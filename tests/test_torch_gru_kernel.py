"""The port's sequence GRU (`onpolicy_torch/ops/cuda_gru.py`) against the
JAX package's Pallas GRU (`onpolicy_tpu/ops/pallas_gru.py`).

On the CPU the port's wrappers run the kernels' plain versions
(`gru_layer_fwd_ref`, `gru_layer_bwd_ref`) under the same
`torch.autograd.Function` that drives the CUDA kernels on the card; the
JAX side runs the Pallas kernels in interpret mode, as
tests/test_pallas_gru.py does. Inputs come from a numpy seed.
Tolerances are those of tests/test_pallas_gru.py: forward rtol/atol 1e-5
(f32, sums in another order), gradients 2e-4 / 2e-5 (a reverse
recurrence accumulates more reordering). The kernels themselves are held
against the plain versions on the card by `chip_smoke.py` and by
tests/test_torch_cuda_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.ops import pallas_gru

from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.utils.params import to_torch
from onpolicy_torch.utils.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _case(T, B, D, H, layers, seed=0, zero_t0=True):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    params = {"layers": [], "norm": {"scale": 1.0 + f(H, scale=0.1),
                                     "bias": f(H, scale=0.1)}}
    d_in = D
    for _ in range(layers):
        params["layers"].append({
            "w_ih": f(d_in, 3 * H, scale=d_in ** -0.5),
            "w_hh": f(H, 3 * H, scale=H ** -0.5),
            "b_ih": f(3 * H, scale=0.1), "b_hh": f(3 * H, scale=0.1)})
        d_in = H
    xs, hxs = f(T, B, D), f(B, layers, H, scale=0.5)
    masks = (rng.random((T, B, 1)) > 0.3).astype(np.float32)
    if zero_t0:
        masks[0] = 0.0
    w_out = f(H, 3)
    return params, xs, hxs, masks, w_out


def _jax_value_and_grads(params, xs, hxs, masks, w_out, H, layers):
    cfg = JaxConfig(hidden_size=H, recurrent_N=layers)

    def loss(p, x, h):
        outs, hT = pallas_gru.sequence(cfg, p, x, h, masks)
        return jnp.sum((outs @ w_out) ** 2) + jnp.sum(hT * hT), (outs, hT)

    (_, (outs, hT)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, xs, hxs)
    return outs, hT, jax.device_get(grads)


def _torch_value_and_grads(params, xs, hxs, masks, w_out):
    p = to_torch(params)
    leaves = [x.requires_grad_() for x in tree_leaves(p)]
    p = tree_unflatten(p, leaves)
    x = torch.tensor(xs, requires_grad=True)
    h = torch.tensor(hxs, requires_grad=True)
    outs, hT = cuda_gru.sequence(p, x, h, torch.tensor(masks))
    loss = ((outs @ torch.tensor(w_out)) ** 2).sum() + (hT * hT).sum()
    g = torch.autograd.grad(loss, leaves + [x, h])
    return outs.detach(), hT.detach(), g


@pytest.mark.parametrize("T,B,H,layers", [
    (7, 5, 16, 1),      # one tile
    (7, 5, 16, 2),      # two layers
    (4, 130, 8, 1),     # several TPU batch tiles
    (1, 9, 16, 1),      # T = 1
])
def test_sequence_forward_and_grads_match_pallas(T, B, H, layers):
    D = 12
    params, xs, hxs, masks, w_out = _case(T, B, D, H, layers)
    j_outs, j_hT, j_grads = _jax_value_and_grads(params, xs, hxs, masks,
                                                 w_out, H, layers)
    t_outs, t_hT, t_grads = _torch_value_and_grads(params, xs, hxs, masks,
                                                   w_out)
    np.testing.assert_allclose(t_outs.numpy(), np.asarray(j_outs), **FWD)
    np.testing.assert_allclose(t_hT.numpy(), np.asarray(j_hT), **FWD)
    j_params, j_xs, j_hxs = j_grads
    want = tree_leaves(j_params) + [j_xs, j_hxs]
    assert len(want) == len(t_grads)
    for got, ref in zip(t_grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


def _layer_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.tensor(
        (rng.standard_normal(s) * scale).astype(np.float32))
    masks = torch.tensor((rng.random((T, B, 1)) > 0.2).astype(np.float32))
    masks[0] = 0.0
    return dict(gir=f(T, B, H), giz=f(T, B, H), gin=f(T, B, H),
                h0=f(B, H, scale=0.5), masks=masks,
                w_hh=f(H, 3 * H, scale=H ** -0.5), b_hh=f(3 * H, scale=0.1),
                douts=f(T, B, H, scale=0.1), dhT=f(B, H, scale=0.1))


@pytest.mark.parametrize("T,B,H", [(6, 11, 8), (1, 4, 16)])
def test_plain_backward_matches_autograd(T, B, H):
    """`gru_layer_bwd_ref` (the backward kernel's plain version, with the
    gates rematerialized) equals torch autograd through
    `gru_layer_fwd_ref`, and gives the masks no cotangent."""
    x = _layer_inputs(T, B, H, seed=T + B)
    names = ("gir", "giz", "gin", "h0", "w_hh", "b_hh")
    leaves = {k: x[k].clone().requires_grad_() for k in names}
    outs, hT = cuda_gru.gru_layer_fwd_ref(
        leaves["gir"], leaves["giz"], leaves["gin"], leaves["h0"],
        x["masks"], leaves["w_hh"], leaves["b_hh"])
    auto = torch.autograd.grad((outs * x["douts"]).sum() + (hT * x["dhT"]).sum(),
                               [leaves[k] for k in names])
    dgir, dgiz, dgin, dh0, dw, db = cuda_gru.gru_layer_bwd_ref(
        x["gir"], x["giz"], x["gin"], outs.detach(), x["h0"], x["masks"],
        x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    for got, ref in zip((dgir, dgiz, dgin, dh0, dw, db), auto):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **GRAD)


def test_cpu_wrappers_take_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch; a tensor on any other non-CUDA device is refused."""
    x = _layer_inputs(3, 5, 8, seed=1)
    fwd0, bwd0 = cuda_gru.FWD_LAUNCHES, cuda_gru.BWD_LAUNCHES
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    outs, hT = cuda_gru.gru_layer_fwd(*args)
    r_outs, r_hT = cuda_gru.gru_layer_fwd_ref(*args)
    assert torch.equal(outs, r_outs) and torch.equal(hT, r_hT)
    cuda_gru.gru_layer_bwd(x["gir"], x["giz"], x["gin"], outs, x["h0"],
                           x["masks"], x["douts"], x["dhT"], x["w_hh"],
                           x["b_hh"])
    assert (cuda_gru.FWD_LAUNCHES, cuda_gru.BWD_LAUNCHES) == (fwd0, bwd0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gru.gru_layer_fwd(*meta)


def test_batch_tile_is_a_multiple_of_the_row_group():
    for H in (8, 64, 256, 1024, 4096):
        for B in (1, 37, 960, 122880):
            bt = cuda_gru.batch_tile(B, H, n_sm=132)
            assert bt >= 4 and bt % 4 == 0, (B, H, bt)


# The backward's launch plan (`cuda_gru.bwd_plan`) is plain Python, chosen
# from the shape and the card before launch; here for an H100 SXM.
H100_SMS = 132
H100_SMEM_OPTIN = 232_448      # bytes of shared memory a block may opt into
H100_SMEM_PER_SM = 233_472     # the SM's, of which 1 KB is kept per block


@pytest.mark.parametrize("B,H", [(960, 64), (122_880, 64), (5, 64), (803, 64),
                                 (5003, 64), (960, 48), (300, 16), (3000, 32)])
def test_bwd_plan_takes_the_tensor_core_kernel_for_its_widths(B, H):
    plan = cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
    assert plan.variant == cuda_gru.MMA and plan.name == "tensor_core"
    assert plan.bt in (8, 16) and plan.bt % 8 == 0
    assert plan.smem_bytes == cuda_gru.mma_smem_bytes(H, plan.bt)
    assert plan.smem_bytes <= H100_SMEM_OPTIN
    per_sm = cuda_gru.MMA_BLOCKS_PER_SM[plan.bt]
    assert plan.grid == min(-(-B // plan.bt), per_sm * H100_SMS)
    assert plan.partial_floats == plan.grid * (H + 1) * 3 * H


@pytest.mark.parametrize("H", [16, 32, 48, 64])
def test_two_tensor_core_blocks_fit_an_sm_at_16_row_tiles(H):
    nbytes = cuda_gru.mma_smem_bytes(H, 16)
    assert cuda_gru.MMA_BLOCKS_PER_SM[16] == 2
    assert 2 * (nbytes + cuda_gru.SMEM_PER_BLOCK_RESERVED) <= H100_SMEM_PER_SM
    assert cuda_gru.mma_smem_bytes(64, 16) == 112_256   # the source's note
    assert cuda_gru.mma_smem_bytes(64, 8) == 81_728


def test_bwd_plan_at_the_flagship_and_bench_shapes():
    flag = cuda_gru.bwd_plan(960, 64, H100_SMS, H100_SMEM_OPTIN)
    assert (flag.name, flag.bt, flag.grid) == ("tensor_core", 8, 120)
    bench = cuda_gru.bwd_plan(122_880, 64, H100_SMS, H100_SMEM_OPTIN)
    assert (bench.name, bench.bt, bench.grid) == ("tensor_core", 16, 264)
    # blocks walk 7,680 tiles; the partials stay at grid x (H+1) x 3H floats
    assert bench.partial_floats * 4 == 264 * 65 * 192 * 4 == 13_178_880


@pytest.mark.parametrize("H", [40, 128, 256, 512])
def test_bwd_plan_keeps_the_cuda_core_kernel_for_other_widths(H):
    """H=40 keeps the CUDA-core kernel; H=128, 256 and 512 (64 < H <= 512,
    H % 32 == 0) take the wide tensor-core backward, whose CUDA-core plan
    stays what it was, for a caller that asks for it."""
    for B in (5, 960, 122_880):
        old = cuda_gru.cuda_core_bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
        assert old.variant in (cuda_gru.GLOBAL_W, cuda_gru.SMEM_W)
        assert old.bt == cuda_gru.batch_tile(B, H, H100_SMS)
        assert old.grid == -(-B // old.bt)
        assert old.smem_bytes <= H100_SMEM_OPTIN
        assert old.partial_floats == old.grid * (H + 1) * 3 * H
        plan = cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
        if H == 40:
            assert plan == old
        else:
            assert plan.variant == cuda_gru.WIDE
            assert plan == cuda_gru.wide_bwd_plan(1, B, H, H100_SMS)
    assert cuda_gru.bwd_plan(960, 40, H100_SMS, H100_SMEM_OPTIN).name \
        == "cuda_core_smem_w"
    assert cuda_gru.bwd_plan(960, 256, H100_SMS, H100_SMEM_OPTIN).name \
        == "tensor_core_wide"
    assert cuda_gru.cuda_core_bwd_plan(960, 256, H100_SMS,
                                       H100_SMEM_OPTIN).name \
        == "cuda_core_global_w"


@pytest.mark.parametrize("B,H", [(960, 64), (122_880, 64), (5003, 48), (37, 16)])
def test_bwd_plan_grid_depends_only_on_shape_and_sm_count(B, H):
    """dW is summed per block, so its bits follow the grid: the same
    (B, H, SM count) must give the same grid whatever else the card
    reports, and a card that cannot hold the blocks takes the CUDA-core
    kernel rather than another grid."""
    plan = cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
    for optin in (H100_SMEM_OPTIN, H100_SMEM_OPTIN + 65_536, 2 ** 20):
        assert cuda_gru.bwd_plan(B, H, H100_SMS, optin) == plan
    small = cuda_gru.bwd_plan(B, H, H100_SMS, 48 * 1024)
    assert small.variant != cuda_gru.MMA or small == plan


# The forward's launch plan (`cuda_gru.fwd_plan`), chosen the same way.

@pytest.mark.parametrize("B,H", [(960, 64), (122_880, 64), (5, 64), (37, 64),
                                 (803, 64), (5003, 64), (960, 48), (2200, 48),
                                 (300, 32), (2200, 32), (300, 16), (2200, 16)])
def test_fwd_plan_takes_the_tensor_core_kernel_for_its_widths(B, H):
    plan = cuda_gru.fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
    assert plan.variant == cuda_gru.MMA and plan.name == "tensor_core"
    assert plan.bt == (16 if -(-B // 16) >= H100_SMS else 8)
    assert plan.smem_bytes == cuda_gru.mma_fwd_smem_bytes(H, plan.bt)
    per_sm = cuda_gru.MMA_FWD_BLOCKS_PER_SM
    assert per_sm * (plan.smem_bytes + cuda_gru.SMEM_PER_BLOCK_RESERVED) \
        <= H100_SMEM_PER_SM
    assert plan.grid == min(-(-B // plan.bt), per_sm * H100_SMS)
    # the grid follows from (B, H, SM count) alone
    for optin in (plan.smem_bytes, H100_SMEM_OPTIN + 65_536, 2 ** 20):
        assert cuda_gru.fwd_plan(B, H, H100_SMS, optin) == plan


@pytest.mark.parametrize("H", [40, 100, 128, 256, 512, 520])
def test_fwd_plan_keeps_the_cuda_core_kernel_for_other_widths(H):
    """H=40, 100 and 520 keep the CUDA-core kernel; H=128, 256 and 512
    (64 < H <= 512, H % 32 == 0) take the wide tensor-core forward, whose
    CUDA-core plan stays what it was, for a caller that asks for it."""
    for B in (5, 960, 122_880):
        old = cuda_gru.cuda_core_fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
        assert old.variant in (cuda_gru.GLOBAL_W, cuda_gru.SMEM_W)
        assert old.bt == cuda_gru.batch_tile(B, H, H100_SMS)
        assert old.grid == -(-B // old.bt)
        assert old.smem_bytes <= H100_SMEM_OPTIN
        plan = cuda_gru.fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
        if H in (40, 100, 520):
            assert plan == old
        else:
            assert plan == cuda_gru.wide_fwd_plan(B, H)
            assert plan.name == "tensor_core_wide"
    names = {H: cuda_gru.fwd_plan(960, H, H100_SMS, H100_SMEM_OPTIN).name
             for H in (40, 100, 128, 256, 520)}
    assert names == {40: "cuda_core_smem_w", 100: "cuda_core_smem_w",
                     128: "tensor_core_wide", 256: "tensor_core_wide",
                     520: "cuda_core_global_w"}
    old = {H: cuda_gru.cuda_core_fwd_plan(960, H, H100_SMS,
                                          H100_SMEM_OPTIN).name
           for H in (128, 256)}
    assert old == {128: "cuda_core_smem_w", 256: "cuda_core_global_w"}


def test_fwd_plan_at_the_flagship_and_bench_shapes():
    flag = cuda_gru.fwd_plan(960, 64, H100_SMS, H100_SMEM_OPTIN)
    assert flag == (cuda_gru.MMA, 8, 120, 66_624)
    bench = cuda_gru.fwd_plan(122_880, 64, H100_SMS, H100_SMEM_OPTIN)
    assert bench == (cuda_gru.MMA, 16, 264, 84_096)   # blocks walk 7,680 tiles
    # the CUDA-core forward these replace: one block per 8 or 64 rows
    assert cuda_gru.cuda_core_fwd_plan(960, 64, H100_SMS, H100_SMEM_OPTIN) \
        == (cuda_gru.SMEM_W, 8, 120, 4 * (64 * 193 + 2 * 8 * 64 + 8))
    assert cuda_gru.cuda_core_fwd_plan(
        122_880, 64, H100_SMS, H100_SMEM_OPTIN)[:3] == (cuda_gru.SMEM_W, 64,
                                                         1920)


def _fwd_layout_bytes(H, bt):
    """`FwdLayout<H, BT>::BYTES` of csrc/gru_seq.cu, member by member."""
    H3, SS = 3 * H, H + 4
    stream = bt * SS
    stage = 3 * stream + bt
    stages = 2
    stage_off = H3 * H
    h_off = stage_off + stages * stage
    return (h_off + 2 * stream) * 4


@pytest.mark.parametrize("H", [16, 32, 48, 64])
@pytest.mark.parametrize("bt", [8, 16])
def test_fwd_smem_bytes_mirror_the_kernel_layout(H, bt):
    assert cuda_gru.mma_fwd_smem_bytes(H, bt) == _fwd_layout_bytes(H, bt)
    # 16-byte cp.async targets: every stage and h buffer starts aligned
    assert (3 * H * H) % 4 == 0 and (bt * (H + 4)) % 4 == 0 and bt % 4 == 0
    src = cuda_gru.SOURCE.read_text()
    assert "84,096 bytes for\n// BT = 16 and 66,624 for BT = 8" in src
    assert "static constexpr int STAGES = 2;" in src
    assert _fwd_layout_bytes(64, 16) == 84_096
    assert _fwd_layout_bytes(64, 8) == 66_624
