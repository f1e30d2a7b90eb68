"""The wide GRU backward (`tensor_core_wide`, 64 < H <= 512, H % 32 == 0)
on the CPU: its three plain pieces against the whole backward and against
the JAX package's, and its launch plan.

On the card the backward at these widths runs as three kernels: the gate
GEMM (GH = hm @ W_hh + b_hh over all T*B rows), the carry (the only
recurrence: the gate cotangents from GH, then dh <- (dh*z + dG @ W^T)*m)
and the split-K dW GEMM with its fixed-order reduction. Their plain
versions (`cuda_gru.gru_bwd_{gates,carry,dw}_ref`) are what the CPU path
and the tests can reach; here, composed, against `gru_layer_bwd_ref` and
against `pallas_gru.gru_layer_sequence`'s VJP (its `_bwd_call`) in
interpret mode, as tests/test_pallas_gru.py runs it. Inputs come from a
numpy seed. Tolerances: f32 rtol 2e-4 / atol 2e-5 (the gradients'
tolerance of tests/test_pallas_gru.py); with bf16 streams the dgi within
one bf16 ulp (rtol 2^-7) and dh0, dW, db at the f32 tolerances, dW being
built from the f32 dG. The kernels themselves are held against these
pieces on the card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.ops import pallas_gru as pg

from onpolicy_torch.ops import cuda_gru

torch.set_num_threads(1)

GRAD = dict(rtol=2e-4, atol=2e-5)
ULP = dict(rtol=2 ** -7, atol=2e-5)          # one bf16 ulp
H100_SMS, H100_SMEM_OPTIN = 132, 232_448
NAMES = ("dgir", "dgiz", "dgin", "dh0", "dw_hh", "db_hh")


def _inputs(T, B, H, seed, bf16, zero_t0=True):
    """numpy f32 layer inputs; the [T, B, H] streams rounded to bf16 (and
    kept as f32 values) when `bf16`."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    rnd = (lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                .astype(jnp.float32))) if bf16 else (lambda a: a)
    x = dict(gir=rnd(f(T, B, H)), giz=rnd(f(T, B, H)), gin=rnd(f(T, B, H)),
             h0=f(B, H, scale=0.5), w_hh=f(H, 3 * H, scale=H ** -0.5),
             b_hh=f(3 * H, scale=0.1), douts=rnd(f(T, B, H, scale=0.1)),
             dhT=f(B, H, scale=0.1))
    m = (rng.random((T, B, 1)) > 0.2).astype(np.float32)
    if zero_t0:
        m[0] = 0.0
    x["masks"] = m
    return x


def _torch(x, bf16):
    sd = torch.bfloat16 if bf16 else torch.float32
    t = {k: torch.tensor(v) for k, v in x.items()}
    for k in ("gir", "giz", "gin", "douts"):
        t[k] = t[k].to(sd)
    t["outs"], _ = cuda_gru.gru_layer_fwd_ref(t["gir"], t["giz"], t["gin"],
                                              t["h0"], t["masks"], t["w_hh"],
                                              t["b_hh"])
    return t


def _pieces(t):
    """The three plain pieces composed: the wide backward on the CPU."""
    hprev0 = t["h0"].to(t["outs"].dtype)
    common = (t["outs"], hprev0, t["masks"])
    gh = cuda_gru.gru_bwd_gates_ref(*common, t["w_hh"], t["b_hh"])
    dgir, dgiz, dgin, dh0, dg = cuda_gru.gru_bwd_carry_ref(
        t["gir"], t["giz"], t["gin"], t["outs"], hprev0, t["masks"],
        t["douts"], t["dhT"], t["w_hh"], gh)
    assert dg.dtype == torch.float32 and dg.shape == gh.shape
    dw, db = cuda_gru.gru_bwd_dw_ref(*common, dg)
    return dgir, dgiz, dgin, dh0, dw, db


def _close(got, want, bf16):
    for i, (n, a, b) in enumerate(zip(NAMES, got, want)):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        b = b.float().numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_allclose(a, np.asarray(b, np.float32), err_msg=n,
                                   **(ULP if bf16 and i < 3 else GRAD))


CASES = [
    # T, B, H, bf16, masks zero at t=0
    (3, 37, 128, False, True),    # B ragged against 32-row tiles
    (1, 5, 128, False, True),     # T = 1, below one tile
    (4, 20, 512, False, True),    # the Hanabi width
    (1, 9, 512, False, False),    # T = 1, h0 in every product
    (3, 37, 128, True, True),     # bf16 streams
    (2, 11, 512, True, False),
]


@pytest.mark.parametrize("T,B,H,bf16,zero_t0", CASES)
def test_wide_pieces_compose_to_the_plain_backward(T, B, H, bf16, zero_t0):
    t = _torch(_inputs(T, B, H, seed=T * 31 + B + H, bf16=bf16,
                       zero_t0=zero_t0), bf16)
    got = _pieces(t)
    want = cuda_gru.gru_layer_bwd_ref(t["gir"], t["giz"], t["gin"], t["outs"],
                                      t["h0"], t["masks"], t["douts"],
                                      t["dhT"], t["w_hh"], t["b_hh"])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    _close(got, want, bf16)
    # the CPU wrappers take the plain pieces
    hprev0 = t["h0"].to(t["outs"].dtype)
    gh = cuda_gru.gru_bwd_gates(t["outs"], hprev0, t["masks"], t["w_hh"],
                                t["b_hh"])
    assert torch.equal(gh, cuda_gru.gru_bwd_gates_ref(
        t["outs"], hprev0, t["masks"], t["w_hh"], t["b_hh"]))


def _jax_vjp(x, bf16):
    """`gru_layer_sequence` and its VJP (`_layer_bwd` -> `_bwd_call`) at B
    padded to the Pallas batch tile with zero rows and masks, which add
    nothing to dW or db; returns (outs, grads) of the first B rows."""
    T, B, H = x["gir"].shape
    sd = jnp.bfloat16 if bf16 else jnp.float32
    bp = -(-B // pg._b_tile(H, itemsize=2 if bf16 else 4)) \
        * pg._b_tile(H, itemsize=2 if bf16 else 4)
    pad = lambda a, axis: np.pad(a, [(0, bp - B) if i == axis else (0, 0)
                                     for i in range(a.ndim)])
    gi = [jnp.asarray(pad(x[k], 1)).astype(sd) for k in ("gir", "giz", "gin")]
    w = x["w_hh"]
    args = (*gi, jnp.asarray(pad(x["h0"], 0)), jnp.asarray(pad(x["masks"], 1)),
            w[:, :H], w[:, H:2 * H], w[:, 2 * H:], x["b_hh"].reshape(3, H))
    (outs, _), vjp = jax.vjp(pg.gru_layer_sequence, *args)
    douts = jnp.asarray(pad(x["douts"], 1)).astype(sd)
    g = vjp((douts, jnp.asarray(pad(x["dhT"], 0))))
    dw = np.concatenate([np.asarray(g[k]) for k in (5, 6, 7)], 1)
    grads = (*(np.asarray(g[k].astype(jnp.float32))[:, :B] for k in range(3)),
             np.asarray(g[3])[:B], dw, np.asarray(g[8]).reshape(-1))
    return np.asarray(outs.astype(jnp.float32))[:, :B], grads


@pytest.mark.parametrize("T,B,H,bf16,zero_t0", CASES)
def test_wide_pieces_match_pallas(T, B, H, bf16, zero_t0):
    x = _inputs(T, B, H, seed=T * 17 + B + H, bf16=bf16, zero_t0=zero_t0)
    j_outs, j_grads = _jax_vjp(x, bf16)
    t = _torch(x, bf16)
    # both sides differentiate at JAX's outs, as `_layer_bwd` saves them
    t["outs"] = torch.tensor(j_outs).to(t["gir"].dtype)
    _close(_pieces(t), j_grads, bf16)


# The wide backward's launch plan, chosen from the shape and the card.

@pytest.mark.parametrize("T,B,H,grid,splits", [
    (10, 20_000, 512, 132, 98),   # the Hanabi shape: 625 tiles walked
    (10, 37, 512, 2, 1),          # below the SM count
    (5, 333, 128, 11, 4),         # four blocks an SM's registers hold
    (10, 960, 256, 30, 19),
    (10, 32, 128, 1, 1),          # Hanabi-Small's update
    (1, 40_000, 128, 528, 79),    # 79 ranges fill the card
    (1, 200_000, 128, 528, 98),   # 98 ranges of at most 2048 rows
    (3, 300, 96, 10, 2),          # GEMM tiles ragged in N = 3H and H
])
def test_wide_plan_tiles_grid_and_splits(T, B, H, grid, splits):
    plan = cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN, 4, T)
    assert plan.variant == cuda_gru.WIDE and plan.name == "tensor_core_wide"
    assert (plan.bt, plan.grid, plan.splits) == (32, grid, splits)
    assert plan.grid == min(-(-B // 32), max(1, 512 // H) * H100_SMS)
    assert plan.smem_bytes == cuda_gru.carry_smem_bytes(H) \
        == _carry_layout_bytes(H) <= H100_SMEM_OPTIN
    # scratch: the dW partials, then GH (dG written over it)
    assert plan.partial_floats == splits * (H + 1) * 3 * H + T * B * 3 * H
    # both stream types take the same plan (the carry keeps f32 only)
    assert cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN, 2, T) == plan


def test_wide_plan_at_the_hanabi_shape_counts_its_scratch():
    plan = cuda_gru.bwd_plan(20_000, 512, H100_SMS, H100_SMEM_OPTIN, 4, 10)
    # 98 x 513 x 1536 partial floats (200,000 rows in ranges of at most
    # 2048) and 200,000 x 1536 of GH / dG: 1.538 GB, against the CUDA-core
    # kernel's 3.94 GB of per-block partials
    assert plan.splits == 98 == -(-200_000 // cuda_gru.DW_MAX_ROWS)
    assert plan.partial_floats == 384_420_864
    old = cuda_gru.cuda_core_bwd_plan(20_000, 512, H100_SMS, H100_SMEM_OPTIN)
    assert (old.name, old.bt, old.grid) == ("cuda_core_global_w", 16, 1250)
    assert old.partial_floats == 984_960_000
    assert cuda_gru.carry_smem_bytes(512) == 156_672   # the source's note


def _carry_layout_bytes(H):
    """`CarryLayout::bytes(H)` of csrc/gru_seq.cu, member by member."""
    bt = 32
    bk = 32
    ldk = bk + 4
    stages = 2
    return stages * (H + bt) * ldk * 4


def test_wide_layouts_mirror_the_source():
    src = cuda_gru.SOURCE.read_text()
    for line in ("static constexpr int BT = 32;           // batch rows",
                 "static constexpr int BK = 32;           // K-chunk",
                 "static constexpr int LDK = BK + 4;",
                 "static constexpr int STAGES = 2;",
                 "static constexpr int BM = 128, BN = 128, BK = 32;",
                 "static constexpr int THREADS = 256, STAGES = 3, "
                 "MIN_BLOCKS = 2;"):
        assert line in src, line
    assert (cuda_gru.CARRY_BT, cuda_gru.CARRY_BK,
            cuda_gru.CARRY_STAGES) == (32, 32, 2)
    assert cuda_gru.GEMM_BM == cuda_gru.GEMM_BN == 128
    assert cuda_gru.GEMM_BLOCKS_PER_SM == 2
    # the GEMMs' stages, as the source's note gives them: three stages of
    # A (hm in the stream type, padded by one 16-byte chunk or 8 columns),
    # B ([32][136] f32) and, in dW, 32 masks; two blocks fit an SM
    for trans, itemsize, want in ((False, 4, 107_520), (True, 4, 104_832),
                                  (False, 2, 82_944), (True, 2, 78_720)):
        epc = 16 // itemsize
        a = 32 * (128 + 8) if trans else 128 * (32 + epc)
        stage = a * itemsize + 32 * 136 * 4 + (4 * 32 if trans else 0)
        assert 3 * stage == want and stage % 16 == 0
        assert 2 * (want + cuda_gru.SMEM_PER_BLOCK_RESERVED) <= 233_472
        assert f"{want:,}" in src


@pytest.mark.parametrize("B,H", [(20_000, 512), (333, 128), (37, 256),
                                 (5003, 160)])
def test_wide_grid_depends_only_on_shape_and_sm_count(B, H):
    """The carry grid and the dW splits follow from (T, B, H, SM count):
    the shared memory a card offers changes neither, and a card that cannot
    hold the carry's shared memory takes the CUDA-core kernel rather than
    another grid."""
    plan = cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN, 4, 10)
    for optin in (plan.smem_bytes, H100_SMEM_OPTIN + 65_536, 2 ** 20):
        assert cuda_gru.bwd_plan(B, H, H100_SMS, optin, 4, 10) == plan
    small = cuda_gru.bwd_plan(B, H, H100_SMS, plan.smem_bytes - 1, 4, 10)
    assert small.variant in (cuda_gru.GLOBAL_W, cuda_gru.SMEM_W)
    other = cuda_gru.bwd_plan(B, H, 114, H100_SMEM_OPTIN, 4, 10)
    assert other.grid == min(-(-B // other.bt), max(1, 512 // H) * 114)


@pytest.mark.parametrize("H", [16, 32, 40, 48, 64, 80, 100, 544, 1024])
def test_other_widths_keep_their_kernels(H):
    """H <= 64 keeps the tensor-core kernel where it has one, every H
    outside the wide widths the CUDA-core kernel, as before."""
    assert not cuda_gru.wide_widths(H)
    for B in (5, 960, 122_880):
        plan = cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN, 4, 10)
        if H in cuda_gru.MMA_WIDTHS:
            assert plan.variant == cuda_gru.MMA
        else:
            assert plan == cuda_gru.cuda_core_bwd_plan(B, H, H100_SMS,
                                                       H100_SMEM_OPTIN)
        assert plan.splits == 0
