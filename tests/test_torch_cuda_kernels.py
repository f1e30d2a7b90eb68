"""The CUDA GRU kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where there is no CUDA device, as on the
CPU machines that run the suite. The file imports neither JAX nor the
JAX package, so the card's machine runs it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: tests/conftest.py configures JAX). Tolerances are those
of tests/test_pallas_gru.py: forward rtol/atol 1e-5, gradients
2e-4 / 2e-5. The backward must also be bitwise deterministic (per-block
partial sums reduced in a fixed order, no float atomics).

With bf16 streams (gi, outs, douts, dgi in bf16; h, W, dW, db and the
gate math in f32) the kernels and the plain versions read the same bf16
inputs and differ only in the f32 rounding of their sums, so a stream
written in bf16 may round to the neighbouring value: streams are held to
one bf16 ulp (rtol 2^-7) plus the f32 atol, everything kept in f32 to
the f32 tolerances.
"""
import numpy as np
import pytest
import torch

from onpolicy_torch.ops import cuda_gru

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
BF16_STREAM = dict(rtol=2 ** -7, atol=2e-5)   # one bf16 ulp
STREAMS = ("gir", "giz", "gin", "douts")


def _layer_inputs(T, B, H, seed, stream_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.tensor(
        (rng.standard_normal(s) * scale).astype(np.float32), device="cuda")
    masks = torch.tensor((rng.random((T, B, 1)) > 0.2).astype(np.float32),
                         device="cuda")
    masks[0] = 0.0
    x = dict(gir=f(T, B, H), giz=f(T, B, H), gin=f(T, B, H),
             h0=f(B, H, scale=0.5), masks=masks,
             w_hh=f(H, 3 * H, scale=H ** -0.5), b_hh=f(3 * H, scale=0.1),
             douts=f(T, B, H, scale=0.1), dhT=f(B, H, scale=0.1))
    for k in STREAMS:
        x[k] = x[k].to(stream_dtype)
    return x


def _close_bf16(got, want, streams):
    """bf16 streams to one ulp, f32 results to the f32 tolerances."""
    for a, b, is_stream in zip(got, want, streams):
        assert a.dtype == b.dtype
        if is_stream:
            assert a.dtype == torch.bfloat16
            torch.testing.assert_close(a.float(), b.float(), **BF16_STREAM)
        else:
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, **GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(10, 960, 64), (10, 37, 64), (1, 300, 64),
                                   (5, 333, 128), (4, 200, 256),
                                   # tensor-core kernels: below one tile,
                                   # 8k+3 rows, blocks walking two tiles, H=48
                                   (10, 5, 64), (10, 803, 64), (10, 5003, 64),
                                   (10, 960, 48),
                                   # the other (H, tile) instantiations of
                                   # both tensor-core kernels
                                   (4, 2200, 48), (4, 2200, 32), (4, 300, 32),
                                   (4, 2200, 16), (4, 300, 16),
                                   # CUDA-core kernels, W in shared memory:
                                   # full tiles, a ragged single tile, T=1
                                   (10, 960, 40), (10, 37, 40), (1, 300, 40),
                                   # Hanabi width, W read from device
                                   # memory: ragged tiles, T=1
                                   (3, 37, 512), (1, 1003, 512),
                                   # the host runners: SMAC 3s5z rMAPPO,
                                   # SMACv2 HAPPO per agent and its
                                   # whole-episode log-probs, GRF 3v1
                                   (10, 2560, 64), (10, 80, 64),
                                   (400, 2, 64), (10, 1500, 64)])
def test_kernels_match_plain_versions_on_the_card(T, B, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    x = _layer_inputs(T, B, H, seed=B)
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    fwd0, bwd0 = cuda_gru.FWD_LAUNCHES, cuda_gru.BWD_LAUNCHES
    outs, hT = cuda_gru.gru_layer_fwd(*args)
    r_outs, r_hT = cuda_gru.gru_layer_fwd_ref(*args)
    torch.testing.assert_close(outs, r_outs, **FWD)
    torch.testing.assert_close(hT, r_hT, **FWD)
    bargs = (x["gir"], x["giz"], x["gin"], r_outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    got = cuda_gru.gru_layer_bwd(*bargs)
    for a, b in zip(got, cuda_gru.gru_layer_bwd_ref(*bargs)):
        torch.testing.assert_close(a, b, **GRAD)
    again = cuda_gru.gru_layer_bwd(*bargs)
    for a, b in zip(got, again):
        assert torch.equal(a, b), "backward is not deterministic"
    assert (cuda_gru.FWD_LAUNCHES - fwd0, cuda_gru.BWD_LAUNCHES - bwd0) == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,variant,bt", [
    (960, 64, "tensor_core", 8), (122_880, 64, "tensor_core", 16),
    (5003, 64, "tensor_core", 16), (37, 64, "tensor_core", 8),
    (960, 48, "tensor_core", 8), (300, 16, "tensor_core", 8),
    (2200, 32, "tensor_core", 16),
    (960, 40, "cuda_core_smem_w", 8), (960, 100, "cuda_core_smem_w", 8),
    (300, 520, "cuda_core_global_w", 8),
    (333, 128, "tensor_core_wide", 128), (200, 256, "tensor_core_wide", 128),
    (20_000, 512, "tensor_core_wide", 128)])
def test_forward_variant_by_width_on_the_card(B, H, variant, bt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    plan = cuda_gru.device_fwd_plan(torch.device("cuda"), B, H)
    assert (plan.name, plan.bt) == (variant, bt)
    if B == 5003:   # the first test needs its blocks to walk two tiles
        assert -(-B // plan.bt) > plan.grid


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(10, 960, 64), (10, 37, 64), (1, 5003, 64)])
def test_cuda_core_forward_at_tensor_core_widths_on_the_card(T, B, H):
    """The CUDA-core forward still runs at H=64 when a plan asks for it, as
    chip_smoke.py times it against the tensor-core one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    x = _layer_inputs(T, B, H, seed=B + 1)
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    plan = cuda_gru.cuda_core_fwd_plan(
        B, H, *cuda_gru.device_limits(torch.cuda.current_device()))
    assert plan.name == "cuda_core_smem_w"
    outs, hT = cuda_gru.gru_layer_fwd(*args, plan=plan)
    r_outs, r_hT = cuda_gru.gru_layer_fwd_ref(*args)
    torch.testing.assert_close(outs, r_outs, **FWD)
    torch.testing.assert_close(hT, r_hT, **FWD)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,variant", [
    (960, 64, "tensor_core"), (122_880, 64, "tensor_core"),
    (5003, 64, "tensor_core"),
    (960, 48, "tensor_core"), (960, 40, "cuda_core_smem_w"),
    (37, 40, "cuda_core_smem_w"), (300, 40, "cuda_core_smem_w"),
    (333, 128, "tensor_core_wide"), (200, 256, "tensor_core_wide"),
    (20_000, 512, "tensor_core_wide")])
def test_backward_variant_by_width_on_the_card(B, H, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    plan = cuda_gru.device_bwd_plan(torch.device("cuda"), B, H)
    assert plan.name == variant
    if B == 5003:   # the test above needs its blocks to walk two tiles
        assert -(-B // plan.bt) > plan.grid


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,bf16", [
    (10, 803, 128, False), (10, 803, 128, True), (5, 333, 256, False),
    (4, 200, 256, True), (3, 37, 512, False), (1, 1003, 512, False)])
def test_cuda_core_backward_with_w_in_memory_on_the_card(T, B, H, bf16):
    """The CUDA-core backward that reads W from device memory, which the
    wide widths no longer take by default, when a plan asks for it (as
    chip_smoke.py times it against the wide one): against the plain
    version, twice with the same bits, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    sd = torch.bfloat16 if bf16 else torch.float32
    x = _layer_inputs(T, B, H, seed=B + H, stream_dtype=sd)
    outs, _ = cuda_gru.gru_layer_fwd_ref(x["gir"], x["giz"], x["gin"], x["h0"],
                                         x["masks"], x["w_hh"], x["b_hh"])
    bargs = (x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    plan = cuda_gru.cuda_core_bwd_plan(
        B, H, *cuda_gru.device_limits(torch.cuda.current_device()))
    assert plan.name == "cuda_core_global_w"
    bwd0 = cuda_gru.BWD_LAUNCHES
    got = cuda_gru.gru_layer_bwd(*bargs, plan=plan)
    assert cuda_gru.BWD_LAUNCHES - bwd0 == 1
    want = cuda_gru.gru_layer_bwd_ref(*bargs)
    if bf16:
        _close_bf16(got, want, (True, True, True, False, False, False))
    else:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **GRAD)
    again = cuda_gru.gru_layer_bwd(*bargs, plan=plan)
    for a, b in zip(got, again):
        assert torch.equal(a, b), "CUDA-core backward is not deterministic"


@pytest.mark.cuda
def test_tensor_core_backward_takes_unaligned_streams_on_the_card():
    """Its cp.async copies move 16-byte chunks: a stream or a W_hh that
    starts off a 16-byte boundary is copied first, and the result is the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    T, B, H = 4, 40, 64
    x = _layer_inputs(T, B, H, seed=3)
    outs, _ = cuda_gru.gru_layer_fwd_ref(x["gir"], x["giz"], x["gin"], x["h0"],
                                         x["masks"], x["w_hh"], x["b_hh"])
    bargs = [x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"]]
    want = cuda_gru.gru_layer_bwd(*bargs)
    for i in (6, 8):   # douts, w_hh
        flat = torch.empty(bargs[i].numel() + 1, device="cuda")
        shifted = flat[1:].view(bargs[i].shape)
        shifted.copy_(bargs[i])
        assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
        got = cuda_gru.gru_layer_bwd(*bargs[:i], shifted, *bargs[i + 1:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_tensor_core_forward_takes_unaligned_streams_on_the_card():
    """It moves 16-byte chunks of the gi streams and of W_hh: one that
    starts off a 16-byte boundary is copied first. h0 is read with plain
    loads and taken where it lies. The result is the same bits either
    way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    T, B, H = 4, 40, 64
    x = _layer_inputs(T, B, H, seed=4)
    args = [x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"]]
    assert cuda_gru.device_fwd_plan(torch.device("cuda"), B, H).name \
        == "tensor_core"
    want = cuda_gru.gru_layer_fwd(*args)
    for i in (1, 3, 5):   # giz, h0, w_hh
        flat = torch.empty(args[i].numel() + 1, device="cuda")
        shifted = flat[1:].view(args[i].shape)
        shifted.copy_(args[i])
        assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
        got = cuda_gru.gru_layer_fwd(*args[:i], shifted, *args[i + 1:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    x = _layer_inputs(3, 8, 16, seed=0)
    args = [x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"]]
    with pytest.raises(ValueError, match="float32"):
        cuda_gru.gru_layer_fwd(*[a.double() for a in args])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru.gru_layer_fwd(x["gir"].transpose(0, 1).contiguous()
                               .transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="expected"):
        cuda_gru.gru_layer_fwd(*args[:3], x["h0"].cpu(), *args[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [
    (10, 960, 64),                       # flagship, 8-row tiles
    (10, 37, 64), (10, 5, 64),           # ragged, below one tile
    (10, 5003, 64),                      # 16-row tiles, blocks walk two
    (1, 300, 64),                        # T=1
    (25, 384, 64),                       # naive-recurrent, 128 threads
    (4, 2200, 48), (10, 960, 48), (4, 2200, 32), (4, 300, 32),
    (4, 2200, 16), (4, 300, 16),         # every tensor-core (H, tile)
    (10, 960, 40), (10, 37, 40), (1, 300, 40),   # CUDA-core, W in smem
    (5, 333, 128)])                      # CUDA-core, W from L2
def test_bf16_kernels_match_plain_versions_on_the_card(T, B, H):
    """All four kernels with bf16 streams against the plain bf16 versions
    (which take hprev at t = 0 as h0 rounded to bf16, as the kernels do);
    the backward twice, with the same bits, and one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    x = _layer_inputs(T, B, H, seed=B + 7, stream_dtype=torch.bfloat16)
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    fwd0, bwd0 = cuda_gru.FWD_LAUNCHES, cuda_gru.BWD_LAUNCHES
    got = cuda_gru.gru_layer_fwd(*args)
    want = cuda_gru.gru_layer_fwd_ref(*args)
    _close_bf16(got, want, (True, False))
    torch.testing.assert_close(got[1], want[1], **FWD)
    bargs = (x["gir"], x["giz"], x["gin"], want[0], x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    got = cuda_gru.gru_layer_bwd(*bargs)
    _close_bf16(got, cuda_gru.gru_layer_bwd_ref(*bargs),
                (True, True, True, False, False, False))
    again = cuda_gru.gru_layer_bwd(*bargs)
    for a, b in zip(got, again):
        assert torch.equal(a, b), "bf16 backward is not deterministic"
    assert (cuda_gru.FWD_LAUNCHES - fwd0, cuda_gru.BWD_LAUNCHES - bwd0) == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_bf16_tensor_core_kernels_take_unaligned_streams_on_the_card(which):
    """A bf16 stream shifted by one element (2 bytes off a 16-byte
    boundary) is copied before the cp.async kernels read it; the result is
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    T, B, H = 4, 40, 64
    x = _layer_inputs(T, B, H, seed=5, stream_dtype=torch.bfloat16)
    outs, _ = cuda_gru.gru_layer_fwd_ref(x["gir"], x["giz"], x["gin"], x["h0"],
                                         x["masks"], x["w_hh"], x["b_hh"])
    if which == "fwd":
        fn = cuda_gru.gru_layer_fwd
        args = [x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
                x["b_hh"]]
        shift = (0, 2)        # gir, gin
    else:
        fn = cuda_gru.gru_layer_bwd
        args = [x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
                x["douts"], x["dhT"], x["w_hh"], x["b_hh"]]
        shift = (1, 3, 6)     # giz, outs, douts
    want = fn(*args)
    for i in shift:
        flat = torch.empty(args[i].numel() + 1, dtype=torch.bfloat16,
                           device="cuda")
        shifted = flat[1:].view(args[i].shape)
        shifted.copy_(args[i])
        assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
        got = fn(*args[:i], shifted, *args[i + 1:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_two_layers_on_the_card_match_the_cpu_path():
    """recurrent_N=2 through `cuda_gru.sequence` with bf16 streams (input
    projections and LayerNorm in bf16): the card (kernels, cuBLAS) against
    the CPU (plain versions) on the same inputs, outputs and every
    gradient. The bf16 projections may round to neighbouring values on the
    two devices, and such a difference passes through two layers, hence
    rtol/atol 2e-2 on the bf16 outputs and on the gradients, and 1e-2 on
    the f32 final states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    T, B, D, H, N = 10, 300, 24, 64, 2
    rng = np.random.default_rng(8)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    layers, d_in = [], D
    for _ in range(N):
        layers.append({"w_ih": f(d_in, 3 * H, scale=d_in ** -0.5),
                       "w_hh": f(H, 3 * H, scale=H ** -0.5),
                       "b_ih": f(3 * H, scale=0.1), "b_hh": f(3 * H, scale=0.1)})
        d_in = H
    norm = {"scale": 1.0 + f(H, scale=0.1), "bias": f(H, scale=0.1)}
    xs, hxs = f(T, B, D), f(B, N, H, scale=0.5)
    masks = (rng.random((T, B, 1)) > 0.2).astype(np.float32)
    masks[0] = 0.0
    w_out = f(H, 3, scale=H ** -0.5)

    def run(device):
        t = lambda a: torch.tensor(a, device=device, requires_grad=True)
        p = {"layers": [{k: t(v) for k, v in l.items()} for l in layers],
             "norm": {k: t(v) for k, v in norm.items()}}
        x_, h_ = t(xs), t(hxs)
        outs, hT = cuda_gru.sequence(p, x_, h_, torch.tensor(masks, device=device),
                                     torch.bfloat16)
        assert outs.dtype == torch.bfloat16 and hT.dtype == torch.float32
        loss = ((outs.float() @ torch.tensor(w_out, device=device)) ** 2).sum() \
            + (hT * hT).sum()
        leaves = [x_, h_] + [v for l in p["layers"] for v in l.values()] \
            + list(p["norm"].values())
        grads = torch.autograd.grad(loss, leaves)
        return [outs.float().cpu(), hT.cpu()] + [g.cpu() for g in grads]

    n0 = cuda_gru.FWD_LAUNCHES
    card, cpu = run("cuda"), run("cpu")
    assert cuda_gru.FWD_LAUNCHES - n0 == N
    torch.testing.assert_close(card[0], cpu[0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(card[1], cpu[1], rtol=1e-2, atol=1e-2)
    for i, (a, b) in enumerate(zip(card[2:], cpu[2:])):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a / scale, b / scale, rtol=2e-2, atol=2e-2,
                                   msg=f"grad {i}")


# ---------------------------------------------------------------------------
# the wide backward (64 < H <= 512, H % 32 == 0): gate GEMM, carry, dW GEMM
# ---------------------------------------------------------------------------

def _wide_case(T, B, H, seed, stream_dtype):
    x = _layer_inputs(T, B, H, seed, stream_dtype)
    outs, _ = cuda_gru.gru_layer_fwd_ref(x["gir"], x["giz"], x["gin"], x["h0"],
                                         x["masks"], x["w_hh"], x["b_hh"])
    bargs = [x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"]]
    return x, outs, bargs


def _close_scaled(a, b, big):
    """dW and db sum T*B products; at many rows compare relative to the
    largest entry, as chip_smoke.py does at the bench and Hanabi shapes."""
    scale = max(1.0, float(b.abs().max())) if big else 1.0
    torch.testing.assert_close(a / scale, b / scale, **GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,bf16", [
    (3, 37, 512, False),       # below one tile (32-row tiles, one block)
    (1, 1003, 512, False),     # T = 1
    (2, 20_000, 512, False),   # 625 tiles on 132 blocks
    (5, 333, 128, False), (10, 803, 128, False), (4, 200, 256, False),
    (3, 300, 96, False),       # GEMM tiles ragged in N = 3H and in H
    (3, 300, 160, False),
    (3, 2100, 128, True), (4, 200, 256, True), (2, 9000, 512, True)])
def test_wide_backward_and_pieces_match_plain_versions_on_the_card(T, B, H,
                                                                  bf16):
    """The whole against `gru_layer_bwd_ref`, twice with the same bits and
    one launch; each piece against its plain piece on the same inputs:
    GH at the forward's tolerance, the carry's outputs and dG at the
    gradients' (dgi within one bf16 ulp with bf16 streams), dW and db at
    the gradients' (relative to the largest entry at 20,000 rows and
    more). The masks are zero at t = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    sd = torch.bfloat16 if bf16 else torch.float32
    x, outs, bargs = _wide_case(T, B, H, B + H, sd)
    plan = cuda_gru.device_bwd_plan(torch.device("cuda"), B, H,
                                    2 if bf16 else 4, T)
    assert plan.name == "tensor_core_wide"
    bwd0, pieces0 = cuda_gru.BWD_LAUNCHES, dict(cuda_gru.WIDE_LAUNCHES)
    got = cuda_gru.gru_layer_bwd(*bargs)
    assert cuda_gru.BWD_LAUNCHES - bwd0 == 1
    assert all(cuda_gru.WIDE_LAUNCHES[k] - pieces0[k] == 1 for k in pieces0)
    want = cuda_gru.gru_layer_bwd_ref(*bargs)
    big = T * B >= 20_000
    if bf16:
        _close_bf16(got[:4], want[:4], (True, True, True, False))
    else:
        for a, b in zip(got[:4], want[:4]):
            torch.testing.assert_close(a, b, **GRAD)
    for a, b in zip(got[4:], want[4:]):
        _close_scaled(a, b, big)
    again = cuda_gru.gru_layer_bwd(*bargs)
    for a, b in zip(got, again):
        assert torch.equal(a, b), "wide backward is not deterministic"

    hprev0 = x["h0"].to(sd)
    common = (outs, hprev0, x["masks"])
    gh = cuda_gru.gru_bwd_gates(*common, x["w_hh"], x["b_hh"])
    gh_ref = cuda_gru.gru_bwd_gates_ref(*common, x["w_hh"], x["b_hh"])
    torch.testing.assert_close(gh, gh_ref, **FWD)
    cargs = (x["gir"], x["giz"], x["gin"], outs, hprev0, x["masks"],
             x["douts"], x["dhT"], x["w_hh"])
    got_c = cuda_gru.gru_bwd_carry(*cargs, gh_ref.clone())
    want_c = cuda_gru.gru_bwd_carry_ref(*cargs, gh_ref)
    if bf16:
        _close_bf16(got_c[:4], want_c[:4], (True, True, True, False))
    else:
        for a, b in zip(got_c[:4], want_c[:4]):
            torch.testing.assert_close(a, b, **GRAD)
    torch.testing.assert_close(got_c[4], want_c[4], **GRAD)
    dg = want_c[4]
    for a, b in zip(cuda_gru.gru_bwd_dw(*common, dg),
                    cuda_gru.gru_bwd_dw_ref(*common, dg)):
        _close_scaled(a, b, big)


@pytest.mark.cuda
def test_wide_backward_gives_the_same_bits_on_any_grid_on_the_card():
    """Each row's carry is its own and dW comes from the GEMMs, whose
    splits follow from the shape alone: three carry blocks walking the 63
    tiles of 32 rows give the bits of the default grid (one block a
    tile). A plan with another tile is refused, not run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    T, B, H = 3, 2000, 128
    _, _, bargs = _wide_case(T, B, H, 9, torch.float32)
    plan = cuda_gru.device_bwd_plan(torch.device("cuda"), B, H, 4, T)
    assert plan.name == "tensor_core_wide" and plan.grid == -(-B // plan.bt)
    want = cuda_gru.gru_layer_bwd(*bargs)
    got = cuda_gru.gru_layer_bwd(*bargs, plan=plan._replace(grid=3))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):
        cuda_gru.gru_layer_bwd(*bargs, plan=plan._replace(bt=64))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_backward_takes_unaligned_inputs_on_the_card(bf16):
    """Its kernels move 16-byte chunks (cp.async) and four elements at a
    time: a stream, W_hh or dhT that starts off a 16-byte boundary is
    copied first, and the result is the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    sd = torch.bfloat16 if bf16 else torch.float32
    T, B, H = 3, 90, 128
    _, _, bargs = _wide_case(T, B, H, 12, sd)
    want = cuda_gru.gru_layer_bwd(*bargs)
    for i in (1, 3, 6, 7, 8):   # giz, outs, douts, dhT, w_hh
        flat = torch.empty(bargs[i].numel() + 1, dtype=bargs[i].dtype,
                           device="cuda")
        shifted = flat[1:].view(bargs[i].shape)
        shifted.copy_(bargs[i])
        assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
        got = cuda_gru.gru_layer_bwd(*bargs[:i], shifted, *bargs[i + 1:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_wide_two_layers_at_h512_on_the_card_match_the_cpu_path():
    """recurrent_N=2 at H=512 through `cuda_gru.sequence` (f32): the card
    (kernels, the wide forward and backward for both layers) against the
    CPU (plain versions), outputs and every gradient. The weight gradients
    sum 3,000 rows of 512-long products, so each gradient is compared
    relative to its largest entry, as chip_smoke.py does at H=512."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    n0 = cuda_gru.WIDE_LAUNCHES["carry"]
    _two_layers_at_h512()
    assert cuda_gru.WIDE_LAUNCHES["carry"] - n0 == 2


@pytest.mark.cuda
def test_wide_forward_two_layers_at_h512_on_the_card():
    """The same recurrent_N=2 run, held for its forward: both layers take
    the wide forward, T step launches each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    f0, s0 = cuda_gru.FWD_LAUNCHES, cuda_gru.FWD_STEP_LAUNCHES
    _two_layers_at_h512()
    assert cuda_gru.FWD_LAUNCHES - f0 == 2
    assert cuda_gru.FWD_STEP_LAUNCHES - s0 == 2 * 10


def _two_layers_at_h512():
    """recurrent_N=2, T=10, B=300 at H=512 on the card and on the CPU."""
    T, B, D, H, N = 10, 300, 24, 512, 2
    rng = np.random.default_rng(13)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    layers, d_in = [], D
    for _ in range(N):
        layers.append({"w_ih": f(d_in, 3 * H, scale=d_in ** -0.5),
                       "w_hh": f(H, 3 * H, scale=H ** -0.5),
                       "b_ih": f(3 * H, scale=0.1), "b_hh": f(3 * H, scale=0.1)})
        d_in = H
    norm = {"scale": 1.0 + f(H, scale=0.1), "bias": f(H, scale=0.1)}
    xs, hxs = f(T, B, D), f(B, N, H, scale=0.5)
    masks = (rng.random((T, B, 1)) > 0.2).astype(np.float32)
    masks[0] = 0.0
    w_out = f(H, 3, scale=H ** -0.5)

    def run(device):
        t = lambda a: torch.tensor(a, device=device, requires_grad=True)
        p = {"layers": [{k: t(v) for k, v in l.items()} for l in layers],
             "norm": {k: t(v) for k, v in norm.items()}}
        x_, h_ = t(xs), t(hxs)
        outs, hT = cuda_gru.sequence(p, x_, h_, torch.tensor(masks, device=device))
        loss = ((outs @ torch.tensor(w_out, device=device)) ** 2).sum() \
            + (hT * hT).sum()
        leaves = [x_, h_] + [v for l in p["layers"] for v in l.values()] \
            + list(p["norm"].values())
        grads = torch.autograd.grad(loss, leaves)
        return [outs.detach().cpu(), hT.detach().cpu()] + [g.cpu() for g in grads]

    card, cpu = run("cuda"), run("cpu")
    torch.testing.assert_close(card[0], cpu[0], **FWD)
    torch.testing.assert_close(card[1], cpu[1], **FWD)
    for i, (a, b) in enumerate(zip(card[2:], cpu[2:])):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a / scale, b / scale, **GRAD, msg=f"grad {i}")


# ---------------------------------------------------------------------------
# the wide forward (64 < H <= 512, H % 32 == 0): one GEMM a time step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,bf16,ones", [
    (3, 37, 512, False, False),     # below one 128-row tile
    (10, 803, 512, False, False),   # 6 tiles and 35 rows
    (1, 1003, 512, False, False),   # T = 1: h0 in, hT out, no scratch
    (2, 20_000, 512, False, False),  # the Hanabi rows: 2,512 blocks a step
    (10, 803, 512, False, True),    # all-ones masks
    (5, 333, 128, False, False), (4, 200, 256, False, False),
    (3, 300, 96, False, False), (3, 300, 160, False, True),
    (5, 333, 128, True, False), (3, 2100, 128, True, True),
    (4, 200, 256, True, False), (2, 9000, 512, True, False)])
def test_wide_forward_matches_plain_version_on_the_card(T, B, H, bf16, ones):
    """Against `gru_layer_fwd_ref`: outs at 1e-5 (within one bf16 ulp with
    bf16 streams), hT at 1e-5; twice with the same bits; one layer launch
    and T step launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    sd = torch.bfloat16 if bf16 else torch.float32
    x = _layer_inputs(T, B, H, seed=B + H + 1, stream_dtype=sd)
    if ones:
        x["masks"] = torch.ones_like(x["masks"])
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    plan = cuda_gru.device_fwd_plan(torch.device("cuda"), B, H,
                                    2 if bf16 else 4)
    assert plan.name == "tensor_core_wide"
    f0, s0 = cuda_gru.FWD_LAUNCHES, cuda_gru.FWD_STEP_LAUNCHES
    got = cuda_gru.gru_layer_fwd(*args)
    assert (cuda_gru.FWD_LAUNCHES - f0, cuda_gru.FWD_STEP_LAUNCHES - s0) \
        == (1, T)
    want = cuda_gru.gru_layer_fwd_ref(*args)
    if bf16:
        _close_bf16(got[:1], want[:1], (True,))
    else:
        torch.testing.assert_close(got[0], want[0], **FWD)
    torch.testing.assert_close(got[1], want[1], **FWD)
    again = cuda_gru.gru_layer_fwd(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b), "wide forward is not repeatable"


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_forward_takes_unaligned_inputs_on_the_card(bf16):
    """It moves 16-byte chunks of h0 and W_hh (cp.async) and pairs of the
    gi streams: one that starts off a 16-byte boundary is copied first,
    and the result is the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    sd = torch.bfloat16 if bf16 else torch.float32
    T, B, H = 3, 90, 128
    x = _layer_inputs(T, B, H, seed=14, stream_dtype=sd)
    args = [x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"]]
    want = cuda_gru.gru_layer_fwd(*args)
    for i in (1, 3, 5):   # giz, h0, w_hh
        flat = torch.empty(args[i].numel() + 1, dtype=args[i].dtype,
                           device="cuda")
        shifted = flat[1:].view(args[i].shape)
        shifted.copy_(args[i])
        assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
        got = cuda_gru.gru_layer_fwd(*args[:i], shifted, *args[i + 1:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_wide_forward_refuses_plans_it_does_not_take_on_the_card():
    """A wide plan for another shape, or at a width the kernel does not
    take, raises instead of running."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    T, B, H = 2, 300, 128
    x = _layer_inputs(T, B, H, seed=15)
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    plan = cuda_gru.wide_fwd_plan(B, H)
    with pytest.raises(ValueError):
        cuda_gru.gru_layer_fwd(*args, plan=plan._replace(grid=plan.grid - 1))
    x = _layer_inputs(T, B, 100, seed=15)
    with pytest.raises(ValueError):
        cuda_gru.gru_layer_fwd(x["gir"], x["giz"], x["gin"], x["h0"],
                               x["masks"], x["w_hh"], x["b_hh"],
                               plan=cuda_gru.wide_fwd_plan(B, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,bf16", [
    (3, 17_000, 128, False), (3, 17_000, 128, True), (4, 200, 256, False),
    (4, 200, 256, True), (3, 37, 512, False), (1, 1003, 512, False)])
def test_cuda_core_forward_with_w_in_memory_on_the_card(T, B, H, bf16):
    """The CUDA-core forward that reads W from device memory, which the
    wide widths no longer take by default, when a plan asks for it (as
    chip_smoke.py times it against the wide one): against the plain
    version, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    sd = torch.bfloat16 if bf16 else torch.float32
    x = _layer_inputs(T, B, H, seed=B + H + 2, stream_dtype=sd)
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    plan = cuda_gru.cuda_core_fwd_plan(
        B, H, *cuda_gru.device_limits(torch.cuda.current_device()))
    assert plan.name == "cuda_core_global_w"
    f0, s0 = cuda_gru.FWD_LAUNCHES, cuda_gru.FWD_STEP_LAUNCHES
    got = cuda_gru.gru_layer_fwd(*args, plan=plan)
    assert (cuda_gru.FWD_LAUNCHES - f0, cuda_gru.FWD_STEP_LAUNCHES - s0) \
        == (1, 0)
    want = cuda_gru.gru_layer_fwd_ref(*args)
    if bf16:
        _close_bf16(got[:1], want[:1], (True,))
    else:
        torch.testing.assert_close(got[0], want[0], **FWD)
    torch.testing.assert_close(got[1], want[1], **FWD)


def _sequence_inputs(T, B, D, H, seed):
    from onpolicy_torch.config import Config
    from onpolicy_torch.models import gru
    g = torch.Generator().manual_seed(seed)
    params = gru.init(Config(hidden_size=H, device="cpu"), D, g, "cuda")
    xs = torch.randn(T, B, D, generator=g).cuda()
    hxs = torch.randn(B, 1, H, generator=g).cuda()
    masks = (torch.rand(T, B, 1, generator=g) > 0.2).float().cuda()
    return params, xs, hxs, masks


@pytest.mark.cuda
def test_double_backward_through_the_kernels_raises_on_the_card():
    """`GRULayerSequence` is once differentiable on the card too: a
    second gradient, through a weight or through every parameter as one
    flat vector (HATRPO's form), raises instead of dropping the kernels'
    second-order terms; the first gradient under create_graph equals the
    plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    from onpolicy_torch.algorithms.hatrpo import _flatten
    params, xs, hxs, masks = _sequence_inputs(10, 96, 8, 64, seed=1)
    w = params["layers"][0]["w_hh"].requires_grad_(True)
    n0 = cuda_gru.BWD_LAUNCHES
    outs, _ = cuda_gru.sequence(params, xs, hxs, masks)
    g, = torch.autograd.grad(outs.square().sum(), w, create_graph=True)
    assert cuda_gru.BWD_LAUNCHES == n0 + 1
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(g.sum(), w)
    cpu = {"layers": [{k: x.detach().cpu() for k, x in
                       params["layers"][0].items()}],
           "norm": {k: x.cpu() for k, x in params["norm"].items()}}
    cpu["layers"][0]["w_hh"].requires_grad_(True)
    o_cpu, _ = cuda_gru.sequence(cpu, xs.cpu(), hxs.cpu(), masks.cpu())
    want, = torch.autograd.grad(o_cpu.square().sum(),
                                cpu["layers"][0]["w_hh"])
    torch.testing.assert_close(g.cpu(), want, **GRAD)

    theta0, unflatten = _flatten(params)
    theta = theta0.detach().requires_grad_(True)
    outs, _ = cuda_gru.sequence(unflatten(theta), xs, hxs, masks)
    g, = torch.autograd.grad(outs.square().sum(), theta, create_graph=True)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(g @ torch.ones_like(theta), theta)


@pytest.mark.cuda
def test_hatrpo_runs_the_plain_scan_on_the_card():
    """models/gru.sequence under hatrpo, as the JAX package routes it: the
    plain scan on the card (no kernel launched), whose double backward
    goes through and equals the CPU's; an explicit use_pallas_gru=True
    runs the kernels, and its double backward raises. Every other
    algorithm keeps the kernels and refuses use_pallas_gru=False."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    from onpolicy_torch.config import Config
    from onpolicy_torch.models import gru
    params, xs, hxs, masks = _sequence_inputs(10, 96, 8, 64, seed=2)
    cfg = Config(algorithm_name="hatrpo", hidden_size=64, share_policy=False)
    gen = torch.Generator().manual_seed(3)
    v = torch.randn(64, 192, generator=gen)
    c = torch.randn(10, 96, 64, generator=gen)

    def hvp(cfg, device):
        p = {"layers": [{k: x.detach().to(device) for k, x in
                         params["layers"][0].items()}],
             "norm": {k: x.to(device) for k, x in params["norm"].items()}}
        w = p["layers"][0]["w_hh"].requires_grad_(True)
        o, _ = gru.sequence(cfg, p, xs.to(device), hxs.to(device),
                            masks.to(device))
        g, = torch.autograd.grad((o * c.to(device)).square().sum(), w,
                                 create_graph=True)
        return torch.autograd.grad((g * v.to(device)).sum(), w)[0]

    f0, b0 = cuda_gru.FWD_LAUNCHES, cuda_gru.BWD_LAUNCHES
    got = hvp(cfg, "cuda")
    assert (cuda_gru.FWD_LAUNCHES, cuda_gru.BWD_LAUNCHES) == (f0, b0)
    # a second derivative: held as HATRPO's Fisher-vector product is
    # against JAX's, relative to its largest entry
    want = hvp(cfg, "cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    cfg.replace(use_pallas_gru=False).validate()   # the scan, allowed
    with pytest.raises(RuntimeError, match="once differentiable"):
        hvp(cfg.replace(use_pallas_gru=True), "cuda")
    assert cuda_gru.FWD_LAUNCHES == f0 + 1
    other = Config(algorithm_name="happo", hidden_size=64, share_policy=False)
    gru.sequence(other, params, xs, hxs, masks)
    assert cuda_gru.FWD_LAUNCHES == f0 + 2
    with pytest.raises(ValueError, match="use_pallas_gru=False"):
        gru.sequence(other.replace(use_pallas_gru=False), params, xs, hxs,
                     masks)
