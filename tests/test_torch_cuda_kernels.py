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
                                   (3, 37, 512), (1, 1003, 512)])
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
    (960, 40, "cuda_core_smem_w", 8), (333, 128, "cuda_core_smem_w", 8),
    (200, 256, "cuda_core_global_w", 8),
    (20_000, 512, "cuda_core_global_w", 16)])
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
    (333, 128, "cuda_core_global_w"), (200, 256, "cuda_core_global_w"),
    (20_000, 512, "cuda_core_global_w")])
def test_backward_variant_by_width_on_the_card(B, H, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    plan = cuda_gru.device_bwd_plan(torch.device("cuda"), B, H)
    assert plan.name == variant
    if B == 5003:   # the test above needs its blocks to walk two tiles
        assert -(-B // plan.bt) > plan.grid


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
