"""The CUDA GRU kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where there is no CUDA device, as on the
CPU machines that run the suite. The file imports neither JAX nor the
JAX package, so the card's machine runs it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: tests/conftest.py configures JAX). Tolerances are those
of tests/test_pallas_gru.py: forward rtol/atol 1e-5, gradients
2e-4 / 2e-5. The backward must also be bitwise deterministic (per-block
partial sums reduced in a fixed order, no float atomics).
"""
import numpy as np
import pytest
import torch

from onpolicy_torch.ops import cuda_gru

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _layer_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.tensor(
        (rng.standard_normal(s) * scale).astype(np.float32), device="cuda")
    masks = torch.tensor((rng.random((T, B, 1)) > 0.2).astype(np.float32),
                         device="cuda")
    masks[0] = 0.0
    return dict(gir=f(T, B, H), giz=f(T, B, H), gin=f(T, B, H),
                h0=f(B, H, scale=0.5), masks=masks,
                w_hh=f(H, 3 * H, scale=H ** -0.5), b_hh=f(3 * H, scale=0.1),
                douts=f(T, B, H, scale=0.1), dhT=f(B, H, scale=0.1))


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
                                   (10, 960, 40), (10, 37, 40), (1, 300, 40)])
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
    (200, 256, "cuda_core_global_w", 8)])
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
    (333, 128, "cuda_core_global_w"), (200, 256, "cuda_core_global_w")])
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
