"""LayerNorm through hand-written CUDA kernels, one each way.

The JAX package writes its LayerNorm as array ops (`onpolicy_tpu/models/
common.py`) and XLA fuses them. Written as separate PyTorch ops
(`models/common.layer_norm_apply`) it took about 10 kernels forward and 20
backward, most of them a full pass over the tensor; on the card an f32
LayerNorm goes instead through `LayerNorm` below: the forward kernel
(`ln_fwd_rows` / `ln_fwd_loop` of `csrc/layer_norm.cu`: read x, write y and
each row's mean and rstd) and the backward kernel with its fixed-order
reduction of the scale and bias gradients (`ln_bwd_rows` / `ln_bwd_loop`,
`ln_bwd_reduce`: read x and dy, write dx). Both are bound by bytes. The
library is built with `nvcc` for `sm_90a` into `_build/` on first use by
`cuda_gru.build`, and bound through `ctypes`.

`plan` chooses the kernel by width before launch: a row held in
registers by 8 or 16 lanes (D <= 64) or by a warp (64 < D <= 1024), with
16-byte loads where D % 4 == 0 and the tensors are aligned; a warp walking
the row through device memory for any wider row. `fwd_grid` and `bwd_grid`
size the launches (the backward on as many blocks as the card holds at
once, so its partial sums stay few).

Beside each kernel stands its plain PyTorch twin (`layer_norm_fwd_ref`,
`layer_norm_bwd_ref`): the wrappers take it for tensors on the CPU; for a
CUDA tensor they launch the kernel or raise. `LayerNorm`'s backward under
grad mode (`create_graph=True`: HATRPO's Fisher-vector product) runs the
plain twin in differentiable ops, its statistics recomputed from x, so
second-order terms stay exact.

`FWD_LAUNCHES` / `BWD_LAUNCHES` count wrapper calls that reached the card;
the profiling counters `layer_norm_fused` (+1 a forward or backward on the
kernels) and `layer_norm_plain` (+1 a LayerNorm the card ran in plain
ops: a bf16 forward in `layer_norm_apply`'s decomposed form, or a backward
under grad mode here) show which path a traced run took.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.utils import profiling

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "layer_norm.cu"
THREADS = 256            # threads a block, every kernel
WARPS = THREADS // 32
MAX_ROW_WIDTH = 1024     # widest row held in registers (a warp, 32 floats a lane)
ROWS, LOOP = 0, 1        # `variant`: the row in registers, or walked in chunks
VARIANT_NAMES = ("rows", "loop")
# the (lanes, vec, chunks) that csrc/layer_norm.cu instantiates
# (LN_ROW_PLANS), each taken by some width
ROW_PLANS = ((8, 1, 1), (8, 1, 2), (8, 1, 4), (8, 4, 1), (8, 4, 2),
             (16, 1, 4),
             (32, 1, 4), (32, 1, 8), (32, 1, 16), (32, 1, 32),
             (32, 4, 1), (32, 4, 2), (32, 4, 4), (32, 4, 8))
_lib = None


# ---------------------------------------------------------------------------
# build, bind, plan
# ---------------------------------------------------------------------------

def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_gru.build(SOURCE)))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ln_fwd.argtypes = [P] * 6 + [L, I, ctypes.c_float] + [I] * 5 + [P]
        lib.ln_fwd.restype = I
        lib.ln_bwd.argtypes = [P] * 9 + [L, I] + [I] * 5 + [P]
        lib.ln_bwd.restype = I
        lib.ln_bwd_blocks_per_sm.argtypes = [I] * 5
        lib.ln_bwd_blocks_per_sm.restype = I
        _lib = lib
    return _lib


class Plan(NamedTuple):
    variant: int
    lanes: int            # threads a row
    vec: int              # floats a load: 4 (16 bytes) or 1
    chunks: int           # loads a lane holds (ROWS; 0 for LOOP)

    @property
    def name(self) -> str:
        return VARIANT_NAMES[self.variant]

    @property
    def rows_per_block(self) -> int:
        return THREADS // self.lanes


def plan(D: int, aligned: bool = True) -> Plan:
    """The kernels for rows of width D; `aligned`: every tensor the launch
    reads or writes starts on a 16-byte boundary."""
    if D < 1:
        raise ValueError(f"LayerNorm over a width of {D}")
    if D > MAX_ROW_WIDTH:
        return Plan(LOOP, 32, 1, 0)
    vec = 4 if D % 4 == 0 and aligned else 1
    units = D // vec
    lanes = 32 if D > 64 else 16 if units > 32 else 8
    chunks = 1
    while chunks * lanes < units:
        chunks *= 2
    return Plan(ROWS, lanes, vec, chunks)


def fwd_grid(N: int, p: Plan) -> int:
    """Blocks of the forward: a tile of rows each."""
    return -(-N // p.rows_per_block)


def bwd_grid(N: int, p: Plan, n_sm: int, blocks_per_sm: int) -> int:
    """Blocks of the backward: as many as the card holds at once (each
    walks its share of the tiles), or one a tile where there are fewer."""
    return max(1, min(-(-N // p.rows_per_block), n_sm * blocks_per_sm))


def partial_rows(p: Plan, grid: int) -> int:
    """[2, D] partial rows the backward writes: one a block, one a warp
    for LOOP."""
    return grid * (WARPS if p.variant == LOOP else 1)


def served_by_kernels(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether a LayerNorm of a tensor on `device` in `dtype` runs on the
    kernels (`models/common.layer_norm_apply`): f32 on the card. The CPU
    keeps the decomposed form (the tests' reference); bf16 keeps it too,
    since the kernels would not round each op to bf16 as it does."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, p: Plan, D: int) -> int:
    with torch.cuda.device(index):
        n = _load().ln_bwd_blocks_per_sm(p.variant, p.lanes, p.vec, p.chunks, D)
    if n < 1:
        raise RuntimeError(f"ln_bwd_blocks_per_sm: no block of {p} fits at "
                           f"D={D}")
    return n


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# plain PyTorch twins (CPU path, the kernels' reference, the double backward)
# ---------------------------------------------------------------------------

def stats(x, eps):
    """(mean, rstd) of each row of x [..., D], each [...]: the biased
    variance of the row after its mean."""
    mean = x.mean(-1)
    xc = x - mean[..., None]
    return mean, torch.rsqrt(xc.square().mean(-1) + eps)


def layer_norm_fwd_ref(x, scale, bias, eps):
    """(y, mean, rstd), as the forward kernel computes them."""
    mean, rstd = stats(x, eps)
    y = (x - mean[..., None]) * rstd[..., None] * scale + bias
    return y, mean, rstd


def layer_norm_bwd_ref(x, scale, dy, mean, rstd):
    """(dx, dscale, dbias), as the backward kernel computes them:
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), g = dy * scale."""
    D = x.shape[-1]
    xhat = (x - mean[..., None]) * rstd[..., None]
    g = dy * scale
    dx = rstd[..., None] * (g - g.mean(-1, keepdim=True)
                            - xhat * (g * xhat).mean(-1, keepdim=True))
    return (dx, (dy * xhat).reshape(-1, D).sum(0),
            dy.reshape(-1, D).sum(0))


# ---------------------------------------------------------------------------
# wrappers: plain twin on the CPU, kernel on the card
# ---------------------------------------------------------------------------

def _ptr(x):
    return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


def _require(like, D, **tensors):
    """Every tensor f32, contiguous and on the card of `like` (x); the [D]
    ones of width D, the others x's shape (mean and rstd without its last
    axis)."""
    if like.device.type != "cuda":
        raise ValueError(f"unsupported device {like.device}")
    for name, t in tensors.items():
        want = ((D,) if name in ("scale", "bias") else
                tuple(like.shape[:-1]) if name in ("mean", "rstd") else
                tuple(like.shape))
        if t.device != like.device:
            raise ValueError(f"{name} on {t.device}, expected {like.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; the LayerNorm kernels "
                             "take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")


def _aligned(*xs) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def layer_norm_fwd(x, scale, bias, eps):
    """(y, mean, rstd) of x [..., D]."""
    global FWD_LAUNCHES
    if x.device.type == "cpu":
        return layer_norm_fwd_ref(x, scale, bias, eps)
    D = x.shape[-1]
    _require(x, D, x=x, scale=scale, bias=bias)
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], device=x.device)
    rstd = torch.empty_like(mean)
    N = mean.numel()
    if N == 0:
        return y, mean, rstd
    p = plan(D, _aligned(x, scale, bias))
    with torch.cuda.device(x.device):
        err = _load().ln_fwd(*map(_ptr, (x, scale, bias, y, mean, rstd)), N,
                             D, eps, p.variant, p.lanes, p.vec, p.chunks,
                             fwd_grid(N, p), cuda_gru._stream(x.device))
    cuda_gru._check(err, "ln_fwd launch")
    FWD_LAUNCHES += 1
    profiling.count("layer_norm_fused")
    return y, mean, rstd


def layer_norm_bwd(x, scale, dy, mean, rstd, need_dx=True):
    """(dx or None, dscale [D], dbias [D]); dx only where `need_dx`."""
    global BWD_LAUNCHES
    if x.device.type == "cpu":
        dx, dscale, dbias = layer_norm_bwd_ref(x, scale, dy, mean, rstd)
        return (dx if need_dx else None), dscale, dbias
    D = x.shape[-1]
    _require(x, D, x=x, scale=scale, dy=dy, mean=mean, rstd=rstd)
    dx = torch.empty_like(x) if need_dx else None
    N = mean.numel()
    if N == 0:
        return dx, torch.zeros_like(scale), torch.zeros_like(scale)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    p = plan(D, _aligned(x, scale, dy))
    index = cuda_gru._index(x.device)
    grid = bwd_grid(N, p, _sms(index), _blocks_per_sm(index, p, D))
    partial = torch.empty(partial_rows(p, grid) * 2 * D, device=x.device)
    with torch.cuda.device(x.device):
        err = _load().ln_bwd(*map(_ptr, (x, scale, dy, mean, rstd, dx,
                                         partial, dscale, dbias)),
                             N, D, p.variant, p.lanes, p.vec, p.chunks, grid,
                             cuda_gru._stream(x.device))
    cuda_gru._check(err, "ln_bwd launch")
    BWD_LAUNCHES += 1
    profiling.count("layer_norm_fused")
    return dx, dscale, dbias


class LayerNorm(torch.autograd.Function):
    """y = LayerNorm(x) * scale + bias over x's last axis, on the kernels.
    Saves x as it came in (a strided x too, so that a double backward
    reaches the caller's x), scale and each row's mean and rstd; the
    kernels take a contiguous copy. Its backward under grad mode runs
    `layer_norm_bwd_ref` in differentiable ops on statistics recomputed
    from x, so a double backward through it is exact."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd(x.contiguous(), scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        if torch.is_grad_enabled():
            if x.device.type == "cuda":
                profiling.count("layer_norm_plain")
            dx, dscale, dbias = layer_norm_bwd_ref(x, scale, dy,
                                                   *stats(x, ctx.eps))
        else:
            dx, dscale, dbias = layer_norm_bwd(
                x.contiguous(), scale, dy.contiguous(), mean, rstd,
                need_dx=ctx.needs_input_grad[0])
        return dx, dscale, dbias, None
