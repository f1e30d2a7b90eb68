"""Sequence-mode mask-gated GRU through hand-written CUDA kernels.

Port of `onpolicy_tpu/ops/pallas_gru.py`. The two Pallas TPU kernels
there (`_fwd_call`, `_bwd_call`) become the CUDA kernels of
`csrc/gru_seq.cu`, built with `nvcc` for `sm_90a` into `_build/` on
first use and bound through `ctypes`. The forward has two kernels: a
tensor-core one (3xTF32 `mma.sync`) for H in 16, 32, 48, 64, and a
CUDA-core one for every other H. The backward has three: the tensor-core
kernel for H in 16..64; for 64 < H <= 512 with H % 32 == 0 the wide one
(`tensor_core_wide`: two 3xTF32 GEMMs, the gate product and dW over all
T*B rows, around a kernel that runs only the recurrent carry; its pieces
are `gru_bwd_gates`, `gru_bwd_carry`, `gru_bwd_dw`); and the CUDA-core
kernel for every other H. `fwd_plan` and `bwd_plan` choose by shape before
launch. The forward at the wide widths (64 < H <= 512, H % 32 == 0) is its
own variant too (`tensor_core_wide`): one 3xTF32 GEMM a time step over all
B rows, launched T times, with the gate math in its epilogue
(`gru_fwd_wide_step`). Beside each kernel stands its plain PyTorch version
(`gru_layer_fwd_ref` and its one-step twin `gru_fwd_step_ref`,
`gru_layer_bwd_ref`, `gru_bwd_{gates,carry,dw}_ref`):
the wrappers take it only for tensors that lie on the CPU; for a CUDA
tensor they launch the kernel or raise.

`FWD_LAUNCHES` / `BWD_LAUNCHES` count kernel launches (one per wrapper
call that reaches the card, whichever kernels the plan runs),
`FWD_STEP_LAUNCHES` the wide forward's step launches (T a call) and
`WIDE_LAUNCHES` the wide backward's pieces, so a run can show that its
training path went through the kernels.

Layout (the JAX package's): gi streams `[T, B, H]`, masks `[T, B, 1]`,
`w_hh [H, 3H]` and `b_hh [3H]` with gate order r, z, n.

Stream type: the `[T, B, H]` sequence streams (gi, outs and their
cotangents) are float32 or, under `use_bf16`, bfloat16 (pallas_gru.py:
310-320); h0, hT, dh0, the masks, W, b, dW, db and all gate math stay
float32, on the card and in the plain versions alike. The backward's
hprev at t = 0 is h0 rounded to the stream type (pallas_gru.py:279-280).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from onpolicy_torch.models import common as cm

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_STEP_LAUNCHES = 0
WIDE_LAUNCHES = {"gates": 0, "carry": 0, "dw": 0}

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "gru_seq.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lib = None


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def library_path(source: Path = SOURCE) -> Path:
    """Build target, named by the source's content hash: a changed source
    builds anew, an unchanged one is reused."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile `source` (default `csrc/gru_seq.cu`; ops/cuda_layer_norm.py
    builds `csrc/layer_norm.cu` the same way) unless the library for this
    source exists. Writes the compiler's register/shared-memory report
    beside it."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_suffix(".ptxas.txt").write_text(res.stderr)
    os.replace(tmp, out)
    return out


def bind(path) -> ctypes.CDLL:
    """The library built from `csrc/gru_seq.cu` at `path`, with the
    signatures of its C entries declared."""
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gru_seq_fwd.argtypes = [P] * 9 + [I] * 8 + [P]
    lib.gru_seq_fwd.restype = I
    lib.gru_seq_bwd.argtypes = [P] * 17 + [I] * 8 + [P]
    lib.gru_seq_bwd.restype = I
    lib.gru_smem_optin.argtypes = []
    lib.gru_smem_optin.restype = I
    lib.gru_wide_fwd.argtypes = [P] * 10 + [I] * 7 + [P]
    lib.gru_wide_fwd.restype = I
    lib.gru_wide_gates.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.gru_wide_gates.restype = I
    lib.gru_wide_carry.argtypes = [P] * 14 + [I] * 7 + [P]
    lib.gru_wide_carry.restype = I
    lib.gru_wide_dw.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.gru_wide_dw.restype = I
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def batch_tile(B: int, H: int, n_sm: int) -> int:
    """Rows per block of the CUDA-core forward and backward:
    the largest tile that still gives two waves of blocks over the card's
    SMs, within a shared-memory cap that keeps the CUDA-core backward's
    five [tile, H] buffers under 160 KB. Multiple of 4. (The tensor-core
    kernels take their tiles from `fwd_plan` and `bwd_plan`.)"""
    cap = max(4, min(64, (8192 // max(H, 1)) // 4 * 4))
    for bt in (64, 32, 16, 8):
        if bt <= cap and -(-B // bt) >= 2 * n_sm:
            return bt
    return min(8, cap)


# kernel variants of both C entries (their `variant`): the CUDA-core kernel
# with W read from global memory or held in shared memory, and the
# tensor-core one; and the wide backward's, launched through its own three
# C entries
GLOBAL_W, SMEM_W, MMA, WIDE = 0, 1, 2, 3
VARIANT_NAMES = ("cuda_core_global_w", "cuda_core_smem_w", "tensor_core",
                 "tensor_core_wide")
MMA_WIDTHS = (16, 32, 48, 64)   # H the tensor-core kernels are built for
MMA_BLOCKS_PER_SM = {8: 1, 16: 2}  # the backward's launch bounds, by tile rows
MMA_FWD_BLOCKS_PER_SM = 2       # the forward's, at either tile
MMA_FWD_STAGES = 2              # its ring of cp.async stages
SMEM_PER_BLOCK_RESERVED = 1024  # shared bytes the card keeps for each block
# element types of the [T, B, H] streams, as the C entries' `stream_type`
STREAM_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _staged_row(H: int, itemsize: int) -> int:
    """Bytes of one staged [H] stream row in the tensor-core kernels: H
    elements and one 16-byte chunk of padding (H + 4 floats, H + 8 bf16),
    a whole number of cp.async chunks whose stride keeps the gate math's
    reads free of bank conflicts."""
    return (H + 16 // itemsize) * itemsize


class FwdPlan(NamedTuple):
    variant: int
    bt: int               # batch rows of a tile
    grid: int             # blocks
    smem_bytes: int       # dynamic shared memory of a block

    @property
    def name(self) -> str:
        return VARIANT_NAMES[self.variant]


def mma_fwd_smem_bytes(H: int, bt: int, itemsize: int = 4) -> int:
    """Shared memory of the tensor-core forward (`FwdLayout` in
    csrc/gru_seq.cu) for streams of `itemsize` bytes: W^T 3H*H f32,
    MMA_FWD_STAGES stages of three staged [bt] x [H] streams and bt f32
    masks, h 2 x [bt][H+4] f32."""
    stage = 3 * bt * _staged_row(H, itemsize) + 4 * bt
    return 4 * 3 * H * H + MMA_FWD_STAGES * stage + 4 * 2 * bt * (H + 4)


def fwd_plan(B: int, H: int, n_sm: int, smem_optin: int,
             itemsize: int = 4) -> FwdPlan:
    """Which forward kernel runs for a [T, B, H] layer, on how many blocks
    of how many rows, with how much shared memory. Chosen from the shape
    and the card alone, before launch.

    H in MMA_WIDTHS takes the tensor-core kernel: 16-row tiles when they
    still give a tile to every SM, else 8-row tiles; min(tiles, 2 * n_sm)
    blocks walk the tiles. H with `wide_widths` (64 < H <= 512,
    H % 32 == 0) takes the wide forward (`wide_fwd_plan`: a GEMM a step,
    its grid from (B, H)). Every other H, or a card whose blocks cannot
    hold its shared memory, takes `cuda_core_fwd_plan`. `itemsize` is the
    streams' element size (4 f32, 2 bf16): it sizes the tensor-core
    kernel's staged tiles and nothing else, so both types take the same
    kernel, tile and grid."""
    if H in MMA_WIDTHS:
        bt = 16 if -(-B // 16) >= n_sm else 8
        nbytes = mma_fwd_smem_bytes(H, bt, itemsize)
        if nbytes <= smem_optin:
            grid = min(-(-B // bt), MMA_FWD_BLOCKS_PER_SM * n_sm)
            return FwdPlan(MMA, bt, grid, nbytes)
    if wide_widths(H):
        plan = wide_fwd_plan(B, H)
        if plan.smem_bytes <= smem_optin:
            return plan
    return cuda_core_fwd_plan(B, H, n_sm, smem_optin)


def cuda_core_fwd_plan(B: int, H: int, n_sm: int, smem_optin: int) -> FwdPlan:
    """The CUDA-core forward: one block per `batch_tile` rows, with W in
    shared memory when it fits beside the tile. It keeps only f32 in
    shared memory (the streams are read from device memory), so its plan
    is the same for either stream type."""
    bt = batch_tile(B, H, n_sm)
    tile = 4 * (2 * bt * H + bt)
    w = 4 * H * ((3 * H) | 1)
    if tile + w <= smem_optin:
        return FwdPlan(SMEM_W, bt, -(-B // bt), tile + w)
    return FwdPlan(GLOBAL_W, bt, -(-B // bt), tile)


class BwdPlan(NamedTuple):
    variant: int
    bt: int               # batch rows of a tile
    grid: int             # blocks (the wide variant: of its carry kernel)
    smem_bytes: int       # dynamic shared memory of a block
    partial_floats: int   # scratch: dW/db partials (the wide variant: and GH)
    splits: int = 0       # the wide variant's K-ranges of its dW GEMM

    @property
    def name(self) -> str:
        return VARIANT_NAMES[self.variant]


def mma_smem_bytes(H: int, bt: int, itemsize: int = 4) -> int:
    """Shared memory of the tensor-core backward (`MmaLayout` in
    csrc/gru_seq.cu) for streams of `itemsize` bytes: W [H][3H+8] f32, two
    stages of five staged [bt] x [H] streams and bt f32 masks,
    hm [bt][H+8] f32, dG [bt][3H+8] f32."""
    stage = 5 * bt * _staged_row(H, itemsize) + 4 * bt
    return 4 * (H * (3 * H + 8) + bt * (H + 8) + bt * (3 * H + 8)) + 2 * stage


# the wide backward (`tensor_core_wide`): its carry kernel's K-chunk, ring
# and register budget, and its GEMMs' tiles (`CarryLayout`, `WideGemm` in
# csrc/gru_seq.cu)
WIDE_MAX_H = 512              # one carry warp per 32 units, 512 threads
CARRY_BT, CARRY_BK, CARRY_STAGES = 32, 32, 2
CARRY_REGS = 128              # registers a thread at 512 threads
GEMM_BM = GEMM_BN = 128
GEMM_BLOCKS_PER_SM = 2
DW_MIN_ROWS = 512             # rows of K a dW split takes at least
DW_MAX_ROWS = 2048            # ... and at most (see `dw_splits`)


# the wide forward: its step GEMM's tiles (`WideFwd` in csrc/gru_seq.cu):
# FWD_BM rows by FWD_U units of each of the three gates, FWD_BK deep
FWD_BM, FWD_U, FWD_BK, FWD_STAGES = 128, 32, 32, 3


def wide_widths(H: int) -> bool:
    """H the wide forward and backward take: 64 < H <= 512, H % 32 == 0."""
    return 64 < H <= WIDE_MAX_H and H % 32 == 0


def wide_fwd_smem_bytes() -> int:
    """Shared memory of the wide forward's step kernel (`WideFwd::BYTES`):
    FWD_STAGES stages of an A tile [FWD_BM][FWD_BK + 4] f32 of h * m and a
    B tile [FWD_BK][3 * FWD_U + 8] f32 of W's columns. The same for every
    wide H and either stream type (A is the f32 h)."""
    a = FWD_BM * (FWD_BK + 4)
    b = FWD_BK * (3 * FWD_U + 8)
    return 4 * FWD_STAGES * (a + b)


def wide_fwd_plan(B: int, H: int) -> FwdPlan:
    """The wide forward: each of its T step launches runs one block per
    FWD_BM rows and FWD_U units, (H / FWD_U) * ceil(B / FWD_BM) blocks."""
    return FwdPlan(WIDE, FWD_BM, (H // FWD_U) * -(-B // FWD_BM),
                   wide_fwd_smem_bytes())


def carry_smem_bytes(H: int) -> int:
    """Shared memory of the carry kernel (`CarryLayout::bytes`): two
    stages of [H + CARRY_BT][CARRY_BK + 4] f32, a K-chunk of W's H rows and
    of the tile's CARRY_BT rows of dG. The same for either stream type."""
    return 4 * CARRY_STAGES * (H + CARRY_BT) * (CARRY_BK + 4)


def dw_splits(T: int, B: int, H: int, n_sm: int) -> int:
    """K-ranges of the dW GEMM: as many as fill GEMM_BLOCKS_PER_SM blocks
    on every SM with its (3H / 128) x (H / 128) output tiles, at least
    DW_MIN_ROWS of the T*B rows each; and at most DW_MAX_ROWS rows each,
    however many ranges that takes: many short ranges spread the GEMM over
    many waves of blocks, so that the last wave leaves few SMs idle."""
    tiles = -(-3 * H // GEMM_BN) * -(-H // GEMM_BM)
    rows = T * B
    return max(1, -(-rows // DW_MAX_ROWS),
               min(GEMM_BLOCKS_PER_SM * n_sm // tiles,
                   -(-rows // DW_MIN_ROWS)))


def wide_bwd_plan(T: int, B: int, H: int, n_sm: int) -> BwdPlan:
    """The wide backward: carry tiles of CARRY_BT rows, as many carry
    blocks as one SM's registers hold at CARRY_REGS a thread (512 // H) on
    each SM, fewer when there are fewer tiles; blocks walk the tiles.
    Scratch: the dW GEMM's `splits` partials of (H + 1) * 3H floats and GH
    (then dG), T*B*3H floats."""
    per_sm = max(1, 65_536 // (CARRY_REGS * H))
    grid = min(-(-B // CARRY_BT), per_sm * n_sm)
    splits = dw_splits(T, B, H, n_sm)
    scratch = splits * (H + 1) * 3 * H + T * B * 3 * H
    return BwdPlan(WIDE, CARRY_BT, grid, carry_smem_bytes(H), scratch,
                   splits)


def cuda_core_bwd_plan(B: int, H: int, n_sm: int, smem_optin: int) -> BwdPlan:
    """The CUDA-core backward: one block per `batch_tile` rows, with W in
    shared memory when it fits beside the tile and the dW/db sums."""
    nacc = (H + 1) * 3 * H
    bt = batch_tile(B, H, n_sm)
    tile = 4 * (5 * bt * H + 2 * bt)
    w = 4 * (H * ((3 * H) | 1) + nacc)
    grid = -(-B // bt)
    if tile + w <= smem_optin:
        return BwdPlan(SMEM_W, bt, grid, tile + w, grid * nacc)
    return BwdPlan(GLOBAL_W, bt, grid, tile, grid * nacc)


def bwd_plan(B: int, H: int, n_sm: int, smem_optin: int,
             itemsize: int = 4, T: int = 1) -> BwdPlan:
    """Which backward kernel runs for a [T, B, H] layer, on how many blocks
    of how many rows, with how much shared memory and scratch. Chosen from
    the shape and the card alone, before launch.

    H in MMA_WIDTHS takes the tensor-core kernel: 16-row tiles, two blocks
    to an SM, when they still give a tile to every SM, else 8-row tiles and
    one block to an SM. min(tiles, blocks per SM * n_sm) blocks walk the
    tiles, so the grid, and with it the bits of dW, follow from (B, H,
    n_sm). H with `wide_widths` (64 < H <= 512, H % 32 == 0) takes the wide
    kernels (`wide_bwd_plan`): 32-row carry tiles; its grid and dW splits
    follow from (T, B, H, n_sm). Every other H, or a card where those
    blocks do not fit, takes the CUDA-core kernel (`cuda_core_bwd_plan`).
    `itemsize` (4 f32, 2 bf16 streams) sizes the tensor-core kernel's
    staged tiles only; `T` sizes the wide kernels' scratch and dW splits."""
    nacc = (H + 1) * 3 * H
    if H in MMA_WIDTHS:
        bt = 16 if -(-B // 16) >= n_sm else 8
        nbytes = mma_smem_bytes(H, bt, itemsize)
        per_sm = MMA_BLOCKS_PER_SM[bt]
        if per_sm * (nbytes + SMEM_PER_BLOCK_RESERVED) \
                <= smem_optin + SMEM_PER_BLOCK_RESERVED:
            grid = min(-(-B // bt), per_sm * n_sm)
            return BwdPlan(MMA, bt, grid, nbytes, grid * nacc)
    if wide_widths(H):
        plan = wide_bwd_plan(T, B, H, n_sm)
        if plan.smem_bytes <= smem_optin:
            return plan
    return cuda_core_bwd_plan(B, H, n_sm, smem_optin)


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, opt-in shared bytes of a block) of card `index`."""
    with torch.cuda.device(index):
        optin = _load().gru_smem_optin()
    return torch.cuda.get_device_properties(index).multi_processor_count, optin


def device_fwd_plan(device, B: int, H: int, itemsize: int = 4) -> FwdPlan:
    """`fwd_plan` for the card `device`."""
    return _device_fwd_plan(_index(device), B, H, itemsize)


@functools.lru_cache(maxsize=None)
def _device_fwd_plan(index: int, B: int, H: int, itemsize: int) -> FwdPlan:
    return fwd_plan(B, H, *device_limits(index), itemsize)


def device_bwd_plan(device, B: int, H: int, itemsize: int = 4,
                    T: int = 1) -> BwdPlan:
    """`bwd_plan` for the card `device`."""
    return _device_bwd_plan(_index(device), B, H, itemsize, T)


@functools.lru_cache(maxsize=None)
def _device_bwd_plan(index: int, B: int, H: int, itemsize: int,
                     T: int) -> BwdPlan:
    return bwd_plan(B, H, *device_limits(index), itemsize, T)


_STREAMS = ("gir", "giz", "gin", "outs", "douts", "hprev0")


def _stream_dtype(gir):
    if gir.dtype not in STREAM_TYPES:
        raise ValueError(f"gir is {gir.dtype}; the kernels take float32 "
                         "streams, or bfloat16 streams")
    return gir.dtype


def _require(tensors: dict, shapes: dict, device, stream_dtype):
    """The [T, B, H] streams in `stream_dtype`, everything else in float32."""
    for name, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")
        want = stream_dtype if name in _STREAMS else torch.float32
        if x.dtype != want:
            raise ValueError(f"{name} is {x.dtype}; the kernels take {want} "
                             "here (float32, with bfloat16 allowed for the "
                             "[T, B, H] streams)")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shapes[name]}")


def _shapes(T, B, H, **extra):
    seq = (T, B, H)
    d = {"gir": seq, "giz": seq, "gin": seq, "masks": (T, B, 1),
         "h0": (B, H), "w_hh": (H, 3 * H), "b_hh": (3 * H,)}
    d.update(extra)
    return d


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def _gates(gir, giz, gin, hm, w_hh, b_hh):
    """Gate math in f32, whatever the streams' type (`.float()` is the
    identity on f32)."""
    H = hm.shape[-1]
    ghr = hm @ w_hh[:, :H] + b_hh[:H]
    ghz = hm @ w_hh[:, H:2 * H] + b_hh[H:2 * H]
    ghn = hm @ w_hh[:, 2 * H:] + b_hh[2 * H:]
    r = torch.sigmoid(gir.float() + ghr)
    z = torch.sigmoid(giz.float() + ghz)
    n = torch.tanh(gin.float() + r * ghn)
    return r, z, n, ghn


def gru_fwd_step_ref(gir_t, giz_t, gin_t, h, m_t, w_hh, b_hh):
    """One step of the forward, as the wide forward's step kernel computes
    it: the gate product (h * m_t) @ W_hh + b_hh over the step's rows and
    the gate math. `h` [B, H] f32, `m_t` [B, 1]. Returns (out_t [B, H] in
    the streams' type, h_t [B, H] f32)."""
    hm = h * m_t
    _, z, n, _ = _gates(gir_t, giz_t, gin_t, hm, w_hh, b_hh)
    h = (1.0 - z) * n + z * hm
    return h.to(gir_t.dtype), h


def gru_layer_fwd_ref(gir, giz, gin, h0, masks, w_hh, b_hh):
    """Time loop of `gru_fwd_step_ref`, h carried in f32. Returns
    (outs [T, B, H] in the streams' type, hT [B, H] f32)."""
    h = h0
    outs = []
    for t in range(gir.shape[0]):
        out, h = gru_fwd_step_ref(gir[t], giz[t], gin[t], h, masks[t], w_hh,
                                  b_hh)
        outs.append(out)
    return torch.stack(outs), h


def gru_layer_bwd_ref(gir, giz, gin, outs, h0, masks, douts, dhT, w_hh, b_hh):
    """Reverse loop that rematerializes the gates from gi and
    hprev = [h0, outs[:-1]] (h0 rounded to the streams' type, as
    `_layer_bwd` builds it), as `_bwd_kernel` does. Returns
    (dgir, dgiz, dgin [T, B, H] in the streams' type, dh0 [B, H],
    dw_hh [H, 3H], db_hh [3H] in f32). The masks get no cotangent."""
    T, _, H = gir.shape
    h0p = h0.to(outs.dtype)
    dh = dhT
    dw = torch.zeros_like(w_hh)
    db = torch.zeros_like(b_hh)
    dgr, dgz, dgn = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        hm = (outs[t - 1] if t > 0 else h0p).float() * masks[t]
        r, z, n, ghn = _gates(gir[t], giz[t], gin[t], hm, w_hh, b_hh)
        dh = dh + douts[t].float()
        dz = dh * (hm - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * ghn * r * (1.0 - r)
        dgate = torch.cat([dr, dz, dn * r], dim=-1)           # [B, 3H]
        d_hm = dh * z + dgate @ w_hh.T
        dh = d_hm * masks[t]
        dw = dw + hm.T @ dgate
        db = db + dgate.sum(0)
        dgr[t], dgz[t], dgn[t] = dr, dz, dn
    sd = gir.dtype
    return (torch.stack(dgr).to(sd), torch.stack(dgz).to(sd),
            torch.stack(dgn).to(sd), dh, dw, db)


# The wide backward's three pieces, each a plain function of what its
# kernel reads. `hprev0` is hprev at t = 0: h0 in the streams' type.

def _hm(outs, hprev0, masks):
    """hm = [hprev0, outs[:-1]] * masks, widened to f32: [T, B, H]."""
    return torch.cat([hprev0[None], outs[:-1]]).float() * masks


def gru_bwd_gates_ref(outs, hprev0, masks, w_hh, b_hh):
    """GH = hm @ W_hh + b_hh over all T*B rows: [T, B, 3H] f32."""
    return _hm(outs, hprev0, masks) @ w_hh + b_hh


def gru_bwd_carry_ref(gir, giz, gin, outs, hprev0, masks, douts, dhT, w_hh,
                      gh):
    """The recurrent carry, from the gates' hidden products `gh` [T, B, 3H].
    Returns (dgir, dgiz, dgin [T, B, H] in the streams' type, dh0 [B, H],
    dG [T, B, 3H] f32 = [dr, dz, dn * r])."""
    T, _, H = gir.shape
    hm = _hm(outs, hprev0, masks)
    dh = dhT
    dg = torch.empty_like(gh)
    dgr, dgz, dgn = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        ghr, ghz, ghn = gh[t].split(H, dim=-1)
        r = torch.sigmoid(gir[t].float() + ghr)
        z = torch.sigmoid(giz[t].float() + ghz)
        n = torch.tanh(gin[t].float() + r * ghn)
        dh = dh + douts[t].float()
        dz = dh * (hm[t] - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * ghn * r * (1.0 - r)
        dg[t] = torch.cat([dr, dz, dn * r], dim=-1)
        dh = (dh * z + dg[t] @ w_hh.T) * masks[t]
        dgr[t], dgz[t], dgn[t] = dr, dz, dn
    sd = gir.dtype
    return (torch.stack(dgr).to(sd), torch.stack(dgz).to(sd),
            torch.stack(dgn).to(sd), dh, dg)


def gru_bwd_dw_ref(outs, hprev0, masks, dg):
    """dW_hh = hm^T @ dG and db_hh = the column sums of dG, over all T*B
    rows, from the f32 dG [T, B, 3H]."""
    H = outs.shape[-1]
    hm = _hm(outs, hprev0, masks).reshape(-1, H)
    d = dg.reshape(-1, dg.shape[-1])
    return hm.T @ d, d.sum(0)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernel on the card
# ---------------------------------------------------------------------------

def gru_layer_fwd(gir, giz, gin, h0, masks, w_hh, b_hh, plan=None):
    """One layer forward. Returns (outs [T, B, H], hT [B, H]). On the card
    `plan` (a `FwdPlan`) overrides `device_fwd_plan`, so that two kernels
    can be timed on the same inputs. The wide plan launches its step kernel
    T times; it counts as one launch (and T in `FWD_STEP_LAUNCHES`)."""
    global FWD_LAUNCHES
    if gir.device.type == "cpu":
        return gru_layer_fwd_ref(gir, giz, gin, h0, masks, w_hh, b_hh)
    if gir.device.type != "cuda":
        raise ValueError(f"unsupported device {gir.device}")
    T, B, H = gir.shape
    sd = _stream_dtype(gir)
    ins = dict(gir=gir, giz=giz, gin=gin, masks=masks, h0=h0, w_hh=w_hh,
               b_hh=b_hh)
    _require(ins, _shapes(T, B, H), gir.device, sd)
    outs = torch.empty_like(gir)
    hT = torch.empty_like(h0)
    if T == 0 or B == 0:
        return outs, h0.clone()
    lib = _load()
    plan = plan or device_fwd_plan(gir.device, B, H, gir.element_size())
    if plan.variant == WIDE:
        return _wide_fwd(lib, gir, giz, gin, h0, masks, w_hh, b_hh, outs, hT,
                         plan)
    if plan.variant == MMA:
        # it moves 16-byte chunks of the gi streams and of W
        gir, giz, gin, w_hh = _aligned(gir, giz, gin, w_hh)
    with torch.cuda.device(gir.device):
        err = lib.gru_seq_fwd(*map(_ptr, (gir, giz, gin, masks, h0, w_hh,
                                          b_hh, outs, hT)), T, B, H,
                              plan.variant, plan.bt, plan.grid,
                              plan.smem_bytes, STREAM_TYPES[sd],
                              _stream(gir.device))
    _check(err, "gru_seq_fwd launch")
    FWD_LAUNCHES += 1
    return outs, hT


def _wide_fwd(lib, gir, giz, gin, h0, masks, w_hh, b_hh, outs, hT, plan):
    """The wide forward's T step launches into `outs` and `hT`, h carried
    in f32 through a [min(T - 1, 2), B, H] scratch buffer."""
    global FWD_LAUNCHES, FWD_STEP_LAUNCHES
    T, B, H = gir.shape
    if not wide_widths(H) or plan != wide_fwd_plan(B, H):
        raise ValueError(f"{plan} is not the wide forward's plan for B={B} "
                         f"H={H} (it takes 64 < H <= {WIDE_MAX_H}, "
                         "H % 32 == 0)")
    # it moves 16-byte chunks of h0 and W, pairs of the gi streams
    gir, giz, gin, h0, w_hh = _aligned(gir, giz, gin, h0, w_hh)
    hbuf = torch.empty(min(T - 1, 2), B, H, device=gir.device)
    with torch.cuda.device(gir.device):
        err = lib.gru_wide_fwd(*map(_ptr, (gir, giz, gin, masks, h0, w_hh,
                                           b_hh, outs, hT, hbuf)), T, B, H,
                               plan.bt, plan.grid, plan.smem_bytes,
                               STREAM_TYPES[gir.dtype], _stream(gir.device))
    _check(err, "gru_wide_fwd launch")
    FWD_LAUNCHES += 1
    FWD_STEP_LAUNCHES += T
    return outs, hT


def gru_layer_bwd(gir, giz, gin, outs, h0, masks, douts, dhT, w_hh, b_hh,
                  plan=None):
    """One layer backward; same outputs as `gru_layer_bwd_ref`. On the card
    `plan` (a `BwdPlan`) overrides `device_bwd_plan`, so that two kernels
    can be timed on the same inputs. The wide plan launches its three
    pieces (`gru_bwd_gates`, `gru_bwd_carry`, `gru_bwd_dw`) in one scratch
    buffer of `plan.partial_floats`; it counts as one launch."""
    global BWD_LAUNCHES
    if gir.device.type == "cpu":
        return gru_layer_bwd_ref(gir, giz, gin, outs, h0, masks, douts, dhT,
                                 w_hh, b_hh)
    if gir.device.type != "cuda":
        raise ValueError(f"unsupported device {gir.device}")
    T, B, H = gir.shape
    sd = _stream_dtype(gir)
    ins = dict(gir=gir, giz=giz, gin=gin, outs=outs, masks=masks, h0=h0,
               douts=douts, dhT=dhT, w_hh=w_hh, b_hh=b_hh)
    _require(ins, _shapes(T, B, H, outs=(T, B, H), douts=(T, B, H),
                          dhT=(B, H)), gir.device, sd)
    if T == 0 or B == 0:
        return (*(torch.empty_like(gir) for _ in range(3)), dhT.clone(),
                torch.zeros_like(w_hh), torch.zeros_like(b_hh))
    plan = plan or device_bwd_plan(gir.device, B, H, gir.element_size(), T)
    hprev0 = h0.to(sd)   # hprev at t = 0, in the streams' type
    if plan.variant == WIDE:
        nacc = (H + 1) * 3 * H
        if plan.partial_floats != plan.splits * nacc + T * B * 3 * H:
            raise ValueError(f"{plan} is not a plan for T={T} B={B} H={H}")
        scratch = torch.empty(plan.partial_floats, device=gir.device)
        gh = scratch[plan.splits * nacc:].view(T, B, 3 * H)
        gru_bwd_gates(outs, hprev0, masks, w_hh, b_hh, out=gh)
        dgir, dgiz, dgin, dh0, dg = gru_bwd_carry(
            gir, giz, gin, outs, hprev0, masks, douts, dhT, w_hh, gh, plan)
        dw, db = gru_bwd_dw(outs, hprev0, masks, dg, plan.splits,
                            scratch[:plan.splits * nacc])
        BWD_LAUNCHES += 1
        return dgir, dgiz, dgin, dh0, dw, db
    dgir, dgiz, dgin = (torch.empty_like(gir) for _ in range(3))
    dh0 = torch.empty_like(h0)
    dw = torch.empty_like(w_hh)
    db = torch.empty_like(b_hh)
    lib = _load()
    if plan.variant == MMA:
        # its cp.async copies move 16-byte chunks of the streams and of W
        gir, giz, gin, outs, hprev0, douts, w_hh = _aligned(
            gir, giz, gin, outs, hprev0, douts, w_hh)
    partial = torch.empty(plan.partial_floats, device=gir.device)
    with torch.cuda.device(gir.device):
        err = lib.gru_seq_bwd(*map(_ptr, (gir, giz, gin, outs, masks, hprev0,
                                          douts, dhT, w_hh, b_hh, dgir, dgiz,
                                          dgin, dh0, dw, db, partial)),
                              T, B, H, plan.variant, plan.bt, plan.grid,
                              plan.smem_bytes, STREAM_TYPES[sd],
                              _stream(gir.device))
    _check(err, "gru_seq_bwd launch")
    BWD_LAUNCHES += 1
    return dgir, dgiz, dgin, dh0, dw, db


def _aligned(*xs):
    """Each tensor where it lies if it starts on a 16-byte boundary, else a
    copy: the kernels move 16-byte chunks of these."""
    return [x if x.data_ptr() % 16 == 0 else x.clone() for x in xs]


def _wide_args(ins, T, B, H, sd, device):
    """Checks the wide pieces' inputs; `gh` / `dg` are [T, B, 3H] f32."""
    _require(ins, _shapes(T, B, H, outs=(T, B, H), douts=(T, B, H),
                          hprev0=(B, H), dhT=(B, H), gh=(T, B, 3 * H),
                          dg=(T, B, 3 * H)), device, sd)
    if not wide_widths(H) or T == 0 or B == 0:
        raise ValueError(f"the wide backward takes T, B > 0 and 64 < H <= "
                         f"{WIDE_MAX_H}, H % 32 == 0; got T={T} B={B} H={H}")


def gru_bwd_gates(outs, hprev0, masks, w_hh, b_hh, out=None):
    """GH [T, B, 3H] f32, as `gru_bwd_gates_ref`. On the card the gate GEMM
    (`gru_bwd_gates_gemm`), into `out` when given."""
    if outs.device.type == "cpu":
        return gru_bwd_gates_ref(outs, hprev0, masks, w_hh, b_hh)
    T, B, H = outs.shape
    sd = _stream_dtype(outs)
    _wide_args(dict(outs=outs, hprev0=hprev0, masks=masks, w_hh=w_hh,
                    b_hh=b_hh), T, B, H, sd, outs.device)
    gh = torch.empty(T, B, 3 * H, device=outs.device) if out is None else out
    outs, hprev0, w_hh = _aligned(outs, hprev0, w_hh)
    with torch.cuda.device(outs.device):
        err = _load().gru_wide_gates(
            *map(_ptr, (outs, hprev0, masks, w_hh, b_hh, gh)), T, B, H,
            STREAM_TYPES[sd], _stream(outs.device))
    _check(err, "gru_wide_gates launch")
    WIDE_LAUNCHES["gates"] += 1
    return gh


def gru_bwd_carry(gir, giz, gin, outs, hprev0, masks, douts, dhT, w_hh, gh,
                  plan=None):
    """(dgir, dgiz, dgin, dh0, dG), as `gru_bwd_carry_ref`. On the card the
    carry kernel (`gru_bwd_carry`) on `plan`'s tiles and grid (default:
    `device_bwd_plan`'s, which must be the wide one); dG is written over
    `gh`, and the returned dG is that tensor."""
    if gir.device.type == "cpu":
        return gru_bwd_carry_ref(gir, giz, gin, outs, hprev0, masks, douts,
                                 dhT, w_hh, gh)
    T, B, H = gir.shape
    sd = _stream_dtype(gir)
    _wide_args(dict(gir=gir, giz=giz, gin=gin, outs=outs, hprev0=hprev0,
                    masks=masks, douts=douts, dhT=dhT, w_hh=w_hh, gh=gh),
               T, B, H, sd, gir.device)
    plan = plan or device_bwd_plan(gir.device, B, H, gir.element_size(), T)
    if plan.variant != WIDE:
        raise ValueError(f"{plan} is not a plan of the wide backward")
    # gh is written in place, so it is taken where it lies (the kernel
    # refuses one that is not 16-byte aligned)
    gir, giz, gin, outs, hprev0, douts, dhT, w_hh = _aligned(
        gir, giz, gin, outs, hprev0, douts, dhT, w_hh)
    dgir, dgiz, dgin = (torch.empty_like(gir) for _ in range(3))
    dh0 = torch.empty(B, H, device=gir.device)
    with torch.cuda.device(gir.device):
        err = _load().gru_wide_carry(
            *map(_ptr, (gir, giz, gin, outs, masks, hprev0, douts, dhT, w_hh,
                        gh, dgir, dgiz, dgin, dh0)),
            T, B, H, plan.bt, plan.grid, plan.smem_bytes, STREAM_TYPES[sd],
            _stream(gir.device))
    _check(err, "gru_wide_carry launch")
    WIDE_LAUNCHES["carry"] += 1
    return dgir, dgiz, dgin, dh0, gh


def gru_bwd_dw(outs, hprev0, masks, dg, splits=None, partial=None):
    """(dW_hh [H, 3H], db_hh [3H]), as `gru_bwd_dw_ref`. On the card the
    split-K dW GEMM (`gru_bwd_dw_gemm`) over `splits` K-ranges (default:
    `dw_splits` for the card) into `partial` (splits * (H + 1) * 3H floats
    of scratch, allocated when not given), then `gru_bwd_reduce` sums the
    ranges in order."""
    if outs.device.type == "cpu":
        return gru_bwd_dw_ref(outs, hprev0, masks, dg)
    T, B, H = outs.shape
    sd = _stream_dtype(outs)
    _wide_args(dict(outs=outs, hprev0=hprev0, masks=masks, dg=dg),
               T, B, H, sd, outs.device)
    if splits is None:
        splits = dw_splits(T, B, H, device_limits(_index(outs.device))[0])
    nacc = (H + 1) * 3 * H
    if partial is None:
        partial = torch.empty(splits * nacc, device=outs.device)
    if partial.numel() != splits * nacc:
        raise ValueError(f"partial holds {partial.numel()} floats, the dW "
                         f"GEMM writes {splits} x {nacc}")
    outs, hprev0, dg, partial = _aligned(outs, hprev0, dg, partial)
    dw = torch.empty(H, 3 * H, device=outs.device)
    db = torch.empty(3 * H, device=outs.device)
    with torch.cuda.device(outs.device):
        err = _load().gru_wide_dw(
            *map(_ptr, (outs, hprev0, masks, dg, partial, dw, db)), T, B, H,
            splits, STREAM_TYPES[sd], _stream(outs.device))
    _check(err, "gru_wide_dw launch")
    WIDE_LAUNCHES["dw"] += 1
    return dw, db


# ---------------------------------------------------------------------------
# differentiable layer and the multi-layer sequence
# ---------------------------------------------------------------------------

class _SecondOrderRefused(torch.autograd.Function):
    """The identity on a backward's results, built only when that
    backward runs under `create_graph=True`; its own backward raises.
    Its inputs also take what the results depend on (the incoming
    cotangents and the saved tensors that need a gradient), so every
    double backward that needs the results reaches it. torch's
    `once_differentiable` hangs its error node on detached copies
    instead, which `torch.autograd.grad(..., inputs)` prunes: a
    Fisher-vector product through the kernels would drop the GRU's
    second-order terms without a word."""

    @staticmethod
    def forward(ctx, n, *tensors):
        return tuple(t.clone() for t in tensors[:n])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "GRULayerSequence is once differentiable: the GRU kernels' "
            "backward cannot be differentiated again (a double backward, "
            "e.g. HATRPO's Fisher-vector product, runs the plain scan: "
            "models/gru.py)")


class GRULayerSequence(torch.autograd.Function):
    """One GRU layer over [T, B, H]; the backward is the backward kernel
    (`gru_layer_sequence`'s custom VJP, pallas_gru.py:258-287). It saves
    gi, outs (in the streams' type), h0, masks and the weights; no gate
    residuals. The backward is once differentiable: it runs without a
    graph, and under `create_graph=True` its results pass through
    `_SecondOrderRefused`, so a double backward raises instead of
    dropping the GRU's second-order terms."""

    @staticmethod
    def forward(ctx, gir, giz, gin, h0, masks, w_hh, b_hh):
        outs, hT = gru_layer_fwd(gir, giz, gin, h0, masks, w_hh, b_hh)
        ctx.save_for_backward(gir, giz, gin, outs, h0, masks, w_hh, b_hh)
        return outs, hT

    @staticmethod
    def backward(ctx, douts, dhT):
        saved = ctx.saved_tensors
        gir, giz, gin, outs, h0, masks, w_hh, b_hh = saved
        with torch.no_grad():
            douts_ = torch.zeros_like(outs) if douts is None \
                else douts.to(outs.dtype).contiguous()
            dhT_ = torch.zeros_like(h0) if dhT is None \
                else dhT.to(h0.dtype).contiguous()
            grads = gru_layer_bwd(gir, giz, gin, outs, h0, masks, douts_,
                                  dhT_, w_hh, b_hh)
        if torch.is_grad_enabled():
            deps = [t for t in (douts, dhT, *saved)
                    if t is not None and t.requires_grad]
            grads = _SecondOrderRefused.apply(len(grads), *grads, *deps)
        dgir, dgiz, dgin, dh0, dw, db = grads
        return dgir, dgiz, dgin, dh0, None, dw, db


def sequence(params, xs, hxs, masks, stream_dtype=torch.float32):
    """Kernel-backed equivalent of `pallas_gru.sequence`.

    xs [T, B, in]; hxs [B, recurrent_N, H]; masks [T, B, 1].
    Returns (outs [T, B, H] after LayerNorm, in `stream_dtype`, and the
    final hxs [B, recurrent_N, H] in f32). The input projections and the
    LayerNorm are plain PyTorch, as the JAX package leaves them to XLA
    (pallas_gru.py:315-341): with bf16 streams, xs, w_ih and b_ih are cast
    to bf16 for the projections and the LayerNorm runs in bf16 with its
    parameters cast; h0 stays f32.
    """
    T, B, _ = xs.shape
    sd = stream_dtype
    m = masks.to(torch.float32).contiguous()
    h0s = hxs.to(torch.float32)
    inp = xs.to(sd)
    finals = []
    for i, layer in enumerate(params["layers"]):
        H = layer["w_hh"].shape[0]
        flat = inp.reshape(T * B, -1)
        wi, bi = layer["w_ih"].to(sd), layer["b_ih"].to(sd)
        gir = (flat @ wi[:, :H] + bi[:H]).reshape(T, B, H)
        giz = (flat @ wi[:, H:2 * H] + bi[H:2 * H]).reshape(T, B, H)
        gin = (flat @ wi[:, 2 * H:] + bi[2 * H:]).reshape(T, B, H)
        outs, hT = GRULayerSequence.apply(
            gir, giz, gin, h0s[:, i].contiguous(), m,
            layer["w_hh"].contiguous(), layer["b_hh"].contiguous())
        finals.append(hT)
        inp = outs
    norm = cm.cast_floats(params["norm"], sd)
    return cm.layer_norm_apply(norm, inp), torch.stack(finals, 1)
