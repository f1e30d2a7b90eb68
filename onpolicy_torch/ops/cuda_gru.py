"""Sequence-mode mask-gated GRU through hand-written CUDA kernels.

Port of `onpolicy_tpu/ops/pallas_gru.py`. The two Pallas TPU kernels
there (`_fwd_call`, `_bwd_call`) become the CUDA kernels of
`csrc/gru_seq.cu`, built with `nvcc` for `sm_90a` into `_build/` on
first use and bound through `ctypes`. The forward and the backward each
have two kernels: a tensor-core one (3xTF32 `mma.sync`) for H in 16, 32,
48, 64, and a CUDA-core one for every other H; `fwd_plan` and `bwd_plan`
choose between them by shape before launch. Beside each kernel stands its
plain PyTorch version (`gru_layer_fwd_ref`, `gru_layer_bwd_ref`): the
wrappers take it only for tensors that lie on the CPU; for a CUDA tensor
they launch the kernel or raise.

`FWD_LAUNCHES` / `BWD_LAUNCHES` count kernel launches (one per wrapper
call that reaches the card), so a run can show that its training path
went through the kernels.

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
        raise RuntimeError("nvcc not found: the GRU kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def library_path() -> Path:
    """Build target, named by the source's content hash: a changed source
    builds anew, an unchanged one is reused."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgru_seq_{tag}.so"


def build() -> Path:
    """Compile `csrc/gru_seq.cu` unless the library for this source exists.
    Writes the compiler's register/shared-memory report beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
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
# tensor-core one
GLOBAL_W, SMEM_W, MMA = 0, 1, 2
VARIANT_NAMES = ("cuda_core_global_w", "cuda_core_smem_w", "tensor_core")
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
    blocks walk the tiles. Every other H, or a card whose blocks cannot
    hold its shared memory, takes `cuda_core_fwd_plan`. `itemsize` is the
    streams' element size (4 f32, 2 bf16): it sizes the staged tiles and
    nothing else, so both types take the same kernel, tile and grid."""
    if H in MMA_WIDTHS:
        bt = 16 if -(-B // 16) >= n_sm else 8
        nbytes = mma_fwd_smem_bytes(H, bt, itemsize)
        if nbytes <= smem_optin:
            grid = min(-(-B // bt), MMA_FWD_BLOCKS_PER_SM * n_sm)
            return FwdPlan(MMA, bt, grid, nbytes)
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
    grid: int             # blocks
    smem_bytes: int       # dynamic shared memory of a block
    partial_floats: int   # scratch for the per-block dW/db partials

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


def bwd_plan(B: int, H: int, n_sm: int, smem_optin: int,
             itemsize: int = 4) -> BwdPlan:
    """Which backward kernel runs for a [T, B, H] layer, on how many blocks
    of how many rows, with how much shared memory. Chosen from the shape
    and the card alone, before launch.

    H in MMA_WIDTHS takes the tensor-core kernel: 16-row tiles, two blocks
    to an SM, when they still give a tile to every SM, else 8-row tiles and
    one block to an SM. min(tiles, blocks per SM * n_sm) blocks walk the
    tiles, so the grid, and with it the bits of dW, follow from (B, H,
    n_sm). Every other H, or a card where those blocks do not fit,
    takes the CUDA-core kernel, one block per `batch_tile` rows, with W in
    shared memory when it fits beside the tile. `itemsize` (4 f32, 2 bf16
    streams) sizes the tensor-core kernel's staged tiles only."""
    nacc = (H + 1) * 3 * H
    if H in MMA_WIDTHS:
        bt = 16 if -(-B // 16) >= n_sm else 8
        nbytes = mma_smem_bytes(H, bt, itemsize)
        per_sm = MMA_BLOCKS_PER_SM[bt]
        if per_sm * (nbytes + SMEM_PER_BLOCK_RESERVED) \
                <= smem_optin + SMEM_PER_BLOCK_RESERVED:
            grid = min(-(-B // bt), per_sm * n_sm)
            return BwdPlan(MMA, bt, grid, nbytes, grid * nacc)
    bt = batch_tile(B, H, n_sm)
    tile = 4 * (5 * bt * H + 2 * bt)
    w = 4 * (H * ((3 * H) | 1) + nacc)
    grid = -(-B // bt)
    if tile + w <= smem_optin:
        return BwdPlan(SMEM_W, bt, grid, tile + w, grid * nacc)
    return BwdPlan(GLOBAL_W, bt, grid, tile, grid * nacc)


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


def device_bwd_plan(device, B: int, H: int, itemsize: int = 4) -> BwdPlan:
    """`bwd_plan` for the card `device`."""
    return _device_bwd_plan(_index(device), B, H, itemsize)


@functools.lru_cache(maxsize=None)
def _device_bwd_plan(index: int, B: int, H: int, itemsize: int) -> BwdPlan:
    return bwd_plan(B, H, *device_limits(index), itemsize)


_STREAMS = ("gir", "giz", "gin", "outs", "douts")


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


def gru_layer_fwd_ref(gir, giz, gin, h0, masks, w_hh, b_hh):
    """Time loop, h carried in f32. Returns (outs [T, B, H] in the
    streams' type, hT [B, H] f32)."""
    h = h0
    outs = []
    for t in range(gir.shape[0]):
        hm = h * masks[t]
        _, z, n, _ = _gates(gir[t], giz[t], gin[t], hm, w_hh, b_hh)
        h = (1.0 - z) * n + z * hm
        outs.append(h)
    return torch.stack(outs).to(gir.dtype), h


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


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernel on the card
# ---------------------------------------------------------------------------

def gru_layer_fwd(gir, giz, gin, h0, masks, w_hh, b_hh, plan=None):
    """One layer forward. Returns (outs [T, B, H], hT [B, H]). On the card
    `plan` (a `FwdPlan`) overrides `device_fwd_plan`, so that two kernels
    can be timed on the same inputs."""
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
    if plan.variant == MMA:
        # it moves 16-byte chunks of the gi streams and of W
        gir, giz, gin, w_hh = (x if x.data_ptr() % 16 == 0 else x.clone()
                               for x in (gir, giz, gin, w_hh))
    with torch.cuda.device(gir.device):
        err = lib.gru_seq_fwd(*map(_ptr, (gir, giz, gin, masks, h0, w_hh,
                                          b_hh, outs, hT)), T, B, H,
                              plan.variant, plan.bt, plan.grid,
                              plan.smem_bytes, STREAM_TYPES[sd],
                              _stream(gir.device))
    _check(err, "gru_seq_fwd launch")
    FWD_LAUNCHES += 1
    return outs, hT


def gru_layer_bwd(gir, giz, gin, outs, h0, masks, douts, dhT, w_hh, b_hh):
    """One layer backward; same outputs as `gru_layer_bwd_ref`."""
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
    dgir, dgiz, dgin = (torch.empty_like(gir) for _ in range(3))
    dh0 = torch.empty_like(h0)
    dw = torch.empty_like(w_hh)
    db = torch.empty_like(b_hh)
    if T == 0 or B == 0:
        return dgir, dgiz, dgin, dhT.clone(), dw.zero_(), db.zero_()
    lib = _load()
    plan = device_bwd_plan(gir.device, B, H, gir.element_size())
    hprev0 = h0.to(sd)   # hprev at t = 0, in the streams' type
    if plan.variant == MMA:
        # its cp.async copies move 16-byte chunks of the streams and of W
        gir, giz, gin, outs, hprev0, douts, w_hh = (
            x if x.data_ptr() % 16 == 0 else x.clone()
            for x in (gir, giz, gin, outs, hprev0, douts, w_hh))
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


# ---------------------------------------------------------------------------
# differentiable layer and the multi-layer sequence
# ---------------------------------------------------------------------------

class GRULayerSequence(torch.autograd.Function):
    """One GRU layer over [T, B, H]; the backward is the backward kernel
    (`gru_layer_sequence`'s custom VJP, pallas_gru.py:258-287). It saves
    gi, outs (in the streams' type), h0, masks and the weights; no gate
    residuals."""

    @staticmethod
    def forward(ctx, gir, giz, gin, h0, masks, w_hh, b_hh):
        outs, hT = gru_layer_fwd(gir, giz, gin, h0, masks, w_hh, b_hh)
        ctx.save_for_backward(gir, giz, gin, outs, h0, masks, w_hh, b_hh)
        return outs, hT

    @staticmethod
    def backward(ctx, douts, dhT):
        gir, giz, gin, outs, h0, masks, w_hh, b_hh = ctx.saved_tensors
        douts = torch.zeros_like(outs) if douts is None \
            else douts.to(outs.dtype).contiguous()
        dhT = torch.zeros_like(h0) if dhT is None \
            else dhT.to(h0.dtype).contiguous()
        dgir, dgiz, dgin, dh0, dw, db = gru_layer_bwd(
            gir, giz, gin, outs, h0, masks, douts, dhT, w_hh, b_hh)
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
