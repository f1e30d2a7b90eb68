"""Mask-gated multi-layer GRU with output LayerNorm.

Port of `onpolicy_tpu/models/gru.py`. Two modes:

  * single step (rollout, `step`): the hidden state is multiplied by the
    episode mask before the cell. Plain torch, as in the JAX package,
    which also computes it outside any kernel; under `use_bf16` in bf16
    (parameters, state and mask cast), the new state returned in f32;
  * sequence (training, `sequence`): the gated form `h ← h·mask_t` at
    every step over [T, B, ...]. For tensors on the card it runs the CUDA
    kernels of `ops/cuda_gru.py`: there is no routing rule by width. For
    tensors on the CPU it runs `scan_sequence`, the plain time loop, which
    is also the tests' reference. Under `use_bf16` it follows the kernels'
    semantics on both devices (bf16 [T, B, H] streams, f32 state, weights
    and gate math, `pallas_gru.py:310-320`): on the CPU through the
    kernels' plain versions, not a bf16 scan. HATRPO is the exception, as
    in the JAX package (`models/gru.py:96-101` there): its Fisher-vector
    product differentiates the GRU twice, which the kernels' backward
    cannot, so unless `use_pallas_gru` asks for the kernels it runs the
    plain scan on both devices, in the compute dtype as the JAX scan does.

Gate math matches torch.nn.GRU (gate order r, z, n; b_ih and b_hh kept
separate so the r·(W_hn h + b_hn) coupling is exact). Weights are stored
`w_ih [in, 3H]`, `w_hh [H, 3H]`. Hidden-state layout at the API boundary:
[batch, recurrent_N, H].
"""
from __future__ import annotations

import functools
import sys

import torch

from onpolicy_torch.models import common as cm
from onpolicy_torch.ops import cuda_gru


def init(cfg, input_dim: int, generator: torch.Generator, device):
    H = cfg.hidden_size
    init_fn = cm.orthogonal if cfg.use_orthogonal else cm.xavier_uniform
    layers = []
    d_in = input_dim
    for _ in range(cfg.recurrent_N):
        layers.append({
            "w_ih": init_fn((d_in, 3 * H), 1.0, generator, device),
            "w_hh": init_fn((H, 3 * H), 1.0, generator, device),
            "b_ih": torch.zeros(3 * H, device=device),
            "b_hh": torch.zeros(3 * H, device=device),
        })
        d_in = H
    return {"layers": layers, "norm": cm.layer_norm_init(H, device)}


def _cell(layer, x, h):
    """One GRU cell step. x: [B, in], h: [B, H] → h': [B, H]."""
    H = h.shape[-1]
    gi = x @ layer["w_ih"] + layer["b_ih"]
    gh = h @ layer["w_hh"] + layer["b_hh"]
    i_r, i_z, i_n = gi[..., :H], gi[..., H:2 * H], gi[..., 2 * H:]
    h_r, h_z, h_n = gh[..., :H], gh[..., H:2 * H], gh[..., 2 * H:]
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def step(cfg, params, x, hxs, masks):
    """Single rollout step. x: [B, in]; hxs: [B, recurrent_N, H];
    masks: [B, 1]. Returns (out [B, H] in the compute dtype, new_hxs
    [B, recurrent_N, H] f32)."""
    dt = cm.compute_dtype(cfg)
    params = cm.cast_floats(params, dt)
    hxs = hxs.to(dt) * masks[..., None].to(dt)
    new_h = []
    inp = x.to(dt)
    for i, layer in enumerate(params["layers"]):
        inp = _cell(layer, inp, hxs[:, i])
        new_h.append(inp)
    return (cm.layer_norm_apply(params["norm"], inp),
            torch.stack(new_h, 1).float())


def scan_sequence(params, xs, hxs, masks):
    """Plain time loop over a [T, B, in] sequence with per-step mask
    gating. Returns (outs [T, B, H] after LayerNorm, final hxs)."""
    h = hxs
    outs = []
    for t in range(xs.shape[0]):
        h = h * masks[t][..., None]
        new_h = []
        inp = xs[t]
        for i, layer in enumerate(params["layers"]):
            inp = _cell(layer, inp, h[:, i])
            new_h.append(inp)
        h = torch.stack(new_h, 1)
        outs.append(inp)
    return cm.layer_norm_apply(params["norm"], torch.stack(outs)), h


def scan_in_dtype(params, xs, hxs, masks, dt):
    """`scan_sequence` in the compute dtype, as the JAX package's scan
    runs it (`models/gru.py:126-141` there): parameters, inputs, state and
    masks cast to `dt`, the final state returned in f32; for f32 the scan
    itself."""
    if dt == torch.float32:
        return scan_sequence(params, xs, hxs, masks)
    outs, h = scan_sequence(cm.cast_floats(params, dt), xs.to(dt),
                            hxs.to(dt), masks.to(dt))
    return outs, h.float()


@functools.lru_cache(maxsize=None)
def _note_hatrpo_scan():
    print("onpolicy_torch: hatrpo runs the sequence GRU as the plain scan, "
          "as the JAX package routes it (its Fisher-vector product "
          "differentiates the GRU twice; the kernels' backward cannot)",
          file=sys.stderr, flush=True)


def sequence(cfg, params, xs, hxs, masks):
    """xs [T, B, in]; hxs [B, recurrent_N, H]; masks [T, B, 1].
    Returns (outs [T, B, H], final hxs [B, recurrent_N, H]).

    On the card: the CUDA kernels. On the CPU: the plain scan in f32, and
    under `use_bf16` the kernels' plain versions with bf16 streams;
    `use_pallas_gru=True` there raises, as the kernels exist only on the
    card, and `use_pallas_gru=False` on the card raises likewise. HATRPO
    runs the plain scan in the compute dtype on both devices unless
    `use_pallas_gru=True` forces the kernels (whose double backward then
    raises)."""
    explicit = getattr(cfg, "use_pallas_gru", None)
    dt = cm.compute_dtype(cfg)
    hatrpo = getattr(cfg, "algorithm_name", "") == "hatrpo"
    if hatrpo and not explicit:
        if xs.is_cuda:
            _note_hatrpo_scan()
        return scan_in_dtype(params, xs, hxs, masks, dt)
    if xs.is_cuda:
        if explicit is False:
            raise ValueError("use_pallas_gru=False: the plain GRU scan is "
                             "the CPU path, not a path on the card")
        return cuda_gru.sequence(params, xs, hxs, masks, dt)
    if explicit:
        raise ValueError("use_pallas_gru=True on CPU tensors: the GRU "
                         "kernels run on the card only")
    if dt != torch.float32:
        return cuda_gru.sequence(params, xs, hxs, masks, dt)
    return scan_sequence(params, xs, hxs, masks)
