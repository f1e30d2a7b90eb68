"""Shared layer primitives: initializers, linear, layer-norm.

Port of `onpolicy_tpu/models/common.py`. Parameters are plain nested
dicts of tensors with the JAX package's layout: a linear weight is
stored `[in, out]` and applied as `x @ w + b` (not `nn.Linear`'s
`[out, in]`), so a JAX parameter tree carries across leaf for leaf
(`utils/params.py`).
"""
from __future__ import annotations

import math

import torch

from onpolicy_torch.ops import cuda_layer_norm as cln
from onpolicy_torch.utils import profiling
from onpolicy_torch.utils.tree import tree_map

LN_EPS = 1e-5  # torch nn.LayerNorm default


def calculate_gain(activation: str) -> float:
    if activation == "relu":
        return math.sqrt(2.0)
    if activation == "tanh":
        return 5.0 / 3.0
    if activation in ("linear", "sigmoid"):
        return 1.0
    raise ValueError(activation)


def orthogonal(shape, gain, generator, device):
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.orthogonal_(w, gain=gain, generator=generator)
    return w.to(device)


def xavier_uniform(shape, gain, generator, device):
    fan_in, fan_out = shape[0], shape[1]
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32).uniform_(-a, a,
                                                         generator=generator)
    return w.to(device)


def linear_init(in_dim: int, out_dim: int, *, gain: float, use_orthogonal: bool,
                generator: torch.Generator, device):
    """Weight stored [in, out]; drawn on the host generator, then moved."""
    init_fn = orthogonal if use_orthogonal else xavier_uniform
    return {"w": init_fn((in_dim, out_dim), gain, generator, device),
            "b": torch.zeros(out_dim, device=device)}


def linear_apply(p, x):
    return x @ p["w"] + p["b"]


def layer_norm_init(dim: int, device):
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layer_norm_apply(p, x):
    """Biased variance, as `jnp.var` (`common.py:57-61`). On the card an
    f32 x runs on the fused kernels (`ops/cuda_layer_norm.LayerNorm`);
    elsewhere, as decomposed ops: the two moments are taken in f32 and
    rounded to x's type, as `jnp.mean` and `jnp.var` do for bf16; on f32
    the casts are the identity."""
    if cln.served_by_kernels(x.device, x.dtype):
        return cln.LayerNorm.apply(x, p["scale"], p["bias"], LN_EPS)
    if x.device.type == "cuda":
        profiling.count("layer_norm_plain")
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    return y * p["scale"] + p["bias"]


def activation_fn(use_relu: bool):
    return torch.relu if use_relu else torch.tanh


def compute_dtype(cfg):
    """bf16 mixed precision (cfg.use_bf16, `common.py:68-71`): the MLP's and
    the GRU's matmuls and LayerNorms run in bfloat16; parameters, heads,
    distributions, losses and the optimizer stay float32."""
    return torch.bfloat16 if getattr(cfg, "use_bf16", False) else torch.float32


def cast_floats(tree, dtype):
    """Float leaves of a parameter subtree cast to the compute dtype (the
    tree itself for f32); other leaves pass through."""
    if dtype == torch.float32:
        return tree
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
