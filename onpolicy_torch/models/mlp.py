"""MLP feature extractor.

Port of `onpolicy_tpu/models/mlp.py` (the reference's MLPBase): optional
input LayerNorm (feature normalization), then fc1 + layer_N hidden
blocks, each Linear → activation → LayerNorm, orthogonal(gain) init.
"""
from __future__ import annotations

import torch

from onpolicy_torch.models import common as cm


def init(cfg, input_dim: int, generator: torch.Generator, device):
    act = "relu" if cfg.use_ReLU else "tanh"
    gain = cm.calculate_gain(act)
    params = {}
    if cfg.use_feature_normalization:
        params["feature_norm"] = cm.layer_norm_init(input_dim, device)
    layers = []
    d_in = input_dim
    for _ in range(1 + cfg.layer_N):
        layers.append({
            "lin": cm.linear_init(d_in, cfg.hidden_size, gain=gain,
                                  use_orthogonal=cfg.use_orthogonal,
                                  generator=generator, device=device),
            "ln": cm.layer_norm_init(cfg.hidden_size, device),
        })
        d_in = cfg.hidden_size
    params["layers"] = layers
    return params


def apply(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Features in the compute dtype (`cm.compute_dtype`)."""
    act = cm.activation_fn(cfg.use_ReLU)
    dt = cm.compute_dtype(cfg)
    params = cm.cast_floats(params, dt)
    x = x.to(dt)
    if cfg.use_feature_normalization:
        x = cm.layer_norm_apply(params["feature_norm"], x)
    for layer in params["layers"]:
        x = cm.layer_norm_apply(layer["ln"], act(cm.linear_apply(layer["lin"], x)))
    return x
