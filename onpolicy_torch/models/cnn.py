"""CNN feature extractor for image observations.

Port of `onpolicy_tpu/models/cnn.py` (the reference's CNNBase/CNNLayer):
input scaled /255, one Conv(C → hidden/2, k=3, s=1, VALID), activation,
flatten, two Linear(… → hidden) blocks with activation; orthogonal init
with the activation's gain over the flattened (HWI, O) kernel matrix,
zero biases.

Observations are [B, C, W, H], as the space's shape gives them, and stay
in that (NCHW) layout through the convolution: the kernel is stored OIHW
(the JAX package's is HWIO, over NHWC input; `utils/params.py` carries it
across). The flatten runs over (W', H', C'), the JAX package's order, so
that `fc1` keeps its rows as they are there. The convolution is
`torch.nn.functional.conv2d`, as the JAX package's is
`lax.conv_general_dilated` outside any Pallas kernel. The body runs in
the compute dtype (`cm.compute_dtype`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from onpolicy_torch.models import common as cm

KERNEL = 3
STRIDE = 1


def init(cfg, obs_shape, generator: torch.Generator, device):
    c, w, h = obs_shape
    act = "relu" if cfg.use_ReLU else "tanh"
    gain = cm.calculate_gain(act)
    hid = cfg.hidden_size
    out_w = (w - KERNEL) // STRIDE + 1
    out_h = (h - KERNEL) // STRIDE + 1
    flat = (hid // 2) * out_w * out_h
    init_fn = cm.orthogonal if cfg.use_orthogonal else cm.xavier_uniform
    # orthogonal over the (HWI, O) matrix, as the JAX package draws it,
    # then laid out OIHW
    kern = init_fn((KERNEL * KERNEL * c, hid // 2), gain, generator, device)
    kern = kern.reshape(KERNEL, KERNEL, c, hid // 2).permute(3, 2, 0, 1)
    lin = lambda i, o: cm.linear_init(i, o, gain=gain,
                                      use_orthogonal=cfg.use_orthogonal,
                                      generator=generator, device=device)
    return {"conv": {"w": kern.contiguous(),
                     "b": torch.zeros(hid // 2, device=device)},
            "fc1": lin(flat, hid), "fc2": lin(hid, hid)}


def apply(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, C, W, H] → [B, hidden]."""
    act = cm.activation_fn(cfg.use_ReLU)
    dt = cm.compute_dtype(cfg)
    params = cm.cast_floats(params, dt)
    x = (x.float() / 255.0).to(dt)
    y = act(F.conv2d(x, params["conv"]["w"], params["conv"]["b"],
                     stride=STRIDE))
    y = y.permute(0, 2, 3, 1).flatten(1)      # (W', H', C') as fc1's rows
    y = act(cm.linear_apply(params["fc1"], y))
    return act(cm.linear_apply(params["fc2"], y))
