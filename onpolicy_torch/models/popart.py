"""PopArt critic head: a linear output layer whose weights are rescaled
whenever the running target statistics move, preserving the head's
denormalized outputs (Pop-Art, van Hasselt et al. 2016).

Port of `onpolicy_tpu/models/popart.py`, on the port's `ops/valuenorm.py`:
  * stats: the debiased EMA (β=0.99999) of mean / mean², var clamped
    ≥ 1e-2;
  * update(targets): w ← w·σ_old/σ_new, b ← (σ_old·b + μ_old − μ_new)/σ_new.

Functional form: the head's parameters and its `ValueNormState` go in,
new ones come out. In the trainers the head is the critic's `v_out` and
the stats are the train state's `vnorm`; on a `(data, model)` mesh
`algorithms/mappo.py` rescales the gathered head and cuts it to the
rank's block.
"""
from __future__ import annotations

from typing import Tuple

import torch

from onpolicy_torch.models import common as cm
from onpolicy_torch.ops import valuenorm as vn


def init(input_dim: int, output_dim: int = 1, *, use_orthogonal: bool = True,
         generator: torch.Generator, device, beta: float = vn.DEFAULT_BETA
         ) -> Tuple[dict, vn.ValueNormState]:
    params = cm.linear_init(input_dim, output_dim, gain=1.0,
                            use_orthogonal=use_orthogonal,
                            generator=generator, device=device)
    return params, vn.create(output_dim, device=device, beta=beta)


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass — outputs live in *normalized* target space."""
    return cm.linear_apply(params, x)


def update(params: dict, state: vn.ValueNormState, targets: torch.Tensor
           ) -> Tuple[dict, vn.ValueNormState]:
    """Fold a batch of raw targets into the stats and rescale the head."""
    old_mean, old_var = vn.mean_var(state)
    old_std = old_var.sqrt()
    state = vn.update(state, targets)
    new_mean, new_var = vn.mean_var(state)
    new_std = new_var.sqrt()
    return {"w": params["w"] * (old_std / new_std),       # [in, out] * [out]
            "b": (old_std * params["b"] + old_mean - new_mean) / new_std
            }, state
