"""Action head (ACT layer).

Port of `onpolicy_tpu/models/act.py` for the Discrete space of the slice
(masked Categorical, logit mask −1e10, output layer orthogonal with
cfg.gain). Box, MultiBinary, MultiDiscrete and mixed spaces are ROADMAP.md
Queue 1 item 9 and raise here. Heads and distribution math run in f32.

`evaluate` returns the batch-reduced (active-mask-weighted) entropy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from onpolicy_torch.models import common as cm
from onpolicy_torch.ops import distributions as D
from onpolicy_torch.utils import spaces as sp


def _require_discrete(space):
    if not isinstance(space, sp.Discrete):
        raise NotImplementedError(
            f"action space {space!r} is not ported yet (ROADMAP.md, "
            "Queue 1 item 9); the port has the Discrete head")


def init(cfg, space, input_dim: int, generator: torch.Generator, device):
    _require_discrete(space)
    return {"out": cm.linear_init(input_dim, space.n, gain=cfg.gain,
                                  use_orthogonal=cfg.use_orthogonal,
                                  generator=generator, device=device)}


def _dist(params, space, x, available_actions=None):
    _require_discrete(space)
    return D.Categorical.create(cm.linear_apply(params["out"], x),
                                available_actions)


def sample(cfg, params, space, x, generator: torch.Generator,
           available_actions=None, actions: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (actions [B, 1] as float, log_probs [B, 1]). Given
    `actions` (drawn elsewhere, e.g. by a test), no draw is made and their
    log-probs are returned."""
    d = _dist(params, space, x.float(), available_actions)
    if actions is None:
        actions = d.sample(generator)
    return actions.float(), d.log_prob(actions)


def evaluate(cfg, params, space, x, action, available_actions=None,
             active_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_probs [B, 1], entropy scalar)."""
    d = _dist(params, space, x.float(), available_actions)
    return d.log_prob(action), _reduce_entropy(d.entropy(), active_masks)


def _reduce_entropy(ent, active_masks: Optional[torch.Tensor]):
    """ent: [B]; active_masks: [B, 1] or None → scalar."""
    if active_masks is None:
        return ent.mean()
    m = active_masks[..., 0]
    return (ent * m).sum() / torch.clamp_min(m.sum(), 1e-8)
