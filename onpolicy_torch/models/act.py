"""Action head (ACT layer).

Port of `onpolicy_tpu/models/act.py` for the spaces of the MPE scripts:
  * Discrete      → masked Categorical (logit mask −1e10);
  * MultiDiscrete → one Categorical head per sub-action, in a `"heads"`
                    list; actions and log-probs are concatenated per head,
                    NOT summed (the PPO ratio is taken per head), and the
                    entropy is the mean over heads of each head's
                    mask-reduced entropy.
Output layers are orthogonal with cfg.gain. Box, MultiBinary and mixed
spaces are ROADMAP.md item B4 and raise here. Heads and distribution math
run in f32.

`evaluate` returns the batch-reduced (active-mask-weighted) entropy;
`evaluate_trpo` (HATRPO) also the distribution's parameters.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from onpolicy_torch.models import common as cm
from onpolicy_torch.ops import distributions as D
from onpolicy_torch.utils import spaces as sp


def _require_ported(space):
    if not isinstance(space, (sp.Discrete, sp.MultiDiscrete)):
        raise NotImplementedError(
            f"action space {space!r} is not ported yet (ROADMAP.md, item "
            "B4); the port has the Discrete and MultiDiscrete heads")


def init(cfg, space, input_dim: int, generator: torch.Generator, device):
    _require_ported(space)
    lin = lambda n: cm.linear_init(input_dim, n, gain=cfg.gain,
                                   use_orthogonal=cfg.use_orthogonal,
                                   generator=generator, device=device)
    if isinstance(space, sp.MultiDiscrete):
        return {"heads": [lin(n) for n in space.nvec]}
    return {"out": lin(space.n)}


def _dists(params, space, x, available_actions=None) -> list:
    """One Categorical per head (a MultiDiscrete's heads take no
    availability mask, as in the JAX package)."""
    _require_ported(space)
    if isinstance(space, sp.MultiDiscrete):
        return [D.Categorical.create(cm.linear_apply(p, x))
                for p in params["heads"]]
    return [D.Categorical.create(cm.linear_apply(params["out"], x),
                                 available_actions)]


def sample(cfg, params, space, x, generator: torch.Generator,
           available_actions=None, actions: Optional[torch.Tensor] = None,
           deterministic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (actions [B, heads] as float, log_probs [B, heads]). Given
    `actions` (drawn elsewhere, e.g. by a test), no draw is made and their
    log-probs are returned; `deterministic` takes each head's mode."""
    acts, lps = [], []
    for i, d in enumerate(_dists(params, space, x.float(), available_actions)):
        if actions is not None:
            a = actions[..., i:i + 1]
        else:
            a = d.mode() if deterministic else d.sample(generator)
        acts.append(a.float())
        lps.append(d.log_prob(a))
    return torch.cat(acts, -1), torch.cat(lps, -1)


def evaluate(cfg, params, space, x, action, available_actions=None,
             active_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_probs [B, heads], entropy scalar)."""
    dists = _dists(params, space, x.float(), available_actions)
    lps = [d.log_prob(action[..., i:i + 1]) for i, d in enumerate(dists)]
    ents = [_reduce_entropy(d.entropy(), active_masks) for d in dists]
    return torch.cat(lps, -1), sum(ents) / len(ents)


def evaluate_trpo(cfg, params, space, x, action, available_actions=None,
                  active_masks=None):
    """HATRPO's evaluation (JAX `act.py:118-135`): (log_probs, entropy,
    mu, std, all_probs). For Discrete and MultiDiscrete, mu and std are
    None and all_probs is the (masked) LOGITS vector, the heads'
    concatenated — the reference appends `action_logit.logits` and its
    kl_approx consumes them as they are. Box (mu, std) is ROADMAP.md item
    B4 and raises."""
    x = x.float()
    dists = _dists(params, space, x, available_actions)
    lps = [d.log_prob(action[..., i:i + 1]) for i, d in enumerate(dists)]
    ents = [_reduce_entropy(d.entropy(), active_masks) for d in dists]
    logits = torch.cat([d.logits for d in dists], -1)
    return torch.cat(lps, -1), sum(ents) / len(ents), None, None, logits


def _reduce_entropy(ent, active_masks: Optional[torch.Tensor]):
    """ent: [B]; active_masks: [B, 1] or None → scalar."""
    if active_masks is None:
        return ent.mean()
    m = active_masks[..., 0]
    return (ent * m).sum() / torch.clamp_min(m.sum(), 1e-8)
