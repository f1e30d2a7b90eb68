"""Action head (ACT layer): the output layer for each action space.

Port of `onpolicy_tpu/models/act.py`:
  * Discrete      → masked Categorical (logit mask −1e10);
  * Box           → DiagGaussian, a linear `mean` and a state-independent,
                    zero-initialised `log_std`;
  * MultiBinary   → Bernoulli;
  * MultiDiscrete → one Categorical head per sub-action, in a `"heads"`
                    list; actions and log-probs are concatenated per head,
                    NOT summed (the PPO ratio is taken per head), and the
                    entropy is the mean over heads of each head's
                    mask-reduced entropy;
  * MixedSpace    → a Box part and a Discrete part: log-probs summed,
                    entropy weighted ent_c/2 + ent_d/0.98; the stored
                    action is [continuous, discrete index].
Output layers are orthogonal with cfg.gain. Heads and distribution math
run in f32.

`evaluate` returns the batch-reduced (active-mask-weighted) entropy;
`evaluate_trpo` (HATRPO) also the distribution's parameters.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from onpolicy_torch.models import common as cm
from onpolicy_torch.ops import distributions as D
from onpolicy_torch.ops import losses
from onpolicy_torch.utils import spaces as sp


def init(cfg, space, input_dim: int, generator: torch.Generator, device):
    lin = lambda n: cm.linear_init(input_dim, n, gain=cfg.gain,
                                   use_orthogonal=cfg.use_orthogonal,
                                   generator=generator, device=device)
    zeros = lambda n: torch.zeros(n, device=device)
    if isinstance(space, sp.Discrete):
        return {"out": lin(space.n)}
    if isinstance(space, sp.Box):
        d = space.shape[0]
        return {"mean": lin(d), "log_std": zeros(d)}
    if isinstance(space, sp.MultiBinary):
        return {"out": lin(space.n)}
    if isinstance(space, sp.MultiDiscrete):
        return {"heads": [lin(n) for n in space.nvec]}
    if isinstance(space, sp.MixedSpace):
        return {"mean": lin(space.continuous_dim),
                "log_std": zeros(space.continuous_dim),
                "out": lin(space.discrete_n)}
    raise TypeError(f"unsupported action space {space!r}")


def _gaussian(params, x) -> D.DiagGaussian:
    mean = cm.linear_apply(params["mean"], x)
    return D.DiagGaussian(mean, params["log_std"].expand_as(mean))


def _dists(params, space, x, available_actions=None) -> list:
    """The head's distributions, one per stored action part: one
    Categorical per head of a MultiDiscrete (which take no availability
    mask, as in the JAX package); a MixedSpace's DiagGaussian and masked
    Categorical; else the one distribution."""
    if isinstance(space, sp.Discrete):
        return [D.Categorical.create(cm.linear_apply(params["out"], x),
                                     available_actions)]
    if isinstance(space, sp.Box):
        return [_gaussian(params, x)]
    if isinstance(space, sp.MultiBinary):
        return [D.Bernoulli(cm.linear_apply(params["out"], x))]
    if isinstance(space, sp.MultiDiscrete):
        return [D.Categorical.create(cm.linear_apply(p, x))
                for p in params["heads"]]
    if isinstance(space, sp.MixedSpace):
        return [_gaussian(params, x),
                D.Categorical.create(cm.linear_apply(params["out"], x),
                                     available_actions)]
    raise TypeError(f"unsupported action space {space!r}")


def _parts(space, action) -> list:
    """The stored action cut into the columns of each distribution."""
    if isinstance(space, sp.MultiDiscrete):
        return [action[..., i:i + 1] for i in range(len(space.nvec))]
    if isinstance(space, sp.MixedSpace):
        c = space.continuous_dim
        return [action[..., :c], action[..., c:]]
    return [action]


def _log_probs(space, dists, parts):
    lps = [d.log_prob(a) for d, a in zip(dists, parts)]
    if isinstance(space, sp.MixedSpace):
        return lps[0] + lps[1]
    return torch.cat(lps, -1)


def sample(cfg, params, space, x, generator: torch.Generator,
           available_actions=None, actions: Optional[torch.Tensor] = None,
           deterministic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (actions [B, A_store] as float, log_probs [B, A_logp]).
    Given `actions` (drawn elsewhere, e.g. by a test), no draw is made and
    their log-probs are returned; `deterministic` takes each
    distribution's mode."""
    dists = _dists(params, space, x.float(), available_actions)
    if actions is not None:
        parts = _parts(space, actions)
    else:
        parts = [d.mode() if deterministic else d.sample(generator)
                 for d in dists]
    lp = _log_probs(space, dists, parts)
    return torch.cat([a.float() for a in parts], -1), lp


def _entropy(space, dists, active_masks):
    ents = [_reduce_entropy(d.entropy(), active_masks) for d in dists]
    if isinstance(space, sp.MixedSpace):
        return ents[0] / 2.0 + ents[1] / 0.98
    return sum(ents) / len(ents)


def evaluate(cfg, params, space, x, action, available_actions=None,
             active_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_probs [B, A_logp], entropy scalar)."""
    dists = _dists(params, space, x.float(), available_actions)
    return (_log_probs(space, dists, _parts(space, action)),
            _entropy(space, dists, active_masks))


def evaluate_trpo(cfg, params, space, x, action, available_actions=None,
                  active_masks=None):
    """HATRPO's evaluation (JAX `act.py:118-135`): (log_probs, entropy,
    mu, std, all_probs). Box: the DiagGaussian's mean and std, all_probs
    None. Discrete and MultiDiscrete: mu and std None, all_probs the
    (masked) LOGITS vector, the heads' concatenated — the reference
    appends `action_logit.logits` and its kl_approx consumes them as they
    are. MultiBinary and mixed spaces have no TRPO form, as in the JAX
    package."""
    if not isinstance(space, (sp.Discrete, sp.Box, sp.MultiDiscrete)):
        raise TypeError(f"no TRPO evaluation for {space!r}")
    dists = _dists(params, space, x.float(), available_actions)
    lp = _log_probs(space, dists, _parts(space, action))
    ent = _entropy(space, dists, active_masks)
    if isinstance(space, sp.Box):
        return lp, ent, dists[0].mean, dists[0].std, None
    return lp, ent, None, None, torch.cat([d.logits for d in dists], -1)


def get_probs(cfg, params, space, x, available_actions=None):
    """The action probabilities: a Categorical's softmax, a Bernoulli's
    sigmoid, a MultiDiscrete's heads' concatenated."""
    if not isinstance(space, (sp.Discrete, sp.MultiBinary, sp.MultiDiscrete)):
        raise TypeError(f"no probabilities for {space!r}")
    dists = _dists(params, space, x.float(), available_actions)
    return torch.cat([d.probs for d in dists], -1)


def _reduce_entropy(ent, active_masks: Optional[torch.Tensor]):
    """ent: [B]; active_masks: [B, 1] or None → scalar (over ranks: the
    rank's part, `losses.masked_mean`)."""
    return losses.masked_mean(
        ent, None if active_masks is None else active_masks[..., 0])
