"""Return / advantage computation as a reverse loop over time.

Port of `onpolicy_tpu/ops/gae.py` (the reference's `compute_returns`),
covering use_gae × use_proper_time_limits, on normalized or raw values.
Shapes are time-major `[T(+1), ...]`; masks gate the recurrence:
  delta_t = r_t + γ·V̂_{t+1}·m_{t+1} − V̂_t
  gae_t   = delta_t + γλ·m_{t+1}·gae_{t+1}      (then ·bad_{t+1} if proper limits)
  ret_t   = gae_t + V̂_t
where V̂ is the denormalized value when a normalizer is in use. The plain
discounted branch seeds with the denormalized bootstrap, as the JAX
package does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from onpolicy_torch.ops import valuenorm as vn


def compute_returns(
    rewards: torch.Tensor,        # [T, ...]
    value_preds: torch.Tensor,    # [T+1, ...]  (slot T = bootstrap)
    masks: torch.Tensor,          # [T+1, ...]
    bad_masks: Optional[torch.Tensor],
    norm_state: Optional[vn.ValueNormState],
    *,
    gamma: float,
    gae_lambda: float,
    use_gae: bool = True,
    use_proper_time_limits: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (returns [T, ...], advantages [T, ...])."""
    values = vn.denormalize(norm_state, value_preds) if norm_state is not None \
        else value_preds
    if use_proper_time_limits and bad_masks is None:
        raise ValueError("use_proper_time_limits needs bad_masks")
    T = rewards.shape[0]
    v_t, v_tp1, m_tp1 = values[:-1], values[1:], masks[1:]
    b_tp1 = bad_masks[1:] if use_proper_time_limits else None
    out = [None] * T

    if use_gae:
        delta = rewards + gamma * v_tp1 * m_tp1 - v_t
        gae = torch.zeros_like(delta[0])
        for t in reversed(range(T)):
            gae = delta[t] + gamma * gae_lambda * m_tp1[t] * gae
            if use_proper_time_limits:
                gae = gae * b_tp1[t]
            out[t] = gae
        advantages = torch.stack(out)
        return advantages + v_t, advantages

    ret = values[-1]
    for t in reversed(range(T)):
        if use_proper_time_limits:
            ret = ((ret * gamma * m_tp1[t] + rewards[t]) * b_tp1[t]
                   + (1.0 - b_tp1[t]) * v_t[t])
        else:
            ret = ret * gamma * m_tp1[t] + rewards[t]
        out[t] = ret
    returns = torch.stack(out)
    return returns, returns - v_t
