"""Loss primitives: huber/mse, PPO clipped surrogate, value loss.

Port of `onpolicy_tpu/ops/losses.py` (the reference's `r_mappo.py:52-141`
and `utils/util.py:5-13`). The normalizer state is passed in explicitly;
the trainer updates it before calling `value_loss`.

Under data parallelism (`parallel/distributed.global_batch`) each rank
holds a share of the minibatch's rows: `masked_mean` sums its rows and
divides by the whole minibatch's mask sum, and a plain mean is the
rank's part of the whole mean (`batch_mean`), so the ranks' losses and
gradients add up to the one-process ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from onpolicy_torch.ops import valuenorm as vn
from onpolicy_torch.parallel.distributed import batch_mean, batch_total


def huber_loss(e: torch.Tensor, delta: float) -> torch.Tensor:
    a = e.abs()
    quad = 0.5 * torch.clamp_max(a, delta).square()
    lin = delta * (a - torch.clamp_max(a, delta))
    return quad + lin


def mse_loss(e: torch.Tensor) -> torch.Tensor:
    return 0.5 * e.square()


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """sum(x*mask)/sum(mask); plain mean when mask is None. Over ranks:
    this rank's sum over the whole minibatch's mask sum."""
    if mask is None:
        return batch_mean(x)
    return (x * mask).sum() / torch.clamp_min(batch_total(mask.sum()), 1e-8)


def value_loss(values, value_preds_old, returns, active_masks,
               norm_state: Optional[vn.ValueNormState], *, clip_param: float,
               use_clipped_value_loss: bool = True, use_huber_loss: bool = True,
               huber_delta: float = 10.0, use_value_active_masks: bool = True):
    """Clipped value loss; errors in normalized space, per-element
    max(orig, clipped), reduced by active masks when enabled."""
    value_pred_clipped = value_preds_old + torch.clamp(
        values - value_preds_old, -clip_param, clip_param)
    target = vn.normalize(norm_state, returns) if norm_state is not None \
        else returns
    error_clipped = target - value_pred_clipped
    error_original = target - values
    if use_huber_loss:
        loss_clipped = huber_loss(error_clipped, huber_delta)
        loss_original = huber_loss(error_original, huber_delta)
    else:
        loss_clipped = mse_loss(error_clipped)
        loss_original = mse_loss(error_original)
    loss = torch.maximum(loss_original, loss_clipped) if use_clipped_value_loss \
        else loss_original
    return masked_mean(loss, active_masks if use_value_active_masks else None)


def ppo_policy_loss(log_prob_new, log_prob_old, advantages, active_masks, *,
                    clip_param: float, use_policy_active_masks: bool = True,
                    factor: Optional[torch.Tensor] = None,
                    prod_ratio_heads: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clipped surrogate. Returns (loss, mean_ratio). The ratio is taken
    per action head, or with `prod_ratio_heads` (HAPPO) jointly as
    exp(Σ_heads Δlogp), keepdim. The surrogate is summed over heads
    (keepdim) before the batch reduction, then weighted by HAPPO's
    sequential-update `factor` when one is given."""
    delta = log_prob_new - log_prob_old
    if prod_ratio_heads:
        delta = delta.sum(-1, keepdim=True)
    ratio = torch.exp(delta)
    surr1 = ratio * advantages
    surr2 = torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * advantages
    surr = torch.minimum(surr1, surr2).sum(-1, keepdim=True)
    if factor is not None:
        surr = factor * surr
    mask = active_masks if use_policy_active_masks else None
    return -masked_mean(surr, mask), batch_mean(ratio)


def normalize_advantages(advantages: torch.Tensor,
                         active_masks: Optional[torch.Tensor]) -> torch.Tensor:
    """Active-mask-aware standardization (masked moments, population
    variance), `r_mappo.py:179-187`."""
    if active_masks is None:
        mean = advantages.mean()
        std = advantages.std(correction=0)
    else:
        w = active_masks
        n = torch.clamp_min(w.sum(), 1e-8)
        mean = (advantages * w).sum() / n
        std = torch.sqrt(((advantages - mean).square() * w).sum() / n)
    return (advantages - mean) / (std + 1e-5)


def global_grad_norm(grads) -> torch.Tensor:
    return torch.sqrt(torch.stack([g.square().sum() for g in grads]).sum())
