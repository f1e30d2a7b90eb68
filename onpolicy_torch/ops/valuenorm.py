"""Running value-target normalizer (ValueNorm statistics).

Port of `onpolicy_tpu/ops/valuenorm.py`, the reference's debiased EMA:

  state = (running_mean, running_mean_sq, debiasing_term), beta=0.99999
  debiased mean  = mean / clamp(debias, eps)
  debiased var   = clamp(mean_sq_debiased - mean_debiased², 1e-2)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

EPS = 1e-5
VAR_CLAMP = 1e-2
DEFAULT_BETA = 0.99999


@dataclass
class ValueNormState:
    running_mean: torch.Tensor      # [shape], usually [1]
    running_mean_sq: torch.Tensor   # [shape]
    debiasing_term: torch.Tensor    # scalar
    beta: float = DEFAULT_BETA
    per_element_update: bool = False
    norm_axes: int = 1

    def replace(self, **kw) -> "ValueNormState":
        return dataclasses.replace(self, **kw)


def create(input_shape=1, *, device, beta: float = DEFAULT_BETA,
           per_element_update: bool = False, norm_axes: int = 1
           ) -> ValueNormState:
    shape = (input_shape,) if isinstance(input_shape, int) else tuple(input_shape)
    return ValueNormState(
        running_mean=torch.zeros(shape, device=device),
        running_mean_sq=torch.zeros(shape, device=device),
        debiasing_term=torch.zeros((), device=device),
        beta=beta, per_element_update=per_element_update, norm_axes=norm_axes)


def mean_var(s: ValueNormState):
    debias = torch.clamp_min(s.debiasing_term, EPS)
    mean = s.running_mean / debias
    mean_sq = s.running_mean_sq / debias
    var = torch.clamp_min(mean_sq - mean.square(), VAR_CLAMP)
    return mean, var


def update(s: ValueNormState, x: torch.Tensor) -> ValueNormState:
    axes = tuple(range(s.norm_axes))
    x = x.float()
    batch_mean = x.mean(axes)
    batch_sq_mean = x.square().mean(axes)
    if s.per_element_update:
        batch_size = 1
        for a in axes:
            batch_size *= x.shape[a]
        weight = s.beta ** batch_size
    else:
        weight = s.beta
    return s.replace(
        running_mean=s.running_mean * weight + batch_mean * (1.0 - weight),
        running_mean_sq=s.running_mean_sq * weight + batch_sq_mean * (1.0 - weight),
        debiasing_term=s.debiasing_term * weight + (1.0 - weight),
    )


def _bcast(stat: torch.Tensor, s: ValueNormState):
    return stat.reshape((1,) * s.norm_axes + tuple(stat.shape))


def normalize(s: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = mean_var(s)
    return (x - _bcast(mean, s)) / _bcast(torch.sqrt(var), s)


def denormalize(s: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = mean_var(s)
    return x * _bcast(torch.sqrt(var), s) + _bcast(mean, s)
