"""Action distributions.

Port of `onpolicy_tpu/ops/distributions.py` (Categorical; the other
distributions come with Slice B of ROADMAP.md), with its reduction
conventions, which the PPO losses depend on:

  * ``log_prob`` keeps a trailing singleton axis (shape ``[..., 1]``);
  * ``entropy`` reduces the event axis to shape ``[...]``, with the rule
    0·log 0 := 0 for fully masked entries;
  * ``sample`` and ``mode`` return integer actions ``[..., 1]``;
  * unavailable actions get the logit ``MASK_NEG = -1e10``.

Sampling is the Gumbel-max rule of `jax.random.categorical`, with the
uniform draws taken from a `torch.Generator`: elementwise on the card,
no synchronisation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

MASK_NEG = -1e10


def mask_logits(logits: torch.Tensor,
                available_actions: Optional[torch.Tensor]) -> torch.Tensor:
    """Suppress unavailable actions. `available_actions` is {0,1}-valued."""
    if available_actions is None:
        return logits
    return torch.where(available_actions > 0, logits,
                       torch.full_like(logits, MASK_NEG))


@dataclass
class Categorical:
    """Masked categorical over the last axis. `logits` shape [..., n]."""
    logits: torch.Tensor

    @classmethod
    def create(cls, logits, available_actions=None):
        return cls(logits=mask_logits(logits, available_actions))

    @property
    def log_softmax(self):
        return torch.log_softmax(self.logits, -1)

    @property
    def probs(self):
        return torch.softmax(self.logits, -1)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(self.logits.shape, generator=generator,
                       dtype=self.logits.dtype, device=self.logits.device)
        tiny = torch.finfo(self.logits.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return (self.logits + gumbel).argmax(-1, keepdim=True)

    def mode(self) -> torch.Tensor:
        return self.logits.argmax(-1, keepdim=True)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        """actions: [..., 1] integer-valued. Returns [..., 1]."""
        return self.log_softmax.gather(-1, actions.long())

    def entropy(self) -> torch.Tensor:
        ls = self.log_softmax
        p = ls.exp()
        plogp = torch.where(p > 0, p * ls, torch.zeros_like(ls))
        return -plogp.sum(-1)
