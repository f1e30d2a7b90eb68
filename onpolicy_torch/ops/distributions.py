"""Action distributions.

Port of `onpolicy_tpu/ops/distributions.py` (Categorical, DiagGaussian,
Bernoulli), with its reduction conventions, which the PPO losses depend
on:

  * ``log_prob`` reduces the event axis and keeps a trailing singleton
    axis (shape ``[..., 1]``);
  * ``entropy`` reduces the event axis to shape ``[...]``, with the rule
    0·log 0 := 0 for fully masked categorical entries;
  * a Categorical's ``sample`` and ``mode`` return integer actions
    ``[..., 1]``; a DiagGaussian's and a Bernoulli's have the event shape;
  * unavailable actions get the logit ``MASK_NEG = -1e10``.

Categorical sampling is the Gumbel-max rule of `jax.random.categorical`,
with the uniform draws taken from a `torch.Generator`: elementwise on the
card, no synchronisation. DiagGaussian and Bernoulli take their standard
normal or uniform draws from a generator, or given (`noise`, `uniform`),
so a test can feed them the JAX package's draws. A generator may also be
a `parallel.distributed.RowDraws` (anything with `rand` / `randn` of
torch's signature): a data-parallel rank's rows of the global draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

MASK_NEG = -1e10


def _draw(generator, kind: str, shape, dtype, device) -> torch.Tensor:
    """A uniform ("rand") or standard normal ("randn") draw of `shape`."""
    if generator is None or isinstance(generator, torch.Generator):
        return getattr(torch, kind)(shape, generator=generator, dtype=dtype,
                                    device=device)
    return getattr(generator, kind)(shape, dtype=dtype, device=device)


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
        u = _draw(generator, "rand", self.logits.shape, self.logits.dtype,
                  self.logits.device)
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


@dataclass
class DiagGaussian:
    """Diagonal gaussian; `mean` / `log_std` shape [..., d]."""
    mean: torch.Tensor
    log_std: torch.Tensor

    @property
    def std(self):
        return self.log_std.exp()

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std·ε, ε standard normal drawn from `generator` or
        given as `noise`."""
        if noise is None:
            noise = _draw(generator, "randn", self.mean.shape,
                          self.mean.dtype, self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        var = self.std.square()
        lp = -0.5 * ((actions - self.mean).square() / var
                     + math.log(2.0 * math.pi) + 2.0 * self.log_std)
        return lp.sum(-1, keepdim=True)

    def entropy(self) -> torch.Tensor:
        per_dim = 0.5 + 0.5 * math.log(2.0 * math.pi) + self.log_std
        return per_dim.sum(-1)

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        """KL(self ‖ other), closed form, summed over the event axis,
        keepdim."""
        var0, var1 = self.std.square(), other.std.square()
        kl = (other.log_std - self.log_std
              + (var0 + (self.mean - other.mean).square()) / (2.0 * var1)
              - 0.5)
        return kl.sum(-1, keepdim=True)


@dataclass
class Bernoulli:
    """Independent bernoullis; `logits` shape [..., d]."""
    logits: torch.Tensor

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, generator: Optional[torch.Generator] = None,
               uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """1 where u < p, u uniform on [0, 1) drawn from `generator` or
        given as `uniform`; float."""
        if uniform is None:
            uniform = _draw(generator, "rand", self.logits.shape,
                            self.logits.dtype, self.logits.device)
        return (uniform < self.probs).float()

    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).float()

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        lp = -binary_cross_entropy_with_logits(self.logits, actions)
        return lp.sum(-1, keepdim=True)

    def entropy(self) -> torch.Tensor:
        return binary_cross_entropy_with_logits(self.logits,
                                                self.probs).sum(-1)


def binary_cross_entropy_with_logits(logits, labels):
    """max(l, 0) − l·y + log(1 + exp(−|l|)), elementwise: the stable form
    the JAX package writes out."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
