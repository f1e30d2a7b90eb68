"""Lightweight, hashable space descriptors.

The port's own copy of the parts of `onpolicy_tpu/utils/spaces.py` that
the port uses: frozen dataclasses in place of gym space classes (no gym
dependency in the compute path). The gym adapters come with the host
envs of Slice F (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Discrete:
    n: int


@dataclass(frozen=True)
class Box:
    shape: Tuple[int, ...]
    low: float = -1.0
    high: float = 1.0


@dataclass(frozen=True)
class MultiDiscrete:
    nvec: Tuple[int, ...]


@dataclass(frozen=True)
class MultiBinary:
    n: int


@dataclass(frozen=True)
class MixedSpace:
    """Tuple(Box, Discrete) — the reference's 'mixed' action space."""
    continuous_dim: int
    discrete_n: int


def obs_shape(space) -> Tuple[int, ...]:
    if isinstance(space, Box):
        return tuple(space.shape)
    if isinstance(space, Discrete):
        return (space.n,)
    raise TypeError(f"unsupported obs space {space!r}")


def action_storage_dim(space) -> int:
    """Width of the stored action array (`get_shape_from_act_space`)."""
    if isinstance(space, Discrete):
        return 1
    if isinstance(space, MultiDiscrete):
        return len(space.nvec)
    if isinstance(space, Box):
        return space.shape[0]
    if isinstance(space, MultiBinary):
        return space.n
    if isinstance(space, MixedSpace):
        return space.continuous_dim + 1
    raise TypeError(f"unsupported action space {space!r}")


def log_prob_dim(space) -> int:
    """Width of the stored log-prob array: one column, except for
    MultiDiscrete, whose heads keep their own log-probs (the PPO ratio is
    taken per head)."""
    if isinstance(space, MultiDiscrete):
        return len(space.nvec)
    return 1
