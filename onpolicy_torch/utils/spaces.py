"""Lightweight, hashable space descriptors.

The port's own copy of the parts of `onpolicy_tpu/utils/spaces.py` that
the port uses: frozen dataclasses in place of gym space classes (no gym
dependency in the compute path). `from_gym` converts the spaces of the
host envs (SMAC, GRF) by their class names, so gym need not be installed.
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


SPACES = (Discrete, Box, MultiDiscrete, MultiBinary, MixedSpace)


def obs_dim(space) -> int:
    """Flat feature width of an observation space
    (`get_shape_from_obs_space`)."""
    if isinstance(space, Box):
        if len(space.shape) == 1:
            return space.shape[0]
        raise ValueError(f"non-flat obs space {space}; use shape directly")
    raise TypeError(f"unsupported obs space {space!r}")


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


def env_action_dim(space) -> int:
    """Width of the action as presented to the env (one-hot for discrete
    heads)."""
    if isinstance(space, Discrete):
        return space.n
    if isinstance(space, MultiDiscrete):
        return sum(space.nvec)
    return action_storage_dim(space)


def available_actions_dim(space) -> int:
    if isinstance(space, Discrete):
        return space.n
    raise TypeError("available_actions only defined for Discrete spaces")


def from_gym(space):
    """A gym/gymnasium space (or one of the spaces above, returned as it
    is) as one of the spaces above, told apart by its class name, so that
    the host envs' spaces convert without gym installed."""
    if isinstance(space, SPACES):
        return space
    name = type(space).__name__
    if name == "Discrete":
        return Discrete(int(space.n))
    if name == "Box":
        return Box(tuple(int(s) for s in space.shape))
    if name == "MultiDiscrete":
        if hasattr(space, "nvec"):
            nvec = tuple(int(n) for n in space.nvec)
        else:  # the reference's vendored MultiDiscrete (high-low+1)
            nvec = tuple(int(h - l + 1) for l, h in zip(space.low, space.high))
        return MultiDiscrete(nvec)
    if name == "MultiBinary":
        return MultiBinary(int(space.n))
    if name == "Tuple":
        return MixedSpace(int(space[0].shape[0]), int(space[1].n))
    raise TypeError(f"unsupported gym space {space!r}")
