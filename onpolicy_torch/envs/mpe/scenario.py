"""Scenario protocol for the batched MPE engine.

Port of `onpolicy_tpu/envs/mpe/scenario.py`. A scenario is a module
providing functions over (spec, batched state):

  make_spec(args) -> WorldSpec
  reset(spec, n, generator, device, dtype) -> WorldState   # N fresh worlds
  observation(spec, state) -> tuple of per-agent [N, D_i] tensors
  reward(spec, state) -> [N, M] per-agent rewards
  shared_reward: bool
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe.world import WorldSpec, WorldState


def uniform_positions(n_envs: int, n: int, generator, device, dtype,
                      scale: float = 1.0) -> torch.Tensor:
    u = torch.empty(n_envs, n, 2, device=device, dtype=dtype)
    return scale * u.uniform_(-1.0, 1.0, generator=generator)


def base_state(spec: WorldSpec, agent_pos, landmark_pos,
               extras=None) -> WorldState:
    N, M, K, C = agent_pos.shape[0], spec.n_agents, spec.n_landmarks, spec.dim_c
    z = lambda *s: torch.zeros(*s, dtype=agent_pos.dtype, device=agent_pos.device)
    return WorldState(
        agent_pos=agent_pos, agent_vel=z(N, M, 2),
        agent_comm=z(N, M, max(C, 1)),
        landmark_pos=landmark_pos, landmark_vel=z(N, K, 2),
        t=torch.zeros(N, dtype=torch.int32, device=agent_pos.device),
        extras=extras or {})


def pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [N, P, 2], b: [N, K, 2] → [N, P, K] euclidean distances."""
    d = a[:, :, None, :] - b[:, None, :, :]
    return torch.sqrt(torch.clamp_min(d.square().sum(-1), 1e-12))


def others_concat(values: torch.Tensor, agent_idx: int) -> torch.Tensor:
    """Rows of `values` [N, M, D] other than agent_idx, in order, flattened
    to [N, (M-1)·D] (the reference's `if other is agent: continue`)."""
    M = values.shape[1]
    keep = [j for j in range(M) if j != agent_idx]
    return values[:, keep].reshape(values.shape[0], -1)


def colors(table, n_landmarks: int, like: torch.Tensor) -> torch.Tensor:
    """The first `n_landmarks` rows of a scenario's landmark colour table,
    in `like`'s dtype and device."""
    return torch.tensor(table[:n_landmarks], dtype=like.dtype,
                        device=like.device)


def gather_landmarks(state: WorldState, idx: torch.Tensor) -> torch.Tensor:
    """Positions of the landmarks `idx` [N, P] of each world → [N, P, 2]."""
    return state.landmark_pos.gather(
        1, idx.long()[..., None].expand(*idx.shape, 2))


def landmark_rel(state: WorldState, p_i: torch.Tensor) -> torch.Tensor:
    """Every landmark's position relative to p_i [N, 2] → [N, 2K]."""
    return (state.landmark_pos - p_i[:, None]).reshape(p_i.shape[0], -1)


def mask(flags, like: torch.Tensor) -> torch.Tensor:
    """A per-agent (or per-entity) tuple of bools as a bool tensor on
    `like`'s device."""
    return torch.tensor(flags, dtype=torch.bool, device=like.device)


def values(numbers, like: torch.Tensor) -> torch.Tensor:
    """A per-agent (or per-entity) tuple of numbers (sizes) as a tensor
    in `like`'s dtype and device."""
    return torch.tensor(numbers, dtype=like.dtype, device=like.device)


def bound_penalty(x: torch.Tensor) -> torch.Tensor:
    """The soft screen-exit penalty of |coordinate| x (the reference's
    `bound`, simple_tag.py:102-108): 0 below 0.9, linear to 1, then
    exp(2x − 2) capped at 10."""
    return torch.where(
        x < 0.9, 0.0,
        torch.where(x < 1.0, (x - 0.9) * 10.0,
                    torch.clamp_max(torch.exp(2.0 * x - 2.0), 10.0)))
