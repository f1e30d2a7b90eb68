"""simple_push: an adversary tries to push good agents off their goal
landmark.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_push.py`: agent 0 is the
adversary, all collide, size 0.05; K landmarks at 0.8·uniform; landmark
k's colour is [0.1, 0.1, 0.1] + 0.8 at channel min(k+1, 2); a good
agent's colour encodes the shared random goal landmark (`extras["goal"]`
[N]). Good reward −dist(agent, goal); adversary reward
min_good dist(a, goal) − dist(adv, goal). Good obs [vel, goal_rel,
colour(3), landmark_rel, landmark_colours(3K), other_pos]; adversary obs
[vel, landmark_rel, other_pos].
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = False
NUM_ADVERSARIES = 1


def make_spec(args) -> WorldSpec:
    M, K = args.num_agents, args.num_landmarks
    return WorldSpec(
        n_agents=M, n_landmarks=K, dim_c=2, world_length=args.episode_length,
        agent_movable=(True,) * M, agent_silent=(True,) * M,
        agent_collide=(True,) * M, agent_size=(0.05,) * M,
        agent_accel=(None,) * M, agent_max_speed=(None,) * M,
        agent_adversary=(True,) * NUM_ADVERSARIES + (False,) * (M - 1),
        landmark_collide=(False,) * K, landmark_movable=(False,) * K,
        landmark_size=(0.05,) * K,
    )


def _landmark_colors(K: int, like: torch.Tensor) -> torch.Tensor:
    c = torch.full((K, 3), 0.1, dtype=like.dtype, device=like.device)
    idx = torch.clamp_max(torch.arange(K, device=like.device) + 1, 2)
    c[torch.arange(K, device=like.device), idx] += 0.8
    return c


def _agent_color(goal: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Good agents' colour [N, 3] encodes the goal index
    (`simple_push.py:49-55`)."""
    idx = torch.clamp_max(goal.long() + 1, 2)
    onehot = idx[:, None] == torch.arange(3, device=like.device)
    return 0.25 + torch.where(onehot, 0.5, 0.0).to(like.dtype)


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype, scale=0.8)
    goal = torch.randint(0, spec.n_landmarks, (n_envs,), generator=generator,
                         device=device)
    return sc.base_state(spec, agent_pos, landmark_pos, extras={"goal": goal})


def _goal_pos(state):
    return sc.gather_landmarks(state, state.extras["goal"][:, None])[:, 0]


def observation(spec: WorldSpec, state):
    pos = state.agent_pos
    N = pos.shape[0]
    goal_pos = _goal_pos(state)
    lcolors = _landmark_colors(spec.n_landmarks, pos).reshape(1, -1) \
        .expand(N, -1)
    acolor = _agent_color(state.extras["goal"], pos)
    obs = []
    for i in range(spec.n_agents):
        p_i = pos[:, i]
        lrel = sc.landmark_rel(state, p_i)
        others = sc.others_concat(pos - p_i[:, None], i)
        if spec.agent_adversary[i]:
            obs.append(torch.cat([state.agent_vel[:, i], lrel, others], -1))
        else:
            obs.append(torch.cat([state.agent_vel[:, i], goal_pos - p_i,
                                  acolor, lrel, lcolors, others], -1))
    return tuple(obs)


def reward(spec: WorldSpec, state) -> torch.Tensor:
    adv = sc.mask(spec.agent_adversary, state.agent_pos)
    d = torch.sqrt(torch.clamp_min(
        (state.agent_pos - _goal_pos(state)[:, None]).square().sum(-1),
        1e-12))                                                     # [N, M]
    min_good = torch.where(adv, torch.inf, d).min(-1).values
    return torch.where(adv, min_good[:, None] - d, -d)
