"""simple_tag (predator-prey): slow adversaries chase faster good agents
around obstacle landmarks.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_tag.py`: the first
`num_adversaries` agents are predators (size .075, accel 3.0, max_speed
1.0); good agents size .05, accel 4.0, max_speed 1.3; colliding landmarks
of size 0.2 at 0.8·uniform. Good reward: −10 per adversary collision and
the soft boundary penalty; adversary reward: +10 per (good, adversary)
collision pair (reward shaping off, as in the reference). obs = [vel(2),
pos(2), landmark_rel, other_pos, other_vel (good others only)] — the
widths differ between roles.
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = False


def make_spec(args) -> WorldSpec:
    na, ng = args.num_adversaries, args.num_good_agents
    M = na + ng
    K = args.num_landmarks
    return WorldSpec(
        n_agents=M, n_landmarks=K, dim_c=2, world_length=args.episode_length,
        agent_movable=(True,) * M, agent_silent=(True,) * M,
        agent_collide=(True,) * M,
        agent_size=(0.075,) * na + (0.05,) * ng,
        agent_accel=(3.0,) * na + (4.0,) * ng,
        agent_max_speed=(1.0,) * na + (1.3,) * ng,
        agent_adversary=(True,) * na + (False,) * ng,
        landmark_collide=(True,) * K, landmark_movable=(False,) * K,
        landmark_size=(0.2,) * K,
    )


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype, scale=0.8)
    return sc.base_state(spec, agent_pos, landmark_pos)


def observation(spec: WorldSpec, state):
    pos, vel = state.agent_pos, state.agent_vel
    obs = []
    for i in range(spec.n_agents):
        p_i = pos[:, i]
        good = [j for j in range(spec.n_agents)
                if j != i and not spec.agent_adversary[j]]
        obs.append(torch.cat([
            vel[:, i], p_i, sc.landmark_rel(state, p_i),
            sc.others_concat(pos - p_i[:, None], i),
            vel[:, good].reshape(pos.shape[0], -1)], -1))
    return tuple(obs)


def reward(spec: WorldSpec, state) -> torch.Tensor:
    pos = state.agent_pos
    adv = sc.mask(spec.agent_adversary, pos)
    sizes = sc.values(spec.agent_size, pos)
    d = sc.pairwise_dist(pos, pos)
    collide = d < sizes[:, None] + sizes[None, :]
    # (good, adversary) collision pairs
    pair = (collide & ~adv[:, None] & adv[None, :]).to(pos.dtype)
    good_hits = pair.sum(2)                              # per good agent
    total_pairs = pair.sum((1, 2))
    bound = sc.bound_penalty(pos.abs()).sum(-1)
    return torch.where(adv, 10.0 * total_pairs[:, None],
                       -10.0 * good_hits - bound)
