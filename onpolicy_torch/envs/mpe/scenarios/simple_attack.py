"""simple_attack: each agent races to its own goal landmark; adversaries
punish good agents for coming near or touching them.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_attack.py`:
num_adversaries + num_good_agents agents (adversaries first), all size
0.075, accel 3.0, max_speed 1.0; num_landmarks == num_agents, agent i's
goal is landmark i; landmarks collide, size 0.2, at 0.8·uniform; dim_c=0
(everyone silent, so every space is Discrete(5)). Rewards: every agent
−dist(self, goal_i) + 0.5·1{dist < goal size}; good agents also −0.1 per
adversary within 0.15 and −0.5 per adversary contact; adversaries −0.5
per (good, adversary) contact pair; both the boundary penalty. The
reference calls `bound` where it is not defined (a NameError,
`simple_attack.py:91-96,118-121`); the JAX package applies the evidently
intended penalty (docs/DESIGN.md §8), and so does the port.
obs = [vel(2), pos(2), landmark_rel(2K), other_pos, other_vel].
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
    if K != M:
        raise ValueError("simple_attack requires num_landmarks == num_agents")
    return WorldSpec(
        n_agents=M, n_landmarks=K, dim_c=0, world_length=args.episode_length,
        agent_movable=(True,) * M, agent_silent=(True,) * M,
        agent_collide=(True,) * M, agent_size=(0.075,) * M,
        agent_accel=(3.0,) * M, agent_max_speed=(1.0,) * M,
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
        obs.append(torch.cat([
            vel[:, i], p_i, sc.landmark_rel(state, p_i),
            sc.others_concat(pos - p_i[:, None], i),
            sc.others_concat(vel, i)], -1))
    return tuple(obs)


def _contacts(spec, pos):
    """(pairwise distances [N, M, M], contact [N, M, M])."""
    sizes = sc.values(spec.agent_size, pos)
    d = sc.pairwise_dist(pos, pos)
    return d, d < sizes[:, None] + sizes[None, :]


def reward(spec: WorldSpec, state) -> torch.Tensor:
    M = spec.n_agents
    pos = state.agent_pos
    adv = sc.mask(spec.agent_adversary, pos)
    gsize = sc.values(spec.landmark_size[:M], pos)
    gd = torch.sqrt(torch.clamp_min(
        (pos - state.landmark_pos[:, :M]).square().sum(-1), 1e-12))
    rew = -gd + 0.5 * (gd < gsize).to(pos.dtype)

    d, contact = _contacts(spec, pos)
    f = lambda b: b.to(pos.dtype)
    good_pen = (0.1 * f((d < 0.15) & adv[None, :]).sum(2)
                + 0.5 * f(contact & adv[None, :]).sum(2))
    adv_pen = 0.5 * (contact & ~adv[:, None] & adv[None, :]).float().sum((1, 2))
    # the penalty is float32 whatever the state's dtype, as the JAX
    # package's is (its adversary term sums a float32 cast)
    pen = torch.where(adv, adv_pen[:, None], good_pen.float())
    rew = rew - pen.to(pos.dtype)
    return rew - sc.bound_penalty(pos.abs()).sum(-1)


def info(spec: WorldSpec, state) -> dict:
    """{"fail": [N] bool}: a good agent touches an adversary."""
    adv = sc.mask(spec.agent_adversary, state.agent_pos)
    _, contact = _contacts(spec, state.agent_pos)
    return {"fail": (contact & ~adv[:, None] & adv[None, :]).any(-1).any(-1)}
