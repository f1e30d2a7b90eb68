"""simple_adversary (physical deception): N−1 good agents must cover the
goal landmark while keeping an adversary, who does not know which
landmark is the goal, away from it.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_adversary.py`: agent 0
is the adversary; K = N−1 landmarks of size 0.08; no collisions;
landmark positions uniform(-1, 1) (no 0.8 scale); the goal landmark is
kept in `extras["goal"]` [N]. Good reward = −min_good dist(a, goal) +
Σ_adv dist(adv, goal); adversary reward = −‖pos − goal‖². Good obs
[goal_rel(2), landmark_rel(2K), other_pos(2(M−1))]; the adversary's
drops the goal, so the widths differ and the policies are separated.
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = False
NUM_ADVERSARIES = 1


def make_spec(args) -> WorldSpec:
    M = args.num_agents
    K = M - 1
    return WorldSpec(
        n_agents=M, n_landmarks=K, dim_c=2, world_length=args.episode_length,
        agent_movable=(True,) * M, agent_silent=(True,) * M,
        agent_collide=(False,) * M, agent_size=(0.15,) * M,
        agent_accel=(None,) * M, agent_max_speed=(None,) * M,
        agent_adversary=(True,) * NUM_ADVERSARIES + (False,) * (M - 1),
        landmark_collide=(False,) * K, landmark_movable=(False,) * K,
        landmark_size=(0.08,) * K,
    )


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype)
    goal = torch.randint(0, spec.n_landmarks, (n_envs,), generator=generator,
                         device=device)
    return sc.base_state(spec, agent_pos, landmark_pos, extras={"goal": goal})


def _goal_pos(state):
    return sc.gather_landmarks(state, state.extras["goal"][:, None])[:, 0]


def observation(spec: WorldSpec, state):
    pos = state.agent_pos
    goal_pos = _goal_pos(state)
    obs = []
    for i in range(spec.n_agents):
        p_i = pos[:, i]
        parts = [] if spec.agent_adversary[i] else [goal_pos - p_i]
        parts += [sc.landmark_rel(state, p_i),
                  sc.others_concat(pos - p_i[:, None], i)]
        obs.append(torch.cat(parts, -1))
    return tuple(obs)


def reward(spec: WorldSpec, state) -> torch.Tensor:
    adv = sc.mask(spec.agent_adversary, state.agent_pos)
    d2 = (state.agent_pos - _goal_pos(state)[:, None]).square().sum(-1)
    d = torch.sqrt(torch.clamp_min(d2, 1e-12))                     # [N, M]
    adv_term = torch.where(adv, d, 0.0).sum(-1)          # Σ adversary dists
    pos_rew = -torch.where(adv, torch.inf, d).min(-1).values  # min over good
    return torch.where(adv, -d2, (pos_rew + adv_term)[:, None])
