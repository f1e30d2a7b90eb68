"""simple_reference: 2 agents, each must guide the OTHER to a secret goal
landmark over a 10-symbol comm channel.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_reference.py`: dim_c=10,
non-colliding agents of size 0.05, each movable and speaking, so each acts
in MultiDiscrete (5, 10); landmark colours are the fixed RGB triplet per
index. Agent i's goal_a is the other agent, goal_b a random landmark, kept
in `extras["goal_b"]` [N, 2]. reward_i = −‖pos(other) − pos(goal_b_i)‖²;
cooperative: the env-level reward is the sum over agents.
obs = [vel(2), landmark_rel(2K), goal_b_color(3), comm_other(10)].
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = True

LANDMARK_COLORS = ((0.75, 0.25, 0.25), (0.25, 0.75, 0.25), (0.25, 0.25, 0.75))


def make_spec(args) -> WorldSpec:
    M, K = args.num_agents, args.num_landmarks
    if M != 2:
        raise ValueError("simple_reference supports exactly 2 agents")
    return WorldSpec(
        n_agents=M, n_landmarks=K, dim_c=10, world_length=args.episode_length,
        agent_movable=(True,) * M, agent_silent=(False,) * M,
        agent_collide=(False,) * M, agent_size=(0.05,) * M,
        agent_accel=(None,) * M, agent_max_speed=(None,) * M,
        landmark_collide=(False,) * K, landmark_movable=(False,) * K,
        landmark_size=(0.05,) * K,
    )


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype, scale=0.8)
    goal_b = torch.randint(0, spec.n_landmarks, (n_envs, 2),
                           generator=generator, device=device)
    return sc.base_state(spec, agent_pos, landmark_pos,
                         extras={"goal_b": goal_b})


def observation(spec: WorldSpec, state):
    pos = state.agent_pos
    colors = sc.colors(LANDMARK_COLORS, spec.n_landmarks, pos)
    goal_b = state.extras["goal_b"]
    obs = []
    for i in range(spec.n_agents):
        p_i = pos[:, i]
        obs.append(torch.cat([
            state.agent_vel[:, i],
            sc.landmark_rel(state, p_i),
            colors[goal_b[:, i] % colors.shape[0]],
            sc.others_concat(state.agent_comm[..., :spec.dim_c], i),
        ], -1))
    return tuple(obs)


def reward(spec: WorldSpec, state) -> torch.Tensor:
    goal = sc.gather_landmarks(state, state.extras["goal_b"])     # [N, 2, 2]
    # agent i is rewarded for the OTHER agent reaching i's goal landmark
    other = state.agent_pos.flip(1)
    return -(other - goal).square().sum(-1)
