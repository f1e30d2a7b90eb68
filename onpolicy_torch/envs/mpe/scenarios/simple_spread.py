"""simple_spread: N agents cover N landmarks, penalized for collisions.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_spread.py`: agents
collide, silent, size 0.15; landmarks non-colliding; dim_c=2; reward (per
agent) = −Σ_l min_a dist(a,l) − #collisions-with-this-agent, where the
collision count does NOT exclude the agent itself, so every agent carries
a constant −1 self-collision term (the reference's quirk). Cooperative:
the env-level reward is the sum over agents.
obs = [vel(2), pos(2), landmark_rel(2K), other_pos_rel(2(M−1)),
comm_others(2(M−1))].
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = True


def make_spec(args) -> WorldSpec:
    M, K = args.num_agents, args.num_landmarks
    return WorldSpec(
        n_agents=M, n_landmarks=K, dim_c=2, world_length=args.episode_length,
        agent_movable=(True,) * M, agent_silent=(True,) * M,
        agent_collide=(True,) * M, agent_size=(0.15,) * M,
        agent_accel=(None,) * M, agent_max_speed=(None,) * M,
        landmark_collide=(False,) * K, landmark_movable=(False,) * K,
        landmark_size=(0.05,) * K,
    )


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype, scale=0.8)
    return sc.base_state(spec, agent_pos, landmark_pos)


def observation(spec: WorldSpec, state):
    pos = state.agent_pos
    obs = []
    for i in range(spec.n_agents):
        p_i = pos[:, i]
        obs.append(torch.cat([
            state.agent_vel[:, i],
            p_i,
            sc.landmark_rel(state, p_i),
            sc.others_concat(pos - p_i[:, None], i),
            sc.others_concat(state.agent_comm[..., :spec.dim_c], i),
        ], -1))
    return tuple(obs)


def reward(spec: WorldSpec, state) -> torch.Tensor:
    dists = sc.pairwise_dist(state.agent_pos, state.landmark_pos)  # [N, M, K]
    cover = -dists.min(1).values.sum(-1)                            # [N]
    # collision count per agent (self included — reference quirk)
    ad = sc.pairwise_dist(state.agent_pos, state.agent_pos)        # [N, M, M]
    collisions = (ad < 0.15 + 0.15).to(ad.dtype).sum(-1)
    return cover[:, None] - collisions
