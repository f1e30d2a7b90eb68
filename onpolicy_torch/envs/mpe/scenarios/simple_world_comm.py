"""simple_world_comm: predator-prey with a speaking predator leader, food
and forests that hide whoever is inside.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_world_comm.py`: agent 0
is the adversary leader (speaks, dim_c=4, so it acts in MultiDiscrete
(5, 4)); the other adversaries are silent (size .075, accel 3,
max_speed 1); good agents size .045, accel 4, max_speed 1.3. The
landmark axis holds K obstacles (collide, size .2), then 2 food (size
.03), then 2 forests (size .3), all at 0.8·uniform. Forest visibility:
another agent's relative position and velocity read zero unless the two
share a forest, both are outside every forest, or the observer is the
leader. Good reward: −5 per adversary contact, −2·bound(|x|), +2 per
food contact, +0.05·the distance to the nearest food (the reference's
sign, kept); adversary reward: −0.1·the distance to the nearest prey + 5
per (good, adversary) contact pair. Adversaries observe [vel, pos,
entity_rel, other_pos, other_vel (good others), in_forest(2), the
leader's comm(4)]; good agents [vel, pos, entity_rel, other_pos,
in_forest(2), other_vel] and no comm.
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = False
NUM_FOOD = 2
NUM_FORESTS = 2
DIM_C = 4


def make_spec(args) -> WorldSpec:
    na, ng = args.num_adversaries, args.num_good_agents
    M = na + ng
    K = args.num_landmarks           # obstacle landmarks only
    KT = K + NUM_FOOD + NUM_FORESTS  # the whole landmark axis
    return WorldSpec(
        n_agents=M, n_landmarks=KT, dim_c=DIM_C,
        world_length=args.episode_length,
        agent_movable=(True,) * M,
        agent_silent=(False,) + (True,) * (M - 1),   # only the leader speaks
        agent_collide=(True,) * M,
        agent_size=(0.075,) * na + (0.045,) * ng,
        agent_accel=(3.0,) * na + (4.0,) * ng,
        agent_max_speed=(1.0,) * na + (1.3,) * ng,
        agent_adversary=(True,) * na + (False,) * ng,
        landmark_collide=(True,) * K + (False,) * (NUM_FOOD + NUM_FORESTS),
        landmark_movable=(False,) * KT,
        landmark_size=(0.2,) * K + (0.03,) * NUM_FOOD + (0.3,) * NUM_FORESTS,
    )


def _slices(spec):
    K = spec.n_landmarks - NUM_FOOD - NUM_FORESTS
    return slice(K, K + NUM_FOOD), slice(K + NUM_FOOD, spec.n_landmarks)


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype, scale=0.8)
    return sc.base_state(spec, agent_pos, landmark_pos)


def _in_forest(spec, state) -> torch.Tensor:
    """[N, M, NUM_FORESTS] bool: agent i overlaps forest f."""
    _, forests = _slices(spec)
    pos = state.agent_pos
    d = sc.pairwise_dist(pos, state.landmark_pos[:, forests])
    return d < (sc.values(spec.agent_size, pos)[:, None]
                + sc.values(spec.landmark_size[forests], pos)[None, :])


def observation(spec: WorldSpec, state):
    M = spec.n_agents
    adv = spec.agent_adversary
    pos, vel = state.agent_pos, state.agent_vel
    inf = _in_forest(spec, state)                               # [N, M, 2]
    anywhere = inf.any(-1)                                      # [N, M]
    in_forest_feat = torch.where(inf, 1.0, -1.0).to(pos.dtype)
    leader_c = state.agent_comm[:, 0, :DIM_C]
    obs = []
    for i in range(M):
        p_i = pos[:, i]
        other_pos, other_vel = [], []
        for j in range(M):
            if j == i:
                continue
            visible = ((inf[:, i] & inf[:, j]).any(-1)
                       | (~anywhere[:, i] & ~anywhere[:, j])
                       | (i == 0))[:, None]             # the leader sees all
            other_pos.append(torch.where(visible, pos[:, j] - p_i, 0.0))
            if not adv[j]:
                other_vel.append(torch.where(visible, vel[:, j], 0.0))
        base = [vel[:, i], p_i, sc.landmark_rel(state, p_i)] + other_pos
        if adv[i]:
            parts = base + other_vel + [in_forest_feat[:, i], leader_c]
        else:
            parts = base + [in_forest_feat[:, i]] + other_vel
        obs.append(torch.cat(parts, -1))
    return tuple(obs)


def reward(spec: WorldSpec, state) -> torch.Tensor:
    pos = state.agent_pos
    f = lambda b: b.to(pos.dtype)
    adv = sc.mask(spec.agent_adversary, pos)
    sizes = sc.values(spec.agent_size, pos)
    food, _ = _slices(spec)

    d = sc.pairwise_dist(pos, pos)
    contact = d < sizes[:, None] + sizes[None, :]
    hit_by_adv = f(contact & adv[None, :]).sum(2)
    pair_total = f(contact & ~adv[:, None] & adv[None, :]).sum((1, 2))

    fd = sc.pairwise_dist(pos, state.landmark_pos[:, food])          # [N, M, 2]
    food_size = sc.values(spec.landmark_size[food], pos)
    food_hits = f(fd < sizes[:, None] + food_size[None, :]).sum(2)
    min_food = fd.min(2).values

    bound = sc.bound_penalty(pos.abs()).sum(-1)
    good = -5.0 * hit_by_adv - 2.0 * bound + 2.0 * food_hits + 0.05 * min_food
    min_prey = torch.where(adv[None, :], torch.inf, d).min(2).values
    return torch.where(adv, -0.1 * min_prey + 5.0 * pair_total[:, None], good)
