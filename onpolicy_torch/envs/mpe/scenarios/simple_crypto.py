"""simple_crypto: Alice (speaker) must send a goal colour to Bob
(listener) over a channel Eve (adversary) hears too, using a shared key.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_crypto.py`: 3 immobile
agents — agent 0 Eve (adversary listener), agent 1 Bob (good listener),
agent 2 Alice (speaker); dim_c=4; K landmarks with one-hot dim_c colours;
the goal and the key are random landmark colours (`extras["goal"]`,
`extras["key"]`, [N]). Rewards (an utterance of all zeros scores
nothing): good agents get −‖c_Bob − goal‖² + ‖c_Eve − goal‖², Eve gets
−‖c_Eve − goal‖². Obs: Alice [goal(4), key(4)]; Bob [key(4),
c_Alice(4)]; Eve [c_Alice(4)]. Every action space is Discrete(dim_c)
(comm only; nobody moves).
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = False
DIM_C = 4


def make_spec(args) -> WorldSpec:
    M, K = args.num_agents, args.num_landmarks
    if M != 3:
        raise ValueError(
            "simple_crypto uses exactly 3 agents (Eve, Bob, Alice)")
    return WorldSpec(
        n_agents=M, n_landmarks=K, dim_c=DIM_C,
        world_length=args.episode_length,
        agent_movable=(False,) * M, agent_silent=(False,) * M,
        agent_collide=(False,) * M, agent_size=(0.05,) * M,
        agent_accel=(None,) * M, agent_max_speed=(None,) * M,
        agent_adversary=(True, False, False),
        landmark_collide=(False,) * K, landmark_movable=(False,) * K,
        landmark_size=(0.05,) * K,
    )


def _landmark_colors(K: int, like: torch.Tensor) -> torch.Tensor:
    """One-hot dim_c colours, one per landmark."""
    return torch.eye(DIM_C, dtype=like.dtype, device=like.device)[:K]


def goal_and_key(spec: WorldSpec, n_envs: int, generator, device) -> dict:
    draw = lambda: torch.randint(0, spec.n_landmarks, (n_envs,),
                                 generator=generator, device=device)
    return {"goal": draw(), "key": draw()}


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype)
    return sc.base_state(spec, agent_pos, landmark_pos,
                         extras=goal_and_key(spec, n_envs, generator, device))


def observation(spec: WorldSpec, state):
    colors = _landmark_colors(spec.n_landmarks, state.agent_pos)
    goal_color = colors[state.extras["goal"].long()]
    key_color = colors[state.extras["key"].long()]
    c_alice = state.agent_comm[:, 2, :DIM_C]
    return (c_alice, torch.cat([key_color, c_alice], -1),
            torch.cat([goal_color, key_color], -1))


def reward(spec: WorldSpec, state) -> torch.Tensor:
    colors = _landmark_colors(spec.n_landmarks, state.agent_pos)
    goal = colors[state.extras["goal"].long()]                      # [N, 4]
    c = state.agent_comm[..., :DIM_C]
    nonzero = (c != 0.0).any(-1).to(c.dtype)                        # [N, M]
    err = (c - goal[:, None]).square().sum(-1)                      # [N, M]
    eve = nonzero[:, 0] * err[:, 0]
    good = -nonzero[:, 1] * err[:, 1] + eve
    return torch.stack([-eve, good, good], -1)
