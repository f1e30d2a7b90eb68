"""simple_speaker_listener: an immobile speaker sees the goal colour and
must direct the deaf but mobile listener to the goal landmark.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_speaker_listener.py`:
dim_c=3; agent 0 (speaker) is not movable and not silent, agent 1
(listener) is movable and silent; agent size 0.075, landmark size 0.04;
landmark positions uniform(-1, 1) (no 0.8 scale here); the goal landmark
is kept in `extras["goal"]` [N]. Both agents receive −‖listener − goal‖².
The spaces differ: the speaker acts in Discrete(3) (comm only) and sees
the 3-dim goal colour; the listener acts in Discrete(5) and sees
[vel(2), landmark_rel(2K), comm_speaker(3)]. That needs separated
policies (`runner/separated_runner.py`).
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.world import WorldSpec

shared_reward = True

LANDMARK_COLORS = ((0.65, 0.15, 0.15), (0.15, 0.65, 0.15), (0.15, 0.15, 0.65))


def make_spec(args) -> WorldSpec:
    if args.num_agents != 2:
        raise ValueError("simple_speaker_listener supports exactly 2 agents")
    K = args.num_landmarks
    return WorldSpec(
        n_agents=2, n_landmarks=K, dim_c=3, world_length=args.episode_length,
        agent_movable=(False, True), agent_silent=(False, True),
        agent_collide=(False, False), agent_size=(0.075, 0.075),
        agent_accel=(None, None), agent_max_speed=(None, None),
        landmark_collide=(False,) * K, landmark_movable=(False,) * K,
        landmark_size=(0.04,) * K,
    )


def reset(spec: WorldSpec, n_envs: int, generator, device, dtype):
    agent_pos = sc.uniform_positions(n_envs, spec.n_agents, generator,
                                     device, dtype)
    landmark_pos = sc.uniform_positions(n_envs, spec.n_landmarks, generator,
                                        device, dtype)
    goal = torch.randint(0, spec.n_landmarks, (n_envs,), generator=generator,
                         device=device)
    return sc.base_state(spec, agent_pos, landmark_pos, extras={"goal": goal})


def observation(spec: WorldSpec, state):
    pos = state.agent_pos
    colors = sc.colors(LANDMARK_COLORS, spec.n_landmarks, pos)
    speaker = colors[state.extras["goal"] % colors.shape[0]]
    listener = torch.cat([
        state.agent_vel[:, 1],
        sc.landmark_rel(state, pos[:, 1]),
        state.agent_comm[:, 0, :spec.dim_c],      # the speaker's utterance
    ], -1)
    return (speaker, listener)


def reward(spec: WorldSpec, state) -> torch.Tensor:
    goal = sc.gather_landmarks(state, state.extras["goal"][:, None])[:, 0]
    d2 = (state.agent_pos[:, 1] - goal).square().sum(-1)
    return torch.stack([-d2, -d2], -1)
