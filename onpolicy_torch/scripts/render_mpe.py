"""MPE render entry point of the PyTorch port.

Port of `onpolicy_tpu/scripts/render_mpe.py` (the reference's
`scripts/render/render_mpe.py` and `mpe_runner.render:185-248`): the
policy restored from a checkpoint, `render_episodes` deterministic
episodes of one world, a frame drawn after the reset and after every
step, and the frames saved as gifs under `gifs/<scenario>/` with
`--save_gifs`. The policy acts on the card unless `--device cpu` is
given; the frames are drawn on the host (matplotlib, and imageio for the
gifs).

    python -m onpolicy_torch.scripts.render_mpe --model_dir <ckpt dir> \
        --scenario_name simple_spread --num_agents 3 --num_landmarks 3 \
        --render_episodes 3 --save_gifs

Like the JAX package's, it builds the shared runner's policy, so
`scripts/render_mpe.sh`'s flags (simple_speaker_listener with
`--share_policy false`, whose agents' observation spaces differ) raise
ValueError.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from onpolicy_torch.config import config_from_args
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.utils import checkpoint as ckpt
from onpolicy_torch.utils.render import render_frame, save_gif


def load_policy(cfg):
    """→ (runner, train state): a shared runner over one world, its
    parameters drawn from cfg.seed, then those of the checkpoint in
    cfg.model_dir where one is given, on cfg.device."""
    runner = SharedRunner(cfg.replace(n_rollout_threads=1))
    state = runner.algo.init_state(runner.init_generator, runner.device)
    if cfg.model_dir:
        state, _, _ = ckpt.restore(cfg.model_dir, state, runner.device, {})
    return runner, state


@torch.no_grad()
def render_episodes(runner, state, frame=render_frame, reset=None,
                    out_dir=None):
    """cfg.render_episodes episodes of cfg.episode_length steps of one
    world, each head's mode taken. `frame(spec, world_state)` draws a
    frame after the reset and after each step (None: no frames);
    `reset(episode)` gives an episode's first `WorldState` of one world
    (None: drawn from the runner's generator, seeded with cfg.seed, which
    also draws a noisy world's noise). With cfg.save_gifs the frames go
    to `out_dir/episode_<k>.gif`. → (the episode rewards, each episode's
    actions [T, M, heads])."""
    cfg, env, algo = runner.cfg, runner.envs.env, runner.algo
    device, M = runner.device, env.num_agents
    all_rewards, all_actions = [], []
    for ep in range(cfg.render_episodes):
        if reset is None:
            env_state, obs = env.reset(1, runner.generator, device)
        else:
            env_state = reset(ep)
            obs = env.observation(env_state)
        frames = [] if frame is None else [frame(env.spec, env_state)]
        rnn = torch.zeros(M, cfg.recurrent_N, cfg.hidden_size, device=device)
        masks = torch.ones(M, 1, device=device)
        ep_rew, actions_ep = 0.0, []
        for _ in range(cfg.episode_length):
            actions, _, rnn = algo.act(state, torch.stack(obs, 1)[0], rnn,
                                       masks, deterministic=True)
            noise = env.draw_noise(1, runner.generator, env_state.agent_pos)
            env_state, obs, rewards, _ = env.step(env_state, actions[None],
                                                  noise)
            ep_rew += float(rewards.mean())
            actions_ep.append(actions)
            if frame is not None:
                frames.append(frame(env.spec, env_state))
        all_rewards.append(ep_rew)
        all_actions.append(torch.stack(actions_ep))
        if cfg.save_gifs and frames:
            path = save_gif(frames, Path(out_dir) / f"episode_{ep}.gif",
                            fps=1.0 / cfg.ifi)
            print(f"wrote {path}")
        print(f"episode {ep}: reward {ep_rew:.2f}")
    return all_rewards, all_actions


def main(argv=None):
    cfg = config_from_args(argv, n_rollout_threads=1, use_render=True)
    runner, state = load_policy(cfg)
    rewards, _ = render_episodes(runner, state,
                                 out_dir=Path("gifs") / cfg.scenario_name)
    print(f"average episode reward: {np.mean(rewards):.2f}")
    return rewards


if __name__ == "__main__":
    main(sys.argv[1:])
