"""Google Research Football render entry point of the PyTorch port.

Port of `onpolicy_tpu/scripts/render_football.py` (the reference's
`scripts/render/render_football.py`): MAPPO restored from a checkpoint,
`render_episodes` deterministic episodes of one env, each until every
player is done, with the engine's frames (`FootballEnv.render`) saved as
an mp4 with `--save_videos` (a gif where imageio cannot write one) or as
a gif with `--save_gifs`. The policy acts on the card unless
`--device cpu` is given. It needs the `gfootball` package.
`scripts/render_football.sh`:

    python -m onpolicy_torch.scripts.render_football \
        --env_name Football --scenario_name academy_3_vs_1_with_keeper \
        --algorithm_name rmappo --experiment_name render --seed 1 \
        --num_agents 3 --representation simple115v2 --use_render \
        --render_episodes 10 --n_rollout_threads 1 --model_dir <ckpt dir> \
        --save_videos

As in the JAX package, a frame the engine fails to give is skipped.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from onpolicy_torch.config import (Config, _parse_bool,
                                   canonicalize_algorithm, get_config)
from onpolicy_torch.utils import checkpoint as ckpt
from onpolicy_torch.utils.render import save_gif, save_video


def parse_args(argv):
    p = get_config()
    p.add_argument("--representation", type=str, default="simple115v2")
    p.add_argument("--rewards", type=str, default="scoring,checkpoints")
    # the reference's --save_videos (.avi through the engine's
    # write_video, render_football.py:87); here an mp4 through imageio
    # where it can write one, else a gif
    p.add_argument("--save_videos", nargs="?", const=True, default=False,
                   type=_parse_bool)
    p.add_argument("--video_dir", type=str, default="")
    return p.parse_args(argv)


def config_from_args(argv):
    """→ (parsed flags, Config) with env_name Football, one env."""
    ns = parse_args(argv)
    overrides = {k: v for k, v in vars(ns).items()
                 if k in Config.__dataclass_fields__}
    overrides.update(env_name="Football", n_rollout_threads=1)
    return ns, canonicalize_algorithm(Config(**overrides)).validate()


def load_policy(cfg, env):
    """→ (MAPPO, train state) for `env`'s spaces: the parameters drawn
    from cfg.seed, then those of the checkpoint in cfg.model_dir where
    one is given, on cfg.device."""
    from onpolicy_torch.algorithms.mappo import MAPPO
    obs_space = env.observation_space[0]
    share_space = env.share_observation_space[0] if cfg.use_centralized_V \
        else obs_space
    algo = MAPPO(cfg, obs_space, share_space, env.action_space[0])
    device = torch.device(cfg.device)
    state = algo.init_state(torch.Generator().manual_seed(cfg.seed), device)
    if cfg.model_dir:
        state, _, _ = ckpt.restore(cfg.model_dir, state, device, {})
    return algo, state


@torch.no_grad()
def render_episodes(algo, state, env, cfg, save_videos=False,
                    video_dir=""):
    """cfg.render_episodes episodes of `env`, each head's mode taken,
    each until every player is done. Frames are taken only to be saved
    (`save_videos` or cfg.save_gifs). → (the episode rewards, each
    episode's actions [steps, M, heads])."""
    device, M = torch.device(cfg.device), env.num_agents
    record = cfg.save_gifs or save_videos
    all_rewards, all_actions = [], []
    for ep in range(cfg.render_episodes):
        obs = env.reset()
        rnn = torch.zeros(M, cfg.recurrent_N, cfg.hidden_size, device=device)
        masks = torch.ones(M, 1, device=device)
        frames, ep_rew, done, actions_ep = [], 0.0, False, []
        while not done:
            actions, _, rnn = algo.act(
                state, torch.as_tensor(obs, device=device), rnn, masks,
                deterministic=True)
            obs, rew, dones, infos = env.step(actions.cpu().numpy())
            ep_rew += float(rew.mean())
            done = bool(np.all(dones))
            actions_ep.append(actions)
            if record:
                try:
                    frames.append(env.render("rgb_array"))
                except Exception:
                    pass     # the engine's renderer failed: no frame
        all_rewards.append(ep_rew)
        all_actions.append(torch.stack(actions_ep))
        if frames and save_videos:
            vdir = video_dir or "videos/football"
            save_video(frames, f"{vdir}/episode_{ep}.mp4", fps=1.0 / cfg.ifi)
        elif frames and cfg.save_gifs:
            save_gif(frames, f"gifs/football/episode_{ep}.gif",
                     fps=1.0 / cfg.ifi)
        print(f"episode {ep}: reward {ep_rew:.2f}")
    return all_rewards, all_actions


def main(argv=None):
    from onpolicy_torch.envs.football.football_env import FootballEnv
    ns, cfg = config_from_args(argv if argv is not None else sys.argv[1:])
    env = FootballEnv(scenario_name=cfg.scenario_name,
                      num_agents=cfg.num_agents,
                      representation=ns.representation, rewards=ns.rewards,
                      use_render=True, seed=cfg.seed)
    try:
        algo, state = load_policy(cfg, env)
        rewards, _ = render_episodes(algo, state, env, cfg, ns.save_videos,
                                     ns.video_dir)
    finally:
        env.close()
    return rewards


if __name__ == "__main__":
    main()
