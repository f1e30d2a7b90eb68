"""Google Research Football adapter.

The port's own copy of `onpolicy_tpu/envs/football/football_env.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

Parity with the reference's `onpolicy/envs/football/Football_Env.py`:
wraps `gfootball.env.create_environment` (scenario, representation
simple115v2, rewards "scoring,checkpoints", N left-controlled players),
splits the joint per-player spaces, optionally shares the summed reward,
and enriches infos with max_steps/active/sticky_actions. Adapted to the
4-tuple "basic" protocol of `HostVecEnv` (GRF is fully observed — the
runner uses obs-concat as the centralized state, like the reference's
football runner `:79-85`). Import-gated (gfootball package).
"""
from __future__ import annotations

import numpy as np

from onpolicy_torch.utils import spaces as sp


class FootballEnv:
    def __init__(self, scenario_name: str = "academy_3_vs_1_with_keeper",
                 num_agents: int = 3, representation: str = "simple115v2",
                 rewards: str = "scoring,checkpoints",
                 share_reward: bool = True, stacked: bool = False,
                 smm_width: int = 96, smm_height: int = 72,
                 use_render: bool = False, seed: int = 0, **kwargs):
        try:
            from gfootball.env import create_environment
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "FootballEnv requires the `gfootball` package "
                "(https://github.com/google-research/football)") from e
        # no seed reaches the engine, as in JAX's adapter (ROADMAP Queue 3):
        # `seed` is taken and not passed on. `render` stays off whatever
        # `use_render` says (JAX's `use_render and False`); frames come
        # from `render()`
        self.env = create_environment(
            env_name=scenario_name,
            stacked=stacked,
            representation=representation,
            rewards=rewards,
            number_of_left_players_agent_controls=num_agents,
            channel_dimensions=(smm_width, smm_height),
            render=use_render and False,
            **kwargs)
        self.num_agents = num_agents
        self.share_reward = share_reward
        self.max_steps = self.env.unwrapped.observation()[0]["steps_left"]

        # split the joint spaces per agent (Football_Env.py:53-73)
        if num_agents == 1:
            self.observation_space = [sp.from_gym(self.env.observation_space)]
            self.action_space = [sp.from_gym(self.env.action_space)]
        else:
            obs_shape = self.env.observation_space.shape[1:]
            self.observation_space = [sp.Box(tuple(int(s) for s in obs_shape))
                                      ] * num_agents
            self.action_space = [sp.Discrete(int(self.env.action_space.nvec[0]))
                                 ] * num_agents
        share_dim = int(np.prod(self.observation_space[0].shape)) * num_agents
        self.share_observation_space = [sp.Box((share_dim,))] * num_agents

    def reset(self):
        obs = self.env.reset()
        return np.asarray(obs, np.float32).reshape(self.num_agents, -1)

    def step(self, actions):
        acts = np.asarray(actions).reshape(self.num_agents).astype(np.int64)
        obs, reward, done, info = self.env.step(acts.tolist())
        obs = np.asarray(obs, np.float32).reshape(self.num_agents, -1)
        reward = np.asarray(reward, np.float32).reshape(self.num_agents, 1)
        if self.share_reward:
            reward = np.full_like(reward, reward.sum())
        dones = np.full(self.num_agents, bool(done))
        infos = [self._enrich_info(info)] * self.num_agents
        return obs, reward, dones, infos

    def _enrich_info(self, info):
        """Reference `_info_wrapper` (Football_Env.py:108-115): merge the
        raw player-0 observation dict, then max_steps and per-player
        active/designated/sticky_actions arrays."""
        raw = self.env.unwrapped.observation()
        info = dict(info)
        info.update(raw[0])
        info["max_steps"] = self.max_steps
        info["active"] = np.array(
            [raw[i]["active"] for i in range(self.num_agents)])
        info["designated"] = np.array(
            [raw[i]["designated"] for i in range(self.num_agents)])
        info["sticky_actions"] = np.stack(
            [raw[i]["sticky_actions"] for i in range(self.num_agents)])
        return info

    def seed(self, seed=None):
        # the reference seeds the global python RNG (Football_Env.py:93-97,
        # seed None → 1); the engine's own seed gets the resolved value
        # too (None would reseed it from entropy)
        import random
        resolved = 1 if seed is None else seed
        random.seed(resolved)
        if hasattr(self.env, "seed"):
            self.env.seed(resolved)

    def render(self, mode="rgb_array"):
        return self.env.render(mode)

    def close(self):
        self.env.close()


def football_metrics():
    """Goal / win-rate / steps extractor (football_runner.py:111-150)."""
    def extract(infos):
        if not infos:
            return {}
        scores, wins = [], []
        for info in infos:
            i = info[0] if isinstance(info, (list, tuple)) else info
            if isinstance(i, dict) and "score_reward" in i:
                scores.append(i["score_reward"])
                wins.append(1.0 if i["score_reward"] > 0 else 0.0)
        if not scores:
            return {}
        return {"goal": float(np.mean(scores)),
                "win_rate": float(np.mean(wins))}
    return extract
