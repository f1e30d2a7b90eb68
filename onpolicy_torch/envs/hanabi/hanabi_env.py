"""Hanabi presets and the fleet over the C++ engine.

The port's own copy of `onpolicy_tpu/envs/hanabi/hanabi_env.py` (the
reference's `Hanabi_Env.py`):
  * presets Hanabi-Full / Full-Minimal / Small / Very-Small
    (`Hanabi_Env.py:118-160`);
  * obs = canonical encoding + current-player one-hot "agent_turn"
    (`:305`);
  * share_obs = own-hand encoding + obs + agent_turn (the centralized
    critic sees the current player's hidden hand, `:306-311`), or every
    player's view + agent_turn under use_obs_instead_of_state;
  * action −1 = no-op for seats that do not act (`:461-468`); finished
    games present zeroed rows and zero availability; reward = score delta
    broadcast to all players;
  * no auto-reset: the runner resets the games it chooses.

`HanabiVecEnv` runs all N games in the native batched engine
(`binding.HanabiBatch`), one call for the fleet; it and `HanabiSingleEnv`
speak numpy, and the runner moves their arrays to its device.
`HanabiHostPoolEnv` speaks `HanabiVecEnv`'s protocol over a pool of
`HanabiSingleEnv` worker processes (`envs/host_vec.py`). The
device-resident fleet is `torch_fleet.TorchHanabiFleet`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from onpolicy_torch.envs.hanabi.binding import HanabiBatch
from onpolicy_torch.utils import spaces as sp

PRESETS = {
    "Hanabi-Full": dict(colors=5, ranks=5, max_info=8, max_life=3,
                        hand_size=-1, minimal=False),
    # MINIMAL observation_type: no V0-belief section (Hanabi_Env.py:136)
    "Hanabi-Full-Minimal": dict(colors=5, ranks=5, max_info=8, max_life=3,
                                hand_size=-1, minimal=True),
    "Hanabi-Small": dict(colors=2, ranks=5, max_info=3, max_life=1,
                         hand_size=2, minimal=False),
    "Hanabi-Very-Small": dict(colors=1, ranks=5, max_info=3, max_life=1,
                              hand_size=2, minimal=False),
}


class HanabiVecEnv:
    """N lockstep games; Choose-protocol batched API."""

    def __init__(self, hanabi_name: str, num_agents: int, n_envs: int,
                 seed: int = 0, use_obs_instead_of_state: bool = False):
        if hanabi_name not in PRESETS:
            raise ValueError(f"unknown hanabi preset {hanabi_name!r}; "
                             f"known: {sorted(PRESETS)}")
        p = PRESETS[hanabi_name]
        self.batch = HanabiBatch(n_envs, colors=p["colors"], ranks=p["ranks"],
                                 players=num_agents,
                                 hand_size=p["hand_size"],
                                 max_info=p["max_info"],
                                 max_life=p["max_life"],
                                 minimal=p["minimal"], seed=seed)
        self.n_envs = n_envs
        self.num_agents = M = num_agents
        self.obs_instead_of_state = use_obs_instead_of_state
        self.obs_dim = self.batch.obs_dim + M
        if use_obs_instead_of_state:
            self.share_dim = self.batch.obs_dim * M + M
        else:
            self.share_dim = self.batch.ownhand_dim + self.batch.obs_dim + M
        self.n_moves = self.batch.max_moves
        self.observation_space = [sp.Box((self.obs_dim,))] * M
        self.share_observation_space = [sp.Box((self.share_dim,))] * M
        self.action_space = [sp.Discrete(self.n_moves)] * M

    def _gather(self):
        obs_raw, own, avail, cur, done, score = self.batch.observe()
        N, M = self.n_envs, self.num_agents
        turn = np.zeros((N, M), np.float32)
        turn[np.arange(N), cur] = 1.0
        obs = np.concatenate([obs_raw, turn], -1)
        if self.obs_instead_of_state:
            # every seat's canonical view + agent_turn (Hanabi_Env.py:306-311)
            views = [self.batch.observe_player(p) for p in range(M)]
            share = np.concatenate(views + [turn], -1)
        else:
            share = np.concatenate([own, obs_raw, turn], -1)
        obs[done] = 0.0
        share[done] = 0.0
        avail[done] = 0.0
        return obs, share, avail, cur, done, score

    def reset(self, reset_choose: Optional[np.ndarray] = None):
        """Fresh games where `reset_choose` [N] (all if None) →
        (obs, share_obs, avail, cur_player) of the whole fleet."""
        self.batch.reset(None if reset_choose is None
                         else np.asarray(reset_choose, bool))
        obs, share, avail, cur, _, _ = self._gather()
        return obs, share, avail, cur

    def step(self, actions: np.ndarray):
        """actions [N] int, −1 no-op → (obs, share_obs, rewards [N,M,1],
        done [N], cur_player [N], avail [N,A], scores [N])."""
        rew = self.batch.step(np.asarray(actions, np.int64))
        obs, share, avail, cur, done, score = self._gather()
        rewards = np.repeat(rew[:, None, None], self.num_agents, axis=1)
        return obs, share, rewards, done, cur, avail, score

    def close(self):
        self.batch.close()


class HanabiSingleEnv:
    """ONE game over the native engine, with the reference's per-env
    Choose contract (`Hanabi_Env.py:188-505`): `reset()` → (obs,
    share_obs, available_actions); `step(a)` → (obs, share_obs, rewards
    [M,1], dones [M], info, avail). The env a pool of worker processes
    runs, one game each."""

    def __init__(self, hanabi_name: str, num_agents: int, seed: int = 0,
                 use_obs_instead_of_state: bool = False):
        self._vec = HanabiVecEnv(
            hanabi_name, num_agents, 1, seed=seed,
            use_obs_instead_of_state=use_obs_instead_of_state)
        self.num_agents = num_agents
        self.observation_space = self._vec.observation_space
        self.share_observation_space = self._vec.share_observation_space
        self.action_space = self._vec.action_space

    def reset(self):
        obs, share, avail, _ = self._vec.reset()
        return obs[0], share[0], avail[0]

    def step(self, action):
        # a pool hands the env its [M, act_dim] slice of the action block;
        # one seat acts a turn, so every row carries the same value
        a = int(np.asarray(action).reshape(-1)[0])
        obs, share, rewards, done, _, avail, score = self._vec.step(
            np.asarray([a], np.int64))
        info = {"score": int(score[0])}
        dones = np.full((self.num_agents,), bool(done[0]))
        return obs[0], share[0], rewards[0], dones, info, avail[0]

    def close(self):
        self._vec.close()


class HanabiHostPoolEnv:
    """The `HanabiVecEnv` protocol over a pool of one-game engines — the
    reference's Hanabi data path (`ChooseSubprocVecEnv` of `Hanabi_Env`,
    `train_hanabi_forward.py:25-47`) through the shared-memory pool.
    `pool` is an `envs/host_vec.HostVecEnv` or `DummyVecEnv` with protocol
    "choose" over `HanabiSingleEnv`s. The current player is read from the
    agent-turn one-hot at the end of obs; the scores come in the step
    infos."""

    def __init__(self, pool, num_agents: int):
        self.pool = pool
        self.n_envs = pool.n_envs
        self.num_agents = num_agents
        self.observation_space = pool.observation_space
        self.share_observation_space = pool.share_observation_space
        self.action_space = pool.action_space
        self.obs_dim = self.observation_space[0].shape[0]
        self.share_dim = self.share_observation_space[0].shape[0]
        self.n_moves = self.action_space[0].n

    def _cur(self, obs):
        turn = obs[:, -self.num_agents:]
        return np.argmax(turn, axis=1).astype(np.int32)

    def reset(self, reset_choose: Optional[np.ndarray] = None):
        obs, share, avail = self.pool.reset(reset_choose)
        return obs, share, avail, self._cur(obs)

    def step(self, actions: np.ndarray):
        """actions [N] (−1 no-op) → (obs, share_obs, rewards [N,M,1],
        done [N], cur_player [N], avail [N,A], scores [N])."""
        acts = np.repeat(np.asarray(actions, np.float32)[:, None, None],
                         self.num_agents, axis=1)
        obs, share, rewards, dones, infos, avail = self.pool.step(acts)
        score = np.asarray([i.get("score", 0) for i in infos], np.float32)
        done = np.asarray(dones)[:, 0].astype(bool)
        return obs, share, rewards, done, self._cur(obs), avail, score

    def close(self):
        self.pool.close()
