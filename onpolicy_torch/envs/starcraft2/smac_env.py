"""SMAC (StarCraft Multi-Agent Challenge) adapter.

The port's own copy of `onpolicy_tpu/envs/starcraft2/smac_env.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

The reference vendors a full 2054-line SC2 env speaking the pysc2
protobuf protocol (the reference's `onpolicy/envs/starcraft2/
StarCraft2_Env.py`). The simulator stays on the host, so we
adapt the public `smac` package's StarCraft2Env to this framework's
6-tuple share protocol (`HostVecEnv`):

    reset() → (obs [M,Do], share_obs [M,Ds], available_actions [M,A])
    step(actions [M,1]) → (+ rewards [M,1], dones [M], infos)

reproducing the reference's step semantics (`StarCraft2_Env.py:455-615`):
per-agent dones on death, env done on battle end, `bad_transition` info
on episode-limit truncation, battles_won/battles_game counters, and
SC2-crash resilience via full env restart (`:405-453` — the reference's
only fault-tolerance mechanism).

Global state options (`--use_obs_instead_of_state` and the MAPPO paper's
agent-specific state): "env" uses the engine's get_state() replicated
per agent; "concat" concatenates all agents' obs
(use_obs_instead_of_state); "agent" appends each agent's own obs to the
env state; "agent_feature" builds the paper's FULL agent-specific AS
state per agent via `state_builder.agent_specific_state` (faithful
re-derivation of `get_state_agent`, `:1327-1521`, reading unit data
through the public smac engine attributes).

Import-gated: requires `smac` + a StarCraft II installation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from onpolicy_torch.utils import spaces as sp


class SMACEnv:
    def __init__(self, map_name: str = "3s5z", seed: Optional[int] = None,
                 state_type: str = "env",
                 state_options: Optional[dict] = None):
        try:
            from smac.env import StarCraft2Env
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "SMACEnv requires the `smac` package and a StarCraft II "
                "install (https://github.com/oxwhirl/smac)") from e
        self._seed = seed
        self._make = lambda: StarCraft2Env(map_name=map_name,
                                           seed=self._seed)
        self.env = self._make()
        info = self.env.get_env_info()
        self.num_agents = M = info["n_agents"]
        self.n_actions = info["n_actions"]
        self.episode_limit = info["episode_limit"]
        self.state_type = state_type
        state_dim = info["state_shape"]
        from onpolicy_torch.envs.starcraft2 import obs_builder as ob
        from onpolicy_torch.envs.starcraft2 import state_builder as sb
        self._state_options = dict(state_options or {})
        self._sb_cfg = dataclasses.replace(
            sb.config_from_smac(self.env), **self._state_options)
        # observations follow the reference's get_obs_agent (obs_builder),
        # not pip smac's get_obs: the reference constructs its env with
        # obs_last_action=True and obs_agent_id=True (which pip smac
        # lacks), so the delegated vector would be smaller.
        obs_dim = ob.obs_dim(self._sb_cfg)
        if state_type == "concat":
            share_dim = obs_dim * M
        elif state_type == "agent":
            share_dim = state_dim + obs_dim
        elif state_type == "agent_feature":
            share_dim = sb.state_dim(self._sb_cfg)
        else:
            # per-agent EP state with ablation blocks (`get_state(agent_id)`,
            # StarCraft2_Env.py:419-422 — NOT the engine's joint get_state)
            share_dim = sb.env_state_dim(self._sb_cfg, obs_dim)
        self.observation_space = [sp.Box((obs_dim,))] * M
        self.share_observation_space = [sp.Box((share_dim,))] * M
        self.action_space = [sp.Discrete(self.n_actions)] * M
        self.force_restarts = 0

    # ---- state builders ------------------------------------------------
    def _share_obs(self, obs):
        M = self.num_agents
        if self.state_type == "concat":
            flat = np.concatenate(obs, -1)
            return np.tile(flat, (M, 1)).astype(np.float32)
        from onpolicy_torch.envs.starcraft2 import state_builder as sb
        if self.state_type == "agent_feature":
            snap = sb.snapshot_from_smac(self.env)
            return sb.all_agent_states(self._sb_cfg, snap)
        if self.state_type == "agent":
            state = np.asarray(self.env.get_state(), np.float32)
            return np.stack([np.concatenate([state, o]) for o in obs]
                            ).astype(np.float32)
        snap = sb.snapshot_from_smac(self.env)
        return sb.all_env_states(self._sb_cfg, snap, local_obs=np.asarray(obs))

    def _gather(self):
        from onpolicy_torch.envs.starcraft2 import obs_builder as ob
        from onpolicy_torch.envs.starcraft2 import state_builder as sb
        obs = ob.all_obs(self._sb_cfg, sb.snapshot_from_smac(self.env))
        avail = np.asarray(self.env.get_avail_actions(), np.float32)
        return obs, self._share_obs(obs), avail

    def _refresh_cfg(self):
        """Re-read engine geometry AFTER launch: smac's StarCraft2Env sets
        map_x/map_y/max_distance_* only in _launch() (first reset) — the
        values captured at __init__ are zeros, which would make every
        center-xy feature divide by zero. Feature COUNTS don't depend on
        geometry, so share_dim from __init__ stays valid."""
        import dataclasses as _dc
        from onpolicy_torch.envs.starcraft2 import state_builder as sb
        self._sb_cfg = _dc.replace(sb.config_from_smac(self.env),
                                   **self._state_options)

    # ---- protocol ------------------------------------------------------
    def reset(self):
        try:
            self.env.reset()
        except Exception:
            self._restart()
            self.env.reset()
        self._refresh_cfg()
        return self._gather()

    def _restart(self):
        """Kill + relaunch SC2 (`full_restart`, StarCraft2_Env.py:438-453)."""
        self.force_restarts += 1
        try:
            self.env.close()
        except Exception:
            pass
        self.env = self._make()

    def step(self, actions):
        M = self.num_agents
        acts = np.asarray(actions).reshape(M).astype(np.int64)
        try:
            reward, terminated, info = self.env.step(acts)
        except Exception:
            # SC2 crash: abandon episode (reference :483-528)
            self._restart()
            obs, share, avail = self.reset()
            dones = np.ones(M, bool)
            infos = [{"bad_transition": True,
                      "force_restarts": self.force_restarts}] * M
            return obs, share, np.zeros((M, 1), np.float32), dones, \
                infos, avail

        obs, share, avail = self._gather()
        rewards = np.full((M, 1), float(reward), np.float32)
        if terminated:
            dones = np.ones(M, bool)
        else:
            dones = np.array([self.env.death_tracker_ally[i] > 0
                              for i in range(M)], bool) \
                if hasattr(self.env, "death_tracker_ally") \
                else np.zeros(M, bool)
        base = {
            "battles_won": getattr(self.env, "battles_won", 0),
            "battles_game": getattr(self.env, "battles_game", 0),
            "bad_transition": bool(terminated
                                   and info.get("episode_limit", False)),
            "won": bool(info.get("battle_won", False)),
        }
        infos = [dict(base) for _ in range(M)]
        return obs, share, rewards, dones, infos, avail

    def seed(self, seed):
        """Re-seed after construction (the reference's eval pools call
        seed(seed*50000 + rank*10000)). smac takes the seed at (re)launch,
        so it is kept for the next restart and pushed into the live
        engine's RNG where the engine has one."""
        self._seed = seed
        hooked = False
        if hasattr(self.env, "_seed"):
            self.env._seed = seed
            hooked = True
        rng = getattr(self.env, "np_random", None) or getattr(
            getattr(self.env, "_env", None), "np_random", None)
        if rng is not None and hasattr(rng, "seed"):
            rng.seed(seed)
            hooked = True
        if not hooked:
            import warnings
            warnings.warn(
                "smac engine exposes neither _seed nor np_random; the new "
                "seed only takes effect at the next engine restart "
                "(construction seed stays live until then)", RuntimeWarning)

    def close(self):
        self.env.close()


def smac_win_rate_metrics():
    """Incremental win-rate extractor for HostSharedRunner
    (`smac_runner.py:66-88`): Δbattles_won / Δbattles_game between calls."""
    last = {"won": 0, "game": 0}

    def extract(infos):
        if not infos:
            return {}
        info = infos[0][0] if isinstance(infos[0], (list, tuple)) \
            else infos[0]
        won = sum((i[0] if isinstance(i, (list, tuple)) else i)
                  .get("battles_won", 0) for i in infos)
        game = sum((i[0] if isinstance(i, (list, tuple)) else i)
                   .get("battles_game", 0) for i in infos)
        dwon, dgame = won - last["won"], game - last["game"]
        last.update(won=won, game=game)
        return {"incre_win_rate": dwon / dgame if dgame > 0 else 0.0}

    return extract
