"""SMACv2 adapter: capability-randomized SMAC over the public `smacv2`
package, adapted to the 6-tuple share protocol.

The port's own copy of `onpolicy_tpu/envs/starcraft2/smacv2_env.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

Parity targets both reference wrappers:
  * the reference's `onpolicy/envs/starcraft2/SMACv2_modified.py`
    (env_name StarCraft2v2 — the launch scripts' path): per-agent
    agent-specific global state (`get_state_agent`) and PER-AGENT dones
    from `death_tracker_ally` (`SMACv2_modified.py:32-42`);
  * the reference's `onpolicy/envs/starcraft2/SMACv2.py`
    (env_name SMACv2): engine joint state replicated, scalar dones.

The reference's vendored engine adds `get_state_agent` to SMACv2; the
public smacv2 package has no such method, so the AS state is built by
`v2_builders.agent_state` from a unit snapshot (executed-reference
goldens in tests/test_smacv2_reference_golden.py — the v2 layout
differs from v1: enemy visible flag, capability blocks, own-pos,
[ally|enemy|move|own|id] order). Info dict carries
battles_won/battles_game/battles_draw/restarts/won and bad_transition
on episode-limit truncation (`SMACv2_modified.py:45-52`).

Import-gated (smacv2 + SC2 install).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from onpolicy_torch.utils import spaces as sp


class SMACv2Env:
    def __init__(self, map_name: str, distribution_config: dict,
                 seed=None, state_type: str = "agent_feature",
                 per_agent_dones: bool = True,
                 state_options: Optional[dict] = None):
        try:
            from smacv2.env import StarCraftCapabilityEnvWrapper
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "SMACv2Env requires the `smacv2` package and a StarCraft II "
                "install (https://github.com/oxwhirl/smacv2)") from e
        self.env = StarCraftCapabilityEnvWrapper(
            capability_config=distribution_config, map_name=map_name,
            debug=False, conic_fov=False, obs_own_pos=True,
            use_unit_ranges=True, min_attack_range=2, seed=seed)
        info = self.env.get_env_info()
        self.num_agents = M = info["n_agents"]
        self.n_actions = info["n_actions"]
        self.episode_limit = info["episode_limit"]
        self.state_type = state_type
        self.per_agent_dones = per_agent_dones
        obs_dim = info["obs_shape"]
        state_dim = info["state_shape"]
        from onpolicy_torch.envs.starcraft2 import v2_builders as sb
        self._state_options = dict(state_options or {})
        self._sb_cfg = dataclasses.replace(
            sb.config_from_smacv2(self.env.env), **self._state_options)
        if state_type == "concat":
            share_dim = obs_dim * M
        elif state_type == "agent":
            share_dim = state_dim + obs_dim
        elif state_type == "agent_feature":
            share_dim = sb.state_dim(self._sb_cfg)
        else:
            share_dim = state_dim
        self.observation_space = [sp.Box((obs_dim,))] * M
        self.share_observation_space = [sp.Box((share_dim,))] * M
        self.action_space = [sp.Discrete(self.n_actions)] * M

    def _share_obs(self, obs):
        M = self.num_agents
        if self.state_type == "concat":
            return np.tile(np.concatenate(obs, -1), (M, 1)).astype(np.float32)
        if self.state_type == "agent_feature":
            from onpolicy_torch.envs.starcraft2 import v2_builders as sb
            snap = sb.snapshot_from_smacv2(self.env.env)
            return sb.all_agent_states(self._sb_cfg, snap)
        state = np.asarray(self.env.get_state(), np.float32)
        if self.state_type == "agent":
            return np.stack([np.concatenate([state, o]) for o in obs]
                            ).astype(np.float32)
        return np.tile(state, (M, 1)).astype(np.float32)

    def _gather(self):
        obs = np.asarray(self.env.get_obs(), np.float32)
        avail = np.asarray(self.env.get_avail_actions(), np.float32)
        return obs, self._share_obs(obs), avail

    def reset(self):
        from onpolicy_torch.envs.starcraft2 import v2_builders as sb
        self.env.reset()
        # engine geometry (map_x/max_distance_*) exists only after launch
        self._sb_cfg = dataclasses.replace(
            sb.config_from_smacv2(self.env.env), **self._state_options)
        return self._gather()

    def step(self, actions):
        M = self.num_agents
        acts = np.asarray(actions).reshape(M).astype(np.int64)
        reward, terminated, info = self.env.step(acts)
        obs, share, avail = self._gather()
        rewards = np.full((M, 1), float(reward), np.float32)
        inner = self.env.env
        if terminated or not self.per_agent_dones:
            dones = np.full(M, bool(terminated))
        else:
            tracker = getattr(inner, "death_tracker_ally", np.zeros(M))
            dones = np.array([bool(tracker[i]) for i in range(M)])
        base = {
            "battles_won": getattr(inner, "battles_won", 0),
            "battles_game": getattr(inner, "battles_game", 0),
            "battles_draw": getattr(inner, "timeouts", 0),
            "restarts": getattr(inner, "force_restarts", 0),
            "bad_transition": bool(
                getattr(inner, "_episode_steps", 0) >= self.episode_limit),
            "won": bool(getattr(inner, "win_counted",
                                info.get("battle_won", False))),
        }
        return obs, share, rewards, dones, [dict(base)] * M, avail

    def seed(self, seed):
        pass  # seeded at construction

    def close(self):
        self.env.close()
