"""Agent-specific ("AS") global state builder for SMAC.

The port's own copy of `onpolicy_tpu/envs/starcraft2/state_builder.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

Faithful re-derivation of the MAPPO paper's agent-specific centralized
state (the reference's `onpolicy/envs/starcraft2/StarCraft2_Env.py:
1327-1521`, `get_state_agent`): per agent, the concatenation of

    ally feats   [(M−1) × (4 + 1 + health(+shield) + center₂ + type_bits
                  + last_action)]
    enemy feats  [E × (5 + health(+shield) + type_bits + center₂)]
    move feats   [n_actions_move]
    own feats    [4 + health(+shield) + center₂ + type_bits + last_action]
    (+ agent-id one-hot, + timestep fraction)

with the reference's exact field orderings (allies put center BEFORE
unit type; enemies put type BEFORE center) and sight-range/center-xy
normalizations. Dead agents (mustalive) yield zero vectors.

Implemented as a pure function over a `Snapshot` of plain arrays so it
is unit-testable without StarCraft II; `snapshot_from_smac` adapts a
live `smac.env.StarCraft2Env`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class StateConfig:
    n_agents: int
    n_enemies: int
    n_actions: int
    map_x: float
    map_y: float
    max_distance_x: float
    max_distance_y: float
    unit_type_bits: int = 0
    shield_bits_ally: int = 0
    shield_bits_enemy: int = 0
    obs_all_health: bool = True
    obs_own_health: bool = True
    # observation-path flags (reference construction defaults,
    # StarCraft2_Env.py:77-84 — note pip smac defaults obs_last_action
    # False and has no obs_agent_id; consumed by obs_builder)
    obs_last_action: bool = True
    obs_agent_id: bool = True
    obs_timestep_number: bool = False
    add_center_xy: bool = True
    state_last_action: bool = True
    state_agent_id: bool = True
    state_timestep_number: bool = False
    use_mustalive: bool = True
    n_actions_move: int = 4
    n_actions_no_attack: int = 6
    episode_limit: int = 400
    # EP-state ablation blocks (`train_smac.py:112-118`, consumed by the
    # per-agent `get_state`, `StarCraft2_Env.py:1152-1325`); all default
    # False like the reference entry point.
    add_move_state: bool = False
    add_local_obs: bool = False
    add_distance_state: bool = False
    add_xy_state: bool = False
    add_visible_state: bool = False
    add_enemy_action_state: bool = False
    add_agent_id: bool = False


@dataclass
class Snapshot:
    """Plain-array view of one SC2 step."""
    # allies [M, ...]
    ally_x: np.ndarray
    ally_y: np.ndarray
    ally_health: np.ndarray
    ally_health_max: np.ndarray
    ally_shield: np.ndarray
    ally_shield_max: np.ndarray
    ally_type: np.ndarray            # int type ids ∈ [0, unit_type_bits)
    ally_cooldown: np.ndarray        # weapon cooldown (or energy, medivac)
    ally_max_cooldown: np.ndarray
    # enemies [E, ...]
    enemy_x: np.ndarray
    enemy_y: np.ndarray
    enemy_health: np.ndarray
    enemy_health_max: np.ndarray
    enemy_shield: np.ndarray
    enemy_shield_max: np.ndarray
    enemy_type: np.ndarray
    # per-agent
    sight_range: np.ndarray          # [M]
    avail_actions: np.ndarray        # [M, n_actions]
    last_actions: np.ndarray         # [M, n_actions] one-hot
    episode_steps: int = 0


def _nf_ally(cfg: StateConfig) -> int:
    nf = 4 + 1
    if cfg.obs_all_health:
        nf += 1 + (1 if cfg.shield_bits_ally > 0 else 0)
    if cfg.add_center_xy:
        nf += 2
    nf += cfg.unit_type_bits
    if cfg.state_last_action:
        nf += cfg.n_actions
    return nf


def _nf_enemy(cfg: StateConfig) -> int:
    nf = 5
    if cfg.obs_all_health:
        nf += 1 + (1 if cfg.shield_bits_enemy > 0 else 0)
    nf += cfg.unit_type_bits
    if cfg.add_center_xy:
        nf += 2
    return nf


def _nf_own(cfg: StateConfig) -> int:
    nf = 4
    if cfg.obs_own_health:
        nf += 1 + (1 if cfg.shield_bits_ally > 0 else 0)
    if cfg.add_center_xy:
        nf += 2
    nf += cfg.unit_type_bits
    if cfg.state_last_action:
        nf += cfg.n_actions
    return nf


def state_dim(cfg: StateConfig) -> int:
    d = ((cfg.n_agents - 1) * _nf_ally(cfg) + cfg.n_enemies * _nf_enemy(cfg)
         + cfg.n_actions_move + _nf_own(cfg))
    if cfg.state_agent_id:
        d += cfg.n_agents
    if cfg.state_timestep_number:
        d += 1
    return d


def agent_specific_state(cfg: StateConfig, snap: Snapshot,
                         agent_id: int) -> np.ndarray:
    ally_feats = np.zeros((cfg.n_agents - 1, _nf_ally(cfg)), np.float32)
    enemy_feats = np.zeros((cfg.n_enemies, _nf_enemy(cfg)), np.float32)
    move_feats = np.zeros(cfg.n_actions_move, np.float32)
    own_feats = np.zeros(_nf_own(cfg), np.float32)

    alive = snap.ally_health[agent_id] > 0
    if alive or not cfg.use_mustalive:
        x, y = snap.ally_x[agent_id], snap.ally_y[agent_id]
        sight = max(float(snap.sight_range[agent_id]), 1e-6)
        cx, cy = cfg.map_x / 2.0, cfg.map_y / 2.0
        avail = snap.avail_actions[agent_id]

        move_feats[:] = avail[2:2 + cfg.n_actions_move]

        # enemies (type BEFORE center, :1407-1423)
        for e in range(cfg.n_enemies):
            if snap.enemy_health[e] <= 0:
                continue
            ex, ey = snap.enemy_x[e], snap.enemy_y[e]
            dist = float(np.hypot(ex - x, ey - y))
            if alive:
                enemy_feats[e, 0] = avail[cfg.n_actions_no_attack + e]
                enemy_feats[e, 1] = dist / sight
                enemy_feats[e, 2] = (ex - x) / sight
                enemy_feats[e, 3] = (ey - y) / sight
                if dist < sight:
                    enemy_feats[e, 4] = 1.0
            ind = 5
            if cfg.obs_all_health:
                enemy_feats[e, ind] = (snap.enemy_health[e]
                                       / max(snap.enemy_health_max[e], 1e-6))
                ind += 1
                if cfg.shield_bits_enemy > 0:
                    enemy_feats[e, ind] = (
                        snap.enemy_shield[e]
                        / max(snap.enemy_shield_max[e], 1e-6))
                    ind += 1
            if cfg.unit_type_bits > 0:
                enemy_feats[e, ind + int(snap.enemy_type[e])] = 1.0
                ind += cfg.unit_type_bits
            if cfg.add_center_xy:
                enemy_feats[e, ind] = (ex - cx) / cfg.max_distance_x
                enemy_feats[e, ind + 1] = (ey - cy) / cfg.max_distance_y

        # allies (center BEFORE type, :1448-1468)
        al_ids = [a for a in range(cfg.n_agents) if a != agent_id]
        for i, al in enumerate(al_ids):
            if snap.ally_health[al] <= 0:
                continue
            ax, ay = snap.ally_x[al], snap.ally_y[al]
            dist = float(np.hypot(ax - x, ay - y))
            if alive:
                if dist < sight:
                    ally_feats[i, 0] = 1.0
                ally_feats[i, 1] = dist / sight
                ally_feats[i, 2] = (ax - x) / sight
                ally_feats[i, 3] = (ay - y) / sight
            ally_feats[i, 4] = (snap.ally_cooldown[al]
                                / max(snap.ally_max_cooldown[al], 1e-6))
            ind = 5
            if cfg.obs_all_health:
                ally_feats[i, ind] = (snap.ally_health[al]
                                      / max(snap.ally_health_max[al], 1e-6))
                ind += 1
                if cfg.shield_bits_ally > 0:
                    ally_feats[i, ind] = (snap.ally_shield[al]
                                          / max(snap.ally_shield_max[al],
                                                1e-6))
                    ind += 1
            if cfg.add_center_xy:
                ally_feats[i, ind] = (ax - cx) / cfg.max_distance_x
                ally_feats[i, ind + 1] = (ay - cy) / cfg.max_distance_y
                ind += 2
            if cfg.unit_type_bits > 0:
                ally_feats[i, ind + int(snap.ally_type[al])] = 1.0
                ind += cfg.unit_type_bits
            if cfg.state_last_action:
                ally_feats[i, ind:] = snap.last_actions[al]

        # own (:1470-1496)
        own_feats[0] = 1.0
        ind = 4
        if cfg.obs_own_health:
            own_feats[ind] = (snap.ally_health[agent_id]
                              / max(snap.ally_health_max[agent_id], 1e-6))
            ind += 1
            if cfg.shield_bits_ally > 0:
                own_feats[ind] = (snap.ally_shield[agent_id]
                                  / max(snap.ally_shield_max[agent_id], 1e-6))
                ind += 1
        if cfg.add_center_xy:
            own_feats[ind] = (x - cx) / cfg.max_distance_x
            own_feats[ind + 1] = (y - cy) / cfg.max_distance_y
            ind += 2
        if cfg.unit_type_bits > 0:
            own_feats[ind + int(snap.ally_type[agent_id])] = 1.0
            ind += cfg.unit_type_bits
        if cfg.state_last_action:
            own_feats[ind:] = snap.last_actions[agent_id]

    state = np.concatenate([ally_feats.ravel(), enemy_feats.ravel(),
                            move_feats, own_feats])
    if cfg.state_agent_id:
        one_hot = np.zeros(cfg.n_agents, np.float32)
        one_hot[agent_id] = 1.0
        state = np.concatenate([state, one_hot])
    if cfg.state_timestep_number:
        state = np.append(state, snap.episode_steps / cfg.episode_limit)
    return state.astype(np.float32)


def all_agent_states(cfg: StateConfig, snap: Snapshot) -> np.ndarray:
    return np.stack([agent_specific_state(cfg, snap, i)
                     for i in range(cfg.n_agents)])


# ---- per-agent EP ("env") state --------------------------------------
#
# Faithful re-derivation of the reference's `get_state(agent_id)`
# (`StarCraft2_Env.py:1152-1325`): the environment-provided global state
# conditioned per agent (mustalive zeroing + optional agent-relative
# ablation blocks). Used when `--use_state_agent` is off. Row layouts:
#   ally  [health, cooldown|energy, (center₂), (shield), (type one-hot),
#          (dist), (rel xy₂), (visible), (last_action)]
#   enemy [health, (center₂), (shield), (type one-hot), (dist),
#          (rel xy₂), (visible), (attackable)] + last_action zero padding
# (the size calculator reserves n_actions per enemy row that the body
# never writes — reproduced verbatim, `:1180-1182`).

def _nf_al_env(cfg: StateConfig) -> int:
    nf = 2 + cfg.shield_bits_ally + cfg.unit_type_bits
    nf += 2 if cfg.add_center_xy else 0
    nf += 1 if cfg.add_distance_state else 0
    nf += 2 if cfg.add_xy_state else 0
    nf += 1 if cfg.add_visible_state else 0
    nf += cfg.n_actions if cfg.state_last_action else 0
    return nf


def _nf_en_env(cfg: StateConfig) -> int:
    nf = 1 + cfg.shield_bits_enemy + cfg.unit_type_bits
    nf += 2 if cfg.add_center_xy else 0
    nf += 1 if cfg.add_distance_state else 0
    nf += 2 if cfg.add_xy_state else 0
    nf += 1 if cfg.add_visible_state else 0
    nf += cfg.n_actions if cfg.state_last_action else 0
    nf += 1 if cfg.add_enemy_action_state else 0
    return nf


def env_state_dim(cfg: StateConfig, obs_dim: int = 0) -> int:
    """Size of `env_state` (`get_state_size` env branch, `:1683-1736`)."""
    d = cfg.n_agents * _nf_al_env(cfg) + cfg.n_enemies * _nf_en_env(cfg)
    if cfg.add_move_state:
        d += cfg.n_actions_move
    if cfg.add_local_obs:
        d += obs_dim
    if cfg.state_timestep_number:
        d += 1
    if cfg.add_agent_id:
        d += cfg.n_agents
    return d


def env_state(cfg: StateConfig, snap: Snapshot, agent_id: int,
              local_obs: Optional[np.ndarray] = None) -> np.ndarray:
    ally_state = np.zeros((cfg.n_agents, _nf_al_env(cfg)), np.float32)
    enemy_state = np.zeros((cfg.n_enemies, _nf_en_env(cfg)), np.float32)
    move_state = np.zeros(cfg.n_actions_move, np.float32)

    x, y = snap.ally_x[agent_id], snap.ally_y[agent_id]
    sight = max(float(snap.sight_range[agent_id]), 1e-6)
    cx, cy = cfg.map_x / 2.0, cfg.map_y / 2.0
    avail = snap.avail_actions[agent_id]
    alive = snap.ally_health[agent_id] > 0

    if alive or not cfg.use_mustalive:
        move_state[:] = avail[2:2 + cfg.n_actions_move]

        for al in range(cfg.n_agents):
            if snap.ally_health[al] <= 0:
                continue
            ax, ay = snap.ally_x[al], snap.ally_y[al]
            dist = float(np.hypot(ax - x, ay - y))
            ally_state[al, 0] = (snap.ally_health[al]
                                 / max(snap.ally_health_max[al], 1e-6))
            ally_state[al, 1] = (snap.ally_cooldown[al]
                                 / max(snap.ally_max_cooldown[al], 1e-6))
            ind = 2
            if cfg.add_center_xy:
                ally_state[al, ind] = (ax - cx) / cfg.max_distance_x
                ally_state[al, ind + 1] = (ay - cy) / cfg.max_distance_y
                ind += 2
            if cfg.shield_bits_ally > 0:
                ally_state[al, ind] = (snap.ally_shield[al]
                                       / max(snap.ally_shield_max[al], 1e-6))
                ind += 1
            if cfg.unit_type_bits > 0:
                ally_state[al, ind + int(snap.ally_type[al])] = 1.0
            if alive:  # agent-relative blocks (`:1246-1262`)
                ind += cfg.unit_type_bits
                if cfg.add_distance_state:
                    ally_state[al, ind] = dist / sight
                    ind += 1
                if cfg.add_xy_state:
                    ally_state[al, ind] = (ax - x) / sight
                    ally_state[al, ind + 1] = (ay - y) / sight
                    ind += 2
                if cfg.add_visible_state:
                    if dist < sight:
                        ally_state[al, ind] = 1.0
                    ind += 1
                if cfg.state_last_action:
                    ally_state[al, ind:] = snap.last_actions[al]

        for e in range(cfg.n_enemies):
            if snap.enemy_health[e] <= 0:
                continue
            ex, ey = snap.enemy_x[e], snap.enemy_y[e]
            dist = float(np.hypot(ex - x, ey - y))
            enemy_state[e, 0] = (snap.enemy_health[e]
                                 / max(snap.enemy_health_max[e], 1e-6))
            ind = 1
            if cfg.add_center_xy:
                enemy_state[e, ind] = (ex - cx) / cfg.max_distance_x
                enemy_state[e, ind + 1] = (ey - cy) / cfg.max_distance_y
                ind += 2
            if cfg.shield_bits_enemy > 0:
                enemy_state[e, ind] = (snap.enemy_shield[e]
                                       / max(snap.enemy_shield_max[e], 1e-6))
                ind += 1
            if cfg.unit_type_bits > 0:
                enemy_state[e, ind + int(snap.enemy_type[e])] = 1.0
            if alive:  # agent-relative blocks (`:1286-1302`)
                ind += cfg.unit_type_bits
                if cfg.add_distance_state:
                    enemy_state[e, ind] = dist / sight
                    ind += 1
                if cfg.add_xy_state:
                    enemy_state[e, ind] = (ex - x) / sight
                    enemy_state[e, ind + 1] = (ey - y) / sight
                    ind += 2
                if cfg.add_visible_state:
                    if dist < sight:
                        enemy_state[e, ind] = 1.0
                    ind += 1
                if cfg.add_enemy_action_state:
                    enemy_state[e, ind] = avail[cfg.n_actions_no_attack + e]

    state = np.append(ally_state.ravel(), enemy_state.ravel())
    if cfg.add_move_state:
        state = np.append(state, move_state)
    if cfg.add_local_obs:
        assert local_obs is not None, "add_local_obs requires the agent obs"
        state = np.append(state, np.asarray(local_obs, np.float32).ravel())
    if cfg.state_timestep_number:
        state = np.append(state, snap.episode_steps / cfg.episode_limit)
    if cfg.add_agent_id:
        one_hot = np.zeros(cfg.n_agents, np.float32)
        one_hot[agent_id] = 1.0
        state = np.append(state, one_hot)
    return state.astype(np.float32)


def all_env_states(cfg: StateConfig, snap: Snapshot,
                   local_obs: Optional[np.ndarray] = None) -> np.ndarray:
    return np.stack([
        env_state(cfg, snap, i,
                  None if local_obs is None else local_obs[i])
        for i in range(cfg.n_agents)])


# ---- live-env adapter ------------------------------------------------

def config_from_smac(env) -> StateConfig:
    """Build a StateConfig from a live smac StarCraft2Env."""
    return StateConfig(
        n_agents=env.n_agents, n_enemies=env.n_enemies,
        n_actions=env.n_actions,
        map_x=env.map_x, map_y=env.map_y,
        max_distance_x=getattr(env, "max_distance_x", env.map_x),
        max_distance_y=getattr(env, "max_distance_y", env.map_y),
        unit_type_bits=env.unit_type_bits,
        shield_bits_ally=env.shield_bits_ally,
        shield_bits_enemy=env.shield_bits_enemy,
        obs_all_health=env.obs_all_health,
        obs_own_health=env.obs_own_health,
        state_last_action=env.state_last_action,
        episode_limit=env.episode_limit,
    )


def snapshot_from_smac(env) -> Snapshot:
    M, E = env.n_agents, env.n_enemies
    z = lambda n: np.zeros(n, np.float32)
    s = Snapshot(
        ally_x=z(M), ally_y=z(M), ally_health=z(M), ally_health_max=z(M),
        ally_shield=z(M), ally_shield_max=z(M),
        ally_type=np.zeros(M, np.int32), ally_cooldown=z(M),
        ally_max_cooldown=z(M),
        enemy_x=z(E), enemy_y=z(E), enemy_health=z(E), enemy_health_max=z(E),
        enemy_shield=z(E), enemy_shield_max=z(E),
        enemy_type=np.zeros(E, np.int32),
        sight_range=np.array([env.unit_sight_range(i) for i in range(M)],
                             np.float32),
        avail_actions=np.asarray(env.get_avail_actions(), np.float32),
        last_actions=np.asarray(env.last_action, np.float32),
        episode_steps=getattr(env, "_episode_steps", 0),
    )
    # unit_max_shield returns None for shieldless (non-Protoss) units
    # (`StarCraft2_Env.py:906-913` has no fallthrough return)
    max_shield = lambda u: env.unit_max_shield(u) or 0.0
    for i in range(M):
        u = env.get_unit_by_id(i)
        s.ally_x[i], s.ally_y[i] = u.pos.x, u.pos.y
        s.ally_health[i], s.ally_health_max[i] = u.health, u.health_max
        s.ally_shield[i] = u.shield
        s.ally_shield_max[i] = max_shield(u)
        if env.unit_type_bits > 0:
            s.ally_type[i] = env.get_unit_type_id(u, True)
        is_medivac = (env.map_type == "MMM"
                      and u.unit_type == getattr(env, "medivac_id", -1))
        s.ally_cooldown[i] = u.energy if is_medivac else u.weapon_cooldown
        s.ally_max_cooldown[i] = env.unit_max_cooldown(u)
    for e, u in env.enemies.items():
        s.enemy_x[e], s.enemy_y[e] = u.pos.x, u.pos.y
        s.enemy_health[e], s.enemy_health_max[e] = u.health, u.health_max
        s.enemy_shield[e] = u.shield
        s.enemy_shield_max[e] = max_shield(u)
        if env.unit_type_bits > 0:
            s.enemy_type[e] = env.get_unit_type_id(u, False)
    return s
