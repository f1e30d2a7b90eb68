"""SMACv2 (vendored-engine) observation / agent-specific-state builders.

The port's own copy of `onpolicy_tpu/envs/starcraft2/v2_builders.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

Faithful re-derivation of the reference's vendored SMACv2 engine paths
(the reference's `onpolicy/envs/starcraft2/StarCraft2v2/starcraft2.py`):

  * `get_obs_agent`        (`:1451-1690`) — concat order
    [move | enemy | ally | own] (+timestep), NO agent-id one-hot;
    capability features (attack probability, health level, teammate
    type bits with replace/observe/zero-pad gating), enemy masking,
    own-position block, per-unit-type sight ranges.
  * `get_state_agent`      (`:1696-1934`) — the per-agent global state
    `SMACv2_modified` feeds the centralized critic: ally rows
    [visible, dist, rel_xy, energy/cooldown, center_xy, health,
    (shield), caps], enemy rows [available, dist, rel_xy, visible,
    center_xy, health, (shield), type bits], move, own (+2 center),
    then agent-id one-hot. No mustalive flag (plain health>0 gate).

Differences from the v1 builders (`state_builder.py`) are structural —
different block orders, a visible flag inside enemy rows, capability
features — so they get their own module rather than flag soup.

Deliberately unsupported (the reference wrappers construct with them
off, `SMACv2_modified.py` / our `smacv2_env.py`: conic_fov=False):
  * conic_fov (cone visibility + fov own-features / look actions),
  * obs_last_action in the STATE rows — the reference body writes it
    but `get_ally_num_attributes` never reserves space, so executing
    it raises a broadcast error (latent reference bug); we reject it.

Pure functions over a `V2Snapshot` of plain arrays — unit-testable
without SC2; `snapshot_from_smacv2` / `config_from_smacv2` adapt a live
engine (pip smacv2 or the reference vendored one — the executed-
reference goldens in tests/test_smacv2_reference_golden.py drive the
latter on a stub).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class V2Config:
    n_agents: int
    n_enemies: int
    n_actions: int
    map_x: float
    map_y: float
    max_distance_x: float
    max_distance_y: float
    map_type: str = "terran_gen"
    unit_type_bits: int = 3
    shield_bits_ally: int = 0
    shield_bits_enemy: int = 0
    obs_all_health: bool = True
    obs_own_health: bool = True
    obs_own_pos: bool = True
    obs_last_action: bool = False      # smacv2 default (obs path only)
    obs_timestep_number: bool = False
    state_agent_id: bool = True
    state_timestep_number: bool = False
    # capability flags (starcraft2.py:250-262)
    stochastic_attack: bool = False
    observe_attack_probs: bool = False
    zero_pad_stochastic_attack: bool = False
    stochastic_health: bool = False
    observe_teammate_health: bool = False
    zero_pad_health: bool = False
    replace_teammates: bool = True     # team_gen in capability_config
    observe_teammate_types: bool = True
    zero_pad_unit_types: bool = False
    mask_enemies: bool = False
    episode_limit: int = 400
    n_actions_move: int = 4
    n_actions_no_attack: int = 6


@dataclass
class V2Snapshot:
    """Plain-array view of one engine step (allies [M], enemies [E])."""
    ally_x: np.ndarray
    ally_y: np.ndarray
    ally_health: np.ndarray
    ally_health_max: np.ndarray
    ally_shield: np.ndarray
    ally_shield_max: np.ndarray
    ally_type: np.ndarray            # type ids ∈ [0, unit_type_bits)
    ally_cooldown: np.ndarray        # energy for medivacs (MMM/terran_gen)
    ally_max_cooldown: np.ndarray
    enemy_x: np.ndarray
    enemy_y: np.ndarray
    enemy_health: np.ndarray
    enemy_health_max: np.ndarray
    enemy_shield: np.ndarray
    enemy_shield_max: np.ndarray
    enemy_type: np.ndarray
    sight_range: np.ndarray          # [M] (use_unit_ranges per-type map)
    avail_actions: np.ndarray        # [M, n_actions]
    last_actions: np.ndarray         # [M, n_actions] one-hot
    attack_probs: np.ndarray         # [M] (stochastic_attack)
    health_levels: np.ndarray        # [M] (stochastic_health)
    enemy_mask: np.ndarray           # [M, E] bool (mask_enemies)
    episode_steps: int = 0


# ---- feature sizes (starcraft2.py:2109-2190, 1997-2004) --------------

def _cap_size(cfg: V2Config) -> int:
    """Own capability block (`get_cap_size`, :2178-2188)."""
    n = 0
    if cfg.stochastic_attack:
        n += 1
    if cfg.stochastic_health:
        n += 1
    return n + cfg.unit_type_bits


def _obs_ally_cap_size(cfg: V2Config) -> int:
    """`get_obs_ally_capability_size` (:2164-2176)."""
    n = cfg.unit_type_bits
    if cfg.stochastic_attack and (cfg.zero_pad_stochastic_attack
                                  or cfg.observe_attack_probs):
        n += 1
    if cfg.stochastic_health and (cfg.observe_teammate_health
                                  or cfg.zero_pad_health):
        n += 1
    return n


def _nf_en_obs(cfg: V2Config) -> int:
    nf = 4 + cfg.unit_type_bits
    if cfg.obs_all_health:
        nf += 1 + cfg.shield_bits_enemy
    return nf


def _nf_al_obs(cfg: V2Config) -> int:
    nf = 4 + _obs_ally_cap_size(cfg)
    if cfg.obs_all_health:
        nf += 1 + cfg.shield_bits_ally
    if cfg.obs_last_action:
        nf += cfg.n_actions
    return nf


def _nf_own_obs(cfg: V2Config) -> int:
    nf = _cap_size(cfg)
    if cfg.obs_own_health:
        nf += 1 + cfg.shield_bits_ally
    if cfg.obs_own_pos:
        nf += 2
    return nf


def obs_dim(cfg: V2Config) -> int:
    d = (cfg.n_actions_move + cfg.n_enemies * _nf_en_obs(cfg)
         + (cfg.n_agents - 1) * _nf_al_obs(cfg) + _nf_own_obs(cfg))
    if cfg.obs_timestep_number:
        d += 1
    return d


def _nf_al_state(cfg: V2Config) -> int:
    """`get_ally_num_attributes` = state attr names + capability names
    (:1997-2000, 333-370): 8 basics (+shield) + caps."""
    nf = 8 + cfg.shield_bits_ally
    if cfg.stochastic_attack:
        nf += 1
    if cfg.stochastic_health:
        nf += 1
    return nf + cfg.unit_type_bits


def _nf_en_state(cfg: V2Config) -> int:
    return 8 + cfg.shield_bits_enemy + cfg.unit_type_bits


def state_dim(cfg: V2Config) -> int:
    d = ((cfg.n_agents - 1) * _nf_al_state(cfg)
         + cfg.n_enemies * _nf_en_state(cfg)
         + cfg.n_actions_move + _nf_own_obs(cfg) + 2)
    if cfg.state_agent_id:
        d += cfg.n_agents
    if cfg.state_timestep_number:
        d += 1
    return d


def _compute_health(prop_health: float, level: float) -> float:
    """Health-level rescale (`_compute_health`, :1359-1379)."""
    return (1.0 / (1.0 - level)) * (prop_health - level)


def _own_feats(cfg: V2Config, snap: V2Snapshot, a: int,
               with_center: bool) -> np.ndarray:
    """Own block shared by obs and state (state adds center after
    health, :1883-1905 vs :1634-1662)."""
    own = np.zeros(_nf_own_obs(cfg) + (2 if with_center else 0), np.float32)
    x, y = snap.ally_x[a], snap.ally_y[a]
    cx, cy = cfg.map_x / 2.0, cfg.map_y / 2.0
    ind = 0
    if cfg.obs_own_health:
        ph = snap.ally_health[a] / max(snap.ally_health_max[a], 1e-8)
        own[ind] = _compute_health(ph, snap.health_levels[a]) \
            if cfg.stochastic_health else ph
        ind += 1
        if cfg.shield_bits_ally > 0:
            own[ind] = snap.ally_shield[a] / snap.ally_shield_max[a]
            ind += 1
    if with_center:
        own[ind] = (x - cx) / cfg.max_distance_x
        own[ind + 1] = (y - cy) / cfg.max_distance_y
        ind += 2
    if cfg.stochastic_attack:
        own[ind] = snap.attack_probs[a]
        ind += 1
    if cfg.stochastic_health:
        own[ind] = snap.health_levels[a]
        ind += 1
    if cfg.obs_own_pos:
        own[ind] = x / cfg.map_x
        own[ind + 1] = y / cfg.map_y
        ind += 2
    if cfg.unit_type_bits > 0:
        own[ind + int(snap.ally_type[a])] = 1.0
    return own


def _ally_caps(cfg, snap, feats, row, ind, al):
    """Capability tail of an ally row (obs :1611-1632 == state
    :1855-1881): attack prob, health level, teammate type bits."""
    if cfg.stochastic_attack and cfg.observe_attack_probs:
        feats[row, ind] = snap.attack_probs[al]
        ind += 1
    elif cfg.stochastic_attack and cfg.zero_pad_stochastic_attack:
        ind += 1
    if cfg.stochastic_health and cfg.observe_teammate_health:
        feats[row, ind] = snap.health_levels[al]
        ind += 1
    elif cfg.stochastic_health and cfg.zero_pad_health:
        ind += 1
    if cfg.unit_type_bits > 0 and (not cfg.replace_teammates
                                   or cfg.observe_teammate_types):
        feats[row, ind + int(snap.ally_type[al])] = 1.0
        ind += cfg.unit_type_bits
    elif cfg.unit_type_bits > 0 and cfg.zero_pad_unit_types:
        ind += cfg.unit_type_bits
    return ind


def agent_obs(cfg: V2Config, snap: V2Snapshot, agent_id: int) -> np.ndarray:
    """`get_obs_agent` (:1451-1690), concat [move|enemy|ally|own]."""
    M, E = cfg.n_agents, cfg.n_enemies
    move = np.zeros(cfg.n_actions_move, np.float32)
    enemy = np.zeros((E, _nf_en_obs(cfg)), np.float32)
    ally = np.zeros((M - 1, _nf_al_obs(cfg)), np.float32)
    own = np.zeros(_nf_own_obs(cfg), np.float32)

    if snap.ally_health[agent_id] > 0:
        x, y = snap.ally_x[agent_id], snap.ally_y[agent_id]
        sight = float(snap.sight_range[agent_id])
        avail = snap.avail_actions[agent_id]
        move[:] = avail[2:2 + cfg.n_actions_move]

        for e in range(E):
            ex, ey = snap.enemy_x[e], snap.enemy_y[e]
            dist = float(np.hypot(ex - x, ey - y))
            if dist < sight and snap.enemy_health[e] > 0:
                enemy[e, 0] = avail[cfg.n_actions_no_attack + e]
                enemy[e, 1] = dist / sight
                enemy[e, 2] = (ex - x) / sight
                enemy[e, 3] = (ey - y) / sight
                show = (not cfg.mask_enemies) or \
                    (not snap.enemy_mask[agent_id][e])
                ind = 4
                if cfg.obs_all_health and show:
                    enemy[e, ind] = (snap.enemy_health[e]
                                     / snap.enemy_health_max[e])
                    ind += 1
                    if cfg.shield_bits_enemy > 0:
                        enemy[e, ind] = (snap.enemy_shield[e]
                                         / snap.enemy_shield_max[e])
                        ind += 1
                if cfg.unit_type_bits > 0 and show:
                    enemy[e, ind + int(snap.enemy_type[e])] = 1.0

        al_ids = [i for i in range(M) if i != agent_id]
        for row, al in enumerate(al_ids):
            ax, ay = snap.ally_x[al], snap.ally_y[al]
            dist = float(np.hypot(ax - x, ay - y))
            if dist < sight and snap.ally_health[al] > 0:
                ally[row, 0] = 1.0
                ally[row, 1] = dist / sight
                ally[row, 2] = (ax - x) / sight
                ally[row, 3] = (ay - y) / sight
                ind = 4
                if cfg.obs_all_health:
                    ph = (snap.ally_health[al]
                          / max(snap.ally_health_max[al], 1e-8))
                    if not cfg.stochastic_health:
                        ally[row, ind] = ph
                        ind += 1
                    elif cfg.observe_teammate_health:
                        ally[row, ind] = _compute_health(
                            ph, snap.health_levels[al])
                        ind += 1
                    elif cfg.zero_pad_health:
                        ind += 1
                    if cfg.shield_bits_ally > 0:
                        ally[row, ind] = (snap.ally_shield[al]
                                          / snap.ally_shield_max[al])
                        ind += 1
                ind = _ally_caps(cfg, snap, ally, row, ind, al)
                if cfg.obs_last_action:
                    ally[row, ind:] = snap.last_actions[al]

        own[:] = _own_feats(cfg, snap, agent_id, with_center=False)

    out = np.concatenate([move, enemy.ravel(), ally.ravel(), own])
    if cfg.obs_timestep_number:
        out = np.append(out, snap.episode_steps / cfg.episode_limit)
    return out.astype(np.float32)


def agent_state(cfg: V2Config, snap: V2Snapshot, agent_id: int) -> np.ndarray:
    """`get_state_agent` (:1696-1934), concat [ally|enemy|move|own|id]."""
    if cfg.obs_last_action:
        raise ValueError(
            "obs_last_action in the v2 STATE rows is a latent reference "
            "bug (get_ally_num_attributes reserves no space); rejected")
    M, E = cfg.n_agents, cfg.n_enemies
    move = np.zeros(cfg.n_actions_move, np.float32)
    enemy = np.zeros((E, _nf_en_state(cfg)), np.float32)
    ally = np.zeros((M - 1, _nf_al_state(cfg)), np.float32)
    own = np.zeros(_nf_own_obs(cfg) + 2, np.float32)
    cx, cy = cfg.map_x / 2.0, cfg.map_y / 2.0

    if snap.ally_health[agent_id] > 0:
        x, y = snap.ally_x[agent_id], snap.ally_y[agent_id]
        sight = float(snap.sight_range[agent_id])
        avail = snap.avail_actions[agent_id]
        move[:] = avail[2:2 + cfg.n_actions_move]

        for e in range(E):
            if snap.enemy_health[e] <= 0:
                continue
            ex, ey = snap.enemy_x[e], snap.enemy_y[e]
            dist = float(np.hypot(ex - x, ey - y))
            enemy[e, 0] = avail[cfg.n_actions_no_attack + e]
            enemy[e, 1] = dist / sight
            enemy[e, 2] = (ex - x) / sight
            enemy[e, 3] = (ey - y) / sight
            enemy[e, 4] = 1.0 if dist < sight else 0.0
            show = (not cfg.mask_enemies) or \
                (not snap.enemy_mask[agent_id][e])
            ind = 5
            enemy[e, ind] = (ex - cx) / cfg.max_distance_x
            enemy[e, ind + 1] = (ey - cy) / cfg.max_distance_y
            ind += 2
            if cfg.obs_all_health and show:
                enemy[e, ind] = (snap.enemy_health[e]
                                 / snap.enemy_health_max[e])
                ind += 1
                if cfg.shield_bits_enemy > 0:
                    enemy[e, ind] = (snap.enemy_shield[e]
                                     / snap.enemy_shield_max[e])
                    ind += 1
            if cfg.unit_type_bits > 0 and show:
                enemy[e, ind + int(snap.enemy_type[e])] = 1.0

        al_ids = [i for i in range(M) if i != agent_id]
        for row, al in enumerate(al_ids):
            if snap.ally_health[al] <= 0:
                continue
            ax, ay = snap.ally_x[al], snap.ally_y[al]
            dist = float(np.hypot(ax - x, ay - y))
            ally[row, 0] = 1.0 if dist < sight else 0.0
            ally[row, 1] = dist / sight
            ally[row, 2] = (ax - x) / sight
            ally[row, 3] = (ay - y) / sight
            ally[row, 4] = (snap.ally_cooldown[al]
                            / max(snap.ally_max_cooldown[al], 1e-8))
            ind = 5
            ally[row, ind] = (ax - cx) / cfg.max_distance_x
            ally[row, ind + 1] = (ay - cy) / cfg.max_distance_y
            ind += 2
            if cfg.obs_all_health:
                ph = (snap.ally_health[al]
                      / max(snap.ally_health_max[al], 1e-8))
                if not cfg.stochastic_health:
                    ally[row, ind] = ph
                    ind += 1
                elif cfg.observe_teammate_health:
                    ally[row, ind] = _compute_health(
                        ph, snap.health_levels[al])
                    ind += 1
                elif cfg.zero_pad_health:
                    ind += 1
                if cfg.shield_bits_ally > 0:
                    ally[row, ind] = (snap.ally_shield[al]
                                      / snap.ally_shield_max[al])
                    ind += 1
            _ally_caps(cfg, snap, ally, row, ind, al)

        own[:] = _own_feats(cfg, snap, agent_id, with_center=True)

    state = np.concatenate([ally.ravel(), enemy.ravel(), move, own])
    if cfg.state_agent_id:
        one_hot = np.zeros(M, np.float32)
        one_hot[agent_id] = 1.0
        state = np.concatenate([state, one_hot])
    if cfg.state_timestep_number:
        state = np.append(state, snap.episode_steps / cfg.episode_limit)
    return state.astype(np.float32)


def all_agent_states(cfg: V2Config, snap: V2Snapshot) -> np.ndarray:
    return np.stack([agent_state(cfg, snap, i)
                     for i in range(cfg.n_agents)])


# ---- live-engine adapters --------------------------------------------

def config_from_smacv2(env) -> V2Config:
    # fail loudly on engine features the builders do not model — with
    # them enabled obs/state would silently diverge or dim-mismatch
    # (state obs_last_action is rejected separately below)
    unsupported = [f for f in ("conic_fov", "fully_observable",
                               "obs_pathing_grid", "obs_terrain_height")
                   if getattr(env, f, False)]
    if unsupported:
        raise ValueError(
            f"v2_builders do not model engine feature(s) {unsupported}; "
            "disable them or extend the builders")
    return V2Config(
        n_agents=env.n_agents, n_enemies=env.n_enemies,
        n_actions=env.n_actions, map_x=env.map_x, map_y=env.map_y,
        max_distance_x=getattr(env, "max_distance_x", env.map_x),
        max_distance_y=getattr(env, "max_distance_y", env.map_y),
        map_type=env.map_type, unit_type_bits=env.unit_type_bits,
        shield_bits_ally=env.shield_bits_ally,
        shield_bits_enemy=env.shield_bits_enemy,
        obs_all_health=env.obs_all_health,
        obs_own_health=env.obs_own_health,
        obs_own_pos=getattr(env, "obs_own_pos", False),
        obs_last_action=env.obs_last_action,
        obs_timestep_number=env.obs_timestep_number,
        state_agent_id=getattr(env, "state_agent_id", True),
        state_timestep_number=env.state_timestep_number,
        stochastic_attack=getattr(env, "stochastic_attack", False),
        observe_attack_probs=getattr(env, "observe_attack_probs", False),
        zero_pad_stochastic_attack=getattr(
            env, "zero_pad_stochastic_attack", False),
        stochastic_health=getattr(env, "stochastic_health", False),
        observe_teammate_health=getattr(
            env, "observe_teammate_health", False),
        zero_pad_health=getattr(env, "zero_pad_health", False),
        replace_teammates=getattr(env, "replace_teammates", False),
        observe_teammate_types=getattr(
            env, "observe_teammate_types", True),
        zero_pad_unit_types=getattr(env, "zero_pad_unit_types", False),
        mask_enemies=getattr(env, "mask_enemies", False),
        episode_limit=env.episode_limit)


def snapshot_from_smacv2(env) -> V2Snapshot:
    M, E = env.n_agents, env.n_enemies
    z = lambda n: np.zeros(n, np.float32)
    shield_al = env.shield_bits_ally > 0
    shield_en = env.shield_bits_enemy > 0
    s = V2Snapshot(
        ally_x=z(M), ally_y=z(M), ally_health=z(M), ally_health_max=z(M),
        ally_shield=z(M), ally_shield_max=np.ones(M, np.float32),
        ally_type=np.zeros(M, np.int32), ally_cooldown=z(M),
        ally_max_cooldown=z(M),
        enemy_x=z(E), enemy_y=z(E), enemy_health=z(E), enemy_health_max=z(E),
        enemy_shield=z(E), enemy_shield_max=np.ones(E, np.float32),
        enemy_type=np.zeros(E, np.int32),
        sight_range=np.array([env.unit_sight_range(i) for i in range(M)],
                             np.float32),
        avail_actions=np.asarray(env.get_avail_actions(), np.float32),
        last_actions=np.asarray(env.last_action, np.float32),
        attack_probs=np.asarray(
            getattr(env, "agent_attack_probabilities", np.zeros(M)),
            np.float32),
        health_levels=np.asarray(
            getattr(env, "agent_health_levels", np.zeros(M)), np.float32),
        enemy_mask=np.asarray(
            getattr(env, "enemy_mask", np.zeros((M, E))), bool),
        episode_steps=getattr(env, "_episode_steps", 0),
    )
    for i in range(M):
        u = env.get_unit_by_id(i)
        s.ally_x[i], s.ally_y[i] = u.pos.x, u.pos.y
        s.ally_health[i], s.ally_health_max[i] = u.health, u.health_max
        if shield_al:
            s.ally_shield[i] = u.shield
            s.ally_shield_max[i] = env.unit_max_shield(u)
        if env.unit_type_bits > 0:
            s.ally_type[i] = env.get_unit_type_id(u, True)
        is_medivac = (env.map_type in ("MMM", "terran_gen")
                      and u.unit_type == getattr(env, "medivac_id", -1))
        s.ally_cooldown[i] = u.energy if is_medivac else u.weapon_cooldown
        s.ally_max_cooldown[i] = env.unit_max_cooldown(u)
    for e, u in env.enemies.items():
        s.enemy_x[e], s.enemy_y[e] = u.pos.x, u.pos.y
        s.enemy_health[e], s.enemy_health_max[e] = u.health, u.health_max
        if shield_en:
            s.enemy_shield[e] = u.shield
            s.enemy_shield_max[e] = env.unit_max_shield(u)
        if env.unit_type_bits > 0:
            s.enemy_type[e] = env.get_unit_type_id(u, False)
    return s
