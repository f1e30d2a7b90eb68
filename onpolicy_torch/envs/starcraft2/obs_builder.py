"""SMAC per-agent observation builder (reference `get_obs_agent`).

The port's own copy of `onpolicy_tpu/envs/starcraft2/obs_builder.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

Faithful re-derivation of the reference's vendored observation path
(the reference's `onpolicy/envs/starcraft2/StarCraft2_Env.py:978-1142`,
feature sizes `:1522-1612`) over the same `Snapshot` arrays used by
`state_builder`. The reference CONSTRUCTION DEFAULTS differ from the
public `smac` package (`StarCraft2_Env.py:77-84`): `obs_last_action=True`
and `obs_agent_id=True` — so delegating observations to pip smac's
`get_obs()` would produce a different (smaller) feature vector. Building
observations here pins the reference contract without SC2.

Layout per agent (concatenated, `:1117-1131`):

    ally_feats   [(M-1) × (4 [+1+shield_bits_ally if obs_all_health]
                          [+unit_type_bits] [+n_actions if obs_last_action])]
    enemy_feats  [E × (4 [+1+shield_bits_enemy if obs_all_health]
                          [+unit_type_bits])]
    move_feats   [n_actions_move]            (pathing/terrain unsupported)
    own_feats    [4 [+1+shield_bits_ally if obs_own_health]
                    [+unit_type_bits] [+n_actions if obs_last_action]]
    agent_id     [M]                          (if obs_agent_id)
    timestep     [1]                          (if obs_timestep_number)

Dead agents observe all-zeros EXCEPT the agent-id one-hot and timestep,
which the reference sets unconditionally (`:1120-1138`).
"""
from __future__ import annotations

import math

import numpy as np

from onpolicy_torch.envs.starcraft2.state_builder import Snapshot, StateConfig


def _nf_ally_obs(cfg: StateConfig) -> int:
    nf = 4 + cfg.unit_type_bits
    if cfg.obs_all_health:
        nf += 1 + cfg.shield_bits_ally
    if cfg.obs_last_action:
        nf += cfg.n_actions
    return nf


def _nf_enemy_obs(cfg: StateConfig) -> int:
    nf = 4 + cfg.unit_type_bits
    if cfg.obs_all_health:
        nf += 1 + cfg.shield_bits_enemy
    return nf


def _nf_own_obs(cfg: StateConfig) -> int:
    nf = 4 + cfg.unit_type_bits
    if cfg.obs_own_health:
        nf += 1 + cfg.shield_bits_ally
    if cfg.obs_last_action:
        nf += cfg.n_actions
    return nf


def obs_dim(cfg: StateConfig) -> int:
    d = ((cfg.n_agents - 1) * _nf_ally_obs(cfg)
         + cfg.n_enemies * _nf_enemy_obs(cfg)
         + cfg.n_actions_move + _nf_own_obs(cfg))
    if cfg.obs_agent_id:
        d += cfg.n_agents
    if cfg.obs_timestep_number:
        d += 1
    return d


def agent_obs(cfg: StateConfig, snap: Snapshot, agent_id: int) -> np.ndarray:
    M, E = cfg.n_agents, cfg.n_enemies
    move_feats = np.zeros(cfg.n_actions_move, np.float32)
    enemy_feats = np.zeros((E, _nf_enemy_obs(cfg)), np.float32)
    ally_feats = np.zeros((M - 1, _nf_ally_obs(cfg)), np.float32)
    own_feats = np.zeros(_nf_own_obs(cfg), np.float32)

    if snap.ally_health[agent_id] > 0:           # dead → all zeros
        x, y = snap.ally_x[agent_id], snap.ally_y[agent_id]
        sr = snap.sight_range[agent_id]
        avail = snap.avail_actions[agent_id]

        move_feats[:] = avail[2:2 + cfg.n_actions_move]

        for e in range(E):
            dist = math.hypot(snap.enemy_x[e] - x, snap.enemy_y[e] - y)
            if dist < sr and snap.enemy_health[e] > 0:
                enemy_feats[e, 0] = avail[cfg.n_actions_no_attack + e]
                enemy_feats[e, 1] = dist / sr
                enemy_feats[e, 2] = (snap.enemy_x[e] - x) / sr
                enemy_feats[e, 3] = (snap.enemy_y[e] - y) / sr
                ind = 4
                if cfg.obs_all_health:
                    enemy_feats[e, ind] = (snap.enemy_health[e]
                                           / snap.enemy_health_max[e])
                    ind += 1
                    if cfg.shield_bits_enemy > 0:
                        enemy_feats[e, ind] = (snap.enemy_shield[e]
                                               / snap.enemy_shield_max[e])
                        ind += 1
                if cfg.unit_type_bits > 0:
                    enemy_feats[e, ind + int(snap.enemy_type[e])] = 1

        for i, al in enumerate(a for a in range(M) if a != agent_id):
            dist = math.hypot(snap.ally_x[al] - x, snap.ally_y[al] - y)
            if dist < sr and snap.ally_health[al] > 0:
                ally_feats[i, 0] = 1
                ally_feats[i, 1] = dist / sr
                ally_feats[i, 2] = (snap.ally_x[al] - x) / sr
                ally_feats[i, 3] = (snap.ally_y[al] - y) / sr
                ind = 4
                if cfg.obs_all_health:
                    ally_feats[i, ind] = (snap.ally_health[al]
                                          / snap.ally_health_max[al])
                    ind += 1
                    if cfg.shield_bits_ally > 0:
                        ally_feats[i, ind] = (snap.ally_shield[al]
                                              / snap.ally_shield_max[al])
                        ind += 1
                if cfg.unit_type_bits > 0:
                    ally_feats[i, ind + int(snap.ally_type[al])] = 1
                    ind += cfg.unit_type_bits
                if cfg.obs_last_action:
                    ally_feats[i, ind:] = snap.last_actions[al]

        own_feats[0] = 1                          # visible; dist/x/y = 0
        ind = 4
        if cfg.obs_own_health:
            own_feats[ind] = (snap.ally_health[agent_id]
                              / snap.ally_health_max[agent_id])
            ind += 1
            if cfg.shield_bits_ally > 0:
                own_feats[ind] = (snap.ally_shield[agent_id]
                                  / snap.ally_shield_max[agent_id])
                ind += 1
        if cfg.unit_type_bits > 0:
            own_feats[ind + int(snap.ally_type[agent_id])] = 1
            ind += cfg.unit_type_bits
        if cfg.obs_last_action:
            own_feats[ind:] = snap.last_actions[agent_id]

    parts = [ally_feats.flatten(), enemy_feats.flatten(), move_feats,
             own_feats]
    if cfg.obs_agent_id:
        agent_id_feats = np.zeros(M, np.float32)
        agent_id_feats[agent_id] = 1.0            # set even when dead
        parts.append(agent_id_feats)
    out = np.concatenate(parts)
    if cfg.obs_timestep_number:
        out = np.append(out, np.float32(snap.episode_steps
                                        / cfg.episode_limit))
    return out.astype(np.float32)


def all_obs(cfg: StateConfig, snap: Snapshot) -> np.ndarray:
    return np.stack([agent_obs(cfg, snap, i) for i in range(cfg.n_agents)])
