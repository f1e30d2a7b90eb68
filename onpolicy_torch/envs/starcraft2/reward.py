"""Pure re-derivation of the SMAC shaped reward + step bookkeeping.

The port's own copy of `onpolicy_tpu/envs/starcraft2/reward.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

The adapter (`smac_env.py`) delegates stepping to the pip `smac`
engine; these pure functions are the repo's EXECUTABLE SPEC of the
semantics it relies on, pinned array-for-array against the EXECUTED
reference methods in tests/test_smac_reward_golden.py:

  * `reward_battle` — delta-hit/shield-point damage + death bonuses
    (the reference's `onpolicy/envs/starcraft2/StarCraft2_Env.py:809-864`),
    including the reference's `abs()` quirk under `reward_only_positive`
    (shield regeneration can make the delta negative; the reference
    takes the absolute value rather than clamping).
  * `step_bookkeeping` — terminated/bad_transition/win accounting and
    final reward scaling of the step function (`:544-594`):
    win → +reward_win once (`win_counted`), defeat → +reward_defeat
    once, episode-limit truncation → `bad_transition` + timeout count,
    per-agent dones from the ally death tracker, and
    `reward /= max_reward / reward_scale_rate` (`:593-594`).

Everything is stateless over unit-health snapshots so the spec can be
driven against randomized executed-reference trials without an SC2
binary.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def reward_battle(*,
                  prev_ally_health: np.ndarray,
                  prev_ally_shield: np.ndarray,
                  ally_health: np.ndarray,
                  ally_shield: np.ndarray,
                  dead_before_ally: np.ndarray,
                  prev_enemy_health: np.ndarray,
                  prev_enemy_shield: np.ndarray,
                  enemy_health: np.ndarray,
                  enemy_shield: np.ndarray,
                  dead_before_enemy: np.ndarray,
                  reward_only_positive: bool = True,
                  reward_death_value: float = 10.0,
                  reward_negative_scale: float = 0.5,
                  reward_sparse: bool = False) -> float:
    """Shaped battle reward over (previous, current) unit snapshots.

    `dead_before_*` are the death trackers BEFORE this step (units
    already dead contribute nothing). Matches `reward_battle`
    (`StarCraft2_Env.py:809-864`) exactly, including the
    `abs(delta_enemy + delta_deaths)` quirk under reward_only_positive.
    """
    if reward_sparse:
        return 0.0
    neg = reward_negative_scale
    alive_a = ~np.asarray(dead_before_ally, bool)
    alive_e = ~np.asarray(dead_before_enemy, bool)

    prev_a = np.asarray(prev_ally_health) + np.asarray(prev_ally_shield)
    died_a = alive_a & (np.asarray(ally_health) == 0)
    hurt_a = alive_a & (np.asarray(ally_health) != 0)
    delta_ally = float(
        np.sum(prev_a[died_a]) * neg
        + np.sum(neg * (prev_a - ally_health - ally_shield)[hurt_a]))
    delta_deaths = 0.0
    if not reward_only_positive:
        delta_deaths -= reward_death_value * neg * int(np.sum(died_a))

    prev_e = np.asarray(prev_enemy_health) + np.asarray(prev_enemy_shield)
    died_e = alive_e & (np.asarray(enemy_health) == 0)
    hurt_e = alive_e & (np.asarray(enemy_health) != 0)
    delta_deaths += reward_death_value * int(np.sum(died_e))
    delta_enemy = float(
        np.sum(prev_e[died_e])
        + np.sum((prev_e - enemy_health - enemy_shield)[hurt_e]))

    if reward_only_positive:
        return abs(delta_enemy + delta_deaths)
    return delta_enemy + delta_deaths - delta_ally


def step_bookkeeping(*,
                     game_end_code: Optional[int],
                     episode_steps: int,
                     episode_limit: int,
                     reward: float,
                     death_tracker_ally: np.ndarray,
                     reward_win: float = 200.0,
                     reward_defeat: float = 0.0,
                     reward_sparse: bool = False,
                     win_counted: bool = False,
                     defeat_counted: bool = False,
                     reward_scale: bool = True,
                     max_reward: float = 1.0,
                     reward_scale_rate: float = 20.0) -> dict:
    """Post-`update_units` accounting of one step (`:544-615`).

    Returns the scaled step reward, termination/truncation flags,
    per-agent dones, and the counter increments the infos expose
    (`battles_won/battles_game/battles_draw`)."""
    terminated = False
    bad_transition = False
    battles_game_inc = battles_won_inc = timeouts_inc = 0
    won = win_counted
    if game_end_code is not None:
        terminated = True
        battles_game_inc = 1
        if game_end_code == 1 and not win_counted:
            battles_won_inc = 1
            won = True
            reward = 1.0 if reward_sparse else reward + reward_win
        elif game_end_code == -1 and not defeat_counted:
            reward = -1.0 if reward_sparse else reward + reward_defeat
    elif episode_steps >= episode_limit:
        terminated = True
        bad_transition = True
        battles_game_inc = 1
        timeouts_inc = 1
    dones = (np.ones_like(np.asarray(death_tracker_ally), bool)
             if terminated else np.asarray(death_tracker_ally, bool).copy())
    if reward_scale:
        reward = reward / (max_reward / reward_scale_rate)
    return {"reward": float(reward), "terminated": terminated,
            "bad_transition": bad_transition, "dones": dones, "won": won,
            "battles_game_inc": battles_game_inc,
            "battles_won_inc": battles_won_inc,
            "timeouts_inc": timeouts_inc}
