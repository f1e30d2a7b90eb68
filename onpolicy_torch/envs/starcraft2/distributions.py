"""SMACv2 capability distributions: per-episode team compositions and
start positions.

The port's own copy of `onpolicy_tpu/envs/starcraft2/distributions.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

Behavior parity with the vendored smacv2 generators
(the reference's `onpolicy/envs/starcraft2/StarCraft2v2/
distributions.py:11-359`), re-implemented with an explicit
`np.random.Generator` (seedable — the reference mixes `random` and
unseeded `default_rng`, making resets irreproducible; a footgun fixed).

Registry keys: fixed, all_teams, weighted_teams, per_agent_uniform,
mask, reflect_position, surrounded, surrounded_and_reflect.
`generate()` returns {env_key: {"item"/"ally_team"/…, "id": …}} dicts the
SMACv2 engine consumes as reset config.
"""
from __future__ import annotations

from itertools import combinations_with_replacement
from math import inf
from typing import Any, Dict

import numpy as np

DISTRIBUTION_MAP: Dict[str, type] = {}


def register_distribution(key, cls):
    DISTRIBUTION_MAP[key] = cls


def get_distribution(key):
    return DISTRIBUTION_MAP[key]


class Distribution:
    def __init__(self, config, rng=None):
        self.config = config
        self.rng = rng if rng is not None else np.random.default_rng()

    def generate(self) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def n_tasks(self):
        raise NotImplementedError


class FixedDistribution(Distribution):
    """Draw items from a fixed list — sequential in test mode, uniform in
    train mode; the drawn team is shuffled."""

    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.env_key = config["env_key"]
        self.test_mode = config["test_mode"]
        self.items = [list(x) for x in config["items"]]
        self.index = 0

    def generate(self):
        if self.test_mode:
            idx = self.index
            self.index = (self.index + 1) % len(self.items)
        else:
            idx = int(self.rng.integers(len(self.items)))
        team = list(self.items[idx])
        self.rng.shuffle(team)
        return {self.env_key: {"item": team, "id": idx}}

    @property
    def n_tasks(self):
        return len(self.items)


class AllTeamsDistribution(Distribution):
    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.units = config["unit_types"]
        self.n_units = config["n_units"]
        self.exceptions = set(config.get("exception_unit_types", []))
        self.env_key = config["env_key"]
        self.combinations = list(
            combinations_with_replacement(self.units, self.n_units))

    def generate(self):
        team = []
        while not team or all(m in self.exceptions for m in team):
            idx = int(self.rng.integers(len(self.combinations)))
            team = list(self.combinations[idx])
        self.rng.shuffle(team)
        return {self.env_key: {"ally_team": team, "enemy_team": list(team),
                               "id": idx}}

    @property
    def n_tasks(self):
        assert not self.exceptions
        return len(self.combinations)


class WeightedTeamsDistribution(Distribution):
    """Unit types drawn per slot with given weights; enemy team = ally
    team (+ extra weighted draws when n_enemies > n_units)."""

    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.units = np.array(config["unit_types"])
        self.n_units = config["n_units"]
        self.n_enemies = config["n_enemies"]
        assert self.n_enemies >= self.n_units
        self.weights = np.array(config["weights"], np.float64)
        self.exceptions = set(config.get("exception_unit_types", []))
        self.env_key = config["env_key"]

    def _gen_team(self, n, use_exceptions):
        team = []
        while not team or (use_exceptions
                           and all(m in self.exceptions for m in team)):
            team = list(self.rng.choice(self.units, size=n, p=self.weights))
            self.rng.shuffle(team)
        return team

    def generate(self):
        team = self._gen_team(self.n_units, True)
        enemy = list(team)
        if self.n_enemies > self.n_units:
            enemy += self._gen_team(self.n_enemies - self.n_units, True)
        return {self.env_key: {"ally_team": team, "enemy_team": enemy,
                               "id": 0}}

    @property
    def n_tasks(self):
        return inf


class PerAgentUniformDistribution(Distribution):
    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.lower = np.asarray(config["lower_bound"], np.float64)
        self.upper = np.asarray(config["upper_bound"], np.float64)
        self.env_key = config["env_key"]
        self.n_units = config["n_units"]

    def generate(self):
        probs = self.rng.uniform(self.lower, self.upper,
                                 size=(self.n_units, len(self.lower)))
        return {self.env_key: {"item": probs, "id": 0}}

    @property
    def n_tasks(self):
        return inf


class MaskDistribution(Distribution):
    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.p = config["mask_probability"]
        self.n_units = config["n_units"]
        self.n_enemies = config["n_enemies"]

    def generate(self):
        mask = self.rng.choice([0, 1], size=(self.n_units, self.n_enemies),
                               p=[self.p, 1.0 - self.p])
        return {"enemy_mask": {"item": mask, "id": 0}}

    @property
    def n_tasks(self):
        return inf


class ReflectPositionDistribution(Distribution):
    """Allies uniform on the left half (x ∈ [0, map_x/2 − 1]); enemies are
    the vertical-mirror reflection (+ uniform right-half extras)."""

    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.n_units = config["n_units"]
        self.n_enemies = config["n_enemies"]
        assert self.n_enemies >= self.n_units
        self.map_x = config["map_x"]
        self.map_y = config["map_y"]
        ally_cfg = dict(config, env_key="ally_start_positions",
                        lower_bound=(0, 0),
                        upper_bound=(self.map_x / 2 - 1, self.map_y))
        self.ally_gen = PerAgentUniformDistribution(ally_cfg, self.rng)
        if self.n_enemies > self.n_units:
            extra_cfg = dict(config, env_key="enemy_start_positions",
                             lower_bound=(self.map_x / 2, 0),
                             upper_bound=(self.map_x, self.map_y),
                             n_units=self.n_enemies - self.n_units)
            self.extra_gen = PerAgentUniformDistribution(extra_cfg, self.rng)

    def generate(self):
        ally = self.ally_gen.generate()["ally_start_positions"]["item"]
        enemy = np.zeros((self.n_enemies, 2))
        enemy[:self.n_units, 0] = self.map_x - ally[:, 0]
        enemy[:self.n_units, 1] = ally[:, 1]
        if self.n_enemies > self.n_units:
            enemy[self.n_units:] = \
                self.extra_gen.generate()["enemy_start_positions"]["item"]
        return {"ally_start_positions": {"item": ally, "id": 0},
                "enemy_start_positions": {"item": enemy, "id": 0}}

    @property
    def n_tasks(self):
        return inf


class SurroundedPositionDistribution(Distribution):
    """Allies at map centre; enemies in 1–4 groups along random diagonals
    at random distances toward the corners."""

    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.n_units = config["n_units"]
        self.n_enemies = config["n_enemies"]
        self.map_x = config["map_x"]
        self.map_y = config["map_y"]

    def generate(self):
        offset = 2
        cx, cy = self.map_x / 2, self.map_y / 2
        centre_near = {
            0: np.array([cx - offset, cy - offset]),
            1: np.array([cx - offset, cy + offset]),
            2: np.array([cx + offset, cy + offset]),
            3: np.array([cx + offset, cy - offset]),
        }
        corners = {0: np.array([0, 0]), 1: np.array([0, self.map_y]),
                   2: np.array([self.map_x, self.map_y]),
                   3: np.array([self.map_x, 0])}
        ally = np.tile(np.array([cx, cy]), (self.n_units, 1))
        enemy = np.zeros((self.n_enemies, 2))
        n_groups = int(self.rng.integers(1, 5))
        membership = self.rng.multinomial(self.n_enemies,
                                          np.ones(n_groups) / n_groups)
        t = self.rng.uniform(size=n_groups)
        diags = self.rng.choice(np.arange(4), size=n_groups, replace=False)
        idx = 0
        for g in range(n_groups):
            pos = centre_near[diags[g]] * t[g] + corners[diags[g]] * (1 - t[g])
            enemy[idx:idx + membership[g]] = pos
            idx += membership[g]
        return {"ally_start_positions": {"item": ally, "id": 0},
                "enemy_start_positions": {"item": enemy, "id": 0}}

    @property
    def n_tasks(self):
        return inf


class SurroundedAndReflectPositionDistribution(Distribution):
    """With prob p use the surrounded generator, else reflect
    (`distributions.py:330-359`)."""

    def __init__(self, config, rng=None):
        super().__init__(config, rng)
        self.p = config["p"]
        self.surrounded = SurroundedPositionDistribution(config, self.rng)
        self.reflect = ReflectPositionDistribution(config, self.rng)

    def generate(self):
        if self.rng.uniform() < self.p:
            return self.surrounded.generate()
        return self.reflect.generate()

    @property
    def n_tasks(self):
        return inf


for _key, _cls in [
    ("fixed", FixedDistribution),
    ("all_teams", AllTeamsDistribution),
    ("weighted_teams", WeightedTeamsDistribution),
    ("per_agent_uniform", PerAgentUniformDistribution),
    ("mask", MaskDistribution),
    ("reflect_position", ReflectPositionDistribution),
    ("surrounded", SurroundedPositionDistribution),
    ("surrounded_and_reflect", SurroundedAndReflectPositionDistribution),
]:
    register_distribution(_key, _cls)


def parse_smacv2_distribution(args) -> dict:
    """Capability-config builder for SMACv2 (parity with
    `scripts/train/train_smac.py` `parse_smacv2_distribution`): per-race
    unit-type weights + surrounded_and_reflect start positions."""
    units = args.units.split("v")  # e.g. "10v11"
    distribution_config = {
        "n_units": int(units[0]),
        "n_enemies": int(units[1]),
        "start_positions": {
            "dist_type": "surrounded_and_reflect",
            "p": 0.5,
            "map_x": 32,
            "map_y": 32,
        },
    }
    if "protoss" in args.map_name:
        distribution_config["team_gen"] = {
            "dist_type": "weighted_teams",
            "unit_types": ["stalker", "zealot", "colossus"],
            "weights": [0.45, 0.45, 0.1],
            "observe": True,
        }
    elif "zerg" in args.map_name:
        distribution_config["team_gen"] = {
            "dist_type": "weighted_teams",
            "unit_types": ["zergling", "baneling", "hydralisk"],
            "weights": [0.45, 0.1, 0.45],
            "observe": True,
        }
    elif "terran" in args.map_name:
        distribution_config["team_gen"] = {
            "dist_type": "weighted_teams",
            "unit_types": ["marine", "marauder", "medivac"],
            "weights": [0.45, 0.45, 0.1],
            "observe": True,
        }
    return distribution_config
