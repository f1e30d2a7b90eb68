"""SMAC map registry: per-map agent/enemy counts, episode limits, races,
and unit-type bits.

The port's own copy of `onpolicy_tpu/envs/starcraft2/smac_maps.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_smac.py.

Data parity with the reference's map_param_registry
(the reference's `onpolicy/envs/starcraft2/smac_maps.py:16-458`, itself
from oxwhirl/smac). The table is game data (map → sizes/limits), used by
the train entry to infer num_agents and by the env adapter for episode
limits.
"""
from __future__ import annotations

MAP_REGISTRY = {
    # name: (n_agents, n_enemies, limit, a_race, b_race, unit_type_bits, map_type)
    "3m": (3, 3, 60, "T", "T", 0, "marines"),
    "8m": (8, 8, 120, "T", "T", 0, "marines"),
    "25m": (25, 25, 150, "T", "T", 0, "marines"),
    "5m_vs_6m": (5, 6, 70, "T", "T", 0, "marines"),
    "8m_vs_9m": (8, 9, 120, "T", "T", 0, "marines"),
    "10m_vs_11m": (10, 11, 150, "T", "T", 0, "marines"),
    "27m_vs_30m": (27, 30, 180, "T", "T", 0, "marines"),
    "MMM": (10, 10, 150, "T", "T", 3, "MMM"),
    "MMM2": (10, 12, 180, "T", "T", 3, "MMM"),
    "2s3z": (5, 5, 120, "P", "P", 2, "stalkers_and_zealots"),
    "3s5z": (8, 8, 150, "P", "P", 2, "stalkers_and_zealots"),
    "3s5z_vs_3s6z": (8, 9, 170, "P", "P", 2, "stalkers_and_zealots"),
    "3s_vs_3z": (3, 3, 150, "P", "P", 0, "stalkers"),
    "3s_vs_4z": (3, 4, 200, "P", "P", 0, "stalkers"),
    "3s_vs_5z": (3, 5, 250, "P", "P", 0, "stalkers"),
    "1c3s5z": (9, 9, 180, "P", "P", 3, "colossi_stalkers_zealots"),
    "2m_vs_1z": (2, 1, 150, "T", "P", 0, "marines"),
    "corridor": (6, 24, 400, "P", "Z", 0, "zealots"),
    "6h_vs_8z": (6, 8, 150, "Z", "P", 0, "hydralisks"),
    "2s_vs_1sc": (2, 1, 300, "P", "Z", 0, "stalkers"),
    "so_many_baneling": (7, 32, 100, "P", "Z", 0, "zealots"),
    "bane_vs_bane": (24, 24, 200, "Z", "Z", 2, "bane"),
    "2c_vs_64zg": (2, 64, 400, "P", "Z", 0, "colossus"),
    "1o_10b_vs_1r": (11, 1, 300, "Z", "Z", 2, "overload_bane"),
    "1o_2r_vs_4r": (3, 4, 300, "Z", "Z", 2, "overload_roach"),
    "bane_vs_hM": (3, 2, 30, "Z", "T", 2, "bZ_hM"),
    "1c1s1z_vs_1c1s1z": (3, 3, 180, "P", "P", 3, "colossi_stalkers_zealots"),
    "1c2s_vs_1c1s1z": (3, 3, 180, "P", "P", 3, "colossi_stalkers_zealots"),
    "1c2z_vs_1c1s1z": (3, 3, 180, "P", "P", 3, "colossi_stalkers_zealots"),
    "1s3z_vs_zg": (4, 20, 200, "P", "Z", 2, "stalkers_and_zealots_vs_zergling"),
    "1s3z_vs_zg_easy": (4, 18, 200, "P", "Z", 2, "stalkers_and_zealots_vs_zergling"),
    "28m_vs_30m": (28, 30, 180, "T", "T", 0, "marines"),
    "29m_vs_30m": (29, 30, 180, "T", "T", 0, "marines"),
    "2c1s_vs_1c1s1z": (3, 3, 180, "P", "P", 3, "colossi_stalkers_zealots"),
    "2c1z_vs_1c1s1z": (3, 3, 180, "P", "P", 3, "colossi_stalkers_zealots"),
    "2s2z_vs_zg": (4, 20, 200, "P", "Z", 2, "stalkers_and_zealots_vs_zergling"),
    "2s2z_vs_zg_easy": (4, 18, 200, "P", "Z", 2, "stalkers_and_zealots_vs_zergling"),
    "2s6z_vs_4s4z": (8, 8, 150, "P", "P", 2, "stalkers_and_zealots"),
    "30m_vs_30m": (30, 30, 180, "T", "T", 0, "marines"),
    "3s1z_vs_zg": (4, 20, 200, "P", "Z", 2, "stalkers_and_zealots_vs_zergling"),
    "3s1z_vs_zg_easy": (4, 18, 200, "P", "Z", 2, "stalkers_and_zealots_vs_zergling"),
    "3s5z_vs_4s4z": (8, 8, 150, "P", "P", 2, "stalkers_and_zealots"),
    "3s6z_vs_3s6z": (9, 9, 170, "P", "P", 2, "stalkers_and_zealots"),
    "4s4z_vs_4s4z": (8, 8, 150, "P", "P", 2, "stalkers_and_zealots"),
    "5m_vs_6m_tz": (5, 6, 70, "T", "T", 0, "marines"),
    "5s3z_vs_4s4z": (8, 8, 150, "P", "P", 2, "stalkers_and_zealots"),
    "6m_vs_6m_tz": (6, 6, 70, "T", "T", 0, "marines"),
    "6s2z_vs_4s4z": (8, 8, 150, "P", "P", 2, "stalkers_and_zealots"),
    "7h_vs_8z": (7, 8, 150, "Z", "P", 0, "hydralisks"),
    "MMM2_test": (10, 12, 180, "T", "T", 3, "MMM"),
}


def get_map_params(map_name: str) -> dict:
    if map_name not in MAP_REGISTRY:
        raise KeyError(f"unknown SMAC map {map_name!r}; "
                       f"known: {sorted(MAP_REGISTRY)}")
    n_agents, n_enemies, limit, a_race, b_race, utb, mt = \
        MAP_REGISTRY[map_name]
    return {"n_agents": n_agents, "n_enemies": n_enemies, "limit": limit,
            "a_race": a_race, "b_race": b_race, "unit_type_bits": utb,
            "map_type": mt}
