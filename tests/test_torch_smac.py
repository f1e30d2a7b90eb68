"""The port's SMAC / SMACv2 / GRF env side against the JAX package's, on
the CPU.

  * the numpy feature builders and the reward spec (`envs/starcraft2/
    {state_builder,obs_builder,v2_builders,reward}.py`), the SMACv2
    capability distributions and the map registry: the same inputs, made
    from a seed with numpy, give the same arrays bit for bit, over the
    ablation and capability flags (every boolean of the config drawn per
    case) and with dead units, shields and unit types;
  * the adapters (`smac_env.SMACEnv`, `smacv2_env.SMACv2Env`,
    `football/football_env.FootballEnv`) over the engine stand-ins of
    `chip_smoke.py` (installed in sys.modules under monkeypatch; neither
    machine has StarCraft II or gfootball): the port's and JAX's adapter,
    each over its own stand-in from the same seed, stepped with the same
    actions, give the same streams (obs, state, rewards, dones, infos,
    available actions), episode ends and resets included, at every state
    type; the metric extractors agree on those infos.
"""
import dataclasses
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from onpolicy_tpu.envs.starcraft2 import distributions as j_dist
from onpolicy_tpu.envs.starcraft2 import obs_builder as j_ob
from onpolicy_tpu.envs.starcraft2 import reward as j_reward
from onpolicy_tpu.envs.starcraft2 import smac_maps as j_maps
from onpolicy_tpu.envs.starcraft2 import state_builder as j_sb
from onpolicy_tpu.envs.starcraft2 import v2_builders as j_vb

from onpolicy_torch.envs.starcraft2 import distributions as t_dist
from onpolicy_torch.envs.starcraft2 import obs_builder as t_ob
from onpolicy_torch.envs.starcraft2 import reward as t_reward
from onpolicy_torch.envs.starcraft2 import smac_maps as t_maps
from onpolicy_torch.envs.starcraft2 import state_builder as t_sb
from onpolicy_torch.envs.starcraft2 import v2_builders as t_vb


def _equal(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _flags(config_cls, seed, **fixed):
    """Every boolean field of `config_cls` drawn from `seed` (case 0: all
    False, case 1: all True), then `fixed`."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in dataclasses.fields(config_cls):
        if f.type in ("bool", bool):
            out[f.name] = (False if seed == 0 else True if seed == 1
                           else bool(rng.integers(2)))
    out.update(fixed)
    return out


def _units(rng, n, with_shields):
    """Positions, health (a third dead), shields and types of n units."""
    health_max = rng.uniform(40, 200, n)
    health = np.where(rng.uniform(size=n) < 0.3, 0.0,
                      health_max * rng.uniform(0.1, 1.0, n))
    shield_max = rng.uniform(20, 80, n) if with_shields else np.zeros(n)
    return dict(x=rng.uniform(4, 28, n), y=rng.uniform(4, 28, n),
                health=health, health_max=health_max,
                shield=shield_max * rng.uniform(0, 1, n),
                shield_max=np.where(shield_max > 0, shield_max, 1.0))


def _snapshot_fields(rng, M, E, A, type_bits, shields):
    al, en = _units(rng, M, shields), _units(rng, E, shields)
    avail = (rng.uniform(size=(M, A)) < 0.6).astype(np.float32)
    return dict(
        ally_x=al["x"], ally_y=al["y"], ally_health=al["health"],
        ally_health_max=al["health_max"], ally_shield=al["shield"],
        ally_shield_max=al["shield_max"],
        ally_type=rng.integers(0, max(type_bits, 1), M),
        ally_cooldown=rng.uniform(0, 20, M),
        ally_max_cooldown=rng.uniform(10, 30, M),
        enemy_x=en["x"], enemy_y=en["y"], enemy_health=en["health"],
        enemy_health_max=en["health_max"], enemy_shield=en["shield"],
        enemy_shield_max=en["shield_max"],
        enemy_type=rng.integers(0, max(type_bits, 1), E),
        sight_range=rng.uniform(6, 12, M), avail_actions=avail,
        last_actions=np.eye(A, dtype=np.float32)[rng.integers(0, A, M)],
        episode_steps=int(rng.integers(0, 100)))


CASES = range(6)


@pytest.mark.parametrize("case", CASES)
def test_state_and_obs_builders_equal_jax(case):
    """SMAC's agent-specific state, the per-agent env state with its
    ablation blocks (and local obs) and the reference observation."""
    rng = np.random.default_rng(100 + case)
    M, E = 4, 5
    type_bits = (0, 2, 3)[case % 3]
    shields = case % 2 == 0
    geometry = dict(n_agents=M, n_enemies=E, n_actions=6 + E, map_x=32,
                    map_y=28, max_distance_x=32, max_distance_y=28,
                    unit_type_bits=type_bits,
                    shield_bits_ally=int(shields),
                    shield_bits_enemy=int(shields), episode_limit=150)
    kw = _flags(j_sb.StateConfig, case, **geometry)
    jc, tc = j_sb.StateConfig(**kw), t_sb.StateConfig(**kw)
    fields = _snapshot_fields(rng, M, E, 6 + E, type_bits, shields)
    js, ts = j_sb.Snapshot(**fields), t_sb.Snapshot(**fields)
    assert t_sb.state_dim(tc) == j_sb.state_dim(jc)
    assert t_ob.obs_dim(tc) == j_ob.obs_dim(jc)
    obs = j_ob.all_obs(jc, js)
    _equal(t_ob.all_obs(tc, ts), obs, "obs")
    _equal(t_sb.all_agent_states(tc, ts), j_sb.all_agent_states(jc, js),
           "agent-specific state")
    assert t_sb.env_state_dim(tc, obs.shape[1]) == \
        j_sb.env_state_dim(jc, obs.shape[1])
    for local in ((obs,) if kw["add_local_obs"] else (None, obs)):
        _equal(t_sb.all_env_states(tc, ts, local),
               j_sb.all_env_states(jc, js, local), "env state")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("map_type", ["protoss_gen", "terran_gen"])
def test_v2_builders_equal_jax(case, map_type):
    """SMACv2's observation and agent-specific state over the capability
    flags (stochastic attack and health, teammate masking and padding,
    enemy masks, own position, timestep)."""
    rng = np.random.default_rng(200 + case)
    M, E = 4, 5
    shields = map_type == "protoss_gen"
    geometry = dict(n_agents=M, n_enemies=E, n_actions=6 + E, map_x=32,
                    map_y=32, max_distance_x=32, max_distance_y=32,
                    map_type=map_type, unit_type_bits=3,
                    shield_bits_ally=int(shields),
                    shield_bits_enemy=int(shields), episode_limit=200)
    kw = _flags(j_vb.V2Config, case, **geometry)
    jc, tc = j_vb.V2Config(**kw), t_vb.V2Config(**kw)
    fields = _snapshot_fields(rng, M, E, 6 + E, 3, shields)
    fields.update(attack_probs=rng.uniform(0, 1, M),
                  health_levels=rng.uniform(0, 0.5, M),
                  enemy_mask=rng.uniform(size=(M, E)) < 0.3)
    js, ts = j_vb.V2Snapshot(**fields), t_vb.V2Snapshot(**fields)
    assert (t_vb.obs_dim(tc), t_vb.state_dim(tc)) == \
        (j_vb.obs_dim(jc), j_vb.state_dim(jc))
    for i in range(M):
        _equal(t_vb.agent_obs(tc, ts, i), j_vb.agent_obs(jc, js, i),
               f"v2 obs {i}")
    if jc.obs_last_action:
        for vb, c, s in ((j_vb, jc, js), (t_vb, tc, ts)):
            with pytest.raises(ValueError, match="latent reference bug"):
                vb.all_agent_states(c, s)
    else:
        _equal(t_vb.all_agent_states(tc, ts), j_vb.all_agent_states(jc, js),
               "v2 state")


@pytest.mark.parametrize("case", CASES)
def test_reward_spec_equal_jax(case):
    """`reward_battle` over random unit snapshots (deaths, hurts, shield
    regeneration) at each flag setting, and `step_bookkeeping` over game
    ends, truncation and counted wins."""
    rng = np.random.default_rng(300 + case)
    M, E = 5, 6
    arg = lambda n: dict(health=rng.uniform(0, 100, n).round() * (
        rng.uniform(size=n) > 0.3), shield=rng.uniform(0, 30, n))
    pa, a, pe, e = arg(M), arg(M), arg(E), arg(E)
    kw = dict(prev_ally_health=pa["health"], prev_ally_shield=pa["shield"],
              ally_health=a["health"], ally_shield=a["shield"],
              dead_before_ally=rng.uniform(size=M) < 0.2,
              prev_enemy_health=pe["health"],
              prev_enemy_shield=pe["shield"], enemy_health=e["health"],
              enemy_shield=e["shield"],
              dead_before_enemy=rng.uniform(size=E) < 0.2,
              reward_only_positive=bool(case % 2),
              reward_sparse=case == 4,
              reward_negative_scale=float(rng.uniform(0.1, 1.0)))
    assert t_reward.reward_battle(**kw) == j_reward.reward_battle(**kw)
    for code in (None, 1, -1):
        for steps in (10, 150):
            kw = dict(game_end_code=code, episode_steps=steps,
                      episode_limit=150, reward=float(rng.uniform(0, 5)),
                      death_tracker_ally=rng.uniform(size=M) < 0.4,
                      win_counted=case == 3, reward_sparse=case == 4,
                      max_reward=float(rng.uniform(50, 500)))
            _equal(t_reward.step_bookkeeping(**kw),
                   j_reward.step_bookkeeping(**kw), f"{code} {steps}")


@pytest.mark.parametrize("key", sorted(j_dist.DISTRIBUTION_MAP))
def test_distributions_equal_jax(key):
    """Every registered capability distribution, from the same seeded
    generator, draws the same teams and start positions."""
    config = {"env_key": key, "test_mode": False,
              "items": [["stalker", "zealot"], ["zealot", "zealot"]],
              "unit_types": ["stalker", "zealot", "colossus"],
              "weights": [0.45, 0.45, 0.1], "n_units": 3, "n_enemies": 4,
              "lower_bound": (0, 0), "upper_bound": (1, 1), "mask_probability": 0.5,
              "map_x": 32, "map_y": 32, "p": 0.5}
    if key == "all_teams":
        config["n_enemies"] = 3
    make = lambda mod: mod.get_distribution(key)(
        dict(config), np.random.default_rng(7))
    ours, theirs = make(t_dist), make(j_dist)
    for _ in range(6):
        _equal(ours.generate(), theirs.generate(), key)


def test_smacv2_config_and_map_registry_equal_jax():
    for units, name in (("5v5", "10gen_protoss"), ("10v11", "10gen_zerg"),
                        ("20v23", "10gen_terran")):
        ns = SimpleNamespace(units=units, map_name=name)
        _equal(t_dist.parse_smacv2_distribution(ns),
               j_dist.parse_smacv2_distribution(ns), name)
    assert t_maps.MAP_REGISTRY == j_maps.MAP_REGISTRY
    for name in ("3s5z", "corridor", "MMM2"):
        assert t_maps.get_map_params(name) == j_maps.get_map_params(name)
    with pytest.raises(KeyError):
        t_maps.get_map_params("no_such_map")


# ---------------------------------------------------------------------------
# the adapters over the engine stand-ins
# ---------------------------------------------------------------------------

@pytest.fixture()
def standins(monkeypatch):
    for name, mod in chip_smoke.engine_standin_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)


def _run_adapter(env, steps, seed=0):
    """reset, then `steps` steps of available actions drawn from `seed`
    (a new episode after each end): every output."""
    rng = np.random.default_rng(seed)
    out = env.reset()
    rows = [out]
    for _ in range(steps):
        avail = out[-1] if isinstance(out, tuple) and len(out) != 4 \
            else None
        M = env.num_agents
        acts = np.array([rng.choice(np.nonzero(avail[i])[0])
                         if avail is not None else rng.integers(19)
                         for i in range(M)])
        out = env.step(acts)
        rows.append(out)
        dones = out[3] if len(out) == 6 else out[2]
        if np.all(dones):
            out = env.reset()
            rows.append(out)
    return rows


def _shapes(spaces):
    return [s.shape if hasattr(s, "shape") else s.n for s in spaces]


@pytest.mark.parametrize("state_type", ["env", "agent_feature", "concat",
                                        "agent"])
def test_smac_env_equals_jax_over_the_standin(standins, state_type):
    """SMACEnv on 3s5z (8 against 8, Protoss shields, unit types):
    battles won, lost and cut at the limit, per-agent deaths."""
    from onpolicy_tpu.envs.starcraft2.smac_env import SMACEnv as JEnv
    from onpolicy_tpu.envs.starcraft2.smac_env import \
        smac_win_rate_metrics as j_metrics
    from onpolicy_torch.envs.starcraft2.smac_env import SMACEnv, \
        smac_win_rate_metrics
    options = {"add_move_state": True, "add_local_obs": True}
    make = lambda cls: cls("3s5z", seed=5, state_type=state_type,
                           state_options=options)
    ours, theirs = make(SMACEnv), make(JEnv)
    for a in ("observation_space", "share_observation_space",
              "action_space"):
        assert _shapes(getattr(ours, a)) == _shapes(getattr(theirs, a))
    got, want = _run_adapter(ours, 600), _run_adapter(theirs, 600)
    _equal(got, want, state_type)
    infos = [r[4] for r in want if len(r) == 6]
    ends = [i[0] for i, r in zip(infos, [r for r in want if len(r) == 6])
            if r[3].all()]
    assert {(e["won"], e["bad_transition"]) for e in ends} >= \
        {(True, False), (False, True)}
    assert any(r[3].any() and not r[3].all() for r in want if len(r) == 6)
    ours_m, theirs_m = smac_win_rate_metrics(), j_metrics()
    for info in infos[::37]:
        assert ours_m([info] * 2) == theirs_m([info] * 2)
    assert ours.force_restarts == theirs.force_restarts == 0


@pytest.mark.parametrize("state_type,per_agent_dones", [
    ("agent_feature", True), ("env", False), ("concat", True),
    ("agent", True)])
def test_smacv2_env_equals_jax_over_the_standin(standins, state_type,
                                                per_agent_dones):
    """SMACv2Env on 10gen_protoss 5v5 (teams and starts drawn from the
    capability config)."""
    from onpolicy_tpu.envs.starcraft2.smacv2_env import SMACv2Env as JEnv
    from onpolicy_torch.envs.starcraft2.smacv2_env import SMACv2Env
    dist = t_dist.parse_smacv2_distribution(
        SimpleNamespace(units="5v5", map_name="10gen_protoss"))
    make = lambda cls: cls("10gen_protoss", dist, seed=9,
                           state_type=state_type,
                           per_agent_dones=per_agent_dones)
    ours, theirs = make(SMACv2Env), make(JEnv)
    assert _shapes(ours.share_observation_space) == \
        _shapes(theirs.share_observation_space)
    got, want = _run_adapter(ours, 300), _run_adapter(theirs, 300)
    _equal(got, want, state_type)
    assert any(r[3].all() for r in want if len(r) == 6)


@pytest.mark.parametrize("share_reward", [True, False])
def test_football_env_equals_jax_over_the_standin(standins, share_reward):
    """FootballEnv on academy_3_vs_1_with_keeper (3 players, 115-wide obs,
    19 actions): obs, rewards, dones and the enriched infos; the goal and
    win-rate extractor."""
    from onpolicy_tpu.envs.football.football_env import FootballEnv as JEnv
    from onpolicy_tpu.envs.football.football_env import \
        football_metrics as j_metrics
    from onpolicy_torch.envs.football.football_env import FootballEnv, \
        football_metrics
    make = lambda cls: cls(num_agents=3, share_reward=share_reward)
    ours, theirs = make(FootballEnv), make(JEnv)
    assert _shapes(ours.observation_space) == [(115,)] * 3
    assert [s.n for s in ours.action_space] == [19] * 3
    assert _shapes(ours.share_observation_space) == [(345,)] * 3
    got, want = _run_adapter(ours, 120), _run_adapter(theirs, 120)
    _equal(got, want, "football")
    steps = [r for r in want if isinstance(r, tuple)]
    assert any(r[3][0]["score_reward"] for r in steps)
    for r in steps[::9]:
        assert football_metrics()(r[3]) == j_metrics()(r[3])
