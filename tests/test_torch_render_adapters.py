"""The env adapters' render and seed methods against the JAX package's,
on the CPU, over the engine stand-ins of `chip_smoke.py` (installed in
sys.modules under monkeypatch; neither machine has gfootball or
StarCraft II):

  * `envs/host_vec.HostVecEnv.render` asks env 0 of the pool for its
    frame, with the mode given;
  * `envs/football/football_env.FootballEnv` hands the engine's
    `create_environment` JAX's keyword arguments (`stacked`, the render
    flag, extra keywords), and its `seed` and `render` act as JAX's;
  * `envs/starcraft2/smac_env.SMACEnv.seed` keeps the seed and pushes it
    into the engine's `_seed` or `np_random`, or warns, as JAX's;
    `smacv2_env.SMACv2Env.seed` changes nothing, as JAX's.
"""
import random
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
import onpolicy_tpu.envs.football.football_env as j_fe
import onpolicy_tpu.envs.starcraft2.smac_env as j_smac
import onpolicy_tpu.envs.starcraft2.smacv2_env as j_smacv2
from onpolicy_tpu.envs import host_vec as j_host_vec

import onpolicy_torch.envs.football.football_env as t_fe
import onpolicy_torch.envs.starcraft2.smac_env as t_smac
import onpolicy_torch.envs.starcraft2.smacv2_env as t_smacv2
from onpolicy_torch.envs import host_vec
from onpolicy_torch.envs.starcraft2 import distributions as t_dist


@pytest.fixture()
def standins(monkeypatch):
    for name, mod in chip_smoke.engine_standin_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)


def _framed_env(module, i):
    """A GRF adapter over the stand-in whose engine draws a frame that
    tells the env `i` and the mode asked for."""
    env = module.FootballEnv(num_agents=3)
    env.env.render = lambda mode="rgb_array": np.full(
        (72, 96, 3), 10 * i + (100 if mode == "human" else 1), np.uint8)
    return env


@pytest.mark.parametrize("mode", [None, "human"])
def test_host_vec_render_is_env_0s_frame(standins, mode):
    def frames(vec_module, env_module):
        pool = vec_module.HostVecEnv(
            [lambda i=i: _framed_env(env_module, i) for i in range(2)],
            protocol="basic")
        try:
            pool.reset()
            return pool.render() if mode is None else pool.render(mode)
        finally:
            pool.close()
    got = frames(host_vec, t_fe)
    want = frames(j_host_vec, j_fe)
    np.testing.assert_array_equal(got, want)
    env0 = _framed_env(t_fe, 0).render(mode or "rgb_array")
    np.testing.assert_array_equal(got, env0)
    assert got.dtype == np.uint8 and got.shape == (72, 96, 3)


@pytest.mark.parametrize("kwargs", [
    {},
    {"stacked": True, "use_render": True, "seed": 3},
    {"use_render": True, "smm_width": 48, "smm_height": 36,
     "write_video": True, "logdir": "/nowhere"},
])
def test_football_env_hands_the_engine_jax_arguments(standins, monkeypatch,
                                                     kwargs):
    calls = []

    def recording(**kw):
        calls.append(kw)
        return chip_smoke.standin_create_environment(**kw)
    monkeypatch.setattr(sys.modules["gfootball.env"], "create_environment",
                        recording)
    t_fe.FootballEnv(num_agents=3, **kwargs)
    j_fe.FootballEnv(num_agents=3, **kwargs)
    assert len(calls) == 2
    assert calls[0] == calls[1]
    assert calls[0]["render"] is False
    assert "seed" not in calls[0]


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_football_env_seed_and_render_equal_jax(standins, seed):
    def seeded(module):
        env = module.FootballEnv(num_agents=3)
        env.seed(seed)
        return random.random(), env.env.rng.random(3), env.render()
    ours, theirs = seeded(t_fe), seeded(j_fe)
    assert ours[0] == theirs[0]
    random.seed(1 if seed is None else seed)
    assert ours[0] == random.random()
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[1], np.random.default_rng(
        1 if seed is None else seed).random(3))
    np.testing.assert_array_equal(ours[2], theirs[2])


def _engine(kind):
    """What `SMACEnv.seed` may find as its engine: the stand-in (with
    `_seed`), one with only `np_random`, or one with neither."""
    if kind == "np_random":
        return SimpleNamespace(np_random=np.random.RandomState(0),
                               close=lambda: None)
    return SimpleNamespace(close=lambda: None)


@pytest.mark.parametrize("engine", ["standin", "np_random", "neither"])
def test_smac_env_seed_equals_jax(standins, engine):
    def seeded(module):
        env = module.SMACEnv("3s5z", seed=5)
        if engine != "standin":
            env.env = _engine(engine)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            env.seed(123)
        rng = getattr(env.env, "np_random", None)
        return (env._seed, getattr(env.env, "_seed", None),
                None if rng is None else rng.random_sample(3),
                [(w.category, str(w.message)) for w in caught])
    ours, theirs = seeded(t_smac), seeded(j_smac)
    assert ours[0] == theirs[0] == 123
    assert ours[1] == theirs[1] == (123 if engine == "standin" else None)
    if engine == "np_random":
        np.testing.assert_array_equal(ours[2], theirs[2])
        np.testing.assert_array_equal(
            ours[2], np.random.RandomState(123).random_sample(3))
    assert ours[3] == theirs[3]
    assert bool(ours[3]) == (engine == "neither")


def test_smacv2_env_seed_changes_nothing_as_jax(standins):
    dist = t_dist.parse_smacv2_distribution(
        SimpleNamespace(units="5v5", map_name="10gen_protoss"))
    outs = []
    for module in (t_smacv2, j_smacv2):
        for reseed in (False, True):
            env = module.SMACv2Env("10gen_protoss", dist, seed=9)
            if reseed:
                assert env.seed(4) is None
            outs.append(env.reset())
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            np.testing.assert_array_equal(a, b)
