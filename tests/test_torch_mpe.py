"""The port's batched MPE scenarios against the JAX env.

For simple_spread, simple_reference (MultiDiscrete (5, 10) actions, comm)
and simple_speaker_listener (Discrete(3) speaker, Discrete(5) listener,
actions padded to the widest head): from `envs/mpe/golden.reference_reset`
states (the reference's numpy draw order), 30 steps of the same random
actions must give the same observations, rewards and dones, across an
auto-reset at step 25 whose fresh states are the JAX env's own draws
injected into the port (every env finishes there, since all start at
t=0). The comparison runs in float64 at atol 1e-9, in a subprocess:
float64 needs `jax_enable_x64`, which flips global JAX state for every
later test of the same worker (as in tests/test_mpe_golden_exact.py).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.utils import spaces as sp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json
import sys
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
import jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads(1)

from onpolicy_tpu.envs.mpe import golden
from onpolicy_tpu.envs.mpe.env import MPEEnv as JEnv, MPEVecEnv as JVec
from onpolicy_torch.envs.mpe.env import MPEEnv, MPEVecEnv
from onpolicy_torch.utils.params import world_state_from_jax

SCENARIO, M = sys.argv[1], int(sys.argv[2])
N, K, T, STEPS = 6, 3, 25, 30
f64 = torch.float64
jenv = JEnv(SCENARIO, M, K, T)
jvec = JVec(jenv, N)
j_step = jax.jit(jvec.step)
j_resets = jax.jit(lambda k: jax.vmap(jenv.reset)(jax.random.split(k, N)))
j_observe = jax.jit(jax.vmap(lambda s: jenv.scenario.observation(jenv.spec, s)))
tenv = MPEEnv(SCENARIO, M, K, T)
assert list(map(repr, tenv.action_space)) == list(map(repr, jenv.action_space))
heads = [getattr(s, "nvec", None) or (s.n,) for s in tenv.action_space]
width = max(len(h) for h in heads)
highs = np.ones((M, width), np.int64)          # padding columns draw 0
for i, h in enumerate(heads):
    highs[i, :len(h)] = h
tvec = MPEVecEnv(tenv, N, "cpu", torch.Generator().manual_seed(0), f64)
conv = lambda s: world_state_from_jax(jax.device_get(s), dtype=f64)

np.random.seed(0)
resets = [golden.reference_reset(SCENARIO, jenv.spec, jnp.float64)
          for _ in range(N)]
js = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *resets)
ts = conv(js)
j_obs = j_observe(js)
t_obs = tenv.observation(ts)
err = {"obs": max(float(np.max(np.abs(t.numpy() - np.asarray(j))))
                  for t, j in zip(t_obs, j_obs)),
       "rew": 0.0, "state": 0.0}
dones_seen, reset_seen = 0, 0
rng = np.random.default_rng(1)
key = jax.random.PRNGKey(2)
for step in range(STEPS):
    acts = rng.integers(0, highs, (N, M, width)).astype(np.int32)
    key, k = jax.random.split(key)
    _, k_reset = jax.random.split(k)                  # as JVec.step splits
    j_reset, _ = j_resets(k_reset)
    js, j_obs, j_rew, j_done = j_step(js, jnp.asarray(acts), k)
    ts, t_obs, t_rew, t_done = tvec.step(ts, torch.tensor(acts), conv(j_reset))
    assert t_rew.shape == (N, M, 1) and t_done.shape == (N, M)
    assert np.array_equal(t_done.numpy(), np.asarray(j_done)), step
    dones_seen += int(t_done.any())
    reset_seen += int((ts.t == 0).all())
    if bool(t_done.any()):
        # JAX's reset draws float32 positions and builds their obs in
        # float32 even under x64; hold the port's obs of those states
        # against JAX's observation of the same states in float64, and
        # against the vec env's float32 obs at float32 rounding
        j_ref = j_observe(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
            j_reset))
        err["obs_reset_f32"] = max(float(np.max(np.abs(t.numpy() - np.asarray(j))))
                                   for t, j in zip(t_obs, j_obs))
        j_obs = j_ref
    for t, j in zip(t_obs, j_obs):
        assert t.dtype == f64 and t.shape == j.shape
        err["obs"] = max(err["obs"], float(np.max(np.abs(t.numpy() - np.asarray(j)))))
    err["rew"] = max(err["rew"], float(np.max(np.abs(t_rew.numpy() - np.asarray(j_rew)))))
    for name in ("agent_pos", "agent_vel", "landmark_pos"):
        err["state"] = max(err["state"], float(np.max(np.abs(
            getattr(ts, name).numpy() - np.asarray(getattr(js, name))))))
err["dones_seen"] = dones_seen
err["reset_seen"] = reset_seen
print(json.dumps(err))
"""


def _matches_jax_float64(scenario, num_agents):
    res = subprocess.run([sys.executable, "-c", WORKER, scenario,
                          str(num_agents)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    err = json.loads(res.stdout.strip().splitlines()[-1])
    assert err["dones_seen"] == 1 and err["reset_seen"] == 1, err
    for k in ("obs", "rew", "state"):
        assert err[k] < 1e-9, err
    assert err["obs_reset_f32"] < 1e-7, err


def test_simple_spread_matches_jax_float64():
    _matches_jax_float64("simple_spread", 3)


@pytest.mark.parametrize("scenario", ["simple_reference",
                                      "simple_speaker_listener"])
def test_comm_scenarios_match_jax_float64(scenario):
    _matches_jax_float64(scenario, 2)


def test_env_spaces_and_decode():
    from onpolicy_torch.envs.mpe.env import MPEEnv
    env = MPEEnv("simple_spread", 3, 3, 25)
    assert [s.shape for s in env.observation_space] == [(18,)] * 3
    assert env.share_observation_space[0].shape == (54,)
    assert env.action_space[0].n == 5
    like = torch.zeros(1, dtype=torch.float32)
    u, c = env._decode_actions(torch.tensor([[[0], [1], [4]]]), like)
    assert u.tolist() == [[[0.0, 0.0], [5.0, 0.0], [0.0, -5.0]]]
    assert c.abs().sum() == 0            # silent agents send nothing


def test_comm_scenario_spaces_and_decode():
    """simple_reference: MultiDiscrete (5, 10), comm one-hot of the second
    head. simple_speaker_listener: the speaker's only head is its comm,
    the listener's its move; actions padded to one column."""
    from onpolicy_torch.envs.mpe.env import MPEEnv
    from onpolicy_torch.utils import spaces as sp
    ref = MPEEnv("simple_reference", 2, 3, 25)
    assert ref.action_space == [sp.MultiDiscrete((5, 10))] * 2
    assert [s.shape for s in ref.observation_space] == [(21,)] * 2
    like = torch.zeros(1, dtype=torch.float32)
    u, c = ref._decode_actions(torch.tensor([[[1, 7], [0, 2]]]), like)
    assert u.tolist() == [[[5.0, 0.0], [0.0, 0.0]]]
    assert c[0, 0].argmax() == 7 and c[0, 1].argmax() == 2
    assert c.sum() == 2
    sl = MPEEnv("simple_speaker_listener", 2, 3, 25)
    assert sl.action_space == [sp.Discrete(3), sp.Discrete(5)]
    assert [s.shape for s in sl.observation_space] == [(3,), (11,)]
    assert sl.share_observation_space[0].shape == (14,)
    u, c = sl._decode_actions(torch.tensor([[[2], [3]]]), like)
    assert u.tolist() == [[[0.0, 0.0], [0.0, 5.0]]]  # the speaker stays
    assert c[0, 0].tolist() == [0.0, 0.0, 1.0] and c[0, 1].sum() == 0


def test_other_scenarios_name_their_roadmap_item():
    """Every scenario of the JAX package's registry loads (simple_tag was
    refused until B3 was ported); an unknown name still raises."""
    from onpolicy_torch.envs.mpe import scenarios
    assert scenarios.load("simple_tag").shared_reward is False
    with pytest.raises(ValueError):
        scenarios.load("no_such_scenario")


def test_config_refuses_what_it_cannot_run():
    cfg = canonicalize_algorithm(Config(algorithm_name="rmappo"))
    assert cfg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cfg.validate()
    cpu = cfg.replace(device="cpu")
    assert cpu.validate() is cpu
    bf16 = cpu.replace(use_bf16=True)
    assert bf16.validate() is bf16
    with pytest.raises(ValueError, match="card only"):
        cpu.replace(use_pallas_gru=True).validate()


@pytest.mark.parametrize("override", [
    dict(mesh_shape=(1, 2)), dict(env_name="StarCraft2"),
    dict(scenario_name="simple_tag", num_agents=4, num_landmarks=2,
         share_policy=False),
    dict(algorithm_name="mat", use_popart=True, use_valuenorm=False),
    dict(use_popart=True, use_valuenorm=False)])
def test_runner_refuses_unported_options(override):
    """The 2-D (data, model) mesh (G2) is ported and runs under
    torchrun (tests/test_torch_parallel_2d.py): in one process its D·M = 2
    ranks are refused as a world of 1 (WORLD_SIZE); the
    StarCraft2 env is sent to the host runners (F); simple_tag (B3,
    through the separated runner: its roles see different widths) and
    PopArt for MAT and MAPPO (B4) build their runner now."""
    from onpolicy_torch.scripts.train_mpe import make_runner
    cfg = canonicalize_algorithm(Config(
        algorithm_name=override.pop("algorithm_name", "rmappo"),
        device="cpu", n_rollout_threads=2, episode_length=5,
        n_embd=16, hidden_size=16)).replace(**override)
    if "mesh_shape" in override:
        with pytest.raises(ValueError, match="D·M = 2 ranks.*WORLD_SIZE"):
            make_runner(cfg)
        return
    if "env_name" in override:
        with pytest.raises(ValueError, match="host_runner.py"):
            make_runner(cfg)
        return
    runner = make_runner(cfg)
    state, _ = runner.init()
    if cfg.scenario_name == "simple_tag":
        assert [a.act_space for a in runner.algos] == [sp.Discrete(5)] * 4
    elif cfg.algorithm_name == "mat":
        assert state.vnorm is None     # MAT normalizes under use_valuenorm only
    else:
        assert state.vnorm is not None  # PopArt's statistics


@pytest.mark.parametrize("algo", ["mat", "mat_dec", "hatrpo"])
def test_runner_takes_the_ported_algorithms(algo):
    """No longer refused: MAT and MAT-dec build the shared runner, HATRPO
    the separated one (and the shared runner sends it there)."""
    from onpolicy_torch.runner.separated_runner import SeparatedRunner
    from onpolicy_torch.runner.shared_runner import SharedRunner
    cfg = canonicalize_algorithm(Config(
        algorithm_name=algo, device="cpu", n_rollout_threads=2,
        episode_length=5, n_embd=16, hidden_size=16))
    if algo == "hatrpo":
        assert SeparatedRunner(cfg).is_happo
        with pytest.raises(ValueError, match="separated runner"):
            SharedRunner(cfg)
    else:
        assert SharedRunner(cfg).is_mat
