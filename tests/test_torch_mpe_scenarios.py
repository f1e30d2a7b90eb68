"""The port's other seven MPE scenarios, and the world's walls and noise,
against the JAX env.

For each scenario, from `envs/mpe/golden.reference_reset` states (the
reference's numpy draw order), 30 steps of the same random actions must
give the same observations, rewards and dones, across the auto-reset at
step 25, whose fresh states are the JAX env's own draws injected into the
port (as tests/test_torch_mpe.py does for the three scenarios ported
first). The scenarios' arguments are those of tests/test_mpe_golden_exact.py
(simple_attack, which has no reference run: 2 adversaries, 2 good agents,
4 landmarks). The walls and noise: simple_world_comm's spec with a hard
horizontal wall, a soft vertical one that its ghost agents pass, action
noise on every agent and comm noise on the speaking leader; the port's
step takes the standard normal draws JAX's `physics_step` makes from each
env's step key. float64 at atol 1e-9, in one subprocess: float64 needs
`jax_enable_x64`, which flips global JAX state for every later test of the
same worker.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from onpolicy_torch.envs.mpe import scenarios
from onpolicy_torch.envs.mpe.env import MPEEnv
from onpolicy_torch.envs.mpe.world import WorldSpec, physics_step
from onpolicy_torch.utils import spaces as sp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case: (scenario, num_agents, num_landmarks, num_good_agents,
# num_adversaries, walls and noise)
CASES = {
    "simple_adversary": ("simple_adversary", 3, 2, 1, 3, False),
    "simple_tag": ("simple_tag", 4, 2, 1, 3, False),
    "simple_push": ("simple_push", 2, 2, 1, 3, False),
    "simple_crypto": ("simple_crypto", 3, 2, 1, 3, False),
    "simple_crypto_display": ("simple_crypto_display", 3, 2, 1, 3, False),
    "simple_attack": ("simple_attack", 4, 4, 2, 2, False),
    "simple_world_comm": ("simple_world_comm", 6, 1, 2, 4, False),
    "walls_and_noise": ("simple_world_comm", 6, 1, 2, 4, True),
}

WORKER = r"""
import dataclasses
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
from onpolicy_tpu.envs.mpe import world as jworld
from onpolicy_tpu.envs.mpe.env import MPEEnv as JEnv, MPEVecEnv as JVec
from onpolicy_torch.envs.mpe import world as tworld
from onpolicy_torch.envs.mpe.env import MPEEnv, MPEVecEnv
from onpolicy_torch.utils.params import world_state_from_jax

CASES = json.loads(sys.argv[1])
N, T, STEPS = 6, 25, 30
f64 = torch.float64


def walls_and_noise(spec, wall_cls):
    M = spec.n_agents
    return dataclasses.replace(
        spec,
        walls=(wall_cls("H", 0.3, (-0.5, 0.6), width=0.1, hard=True),
               wall_cls("V", -0.2, (-0.8, 0.4), width=0.2, hard=False)),
        agent_ghost=tuple(i % 2 == 1 for i in range(M)),
        agent_u_noise=(0.3,) * M,
        agent_c_noise=(0.5,) + (None,) * (M - 1))


def noise_draws(spec, step_keys, M):
    # the draws jworld.physics_step makes from each env's step key
    u_on = any(spec.agent_u_noise)
    c_on = spec.dim_c > 0 and any(spec.agent_c_noise)
    us, cs = [], []
    for key in step_keys:
        if u_on:
            key, kn = jax.random.split(key)
            us.append(np.asarray(jax.random.normal(kn, (M, 2))))
        if c_on:
            key, kc = jax.random.split(key)
            cs.append(np.asarray(jax.random.normal(kc, (M, spec.dim_c))))
    noise = {}
    if us:
        noise["u"] = torch.tensor(np.stack(us))
    if cs:
        noise["c"] = torch.tensor(np.stack(cs))
    return noise


def run(name, M, K, good, adv, special):
    jenv = JEnv(name, M, K, T, good, adv)
    tenv = MPEEnv(name, M, K, T, good, adv)
    assert list(map(repr, tenv.action_space)) == list(map(repr, jenv.action_space))
    if special:
        jenv.spec = walls_and_noise(jenv.spec, jworld.WallSpec)
        tenv.spec = walls_and_noise(tenv.spec, tworld.WallSpec)
    jvec = JVec(jenv, N)
    j_step = jax.jit(jvec.step)
    j_resets = jax.jit(lambda k: jax.vmap(jenv.reset)(jax.random.split(k, N)))
    j_observe = jax.jit(jax.vmap(lambda s: jenv.scenario.observation(jenv.spec, s)))
    heads = [getattr(s, "nvec", None) or (s.n,) for s in tenv.action_space]
    width = max(len(h) for h in heads)
    highs = np.ones((M, width), np.int64)          # padding columns draw 0
    for i, h in enumerate(heads):
        highs[i, :len(h)] = h
    tvec = MPEVecEnv(tenv, N, "cpu", torch.Generator().manual_seed(0), f64)
    conv = lambda s: world_state_from_jax(jax.device_get(s), dtype=f64)

    np.random.seed(0)
    resets = [golden.reference_reset(name, jenv.spec, jnp.float64)
              for _ in range(N)]
    js = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *resets)
    ts = conv(js)
    maxabs = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) \
        if np.asarray(b).size else 0.0
    err = {"obs": max(maxabs(t.numpy(), j) for t, j in
                      zip(tenv.observation(ts), j_observe(js))),
           "rew": 0.0, "state": 0.0}
    dones_seen, reset_seen, wall_force = 0, 0, 0.0
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    for step in range(STEPS):
        acts = rng.integers(0, highs, (N, M, width)).astype(np.int32)
        key, k = jax.random.split(key)
        k_step, k_reset = jax.random.split(k)          # as JVec.step splits
        j_reset, _ = j_resets(k_reset)
        noise = noise_draws(jenv.spec, jax.random.split(k_step, N), M) \
            if special else None
        wall_force = max(wall_force, float(
            tworld._wall_forces(tenv.spec, ts.agent_pos).abs().max()))
        js, j_obs, j_rew, j_done = j_step(js, jnp.asarray(acts), k)
        ts, t_obs, t_rew, t_done = tvec.step(ts, torch.tensor(acts),
                                             conv(j_reset), noise)
        assert t_rew.shape == (N, M, 1) and t_done.shape == (N, M)
        assert np.array_equal(t_done.numpy(), np.asarray(j_done)), step
        dones_seen += int(t_done.any())
        reset_seen += int((ts.t == 0).all())
        if bool(t_done.any()):
            # JAX's reset draws float32 positions and builds their obs in
            # float32 even under x64: hold the port's obs of those states
            # against JAX's observation of them in float64
            j_ref = j_observe(jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
                j_reset))
            err["obs_reset_f32"] = max(maxabs(t.numpy(), j)
                                       for t, j in zip(t_obs, j_obs))
            j_obs = j_ref
        for t, j in zip(t_obs, j_obs):
            assert t.dtype == f64 and t.shape == j.shape, (t.shape, j.shape)
            err["obs"] = max(err["obs"], maxabs(t.numpy(), j))
        err["rew"] = max(err["rew"], maxabs(t_rew.numpy(), j_rew))
        for f in ("agent_pos", "agent_vel", "landmark_pos", "agent_comm"):
            err["state"] = max(err["state"], maxabs(
                getattr(ts, f).numpy(), getattr(js, f)))
    err["dones_seen"] = dones_seen
    err["reset_seen"] = reset_seen
    err["wall_force"] = wall_force
    return err


print(json.dumps({case: run(*args) for case, args in CASES.items()}))
"""


@pytest.fixture(scope="module")
def jax_results():
    res = subprocess.run([sys.executable, "-c", WORKER, json.dumps(CASES)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_scenario_matches_jax_float64(jax_results, case):
    err = jax_results[case]
    assert err["dones_seen"] == 1 and err["reset_seen"] == 1, err
    for k in ("obs", "rew", "state"):
        assert err[k] < 1e-9, (k, err)
    assert err["obs_reset_f32"] < 1e-7, err
    # the walls push somebody at some step, or they were not tested
    assert (err["wall_force"] > 1e-3) == (case == "walls_and_noise"), err


def test_world_comm_spaces_and_decode():
    """simple_world_comm at the arguments of the JAX package's golden test:
    the leader acts in MultiDiscrete (5, 4), the rest in Discrete(5),
    adversaries see 34 numbers and good agents 28; the leader's comm
    column of an action padded to two columns (as the separated runner
    pads) becomes its one-hot utterance, the followers' padding says
    nothing."""
    env = MPEEnv("simple_world_comm", 6, 1, 25, num_good_agents=2,
                 num_adversaries=4)
    assert env.action_space == ([sp.MultiDiscrete((5, 4))]
                                + [sp.Discrete(5)] * 5)
    assert [s.shape[0] for s in env.observation_space] == [34] * 4 + [28] * 2
    assert env.share_observation_space[0].shape == (4 * 34 + 2 * 28,)
    acts = torch.tensor([[[1, 3], [2, 0], [3, 0], [4, 0], [0, 0], [1, 0]]])
    u, c = env._decode_actions(acts, torch.zeros(1))
    sens = [3.0] * 4 + [4.0] * 2
    want = [[1, 0], [-1, 0], [0, 1], [0, -1], [0, 0], [1, 0]]
    assert u[0].tolist() == [[x * s for x in w] for w, s in zip(want, sens)]
    assert c[0, 0].tolist() == [0.0, 0.0, 0.0, 1.0]
    assert c[0, 1:].abs().sum() == 0


def test_registry_loads_every_scenario():
    assert scenarios.available() == sorted(
        ["simple_spread", "simple_reference", "simple_speaker_listener"]
        + [c for c in CASES if c.startswith("simple_")])
    with pytest.raises(ValueError, match="unknown MPE scenario"):
        scenarios.load("simple_world")


def test_noise_needs_its_draws():
    spec = WorldSpec(n_agents=1, n_landmarks=0, dim_c=0, world_length=5,
                     agent_movable=(True,), agent_silent=(True,),
                     agent_collide=(False,), agent_size=(0.1,),
                     agent_accel=(None,), agent_max_speed=(None,),
                     agent_u_noise=(0.2,))
    env = MPEEnv("simple_spread", 1, 0, 5)
    state = env.scenario.reset(spec, 2, torch.Generator().manual_seed(0),
                               "cpu", torch.float32)
    u = torch.zeros(2, 1, 2)
    with pytest.raises(ValueError, match="noise"):
        physics_step(spec, state, u, torch.zeros(2, 1, 1))
    eps = torch.tensor([[[1.0, -2.0]], [[0.5, 0.0]]])
    moved = physics_step(spec, state, u, torch.zeros(2, 1, 1), {"u": eps})
    # v = F/m·dt with F = 0.2·ε, p += v·dt
    torch.testing.assert_close(moved.agent_vel, 0.2 * eps * 0.1)
