"""The port's Hanabi host path against the JAX package's, on the CPU.

At the size of tests/test_hanabi_device_collect.py (Hanabi-Small, 2
agents, 6 games, T=12, hidden 32), on the C++ engine (`cpp/hanabi`; the
port builds its own copy of the library), the same engine seed, the same
parameters (carried by `utils/params.py`) and deterministic actions (each
policy's mode):
  * the port's `_host_round` in lockstep with JAX's for an episode and the
    first round of the next: after every round the staging, the reset
    vector, the finished games' scores and, after the masked reset, the
    next seat's obs / share / avail, at the rollout tolerance (rtol/atol
    1e-5; integer and bool fields equal); then the buffer, and the state
    the deferred training leaves at the trained tolerance of
    tests/test_torch_hanabi_runner.py (rtol 1e-4 / atol 5e-5);
  * the port's `_host_round` against its `_device_round` over the C++
    engine (`torch_fleet.CppHanabiFleet`), bit for bit, and its host `run`
    against its `--use_scan_rounds` run;
  * the round's blanking of seats the loop never visits;
  * `HanabiVecEnv` / `HanabiSingleEnv` against JAX's, array for array;
  * `evaluate` against JAX's; the scripts; where the binding builds.
"""
import contextlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import config_from_args as j_config_from_args
from onpolicy_tpu.envs.hanabi import hanabi_env as j_env
from onpolicy_tpu.runner.hanabi_runner import HanabiRunner as JaxRunner

from onpolicy_torch.config import config_from_args
from onpolicy_torch.envs.hanabi import binding
from onpolicy_torch.envs.hanabi import hanabi_env as t_env
from onpolicy_torch.envs.hanabi.torch_fleet import CppHanabiFleet, upload
from onpolicy_torch.runner.hanabi_runner import HanabiRunner
from onpolicy_torch.scripts import eval_hanabi, train_hanabi
from onpolicy_torch.utils.params import train_state_from_jax, train_state_to_jax

torch.set_num_threads(1)

ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
ARGS = [
    "--algorithm_name", "mappo", "--env_name", "Hanabi",
    "--scenario_name", "Hanabi-Small", "--num_agents", "2",
    "--n_rollout_threads", "6", "--episode_length", "12",
    "--num_env_steps", "144", "--hidden_size", "32", "--ppo_epoch", "3",
]
STAGING = ("obs", "share_obs", "avail", "values", "actions", "logp",
           "rnn", "rnn_critic", "rewards", "active", "accum", "masks")
USE = (("obs", "use_obs"), ("share", "use_share"), ("avail", "use_avail"))
# mappo is feed-forward whatever --use_recurrent_policy says, so the
# recurrent case names rmappo
EXTRAS = [(), ("--use_centralized_V", "false"),
          ("--algorithm_name", "rmappo", "--use_recurrent_policy", "true"),
          ("--use_obs_instead_of_state", "true")]


def _port(extra=(), **kw):
    cfg = config_from_args(ARGS + list(extra) + ["--device", "cpu"], **kw)
    runner = HanabiRunner(cfg)
    runner.det_collect = True
    return runner


def _jax(extra=()):
    runner = JaxRunner(j_config_from_args(ARGS + list(extra)))
    runner._det_collect = True
    return runner


def _close(got, want, name, tol=ROLL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want.astype(np.float32), err_msg=name,
                                   **tol)


def _jax_start(jr, ts):
    obs, share, avail, _ = jr.envs.reset()
    if not jr.cfg.use_centralized_V:
        share = obs
    use, turn = jr._fresh_staging(obs, share, avail)
    return use, turn, jr._alloc_buffer()


def _jax_step(jr, ts, use, turn, bufnp, key, step, train):
    """One buffer step of JAX's host `run` (hanabi_runner.py:661-702)."""
    key, reset, scores = jr._host_round(ts, turn, use, key)
    after_round = {k: turn[k].copy() for k in STAGING}
    T, m = jr.cfg.episode_length, None
    if train:
        bufnp["share_obs"][-1] = turn["share_obs"]
        bufnp["obs"][-1] = turn["obs"]
        bufnp["available_actions"][-1] = turn["avail"]
        bufnp["active_masks"][-1] = turn["active"]
        bufnp["rewards"][:T - 1] = bufnp["rewards"][1:]
        bufnp["rewards"][-1] = turn["rewards"]
        key, k_train = jax.random.split(key)
        ts, m = jr._train_from_numpy(ts, bufnp, k_train)
        m = jax.device_get(m)
    for name, field, at in (("share_obs", "share_obs", 0), ("obs", "obs", 0),
                            ("rnn_states", "rnn", 1),
                            ("rnn_states_critic", "rnn_critic", 1),
                            ("actions", "actions", 0),
                            ("action_log_probs", "logp", 0),
                            ("value_preds", "values", 0),
                            ("rewards", "rewards", 0), ("masks", "masks", 1),
                            ("active_masks", "active", 0),
                            ("available_actions", "avail", 0)):
        bufnp[name][step + at] = turn[field]
    if reset.any():
        obs, share, avail, _ = jr.envs.reset(reset)
        if not jr.cfg.use_centralized_V:
            share = obs
        use["obs"][reset] = obs[reset]
        use["share"][reset] = share[reset]
        use["avail"][reset] = avail[reset]
        turn["masks"][reset] = 1.0
    return ts, key, reset, scores, after_round, m


@pytest.mark.parametrize("extra", EXTRAS)
def test_host_round_lockstep_with_jax(extra):
    jr, tr = _jax(extra), _port(extra)
    ts = jr.algo.init_state(jax.random.PRNGKey(7))
    t_ts = train_state_from_jax(jax.device_get(ts))
    use, turn, bufnp = _jax_start(jr, ts)
    _, c, dbuf = tr.init()
    for k, tk in USE:
        _close(c[tk], use[k], f"start {k}")
    key = jax.random.PRNGKey(3)
    T = jr.cfg.episode_length
    saw_reset = False
    for r in range(T + 1):
        step, train = r % T, r == T
        ts, key, reset, scores, staged, m = _jax_step(
            jr, ts, use, turn, bufnp, key, step, train)
        c, aux = tr._host_round(t_ts, c)
        where = f"{extra} round {r}"
        np.testing.assert_array_equal(aux["reset_choose"], reset)
        assert aux["scores"] == scores, where
        for k in STAGING:
            _close(c[k], staged[k], f"{where} {k}")
        if train:
            t_ts, t_m = tr._deferred_train(
                t_ts, c, dbuf, lambda name: contextlib.nullcontext())
        tr._write_slot(dbuf, step, c, c["masks"])
        c = tr._host_reset(c, aux["reset_choose"])
        for k, tk in USE:
            _close(c[tk], use[k], f"{where} use {k}")
        _close(c["masks"], turn["masks"], f"{where} masks after the reset")
        saw_reset = saw_reset or reset.any()
        if r == T - 1:
            for k, v in dbuf.items():
                _close(v, bufnp[k], f"episode buffer {k}")
    assert saw_reset, "no game ended"
    back = train_state_to_jax(t_ts, jax.device_get(ts))
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        for i, (a, b) in enumerate(zip(
                jax.tree_util.tree_leaves(getattr(back, part)),
                jax.tree_util.tree_leaves(getattr(ts, part)))):
            _close(np.asarray(a, np.float32), b, f"{part}[{i}]", TRAINED)
    for k in ("value_loss", "policy_loss", "dist_entropy", "actor_grad_norm",
              "critic_grad_norm"):
        _close(t_m[k], m[k], f"trained {k}", TRAINED)


@pytest.mark.parametrize("extra", EXTRAS[:3])
def test_device_round_over_the_engine_matches_host_round(extra):
    """The device round over `CppHanabiFleet` stages what the host round
    does, bit for bit; it resets in the round, the host round after it."""
    rh = _port(extra)
    rd = _port(extra, use_device_collect=True)
    assert isinstance(rd.envs, CppHanabiFleet) and not rd.host_loop
    ts, ch, _ = rh.init()
    _, cd, _ = rd.init()
    saw_reset = False
    for r in range(40):
        ch, aux_h = rh._host_round(ts, ch)
        cd, aux_d = rd._device_round(ts, cd)
        where = f"round {r}"
        np.testing.assert_array_equal(aux_d["reset_choose"].numpy(),
                                      aux_h["reset_choose"])
        for k in STAGING[:-1]:
            np.testing.assert_array_equal(cd[k].numpy(), ch[k].numpy(),
                                          err_msg=f"{where} {k}")
        np.testing.assert_array_equal(aux_d["masks_insert"].numpy(),
                                      ch["masks"].numpy())
        assert int(aux_d["score_n"]) == len(aux_h["scores"])
        assert float(aux_d["score_sum"]) == sum(aux_h["scores"])
        assert int(aux_d["true_delta"]) == aux_h["true_delta"]
        ch = rh._host_reset(ch, aux_h["reset_choose"])
        for k in ("use_obs", "use_share", "use_avail", "masks"):
            np.testing.assert_array_equal(cd[k].numpy(), ch[k].numpy(),
                                          err_msg=f"{where} {k} after reset")
        saw_reset = saw_reset or aux_h["reset_choose"].any()
    assert saw_reset


def test_scan_rounds_run_matches_host_run():
    """`run` with --use_scan_rounds on the C++ engine trains what the host
    `run` trains: the same rows and parameters, bit for bit (both draw
    actions and minibatches from one generator in the same order)."""
    extra = ("--episode_length", "8", "--num_env_steps", "288",
             "--ppo_epoch", "2", "--log_interval", "1")
    rh, rs = _port(extra), _port(extra + ("--use_scan_rounds", "true"))
    rh.det_collect = rs.det_collect = False
    ts_h, hist_h = rh.run(log_fn=None)
    ts_s, hist_s = rs.run(log_fn=None)
    assert len(hist_h) == len(hist_s) == 5
    for a, b in zip(hist_h, hist_s):
        assert {k: v for k, v in a.items() if k != "fps"} == \
            {k: v for k, v in b.items() if k != "fps"}
    for part in ("actor_params", "critic_params"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(ts_h, part)),
                        jax.tree_util.tree_leaves(getattr(ts_s, part))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_host_round_break_blanks_unvisited_seats():
    """Every game ends at seat 0, so the loop breaks before it visits seat
    1: that seat's staged values are still zeroed, and every game's critic
    state."""
    runner = _port()
    N, M = runner.N, runner.num_agents
    Do, Ds, A = runner.envs.obs_dim, runner.envs.share_dim, \
        runner.envs.n_moves

    class EveryGameEnds:
        def step(self, env_actions):
            return (np.zeros((N, Do), np.float32),
                    np.zeros((N, Ds), np.float32),
                    np.zeros((N, M, 1), np.float32), np.ones(N, bool), None,
                    np.zeros((N, A), np.float32), np.full(N, 5, np.int32))

    runner.envs = EveryGameEnds()
    ts = runner.algo.init_state(runner.init_generator, runner.device)
    rng = np.random.default_rng(0)
    c = runner._fresh_staging(*upload(
        runner.device, rng.normal(size=(N, Do)), rng.normal(size=(N, Ds)),
        np.ones((N, A))))
    c["values"] = torch.full_like(c["values"], 7.0)
    c, aux = runner._host_round(ts, c)
    assert aux["reset_choose"].all() and aux["scores"] == [5] * N
    assert not (c["values"][:, 0] == 7.0).any()
    assert (c["values"][:, 1:] == 0).all() and (c["rnn_critic"] == 0).all()


# ---------------------------------------------------------------------------
# the engine's fleets
# ---------------------------------------------------------------------------

def _drive(envs, n_steps, rng, N):
    """Steps both fleets with the same random legal moves (−1 where a game
    has none, and for a random third of the others) and resets the games
    that ended; yields each output of both."""
    out = [e.reset() for e in envs]
    yield "reset", out
    avail = out[0][2]
    for t in range(n_steps):
        acts = np.array([rng.choice(np.flatnonzero(a)) if a.any() else -1
                         for a in avail], np.int64)
        acts[rng.random(N) < 1 / 3] = -1
        out = [e.step(acts) for e in envs]
        yield f"step {t}", out
        avail, done = out[0][5], out[0][3]
        if done.any():
            out = [e.reset(done) for e in envs]
            yield f"reset {t}", out
            avail = out[0][2]


PRESETS = sorted(t_env.PRESETS)


@pytest.mark.parametrize("obs_instead", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_vec_env_matches_jax(preset, obs_instead):
    assert t_env.PRESETS == j_env.PRESETS
    N = 5
    envs = [m.HanabiVecEnv(preset, 2, N, seed=11,
                           use_obs_instead_of_state=obs_instead)
            for m in (t_env, j_env)]
    for k in ("obs_dim", "share_dim", "n_moves"):
        assert getattr(envs[0], k) == getattr(envs[1], k), k
    for k in ("observation_space", "share_observation_space",
              "action_space"):
        assert [vars(x) for x in getattr(envs[0], k)] == \
            [vars(x) for x in getattr(envs[1], k)], k
    ended = 0
    for where, (got, want) in _drive(envs, 60, np.random.default_rng(2), N):
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.shape == b.shape, (where, i)
            np.testing.assert_array_equal(a, b, err_msg=f"{where} [{i}]")
        ended += where.startswith("reset ")
    assert ended > 0
    for e in envs:
        e.close()


@pytest.mark.parametrize("preset", PRESETS)
def test_single_env_matches_jax(preset):
    envs = [m.HanabiSingleEnv(preset, 3, seed=5) for m in (t_env, j_env)]
    rng = np.random.default_rng(4)
    seen = [e.reset() for e in envs]
    games = 1
    for t in range(80):
        for a, b in zip(*seen):
            np.testing.assert_array_equal(a, b, err_msg=f"step {t}")
        a = int(rng.choice(np.flatnonzero(seen[0][2])))
        out = [e.step(np.full((3, 1), a, np.float32)) for e in envs]
        assert out[0][4] == out[1][4], f"step {t} info"
        for i in (0, 1, 2, 3, 5):
            np.testing.assert_array_equal(out[0][i], out[1][i],
                                          err_msg=f"step {t} [{i}]")
        if out[0][3].all():
            seen = [e.reset() for e in envs]
            games += 1
        else:
            seen = [(o[0], o[1], o[5]) for o in out]
    assert games > 1
    for e in envs:
        e.close()


# ---------------------------------------------------------------------------
# evaluation, scripts, binding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["mappo", "rmappo"])
def test_evaluate_matches_jax(algo):
    extra = ("--algorithm_name", algo)
    jr, tr = _jax(extra), _port(extra)
    ts = jr.algo.init_state(jax.random.PRNGKey(5))
    t_ts = train_state_from_jax(jax.device_get(ts))
    want = jr.evaluate(ts, 8)
    got = tr.evaluate(t_ts, 8)
    assert got == want and 0.0 <= got <= 10.0
    # on a fleet handed in, as --use_eval's
    env = t_env.HanabiVecEnv("Hanabi-Small", 2, 3, seed=50000)
    j_eval = j_env.HanabiVecEnv("Hanabi-Small", 2, 3, seed=50000)
    assert tr.evaluate(t_ts, 8, env=env) == jr.evaluate(ts, 8, env=j_eval)


def test_scripts_train_with_eval_then_evaluate(tmp_path, monkeypatch):
    monkeypatch.setenv("ONPOLICY_TORCH_RESULTS", str(tmp_path))
    small = ["--hanabi_name", "Hanabi-Small", "--n_rollout_threads", "4",
             "--episode_length", "6", "--hidden_size", "16",
             "--ppo_epoch", "1", "--log_interval", "1", "--device", "cpu"]
    argv = train_hanabi.CONFIGS["hanabi_forward"] + small + [
        "--num_env_steps", str(2 * 4 * 6), "--use_eval", "--eval_interval",
        "1", "--eval_episodes", "4", "--n_eval_rollout_threads", "2"]
    state, history = train_hanabi.main(argv)
    assert [r["episode"] for r in history] == [1]
    row = history[0]
    assert np.isfinite(row["value_loss"]) and 0.0 <= row["eval_average_score"]
    models = next(tmp_path.rglob("mappo/**/models"))
    score = eval_hanabi.main(eval_hanabi.EVAL_FORWARD + small[:-2] + [
        "--device", "cpu", "--model_dir", str(models), "--eval_games", "5"])
    assert 0.0 <= score <= 10.0


def test_binding_builds_into_the_ports_build_dir(tmp_path, monkeypatch):
    lib = binding.load_library()
    assert lib._name == str(binding.BUILD_DIR / "libhanabi.so")
    assert binding.BUILD_DIR == (
        binding.CPP_DIR.parents[1] / "onpolicy_torch" / "_build")
    # a build from a copy of the sources, and again when one is newer
    src = tmp_path / "src"
    shutil.copytree(binding.CPP_DIR, src,
                    ignore=shutil.ignore_patterns("*.so", "test_hanabi*"))
    monkeypatch.setattr(binding, "CPP_DIR", src)
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    so = binding.build()
    assert so == tmp_path / "build" / "libhanabi.so" and so.exists()
    assert not list(src.glob("*.so"))
    first = so.stat().st_mtime_ns
    assert binding.build().stat().st_mtime_ns == first
    later = so.stat().st_mtime + 10
    os.utime(src / "hanabi.h", (later, later))
    assert binding.build().stat().st_mtime_ns != first
    assert not list((tmp_path / "build").glob("*.tmp"))
