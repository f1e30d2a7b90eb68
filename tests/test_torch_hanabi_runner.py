"""The port's Hanabi runner against the JAX package's, on the CPU.

At the size of tests/test_hanabi_device_collect.py (Hanabi-Small, 2
agents, 6 fleets, T=12, hidden 32), the same parameters (carried by
`utils/params.py`), deterministic actions (each policy's mode) and the
same decks: JAX draws them from its keys, and the test reads them out of
JAX's states (or replays JAX's key chain) and hands them to the port.
  * `_device_round`, recurrent (rmappo) and feed-forward (mappo): every
    staging field, reset_choose, masks_insert, the score and true-step
    counts and the engine state after each of 24 rounds, at the rollout
    tolerance (rtol/atol 1e-5);
  * `_device_episode`, untrained then trained (deferred training with 3
    PPO epochs): the buffer after the untrained episode at 1e-5; the
    trained state, the metrics and the buffer after the trained one at
    rtol 1e-4 / atol 5e-5; in bf16 (feed-forward, as `bench_hanabi_width`)
    the update itself within 0.25 of its norm, the trained state and
    outputs at the bf16 model limit 0.05.
Then the runner's own mechanics, as tests/test_jax_hanabi.py checks the
JAX package's: a short run, a resume, `evaluate_device`, the scripts, and
one round of each round loop over each engine (the host path itself is
held to JAX's in tests/test_torch_hanabi_host.py).
"""
import jax
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import config_from_args as j_config_from_args
from onpolicy_tpu.runner.hanabi_runner import HanabiRunner as JaxRunner

from onpolicy_torch import buffer as t_buf
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.runner.hanabi_runner import HanabiRunner
from onpolicy_torch.scripts import eval_hanabi, train_hanabi
from onpolicy_torch.utils.params import train_state_from_jax, train_state_to_jax

torch.set_num_threads(1)

ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
MODEL = dict(rtol=0.05, atol=0.05)
FLAGS = dict(env_name="Hanabi", scenario_name="Hanabi-Small", num_agents=2,
             n_rollout_threads=6, episode_length=12, num_env_steps=144,
             hidden_size=32, ppo_epoch=3, use_jax_env=True,
             use_scan_rounds=True)
STAGING = ("obs", "share_obs", "avail", "values", "actions", "logp", "rnn",
           "rnn_critic", "rewards", "active", "accum", "masks", "use_obs",
           "use_share", "use_avail")


def _args(flags):
    out = []
    for k, v in flags.items():
        out += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return out


def _runners(**kw):
    flags = {**FLAGS, **kw}
    jr = JaxRunner(j_config_from_args(_args(flags)))
    jr._det_collect = True
    tr = HanabiRunner(canonicalize_algorithm(Config(**flags, device="cpu")))
    tr.det_collect = True
    return jr, tr


def _close(got, want, name, tol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               err_msg=name, **tol)


def _start(jr, tr, key):
    """JAX's init_device and the port's init from the same decks and
    parameters."""
    ts, carry, dbuf = jr.init_device(key)
    t_ts, t_carry, t_dbuf = tr.init(torch.tensor(np.asarray(
        carry["env_states"].deck)))
    t_ts = train_state_from_jax(jax.device_get(ts))
    return (ts, carry, dbuf), (t_ts, t_carry, t_dbuf)


def _compare_env(jst, tst, where):
    for k, v in tst.tensors().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jst, k)),
                                      err_msg=f"{where} env {k}")


def _compare_carry(jc, tc, where, tol):
    for k in STAGING:
        _close(tc[k], jc[k], f"{where} {k}", tol)
    _compare_env(jc["env_states"], tc["env_states"], where)


def _compare_buffer(jb, tb, where, tol):
    for k, v in tb.items():
        _close(v, jb[k], f"{where} buffer {k}", tol)


@pytest.mark.parametrize("algo", ["rmappo", "mappo"])
def test_device_round_matches_jax(algo):
    jr, tr = _runners(algorithm_name=algo)
    (ts, jc, _), (t_ts, tc, _) = _start(jr, tr, jax.random.PRNGKey(0))
    round_jit = jax.jit(jr._device_round)
    key = jax.random.PRNGKey(3)
    saw_reset = False
    for r in range(24):
        jc, aux = round_jit(ts, jc, key)
        key = aux["key"]
        tc, t_aux = tr._device_round(t_ts, tc, torch.tensor(np.asarray(
            jc["env_states"].deck)))
        where = f"{algo} round {r}"
        np.testing.assert_array_equal(t_aux["reset_choose"].numpy(),
                                      np.asarray(aux["reset_choose"]))
        for k in ("masks_insert", "score_sum", "score_n", "true_delta"):
            _close(t_aux[k], aux[k], f"{where} {k}", ROLL)
        _compare_carry(jc, tc, where, ROLL)
        saw_reset = saw_reset or bool(t_aux["reset_choose"].any())
    assert saw_reset


def _episode_decks(jr, key, do_train):
    """The decks JAX's `_device_episode(..., key, do_train)` resets from,
    by replaying its key chain: each round splits its key once per seat,
    then once for the masked reset; the deferred training takes one split
    after round 0. Returns (decks, the episode's final key)."""
    decks = []
    for t in range(jr.cfg.episode_length):
        for _ in range(jr.num_agents):
            key, _ = jax.random.split(key)
        key, k_reset = jax.random.split(key)
        decks.append(torch.tensor(np.asarray(
            jr.envs.reset_states(k_reset).deck)))
        if t == 0 and do_train:
            key, _ = jax.random.split(key)
    return decks, key


def _episodes(algo, **kw):
    """An untrained and a trained episode in both packages; returns what
    each produced after each."""
    jr, tr = _runners(algorithm_name=algo, **kw)
    (ts, jc, jb), (t_ts, tc, tb) = _start(jr, tr, jax.random.PRNGKey(1))
    out = []
    key = jax.random.PRNGKey(4)
    for do_train in (False, True):
        ep = jax.jit(lambda t, c, b, k, d=do_train: jr._device_episode(
            t, c, b, k, d))
        decks, want_key = _episode_decks(jr, key, do_train)
        ts, jc, jb, key, jm = ep(ts, jc, jb, key)
        np.testing.assert_array_equal(np.asarray(key), np.asarray(want_key))
        t_ts, tc, tb, tm = tr._device_episode(t_ts, tc, tb, do_train, decks)
        # the port writes its buffer in place: keep this episode's copy
        out.append(((jax.device_get(ts), jc, jb, jax.device_get(jm)),
                    (t_ts, tc, {k: v.clone() for k, v in tb.items()}, tm)))
    return out


def _compare_train_state(got, want, tol):
    back = train_state_to_jax(got, want)
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        for i, (a, b) in enumerate(zip(
                jax.tree_util.tree_leaves(getattr(back, part)),
                jax.tree_util.tree_leaves(getattr(want, part)))):
            _close(np.asarray(a, np.float32), b, f"{part}[{i}]", tol)


@pytest.mark.parametrize("algo", ["rmappo", "mappo"])
def test_episode_matches_jax(algo):
    (first_j, first_t), (trained_j, trained_t) = _episodes(algo)
    _compare_buffer(first_j[2], first_t[2], "untrained", ROLL)
    _compare_carry(first_j[1], first_t[1], "untrained", ROLL)
    for k in ("_score_sum", "_score_n", "_true_delta"):
        _close(first_t[3][k], first_j[3][k], k, ROLL)
    _compare_train_state(trained_t[0], trained_j[0], TRAINED)
    for k, v in trained_t[3].items():
        _close(v, trained_j[3][k], f"trained {k}", TRAINED)
    _compare_buffer(trained_j[2], trained_t[2], "trained", TRAINED)


def _update_err(before_t, after_t, before_j, after_j, part):
    """|update_port - update_jax| / |update_jax| over all leaves of one
    network's parameters, the update being new - old parameters."""
    leaves = lambda ts, ref: [np.asarray(a, np.float64).ravel() for a in
                              jax.tree_util.tree_leaves(getattr(
                                  train_state_to_jax(ts, ref), part))]
    jleaves = lambda ts: [np.asarray(a, np.float64).ravel() for a in
                          jax.tree_util.tree_leaves(getattr(ts, part))]
    d_t = np.concatenate([a - b for a, b in zip(
        leaves(after_t, after_j), leaves(before_t, before_j))])
    d_j = np.concatenate([a - b for a, b in zip(
        jleaves(after_j), jleaves(before_j))])
    return np.linalg.norm(d_t - d_j) / np.linalg.norm(d_j)


def test_bf16_feed_forward_episode_matches_jax():
    """`bench_hanabi_width`'s model at small width: feed-forward MAPPO in
    bf16, its trained episode against JAX's bf16 model. Three Adam steps
    move a parameter by ~2e-3, far below the bf16 model limit 0.05, so the
    update itself (new - old parameters of each network) is held to
    JAX's by the norm of the difference over the norm of JAX's update, at
    most 0.25, the limit `chip_smoke.py` holds the bf16 update to between
    card and CPU (a missing update reads 1, one of the wrong sign 2; on
    the CPU it reads 7.3e-3 for the actor and 2.4e-2 for the critic). The
    state and the outputs are held at 0.05."""
    (first_j, first_t), (trained_j, trained_t) = _episodes(
        "mappo", use_bf16=True)
    for part in ("actor_params", "critic_params"):
        err = _update_err(first_t[0], trained_t[0], first_j[0],
                          trained_j[0], part)
        assert err <= 0.25, f"bf16 {part} update differs by {err:.3g}"
    _compare_train_state(trained_t[0], trained_j[0], MODEL)
    for k in ("value_loss", "dist_entropy", "average_step_rewards"):
        _close(trained_t[3][k], trained_j[3][k], f"bf16 {k}", MODEL)
    _compare_buffer(trained_j[2], trained_t[2], "bf16 trained", MODEL)


# ---------------------------------------------------------------------------
# the runner's own mechanics
# ---------------------------------------------------------------------------

def _port_runner(**kw):
    flags = {**FLAGS, "algorithm_name": "mappo", "n_rollout_threads": 8,
             "episode_length": 8, "num_env_steps": 256, "ppo_epoch": 2,
             "log_interval": 1, **kw}
    return HanabiRunner(canonicalize_algorithm(Config(**flags, device="cpu")))


@pytest.mark.parametrize("algo", ["rmappo", "mappo"])
def test_short_run_trains(algo):
    _, history = _port_runner(algorithm_name=algo).run(log_fn=None)
    assert [r["episode"] for r in history] == [1, 2, 3]
    for row in history:
        assert np.isfinite(row["value_loss"]) and np.isfinite(row["policy_loss"])
        assert 0.0 <= row["average_score"] <= 10.0
    assert history[-1]["true_steps"] > history[0]["true_steps"] > 0


def test_resume_continues_past_the_checkpoint(tmp_path):
    d = str(tmp_path)
    r1 = _port_runner()
    r1.run(log_fn=None, save_dir=d)
    r2 = _port_runner(num_env_steps=384, model_dir=d)
    _, history = r2.run(log_fn=None)
    # episode 4, the first after the resume, collects only
    assert [r["episode"] for r in history] == [4, 5]
    assert "value_loss" not in history[0]
    assert np.isfinite(history[1]["value_loss"])
    assert history[0]["true_steps"] > r1.true_total_num_steps > 0


def test_evaluate_device_valid_and_deterministic():
    r = _port_runner(scenario_name="Hanabi-Very-Small", n_rollout_threads=16,
                     episode_length=4, hidden_size=32)
    ts = r.algo.init_state(r.init_generator, r.device)
    g = lambda: torch.Generator().manual_seed(9)
    s1 = r.evaluate_device(ts, 32, g())
    s2 = r.evaluate_device(ts, 32, g())
    assert s1 == s2 and 0.0 <= s1 <= 5.0


def test_scripts_train_and_eval(tmp_path, monkeypatch):
    monkeypatch.setenv("ONPOLICY_TORCH_RESULTS", str(tmp_path))
    small = ["--hanabi_name", "Hanabi-Small", "--n_rollout_threads", "4",
             "--episode_length", "6", "--hidden_size", "16",
             "--layer_N", "1", "--ppo_epoch", "1", "--log_interval", "1",
             "--device", "cpu"]
    for name in ("hanabi_device", "bench_hanabi_width"):
        argv = train_hanabi.CONFIGS[name] + small + [
            "--num_env_steps", str(2 * 4 * 6)]
        _, history = train_hanabi.main(argv)
        assert [r["episode"] for r in history] == [1]
        assert np.isfinite(history[0]["value_loss"])
    models = next(tmp_path.rglob("rmappo/**/models"))
    score = eval_hanabi.main(train_hanabi.CONFIGS["hanabi_device"] + small + [
        "--model_dir", str(models), "--eval_games", "8"])
    assert 0.0 <= score <= 10.0


@pytest.mark.parametrize("flags", [
    dict(use_jax_env=False),
    dict(use_scan_rounds=False),
    dict(use_jax_env=True, use_scan_rounds=False, use_device_collect=False),
])
def test_every_round_loop_runs_a_round(flags):
    """The C++ engine through the device round, and the tensor engine and
    the C++ engine through the host seat loop: each runner builds and
    runs one round."""
    r = _port_runner(**flags)
    assert r.host_loop == (not r.cfg.use_scan_rounds)
    ts, carry, _ = r.init()
    if r.host_loop:
        carry, aux = r._host_round(ts, carry)
        true_delta = aux["true_delta"]
    else:
        carry, aux = r._device_round(ts, carry)
        true_delta = int(aux["true_delta"])
    # every game moves at seat 0; one that ends there skips seat 1
    assert r.N <= true_delta <= r.N * r.num_agents
    assert torch.isfinite(carry["values"]).all()
    assert (carry["active"] == 1).any()


@pytest.mark.parametrize("flags", [dict(episodes_per_call=2),
                                   dict(profile_dir="trace")])
def test_flags_the_hanabi_runner_does_not_take_raise(flags):
    with pytest.raises(ValueError, match="profile_episode"):
        _port_runner(**flags)


def test_the_buffer_is_the_ports():
    """The runner's buffer dict holds exactly the port's RolloutBuffer
    fields that collection fills."""
    tr = _port_runner()
    fields = set(t_buf.RolloutBuffer.__dataclass_fields__)
    assert set(tr._alloc_buffer()) == fields - {"returns", "advantages"}
