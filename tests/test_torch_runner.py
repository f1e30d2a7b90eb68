"""The runners' host loop and the trainer at several minibatches.

* rMAPPO `train()` at num_mini_batch=2 against JAX's, each epoch's chunk
  permutation computed from JAX's key and handed to the port (trained
  state at rtol 1e-4 / atol 5e-5, as tests/test_torch_slice.py).
* The shared runner's deterministic eval return against JAX's
  `_eval_episode` from the same initial worlds (1e-5).
* `episodes_per_call=2`: its rows are the E=1 run's rows averaged over
  each pair of episodes, on the `% E` schedule, eval included.
* `profile_dir` writes a trace of the episodes 2 <= episode < 2 + E,
  the program's spans in it.
* `scripts/train_mpe` runs the new configurations end to end on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.envs.mpe import golden
from onpolicy_tpu.envs.mpe import make_vec_env as j_make_vec_env
from onpolicy_tpu.runner.shared_runner import SharedRunner as JaxRunner

from onpolicy_torch import buffer as t_buf
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.scripts import train_mpe
from onpolicy_torch.utils import profiling
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         train_state_to_jax,
                                         world_state_from_jax)

torch.set_num_threads(1)

ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
N, T = 4, 25
FLAGS = dict(algorithm_name="rmappo", scenario_name="simple_spread",
             num_agents=3, num_landmarks=3, n_rollout_threads=N,
             episode_length=T, num_env_steps=N * T, hidden_size=16,
             data_chunk_length=10, ppo_epoch=3, use_ReLU=False, lr=7e-4,
             critic_lr=7e-4, n_eval_rollout_threads=N)


def _close(got, want, name, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


def _jax_runner(**kw):
    cfg = j_canon(JaxConfig(**{**FLAGS, **kw})).validate()
    return JaxRunner(cfg, eval_env=j_make_vec_env(cfg, n_envs=N))


def _port_runner(**kw):
    cfg = canonicalize_algorithm(Config(**{**FLAGS, **kw}, device="cpu"))
    eval_env = make_vec_env(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(1), n_envs=N)
    return SharedRunner(cfg, eval_env=eval_env)


def _port_buffer(jb) -> t_buf.RolloutBuffer:
    return t_buf.RolloutBuffer(**{
        k: None if getattr(jb, k) is None else torch.tensor(
            np.asarray(getattr(jb, k)))
        for k in t_buf.RolloutBuffer.__dataclass_fields__})


@pytest.mark.parametrize("scenario", ["simple_spread", "simple_reference"])
def test_train_at_two_minibatches_matches_jax(scenario):
    """One episode's buffer from JAX's runner, trained by both with 2
    minibatches of 15 chunks; simple_reference adds the MultiDiscrete
    (5, 10) head's per-head ratios."""
    agents = 3 if scenario == "simple_spread" else 2
    jr = _jax_runner(num_mini_batch=2, scenario_name=scenario,
                     num_agents=agents)
    state, carry = jr.init(jax.random.PRNGKey(0))
    captured = {}
    train = jr.algo.train

    def capture(ts, buf, key, factor=None):
        captured.update(buf=buf, key=key)
        return train(ts, buf, key, factor)
    jr.algo.train = capture
    new_state, _, metrics = jr._episode(state, carry, jax.random.PRNGKey(7))
    buf, key = jax.device_get(captured["buf"]), captured["key"]
    n_chunks = T * N * agents // 10
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, n_chunks)))
             for k in jax.random.split(key, 3)]

    runner = _port_runner(num_mini_batch=2, scenario_name=scenario,
                          num_agents=agents)
    got, got_metrics = runner.algo.train(
        train_state_from_jax(jax.device_get(state)), _port_buffer(buf), None,
        perms=perms)
    want = jax.device_get(new_state)
    back = train_state_to_jax(got, want)
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        for i, (a, b) in enumerate(zip(
                jax.tree_util.tree_leaves(getattr(back, part)),
                jax.tree_util.tree_leaves(getattr(want, part)))):
            _close(a, b, f"{part}[{i}]", TRAINED)
    for k, v in got_metrics.items():
        _close(float(v), float(metrics[k]), k, TRAINED)


@pytest.mark.parametrize("scenario", ["simple_spread", "simple_reference"])
def test_eval_return_matches_jax(scenario):
    agents = 3 if scenario == "simple_spread" else 2
    jr = _jax_runner(scenario_name=scenario, num_agents=agents, gain=1.0)
    state, _ = jr.init(jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(9)
    _, k_reset = jax.random.split(key)
    worlds, _ = jr.eval_envs.reset(k_reset)
    want = float(jr._eval_episode(state, key))
    runner = _port_runner(scenario_name=scenario, num_agents=agents,
                          gain=1.0)
    got = runner.eval_episode(train_state_from_jax(jax.device_get(state)),
                              world_state_from_jax(jax.device_get(worlds)))
    _close(float(got), want, "eval return", ROLL)
    # from golden worlds too: the eval env's own draws play no part
    np.random.seed(4)
    env = jr.eval_envs.env
    golden_worlds = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x),
        *[golden.reference_reset(scenario, env.spec) for _ in range(N)])
    assert np.isfinite(float(runner.eval_episode(
        train_state_from_jax(jax.device_get(state)),
        world_state_from_jax(jax.device_get(golden_worlds)))))


def test_episodes_per_call_averages_and_keeps_the_schedule():
    kw = dict(num_env_steps=4 * N * T, ppo_epoch=1, log_interval=1,
              use_eval=True, eval_interval=1)
    _, rows1 = _port_runner(**kw).run(log_fn=None)
    _, rows2 = _port_runner(**kw, episodes_per_call=2).run(log_fn=None)
    assert [r["episode"] for r in rows1] == [0, 1, 2, 3]
    assert [r["episode"] for r in rows2] == [0, 2]
    assert [r["steps"] for r in rows2] == [2 * N * T, 4 * N * T]
    for row, pair in zip(rows2, (rows1[:2], rows1[2:])):
        assert set(row) == set(pair[0])
        for k in set(row) - {"episode", "steps", "fps",
                             "eval_average_episode_rewards"}:
            _close(row[k], (pair[0][k] + pair[1][k]) / 2, k,
                   dict(rtol=1e-6, atol=1e-7))
        assert np.isfinite(row["eval_average_episode_rewards"])
    # 6 episodes at E=2, logging every 4: the calls at 0 and 4 log, the
    # call at 2 does not (2 % 4 >= E)
    _, rows = _port_runner(**{**kw, "log_interval": 4, "use_eval": False,
                              "num_env_steps": 6 * N * T},
                           episodes_per_call=2).run(log_fn=None)
    assert [r["episode"] for r in rows] == [0, 4]


def test_profile_dir_writes_a_trace(tmp_path):
    _port_runner(num_env_steps=3 * N * T, ppo_epoch=1,
                 profile_dir=str(tmp_path / "prof")).run(log_fn=None)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    # the program's spans show in the trace, and their log is not held
    assert {"rollout.act", "rollout.env", "update.forward",
            "update.optimizer"} <= names
    assert profiling.take() == {"spans": [], "counters": {}}


def test_shared_runner_sends_happo_to_the_separated_runner():
    with pytest.raises(ValueError, match="separated runner"):
        _port_runner(algorithm_name="happo")


@pytest.mark.parametrize("config", ["reference", "comm", "happo_spread"])
def test_train_mpe_runs_the_new_configs(config, tmp_path, monkeypatch):
    monkeypatch.setenv("ONPOLICY_TORCH_RESULTS", str(tmp_path))
    argv = train_mpe.CONFIGS[config] + [
        "--n_rollout_threads", "4", "--num_env_steps", str(2 * 4 * 25),
        "--ppo_epoch", "1", "--hidden_size", "16", "--log_interval", "1",
        "--use_eval", "--eval_interval", "1", "--n_eval_rollout_threads", "2",
        "--device", "cpu"]
    _, history = train_mpe.main(argv)
    assert [r["episode"] for r in history] == [0, 1]
    for row in history:
        assert all(np.isfinite(v) for v in row.values()
                   if isinstance(v, float)), row
        assert "eval_average_episode_rewards" in row
    lines = list((tmp_path).rglob("metrics.jsonl"))
    assert len(lines) == 1 and len(lines[0].read_text().splitlines()) == 2
