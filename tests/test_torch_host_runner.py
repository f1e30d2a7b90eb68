"""The port's HostSharedRunner against the JAX package's, on the CPU.

One episode in lockstep (N=4 envs of `ScriptedSmacEnv`, 3 agents, T=20,
L=10, H=16, 2 PPO epochs; `ScriptedFootballEnv` for the 4-tuple
protocol): both runners start from the same train state (JAX's, carried
across by `utils/params.py`) and the same env reset; JAX runs its own
`run_episode` with its `_train_fn` wrapped to capture the buffer and the
bootstrap value, and the port's rollout takes JAX's sampled actions.
Compared: the staged buffer (obs, share_obs, rnn states, actions,
log-probs, values, rewards, masks, active_masks, bad_masks, available
actions) and the returns at rtol/atol 1e-5; the carry after the episode;
the trained state (parameters, Adam moments, ValueNorm) and the update's
metrics at rtol 1e-4 / atol 5e-5 (tests/test_torch_slice.py says why);
`average_step_rewards`, `dead_ratio` and the stateful `incre_win_rate`;
the deterministic eval of JAX's trained state at 1e-5. Cases: rMAPPO
(the port over worker processes, JAX in process), MAPPO, MAT and rMAPPO
on the 4-tuple protocol.

Also: a run saves and resumes exactly; `train_smac.main` (StarCraft2 and
StarCraft2v2, one thread and two, stacked frames, eval) and
`train_football.main` run end to end over the engine stand-ins of
`chip_smoke.py` on the CPU.
"""
import math
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from onpolicy_tpu.config import config_from_args as j_config_from_args
from onpolicy_tpu.envs import host_vec as j_host_vec
from onpolicy_tpu.envs.starcraft2.smac_env import \
    smac_win_rate_metrics as j_win_rate
from onpolicy_tpu.runner.host_runner import HostSharedRunner as JaxRunner
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch.config import config_from_args
from onpolicy_torch.envs import host_vec
from onpolicy_torch.envs.starcraft2.smac_env import smac_win_rate_metrics
from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.runner.host_runner import HostSharedRunner
from onpolicy_torch.scripts import train_football, train_smac
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.params import train_state_from_jax, \
    train_state_to_jax
from onpolicy_torch.utils.tree import tree_leaves
from tests.test_torch_host_vec import ScriptedFootballEnv, ScriptedSmacEnv

torch.set_num_threads(1)

ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
N, T = 4, 20
CASES = {
    "rmappo": dict(algo="rmappo", env=ScriptedSmacEnv, protocol="share",
                   pool="HostVecEnv"),
    "mappo": dict(algo="mappo", env=ScriptedSmacEnv, protocol="share",
                  pool="DummyVecEnv"),
    "mat": dict(algo="mat", env=ScriptedSmacEnv, protocol="share",
                pool="DummyVecEnv"),
    "rmappo_basic": dict(algo="rmappo", env=ScriptedFootballEnv,
                         protocol="basic", pool="DummyVecEnv"),
}
BUFFER = ("share_obs", "obs", "rnn_states", "rnn_states_critic", "actions",
          "action_log_probs", "value_preds", "rewards", "masks",
          "active_masks", "bad_masks", "available_actions", "returns",
          "advantages")


def _argv(algo, **over):
    flags = {"algorithm_name": algo, "episode_length": T,
             "n_rollout_threads": N, "num_env_steps": N * T,
             "hidden_size": 16, "data_chunk_length": 10, "ppo_epoch": 2,
             "num_mini_batch": 1, "n_embd": 16, "lr": 7e-4,
             "critic_lr": 7e-4, "seed": 1, "eval_episodes": 5, **over}
    return [a for k, v in flags.items() for a in (f"--{k}", str(v))]


def _pool(mod, spaces, case, seed0=0, n=N, **env_kw):
    c = CASES[case]
    return getattr(mod, c["pool"] if mod is host_vec else "DummyVecEnv")(
        [lambda s=seed0 + i: c["env"](s, spaces=spaces, **env_kw)
         for i in range(n)], protocol=c["protocol"])


def _close(got, want, name, tol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=name,
                               **tol)


def _jax_episode(case):
    c = CASES[case]
    cfg = j_config_from_args(_argv(c["algo"]))
    env = _pool(j_host_vec, j_sp, case)
    eval_env = _pool(j_host_vec, j_sp, case, seed0=50, n=3)
    runner = JaxRunner(cfg, env, eval_env=eval_env, env_metrics=j_win_rate())
    state, start = runner.init(jax.random.PRNGKey(0))
    captured = {}
    train_fn = runner._train_fn

    def spy(ts, buf, next_values, key):
        captured.update(buf=buf, next_values=next_values)
        return train_fn(ts, buf, next_values, key)
    runner._train_fn = spy
    new_state, new_start, metrics = runner.run_episode(
        state, start, jax.random.PRNGKey(7))
    buf = captured["buf"].compute_returns(
        captured["next_values"], state.vnorm, gamma=cfg.gamma,
        gae_lambda=cfg.gae_lambda, use_gae=cfg.use_gae,
        use_proper_time_limits=cfg.use_proper_time_limits)
    get = jax.device_get
    evaluation = runner.evaluate(new_state, jax.random.PRNGKey(3),
                                 eval_episodes=5)
    env.close()
    eval_env.close()
    return dict(state=get(state), start=start, buf=get(buf),
                new_state=get(new_state), new_start=new_start,
                metrics=metrics, eval=evaluation)


@pytest.mark.parametrize("case", sorted(CASES))
def test_episode_matches_jax_in_lockstep(case):
    j = _jax_episode(case)
    cfg = config_from_args(_argv(CASES[case]["algo"]) + ["--device", "cpu"])
    env = _pool(host_vec, sp, case)
    eval_env = _pool(host_vec, sp, case, seed0=50, n=3)
    try:
        runner = HostSharedRunner(cfg, env, eval_env=eval_env,
                                  env_metrics=smac_win_rate_metrics())
        _, start = runner.init()
        for k in ("obs", "share_obs", "avail", "masks", "active", "bad"):
            if j["start"][k] is None:
                assert start[k] is None, k
            else:
                np.testing.assert_array_equal(start[k], j["start"][k], k)
        state = train_state_from_jax(j["state"])
        jb = j["buf"]
        inject = [{"actions": np.asarray(jb.actions[t])} for t in range(T)]
        n0 = cuda_gru.FWD_LAUNCHES
        carry, buf, infos = runner.rollout(state, start, inject)
        for k in BUFFER:
            want = getattr(jb, k)
            if want is None:
                assert getattr(buf, k) is None, k
                continue
            _close(getattr(buf, k), want, f"buffer {k}", ROLL)
        assert (np.asarray(jb.active_masks) == 0).any() \
            == (CASES[case]["protocol"] == "share")
        if CASES[case]["protocol"] == "share":
            assert (np.asarray(jb.bad_masks) == 0).any()
        assert (np.asarray(jb.masks) == 0).any()
        ns = j["new_start"]
        for k in ("obs", "share_obs", "masks", "active", "bad"):
            np.testing.assert_array_equal(carry[k], ns[k], k)
        for k in ("rnn_a", "rnn_c"):
            _close(carry[k].reshape(np.shape(ns[k])), ns[k], k, ROLL)

        new_state, m = runner.update(state, buf)
        assert cuda_gru.FWD_LAUNCHES == n0          # CPU: no kernel
        metrics = runner._episode_metrics(m, infos)
        assert metrics.keys() == j["metrics"].keys()
        for k, v in j["metrics"].items():
            tol = TRAINED if k in m else ROLL
            _close(metrics[k], v, k, tol)
        back = train_state_to_jax(new_state, j["new_state"])
        parts = ("params", "opt_state", "vnorm") if case == "mat" else (
            "actor_params", "critic_params", "actor_opt_state",
            "critic_opt_state", "vnorm")
        for part in parts:
            got = jax.tree_util.tree_leaves(getattr(back, part))
            want = jax.tree_util.tree_leaves(getattr(j["new_state"], part))
            assert len(got) == len(want), part
            for i, (a, b) in enumerate(zip(got, want)):
                _close(a, b, f"{part}[{i}]", TRAINED)

        evaluation = runner.evaluate(train_state_from_jax(j["new_state"]))
        assert evaluation.keys() == j["eval"].keys()
        for k, v in j["eval"].items():
            _close(evaluation[k], v, k, ROLL)
    finally:
        env.close()
        eval_env.close()


def _resume_runner(steps, **over):
    cfg = config_from_args(_argv("rmappo", num_env_steps=steps,
                                 **over) + ["--device", "cpu"])
    # episodes as long as the rollout: every episode boundary is an env
    # reset, which a restarted pool reproduces
    env = host_vec.DummyVecEnv(
        [lambda s=i: ScriptedSmacEnv(s, limit=T, decisive=False, spaces=sp)
         for i in range(N)], protocol="share")
    return HostSharedRunner(cfg, env, env_metrics=smac_win_rate_metrics())


def test_checkpoint_resume_is_exact(tmp_path):
    """Two episodes in one run equal one episode, a save and a resumed run
    of one more: the state, the generators and the staging carry go
    through the checkpoint."""
    whole = _resume_runner(2 * N * T)
    state_a, hist_a = whole.run(log_fn=None, save_dir=tmp_path / "a")
    _resume_runner(N * T).run(log_fn=None, save_dir=tmp_path / "b")
    resumed = _resume_runner(2 * N * T, model_dir=str(tmp_path / "b"))
    state_b, hist_b = resumed.run(log_fn=None)
    assert resumed.start_episode == 1
    assert [h["episode"] for h in hist_b] == [1]
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state"):
        for x, y in zip(tree_leaves(getattr(state_a, part)),
                        tree_leaves(getattr(state_b, part))):
            assert torch.equal(x, y), part
    assert hist_a[-1] == {**hist_b[-1], "fps": hist_a[-1]["fps"]}


@pytest.mark.parametrize("T_,B", [(10, 2560), (10, 80), (400, 2),
                                  (10, 1500)])
def test_plans_take_the_tensor_core_kernels_at_the_host_shapes(T_, B):
    """SMAC 3s5z rMAPPO (B=2,560), SMACv2 HAPPO per agent (B=80) and its
    whole-episode log-probs (T=400, B=2, below one tile), GRF 3v1's
    minibatch (B=1,500), H=64: both plans take the tensor-core kernels on
    an H100 (132 SMs, 232,448 shared bytes a block)."""
    f = cuda_gru.fwd_plan(B, 64, 132, 232_448)
    b = cuda_gru.bwd_plan(B, 64, 132, 232_448, 4, T_)
    assert f.name == b.name == "tensor_core"
    assert f.grid == min(-(-B // f.bt), 2 * 132) and f.grid >= 1
    assert b.bt == (16 if -(-B // 16) >= 132 else 8)


# ---------------------------------------------------------------------------
# the entry points over the engine stand-ins
# ---------------------------------------------------------------------------

@pytest.fixture()
def standins(monkeypatch, tmp_path):
    for name, mod in chip_smoke.engine_standin_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setenv("ONPOLICY_TORCH_RESULTS", str(tmp_path))


TINY = ["--episode_length", "10", "--hidden_size", "16", "--ppo_epoch",
        "1", "--log_interval", "1", "--device", "cpu"]


def _finite(history, episodes):
    assert [r["episode"] for r in history] == list(range(episodes))
    for r in history:
        for k, v in r.items():
            assert not isinstance(v, float) or math.isfinite(v), (k, v)


@pytest.mark.parametrize("config,extra", [
    ("smac_3s5z", ["--n_rollout_threads", "2", "--eval_episodes", "1",
                   "--eval_interval", "1"]),
    ("smac_3s5z", ["--n_rollout_threads", "1", "--use_eval", "false",
                   "--use_stacked_frames", "--stacked_frames", "2"]),
    ("smacv2_protoss_5v5", ["--n_rollout_threads", "1", "--eval_episodes",
                            "1", "--n_eval_rollout_threads", "2"]),
    ("smacv2_happo", ["--n_rollout_threads", "2", "--use_eval", "false"])])
def test_train_smac_runs_over_the_standins(standins, config, extra):
    threads = int(extra[extra.index("--n_rollout_threads") + 1])
    state, history = train_smac.main(
        train_smac.CONFIGS[config] + TINY + extra
        + ["--num_env_steps", str(2 * 10 * threads)])
    _finite(history, 2)
    states = state if isinstance(state, tuple) else (state,)
    assert len(states) == (5 if config == "smacv2_happo" else 1)
    assert all("incre_win_rate" in r for r in history)
    if "--eval_episodes" in extra:
        assert "eval_win_rate" in history[0]


def test_train_football_runs_over_the_standin(standins):
    state, history = train_football.main(
        train_football.CONFIGS["football_3v1"] + TINY
        + ["--n_rollout_threads", "2", "--num_env_steps", "40"])
    _finite(history, 2)
    assert {"goal", "win_rate", "dead_ratio"} <= history[-1].keys()
    # as JAX's: no eval env is handed over, so --use_eval evaluates nothing
    assert not any("eval_average_episode_rewards" in r for r in history)


def test_every_launching_run_names_its_gru_shapes():
    """The `kernels` rows attribute each run's launches with the shapes
    they ran at: every run of `TRAIN_RUNS` that launches a GRU kernel
    names them, and no other run does; the host runs name the phase-3
    host shapes."""
    launching = {r[0] for r in chip_smoke.TRAIN_RUNS if r[5] or r[6]}
    assert launching == set(chip_smoke.RUN_GRU_SHAPES)
    host = {f"B={case.split('B=')[1].split()[0]}"
            for case, *_ in chip_smoke.HOST_SHAPES}
    named = " ".join(chip_smoke.RUN_GRU_SHAPES[r[0]]
                     for r in chip_smoke.TRAIN_RUNS
                     if r[1] in chip_smoke.HOST_SCRIPTS)
    assert all(b in named.split() for b in host)
