"""The port's HostSeparatedRunner against the JAX package's, on the CPU.

One episode in lockstep, HAPPO and HATRPO, each with a fixed agent order
(N=4 envs of `ScriptedSmacEnv`, 3 agents, T=20, L=10, H=16, 2 PPO
epochs): both runners start from the same per-agent train states (JAX's,
carried across by `utils/params.py`) and the same env reset; JAX runs its
own `run_episode`, with `_train` wrapped to capture the buffer (returns
included); the port's rollout takes JAX's sampled actions. Compared: the
whole [T, N, M] buffer with its returns at rtol/atol 1e-5; each agent's
factor (the port's as its trainer receives it; JAX's rebuilt from its
agents' whole-episode log-probs before and after their updates) at 1e-5;
every agent's trained state and the metrics at rtol 1e-4 / atol 5e-5;
the deterministic eval of JAX's trained states at 1e-5. Also: a HAPPO
run saves and resumes exactly, the agent-order stream included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import config_from_args as j_config_from_args
from onpolicy_tpu.envs import host_vec as j_host_vec
from onpolicy_tpu.envs.starcraft2.smac_env import \
    smac_win_rate_metrics as j_win_rate
from onpolicy_tpu.runner.host_separated_runner import \
    HostSeparatedRunner as JaxRunner
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch.config import config_from_args
from onpolicy_torch.envs import host_vec
from onpolicy_torch.envs.starcraft2.smac_env import smac_win_rate_metrics
from onpolicy_torch.runner.host_separated_runner import HostSeparatedRunner
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.params import train_state_from_jax, \
    train_state_to_jax
from onpolicy_torch.utils.tree import tree_leaves
from tests.test_torch_host_runner import BUFFER, ROLL, TRAINED, _argv, \
    _close
from tests.test_torch_host_vec import ScriptedSmacEnv

torch.set_num_threads(1)

N, T = 4, 20
ORDER = {"happo": (2, 0, 1), "hatrpo": (1, 2, 0)}


def _pool(mod, spaces, seed0=0, n=N, **env_kw):
    return mod.DummyVecEnv([lambda s=seed0 + i: ScriptedSmacEnv(
        s, spaces=spaces, **env_kw) for i in range(n)], protocol="share")


def _jax_episode(algo):
    cfg = j_config_from_args(_argv(algo))
    env, eval_env = _pool(j_host_vec, j_sp), _pool(j_host_vec, j_sp, 50, 3)
    runner = JaxRunner(cfg, env, eval_env=eval_env, env_metrics=j_win_rate())
    k0 = jax.random.PRNGKey(0)
    states = tuple(a.init_state(jax.random.fold_in(k0, i))
                   for i, a in enumerate(runner.algos))
    obs, share_obs, avail = env.reset()
    M = runner.num_agents
    zeros = np.zeros((N, M, cfg.recurrent_N, cfg.hidden_size), np.float32)
    ones = np.ones((N, M, 1), np.float32)
    start = {"obs": obs, "share_obs": share_obs, "avail": avail,
             "rnn_a": zeros, "rnn_c": zeros, "masks": ones,
             "active": ones, "bad": ones}
    captured = {}
    train = runner._train

    def spy(order, states, buf, key):
        captured["buf"] = buf
        return train(order, states, buf, key)
    runner._train = spy
    new_states, new_start, metrics = runner.run_episode(
        states, start, jax.random.PRNGKey(7), ORDER[algo])
    buf = captured["buf"]
    # the factor each agent's update received, from its predecessors'
    # whole-episode log-probs before and after their updates
    factors, factor = {}, jnp.ones((T, N, 1, 1))
    for i in ORDER[algo]:
        factors[i] = factor
        buf_i = jax.tree_util.tree_map(
            lambda x: x[:, :, i:i + 1] if x is not None else x, buf)
        old = runner.algos[i].evaluate_full_logp(states[i], buf_i)
        new = runner.algos[i].evaluate_full_logp(new_states[i], buf_i)
        factor = factor * jnp.exp(jnp.sum(new - old, -1, keepdims=True))
    evaluation = runner.evaluate(new_states, jax.random.PRNGKey(3),
                                 eval_episodes=5)
    env.close()
    eval_env.close()
    get = jax.device_get
    return dict(states=get(states), start=start, buf=get(buf),
                new_states=get(new_states), new_start=new_start,
                metrics=metrics, factors=get(factors), eval=evaluation)


@pytest.mark.parametrize("algo", sorted(ORDER))
def test_episode_matches_jax_in_lockstep(algo):
    j = _jax_episode(algo)
    cfg = config_from_args(_argv(algo) + ["--device", "cpu"])
    env, eval_env = _pool(host_vec, sp), _pool(host_vec, sp, 50, 3)
    try:
        runner = HostSeparatedRunner(cfg, env, eval_env=eval_env,
                                     env_metrics=smac_win_rate_metrics())
        _, start = runner.init()
        for k in ("obs", "share_obs", "avail"):
            np.testing.assert_array_equal(start[k], j["start"][k], k)
        states = tuple(train_state_from_jax(s) for s in j["states"])
        jb = j["buf"]
        inject = [{"actions": np.asarray(jb.actions[t])} for t in range(T)]
        carry, buf, infos = runner.rollout(states, start, inject)
        for k in BUFFER:
            _close(getattr(buf, k), getattr(jb, k), f"buffer {k}", ROLL)
        assert (np.asarray(jb.active_masks) == 0).any()
        assert (np.asarray(jb.bad_masks) == 0).any()
        for k in ("obs", "share_obs", "masks", "active", "bad"):
            np.testing.assert_array_equal(carry[k], j["new_start"][k], k)

        factors = {}
        for i, a in enumerate(runner.algos):
            def capture(ts, b, generator, factor=None, i=i, train=a.train):
                factors[i] = factor
                return train(ts, b, generator, factor=factor)
            a.train = capture
        new_states, m = runner.update(states, buf, ORDER[algo])
        for i in ORDER[algo]:
            _close(factors[i], j["factors"][i], f"agent{i} factor", ROLL)
        assert torch.equal(factors[ORDER[algo][0]], torch.ones(T, N, 1, 1))
        assert not torch.equal(factors[ORDER[algo][-1]],
                               torch.ones(T, N, 1, 1))
        metrics = runner._episode_metrics(m, infos)
        assert metrics.keys() == j["metrics"].keys()
        for k, v in j["metrics"].items():
            _close(metrics[k], v, k, TRAINED if "/" in k else ROLL)
        for i, (got_s, want_s) in enumerate(zip(new_states,
                                                j["new_states"])):
            back = train_state_to_jax(got_s, want_s)
            for part in ("actor_params", "critic_params", "actor_opt_state",
                         "critic_opt_state", "vnorm"):
                got = jax.tree_util.tree_leaves(getattr(back, part))
                want = jax.tree_util.tree_leaves(getattr(want_s, part))
                assert len(got) == len(want), part
                for n, (a, b) in enumerate(zip(got, want)):
                    _close(a, b, f"agent{i} {part}[{n}]", TRAINED)

        evaluation = runner.evaluate(
            tuple(train_state_from_jax(s) for s in j["new_states"]))
        assert evaluation.keys() == j["eval"].keys()
        for k, v in j["eval"].items():
            _close(evaluation[k], v, k, ROLL)
    finally:
        env.close()
        eval_env.close()


def _resume_runner(steps, **over):
    cfg = config_from_args(_argv("happo", num_env_steps=steps, **over)
                           + ["--device", "cpu"])
    # episodes as long as the rollout, so a restarted pool reproduces the
    # env at every episode boundary
    env = host_vec.DummyVecEnv(
        [lambda s=i: ScriptedSmacEnv(s, limit=T, decisive=False)
         for i in range(N)], protocol="share")
    return HostSeparatedRunner(cfg, env, env_metrics=smac_win_rate_metrics())


def test_checkpoint_resume_is_exact(tmp_path):
    """HAPPO: three episodes in one run equal two, a save and a resumed
    run of one more, the agent order of the last episode included."""
    whole = _resume_runner(3 * N * T)
    states_a, hist_a = whole.run(log_fn=None, save_dir=tmp_path / "a")
    _resume_runner(2 * N * T).run(log_fn=None, save_dir=tmp_path / "b")
    resumed = _resume_runner(3 * N * T, model_dir=str(tmp_path / "b"))
    states_b, hist_b = resumed.run(log_fn=None)
    assert resumed.start_episode == 2
    assert [h["episode"] for h in hist_b] == [2]
    for a, b in zip(states_a, states_b):
        for part in ("actor_params", "critic_params", "actor_opt_state",
                     "critic_opt_state"):
            for x, y in zip(tree_leaves(getattr(a, part)),
                            tree_leaves(getattr(b, part))):
                assert torch.equal(x, y), part
    assert hist_a[-1] == {**hist_b[-1], "fps": hist_a[-1]["fps"]}
