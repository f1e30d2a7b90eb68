"""The slice as a whole: one rMAPPO episode on simple_spread, the port
against the JAX package, in lockstep.

N=4 envs, M=3 agents, T=25, L=10 (chunks cross episodes), H=16, 3 PPO
epochs, one minibatch (permutation-free). Both sides start from the same
`TrainState` (JAX's, carried across by `utils/params.py`) and the same
`golden.reference_reset` worlds. JAX runs its own `SharedRunner._episode`;
its sampled actions and its reset draws are injected into the port's
rollout, so both see the same trajectory. Compared: every step's obs,
rnn states, log-probs, values and rewards; the returns and advantages;
the trained parameters, Adam moments and ValueNorm. All f32 on the CPU:
the rollout is held at rtol/atol 1e-5, and the trained state at
rtol 1e-4 / atol 5e-5 (3 epochs of Adam, whose first steps move each
weight by ~lr whatever the gradient's size, carry the gradients'
summation-order differences). Also covered: recurrent_N=2, and a
checkpoint save → restore that resumes bit-exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.envs.mpe import golden
from onpolicy_tpu.runner.shared_runner import SharedRunner as JaxRunner

from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         train_state_to_jax,
                                         world_state_from_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
N, T = 4, 25
FLAGS = dict(algorithm_name="rmappo", scenario_name="simple_spread",
             num_agents=3, num_landmarks=3, n_rollout_threads=N,
             episode_length=T, num_env_steps=N * T, hidden_size=16,
             data_chunk_length=10, ppo_epoch=3, num_mini_batch=1,
             use_ReLU=False, lr=7e-4, critic_lr=7e-4)


def _jax_episode(layers):
    cfg = j_canon(JaxConfig(**FLAGS, recurrent_N=layers)).validate()
    runner = JaxRunner(cfg)
    state, _ = runner.init(jax.random.PRNGKey(0))
    env = runner.envs.env
    np.random.seed(3)
    worlds = [golden.reference_reset("simple_spread", env.spec)
              for _ in range(N)]
    worlds = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *worlds)
    obs = jax.vmap(lambda s: env.scenario.observation(env.spec, s))(worlds)
    carry = runner._fresh_carry(worlds, obs)

    captured = {}
    train = runner.algo.train

    def capture(ts, buf, key, factor=None):
        captured["buf"] = buf
        return train(ts, buf, key, factor)
    runner.algo.train = capture
    key = jax.random.PRNGKey(7)
    new_state, new_carry, metrics = runner._episode(state, carry, key)

    # the reset draws of every step, as SharedRunner._episode and
    # MPEVecEnv.step split the episode key
    _, k_scan, _ = jax.random.split(key, 3)
    resets = []
    for step_key in jax.random.split(k_scan, T):
        _, k_env = jax.random.split(step_key)
        _, k_reset = jax.random.split(k_env)
        resets.append(jax.vmap(env.reset)(jax.random.split(k_reset, N))[0])
    get = jax.device_get
    return dict(state=get(state), carry=get(carry), buf=get(captured["buf"]),
                new_state=get(new_state), new_carry=get(new_carry),
                metrics=get(metrics), resets=[get(r) for r in resets])


def _port_runner(layers, **kw):
    cfg = canonicalize_algorithm(Config(**{**FLAGS, **kw}, recurrent_N=layers,
                                        device="cpu"))
    return SharedRunner(cfg)


def _close(got, want, name, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=name,
                               **tol)


@pytest.mark.parametrize("layers", [1, 2])
def test_episode_matches_jax_in_lockstep(layers):
    j = _jax_episode(layers)
    runner = _port_runner(layers)
    state = train_state_from_jax(j["state"])
    c = j["carry"]
    carry = {"env_states": world_state_from_jax(c["env_states"]),
             **{k: torch.tensor(np.asarray(c[k]))
                for k in ("obs", "rnn_actor", "rnn_critic", "masks")}}
    inject = [{"actions": torch.tensor(np.asarray(j["buf"].actions[t])),
               "reset_states": world_state_from_jax(j["resets"][t])}
              for t in range(T)]
    new_carry, buf = runner.rollout(state, carry, inject)

    jb = j["buf"]
    for k in ("obs", "share_obs", "rnn_states", "rnn_states_critic",
              "action_log_probs", "value_preds", "rewards", "masks",
              "returns", "advantages"):
        _close(getattr(buf, k), getattr(jb, k), k, ROLL)
    for k in ("obs", "rnn_actor", "rnn_critic", "masks"):
        _close(new_carry[k], j["new_carry"][k], f"carry {k}", ROLL)

    new_state, metrics = runner.algo.train(state, buf, None)
    back = train_state_to_jax(new_state, j["new_state"])
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        got = jax.tree_util.tree_leaves(getattr(back, part))
        want = jax.tree_util.tree_leaves(getattr(j["new_state"], part))
        assert len(got) == len(want), part
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{part}[{i}]", TRAINED)
    for k, v in metrics.items():
        _close(float(v), float(j["metrics"][k]), k, TRAINED)


def test_checkpoint_resume_is_exact(tmp_path):
    """Two episodes in one run equal one episode, a save, and a resumed
    run of one more: parameters, optimizer, ValueNorm, carry and the
    generators' states all round-trip."""
    whole = _port_runner(1, num_env_steps=2 * N * T)
    state_a, hist_a = whole.run(log_fn=None, save_dir=tmp_path / "a")

    first = _port_runner(1, num_env_steps=N * T)
    first.run(log_fn=None, save_dir=tmp_path / "b")
    resumed = _port_runner(1, num_env_steps=2 * N * T,
                           model_dir=str(tmp_path / "b"))
    state_b, hist_b = resumed.run(log_fn=None, save_dir=tmp_path / "c")
    assert resumed.start_episode == 1
    assert [h["episode"] for h in hist_b] == [1]
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state"):
        for a, b in zip(tree_leaves(getattr(state_a, part)),
                        tree_leaves(getattr(state_b, part))):
            assert torch.equal(a, b), part
    assert torch.equal(state_a.vnorm.running_mean, state_b.vnorm.running_mean)
    assert hist_a[-1]["value_loss"] == hist_b[-1]["value_loss"]
