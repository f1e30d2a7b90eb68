"""The separated runner against the JAX package's, in lockstep.

One episode of HAPPO on simple_spread (3 agents, a fixed agent order),
one of rMAPPO on simple_speaker_listener (the speaker's Discrete(3) and
the listener's Discrete(5) heads padded to one column, obs of 3 and 11,
critic input of 14) and one of rMAPPO on simple_world_comm (6 agents:
the leader's MultiDiscrete (5, 4) head and the others' Discrete(5)
padded to two columns, obs of 34 and 28, per-agent rewards), N=4 envs,
T=25, L=10, H=16, 2 PPO epochs. Both sides
start from the same per-agent `TrainState`s (JAX's, carried across by
`utils/params.py`) and the same `golden.reference_reset` worlds. JAX runs
its own `SeparatedRunner._episode`, with each agent's `train` wrapped to
capture its buffer and its factor; the port's rollout takes JAX's actions
and reset draws. Compared: every agent's buffer (rollout and returns),
each agent's factor, the trained states and the metrics, and then the
deterministic eval of the trained states from the same worlds. f32 on the
CPU: rollout, factors and eval at rtol/atol 1e-5, the trained state at
rtol 1e-4 / atol 5e-5 (tests/test_torch_slice.py says why). Also: a
separated run saves and resumes exactly, orders included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.envs.mpe import golden
from onpolicy_tpu.envs.mpe import make_vec_env as j_make_vec_env
from onpolicy_tpu.runner.separated_runner import SeparatedRunner as JaxRunner

from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.runner.separated_runner import SeparatedRunner
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         train_state_to_jax,
                                         world_state_from_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
N, T = 4, 25
CASES = {
    "happo_spread": dict(algorithm_name="happo",
                         scenario_name="simple_spread", num_agents=3),
    "rmappo_speaker_listener": dict(algorithm_name="rmappo",
                                    scenario_name="simple_speaker_listener",
                                    num_agents=2, share_policy=False),
    # the arguments of the JAX package's golden test of this scenario
    "rmappo_world_comm": dict(algorithm_name="rmappo",
                              scenario_name="simple_world_comm",
                              num_agents=6, num_landmarks=1,
                              num_good_agents=2, num_adversaries=4,
                              share_policy=False),
}
ORDER = {"happo_spread": (2, 0, 1), "rmappo_speaker_listener": None,
         "rmappo_world_comm": None}


def _flags(case):
    return {**dict(num_landmarks=3, n_rollout_threads=N, episode_length=T,
                   num_env_steps=N * T, hidden_size=16, data_chunk_length=10,
                   ppo_epoch=2, num_mini_batch=1, lr=7e-4, critic_lr=7e-4,
                   n_eval_rollout_threads=N), **CASES[case]}


def _worlds(env, seed):
    np.random.seed(seed)
    worlds = [golden.reference_reset(env.scenario_name, env.spec)
              for _ in range(N)]
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *worlds)


def _jax_episode(case):
    cfg = j_canon(JaxConfig(**_flags(case))).validate()
    runner = JaxRunner(cfg, eval_env=j_make_vec_env(cfg, n_envs=N))
    states, _ = runner.init(jax.random.PRNGKey(0))
    env = runner.envs.env
    M = env.num_agents
    worlds = _worlds(env, 3)
    obs = jax.vmap(lambda s: env.scenario.observation(env.spec, s))(worlds)
    zeros = tuple(jnp.zeros((N, 1, 16)) for _ in range(M))
    carry = {"env_states": worlds, "obs": tuple(obs), "rnn_actor": zeros,
             "rnn_critic": zeros, "masks": jnp.ones((N, 1))}

    captured = {}
    for i, algo in enumerate(runner.algos):
        def capture(ts, buf, key, factor=None, i=i, train=algo.train):
            captured[i] = (buf, factor)
            return train(ts, buf, key, factor=factor)
        algo.train = capture
    key = jax.random.PRNGKey(7)
    order = ORDER[case] or tuple(range(M))
    new_states, new_carry, metrics = runner._episode(order, states, carry,
                                                     key)

    # the reset draws of every step, as SeparatedRunner._episode and
    # MPEVecEnv.step split the episode key
    _, k_scan, _ = jax.random.split(key, 3)
    resets = []
    for step_key in jax.random.split(k_scan, T):
        k_env = jax.random.split(step_key, M + 1)[-1]
        _, k_reset = jax.random.split(k_env)
        resets.append(jax.vmap(env.reset)(jax.random.split(k_reset, N))[0])

    # deterministic eval of the trained states from fresh worlds
    k_eval = jax.random.PRNGKey(11)
    _, k_reset = jax.random.split(k_eval)
    eval_worlds, _ = runner.eval_envs.reset(k_reset)
    eval_return = runner._eval_episode(new_states, k_eval)
    get = jax.device_get
    return dict(states=get(states), carry=get(carry),
                bufs=[get(captured[i][0]) for i in range(M)],
                factors=[get(captured[i][1]) for i in range(M)],
                new_states=get(new_states), new_carry=get(new_carry),
                metrics=get(metrics), resets=[get(r) for r in resets],
                eval_worlds=get(eval_worlds), eval_return=float(eval_return))


def _port_runner(case, **kw):
    cfg = canonicalize_algorithm(Config(**{**_flags(case), **kw},
                                        device="cpu"))
    eval_env = make_vec_env(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), n_envs=N)
    return SeparatedRunner(cfg, eval_env=eval_env)


def _close(got, want, name, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_episode_matches_jax_in_lockstep(case):
    j = _jax_episode(case)
    runner = _port_runner(case)
    M = runner.num_agents
    assert runner.is_happo == (case == "happo_spread")
    states = tuple(train_state_from_jax(s) for s in j["states"])
    c = j["carry"]
    tensors = lambda xs: tuple(torch.tensor(np.asarray(x)) for x in xs)
    carry = {"env_states": world_state_from_jax(c["env_states"]),
             "obs": tensors(c["obs"]), "rnn_actor": tensors(c["rnn_actor"]),
             "rnn_critic": tensors(c["rnn_critic"]),
             "masks": torch.tensor(np.asarray(c["masks"]))}
    inject = [{"actions": [torch.tensor(np.asarray(b.actions[t, :, 0]))
                           for b in j["bufs"]],
               "reset_states": world_state_from_jax(j["resets"][t])}
              for t in range(T)]
    new_carry, bufs = runner.rollout(states, carry, inject)

    for i in range(M):
        jb = j["bufs"][i]
        for k in ("obs", "share_obs", "rnn_states", "rnn_states_critic",
                  "actions", "action_log_probs", "value_preds", "rewards",
                  "masks", "returns", "advantages"):
            _close(getattr(bufs[i], k), getattr(jb, k), f"agent{i} {k}", ROLL)
    for k in ("obs", "rnn_actor", "rnn_critic"):
        for i in range(M):
            _close(new_carry[k][i], j["new_carry"][k][i], f"carry {k}", ROLL)
    _close(new_carry["masks"], j["new_carry"]["masks"], "carry masks", ROLL)

    factors = {}
    for i, algo in enumerate(runner.algos):
        def capture(ts, buf, generator, factor=None, i=i, train=algo.train):
            factors[i] = factor
            return train(ts, buf, generator, factor=factor)
        algo.train = capture
    n0 = cuda_gru.FWD_LAUNCHES
    new_states, metrics = runner.update(states, bufs, ORDER[case])
    assert cuda_gru.FWD_LAUNCHES == n0          # CPU: no kernel launched
    for i in range(M):
        if j["factors"][i] is None:
            assert factors[i] is None
        else:
            assert factors[i].shape == (T, N, 1, 1)
            _close(factors[i], j["factors"][i], f"agent{i} factor", ROLL)
    if case == "happo_spread":      # the first in the order trains at ones
        assert torch.equal(factors[2], torch.ones(T, N, 1, 1))
        assert not torch.equal(factors[1], factors[0])
    for i in range(M):
        back = train_state_to_jax(new_states[i], j["new_states"][i])
        for part in ("actor_params", "critic_params", "actor_opt_state",
                     "critic_opt_state", "vnorm"):
            got = jax.tree_util.tree_leaves(getattr(back, part))
            want = jax.tree_util.tree_leaves(
                getattr(j["new_states"][i], part))
            assert len(got) == len(want), part
            for n, (a, b) in enumerate(zip(got, want)):
                _close(a, b, f"agent{i} {part}[{n}]", TRAINED)
        for k, v in j["metrics"][f"agent{i}"].items():
            _close(float(metrics[f"agent{i}/{k}"]), float(v), k, TRAINED)

    got = runner.eval_episode(new_states,
                              world_state_from_jax(j["eval_worlds"]))
    _close(float(got), j["eval_return"], "eval return", ROLL)


def test_checkpoint_resume_is_exact(tmp_path):
    """HAPPO: two episodes in one run equal one episode, a save and a
    resumed run of one more, the second episode's agent order included."""
    case = "happo_spread"
    whole = _port_runner(case, num_env_steps=2 * N * T, ppo_epoch=1)
    states_a, hist_a = whole.run(log_fn=None, save_dir=tmp_path / "a")
    first = _port_runner(case, num_env_steps=N * T, ppo_epoch=1)
    first.run(log_fn=None, save_dir=tmp_path / "b")
    resumed = _port_runner(case, num_env_steps=2 * N * T, ppo_epoch=1,
                           model_dir=str(tmp_path / "b"))
    states_b, hist_b = resumed.run(log_fn=None, save_dir=tmp_path / "c")
    assert resumed.start_episode == 1
    assert [h["episode"] for h in hist_b] == [1]
    for a, b in zip(states_a, states_b):
        for part in ("actor_params", "critic_params", "actor_opt_state",
                     "critic_opt_state"):
            for x, y in zip(tree_leaves(getattr(a, part)),
                            tree_leaves(getattr(b, part))):
                assert torch.equal(x, y), part
    assert hist_a[-1] == {**hist_b[-1], "fps": hist_a[-1]["fps"]}
