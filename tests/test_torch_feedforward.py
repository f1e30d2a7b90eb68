"""Feed-forward MAPPO, IPPO, the critic dedup and the naive-recurrent
policy: the port against the JAX package, on the CPU.

  * the samplers (`feed_forward_minibatches`, `naive_recurrent_minibatches`)
    give JAX's minibatches exactly: as they lie with one minibatch, and
    with several when both are handed the same permutation;
  * one episode in lockstep, as tests/test_torch_slice.py runs rMAPPO:
    N=4 envs, M=3 agents, T=25, H=16, 3 PPO epochs, one minibatch; JAX's
    sampled actions and reset draws are injected into the port's rollout.
    The rollout buffers are held at rtol/atol 1e-5 and the trained state
    (parameters, Adam moments, ValueNorm) and metrics at rtol 1e-4 /
    atol 5e-5, the tolerances of that test;
  * the dedup trains as the plain path does, as tests/test_critic_dedup.py
    asserts for JAX (rtol 2e-4 / atol 2e-5 on every metric of 3 episodes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu import buffer as j_buf
from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.envs.mpe import golden
from onpolicy_tpu.runner.shared_runner import SharedRunner as JaxRunner

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         train_state_to_jax,
                                         world_state_from_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
N, T = 4, 25
FLAGS = dict(scenario_name="simple_spread", num_agents=3, num_landmarks=3,
             n_rollout_threads=N, episode_length=T, num_env_steps=N * T,
             hidden_size=16, ppo_epoch=3, num_mini_batch=1, use_ReLU=False,
             lr=7e-4, critic_lr=7e-4)
CASES = {
    "mappo": dict(algorithm_name="mappo"),
    "ippo": dict(algorithm_name="ippo", use_recurrent_policy=False),
    "mappo_dedup": dict(algorithm_name="mappo", use_critic_dedup=True),
    "naive_recurrent": dict(algorithm_name="ippo", use_recurrent_policy=False,
                            use_naive_recurrent_policy=True),
}


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _buffers(Tb=5, Nb=4, M=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    fields = dict(
        share_obs=f(Tb + 1, Nb, M, 7), obs=f(Tb + 1, Nb, M, 5),
        rnn_states=f(Tb + 1, Nb, M, 1, 4),
        rnn_states_critic=f(Tb + 1, Nb, M, 1, 4),
        actions=f(Tb, Nb, M, 1), action_log_probs=f(Tb, Nb, M, 1),
        value_preds=f(Tb + 1, Nb, M, 1), rewards=f(Tb, Nb, M, 1),
        masks=(rng.random((Tb + 1, Nb, M, 1)) > 0.2).astype(np.float32),
        bad_masks=np.ones((Tb + 1, Nb, M, 1), np.float32),
        active_masks=(rng.random((Tb + 1, Nb, M, 1)) > 0.1).astype(np.float32),
        available_actions=(rng.random((Tb + 1, Nb, M, 5)) > 0.3)
        .astype(np.float32),
        returns=f(Tb, Nb, M, 1), advantages=f(Tb, Nb, M, 1))
    adv = f(Tb, Nb, M, 1)
    jb = j_buf.RolloutBuffer(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = buf_lib.RolloutBuffer(**{k: torch.tensor(v) for k, v in fields.items()})
    return jb, tb, adv


@pytest.mark.parametrize("nmb", [1, 2, 5])
def test_feed_forward_minibatches_match_jax(nmb):
    jb, tb, adv = _buffers()
    key = jax.random.PRNGKey(nmb)
    want = j_buf.feed_forward_minibatches(jb, jnp.asarray(adv), key, nmb)
    total = tb.T * tb.n_rollout_threads * tb.num_agents
    perm = None if nmb == 1 else torch.tensor(
        np.asarray(jax.random.permutation(key, total)))
    got = buf_lib.feed_forward_minibatches(tb, torch.tensor(adv), None, nmb,
                                           perm=perm)
    assert len(got) == nmb
    for i, mb in enumerate(got):
        assert set(mb) == set(want)
        for k, v in mb.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][i]),
                                          err_msg=k)


@pytest.mark.parametrize("nmb", [1, 2, 3])
def test_naive_recurrent_minibatches_match_jax(nmb):
    jb, tb, adv = _buffers(Nb=6)
    key = jax.random.PRNGKey(10 + nmb)
    want = j_buf.naive_recurrent_minibatches(jb, jnp.asarray(adv), key, nmb)
    total = tb.n_rollout_threads * tb.num_agents
    perm = None if nmb == 1 else torch.tensor(
        np.asarray(jax.random.permutation(key, total)))
    got = buf_lib.naive_recurrent_minibatches(tb, torch.tensor(adv), None,
                                              nmb, perm=perm)
    assert len(got) == nmb
    for i, mb in enumerate(got):
        assert set(mb) == set(want)
        for k, v in mb.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][i]),
                                          err_msg=k)


def test_samplers_draw_from_the_generator():
    """Without a given permutation the minibatches are a partition of the
    rows drawn from the run's generator: the same seed, the same split."""
    _, tb, adv = _buffers()
    a = torch.tensor(adv)
    total = tb.T * tb.n_rollout_threads * tb.num_agents
    split = lambda seed: buf_lib.feed_forward_minibatches(
        tb, a, torch.Generator().manual_seed(seed), 4)
    one, two = split(0), split(0)
    for x, y in zip(one, two):
        assert torch.equal(x["obs"], y["obs"])
    rows = torch.cat([mb["advantages"] for mb in one]).flatten()
    assert torch.equal(rows.sort().values, a.flatten().sort().values)
    assert rows.numel() == total
    with pytest.raises(ValueError, match="not divisible"):
        buf_lib.feed_forward_minibatches(tb, a, None, 7)


# ---------------------------------------------------------------------------
# one episode in lockstep with JAX
# ---------------------------------------------------------------------------

def _jax_episode(flags):
    cfg = j_canon(JaxConfig(**FLAGS, **flags)).validate()
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


def _close(got, want, name, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=name,
                               **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_episode_matches_jax_in_lockstep(case):
    flags = CASES[case]
    j = _jax_episode(flags)
    runner = SharedRunner(canonicalize_algorithm(
        Config(**FLAGS, **flags, device="cpu")))
    assert runner.cfg.is_recurrent == (case == "naive_recurrent")
    state = train_state_from_jax(j["state"])
    assert ("rnn" in state.actor_params) == runner.cfg.is_recurrent
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

    n0 = cuda_gru.FWD_LAUNCHES
    new_state, metrics = runner.algo.train(state, buf, None)
    assert cuda_gru.FWD_LAUNCHES == n0          # CPU: no kernel launched
    back = train_state_to_jax(new_state, j["new_state"])
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        got = jax.tree_util.tree_leaves(getattr(back, part))
        want = jax.tree_util.tree_leaves(getattr(j["new_state"], part))
        assert len(got) == len(want), part
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{part}[{i}]", TRAINED)
    assert set(metrics) == set(j["metrics"]) - {
        k for k in j["metrics"] if "rewards" in k}
    for k, v in metrics.items():
        _close(float(v), float(j["metrics"][k]), k, TRAINED)


# ---------------------------------------------------------------------------
# the dedup is exact
# ---------------------------------------------------------------------------

def _run_port(**kw):
    cfg = canonicalize_algorithm(Config(
        algorithm_name="mappo", scenario_name="simple_spread", num_agents=3,
        num_landmarks=3, n_rollout_threads=8, episode_length=10,
        num_env_steps=3 * 8 * 10, ppo_epoch=3, num_mini_batch=1,
        hidden_size=32, seed=3, log_interval=1, device="cpu", **kw))
    state, history = SharedRunner(cfg).run(log_fn=None)
    leaf = sum(float(x.double().sum()) for x in tree_leaves(state.critic_params))
    return history, leaf


def test_dedup_matches_plain_path():
    rows_a, leaf_a = _run_port()
    rows_b, leaf_b = _run_port(use_critic_dedup=True)
    assert len(rows_a) == len(rows_b) == 3
    for ra, rb in zip(rows_a, rows_b):
        assert set(ra) == set(rb)
        for k in set(ra) - {"fps"}:     # fps is the host's clock
            np.testing.assert_allclose(rb[k], ra[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
    np.testing.assert_allclose(leaf_b, leaf_a, rtol=1e-4)


def test_dedup_is_refused_where_it_is_not_exact():
    with pytest.raises(ValueError, match="feed-forward"):
        canonicalize_algorithm(Config(algorithm_name="rmappo",
                                      use_critic_dedup=True,
                                      device="cpu")).validate()
    with pytest.raises(ValueError, match="use_centralized_V"):
        canonicalize_algorithm(Config(algorithm_name="ippo",
                                      use_recurrent_policy=False,
                                      use_critic_dedup=True,
                                      device="cpu")).validate()
