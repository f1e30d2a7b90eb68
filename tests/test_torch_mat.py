"""MAT and MAT-dec: the port against the JAX package, on the CPU.

Every input is made from a seed with numpy (or drawn by JAX) and fed to
both packages; the parameters are JAX's, carried across by
`utils/params.py`. f32 throughout.

  * the networks (`models/transformer.py`): encoder, decoder (MAT, and
    the dec_actor MLPs shared and per agent), `parallel_act` and
    `get_values` at rtol/atol 1e-5; `autoregressive_act` with JAX's draws
    injected as the actions (log-probs and values), and in deterministic
    mode (actions equal, log-probs and values at 1e-5);
  * the teacher-forced log-prob of a joint action equals the
    autoregressive one (tests/test_algorithms.py's
    test_mat_autoregressive_feeds_previous_actions, on the port);
  * `transformer_minibatches` at 1 and 2 minibatches (JAX's permutation
    handed to the port) gives JAX's minibatches exactly;
  * one shared-runner episode in lockstep with JAX's (N=4 envs, 3 agents,
    T=25, 3 PPO epochs): JAX's sampled actions and reset draws injected
    into the port's rollout; the buffer at 1e-5, the trained state
    (parameters, Adam moments, ValueNorm) and the metrics at rtol 1e-4 /
    atol 5e-5 (PERF.md §2); for mat, mat_dec, MAT with per-agent
    decoders, encode_state, and two minibatches with linear lr decay
    (each epoch's permutation computed from JAX's key);
  * the deterministic eval return from the same worlds at 1e-5;
  * a MAT run saves and resumes exactly, `episodes_per_call` averages
    its episodes, and `train_mpe` runs the new CONFIGS.
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
from onpolicy_tpu.envs.mpe import make_vec_env as j_make_vec_env
from onpolicy_tpu.models import transformer as j_tfm
from onpolicy_tpu.runner.shared_runner import SharedRunner as JaxRunner

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms.mat import MAT, MATTrainState
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.models import transformer as tfm
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.scripts import train_mpe
from onpolicy_torch.utils.params import (to_torch, train_state_from_jax,
                                         train_state_to_jax,
                                         world_state_from_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

EXACT = dict(rtol=1e-5, atol=1e-5)
ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
N, T = 4, 25


def _close(got, want, name, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

# name → (MATConfig args after (n_agent, action_dim): n_block, n_embd,
# n_head, dec_actor, share_actor)
NETS = {"mat": (1, 16, 1, False, False),
        "mat_2blocks_2heads": (2, 16, 2, False, False),
        "mat_dec_shared": (1, 16, 1, True, True),
        "mat_dec_per_agent": (1, 16, 1, True, False)}
B, M, DO, A = 6, 3, 7, 5


def _net(name, enc_dim=None):
    n_block, n_embd, n_head, dec_actor, share_actor = NETS[name]
    j_cfg = j_tfm.MATConfig(M, A, n_block, n_embd, n_head,
                            dec_actor=dec_actor, share_actor=share_actor)
    t_cfg = tfm.MATConfig(M, A, n_block, n_embd, n_head,
                          dec_actor=dec_actor, share_actor=share_actor)
    params = jax.device_get(j_tfm.mat_init(
        jax.random.PRNGKey(3), DO, A, M, n_block, n_embd,
        dec_actor=dec_actor, share_actor=share_actor, encoder_dim=enc_dim))
    return j_cfg, t_cfg, params, to_torch(params)


def _inputs(seed, with_avail):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, M, DO)).astype(np.float32)
    actions = rng.integers(0, A, (B, M, 1)).astype(np.float32)
    avail = None
    if with_avail:
        avail = (rng.random((B, M, A)) > 0.3).astype(np.float32)
        avail[..., 0] = 1.0
        actions = np.where(np.take_along_axis(avail, actions.astype(int), -1),
                           actions, 0.0).astype(np.float32)
    return obs, actions, avail


def _t(x):
    return None if x is None else torch.tensor(np.asarray(x))


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("with_avail", [False, True])
def test_networks_match_jax(name, with_avail):
    j_cfg, t_cfg, jp, tp = _net(name)
    obs, actions, avail = _inputs(1, with_avail)
    v_j, rep_j = j_tfm.encoder_apply(jp["encoder"], obs, j_cfg.n_head)
    v_t, rep_t = tfm.encoder_apply(tp["encoder"], _t(obs), t_cfg.n_head)
    _close(v_t, v_j, "encoder value", EXACT)
    _close(rep_t, rep_j, "encoder rep", EXACT)
    _close(tfm.get_values(t_cfg, tp, _t(obs)),
           j_tfm.get_values(j_cfg, jp, obs), "get_values", EXACT)

    shifted = np.random.default_rng(2).random((B, M, A + 1)).astype(
        np.float32)
    want = j_tfm.decoder_apply(jp["decoder"], shifted, rep_j, obs,
                               j_cfg.n_head, j_cfg.dec_actor,
                               j_cfg.share_actor)
    got = tfm.decoder_apply(tp["decoder"], _t(shifted), _t(rep_j), _t(obs),
                            t_cfg.n_head, t_cfg.dec_actor, t_cfg.share_actor)
    _close(got, want, "decoder logits", EXACT)

    want = j_tfm.parallel_act(j_cfg, jp, obs, actions, avail)
    got = tfm.parallel_act(t_cfg, tp, _t(obs), _t(actions), _t(avail))
    for k, a, b in zip(("logp", "values", "entropy"), got, want):
        _close(a, b, f"parallel_act {k}", EXACT)


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("with_avail", [False, True])
def test_autoregressive_act_matches_jax(name, with_avail):
    j_cfg, t_cfg, jp, tp = _net(name)
    obs, _, avail = _inputs(4, with_avail)
    for deterministic in (False, True):
        acts, logp, values = j_tfm.autoregressive_act(
            j_cfg, jp, obs, jax.random.PRNGKey(5), avail, deterministic)
        injected = None if deterministic else _t(acts)
        got = tfm.autoregressive_act(t_cfg, tp, _t(obs), None, _t(avail),
                                     deterministic, actions=injected)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(acts))
        _close(got[1], logp, f"logp (deterministic={deterministic})", EXACT)
        _close(got[2], values, "values", EXACT)


@pytest.mark.parametrize("name", sorted(NETS))
def test_teacher_forced_logp_equals_autoregressive(name):
    _, t_cfg, _, tp = _net(name)
    obs, _, avail = _inputs(6, True)
    acts, logp_ar, values = tfm.autoregressive_act(
        t_cfg, tp, _t(obs), torch.Generator().manual_seed(0), _t(avail))
    logp_par, v2, _ = tfm.parallel_act(t_cfg, tp, _t(obs), acts, _t(avail))
    _close(logp_par, logp_ar, "teacher-forced logp", dict(rtol=1e-4,
                                                          atol=1e-5))
    _close(v2, values, "values", EXACT)
    # agent i's logits see agents < i's actions: change agent 0's action
    # and agent 1's log-prob of its own action moves
    other = acts.clone()
    other[:, 0] = (other[:, 0] + 1) % A
    logp_other, _, _ = tfm.parallel_act(t_cfg, tp, _t(obs), other, None)
    logp_same, _, _ = tfm.parallel_act(t_cfg, tp, _t(obs), acts, None)
    if not t_cfg.dec_actor:
        assert not torch.equal(logp_other[:, 1], logp_same[:, 1])


def test_encode_state_reads_the_centralized_state():
    j_cfg, t_cfg, jp, tp = _net("mat", enc_dim=M * DO)
    obs, actions, _ = _inputs(7, False)
    state = np.broadcast_to(obs.reshape(B, 1, M * DO), (B, M, M * DO)).copy()
    assert tp["encoder"]["obs_embed"]["w"].shape[0] == M * DO
    want = j_tfm.parallel_act(j_cfg, jp, obs, actions, enc_in=state)
    got = tfm.parallel_act(t_cfg, tp, _t(obs), _t(actions), enc_in=_t(state))
    for k, a, b in zip(("logp", "values", "entropy"), got, want):
        _close(a, b, f"parallel_act {k}", EXACT)
    acts, logp, values = j_tfm.autoregressive_act(
        j_cfg, jp, obs, jax.random.PRNGKey(8), enc_in=state)
    got = tfm.autoregressive_act(t_cfg, tp, _t(obs), None, enc_in=_t(state),
                                 actions=_t(acts))
    _close(got[1], logp, "logp", EXACT)
    _close(got[2], values, "values", EXACT)


def test_box_actions_are_refused():
    """MAT with Box actions, refused until B4 was ported: the port's own
    decoder has JAX's layout (log_std at ones, a biased act embedding of
    width A), and on JAX's parameters the deterministic decode, the
    sampled one fed JAX's draws and the teacher-forced pass give JAX's
    actions, log-probs, values and entropies, all per action dimension."""
    j_cfg = j_tfm.MATConfig(M, A, 1, 16, 1, action_type="Box")
    t_cfg = tfm.MATConfig(M, A, 1, 16, 1, action_type="Box")
    mine = tfm.mat_init(t_cfg, DO, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(mine["decoder"]["log_std"], torch.ones(A))
    assert mine["decoder"]["act_embed"]["w"].shape == (A, 16)
    jp = jax.device_get(j_tfm.mat_init(jax.random.PRNGKey(4), DO, A, M, 1,
                                       16, "Box"))
    tp = to_torch(jp)
    obs = np.random.default_rng(9).standard_normal((B, M, DO)).astype(
        np.float32)
    acts, logp, values = j_tfm.autoregressive_act(
        j_cfg, jp, obs, jax.random.PRNGKey(1), deterministic=True)
    got = tfm.autoregressive_act(t_cfg, tp, _t(obs), None, deterministic=True)
    for k, a, b in zip(("actions", "logp", "values"), got,
                       (acts, logp, values)):
        assert a.shape == (B, M, A if k != "values" else 1), k
        _close(a, b, f"autoregressive_act {k}", EXACT)
    # sampled: agent i's standard normal draws are JAX's, from
    # fold_in(key, i)
    key = jax.random.PRNGKey(2)
    acts, logp, values = j_tfm.autoregressive_act(j_cfg, jp, obs, key)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (B, A))) for i in range(M)], 1)
    got = tfm.autoregressive_act(t_cfg, tp, _t(obs), None, noise=_t(noise))
    for k, a, b in zip(("actions", "logp", "values"), got,
                       (acts, logp, values)):
        _close(a, b, f"sampled autoregressive_act {k}", EXACT)
    want = j_tfm.parallel_act(j_cfg, jp, obs, acts)
    got = tfm.parallel_act(t_cfg, tp, _t(obs), _t(np.asarray(acts)))
    for k, a, b in zip(("logp", "values", "entropy"), got, want):
        _close(a, b, f"parallel_act {k}", EXACT)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nmb", [1, 2])
def test_transformer_minibatches_match_jax(nmb):
    rng = np.random.default_rng(nmb)
    Tb, Nb, Mb = 5, 4, 3
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    fields = dict(
        share_obs=f(Tb + 1, Nb, Mb, 7), obs=f(Tb + 1, Nb, Mb, 5),
        rnn_states=f(Tb + 1, Nb, Mb, 1, 4),
        rnn_states_critic=f(Tb + 1, Nb, Mb, 1, 4),
        actions=f(Tb, Nb, Mb, 1), action_log_probs=f(Tb, Nb, Mb, 1),
        value_preds=f(Tb + 1, Nb, Mb, 1), rewards=f(Tb, Nb, Mb, 1),
        masks=f(Tb + 1, Nb, Mb, 1), bad_masks=f(Tb + 1, Nb, Mb, 1),
        active_masks=f(Tb + 1, Nb, Mb, 1),
        available_actions=f(Tb + 1, Nb, Mb, 5),
        returns=f(Tb, Nb, Mb, 1), advantages=f(Tb, Nb, Mb, 1))
    adv = f(Tb, Nb, Mb, 1)
    jb = j_buf.RolloutBuffer(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = buf_lib.RolloutBuffer(**{k: torch.tensor(v)
                                  for k, v in fields.items()})
    key = jax.random.PRNGKey(3)
    want = j_buf.transformer_minibatches(jb, jnp.asarray(adv), key, nmb)
    perm = None if nmb == 1 else torch.tensor(
        np.asarray(jax.random.permutation(key, Tb * Nb)))
    got = buf_lib.transformer_minibatches(tb, torch.tensor(adv), None, nmb,
                                          perm=perm)
    assert len(got) == nmb
    for i, mb in enumerate(got):
        assert set(mb) == set(want)
        for k, v in mb.items():
            assert v.shape[1] == Mb, k         # the agent axis is kept
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][i]),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# one shared-runner episode in lockstep with JAX
# ---------------------------------------------------------------------------

FLAGS = dict(scenario_name="simple_spread", num_agents=3, num_landmarks=3,
             n_rollout_threads=N, episode_length=T, num_env_steps=N * T,
             ppo_epoch=3, num_mini_batch=1, n_embd=16, lr=5e-4,
             n_eval_rollout_threads=N)
CASES = {
    "mat": dict(algorithm_name="mat"),
    "mat_dec": dict(algorithm_name="mat_dec"),
    "mat_dec_per_agent": dict(algorithm_name="mat", dec_actor=True,
                              share_actor=False),
    "mat_encode_state": dict(algorithm_name="mat", encode_state=True),
    "mat_2_minibatches_lr_decay": dict(algorithm_name="mat", num_mini_batch=2,
                                       use_linear_lr_decay=True,
                                       num_env_steps=4 * N * T),
}


def _worlds(env, seed):
    np.random.seed(seed)
    worlds = [golden.reference_reset("simple_spread", env.spec)
              for _ in range(N)]
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *worlds)


def _jax_episode(case):
    cfg = j_canon(JaxConfig(**{**FLAGS, **CASES[case]})).validate()
    runner = JaxRunner(cfg, eval_env=j_make_vec_env(cfg, n_envs=N))
    state, _ = runner.init(jax.random.PRNGKey(0))
    env = runner.envs.env
    worlds = _worlds(env, 3)
    obs = jax.vmap(lambda s: env.scenario.observation(env.spec, s))(worlds)
    carry = runner._fresh_carry(worlds, obs)

    captured = {}
    train = runner.algo.train

    def capture(ts, buf, key):
        captured["buf"], captured["key"] = buf, key
        return train(ts, buf, key)
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
    perms = None
    if cfg.num_mini_batch > 1:      # MAT.train's epoch keys
        perms = [torch.tensor(np.asarray(jax.random.permutation(k, T * N)))
                 for k in jax.random.split(captured["key"], cfg.ppo_epoch)]

    k_eval = jax.random.PRNGKey(11)
    _, k_reset = jax.random.split(k_eval)
    eval_worlds, _ = runner.eval_envs.reset(k_reset)
    eval_return = float(runner._eval_episode(new_state, k_eval)) \
        if not cfg.encode_state else None
    get = jax.device_get
    return dict(state=get(state), carry=get(carry), buf=get(captured["buf"]),
                new_state=get(new_state), new_carry=get(new_carry),
                metrics=get(metrics), resets=[get(r) for r in resets],
                perms=perms, eval_worlds=get(eval_worlds),
                eval_return=eval_return)


def _port_runner(case, **kw):
    cfg = canonicalize_algorithm(Config(**{**FLAGS, **CASES[case], **kw},
                                        device="cpu"))
    eval_env = make_vec_env(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(1), n_envs=N)
    return SharedRunner(cfg, eval_env=eval_env)


@pytest.mark.parametrize("case", sorted(CASES))
def test_episode_matches_jax_in_lockstep(case):
    j = _jax_episode(case)
    runner = _port_runner(case)
    assert runner.is_mat and isinstance(runner.algo, MAT)
    assert runner.algo.critic_reads == (
        "share_obs" if case == "mat_encode_state" else "obs")
    state = train_state_from_jax(j["state"])
    assert isinstance(state, MATTrainState)
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
              "actions", "action_log_probs", "value_preds", "rewards",
              "masks", "returns", "advantages"):
        _close(getattr(buf, k), getattr(jb, k), k, ROLL)
    for k in ("obs", "rnn_actor", "rnn_critic", "masks"):
        _close(new_carry[k], j["new_carry"][k], f"carry {k}", ROLL)

    new_state, metrics = runner.algo.train(state, buf, None, perms=j["perms"])
    back = train_state_to_jax(new_state, j["new_state"])
    for part in ("params", "opt_state", "vnorm"):
        got = jax.tree_util.tree_leaves(getattr(back, part))
        want = jax.tree_util.tree_leaves(getattr(j["new_state"], part))
        assert len(got) == len(want), part
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{part}[{i}]", TRAINED)
    assert set(metrics) == set(j["metrics"]) - {
        k for k in j["metrics"] if "rewards" in k}
    for k, v in metrics.items():
        _close(float(v), float(j["metrics"][k]), k, TRAINED)

    got = runner.eval_episode(new_state,
                              world_state_from_jax(j["eval_worlds"]))
    assert np.isfinite(float(got))
    if j["eval_return"] is not None:     # JAX's act ignores encode_state
        _close(float(got), j["eval_return"], "eval return", ROLL)


# ---------------------------------------------------------------------------
# the host loop over the MAT state
# ---------------------------------------------------------------------------

def _leaves(state):
    return tree_leaves(state.params) + tree_leaves(state.opt_state)


def test_checkpoint_resume_is_exact(tmp_path):
    """Two episodes in one run equal one episode, a save and a resumed run
    of one more: parameters, Adam moments, ValueNorm and the carry."""
    whole = _port_runner("mat", num_env_steps=2 * N * T, ppo_epoch=1)
    state_a, hist_a = whole.run(log_fn=None, save_dir=tmp_path / "a")
    _port_runner("mat", num_env_steps=N * T, ppo_epoch=1).run(
        log_fn=None, save_dir=tmp_path / "b")
    resumed = _port_runner("mat", num_env_steps=2 * N * T, ppo_epoch=1,
                           model_dir=str(tmp_path / "b"))
    state_b, hist_b = resumed.run(log_fn=None)
    assert resumed.start_episode == 1 and len(hist_b) == 1
    for a, b in zip(_leaves(state_a), _leaves(state_b)):
        assert torch.equal(a, b)
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        assert torch.equal(getattr(state_a.vnorm, k), getattr(state_b.vnorm, k))
    assert hist_b[0]["average_episode_rewards"] == \
        hist_a[-1]["average_episode_rewards"]


def test_episodes_per_call_averages_the_mat_episodes():
    kw = dict(num_env_steps=4 * N * T, ppo_epoch=1, log_interval=1)
    state1, rows1 = _port_runner("mat", **kw).run(log_fn=None)
    state2, rows2 = _port_runner("mat", episodes_per_call=2, **kw).run(
        log_fn=None)
    assert [r["episode"] for r in rows2] == [0, 2]
    for pair, row in zip((rows1[:2], rows1[2:]), rows2):
        for k in ("average_episode_rewards", "value_loss", "grad_norm"):
            np.testing.assert_allclose(row[k], np.mean([r[k] for r in pair]),
                                       rtol=1e-6, err_msg=k)
    for a, b in zip(_leaves(state1), _leaves(state2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config", ["mpe_mat", "mpe_mat_dec"])
def test_train_mpe_runs_the_mat_configs(config, tmp_path, monkeypatch):
    flags = train_mpe.CONFIGS[config]
    for flag, value in (("--n_embd", "64"), ("--lr", "5e-4"),
                        ("--n_rollout_threads", "128"), ("--ppo_epoch", "10")):
        assert flags[flags.index(flag) + 1] == value
    assert "--hidden_size" not in flags and "--critic_lr" not in flags
    monkeypatch.setenv("ONPOLICY_TORCH_RESULTS", str(tmp_path))
    argv = flags + ["--n_rollout_threads", "4", "--num_env_steps",
                    str(2 * 4 * 25), "--ppo_epoch", "1", "--n_embd", "16",
                    "--log_interval", "1", "--use_eval", "--eval_interval",
                    "1", "--n_eval_rollout_threads", "2", "--device", "cpu"]
    _, history = train_mpe.main(argv)
    assert [r["episode"] for r in history] == [0, 1]
    for row in history:
        assert all(np.isfinite(v) for v in row.values()
                   if isinstance(v, float)), row
        assert "eval_average_episode_rewards" in row
