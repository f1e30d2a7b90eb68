"""HATRPO and the GRU's double backward: the port against the JAX package,
on the CPU.

  * `GRULayerSequence` (the kernels' autograd function, here with their
    plain versions inside, as on CPU tensors) refuses a double backward,
    also one taken with `autograd.grad(..., inputs)`;
    the GRU HATRPO runs (`models/gru.sequence` under hatrpo: the plain
    scan) goes through one (its Hessian-vector product equal to JAX's),
    and under bf16 follows JAX's bf16 scan (tests/test_bf16.py's 0.05);
  * `evaluate_trpo` / `evaluate_trpo_seq` (Discrete and MultiDiscrete
    heads) at rtol/atol 1e-5;
  * one TRPO update on a real minibatch (JAX's HATRPO episode, an agent
    second in the order, so its factor is not ones): the Fisher-vector
    product against JAX's forward-over-reverse one at rtol 1e-4, atol
    1e-5 × max|Fv|; the CG direction, the step size, the accepted
    line-search fraction and the trained actor / critic state at rtol
    1e-4 / atol 5e-5, each per leaf (the port's flat order is its own);
    and a case where the search rejects every candidate and the old
    actor is kept;
  * one separated-runner episode of 3 agents in lockstep with JAX's
    (injected draws, resets and agent order): every buffer at 1e-5; the
    factors (made of the trained actors before each agent), the trained
    states and the metrics at rtol 1e-4 / atol 5e-5; the eval return at
    1e-5;
  * `train_mpe` runs `hatrpo_spread`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.envs.mpe import golden
from onpolicy_tpu.envs.mpe import make_vec_env as j_make_vec_env
from onpolicy_tpu.models import actor_critic as j_ac
from onpolicy_tpu.models import gru as j_gru
from onpolicy_tpu.runner.separated_runner import SeparatedRunner as JaxRunner
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms import hatrpo as t_hatrpo
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.models import actor_critic as t_ac
from onpolicy_torch.models import gru as t_gru
from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.runner.separated_runner import SeparatedRunner
from onpolicy_torch.scripts import train_mpe
from onpolicy_torch.utils import spaces as t_sp
from onpolicy_torch.utils.params import (to_numpy, to_torch,
                                         train_state_from_jax,
                                         train_state_to_jax,
                                         world_state_from_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

EXACT = dict(rtol=1e-5, atol=1e-5)
ROLL = dict(rtol=1e-5, atol=1e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
N, T, H = 4, 25, 16
ORDER = (2, 0, 1)


def _close(got, want, name, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


def _leaves_close(got_tree, want_tree, name, tol):
    got = jax.tree_util.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want), name
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"{name}[{i}]", tol)


# ---------------------------------------------------------------------------
# the GRU under a double backward
# ---------------------------------------------------------------------------

def _gru_inputs(seed, T_=5, B=6, D=4, L=1):
    g = torch.Generator().manual_seed(seed)
    cfg = Config(hidden_size=H, recurrent_N=L, device="cpu")
    params = t_gru.init(cfg, D, g, "cpu")
    xs = torch.randn(T_, B, D, generator=g)
    hxs = torch.randn(B, L, H, generator=g)
    masks = (torch.rand(T_, B, 1, generator=g) > 0.2).float()
    return params, xs, hxs, masks


def test_double_backward_through_the_kernels_autograd_function_raises():
    """Through a weight, and in HATRPO's form: every parameter one flat
    vector, the second gradient taken with `inputs` (which prunes torch's
    own `once_differentiable` error node, so that alone would not
    raise). A single backward under create_graph is unchanged."""
    params, xs, hxs, masks = _gru_inputs(0)
    w = params["layers"][0]["w_hh"].requires_grad_(True)
    outs, _ = cuda_gru.sequence(params, xs, hxs, masks)
    g, = torch.autograd.grad(outs.square().sum(), w, create_graph=True)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(g.sum(), w)
    outs, _ = cuda_gru.sequence(params, xs, hxs, masks)
    once, = torch.autograd.grad(outs.square().sum(), w)
    assert torch.equal(g, once)

    theta0, unflatten = t_hatrpo._flatten(params)
    theta = theta0.detach().requires_grad_(True)
    outs, _ = cuda_gru.sequence(unflatten(theta), xs, hxs, masks)
    g, = torch.autograd.grad(outs.square().sum(), theta, create_graph=True)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(g @ torch.ones_like(theta), theta)


def test_hatrpo_sequence_runs_the_scan_which_a_double_backward_goes_through():
    """models/gru.sequence under hatrpo is the plain scan, and its
    Hessian-vector product (reverse over reverse) equals JAX's forward
    over reverse one through JAX's hatrpo GRU."""
    params, xs, hxs, masks = _gru_inputs(1)
    cfg = Config(algorithm_name="hatrpo", hidden_size=H, device="cpu")
    outs, _ = t_gru.sequence(cfg, params, xs, hxs, masks)
    want, _ = t_gru.scan_sequence(params, xs, hxs, masks)
    assert torch.equal(outs, want)
    gen = torch.Generator().manual_seed(2)
    v = torch.randn(H, 3 * H, generator=gen)
    c = torch.randn(*outs.shape, generator=gen)

    w = params["layers"][0]["w_hh"].detach().requires_grad_(True)
    p = {"layers": [{**params["layers"][0], "w_hh": w}],
         "norm": params["norm"]}
    o, _ = t_gru.sequence(cfg, p, xs, hxs, masks)
    g, = torch.autograd.grad((o * c).square().sum(), w, create_graph=True)
    hv, = torch.autograd.grad((g * v).sum(), w)

    jcfg = JaxConfig(algorithm_name="hatrpo", hidden_size=H,
                     share_policy=False)
    jp = jax.tree_util.tree_map(jnp.asarray, to_numpy(params))

    def loss(wj):
        pj = {"layers": [{**jp["layers"][0], "w_hh": wj}], "norm": jp["norm"]}
        oj, _ = j_gru.sequence(jcfg, pj, xs.numpy(), hxs.numpy(),
                               masks.numpy())
        return jnp.sum(jnp.square(oj * c.numpy()))
    _, hv_j = jax.jvp(jax.grad(loss), (jp["layers"][0]["w_hh"],),
                      (v.numpy(),))
    scale = float(jnp.abs(hv_j).max())
    _close(hv, hv_j, "Hessian-vector product", dict(rtol=1e-4,
                                                    atol=1e-5 * scale))
    # an explicit use_pallas_gru=True still asks for the kernels, which
    # exist only on the card
    with pytest.raises(ValueError, match="card only"):
        t_gru.sequence(cfg.replace(use_pallas_gru=True), params, xs, hxs,
                       masks)


def test_hatrpo_bf16_scan_matches_jax():
    params, xs, hxs, masks = _gru_inputs(3, L=2)
    kw = dict(algorithm_name="hatrpo", hidden_size=H, recurrent_N=2,
              use_bf16=True, share_policy=False)
    jcfg = JaxConfig(**kw)
    assert not j_gru._use_pallas(jcfg)
    want_o, want_h = j_gru.sequence(jcfg, jax.tree_util.tree_map(
        jnp.asarray, to_numpy(params)), xs.numpy(), hxs.numpy(),
        masks.numpy())
    got_o, got_h = t_gru.sequence(Config(**kw, device="cpu"), params, xs,
                                  hxs, masks)
    assert got_o.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    assert want_o.dtype == jnp.bfloat16
    # the whole recurrence runs in bf16 on both sides, and the two
    # frameworks round its steps at other places: tests/test_bf16.py's
    # bf16-model tolerance
    bf16 = dict(rtol=5e-2, atol=5e-2)
    _close(got_o.float(), want_o.astype(jnp.float32), "outs", bf16)
    _close(got_h, want_h, "final state", bf16)


# ---------------------------------------------------------------------------
# evaluate_trpo(_seq)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space", ["discrete", "multidiscrete"])
@pytest.mark.parametrize("recurrent", [False, True])
def test_evaluate_trpo_matches_jax(space, recurrent):
    rng = np.random.default_rng(5)
    L, Bq, D = 4, 6, 7
    kw = dict(hidden_size=H, use_recurrent_policy=recurrent)
    jcfg, tcfg = JaxConfig(**kw), Config(**kw, device="cpu")
    if space == "discrete":
        jsp, tsp, heads = j_sp.Discrete(5), t_sp.Discrete(5), [5]
    else:
        jsp, tsp = j_sp.MultiDiscrete([3, 4]), t_sp.MultiDiscrete([3, 4])
        heads = [3, 4]
    ja = j_ac.Actor(jcfg, j_sp.Box((D,)), jsp)
    ta = t_ac.Actor(tcfg, t_sp.Box((D,)), tsp)
    params = jax.device_get(ja.init(jax.random.PRNGKey(1)))
    tp = to_torch(params)
    obs = rng.standard_normal((L, Bq, D)).astype(np.float32)
    rnn = rng.standard_normal((Bq, 1, H)).astype(np.float32)
    actions = np.stack([rng.integers(0, n, (L, Bq)) for n in heads],
                       -1).astype(np.float32)
    masks = (rng.random((L, Bq, 1)) > 0.2).astype(np.float32)
    active = (rng.random((L, Bq, 1)) > 0.1).astype(np.float32)
    avail = None
    if space == "discrete":
        avail = (rng.random((L, Bq, 5)) > 0.3).astype(np.float32)
        avail[..., 0] = 1.0
    t = lambda x: None if x is None else torch.tensor(x)
    flat = lambda x: None if x is None else x.reshape(L * Bq, *x.shape[2:])
    want = ja.evaluate_trpo(params, flat(obs), np.repeat(rnn, L, 0),
                            flat(actions), flat(masks), flat(avail),
                            flat(active))
    got = ta.evaluate_trpo(tp, t(flat(obs)), t(np.repeat(rnn, L, 0)),
                           t(flat(actions)), t(flat(masks)), t(flat(avail)),
                           t(flat(active)))
    for name, a, b in zip(("logp", "entropy", "mu", "std", "logits"),
                          got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, f"evaluate_trpo {name}", EXACT)
    if not recurrent:
        return
    want = ja.evaluate_trpo_seq(params, obs, rnn, actions, masks, avail,
                                active)
    got = ta.evaluate_trpo_seq(tp, t(obs), t(rnn), t(actions), t(masks),
                               t(avail), t(active))
    for name, a, b in zip(("logp", "entropy", "mu", "std", "logits"),
                          got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, f"evaluate_trpo_seq {name}", EXACT)


# ---------------------------------------------------------------------------
# JAX's HATRPO episode, shared by the tests below
# ---------------------------------------------------------------------------

def _flags(**kw):
    return dict(algorithm_name="hatrpo", scenario_name="simple_spread",
                num_agents=3, num_landmarks=3, n_rollout_threads=N,
                episode_length=T, num_env_steps=N * T, hidden_size=H,
                data_chunk_length=10, num_mini_batch=1, lr=7e-4,
                critic_lr=7e-4, n_eval_rollout_threads=N, **kw)


def _jax_runner(**kw):
    cfg = j_canon(JaxConfig(**_flags(**kw))).validate()
    return JaxRunner(cfg, eval_env=j_make_vec_env(cfg, n_envs=N))


def _port_runner(**kw):
    cfg = canonicalize_algorithm(Config(**_flags(**kw), device="cpu"))
    eval_env = make_vec_env(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), n_envs=N)
    return SeparatedRunner(cfg, eval_env=eval_env)


@pytest.fixture(scope="module")
def jax_episode():
    runner = _jax_runner()
    states, _ = runner.init(jax.random.PRNGKey(0))
    env = runner.envs.env
    M = env.num_agents
    np.random.seed(3)
    worlds = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x),
        *[golden.reference_reset("simple_spread", env.spec)
          for _ in range(N)])
    obs = jax.vmap(lambda s: env.scenario.observation(env.spec, s))(worlds)
    zeros = tuple(jnp.zeros((N, 1, H)) for _ in range(M))
    carry = {"env_states": worlds, "obs": tuple(obs), "rnn_actor": zeros,
             "rnn_critic": zeros, "masks": jnp.ones((N, 1))}

    captured = {}
    for i, algo in enumerate(runner.algos):
        def capture(ts, buf, key, factor=None, i=i, train=algo.train):
            captured[i] = (ts, buf, key, factor)
            return train(ts, buf, key, factor=factor)
        algo.train = capture
    key = jax.random.PRNGKey(7)
    new_states, new_carry, metrics = runner._episode(ORDER, states, carry,
                                                     key)
    _, k_scan, _ = jax.random.split(key, 3)
    resets = []
    for step_key in jax.random.split(k_scan, T):
        k_env = jax.random.split(step_key, M + 1)[-1]
        _, k_reset = jax.random.split(k_env)
        resets.append(jax.vmap(env.reset)(jax.random.split(k_reset, N))[0])
    k_eval = jax.random.PRNGKey(11)
    _, k_reset = jax.random.split(k_eval)
    eval_worlds, _ = runner.eval_envs.reset(k_reset)
    eval_return = float(runner._eval_episode(new_states, k_eval))
    get = jax.device_get
    return dict(runner=runner, states=get(states), carry=get(carry),
                captured={i: get(v) for i, v in captured.items()},
                new_states=get(new_states), new_carry=get(new_carry),
                metrics=get(metrics), resets=[get(r) for r in resets],
                eval_worlds=get(eval_worlds), eval_return=eval_return)


def _port_buffer(jb) -> buf_lib.RolloutBuffer:
    return buf_lib.RolloutBuffer(**{
        k: None if getattr(jb, k) is None else torch.tensor(
            np.asarray(getattr(jb, k)))
        for k in buf_lib.RolloutBuffer.__dataclass_fields__})


def _minibatches(j_algo, t_algo, jb, factor):
    """One minibatch of agent's buffer `jb`, from each package's sampler."""
    cfg = j_algo.cfg
    from onpolicy_tpu.ops import losses as j_losses
    adv = j_losses.normalize_advantages(
        jb.advantages,
        jb.active_masks[:-1] if cfg.use_policy_active_masks else None)
    j_mb = jax.tree_util.tree_map(
        lambda x: x[0], j_algo._sample_minibatches(
            jax.tree_util.tree_map(jnp.asarray, jb), adv,
            jax.random.PRNGKey(0), factor=jnp.asarray(factor)))
    tb = _port_buffer(jb)
    from onpolicy_torch.ops import losses as t_losses
    t_adv = t_losses.normalize_advantages(tb.advantages, tb.active_masks[:-1])
    t_mb = t_algo._sample_minibatches(tb, t_adv, None,
                                      factor=torch.tensor(np.asarray(factor)))
    return j_mb, t_mb[0]


def _jax_trpo_pieces(algo, state, mb, v_tree):
    """JAX's TRPO step up to the line search, from JAX's own
    `_policy_outputs` and `_kl`, in the order of its `_trpo_update`
    (which keeps these in its jitted body): g, F·v, the CG direction, the
    step size and the accepted fraction (0 when rejected)."""
    cfg = algo.cfg
    active = mb["active_masks"]
    am = mb["active_masks"].reshape(-1, 1)
    factor = mb["factor"].reshape(-1, 1)
    old_logp = mb["old_action_log_probs"].reshape(
        -1, mb["old_action_log_probs"].shape[-1])
    adv = mb["advantages"].reshape(-1, 1)
    theta0, unravel = ravel_pytree(state.actor_params)
    outputs = lambda th: algo._policy_outputs(unravel(th), mb, True, active)

    def surrogate(th):
        ratio = jnp.exp(jnp.sum(outputs(th)[0] - old_logp, -1,
                                keepdims=True))
        return jnp.sum(ratio * factor * adv * am) / jnp.maximum(
            jnp.sum(am), 1e-8)
    old_out = jax.lax.stop_gradient(
        algo._policy_outputs(state.actor_params, mb, True, active))
    kl_mean = lambda th: jnp.mean(algo._kl(outputs(th), old_out))
    loss0, g = jax.value_and_grad(surrogate)(theta0)
    fvp = lambda v: jax.jvp(jax.grad(kl_mean), (theta0,), (v,))[1] \
        + 0.1 * v
    x, r, p, rdotr = jnp.zeros_like(g), g, g, g @ g
    for _ in range(10):
        Ap = fvp(p)
        alpha = rdotr / jnp.maximum(p @ Ap, 1e-12)
        x, r = x + alpha * p, r - alpha * Ap
        new = r @ r
        p, rdotr = r + new / jnp.maximum(rdotr, 1e-12) * p, new
    step_size = 1.0 / jnp.sqrt(jnp.maximum(
        0.5 * (x @ fvp(x)) / cfg.kl_threshold, 1e-12))
    full = step_size * x
    expected0 = g @ full
    fraction = 0.0
    for i in range(cfg.ls_step):
        cand = theta0 + 0.5 ** i * full
        improve = surrogate(cand) - loss0
        if (kl_mean(cand) < cfg.kl_threshold
                and improve / max(expected0 * 0.5 ** i, 1e-12)
                > cfg.accept_ratio and improve > 0):
            fraction = 0.5 ** i
            break
    fv = fvp(ravel_pytree(v_tree)[0])
    return dict(g=unravel(g), fv=unravel(fv), step_dir=unravel(x),
                step_size=float(step_size), fraction=fraction,
                full_step=unravel(full))


@pytest.mark.parametrize("accept_ratio", [0.5, 1e9])
def test_trpo_update_matches_jax(jax_episode, accept_ratio):
    """Agent 0, second in the order (2, 0, 1): its factor is agent 2's.
    With accept_ratio 1e9 every candidate is rejected."""
    agent = 0
    jr = _jax_runner(accept_ratio=accept_ratio)
    tr = _port_runner(accept_ratio=accept_ratio)
    j_algo, t_algo = jr.algos[agent], tr.algos[agent]
    assert isinstance(t_algo, t_hatrpo.HATRPO)
    j_state, jb, _, factor = jax_episode["captured"][agent]
    assert not np.allclose(np.asarray(factor), 1.0)
    j_mb, t_mb = _minibatches(j_algo, t_algo, jb, factor)
    t_state = train_state_from_jax(j_state)

    rng = np.random.default_rng(9)
    v_tree = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        j_state.actor_params)
    want = _jax_trpo_pieces(j_algo, jax.tree_util.tree_map(jnp.asarray,
                                                           j_state),
                            j_mb, v_tree)

    fvp = t_algo.fisher_vector_product(t_state, t_mb)
    _, unflatten = t_hatrpo._flatten(t_state.actor_params)
    v_flat = torch.cat([torch.tensor(x).reshape(-1)
                        for x in tree_leaves(v_tree)])
    fv = to_numpy(unflatten(fvp(v_flat)))
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(fv),
                                   jax.tree_util.tree_leaves(want["fv"]))):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a, b, f"F·v[{i}]", dict(rtol=1e-4, atol=1e-5 * scale))

    step = t_algo.natural_step(t_state, t_mb)
    _leaves_close(to_numpy(step.unflatten(step.g)), want["g"], "g", TRAINED)
    _leaves_close(to_numpy(step.unflatten(step.step_dir)), want["step_dir"],
                  "CG direction", TRAINED)
    _close(float(step.step_size), want["step_size"], "step size", TRAINED)
    old_out = t_algo._old_outputs(t_state, t_mb)
    _, fraction, *_ = t_algo.line_search(step, t_mb, old_out)
    assert fraction == want["fraction"]
    assert (fraction == 0.0) == (accept_ratio > 1)

    j_new, j_metrics = j_algo._trpo_update(
        jax.tree_util.tree_map(jnp.asarray, j_state), j_mb)
    j_new, j_metrics = jax.device_get((j_new, j_metrics))
    # JAX's own update took the step the pieces above describe
    moved = jax.tree_util.tree_map(
        lambda n, o, s: np.asarray(n) - np.asarray(o) - fraction * s,
        j_new.actor_params, j_state.actor_params, want["full_step"])
    for x in jax.tree_util.tree_leaves(moved):
        assert np.abs(x).max() < 1e-5
    t_new, t_metrics = t_algo._trpo_update(t_state, t_mb)
    back = train_state_to_jax(t_new, j_new)
    for part in ("actor_params", "critic_params", "critic_opt_state",
                 "vnorm"):
        _leaves_close(getattr(back, part), getattr(j_new, part), part,
                      TRAINED)
    if fraction == 0.0:          # rejected: the old actor is kept exactly
        for a, b in zip(tree_leaves(t_new.actor_params),
                        tree_leaves(t_state.actor_params)):
            assert torch.equal(a, b)
    assert set(t_metrics) == set(j_metrics)
    for k, v in t_metrics.items():
        _close(float(v), float(j_metrics[k]), k, dict(rtol=1e-4, atol=1e-6))


def test_episode_matches_jax_in_lockstep(jax_episode):
    j = jax_episode
    runner = _port_runner()
    M = runner.num_agents
    assert runner.is_happo
    assert all(isinstance(a, t_hatrpo.HATRPO) for a in runner.algos)
    states = tuple(train_state_from_jax(s) for s in j["states"])
    c = j["carry"]
    tensors = lambda xs: tuple(torch.tensor(np.asarray(x)) for x in xs)
    carry = {"env_states": world_state_from_jax(c["env_states"]),
             "obs": tensors(c["obs"]), "rnn_actor": tensors(c["rnn_actor"]),
             "rnn_critic": tensors(c["rnn_critic"]),
             "masks": torch.tensor(np.asarray(c["masks"]))}
    bufs_j = [j["captured"][i][1] for i in range(M)]
    inject = [{"actions": [torch.tensor(np.asarray(b.actions[t, :, 0]))
                           for b in bufs_j],
               "reset_states": world_state_from_jax(j["resets"][t])}
              for t in range(T)]
    new_carry, bufs = runner.rollout(states, carry, inject)
    for i in range(M):
        for k in ("obs", "share_obs", "rnn_states", "rnn_states_critic",
                  "actions", "action_log_probs", "value_preds", "rewards",
                  "masks", "returns", "advantages"):
            _close(getattr(bufs[i], k), getattr(bufs_j[i], k),
                   f"agent{i} {k}", ROLL)

    factors = {}
    for i, algo in enumerate(runner.algos):
        def capture(ts, buf, generator, factor=None, i=i, train=algo.train):
            factors[i] = factor
            return train(ts, buf, generator, factor=factor)
        algo.train = capture
    new_states, metrics = runner.update(states, bufs, ORDER)
    # a factor is made of the trained actors before it, so it is held as
    # a trained state is
    for i in range(M):
        _close(factors[i], j["captured"][i][3], f"agent{i} factor", TRAINED)
    assert torch.equal(factors[ORDER[0]], torch.ones(T, N, 1, 1))
    for i in range(M):
        back = train_state_to_jax(new_states[i], j["new_states"][i])
        for part in ("actor_params", "critic_params", "actor_opt_state",
                     "critic_opt_state", "vnorm"):
            _leaves_close(getattr(back, part),
                          getattr(j["new_states"][i], part),
                          f"agent{i} {part}", TRAINED)
        for k, v in j["metrics"][f"agent{i}"].items():
            _close(float(metrics[f"agent{i}/{k}"]), float(v), k,
                   dict(rtol=1e-4, atol=1e-6))
        assert float(metrics[f"agent{i}/accepted"]) == 1.0

    got = runner.eval_episode(new_states,
                              world_state_from_jax(j["eval_worlds"]))
    _close(float(got), j["eval_return"], "eval return", ROLL)


def test_train_mpe_runs_hatrpo_spread(tmp_path, monkeypatch):
    flags = train_mpe.CONFIGS["hatrpo_spread"]
    happo = train_mpe.CONFIGS["happo_spread"]
    assert flags == [("hatrpo" if f == "happo" else f) for f in happo]
    monkeypatch.setenv("ONPOLICY_TORCH_RESULTS", str(tmp_path))
    argv = flags + ["--n_rollout_threads", "4", "--num_env_steps",
                    str(2 * 4 * 25), "--hidden_size", "16",
                    "--log_interval", "1", "--use_eval", "--eval_interval",
                    "1", "--n_eval_rollout_threads", "2", "--device", "cpu"]
    _, history = train_mpe.main(argv)
    assert [r["episode"] for r in history] == [0, 1]
    for row in history:
        assert all(np.isfinite(v) for v in row.values()
                   if isinstance(v, float)), row
        assert "eval_average_episode_rewards" in row
