"""The port's networks against the JAX package's, with parameters carried
across by `onpolicy_torch/utils/params.py`.

JAX initializes the parameters; the same numpy arrays go into both sides
together with inputs drawn from a numpy seed. Everything is f32 on the
CPU, where the two frameworks sum in different orders: forward values are
held at rtol/atol 1e-5 and gradients at 2e-4 / 2e-5, the tolerances of
tests/test_pallas_gru.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.models import act as j_act
from onpolicy_tpu.models import actor_critic as j_ac
from onpolicy_tpu.models import gru as j_gru
from onpolicy_tpu.models import mlp as j_mlp
from onpolicy_tpu.ops import distributions as j_dist
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch.config import Config
from onpolicy_torch.models import act, actor_critic, gru, mlp
from onpolicy_torch.ops import distributions as dist
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.params import to_torch
from onpolicy_torch.utils.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
KW = dict(hidden_size=16, use_ReLU=False, recurrent_N=1,
          algorithm_name="rmappo")


def _cfgs(**kw):
    kw = {**KW, **kw}
    return JaxConfig(**kw), Config(device="cpu", **kw)


def _np(x):
    return np.asarray(jax.device_get(x))


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_mlp_matches():
    jc, tc = _cfgs(layer_N=2)
    params = jax.device_get(j_mlp.init(jax.random.PRNGKey(0), jc, 18))
    x = _rng().standard_normal((37, 18)).astype(np.float32)
    want = j_mlp.apply(jc, params, x)
    got = mlp.apply(tc, to_torch(params), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **FWD)


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_step_matches(layers):
    jc, tc = _cfgs(recurrent_N=layers)
    params = jax.device_get(j_gru.init(jax.random.PRNGKey(1), jc, 16))
    r = _rng(layers)
    x = r.standard_normal((9, 16)).astype(np.float32)
    h = r.standard_normal((9, layers, 16)).astype(np.float32)
    m = (r.random((9, 1)) > 0.3).astype(np.float32)
    j_out, j_h = j_gru.step(jc, params, x, h, m)
    t_out, t_h = gru.step(tc, to_torch(params), torch.tensor(x),
                          torch.tensor(h), torch.tensor(m))
    np.testing.assert_allclose(t_out.numpy(), _np(j_out), **FWD)
    np.testing.assert_allclose(t_h.numpy(), _np(j_h), **FWD)


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_sequence_scan_matches_with_grads(layers):
    """The CPU path of `gru.sequence` (the plain scan) against JAX's scan:
    outputs, final state and the gradients of every parameter."""
    jc, tc = _cfgs(recurrent_N=layers)
    params = jax.device_get(j_gru.init(jax.random.PRNGKey(2), jc, 12))
    r = _rng(10 + layers)
    xs = r.standard_normal((8, 6, 12)).astype(np.float32)
    h0 = r.standard_normal((6, layers, 16)).astype(np.float32)
    masks = (r.random((8, 6, 1)) > 0.3).astype(np.float32)
    masks[0] = 0.0
    w_out = (r.standard_normal((16, 3)) / 4).astype(np.float32)

    def j_loss(p):
        outs, hT = j_gru.sequence(jc, p, xs, h0, masks)
        return jnp.sum((outs @ w_out) ** 2) + jnp.sum(hT * hT)
    j_grads = jax.device_get(jax.grad(j_loss)(params))

    p = to_torch(params)
    leaves = [x.requires_grad_() for x in tree_leaves(p)]
    p = tree_unflatten(p, leaves)
    outs, hT = gru.sequence(tc, p, torch.tensor(xs), torch.tensor(h0),
                            torch.tensor(masks))
    j_outs, j_hT = j_gru.sequence(jc, params, xs, h0, masks)
    np.testing.assert_allclose(outs.detach().numpy(), _np(j_outs), **FWD)
    np.testing.assert_allclose(hT.detach().numpy(), _np(j_hT), **FWD)
    loss = ((outs @ torch.tensor(w_out)) ** 2).sum() + (hT * hT).sum()
    for got, want in zip(torch.autograd.grad(loss, leaves),
                         tree_leaves(j_grads)):
        np.testing.assert_allclose(got.numpy(), want, **GRAD)


def test_gru_sequence_refuses_kernel_flag_on_cpu():
    _, tc = _cfgs()
    p = to_torch(jax.device_get(j_gru.init(jax.random.PRNGKey(0),
                                           _cfgs()[0], 4)))
    with pytest.raises(ValueError, match="card only"):
        gru.sequence(tc.replace(use_pallas_gru=True), p,
                     torch.zeros(2, 3, 4), torch.zeros(3, 1, 16),
                     torch.ones(2, 3, 1))


def _actor_pair(n_act=5, obs_dim=18, seed=3):
    jc, tc = _cfgs()
    ja = j_ac.Actor(jc, j_sp.Box((obs_dim,)), j_sp.Discrete(n_act))
    ta = actor_critic.Actor(tc, sp.Box((obs_dim,)), sp.Discrete(n_act))
    return ja, ta, jax.device_get(ja.init(jax.random.PRNGKey(seed)))


def test_actor_evaluate_seq_matches():
    ja, ta, params = _actor_pair()
    r = _rng(4)
    L, B = 10, 7
    obs = r.standard_normal((L, B, 18)).astype(np.float32)
    h0 = r.standard_normal((B, 1, 16)).astype(np.float32)
    act = r.integers(0, 5, (L, B, 1)).astype(np.float32)
    masks = (r.random((L, B, 1)) > 0.2).astype(np.float32)
    active = (r.random((L, B, 1)) > 0.1).astype(np.float32)
    j_lp, j_ent = ja.evaluate_seq(params, obs, h0, act, masks, None, active)
    t_lp, t_ent = ta.evaluate_seq(
        to_torch(params), *map(torch.tensor, (obs, h0, act, masks)), None,
        torch.tensor(active))
    assert t_lp.shape == (L, B, 1)
    np.testing.assert_allclose(t_lp.numpy(), _np(j_lp), **FWD)
    np.testing.assert_allclose(float(t_ent), float(j_ent), **FWD)


def test_actor_forward_with_given_actions_matches_evaluate():
    """A rollout step with injected actions returns their log-probs and
    the same new rnn state as JAX's step."""
    ja, ta, params = _actor_pair()
    r = _rng(5)
    obs = r.standard_normal((11, 18)).astype(np.float32)
    h = r.standard_normal((11, 1, 16)).astype(np.float32)
    m = np.ones((11, 1), np.float32)
    act = r.integers(0, 5, (11, 1)).astype(np.float32)
    j_lp, _ = ja.evaluate(params, obs, h, act, m)
    _, _, j_h = ja.forward(params, obs, h, m, jax.random.PRNGKey(0))
    t_act, t_lp, t_h = ta.forward(to_torch(params), torch.tensor(obs),
                                  torch.tensor(h), torch.tensor(m), None,
                                  actions=torch.tensor(act))
    assert torch.equal(t_act, torch.tensor(act))
    np.testing.assert_allclose(t_lp.numpy(), _np(j_lp), **FWD)
    np.testing.assert_allclose(t_h.numpy(), _np(j_h), **FWD)


def test_critic_values_match():
    jc, tc = _cfgs()
    jcr = j_ac.Critic(jc, j_sp.Box((54,)))
    tcr = actor_critic.Critic(tc, sp.Box((54,)))
    params = jax.device_get(jcr.init(jax.random.PRNGKey(6)))
    r = _rng(6)
    obs = r.standard_normal((10, 5, 54)).astype(np.float32)
    h0 = r.standard_normal((5, 1, 16)).astype(np.float32)
    masks = (r.random((10, 5, 1)) > 0.2).astype(np.float32)
    j_v = jcr.forward_seq(params, obs, h0, masks)
    t_v = tcr.forward_seq(to_torch(params), *map(torch.tensor, (obs, h0, masks)))
    np.testing.assert_allclose(t_v.numpy(), _np(j_v), **FWD)
    j_v1, j_h1 = jcr.forward(params, obs[0], h0, masks[0])
    t_v1, t_h1 = tcr.forward(to_torch(params), *map(torch.tensor,
                                                    (obs[0], h0, masks[0])))
    np.testing.assert_allclose(t_v1.numpy(), _np(j_v1), **FWD)
    np.testing.assert_allclose(t_h1.numpy(), _np(j_h1), **FWD)


def test_categorical_masked_logprob_and_entropy_match():
    """Masked logits (−1e10) and the 0·log 0 entropy rule."""
    r = _rng(7)
    logits = r.standard_normal((6, 5)).astype(np.float32)
    avail = (r.random((6, 5)) > 0.4).astype(np.float32)
    avail[:, 0] = 1.0
    avail[0] = [1, 0, 0, 0, 0]            # one action left: entropy 0
    act = np.zeros((6, 1), np.float32)
    jd = j_dist.Categorical.create(logits, avail)
    td = dist.Categorical.create(torch.tensor(logits), torch.tensor(avail))
    np.testing.assert_allclose(td.log_prob(torch.tensor(act)).numpy(),
                               _np(jd.log_prob(act)), **FWD)
    np.testing.assert_allclose(td.entropy().numpy(), _np(jd.entropy()), **FWD)
    assert float(td.entropy()[0]) == 0.0


def test_categorical_sampling_frequencies():
    """20k draws from a fixed generator land within 0.02 of the softmax
    (sampling error of a frequency at n=20k is below 0.004)."""
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5]])
    d = dist.Categorical.create(logits.expand(20000, 5))
    g = torch.Generator().manual_seed(0)
    a = d.sample(g)
    assert a.shape == (20000, 1)
    freq = torch.bincount(a[:, 0], minlength=5).float() / 20000
    np.testing.assert_allclose(freq.numpy(), d.probs[0].numpy(), atol=0.02)
    assert torch.equal(a, dist.Categorical.create(logits.expand(20000, 5))
                       .sample(torch.Generator().manual_seed(0)))


def test_multidiscrete_head_matches():
    """simple_reference's (5, 10) head: per-head log-probs [B, 2] of
    injected actions (JAX's draws) and of each head's mode, and the
    entropy as the mean of the heads' active-mask-reduced entropies."""
    jc, tc = _cfgs(gain=1.0)
    j_space, t_space = j_sp.MultiDiscrete((5, 10)), sp.MultiDiscrete((5, 10))
    params = jax.device_get(j_act.init(jax.random.PRNGKey(3), jc, j_space,
                                       16))
    assert [p["w"].shape for p in params["heads"]] == [(16, 5), (16, 10)]
    tp = to_torch(params)
    r = _rng(20)
    x = r.standard_normal((33, 16)).astype(np.float32)
    active = (r.random((33, 1)) > 0.3).astype(np.float32)
    j_a, j_lp = j_act.sample(jc, params, j_space, x, jax.random.PRNGKey(4))
    t_a, t_lp = act.sample(tc, tp, t_space, torch.tensor(x), None,
                           actions=torch.tensor(np.asarray(j_a)))
    assert t_a.shape == t_lp.shape == (33, 2)
    np.testing.assert_array_equal(t_a.numpy(), _np(j_a))
    np.testing.assert_allclose(t_lp.numpy(), _np(j_lp), **FWD)
    j_m, j_mlp = j_act.sample(jc, params, j_space, x, jax.random.PRNGKey(0),
                              deterministic=True)
    t_m, t_mlp = act.sample(tc, tp, t_space, torch.tensor(x), None,
                            deterministic=True)
    np.testing.assert_array_equal(t_m.numpy(), _np(j_m))
    np.testing.assert_allclose(t_mlp.numpy(), _np(j_mlp), **FWD)
    # a draw from the port's generator gives valid indices of each head
    t_d, _ = act.sample(tc, tp, t_space, torch.tensor(x),
                        torch.Generator().manual_seed(0))
    assert (t_d[:, 0] < 5).all() and (t_d[:, 1] < 10).all()
    assert len(set(t_d[:, 1].tolist())) > 1
    j_lp2, j_ent = j_act.evaluate(jc, params, j_space, x, j_a, None, active)
    t_lp2, t_ent = act.evaluate(tc, tp, t_space, torch.tensor(x), t_a, None,
                                torch.tensor(active))
    np.testing.assert_allclose(t_lp2.numpy(), _np(j_lp2), **FWD)
    np.testing.assert_allclose(float(t_ent), float(j_ent), **FWD)


@pytest.mark.parametrize("space", ["discrete", "multidiscrete"])
def test_actor_deterministic_forward_matches(space):
    """`Actor.forward(deterministic=True)`: the mode of each head after
    the MLP and the GRU step, its log-probs and the new rnn state."""
    jc, tc = _cfgs()
    j_space, t_space = ((j_sp.Discrete(5), sp.Discrete(5)) if space ==
                        "discrete" else (j_sp.MultiDiscrete((5, 10)),
                                         sp.MultiDiscrete((5, 10))))
    ja = j_ac.Actor(jc, j_sp.Box((21,)), j_space)
    ta = actor_critic.Actor(tc, sp.Box((21,)), t_space)
    params = jax.device_get(ja.init(jax.random.PRNGKey(5)))
    r = _rng(21)
    obs = r.standard_normal((17, 21)).astype(np.float32)
    h = r.standard_normal((17, 1, 16)).astype(np.float32)
    m = (r.random((17, 1)) > 0.3).astype(np.float32)
    j_a, j_lp, j_h = ja.forward(params, obs, h, m, jax.random.PRNGKey(0),
                                None, True)
    t_a, t_lp, t_h = ta.forward(to_torch(params), torch.tensor(obs),
                                torch.tensor(h), torch.tensor(m), None,
                                deterministic=True)
    np.testing.assert_array_equal(t_a.numpy(), _np(j_a))
    np.testing.assert_allclose(t_lp.numpy(), _np(j_lp), **FWD)
    np.testing.assert_allclose(t_h.numpy(), _np(j_h), **FWD)


def test_unported_heads_name_their_roadmap_item():
    """The Box head, refused until B4 was ported: the port's own init has
    JAX's layout (a [16, 2] mean and a zero log_std), and on JAX's
    parameters its mode and log-probs are JAX's."""
    jc, tc = _cfgs()
    mine = act.init(tc, sp.Box((2,)), 16, torch.Generator().manual_seed(0),
                    "cpu")
    params = jax.device_get(j_act.init(jax.random.PRNGKey(3), jc,
                                       j_sp.Box((2,)), 16))
    assert [tuple(v.shape) for v in tree_leaves(mine)] == \
        [tuple(v.shape) for v in jax.tree_util.tree_leaves(params)] == \
        [(2,), (2,), (16, 2)]  # log_std, mean b, mean w
    assert not mine["log_std"].any()
    x = _rng(5).standard_normal((11, 16)).astype(np.float32)
    j_a, j_lp = j_act.sample(jc, params, j_sp.Box((2,)), x,
                             jax.random.PRNGKey(0), deterministic=True)
    t_a, t_lp = act.sample(tc, to_torch(params), sp.Box((2,)),
                           torch.tensor(x), None, deterministic=True)
    np.testing.assert_allclose(t_a.numpy(), _np(j_a), **FWD)
    np.testing.assert_allclose(t_lp.numpy(), _np(j_lp), **FWD)

