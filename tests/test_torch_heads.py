"""The port's remaining heads, the CNN base and PopArt against the JAX
package, with parameters carried across by `onpolicy_torch/utils/params.py`.

  * DiagGaussian and Bernoulli: samples fed JAX's own standard normal and
    uniform draws, log-prob, entropy, mode and the gaussian KL;
  * the act heads of every space (Discrete, Box, MultiBinary,
    MultiDiscrete, the mixed Box+Discrete with its 1/2 + 1/0.98 entropy
    weights): the mode, the log-probs of JAX's sampled actions,
    `evaluate` with active masks and its gradients, `evaluate_trpo` and
    `get_probs` where JAX has them;
  * the CNN `Actor` / `Critic` on a Box((4, 10, 10)) image space, flat and
    sequence layouts, forward and gradients (the kernel HWIO → OIHW);
  * `popart.update` over successive batches, and the PopArt invariance of
    JAX's tests/test_valuenorm.py;
  * HATRPO's TRPO step on a Box head (the gaussian KL) under `use_popart`
    against JAX's `_trpo_update`.
f32 on the CPU: forward values at rtol/atol 1e-5, gradients at 2e-4 /
2e-5, a trained state at rtol 1e-4 / atol 5e-5 (tests/test_torch_slice.py
says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.algorithms.hatrpo import HATRPO as JHATRPO
from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.models import act as j_act
from onpolicy_tpu.models import actor_critic as j_ac
from onpolicy_tpu.models import popart as j_popart
from onpolicy_tpu.ops import distributions as j_dist
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch.algorithms.hatrpo import HATRPO
from onpolicy_torch.config import Config
from onpolicy_torch.models import act, actor_critic, popart
from onpolicy_torch.ops import distributions as dist
from onpolicy_torch.ops import valuenorm as vn
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.params import (to_torch, train_state_from_jax,
                                         train_state_to_jax,
                                         valuenorm_from_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
H = 16


def _close(got, want, name, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


def _cfgs(**kw):
    kw = {"hidden_size": H, "use_ReLU": False, "algorithm_name": "rmappo",
          **kw}
    return JaxConfig(**kw), Config(device="cpu", **kw)


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------

def test_diag_gaussian_matches_jax():
    r = np.random.default_rng(0)
    mean, log_std, mean2, log_std2 = (
        r.standard_normal((9, 3)).astype(np.float32) * s
        for s in (1.0, 0.5, 1.0, 0.5))
    jd = j_dist.DiagGaussian(jnp.asarray(mean), jnp.asarray(log_std))
    td = dist.DiagGaussian(torch.tensor(mean), torch.tensor(log_std))
    key = jax.random.PRNGKey(4)
    want = jd.sample(key)
    eps = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
    got = td.sample(noise=torch.tensor(eps))
    _close(got, want, "sample", FWD)
    _close(td.mode(), jd.mode(), "mode", FWD)
    _close(td.std, jd.std, "std", FWD)
    lp = td.log_prob(got)
    assert lp.shape == (9, 1)
    _close(lp, jd.log_prob(want), "log_prob", FWD)
    _close(td.entropy(), jd.entropy(), "entropy", FWD)
    other_t = dist.DiagGaussian(torch.tensor(mean2), torch.tensor(log_std2))
    other_j = j_dist.DiagGaussian(jnp.asarray(mean2), jnp.asarray(log_std2))
    _close(td.kl(other_t), jd.kl(other_j), "kl", FWD)
    # from a generator: the same law, other draws
    g = td.sample(torch.Generator().manual_seed(0))
    assert g.shape == (9, 3) and not torch.equal(g, got)


def test_bernoulli_matches_jax():
    r = np.random.default_rng(1)
    logits = r.standard_normal((9, 4)).astype(np.float32) * 2.0
    jd = j_dist.Bernoulli(jnp.asarray(logits))
    td = dist.Bernoulli(torch.tensor(logits))
    key = jax.random.PRNGKey(5)
    want = jd.sample(key)
    u = np.asarray(jax.random.uniform(key, logits.shape))
    got = td.sample(uniform=torch.tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(td.mode(), jd.mode(), "mode", FWD)
    _close(td.probs, jd.probs, "probs", FWD)
    _close(td.log_prob(got), jd.log_prob(want), "log_prob", FWD)
    _close(td.entropy(), jd.entropy(), "entropy", FWD)


# ---------------------------------------------------------------------------
# the act heads
# ---------------------------------------------------------------------------

SPACES = {
    "discrete": (j_sp.Discrete(5), sp.Discrete(5)),
    "box": (j_sp.Box((3,)), sp.Box((3,))),
    "multibinary": (j_sp.MultiBinary(4), sp.MultiBinary(4)),
    "multidiscrete": (j_sp.MultiDiscrete((3, 4)), sp.MultiDiscrete((3, 4))),
    "mixed": (j_sp.MixedSpace(2, 4), sp.MixedSpace(2, 4)),
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_head_matches_jax(name):
    jspace, tspace = SPACES[name]
    jc, tc = _cfgs(gain=0.5)
    params = jax.device_get(j_act.init(jax.random.PRNGKey(2), jc, jspace, H))
    mine = act.init(tc, tspace, H, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(params)]
    tp = to_torch(params)
    r = np.random.default_rng(3)
    B = 13
    x = r.standard_normal((B, H)).astype(np.float32)
    active = (r.random((B, 1)) > 0.2).astype(np.float32)
    avail = None
    if name in ("discrete", "mixed"):
        n = 5 if name == "discrete" else 4
        avail = (r.random((B, n)) > 0.3).astype(np.float32)
        avail[:, 0] = 1.0
    t = lambda a: None if a is None else torch.tensor(np.asarray(a))

    store = sp.action_storage_dim(tspace)
    assert store == j_sp.action_storage_dim(jspace)
    assert sp.log_prob_dim(tspace) == j_sp.log_prob_dim(jspace)
    # the mode, and JAX's sampled actions given to the port
    for det in (True, False):
        ja, jlp = j_act.sample(jc, params, jspace, x, jax.random.PRNGKey(7),
                               avail, deterministic=det)
        kw = dict(deterministic=True) if det else dict(actions=t(ja))
        ta, tlp = act.sample(tc, tp, tspace, t(x), None, t(avail), **kw)
        assert ta.shape == (B, store) and ta.dtype == torch.float32
        assert tlp.shape == (B, sp.log_prob_dim(tspace))
        _close(ta, ja, f"actions (deterministic {det})", FWD)
        _close(tlp, jlp, f"log_probs (deterministic {det})", FWD)
    # the port's own draws follow the space
    drawn, _ = act.sample(tc, tp, tspace, t(x), torch.Generator().manual_seed(1),
                          t(avail))
    assert drawn.shape == (B, store)

    def j_loss(p, xx):
        lp, ent = j_act.evaluate(jc, p, jspace, xx, ja, avail, active)
        return jnp.sum(lp * jnp.arange(1, lp.shape[-1] + 1)) + 3.0 * ent, \
            (lp, ent)
    (_, (jlp, jent)), (jg, jgx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, x)
    tleaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    tx = t(x).requires_grad_(True)
    tlp, tent = act.evaluate(tc, tp, tspace, tx, t(ja), t(avail), t(active))
    loss = (tlp * torch.arange(1, tlp.shape[-1] + 1)).sum() + 3.0 * tent
    grads = torch.autograd.grad(loss, tleaves + [tx], allow_unused=True)
    _close(tlp, jlp, "evaluate log_probs", FWD)
    _close(tent, jent, "evaluate entropy", FWD)
    for i, (a, b) in enumerate(zip(grads, jax.tree_util.tree_leaves(jg))):
        _close(torch.zeros_like(tleaves[i]) if a is None else a, b,
               f"grad[{i}]", GRAD)
    _close(grads[-1], jgx, "grad x", GRAD)

    if name in ("discrete", "box", "multidiscrete"):
        want = j_act.evaluate_trpo(jc, params, jspace, x, ja, avail, active)
        got = act.evaluate_trpo(tc, tp, tspace, t(x), t(ja), t(avail),
                                t(active))
        for k, a, b in zip(("logp", "entropy", "mu", "std", "logits"),
                           got, want):
            assert (a is None) == (b is None), k
            if a is not None:
                _close(a, b, f"evaluate_trpo {k}", FWD)
    else:
        with pytest.raises(TypeError):
            act.evaluate_trpo(tc, tp, tspace, t(x), t(ja))
    if name in ("discrete", "multibinary", "multidiscrete"):
        _close(act.get_probs(tc, tp, tspace, t(x), t(avail)),
               j_act.get_probs(jc, params, jspace, x, avail), "probs", FWD)


def test_mixed_head_weights_its_entropy():
    """ent_c/2 + ent_d/0.98 of the two parts' mask-reduced entropies."""
    _, tc = _cfgs()
    tp = act.init(tc, sp.MixedSpace(2, 3), H,
                  torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(5, H, generator=torch.Generator().manual_seed(1))
    a = torch.tensor([[0.1, -0.2, 2.0]] * 5)
    _, ent = act.evaluate(tc, tp, sp.MixedSpace(2, 3), x, a)
    _, ent_c = act.evaluate(tc, tp, sp.Box((2,)), x, a[:, :2])
    _, ent_d = act.evaluate(tc, tp, sp.Discrete(3), x, a[:, 2:])
    torch.testing.assert_close(ent, ent_c / 2.0 + ent_d / 0.98)


# ---------------------------------------------------------------------------
# the CNN base
# ---------------------------------------------------------------------------

IMAGE = (4, 10, 10)


@pytest.mark.parametrize("recurrent", [False, True])
def test_cnn_actor_critic_match_jax(recurrent):
    jc, tc = _cfgs(use_recurrent_policy=recurrent, use_ReLU=True)
    ja = j_ac.Actor(jc, j_sp.Box(IMAGE), j_sp.Discrete(5))
    jcr = j_ac.Critic(jc, j_sp.Box(IMAGE))
    ta = actor_critic.Actor(tc, sp.Box(IMAGE), sp.Discrete(5))
    tcr = actor_critic.Critic(tc, sp.Box(IMAGE))
    a_params = jax.device_get(ja.init(jax.random.PRNGKey(0)))
    c_params = jax.device_get(jcr.init(jax.random.PRNGKey(1)))
    mine = ta.init(torch.Generator().manual_seed(0), "cpu")
    conv = mine["base"]["conv"]["w"]
    assert conv.shape == (H // 2, IMAGE[0], 3, 3)           # OIHW
    assert mine["base"]["fc1"]["w"].shape == (H // 2 * 8 * 8, H)
    # orthogonal over the flattened (HWI, O) matrix
    flat = conv.permute(2, 3, 1, 0).reshape(-1, H // 2)
    gain = 2 ** 0.5
    torch.testing.assert_close(flat.T @ flat, gain ** 2 * torch.eye(H // 2),
                               rtol=1e-5, atol=1e-5)
    tap, tcp = to_torch(a_params), to_torch(c_params)
    assert tap["base"]["conv"]["w"].shape == conv.shape

    r = np.random.default_rng(2)
    L, B = 3, 5
    obs = r.uniform(0, 255, (L, B) + IMAGE).astype(np.float32)
    h = r.standard_normal((B, 1, H)).astype(np.float32)
    masks = (r.random((L, B, 1)) > 0.3).astype(np.float32)
    actions = r.integers(0, 5, (L, B, 1)).astype(np.float32)
    t = lambda a: torch.tensor(np.asarray(a))
    flatb = lambda a: a.reshape(L * B, *a.shape[2:])

    # flat rows: the actor's rollout step and the critic's value
    j_a, j_lp, j_h = ja.forward(a_params, flatb(obs), np.repeat(h, L, 0),
                                flatb(masks), jax.random.PRNGKey(0), None,
                                True)
    t_a, t_lp, t_h = ta.forward(tap, t(flatb(obs)), t(np.repeat(h, L, 0)),
                                t(flatb(masks)), None, deterministic=True)
    _close(t_a, j_a, "actions", FWD)
    _close(t_lp, j_lp, "log_probs", FWD)
    _close(t_h, j_h, "rnn", FWD)
    j_v, _ = jcr.forward(c_params, flatb(obs), np.repeat(h, L, 0),
                         flatb(masks))
    t_v, _ = tcr.forward(tcp, t(flatb(obs)), t(np.repeat(h, L, 0)),
                         t(flatb(masks)))
    _close(t_v, j_v, "values", FWD)

    # the training layouts, with gradients of every parameter
    if recurrent:
        j_fn = lambda ap, cp: (ja.evaluate_seq(ap, obs, h, actions, masks),
                               jcr.forward_seq(cp, obs, h, masks))
        t_fn = lambda ap, cp: (ta.evaluate_seq(ap, t(obs), t(h), t(actions),
                                               t(masks)),
                               tcr.forward_seq(cp, t(obs), t(h), t(masks)))
    else:
        hh = np.repeat(h, L, 0)
        j_fn = lambda ap, cp: (
            ja.evaluate(ap, flatb(obs), hh, flatb(actions), flatb(masks)),
            jcr.forward(cp, flatb(obs), hh, flatb(masks))[0])
        t_fn = lambda ap, cp: (
            ta.evaluate(ap, t(flatb(obs)), t(hh), t(flatb(actions)),
                        t(flatb(masks))),
            tcr.forward(cp, t(flatb(obs)), t(hh), t(flatb(masks)))[0])

    def j_loss(ap, cp):
        (lp, ent), v = j_fn(ap, cp)
        return jnp.sum(lp) + ent + jnp.sum(jnp.square(v)), (lp, ent, v)
    (_, want), (jga, jgc) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(a_params, c_params)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tap)
              + tree_leaves(tcp)]
    (lp, ent), v = t_fn(tap, tcp)
    grads = torch.autograd.grad(lp.sum() + ent + v.square().sum(), leaves)
    for k, a, b in zip(("log_probs", "entropy", "values"), (lp, ent, v),
                       want):
        _close(a, b, k, FWD)
    jgrads = jax.tree_util.tree_leaves(jga) + jax.tree_util.tree_leaves(jgc)
    back = jax.tree_util.tree_leaves(
        to_numpy_grads(tap, tcp, grads))
    assert len(back) == len(jgrads)
    for i, (a, b) in enumerate(zip(back, jgrads)):
        _close(a, b, f"grad[{i}]", GRAD)


def to_numpy_grads(tap, tcp, grads):
    """The gradients as JAX-layout numpy trees (the conv kernel's back to
    HWIO), actor then critic."""
    from onpolicy_torch.utils.params import to_numpy
    from onpolicy_torch.utils.tree import tree_unflatten
    na = len(tree_leaves(tap))
    return [to_numpy(tree_unflatten(tap, grads[:na])),
            to_numpy(tree_unflatten(tcp, grads[na:]))]


# ---------------------------------------------------------------------------
# PopArt
# ---------------------------------------------------------------------------

def test_popart_update_matches_jax():
    jp, js = j_popart.init(jax.random.PRNGKey(0), 8)
    jp = jax.device_get(jp)
    tp = to_torch(jp)
    ts = vn.create(1, device="cpu")
    mine, mine_s = popart.init(8, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert mine["w"].shape == (8, 1) and mine_s.beta == js.beta
    r = np.random.default_rng(4)
    x = r.standard_normal((16, 8)).astype(np.float32)
    for step, (scale, shift) in enumerate(((3.0, 7.0), (10.0, 50.0),
                                           (0.5, -4.0))):
        targets = (r.standard_normal((64, 1)) * scale + shift).astype(
            np.float32)
        jp, js = j_popart.update(jp, js, jnp.asarray(targets))
        tp, ts = popart.update(tp, ts, torch.tensor(targets))
        for k in ("w", "b"):
            _close(tp[k], jp[k], f"step {step} {k}", FWD)
        want = valuenorm_from_jax(jax.device_get(js))
        for k in ("running_mean", "running_mean_sq", "debiasing_term"):
            _close(getattr(ts, k), getattr(want, k), f"step {step} {k}", FWD)
        _close(popart.apply(tp, torch.tensor(x)), j_popart.apply(jp, x),
               f"step {step} apply", FWD)


def test_popart_rescale_preserves_outputs():
    """JAX's tests/test_valuenorm.py invariance on the port: after
    `update`, denormalize(head(x)) is unchanged."""
    g = torch.Generator().manual_seed(0)
    params, state = popart.init(8, generator=g, device="cpu")
    x = torch.randn(32, 8, generator=g)
    params, state = popart.update(params, state,
                                  torch.randn(256, 1, generator=g) * 3 + 7)
    before = vn.denormalize(state, popart.apply(params, x))
    params2, state2 = popart.update(
        params, state, torch.randn(256, 1, generator=g) * 10 + 50)
    after = vn.denormalize(state2, popart.apply(params2, x))
    torch.testing.assert_close(after, before, rtol=2e-3, atol=2e-3)
    assert not torch.equal(params2["w"], params["w"])


# ---------------------------------------------------------------------------
# HATRPO on a Box head
# ---------------------------------------------------------------------------

def test_hatrpo_trpo_step_on_a_box_head_matches_jax():
    """One `_trpo_update` of a feed-forward HATRPO agent with a Box(2)
    head under `use_popart` (the stats-only normalizer, updated in the
    critic step), on a minibatch of actions sampled from the policy: the
    gaussian KL carries the Fisher-vector products and the line search.
    The trained actor, critic, optimizer and normalizer at the trained
    tolerance; the KL, improvement and accepted flag at 1e-4."""
    kw = dict(algorithm_name="hatrpo", hidden_size=H, use_popart=True,
              use_valuenorm=False, use_recurrent_policy=False,
              use_naive_recurrent_policy=False, share_policy=False,
              kl_threshold=0.01, lr=7e-4, critic_lr=7e-4)
    jc, tc = JaxConfig(**kw), Config(device="cpu", **kw)
    D, S, B = 6, 12, 40
    j_algo = JHATRPO(jc, j_sp.Box((D,)), j_sp.Box((S,)), j_sp.Box((2,)))
    t_algo = HATRPO(tc, sp.Box((D,)), sp.Box((S,)), sp.Box((2,)))
    j_state = jax.device_get(j_algo.init_state(jax.random.PRNGKey(0)))
    assert j_state.vnorm is not None
    r = np.random.default_rng(6)
    obs = r.standard_normal((B, D)).astype(np.float32)
    rnn = np.zeros((B, 1, H), np.float32)
    ones = np.ones((B, 1), np.float32)
    actions, logp, _ = j_algo.actor.forward(
        j_state.actor_params, obs, rnn, ones, jax.random.PRNGKey(3))
    mb = {"obs": obs, "share_obs": r.standard_normal((B, S)).astype(
              np.float32),
          "rnn_states": rnn, "rnn_states_critic": rnn,
          "actions": np.asarray(actions),
          "old_action_log_probs": np.asarray(logp),
          "value_preds": r.standard_normal((B, 1)).astype(np.float32),
          "returns": (r.standard_normal((B, 1)) * 5 + 20).astype(np.float32),
          "masks": ones, "active_masks": ones,
          "advantages": r.standard_normal((B, 1)).astype(np.float32),
          "factor": (1.0 + 0.1 * r.standard_normal((B, 1))).astype(
              np.float32)}
    j_new, j_m = jax.jit(j_algo._trpo_update)(
        j_state, {k: jnp.asarray(v) for k, v in mb.items()})
    t_state = train_state_from_jax(j_state)
    t_new, t_m = t_algo._trpo_update(
        t_state, {k: torch.tensor(v) for k, v in mb.items()})
    j_new = jax.device_get(j_new)
    assert float(j_m["accepted"]) == 1.0 and float(t_m["accepted"]) == 1.0
    back = train_state_to_jax(t_new, j_new)
    for part in ("actor_params", "critic_params", "critic_opt_state",
                 "vnorm"):
        got = jax.tree_util.tree_leaves(getattr(back, part))
        want = jax.tree_util.tree_leaves(getattr(j_new, part))
        assert len(got) == len(want), part
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{part}[{i}]", TRAINED)
    # the critic step folded the returns into the normalizer
    assert float(back.vnorm.debiasing_term) > 0
    for k in ("kl", "loss_improve", "expected_improve", "value_loss",
              "dist_entropy", "ratio"):
        _close(float(t_m[k]), float(j_m[k]), k, dict(rtol=1e-4, atol=1e-7))
