"""The port's ops and buffer against the JAX package's.

ValueNorm, GAE (use_gae × use_proper_time_limits, with and without the
normalizer), the PPO losses, the optax-equivalent clip+Adam(+decay), and
the buffer (from_rollout, compute_returns, the chunked-BPTT sampler at
T=25, L=10, whose chunks cross episode boundaries). Inputs come from a
numpy seed; f32 on the CPU, so values are held at rtol/atol 1e-5 (sums in
another order), except where stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onpolicy_tpu import buffer as j_buf
from onpolicy_tpu.ops import gae as j_gae
from onpolicy_tpu.ops import losses as j_losses
from onpolicy_tpu.ops import schedules as j_sched
from onpolicy_tpu.ops import valuenorm as j_vn

from onpolicy_torch import buffer as t_buf
from onpolicy_torch.ops import gae, losses, schedules, valuenorm as vn
from onpolicy_torch.utils.params import (adam_state_from_optax,
                                         adam_state_to_optax, to_torch,
                                         valuenorm_from_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _r(seed):
    return np.random.default_rng(seed)


def _f32(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _vn_pair(seed=0, updates=3):
    r = _r(seed)
    js, ts = j_vn.create(1), vn.create(1, device="cpu")
    for _ in range(updates):
        x = _f32(r, 50, 1, scale=3.0) + 2.0
        js, ts = j_vn.update(js, x), vn.update(ts, torch.tensor(x))
    return js, ts


def test_valuenorm_matches():
    js, ts = _vn_pair()
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), **TOL)
    x = _f32(_r(1), 20, 1)
    np.testing.assert_allclose(vn.normalize(ts, torch.tensor(x)).numpy(),
                               np.asarray(j_vn.normalize(js, x)), **TOL)
    np.testing.assert_allclose(vn.denormalize(ts, torch.tensor(x)).numpy(),
                               np.asarray(j_vn.denormalize(js, x)), **TOL)
    # the fresh state: debias clamp at EPS and variance clamp at 1e-2
    fresh_j, fresh_t = j_vn.create(1), vn.create(1, device="cpu")
    np.testing.assert_allclose(vn.normalize(fresh_t, torch.tensor(x)).numpy(),
                               np.asarray(j_vn.normalize(fresh_j, x)), **TOL)


@pytest.mark.parametrize("use_gae", [True, False])
@pytest.mark.parametrize("proper", [True, False])
@pytest.mark.parametrize("norm", [True, False])
def test_gae_matches(use_gae, proper, norm):
    r = _r(2)
    T, N, M = 25, 4, 3
    rewards = _f32(r, T, N, M, 1)
    values = _f32(r, T + 1, N, M, 1)
    masks = (r.random((T + 1, N, M, 1)) > 0.1).astype(np.float32)
    bad = (r.random((T + 1, N, M, 1)) > 0.1).astype(np.float32)
    js, ts = _vn_pair(3) if norm else (None, None)
    kw = dict(gamma=0.99, gae_lambda=0.95, use_gae=use_gae,
              use_proper_time_limits=proper)
    j_ret, j_adv = j_gae.compute_returns(rewards, values, masks, bad, js, **kw)
    t_ret, t_adv = gae.compute_returns(
        *map(torch.tensor, (rewards, values, masks, bad)), ts, **kw)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), **TOL)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), **TOL)


@pytest.mark.parametrize("huber,clipped,masked", [
    (True, True, True), (False, True, False), (True, False, True)])
def test_value_loss_matches(huber, clipped, masked):
    r = _r(4)
    v, old, ret = (_f32(r, 30, 1) for _ in range(3))
    ret = ret * 20.0                    # past the huber delta and the clip
    active = (r.random((30, 1)) > 0.2).astype(np.float32)
    js, ts = _vn_pair(5)
    kw = dict(clip_param=0.2, use_clipped_value_loss=clipped,
              use_huber_loss=huber, huber_delta=10.0,
              use_value_active_masks=masked)
    want = j_losses.value_loss(v, old, ret, active, js, **kw)
    got = losses.value_loss(*map(torch.tensor, (v, old, ret, active)), ts, **kw)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_policy_loss_and_advantage_normalization_match():
    r = _r(6)
    new, old, adv = (_f32(r, 10, 8, 1, scale=0.3) for _ in range(3))
    active = (r.random((10, 8, 1)) > 0.2).astype(np.float32)
    want, want_ratio = j_losses.ppo_policy_loss(new, old, adv, active,
                                                clip_param=0.2)
    got, got_ratio = losses.ppo_policy_loss(
        *map(torch.tensor, (new, old, adv, active)), clip_param=0.2)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(got_ratio), float(want_ratio), **TOL)
    for mask in (active, None):
        w = j_losses.normalize_advantages(adv, mask)
        g = losses.normalize_advantages(
            torch.tensor(adv), None if mask is None else torch.tensor(mask))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _grads(r, scale):
    return {"a": {"w": _f32(r, 4, 3, scale=scale), "b": _f32(r, 3, scale=scale)},
            "c": [_f32(r, 5, scale=scale)]}


@pytest.mark.parametrize("decay,weight_decay", [(False, 0.0), (True, 0.0),
                                                (False, 0.01)])
def test_optimizer_matches_optax_over_five_steps(decay, weight_decay):
    """Global-norm clip (norms on both sides of max_norm) then Adam, 5
    steps; schedule and decoupled weight decay variants. The first steps
    divide moments of size ~|g| by their square roots, so the updates are
    ±lr regardless of scale: 1e-6 absolute on parameters of size ~1."""
    r = _r(7)
    params = _grads(r, 1.0)
    if decay:
        lr = lambda count: 7e-4 * (1.0 - (count // 2) / 5.0)
    else:
        lr = 7e-4
    j_tx = j_sched.make_optimizer(lr, 1e-5, weight_decay, 10.0)
    t_tx = schedules.make_optimizer(lr, 1e-5, weight_decay, 10.0)
    j_p, j_s = params, j_tx.init(params)
    t_p = to_torch(params)
    t_s = adam_state_from_optax(jax.device_get(j_s))
    for step in range(5):
        g = _grads(r, 8.0 if step % 2 else 0.5)    # clipped, then not
        upd, j_s = j_tx.update(g, j_s, j_p)
        j_p = optax.apply_updates(j_p, upd)
        t_p, t_s = t_tx.update(to_torch(g), t_s, t_p)
    for got, want in zip(tree_leaves(t_p), jax.tree_util.tree_leaves(j_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    back = adam_state_to_optax(t_s, jax.device_get(j_s))
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(jax.device_get(j_s))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _buffers(T=25, N=4, M=3, seed=8):
    """A JAX RolloutBuffer and the port's, from the same numpy arrays."""
    r = _r(seed)
    f = lambda *s: _f32(r, *s)
    arrays = dict(
        share_obs=f(T + 1, N, M, 6), obs=f(T + 1, N, M, 4),
        rnn_states=f(T + 1, N, M, 1, 5), rnn_states_critic=f(T + 1, N, M, 1, 5),
        actions=r.integers(0, 5, (T, N, M, 1)).astype(np.float32),
        action_log_probs=f(T, N, M, 1), value_preds=f(T + 1, N, M, 1),
        rewards=f(T, N, M, 1),
        masks=(r.random((T + 1, N, M, 1)) > 0.1).astype(np.float32),
        bad_masks=np.ones((T + 1, N, M, 1), np.float32),
        active_masks=np.ones((T + 1, N, M, 1), np.float32))
    next_value = f(N, M, 1)
    js, ts = _vn_pair(9)
    jb = j_buf.RolloutBuffer(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = t_buf.RolloutBuffer(**{k: torch.tensor(v) for k, v in arrays.items()})
    kw = dict(gamma=0.99, gae_lambda=0.95)
    jb = jb.compute_returns(next_value, js, **kw)
    tb = tb.compute_returns(torch.tensor(next_value), ts, **kw)
    return jb, tb


def test_buffer_returns_and_recurrent_chunks_match():
    """nmb=1 at T=25, L=10: 30 chunks of the env-major stream, the chunks
    that cross episode boundaries included, and the chunk-start rnn
    states, equal to the JAX sampler's (a pure relayout: exact)."""
    jb, tb = _buffers()
    np.testing.assert_allclose(tb.returns.numpy(), np.asarray(jb.returns), **TOL)
    np.testing.assert_allclose(tb.advantages.numpy(),
                               np.asarray(jb.advantages), **TOL)
    adv = np.asarray(jb.advantages)
    j_mb = j_buf.recurrent_minibatches(jb, jnp.asarray(adv),
                                       jax.random.PRNGKey(0), 1, 10)
    (t_mb,) = t_buf.recurrent_minibatches(tb, torch.tensor(adv), None, 1, 10)
    assert set(t_mb) == set(j_mb)
    for k, v in t_mb.items():
        want = np.asarray(j_mb[k])[0]
        assert v.shape == want.shape, k
        if k in ("returns", "advantages"):
            np.testing.assert_allclose(v.numpy(), want, **TOL)
        else:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    # chunk 2 = env-major positions 20..29: agent (0,0) t=20..24, then
    # agent (0,1) t=0..4: it crosses an episode boundary
    obs = tb.obs[:-1]
    np.testing.assert_array_equal(t_mb["obs"][:5, 2].numpy(),
                                  obs[20:25, 0, 0].numpy())
    np.testing.assert_array_equal(t_mb["obs"][5:, 2].numpy(),
                                  obs[0:5, 0, 1].numpy())


def test_recurrent_minibatches_permute_whole_chunks():
    """nmb=3 draws a chunk permutation from the generator: the three
    minibatches hold exactly the 30 chunks of the nmb=1 layout."""
    _, tb = _buffers(seed=10)
    adv = tb.advantages
    (whole,) = t_buf.recurrent_minibatches(tb, adv, None, 1, 10)
    parts = t_buf.recurrent_minibatches(tb, adv, torch.Generator().manual_seed(0),
                                        3, 10)
    assert len(parts) == 3 and all(p["obs"].shape[1] == 10 for p in parts)
    got = torch.cat([p["obs"] for p in parts], 1)
    key = lambda x: sorted(map(tuple, x.transpose(0, 1).reshape(30, -1).tolist()))
    assert key(got) == key(whole["obs"])
    h = torch.cat([p["rnn_states"] for p in parts], 0)
    assert sorted(map(tuple, h.reshape(30, -1).tolist())) == \
        sorted(map(tuple, whole["rnn_states"].reshape(30, -1).tolist()))


@pytest.mark.parametrize("nmb", [1, 3])
def test_recurrent_minibatches_perm_and_factor_match_jax(nmb):
    """The chunked sampler handed JAX's permutation (from JAX's key) and
    HAPPO's factor [T, N, M, 1]: the same minibatches as JAX's, the factor
    cut into the same env-major chunks as the advantages (a relayout:
    exact; the returns and advantages were computed on each side, 1e-5)."""
    jb, tb = _buffers(seed=13)
    adv = np.asarray(jb.advantages)
    factor = np.exp(_f32(_r(14), 25, 4, 3, 1, scale=0.1))
    key = jax.random.PRNGKey(5)
    j_mb = j_buf.recurrent_minibatches(jb, jnp.asarray(adv), key, nmb, 10,
                                       factor=jnp.asarray(factor))
    perm = None if nmb == 1 else torch.tensor(
        np.asarray(jax.random.permutation(key, 30)))
    t_mbs = t_buf.recurrent_minibatches(tb, torch.tensor(adv), None, nmb, 10,
                                        perm=perm,
                                        factor=torch.tensor(factor))
    assert len(t_mbs) == nmb
    for i, t_mb in enumerate(t_mbs):
        assert set(t_mb) == set(j_mb) and "factor" in t_mb
        for k, v in t_mb.items():
            want = np.asarray(j_mb[k])[i]
            assert v.shape == want.shape, k
            if k in ("returns", "advantages"):
                np.testing.assert_allclose(v.numpy(), want, **TOL)
            else:
                np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


@pytest.mark.parametrize("heads,prod,with_factor", [
    (1, False, True), (2, False, True), (2, True, True), (2, True, False)])
def test_policy_loss_happo_options_match(heads, prod, with_factor):
    """HAPPO's factor and joint ratio over the heads, and MAPPO's per-head
    ratio, with the surrogate summed over heads before the batch mean."""
    r = _r(15 + heads)
    new, old = (_f32(r, 64, heads, scale=0.3) for _ in range(2))
    adv = _f32(r, 64, 1)
    active = (r.random((64, 1)) > 0.2).astype(np.float32)
    factor = np.exp(_f32(r, 64, 1, scale=0.2)) if with_factor else None
    kw = dict(clip_param=0.2, prod_ratio_heads=prod)
    want, want_ratio = j_losses.ppo_policy_loss(new, old, adv, active,
                                                factor=factor, **kw)
    got, got_ratio = losses.ppo_policy_loss(
        *map(torch.tensor, (new, old, adv, active)),
        factor=None if factor is None else torch.tensor(factor), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got_ratio), float(want_ratio),
                               rtol=1e-6, atol=1e-6)


def test_valuenorm_carries_across():
    js, ts = _vn_pair(11)
    back = valuenorm_from_jax(jax.device_get(js))
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(js, k)))
