"""The port's bf16 mode against the JAX package's, on the CPU.

Under `use_bf16` the JAX package computes the MLP, the GRU step and the
LayerNorms in bf16 (`models/common.py`), and its Pallas GRU moves only the
[T, B, H] sequence streams in bf16 (gi, outs and their cotangents), with
h, W_hh, dW, db and the gate math in f32 (`ops/pallas_gru.py`). The port's
sequence GRU follows the kernels' semantics on both devices; here, on the
CPU, through the kernels' plain versions, against `pallas_gru` run in
interpret mode as tests/test_pallas_gru.py runs it. Inputs come from a
numpy seed. Tolerances:
  * layer level (same bf16 inputs on both sides): the streams within one
    bf16 ulp (rtol 2^-7) plus the f32 atol, since both sides compute the
    same f32 value and it may round to the neighbouring bf16; hT, dh0, dW
    and db at the f32 tolerances of tests/test_pallas_gru.py;
  * sequence level: outs within one bf16 ulp of the LayerNorm's output
    (atol 2^-6 for |out| < 4), hT at the f32 tolerance; the gradients
    within 3e-2 of each leaf's largest entry, since the two frameworks
    round the bf16 cotangents of the LayerNorm and of the input
    projections at other places (a few bf16 ulps of 2^-8);
  * against the f32 truth, the bound of `test_bf16_path_tracks_f32_reference`;
  * the bf16 model against JAX's at tests/test_bf16.py's 0.05.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import config_from_args as j_config_from_args
from onpolicy_tpu.models import gru as j_gru
from onpolicy_tpu.models.actor_critic import Actor as JActor
from onpolicy_tpu.models.actor_critic import Critic as JCritic
from onpolicy_tpu.ops import pallas_gru as pg
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.models import gru
from onpolicy_torch.models.actor_critic import Actor, Critic
from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.params import to_torch
from onpolicy_torch.utils.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
ULP = dict(rtol=2 ** -7, atol=2e-5)          # one bf16 ulp
SEQ_OUT = dict(rtol=2 ** -7, atol=2 ** -6)   # one ulp of |out| < 4
SEQ_GRAD = 3e-2                              # of each leaf's largest entry
MODEL = dict(rtol=0.05, atol=0.05)           # tests/test_bf16.py


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# one layer: the plain bf16 versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _layer(T, H, seed, masks_ones):
    """Inputs at one Pallas batch tile (its B must be a whole tile)."""
    B = pg._b_tile(H, itemsize=2)
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    x = dict(gir=bf(f(T, B, H)), giz=bf(f(T, B, H)), gin=bf(f(T, B, H)),
             h0=f(B, H, scale=0.5), w_hh=f(H, 3 * H, scale=H ** -0.5),
             b_hh=f(3 * H, scale=0.1), douts=bf(f(T, B, H, scale=0.1)),
             dhT=f(B, H, scale=0.1))
    m = (rng.random((T, B, 1)) > 0.2).astype(np.float32)
    if masks_ones:
        m[:] = 1.0
    else:
        m[0] = 0.0
    x["masks"] = m
    return x


def _jax_layer(x, hprev0_dtype=jnp.bfloat16):
    H = x["h0"].shape[1]
    w = x["w_hh"]
    ws = (w[:, :H], w[:, H:2 * H], w[:, 2 * H:])
    bhh = x["b_hh"].reshape(3, H)
    outs, hT = pg._fwd_call(x["gir"], x["giz"], x["gin"], x["h0"], x["masks"],
                            *ws, bhh)
    # `_layer_bwd`: hprev = [h0 in the streams' type, outs[:-1]]
    hprev = jnp.concatenate([jnp.asarray(x["h0"])[None].astype(hprev0_dtype),
                             outs[:-1].astype(hprev0_dtype)], 0)
    dgir, dgiz, dgin, dh0, dwr, dwz, dwn, dbhh = pg._bwd_call(
        x["gir"], x["giz"], x["gin"], hprev, x["masks"], x["douts"], x["dhT"],
        *ws, bhh)
    dw = np.concatenate([np.asarray(dwr), np.asarray(dwz), np.asarray(dwn)], 1)
    return outs, hT, (dgir, dgiz, dgin, dh0, dw, np.asarray(dbhh).reshape(-1))


def _torch_layer(x, outs):
    bf = lambda a: torch.tensor(_f32(a)).to(torch.bfloat16)
    f = lambda a: torch.tensor(np.asarray(a))
    fwd = cuda_gru.gru_layer_fwd_ref(bf(x["gir"]), bf(x["giz"]), bf(x["gin"]),
                                     f(x["h0"]), f(x["masks"]), f(x["w_hh"]),
                                     f(x["b_hh"]))
    bwd = cuda_gru.gru_layer_bwd_ref(bf(x["gir"]), bf(x["giz"]), bf(x["gin"]),
                                     bf(outs), f(x["h0"]), f(x["masks"]),
                                     bf(x["douts"]), f(x["dhT"]), f(x["w_hh"]),
                                     f(x["b_hh"]))
    return fwd, bwd


@pytest.mark.parametrize("T,H,seed,masks_ones", [
    (7, 16, 0, False),    # episodes start at t = 0
    (3, 32, 2, True),     # no mask zero: h0 enters every product at t = 0
    (1, 16, 1, True)])    # T = 1
def test_bf16_layer_matches_pallas(T, H, seed, masks_ones):
    x = _layer(T, H, seed, masks_ones)
    j_outs, j_hT, j_bwd = _jax_layer(x)
    (outs, hT), bwd = _torch_layer(x, j_outs)
    assert outs.dtype == torch.bfloat16 and hT.dtype == torch.float32
    np.testing.assert_allclose(outs.float().numpy(), _f32(j_outs), **ULP)
    np.testing.assert_allclose(hT.numpy(), np.asarray(j_hT), **FWD)
    names = ("dgir", "dgiz", "dgin", "dh0", "dw_hh", "db_hh")
    for i, (n, a, b) in enumerate(zip(names, bwd, j_bwd)):
        assert a.dtype == (torch.bfloat16 if i < 3 else torch.float32), n
        np.testing.assert_allclose(a.float().numpy(), _f32(b), err_msg=n,
                                   **(ULP if i < 3 else GRAD))


@pytest.mark.parametrize("T,H,seed", [(1, 16, 1), (3, 32, 2)])
def test_bf16_backward_rounds_h0_in_hprev(T, H, seed):
    """The backward rematerializes hm at t = 0 from h0 rounded to bf16, as
    `_layer_bwd` builds hprev, although the forward used h0 in f32. With
    no mask zero at t = 0 the rounding shows in dW and dh0 beyond the f32
    tolerance: the port matches the rounded hprev and not the f32 one."""
    x = _layer(T, H, seed, masks_ones=True)
    j_outs, _, rounded = _jax_layer(x)
    _, _, unrounded = _jax_layer(x, hprev0_dtype=jnp.float32)
    _, bwd = _torch_layer(x, j_outs)
    for i in (3, 4):   # dh0, dw_hh
        np.testing.assert_allclose(bwd[i].numpy(), _f32(rounded[i]), **GRAD)
        assert not np.allclose(bwd[i].numpy(), _f32(unrounded[i]), **GRAD)


# ---------------------------------------------------------------------------
# the multi-layer sequence, as the trainer calls it
# ---------------------------------------------------------------------------

def _seq_case(T, B, D, H, layers, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    params = {"layers": [], "norm": {"scale": 1.0 + f(H, scale=0.1),
                                     "bias": f(H, scale=0.1)}}
    d_in = D
    for _ in range(layers):
        params["layers"].append({
            "w_ih": f(d_in, 3 * H, scale=d_in ** -0.5),
            "w_hh": f(H, 3 * H, scale=H ** -0.5),
            "b_ih": f(3 * H, scale=0.1), "b_hh": f(3 * H, scale=0.1)})
        d_in = H
    masks = (rng.random((T, B, 1)) > 0.3).astype(np.float32)
    masks[0] = 0.0
    return params, f(T, B, D), f(B, layers, H, scale=0.5), masks, f(H, 3)


def _jax_seq(fn, cfg, params, xs, hxs, masks, w_out):
    def loss(p, x, h):
        outs, hT = fn(cfg, p, x, h, masks)
        return (jnp.sum((outs.astype(jnp.float32) @ w_out) ** 2)
                + jnp.sum(hT * hT)), (outs, hT)
    (_, (outs, hT)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, xs, hxs)
    g = jax.device_get(grads)
    return outs, hT, tree_leaves(g[0]) + [g[1], g[2]]


def _torch_seq(cfg, params, xs, hxs, masks, w_out):
    p = to_torch(params)
    leaves = [x.requires_grad_() for x in tree_leaves(p)]
    p = tree_unflatten(p, leaves)
    x = torch.tensor(xs, requires_grad=True)
    h = torch.tensor(hxs, requires_grad=True)
    outs, hT = gru.sequence(cfg, p, x, h, torch.tensor(masks))
    loss = ((outs.float() @ torch.tensor(w_out)) ** 2).sum() + (hT * hT).sum()
    return outs.detach(), hT.detach(), torch.autograd.grad(loss, leaves + [x, h])


@pytest.mark.parametrize("layers", [1, 2])
def test_bf16_sequence_matches_pallas(layers):
    T, B, D, H = 7, 5, 12, 16
    params, xs, hxs, masks, w_out = _seq_case(T, B, D, H, layers)
    j_cfg = JaxConfig(hidden_size=H, recurrent_N=layers, use_bf16=True)
    j_outs, j_hT, j_grads = _jax_seq(pg.sequence, j_cfg, params, xs, hxs,
                                     masks, w_out)
    cfg = Config(hidden_size=H, recurrent_N=layers, use_bf16=True,
                 device="cpu")
    n0 = cuda_gru.FWD_LAUNCHES
    outs, hT, grads = _torch_seq(cfg, params, xs, hxs, masks, w_out)
    assert cuda_gru.FWD_LAUNCHES == n0           # CPU: the plain versions
    assert outs.dtype == torch.bfloat16 and hT.dtype == torch.float32
    np.testing.assert_allclose(outs.float().numpy(), _f32(j_outs), **SEQ_OUT)
    np.testing.assert_allclose(hT.numpy(), np.asarray(j_hT), **FWD)
    assert len(grads) == len(j_grads)
    for i, (a, b) in enumerate(zip(grads, j_grads)):
        b = _f32(b)
        scale = max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a.float().numpy() - b).max()) / scale
        assert err <= SEQ_GRAD, (i, err)


@pytest.mark.parametrize("layers", [1, 2])
def test_bf16_path_tracks_f32_reference(layers):
    """The port's bf16 sequence (kernel semantics) tracks the f32 truth as
    tests/test_pallas_gru.py holds the Pallas bf16 path: each gradient's
    error, relative to its largest entry, at most max(3 * the JAX bf16
    scan's error, 0.02)."""
    T, B, D, H = 7, 5, 12, 16
    params, xs, hxs, masks, w_out = _seq_case(T, B, D, H, layers)
    j32 = JaxConfig(hidden_size=H, recurrent_N=layers)
    _, _, g32 = _jax_seq(j_gru.sequence, j32, params, xs, hxs, masks, w_out)
    _, _, g16s = _jax_seq(j_gru.sequence, j32.replace(use_bf16=True), params,
                          xs, hxs, masks, w_out)
    cfg = Config(hidden_size=H, recurrent_N=layers, use_bf16=True,
                 device="cpu")
    _, _, g16p = _torch_seq(cfg, params, xs, hxs, masks, w_out)
    for a, s, b in zip(g16p, g16s, g32):
        b = _f32(b)
        scale = max(1.0, float(np.abs(b).max()))
        err_port = float(np.abs(a.float().numpy() - b).max()) / scale
        err_scan = float(np.abs(_f32(s) - b).max()) / scale
        assert err_port <= max(3.0 * err_scan, 0.02), (err_port, err_scan)


# ---------------------------------------------------------------------------
# the bf16 model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recurrent", [True, False])
def test_bf16_actor_critic_match_jax(recurrent):
    """Actor and critic outputs in bf16 mode against JAX's bf16 model
    (features and GRU in bf16, heads and outputs in f32): one rollout
    step, the flat evaluation and, for the recurrent policy, the
    sequence evaluation through the GRU kernels' plain versions."""
    flags = dict(hidden_size=64, use_recurrent_policy=recurrent,
                 use_naive_recurrent_policy=False, use_bf16=True)
    j_cfg = JaxConfig(**flags)
    cfg = Config(**flags, device="cpu")
    j_actor = JActor(j_cfg, j_sp.Box((18,)), j_sp.Discrete(5))
    j_critic = JCritic(j_cfg, j_sp.Box((54,)))
    ap = jax.device_get(j_actor.init(jax.random.PRNGKey(0)))
    cp = jax.device_get(j_critic.init(jax.random.PRNGKey(1)))
    actor = Actor(cfg, sp.Box((18,)), sp.Discrete(5))
    critic = Critic(cfg, sp.Box((54,)))

    rng = np.random.default_rng(0)
    L, B = 10, 24
    obs = rng.standard_normal((L, B, 18)).astype(np.float32)
    cobs = rng.standard_normal((L, B, 54)).astype(np.float32)
    hxs = (rng.standard_normal((B, 1, 64)) * 0.3).astype(np.float32)
    masks = (rng.random((L, B, 1)) > 0.2).astype(np.float32)
    action = rng.integers(0, 5, (L, B, 1)).astype(np.float32)
    t = torch.tensor

    lp_j, ent_j = j_actor.evaluate(ap, obs[0], hxs, action[0], masks[0])
    lp, ent = actor.evaluate(to_torch(ap), t(obs[0]), t(hxs), t(action[0]),
                             t(masks[0]))
    assert lp.dtype == torch.float32
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), **MODEL)
    np.testing.assert_allclose(float(ent), float(ent_j), **MODEL)

    v_j, h_j = j_critic.forward(cp, cobs[0], hxs, masks[0])
    v, h = critic.forward(to_torch(cp), t(cobs[0]), t(hxs), t(masks[0]))
    assert v.dtype == torch.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), **MODEL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **MODEL)

    if recurrent:
        lp_j, ent_j = j_actor.evaluate_seq(ap, obs, hxs, action, masks)
        lp, ent = actor.evaluate_seq(to_torch(ap), t(obs), t(hxs), t(action),
                                     t(masks))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), **MODEL)
        np.testing.assert_allclose(float(ent), float(ent_j), **MODEL)
        v_j = j_critic.forward_seq(cp, cobs, hxs, masks)
        v = critic.forward_seq(to_torch(cp), t(cobs), t(hxs), t(masks))
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), **MODEL)


# ---------------------------------------------------------------------------
# plans and end to end
# ---------------------------------------------------------------------------

H100_SMS, H100_SMEM_OPTIN = 132, 232_448


@pytest.mark.parametrize("H", [16, 32, 48, 64])
@pytest.mark.parametrize("bt", [8, 16])
def test_bf16_plans_size_shared_memory_by_element_size(H, bt):
    """Staged rows of H + 8 bf16 (one 16-byte chunk of padding, as H + 4
    f32): the stream stages shrink, and the f32 parts (W, h, hm, dG,
    masks) stay as they were."""
    for itemsize, pad in ((4, 4), (2, 8)):
        row = (H + pad) * itemsize
        assert row % 16 == 0
        fwd = 4 * 3 * H * H + 2 * (3 * bt * row + 4 * bt) + 4 * 2 * bt * (H + 4)
        bwd = (4 * (H * (3 * H + 8) + bt * (H + 8) + bt * (3 * H + 8))
               + 2 * (5 * bt * row + 4 * bt))
        assert cuda_gru.mma_fwd_smem_bytes(H, bt, itemsize) == fwd
        assert cuda_gru.mma_smem_bytes(H, bt, itemsize) == bwd
    assert cuda_gru.mma_smem_bytes(H, bt, 2) < cuda_gru.mma_smem_bytes(H, bt)
    assert cuda_gru.mma_smem_bytes(64, 16, 2) == 91_776    # the source's note
    assert cuda_gru.mma_smem_bytes(64, 8, 2) == 71_488
    assert cuda_gru.mma_fwd_smem_bytes(64, 16, 2) == 71_808
    assert cuda_gru.mma_fwd_smem_bytes(64, 8, 2) == 60_480


@pytest.mark.parametrize("B,H", [(960, 64), (122_880, 64), (384, 64), (37, 64),
                                 (5003, 48), (2200, 32), (300, 16), (960, 40),
                                 (333, 128)])
def test_bf16_plans_route_by_width_as_f32(B, H):
    """bf16 streams take the same kernel, tile and grid as f32 ones; only
    the tensor-core kernels' shared bytes differ."""
    for plan_fn, bytes_fn in ((cuda_gru.fwd_plan, cuda_gru.mma_fwd_smem_bytes),
                              (cuda_gru.bwd_plan, cuda_gru.mma_smem_bytes)):
        p32 = plan_fn(B, H, H100_SMS, H100_SMEM_OPTIN)
        p16 = plan_fn(B, H, H100_SMS, H100_SMEM_OPTIN, 2)
        assert (p16.variant, p16.bt, p16.grid) == (p32.variant, p32.bt, p32.grid)
        if p16.variant == cuda_gru.MMA:
            assert p16.smem_bytes == bytes_fn(H, p16.bt, 2)
        else:
            assert p16 == p32


def test_bf16_stream_type_is_checked():
    """Only the [T, B, H] streams may be bf16, and the C entries name the
    type by `STREAM_TYPES`."""
    assert cuda_gru.STREAM_TYPES == {torch.float32: 0, torch.bfloat16: 1}
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_gru._stream_dtype(torch.zeros(2, dtype=torch.float16))
    x = {"h0": torch.zeros(2, 3, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="h0 is torch.bfloat16"):
        cuda_gru._require(x, {"h0": (2, 3)}, torch.device("cpu"),
                          torch.bfloat16)


def test_bf16_training_learns():
    """End-to-end bf16 MAPPO (feed-forward, critic dedup) on simple_spread
    on the CPU: finite metrics, and the reward improves over the run (the
    harness of tests/test_bf16.py)."""
    cfg = canonicalize_algorithm(Config(
        algorithm_name="mappo", scenario_name="simple_spread", num_agents=3,
        n_rollout_threads=32, episode_length=25, num_env_steps=24000,
        ppo_epoch=5, num_mini_batch=1, hidden_size=64, lr=7e-4,
        critic_lr=7e-4, use_bf16=True, use_critic_dedup=True, seed=3,
        device="cpu"))
    _, history = SharedRunner(cfg).run(log_fn=None)
    rows = [h for h in history if "average_episode_rewards" in h]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    first = np.mean([r["average_episode_rewards"] for r in rows[:3]])
    last = np.mean([r["average_episode_rewards"] for r in rows[-3:]])
    assert last > first + 5.0, (first, last)
