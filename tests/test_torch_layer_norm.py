"""The LayerNorm kernels (`ops/cuda_layer_norm.py`, `csrc/layer_norm.cu`):
their plain twins, autograd function, dispatch and plan on the CPU; the
kernels themselves on the card.

On the CPU the plain twins are held to autograd of the decomposed
`models/common.layer_norm_apply` (the port's LayerNorm everywhere but f32
on the card), forward and first order, at the widths the models use (18,
54, 64; 512, 660, 785) and around them; `LayerNorm` (the twins inside, as
on CPU tensors) passes gradcheck and gradgradcheck in float64; HATRPO's
Fisher-vector product through it equals the decomposed form's.
Tolerances: f32 forward rtol/atol 1e-5, gradients 1e-4 / 1e-5 (the two
forms round the same sums in another order).

Tests marked `cuda` skip without a card. The file imports neither JAX nor
the JAX package, so the card's machine runs them on their own:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_norm.py

There the kernels are held to the twins at each cell's shapes, the scale
and bias gradients over 1,228,800 rows to float64 sums, and the
backward's bits repeat.
"""
import re

import numpy as np
import pytest
import torch

from onpolicy_torch.models import common as cm
from onpolicy_torch.ops import cuda_layer_norm as cln
from onpolicy_torch.utils import profiling
from onpolicy_torch.utils.tree import tree_map

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
WIDTHS = (1, 18, 33, 54, 64, 512, 660, 785, 1100)
H100_SMS = 132


def _inputs(shape, seed, device="cpu", dtype=torch.float32):
    """x, scale, bias, dy from a numpy seed; x with a per-row offset and
    spread, so that the mean and the variance matter."""
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, shape[:-1] + (1,))
         + rng.standard_normal(shape[:-1] + (1,)))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (t(x), t(1.0 + 0.3 * rng.standard_normal(D)),
            t(0.1 * rng.standard_normal(D)), t(rng.standard_normal(shape)))


def _decomposed(x, scale, bias, dy):
    """y and (dx, dscale, dbias) by autograd of the decomposed form."""
    x, scale, bias = (t.detach().requires_grad_(True) for t in (x, scale, bias))
    y = cm.layer_norm_apply({"scale": scale, "bias": bias}, x)
    return y.detach(), torch.autograd.grad(y, (x, scale, bias), dy)


# ---------------------------------------------------------------------------
# CPU: twins, function, dispatch, plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", WIDTHS)
def test_plain_twins_match_the_decomposed_form(D):
    x, scale, bias, dy = _inputs((3, 7, D), seed=D)
    want_y, want = _decomposed(x, scale, bias, dy)
    y, mean, rstd = cln.layer_norm_fwd_ref(x, scale, bias, cm.LN_EPS)
    torch.testing.assert_close(y, want_y, **FWD)
    assert mean.shape == rstd.shape == (3, 7)
    got = cln.layer_norm_bwd_ref(x, scale, dy, mean, rstd)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)
    # the autograd function with the twins inside (CPU tensors)
    xs = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
    y2 = cln.LayerNorm.apply(*xs, cm.LN_EPS)
    assert torch.equal(y2, y)
    for a, b in zip(torch.autograd.grad(y2, xs, dy), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", (1, 5, 18, 64))
def test_function_passes_gradcheck_and_gradgradcheck(D):
    x, scale, bias, _ = _inputs((2, 3, D), seed=D, dtype=torch.float64)
    args = tuple(t.requires_grad_(True) for t in (x, scale, bias))
    f = lambda *a: cln.LayerNorm.apply(*a, cm.LN_EPS)
    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


@pytest.mark.parametrize("D", (5, 64))
def test_function_passes_gradgradcheck_on_a_strided_input(D):
    """A strided x (a slice of a wider one, as `obs[:, i]`) keeps its
    second-order terms: the function saves the caller's x, not the
    contiguous copy the kernels read."""
    wide, scale, bias, _ = _inputs((3, 4, D + 1), seed=D, dtype=torch.float64)
    wide.requires_grad_(True)
    args = tuple(t[:D].clone().requires_grad_(True) for t in (scale, bias))
    f = lambda w, s, b: cln.LayerNorm.apply(w[..., 1:], s, b, cm.LN_EPS)
    assert not wide[..., 1:].is_contiguous()
    assert torch.autograd.gradcheck(f, (wide, *args))
    assert torch.autograd.gradgradcheck(f, (wide, *args))


def test_function_backward_without_input_gradient_and_on_no_rows():
    """An input that needs no gradient (the observations under
    `feature_norm`) gets none; zero rows give an empty y and zero scale and
    bias gradients."""
    x, scale, bias, dy = _inputs((4, 18), seed=0)
    s, b = scale.requires_grad_(True), bias.requires_grad_(True)
    y = cln.LayerNorm.apply(x, s, b, cm.LN_EPS)
    ds, db = torch.autograd.grad(y, (s, b), dy)
    _, (_, want_ds, want_db) = _decomposed(x, scale, bias, dy)
    torch.testing.assert_close(ds, want_ds, **GRAD)
    torch.testing.assert_close(db, want_db, **GRAD)
    dx, ds, db = cln.layer_norm_bwd(x, scale, dy, *cln.stats(x, cm.LN_EPS),
                                    need_dx=False)
    assert dx is None
    empty = torch.zeros(0, 5, 18, requires_grad=True)
    y = cln.LayerNorm.apply(empty, s, b, cm.LN_EPS)
    assert y.shape == (0, 5, 18)
    grads = torch.autograd.grad(y.sum(), (empty, s, b))
    assert grads[0].shape == (0, 5, 18)
    assert not grads[1].any() and not grads[2].any()


def test_dispatch_rule():
    """f32 on the card goes to the kernels; the CPU, and bf16 anywhere,
    keep the decomposed form (no model name, no flag)."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert cln.served_by_kernels(cuda, torch.float32)
    assert cln.served_by_kernels("cuda", torch.float32)
    assert not cln.served_by_kernels(cuda, torch.bfloat16)
    assert not cln.served_by_kernels(cuda, torch.float64)
    assert not cln.served_by_kernels(cpu, torch.float32)
    assert not cln.served_by_kernels(cpu, torch.bfloat16)


def test_layer_norm_apply_dispatches_by_the_rule(monkeypatch):
    calls = []
    real = cln.LayerNorm.apply

    def spy(*a):
        calls.append(a[0].dtype)
        return real(*a)
    monkeypatch.setattr(cln.LayerNorm, "apply", spy)
    x, scale, bias, _ = _inputs((6, 64), seed=1)
    p = {"scale": scale, "bias": bias}
    y = cm.layer_norm_apply(p, x)                           # CPU: decomposed
    cm.layer_norm_apply(cm.cast_floats(p, torch.bfloat16), x.bfloat16())
    assert calls == []
    # where the rule says kernels, the function serves it (its twins on
    # the CPU) and gives the decomposed form's numbers
    monkeypatch.setattr(cln, "served_by_kernels",
                        lambda device, dtype: dtype == torch.float32)
    y2 = cm.layer_norm_apply(p, x)
    assert calls == [torch.float32]
    torch.testing.assert_close(y2, y, **FWD)
    cm.layer_norm_apply(cm.cast_floats(p, torch.bfloat16), x.bfloat16())
    assert calls == [torch.float32]


def _source_row_plans():
    src = cln.SOURCE.read_text()
    body = src[src.index("#define LN_ROW_PLANS(X)"):]
    body = body[:body.index("enum")]
    return tuple(tuple(int(v) for v in m)
                 for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", body))


def test_plan_by_width():
    """Every width to 1,100, aligned or not: a row in registers up to
    1,024 (8 or 16 lanes to 64, a warp above), 16-byte loads only where D
    % 4 == 0 and aligned, one of the source's instantiations, the row
    covered and its shared memory under 48 KB; a warp walking the row above
    1,024. Every instantiation is some width's plan."""
    assert cln.ROW_PLANS == _source_row_plans()
    taken = set()
    for D in range(1, 1101):
        for aligned in (True, False):
            p = cln.plan(D, aligned)
            if D > cln.MAX_ROW_WIDTH:
                assert p.variant == cln.LOOP and p.rows_per_block == 8
                continue
            assert p.variant == cln.ROWS
            key = (p.lanes, p.vec, p.chunks)
            assert key in cln.ROW_PLANS, (D, p)
            taken.add(key)
            assert p.lanes in ((8, 16) if D <= 64 else (32,))
            assert p.vec == (4 if D % 4 == 0 and aligned else 1)
            assert p.lanes * p.vec * p.chunks >= D
            assert p.lanes * p.vec * p.chunks // 2 < D or p.chunks == 1
            assert cln.THREADS // p.lanes * D * 4 <= 48 * 1024
    assert taken == set(cln.ROW_PLANS)
    with pytest.raises(ValueError):
        cln.plan(0)
    # the cells' widths
    assert cln.plan(64) == cln.Plan(cln.ROWS, 8, 4, 2)
    assert cln.plan(18) == cln.Plan(cln.ROWS, 8, 1, 4)
    assert cln.plan(54) == cln.Plan(cln.ROWS, 16, 1, 4)
    assert cln.plan(512) == cln.Plan(cln.ROWS, 32, 4, 4)
    assert cln.plan(660) == cln.Plan(cln.ROWS, 32, 4, 8)
    assert cln.plan(785) == cln.Plan(cln.ROWS, 32, 1, 32)


@pytest.mark.parametrize("N,D", [(1_228_800, 64), (1_228_800, 18),
                                 (200_000, 785), (49_152, 64), (1, 1100),
                                 (33, 1100), (7, 54)])
def test_grids(N, D):
    p = cln.plan(D)
    g = cln.fwd_grid(N, p)
    assert (g - 1) * p.rows_per_block < N <= g * p.rows_per_block
    for bps in (1, 4):
        b = cln.bwd_grid(N, p, H100_SMS, bps)
        assert 1 <= b <= min(g, H100_SMS * bps)
        assert cln.partial_rows(p, b) == b * (8 if p.variant == cln.LOOP
                                              else 1)
    assert cln.bwd_grid(N, p, H100_SMS, 4) == min(g, 4 * H100_SMS)


def _hatrpo_minibatch(device):
    """A HATRPO runner (3 agents, recurrent, hidden 16) on `device`: its
    agent 0, that agent's initial state and its minibatch of one
    rollout."""
    from onpolicy_torch.config import Config, canonicalize_algorithm
    from onpolicy_torch.ops import losses
    from onpolicy_torch.runner.separated_runner import SeparatedRunner
    cfg = canonicalize_algorithm(Config(
        algorithm_name="hatrpo", scenario_name="simple_spread", num_agents=3,
        num_landmarks=3, n_rollout_threads=4, episode_length=25,
        num_env_steps=100, hidden_size=16, data_chunk_length=10,
        num_mini_batch=1, device=device))
    runner = SeparatedRunner(cfg)
    states, carry = runner.init()
    _, bufs = runner.rollout(states, carry)
    algo, buf = runner.algos[0], bufs[0]
    adv = losses.normalize_advantages(buf.advantages, buf.active_masks[:-1])
    return algo, states[0], algo._sample_minibatches(buf, adv, None)[0]


def _fvp(algo, state, mb, v):
    return algo.fisher_vector_product(state, mb)(v)


def test_hatrpo_fisher_vector_product_through_the_function(monkeypatch):
    """HATRPO's Fisher-vector product (reverse over reverse, through every
    LayerNorm of the MLP base and the GRU's output norm) is the same with
    every LayerNorm on `LayerNorm` as on the decomposed form."""
    from onpolicy_torch.algorithms import hatrpo
    algo, state, mb = _hatrpo_minibatch("cpu")
    theta0, _ = hatrpo._flatten(state.actor_params)
    v = torch.randn(theta0.shape, generator=torch.Generator().manual_seed(4))
    want = _fvp(algo, state, mb, v)
    calls = []
    real = cln.LayerNorm.apply
    monkeypatch.setattr(cln, "served_by_kernels", lambda device, dtype: True)
    monkeypatch.setattr(cln.LayerNorm, "apply",
                        lambda *a: calls.append(1) or real(*a))
    got = _fvp(algo, state, mb, v)
    assert calls
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")


def _param_grads_close(got, x, dy, mean, rstd):
    """dscale and dbias against float64 sums of the same terms, to the
    f32 rounding of sums of that many terms."""
    D = x.shape[-1]
    xh = ((x.double() - mean.double()[..., None])
          * rstd.double()[..., None]).reshape(-1, D)
    d = dy.double().reshape(-1, D)
    for g, terms in zip(got, (d * xh, d)):
        want = terms.sum(0)
        tol = 1e-6 * terms.abs().sum(0).max()
        err = (g.double() - want).abs().max()
        assert err <= tol, (float(err), float(tol))


CARD_SHAPES = [(1_228_800, 18), (1_228_800, 54), (1_228_800, 64),
               (200_000, 512), (200_000, 660), (200_000, 785), (49_152, 64),
               # ragged tiles, odd widths, a lone row, the loop variant
               (1001, 1), (1001, 33), (3, 100), (1, 64), (517, 1100),
               (97, 2049)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", CARD_SHAPES)
def test_kernels_match_plain_twins_on_the_card(N, D):
    _card()
    x, scale, bias, dy = _inputs((N, D), seed=N + D, device="cuda")
    f0, b0 = cln.FWD_LAUNCHES, cln.BWD_LAUNCHES
    y, mean, rstd = cln.layer_norm_fwd(x, scale, bias, cm.LN_EPS)
    ry, rmean, rrstd = cln.layer_norm_fwd_ref(x, scale, bias, cm.LN_EPS)
    torch.testing.assert_close(y, ry, **FWD)
    torch.testing.assert_close(mean, rmean, **FWD)
    torch.testing.assert_close(rstd, rrstd, **FWD)
    dx, dscale, dbias = cln.layer_norm_bwd(x, scale, dy, mean, rstd)
    rdx, _, _ = cln.layer_norm_bwd_ref(x, scale, dy, mean, rstd)
    torch.testing.assert_close(dx, rdx, **GRAD)
    _param_grads_close((dscale, dbias), x, dy, mean, rstd)
    again = cln.layer_norm_bwd(x, scale, dy, mean, rstd)
    for a, b in zip((dx, dscale, dbias), again):
        assert torch.equal(a, b), "the backward is not deterministic"
    none, ds2, db2 = cln.layer_norm_bwd(x, scale, dy, mean, rstd,
                                        need_dx=False)
    assert none is None and torch.equal(ds2, dscale)
    assert torch.equal(db2, dbias)
    assert (cln.FWD_LAUNCHES - f0, cln.BWD_LAUNCHES - b0) == (1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("D", (64, 660))
def test_kernels_take_unaligned_and_non_contiguous_inputs_on_the_card(D):
    """An x that starts off a 16-byte boundary takes the scalar loads; a
    strided x goes through the function's copy; both give the twin's
    numbers, forward, backward and double backward (the strided x is a
    slice taken under autograd, so the second order has to reach the wide
    tensor it came from)."""
    _card()
    x, scale, bias, dy = _inputs((301, D + 1), seed=D, device="cuda")
    assert not x[:, 1:].is_contiguous()                 # strided, off by 4 B
    flat = lambda t: t.reshape(-1)[1:1 + 300 * D].view(300, D)
    assert flat(x).data_ptr() % 16 != 0                 # contiguous, off by 4 B
    assert cln.plan(D, False).vec == 1
    v = torch.randn_like(x)
    for cut, g in ((lambda t: t[:, 1:], dy[:, 1:]), (flat, dy[:300, :D])):
        out = []
        for norm in (cln.LayerNorm.apply,
                     lambda *a: cln.layer_norm_fwd_ref(*a)[0]):
            wide = x.detach().clone().requires_grad_(True)
            s = scale[:D].clone().requires_grad_(True)
            b = bias[:D].clone().requires_grad_(True)
            y = norm(cut(wide), s, b, cm.LN_EPS)
            first = torch.autograd.grad(y, (wide, s, b), g, retain_graph=True)
            grads = torch.autograd.grad(y, (wide, s), g, create_graph=True)
            second = torch.autograd.grad((grads[0] * v).sum(), (wide, s))
            out.append((y, first, second))
        (y, first, second), (ry, rfirst, rsecond) = out
        torch.testing.assert_close(y, ry, **FWD)
        for a, w in zip(first, rfirst):
            torch.testing.assert_close(a, w, **GRAD)
        for a, w in zip(second, rsecond):
            torch.testing.assert_close(a, w, rtol=1e-4,
                                       atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_kernels_on_no_rows_on_the_card():
    _card()
    x = torch.zeros(0, 7, 64, device="cuda", requires_grad=True)
    s = torch.ones(64, device="cuda", requires_grad=True)
    b = torch.zeros(64, device="cuda", requires_grad=True)
    f0 = cln.FWD_LAUNCHES
    y = cm.layer_norm_apply({"scale": s, "bias": b}, x)
    assert y.shape == (0, 7, 64) and cln.FWD_LAUNCHES == f0
    gx, gs, gb = torch.autograd.grad(y.sum(), (x, s, b))
    assert gx.shape == (0, 7, 64) and not gs.any() and not gb.any()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take_on_the_card():
    _card()
    x, scale, bias, _ = _inputs((8, 64), seed=0, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        cln.layer_norm_fwd(x.double(), scale, bias, cm.LN_EPS)
    with pytest.raises(ValueError, match="shape"):
        cln.layer_norm_fwd(x, scale[:32], bias, cm.LN_EPS)
    with pytest.raises(ValueError, match="contiguous"):
        cln.layer_norm_fwd(x.t(), scale[:8], bias[:8], cm.LN_EPS)
    with pytest.raises(ValueError, match="on cpu"):
        cln.layer_norm_fwd(x, scale.cpu(), bias, cm.LN_EPS)


@pytest.mark.cuda
def test_double_backward_on_the_card_matches_the_decomposed_form(monkeypatch):
    """A Hessian-vector product through `LayerNorm` on the card (the
    forward on the kernel, the backward under grad mode on the plain
    twin) equals the decomposed form's on the card."""
    _card()
    x, scale, bias, dy = _inputs((4096, 64), seed=5, device="cuda")
    v = torch.randn_like(x)

    def hvp():
        xs = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
        y = cm.layer_norm_apply({"scale": xs[1], "bias": xs[2]}, xs[0])
        g = torch.autograd.grad((y * dy).square().sum(), xs,
                                create_graph=True)
        return torch.autograd.grad((g[0] * v).sum() + g[1].sum(), xs)

    f0, b0 = cln.FWD_LAUNCHES, cln.BWD_LAUNCHES
    got = hvp()
    # the first gradient runs the twin; the second reaches y again through
    # the first's cotangent (2 (y dy) dy) and runs the backward kernel
    assert (cln.FWD_LAUNCHES - f0, cln.BWD_LAUNCHES - b0) == (1, 1)
    monkeypatch.setattr(cln, "served_by_kernels", lambda device, dtype: False)
    want = hvp()
    assert cln.FWD_LAUNCHES - f0 == 1
    for a, w in zip(got, want):
        scale_ = float(w.abs().max())
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5 * scale_)


@pytest.mark.cuda
def test_counters_on_the_card():
    """`layer_norm_fused` counts each forward and backward on the kernels,
    `layer_norm_plain` a bf16 forward and a backward under grad mode."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    x, scale, bias, dy = _inputs((64, 64), seed=6, device="cuda")
    s = scale.clone().requires_grad_(True)
    p = {"scale": s, "bias": bias}
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        y = cm.layer_norm_apply(p, x)
        torch.autograd.grad(y, s, dy)
        cm.layer_norm_apply(cm.cast_floats(p, torch.bfloat16), x.bfloat16())
        y = cm.layer_norm_apply(p, x)
        torch.autograd.grad(y, s, dy, create_graph=True)
        counters = profiling.take()["counters"]
    assert counters == {"layer_norm_fused": 3, "layer_norm_plain": 2}


@pytest.mark.cuda
def test_hatrpo_on_the_card():
    """HATRPO's Fisher-vector product on the card (the LayerNorms on the
    kernels forward, on the twin under grad mode) equals the decomposed
    one on the CPU for the same minibatch, and one TRPO update of the
    agent runs on the card."""
    _card()
    from onpolicy_torch.algorithms import hatrpo
    algo, state, mb = _hatrpo_minibatch("cuda")
    theta0, _ = hatrpo._flatten(state.actor_params)
    v = torch.randn(theta0.shape, generator=torch.Generator().manual_seed(4))
    cpu = lambda t: t.cpu()
    want = _fvp(algo, state.replace(actor_params=tree_map(
        cpu, state.actor_params)), tree_map(cpu, mb), v)
    f0 = cln.FWD_LAUNCHES
    got = _fvp(algo, state, mb, v.cuda())
    assert cln.FWD_LAUNCHES > f0
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4 * scale)
    new, metrics = algo._trpo_update(state, mb)
    for k, m in metrics.items():
        assert torch.isfinite(m).all(), k
    assert torch.isfinite(hatrpo._flatten(new.actor_params)[0]).all()
