"""The wide GRU forward (`tensor_core_wide`, 64 < H <= 512, H % 32 == 0)
on the CPU: its plain one-step twin, composed over T, against the plain
forward and against the JAX package's, and its launch plan.

On the card the forward at these widths is one kernel launched once a
time step (`gru_fwd_wide_step`): the gate product GH_t = (h * m_t) @ W_hh
+ b_hh over all B rows as a GEMM, the gate math in its epilogue, h
carried in f32 from one launch to the next. Its plain twin
(`cuda_gru.gru_fwd_step_ref`, whose time loop is the plain forward
`gru_layer_fwd_ref`) is what the CPU can reach; here, composed over T as
the launches compose, against `gru_layer_fwd_ref` and the CPU wrapper,
and against `pallas_gru.gru_layer_sequence` (its `_fwd_call`) in
interpret mode, as tests/test_pallas_gru.py runs it. Inputs come from a
numpy seed.
Tolerances: f32 rtol/atol 1e-5 (the forward's tolerance of
tests/test_pallas_gru.py); with bf16 streams outs within one bf16 ulp
(rtol 2^-7) and hT, carried in f32, at 1e-5. The kernel itself is held
against the plain forward on the card by tests/test_torch_cuda_kernels.py
and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.ops import pallas_gru as pg

from onpolicy_torch.ops import cuda_gru

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
ULP = dict(rtol=2 ** -7, atol=2e-5)          # one bf16 ulp
H100_SMS, H100_SMEM_OPTIN = 132, 232_448
H100_SMEM_PER_SM = 233_472


def _inputs(T, B, H, seed, bf16, zero_t0=True):
    """numpy f32 layer inputs; the gi streams rounded to bf16 (and kept as
    f32 values) when `bf16`."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    rnd = (lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                .astype(jnp.float32))) if bf16 else (lambda a: a)
    x = dict(gir=rnd(f(T, B, H)), giz=rnd(f(T, B, H)), gin=rnd(f(T, B, H)),
             h0=f(B, H, scale=0.5), w_hh=f(H, 3 * H, scale=H ** -0.5),
             b_hh=f(3 * H, scale=0.1))
    m = (rng.random((T, B, 1)) > 0.2).astype(np.float32)
    if zero_t0:
        m[0] = 0.0
    x["masks"] = m
    return x


def _torch(x, bf16):
    sd = torch.bfloat16 if bf16 else torch.float32
    t = {k: torch.tensor(v) for k, v in x.items()}
    for k in ("gir", "giz", "gin"):
        t[k] = t[k].to(sd)
    return t


def _args(t):
    return (t["gir"], t["giz"], t["gin"], t["h0"], t["masks"], t["w_hh"],
            t["b_hh"])


def _steps(t):
    """The one-step twin composed over T: the wide forward on the CPU."""
    h, outs = t["h0"], []
    for s in range(t["gir"].shape[0]):
        out, h = cuda_gru.gru_fwd_step_ref(t["gir"][s], t["giz"][s],
                                           t["gin"][s], h, t["masks"][s],
                                           t["w_hh"], t["b_hh"])
        assert out.dtype == t["gir"].dtype and h.dtype == torch.float32
        outs.append(out)
    return torch.stack(outs), h


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _close(got, want, bf16):
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), err_msg="outs",
                               **(ULP if bf16 else FWD))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), err_msg="hT", **FWD)


CASES = [
    # T, B, H, bf16, masks zero at t=0
    (3, 37, 128, False, True),    # B ragged against 128-row tiles
    (1, 5, 128, False, True),     # T = 1, below one tile
    (4, 20, 512, False, True),    # the Hanabi width
    (1, 9, 512, False, False),    # T = 1, h0 in the product
    (3, 133, 96, False, True),    # one tile and 5 rows; 3 unit tiles
    (2, 37, 96, False, False),
    (3, 37, 128, True, True),     # bf16 streams
    (2, 11, 512, True, False),
    (3, 133, 96, True, True),
]


@pytest.mark.parametrize("T,B,H,bf16,zero_t0", CASES)
def test_step_twin_composes_to_the_plain_forward(T, B, H, bf16, zero_t0):
    t = _torch(_inputs(T, B, H, seed=T * 31 + B + H, bf16=bf16,
                       zero_t0=zero_t0), bf16)
    got = _steps(t)
    want = cuda_gru.gru_layer_fwd_ref(*_args(t))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    _close(got, want, bf16)
    # the CPU wrapper takes the plain version
    cpu = cuda_gru.gru_layer_fwd(*_args(t))
    for a, b in zip(cpu, want):
        assert torch.equal(a, b)


def _jax_forward(x, bf16):
    """`gru_layer_sequence` (`_fwd_call`) at B padded to the Pallas batch
    tile with zero rows and masks; returns (outs, hT) of the first B rows."""
    T, B, H = x["gir"].shape
    sd = jnp.bfloat16 if bf16 else jnp.float32
    tile = pg._b_tile(H, itemsize=2 if bf16 else 4)
    bp = -(-B // tile) * tile
    pad = lambda a, axis: np.pad(a, [(0, bp - B) if i == axis else (0, 0)
                                     for i in range(a.ndim)])
    gi = [jnp.asarray(pad(x[k], 1)).astype(sd) for k in ("gir", "giz", "gin")]
    w = x["w_hh"]
    outs, hT = pg.gru_layer_sequence(
        *gi, jnp.asarray(pad(x["h0"], 0)), jnp.asarray(pad(x["masks"], 1)),
        w[:, :H], w[:, H:2 * H], w[:, 2 * H:], x["b_hh"].reshape(3, H))
    assert outs.dtype == sd and hT.dtype == jnp.float32
    return (np.asarray(outs.astype(jnp.float32))[:, :B],
            np.asarray(hT)[:B])


@pytest.mark.parametrize("T,B,H,bf16,zero_t0", CASES)
def test_step_twin_matches_pallas(T, B, H, bf16, zero_t0):
    x = _inputs(T, B, H, seed=T * 17 + B + H, bf16=bf16, zero_t0=zero_t0)
    _close(_steps(_torch(x, bf16)), _jax_forward(x, bf16), bf16)


# The wide forward's launch plan, chosen from the shape and the card.

@pytest.mark.parametrize("B,H,grid", [
    (20_000, 512, 16 * 157),   # the Hanabi shape: 157 row tiles, 16 unit tiles
    (37, 512, 16),             # one ragged row tile
    (32, 128, 4),              # Hanabi-Small's update
    (960, 256, 8 * 8),
    (333, 128, 4 * 3),
    (122_880, 96, 3 * 960),
    (5, 480, 15),
])
def test_fwd_plan_routes_the_wide_widths(B, H, grid):
    assert cuda_gru.wide_widths(H)
    for itemsize in (4, 2):    # both stream types take the same plan
        plan = cuda_gru.fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN, itemsize)
        assert plan.variant == cuda_gru.WIDE and plan.name == "tensor_core_wide"
        assert plan == cuda_gru.wide_fwd_plan(B, H)
        assert (plan.bt, plan.grid) == (128, grid)
        assert plan.grid == (H // 32) * -(-B // 128)
        assert plan.smem_bytes == cuda_gru.wide_fwd_smem_bytes() == 95_232


@pytest.mark.parametrize("B,H", [(20_000, 512), (333, 128), (37, 256),
                                 (5003, 160)])
def test_wide_fwd_grid_depends_only_on_shape_and_sm_count(B, H):
    """The grid of every step launch follows from (B, H): neither the SM
    count nor the shared memory a card offers changes it, and a card that
    cannot hold the step kernel's shared memory takes the CUDA-core
    forward rather than another grid."""
    plan = cuda_gru.fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
    for n_sm, optin in ((H100_SMS, plan.smem_bytes), (114, H100_SMEM_OPTIN),
                        (8, 2 ** 20)):
        assert cuda_gru.fwd_plan(B, H, n_sm, optin) == plan
    small = cuda_gru.fwd_plan(B, H, H100_SMS, plan.smem_bytes - 1)
    assert small == cuda_gru.cuda_core_fwd_plan(B, H, H100_SMS,
                                                plan.smem_bytes - 1)


@pytest.mark.parametrize("H", [16, 32, 40, 48, 64, 80, 100, 520, 544, 1024])
def test_other_widths_keep_their_forward(H):
    """H <= 64 keeps the tensor-core kernel where it has one, every H
    outside the wide widths the CUDA-core kernel, as before."""
    assert not cuda_gru.wide_widths(H)
    for B in (5, 960, 122_880):
        plan = cuda_gru.fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
        if H in cuda_gru.MMA_WIDTHS:
            assert plan.variant == cuda_gru.MMA
        else:
            assert plan == cuda_gru.cuda_core_fwd_plan(B, H, H100_SMS,
                                                       H100_SMEM_OPTIN)


def test_cuda_core_forward_stays_reachable_with_w_in_memory():
    """The CUDA-core forward with W read from device memory, which the wide
    widths no longer take by default: its plan at the Hanabi shape and at
    H=128 with 64-row tiles (W beside them exceeds a block's shared
    memory), the shape chip_smoke.py checks it at."""
    old = cuda_gru.cuda_core_fwd_plan(20_000, 512, H100_SMS, H100_SMEM_OPTIN)
    assert old == (cuda_gru.GLOBAL_W, 16, 1250, 4 * (2 * 16 * 512 + 16))
    at128 = cuda_gru.cuda_core_fwd_plan(17_000, 128, H100_SMS,
                                        H100_SMEM_OPTIN)
    assert at128 == (cuda_gru.GLOBAL_W, 64, 266, 4 * (2 * 64 * 128 + 64))
    assert cuda_gru.fwd_plan(17_000, 128, H100_SMS, H100_SMEM_OPTIN).variant \
        == cuda_gru.WIDE


def _wide_fwd_layout_bytes():
    """`WideFwd::BYTES` of csrc/gru_seq.cu, member by member."""
    bm, u, bk, stages = 128, 32, 32, 3
    bn = 3 * u
    a_bytes = bm * (bk + 4) * 4
    b_bytes = bk * (bn + 8) * 4
    return stages * (a_bytes + b_bytes)


def test_wide_fwd_layout_mirrors_the_source():
    src = cuda_gru.SOURCE.read_text()
    start = src.index("struct WideFwd {")
    layout = src[start:src.index("};", start)]
    for line in ("static constexpr int BM = 128, U = 32, BN = 3 * U, BK = 32;",
                 "static constexpr int THREADS = 256, STAGES = 3, "
                 "MIN_BLOCKS = 2;",
                 "static constexpr int AS = BK + 4;",
                 "static constexpr int BS = BN + 8;"):
        assert line in layout, line
    assert (cuda_gru.FWD_BM, cuda_gru.FWD_U, cuda_gru.FWD_BK,
            cuda_gru.FWD_STAGES) == (128, 32, 32, 3)
    want = _wide_fwd_layout_bytes()
    assert cuda_gru.wide_fwd_smem_bytes() == want == 95_232
    assert f"{want:,}" in src          # the source's note on its layout
    # two blocks an SM, as its launch bounds ask
    assert 2 * (want + cuda_gru.SMEM_PER_BLOCK_RESERVED) <= H100_SMEM_PER_SM
