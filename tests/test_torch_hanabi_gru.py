"""The sequence GRU at Hanabi width, H=512, against the JAX package's.

`train_hanabi_device.sh` trains rMAPPO at hidden 512 over 1000 fleets:
each PPO epoch runs the GRU over T=10 chunks of B=100·1000·2/10=20,000
rows, through the wide tensor-core forward and backward on the card.
Here, on the CPU: the port's plain forward and backward at H=512
(small T and B) against `pallas_gru` in interpret mode, at the tolerances
of tests/test_torch_gru_kernel.py (its loss, with the readout scaled to
keep the gradients O(1) at this width), and the plans the card takes at the
Hanabi shape: W (3.15 MB) fits no block's shared memory, so the forward
streams it from L2 into one GEMM a step (128-row by 32-unit tiles, 2512
blocks a step; the CUDA-core forward's plan, 16-row tiles reading W from
device memory, stays for a caller that asks for it) and the backward
streams it from L2 through its carry kernel (32-row tiles, 132 blocks),
with GH, dG and 98 dW/db partials of (H+1)·3H floats as scratch; the old
CUDA-core backward's plan (1250 partials) stays for a caller that asks
for it. And the trainer state
of that configuration (hidden 512, layer_N 2, gain 0.01, Hanabi-Full's
obs 660 / share 785 / 20 moves) carries across from JAX by
`utils/params.py`: the port's actor and critic give JAX's outputs.
"""
import jax
import numpy as np
import pytest
import torch

from onpolicy_tpu.algorithms.mappo import MAPPO as JaxMAPPO
from onpolicy_tpu.config import config_from_args as j_config_from_args
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch.algorithms.mappo import MAPPO
from onpolicy_torch.ops import cuda_gru
from onpolicy_torch.scripts import train_hanabi
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         train_state_to_jax)

from test_torch_gru_kernel import (FWD, GRAD, _case, _jax_value_and_grads,
                                   _torch_value_and_grads)
from onpolicy_torch.utils.tree import tree_leaves

H100_SMS, H100_SMEM_OPTIN = 132, 232448
HANABI = dict(T=10, B=20000, H=512)


@pytest.mark.parametrize("T,B,layers", [(3, 8, 1), (1, 5, 1)])
def test_h512_sequence_matches_pallas(T, B, layers):
    H, D = 512, 24
    params, xs, hxs, masks, w_out = _case(T, B, D, H, layers, seed=T + B)
    # the loss's readout scaled by H^-1/2, as chip_smoke.py scales its own,
    # so that the gradients stay O(1) at H=512 as they are at H <= 16
    w_out = w_out * np.float32(H ** -0.5)
    j_outs, j_hT, j_grads = _jax_value_and_grads(params, xs, hxs, masks,
                                                 w_out, H, layers)
    t_outs, t_hT, t_grads = _torch_value_and_grads(params, xs, hxs, masks,
                                                   w_out)
    np.testing.assert_allclose(t_outs.numpy(), np.asarray(j_outs), **FWD)
    np.testing.assert_allclose(t_hT.numpy(), np.asarray(j_hT), **FWD)
    j_params, j_xs, j_hxs = j_grads
    want = tree_leaves(j_params) + [j_xs, j_hxs]
    for got, ref in zip(t_grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


def test_plans_at_the_hanabi_shape():
    B, H = HANABI["B"], HANABI["H"]
    assert cuda_gru.batch_tile(B, H, H100_SMS) == 16
    for itemsize in (4, 2):
        # the forward: a GEMM a step over 128-row by 32-unit tiles, 16 x 157
        # blocks a launch; the CUDA-core plan it replaces stays reachable
        f = cuda_gru.fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN, itemsize)
        assert (f.name, f.bt, f.grid) == ("tensor_core_wide", 128, 2512)
        assert f.smem_bytes == 95_232 <= H100_SMEM_OPTIN
        old_f = cuda_gru.cuda_core_fwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
        assert (old_f.name, old_f.bt, old_f.grid) == ("cuda_core_global_w",
                                                      16, 1250)
        assert old_f.smem_bytes == 4 * (2 * 16 * H + 16)
        b = cuda_gru.bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN, itemsize,
                              HANABI["T"])
        assert (b.name, b.bt, b.grid) == ("tensor_core_wide", 32, 132)
        assert b.smem_bytes == 4 * 2 * (H + 32) * 36 <= H100_SMEM_OPTIN
        # the wide backward's scratch: 98 dW/db partials (ranges of at most
        # 2048 of the 200,000 rows) and GH (then dG), 1.538 GB of f32, where
        # the CUDA-core kernel kept 1250 per-block partials, 3.94 GB
        assert b.splits == 98
        assert b.partial_floats == 98 * (H + 1) * 3 * H + 10 * B * 3 * H \
            == 384_420_864
        old = cuda_gru.cuda_core_bwd_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
        assert (old.name, old.bt, old.grid) == ("cuda_core_global_w", 16, 1250)
        assert old.smem_bytes == 4 * (5 * 16 * H + 2 * 16) <= H100_SMEM_OPTIN
        assert old.partial_floats == 1250 * (H + 1) * 3 * H == 984_960_000


def test_hanabi_device_train_state_carries_across():
    argv = train_hanabi.CONFIGS["hanabi_device"]
    cfg = train_hanabi.config_from_args(argv + ["--device", "cpu"])
    j_argv = [a for a in argv if a not in ("--hanabi_name", "Hanabi-Full")]
    j_cfg = j_config_from_args(j_argv + ["--scenario_name", "Hanabi-Full"])
    assert (cfg.hidden_size, cfg.layer_N, cfg.gain, cfg.recurrent_N) == (
        j_cfg.hidden_size, j_cfg.layer_N, j_cfg.gain, j_cfg.recurrent_N) \
        == (512, 2, 0.01, 1)
    jm = JaxMAPPO(j_cfg, j_sp.Box((660,)), j_sp.Box((785,)), j_sp.Discrete(20))
    tm = MAPPO(cfg, sp.Box((660,)), sp.Box((785,)), sp.Discrete(20))
    js = jax.device_get(jm.init_state(jax.random.PRNGKey(0)))
    ts = train_state_from_jax(js)
    back = train_state_to_jax(ts, js)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(0)
    B = 6
    obs = (rng.random((B, 660)) < 0.1).astype(np.float32)
    share = (rng.random((B, 785)) < 0.1).astype(np.float32)
    h = rng.standard_normal((B, 1, 512)).astype(np.float32) * 0.5
    masks = np.ones((B, 1), np.float32)
    avail = (rng.random((B, 20)) < 0.7).astype(np.float32)
    j_act, j_logp, j_h = jm.actor.forward(js.actor_params, obs, h, masks,
                                          jax.random.PRNGKey(1), avail, True)
    t_act, t_logp, t_h = tm.actor.forward(
        ts.actor_params, *map(torch.tensor, (obs, h, masks)), None,
        torch.tensor(avail), deterministic=True)
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
    for got, want in ((t_logp, j_logp), (t_h, j_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    j_v = jm.get_values(js, share, h, masks)
    t_v, _ = tm.get_values(ts, *map(torch.tensor, (share, h, masks)))
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), **FWD)
