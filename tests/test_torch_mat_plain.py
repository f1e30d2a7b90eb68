"""The port's MAT (`models/transformer.py`, `algorithms/mat.py`) against
the plain reference that the benchmark holds it to
(`portbench/reference/mat.py`), on the benchmark's seeded random weights,
without JAX.

On the CPU at a small size (8 worlds, 3 agents, T = 5, n_embd 16,
n_head 2, n_block 2, so that the head split and the stacked blocks run):
the autoregressive act's log-probs and values with the actions
injected, the teacher-forced pass against the autoregressive one, the
first 3 Adam steps' losses and parameters of one training call, and that
a decoder without its causal mask fails the comparison. On the card
(marked `cuda`): the act and the teacher-forced pass at the published
widths (n_embd 64, n_head 1, n_block 1).

Tolerances: both sides compute in float32 the same operations in other
orders and forms (LayerNorm by rsqrt or by division, GELU by `F.gelu` or
by erf), so each output carries a few float32 roundings of unit-sized
numbers, about 1e-7 each, through ~30 chained layers: 2e-5 leaves room
above that, and a dropped causal mask moves the log-probs by 1e-2 or
more.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from onpolicy_torch.config import config_from_args  # noqa: E402
from onpolicy_torch.models import transformer as tfm  # noqa: E402
from onpolicy_torch.runner.shared_runner import SharedRunner  # noqa: E402
from portbench import program  # noqa: E402
from portbench.drivers.mpe_mat import watch_steps  # noqa: E402
from portbench.reference import mat, ppo  # noqa: E402

SMALL = {"n_block": 2, "n_embd": 16, "n_head": 2}
PUBLISHED = {"n_block": 1, "n_embd": 64, "n_head": 1}
OBS, A, M = 18, 5, 3
# float32 roundings through the chained layers (module docstring)
ATOL = 2e-5


def _weights(hp, device, seed=11):
    g = torch.Generator(device=device).manual_seed(seed)
    return mat.make_params(hp, OBS, A, g, device)


def _program_params(hp, weights, device):
    mcfg = tfm.MATConfig(M, A, hp["n_block"], hp["n_embd"], hp["n_head"])
    params = tfm.mat_init(mcfg, OBS, torch.Generator().manual_seed(0),
                          device)
    with torch.no_grad():
        program.load_weights(params, weights)
    return mcfg, params


def _inputs(B, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    obs = torch.randn(B, M, OBS, generator=g, device=device)
    actions = torch.randint(0, A, (B, M, 1), generator=g, device=device)
    return obs, actions


def _act_gaps(hp, device, B):
    weights = _weights(hp, device)
    mcfg, params = _program_params(hp, weights, device)
    obs, actions = _inputs(B, device)
    with torch.no_grad():
        acts, logp, value = tfm.autoregressive_act(
            mcfg, params, obs, None, actions=actions)
        ref_logp, ref_value = mat.act(weights, hp, obs, actions, A)
    assert torch.equal(acts.long(), actions)
    return ((logp - ref_logp).abs().max().item(),
            (value - ref_value).abs().max().item())


def test_autoregressive_act_matches_the_reference():
    gaps = _act_gaps(SMALL, "cpu", 40)
    assert max(gaps) < ATOL, gaps


def test_dropped_causal_mask_fails_the_comparison(monkeypatch):
    old = tfm.attn_apply
    monkeypatch.setattr(tfm, "attn_apply",
                        lambda p, k, v, q, n_head, masked:
                        old(p, k, v, q, n_head, False))
    logp_gap, value_gap = _act_gaps(SMALL, "cpu", 40)
    # the encoder's attention is unmasked already: values agree
    assert value_gap < ATOL
    assert logp_gap > 1e-2


def _teacher_forced(hp, device, B):
    weights = _weights(hp, device)
    mcfg, params = _program_params(hp, weights, device)
    obs, actions = _inputs(B, device)
    with torch.no_grad():
        _, ar_logp, ar_value = tfm.autoregressive_act(
            mcfg, params, obs, None, actions=actions)
        tf_logp, tf_value, tf_ent = tfm.parallel_act(mcfg, params, obs,
                                                     actions)
        ref_logp, ref_value, ref_ent = mat.evaluate(weights, hp, obs,
                                                    actions, A)
    # the causal mask makes slot i of the one teacher-forced pass the
    # slot i of the i-th autoregressive pass: the same rows of the same
    # products
    assert (tf_logp - ar_logp).abs().max() < 1e-6
    assert torch.equal(tf_value, ar_value)
    for got, want in ((tf_logp, ref_logp), (tf_value, ref_value),
                      (tf_ent, ref_ent)):
        assert (got - want).abs().max() < ATOL


def test_teacher_forced_pass_equals_the_autoregressive_one():
    _teacher_forced(SMALL, "cpu", 40)


FLAGS = ["--env_name", "MPE", "--algorithm_name", "mat", "--scenario_name",
         "simple_spread", "--num_agents", "3", "--num_landmarks", "3",
         "--n_rollout_threads", "8", "--episode_length", "5",
         "--ppo_epoch", "3", "--lr", "5e-4", "--n_block", "2",
         "--n_embd", "16", "--n_head", "2", "--seed", "5", "--device", "cpu"]


def test_first_three_adam_steps_match_the_reference():
    runner = SharedRunner(config_from_args(FLAGS))
    state, carry = runner.init()
    cfg = runner.cfg
    hp = {**SMALL, **{k: getattr(cfg, k) for k in (
        "lr", "opti_eps", "ppo_epoch", "num_mini_batch", "clip_param",
        "entropy_coef", "value_loss_coef", "max_grad_norm", "huber_delta")}}
    weights = _weights(hp, "cpu")
    with torch.no_grad():
        program.load_weights(state.params, weights)
    _, buf = runner.rollout(state, carry)
    rec, stop = watch_steps(runner.algo, 3)
    runner.algo.train(state, buf, runner.generator)
    stop()
    T = cfg.episode_length
    ref_steps = {}

    def on_step(k, params, opt):
        ref_steps[k] = {k2: v.clone() for k2, v in params.items()}

    _, _, _, losses = mat.mat_update(
        hp, weights, ppo.adam_init(weights), ppo.vnorm_init("cpu"),
        {"obs": buf.obs[:T], "actions": buf.actions,
         "old_logp": buf.action_log_probs, "value_preds": buf.value_preds[:T],
         "returns": buf.returns, "advantages": buf.advantages,
         "active": buf.active_masks[:T], "avail": None}, A, on_step)
    for k in range(3):
        for name in ("policy_loss", "value_loss", "dist_entropy"):
            want = float(losses[name][k])
            got = rec["losses"][k][name]
            # float32 sums over the 120 tokens of unit-sized terms
            assert math.isclose(got, want, rel_tol=1e-5, abs_tol=1e-6), \
                (k, name, got, want)
    # Adam's first steps move every parameter by about lr a step,
    # whatever its gradient's size, so the change after 3 steps is held
    # element by element to 1 % of one step
    for name, p in rec["params"].items():
        change = p - weights[name]
        want = ref_steps[3][name] - weights[name]
        assert (change - want).abs().max() <= 0.01 * cfg.lr, name


@pytest.mark.cuda
def test_act_and_teacher_forced_pass_at_the_published_widths_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        gaps = _act_gaps(PUBLISHED, "cuda", 4096)
        assert max(gaps) < ATOL, gaps
        _teacher_forced(PUBLISHED, "cuda", 4096)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
