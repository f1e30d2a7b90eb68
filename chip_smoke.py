#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`onpolicy_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which fails the run (non-zero exit) if it fails:
  1. card:    name and power limit (nvidia-smi); TF32 off for matmuls.
  2. build:   nvcc of onpolicy_torch/csrc/gru_seq.cu for sm_90a.
  3. kernels: the GRU kernels against their plain PyTorch versions on
              the card, in f32, at the flagship, bench, ragged (B=5 below
              one tile, B=37 and B=803 on 8-row tiles, B=5003 on 16-row
              tiles where blocks walk two), T=1, masked, recurrent_N=2 and
              H=16/32/48 shapes (tensor-core kernels, every (H, tile)
              instantiation), and at ragged, T=1, masked and H=40/128/256
              shapes of the CUDA-core kernels; each line names the forward
              and backward variants, tiles and grids; dW bitwise
              repeatable at the flagship and bench shapes.
  4. times:   kernel, plain version and cuDNN's nn.GRU (yardstick only)
              at the flagship and bench shapes, with CUDA events (`ms`);
              the kernels' device time from torch.profiler beside them
              (`device_ms`, null where the profiler saw no device time);
              then the CUDA-core forward and the tensor-core one on the
              same inputs through explicit plans, in turns (CUDA-core,
              tensor-core, tensor-core, CUDA-core).
  5. train:   one flagship-width episode at 8 rollout threads on the
              card against the CPU path from the same state; then the
              port's `scripts/train_mpe.main` with the flagship rMAPPO
              simple_spread flags for 10 episodes: every logged metric
              finite, each kernel launched 20 times an episode.
The last three lines are one JSON object with a row per kernel, the
card's name and power limit, and the result line
`{"ok": true, "device": {...}}`.
Exits non-zero with no result line when no CUDA device is present or
the port's package is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor-core
# flop/s, dense TF32 tensor-core flop/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12

FLAGSHIP = dict(T=10, B=960, H=64)       # 25*128*3/10 chunks of L=10
BENCH = dict(T=10, B=122880, H=64)       # 16384 rollout threads
TRAIN_ARGV = [
    "--env_name", "MPE", "--algorithm_name", "rmappo",
    "--experiment_name", "chip_smoke", "--scenario_name", "simple_spread",
    "--num_agents", "3", "--num_landmarks", "3", "--seed", "1",
    "--n_rollout_threads", "128", "--num_mini_batch", "1",
    "--episode_length", "25", "--num_env_steps", "32000",
    "--ppo_epoch", "10", "--use_ReLU", "false", "--gain", "0.01",
    "--lr", "7e-4", "--critic_lr", "7e-4", "--log_interval", "1",
    "--device", "cuda",
]


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------

def make_inputs(torch, T, B, H, seed, mask_mode="sprinkled"):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    x = dict(gir=rn(T, B, H), giz=rn(T, B, H), gin=rn(T, B, H),
             h0=rn(B, H, scale=0.5), w_hh=rn(H, 3 * H, scale=H ** -0.5),
             b_hh=rn(3 * H, scale=0.1))
    if mask_mode == "ones":
        m = torch.ones(T, B, 1, device=dev)
    else:
        m = (torch.rand(T, B, 1, generator=g, device=dev) > 0.1).float()
        m[0] = 0.0                      # every row starts an episode at t=0
    x["masks"] = m
    x["douts"] = rn(T, B, H, scale=0.1)
    x["dhT"] = rn(B, H, scale=0.1)
    return x


def max_err(a, b, scale=1.0):
    return float((a - b).abs().max()) / scale


def assert_close(torch, name, a, b, rtol, atol, scale=1.0):
    ok = torch.allclose(a / scale, b / scale, rtol=rtol, atol=atol)
    if not ok:
        raise AssertionError(
            f"{name}: max abs err {max_err(a, b, scale):.3e} "
            f"(scale {scale:.3g}, rtol {rtol}, atol {atol})")


def check_layer(torch, cg, case, T, B, H, mask_mode="sprinkled",
                bench_scale=False, repeat=False):
    """Kernel vs plain version for one layer; with `repeat` (or
    `bench_scale`) the backward also runs twice and must give the same
    bits. Returns (fwd_err, bwd_err)."""
    plan = cg.device_bwd_plan(torch.device("cuda"), B, H)
    fplan = cg.device_fwd_plan(torch.device("cuda"), B, H)
    x = make_inputs(torch, T, B, H, seed=T * 7919 + B * 31 + H,
                    mask_mode=mask_mode)
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    outs, hT = cg.gru_layer_fwd(*args)
    r_outs, r_hT = cg.gru_layer_fwd_ref(*args)
    torch.cuda.synchronize()
    assert_close(torch, f"{case} outs", outs, r_outs, 1e-5, 1e-5)
    assert_close(torch, f"{case} hT", hT, r_hT, 1e-5, 1e-5)
    fwd_err = max(max_err(outs, r_outs), max_err(hT, r_hT))

    bargs = (x["gir"], x["giz"], x["gin"], r_outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    got = cg.gru_layer_bwd(*bargs)
    ref = cg.gru_layer_bwd_ref(*bargs)
    torch.cuda.synchronize()
    names = ("dgir", "dgiz", "dgin", "dh0", "dw_hh", "db_hh")
    bwd_err = 0.0
    for n, a, b in zip(names, got, ref):
        # a sum of T*B products per entry reorders between the two
        # versions; at bench scale (1.2M terms) compare relative to |ref|
        scale = max(1.0, float(b.abs().max())) \
            if (bench_scale and n in ("dw_hh", "db_hh")) else 1.0
        assert_close(torch, f"{case} {n}", a, b, 2e-4, 2e-5, scale)
        bwd_err = max(bwd_err, max_err(a, b, scale))
    if bench_scale or repeat:
        again = cg.gru_layer_bwd(*bargs)
        torch.cuda.synchronize()
        for n, a, b in zip(names, got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"{case} {n}: backward not deterministic")
    log(f"  {case:<34} T={T:<3} B={B:<7} H={H:<4} "
        f"fwd {fplan.name:<18} (tile {fplan.bt}, {fplan.grid} blocks)  "
        f"bwd {plan.name:<18} (tile {plan.bt}, {plan.grid} blocks)  "
        f"fwd err {fwd_err:.2e}  bwd err {bwd_err:.2e}  ok")
    return fwd_err, bwd_err


def check_sequence_layers(torch, cg):
    """recurrent_N=2 through the autograd path (kernels, both layers)
    against the plain scan on the same card, outputs and every grad."""
    from onpolicy_torch.models import gru as gru_mod
    T, B, D, H, N = 10, 300, 24, 64, 2
    g = torch.Generator(device="cuda").manual_seed(5)
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device="cuda") * scale
    layers = []
    d_in = D
    for _ in range(N):
        layers.append({"w_ih": rn(d_in, 3 * H, scale=d_in ** -0.5),
                       "w_hh": rn(H, 3 * H, scale=H ** -0.5),
                       "b_ih": rn(3 * H, scale=0.1), "b_hh": rn(3 * H, scale=0.1)})
        d_in = H
    params = {"layers": layers, "norm": {"scale": 1.0 + rn(H, scale=0.1),
                                         "bias": rn(H, scale=0.1)}}
    xs, hxs = rn(T, B, D), rn(B, N, H, scale=0.5)
    masks = (torch.rand(T, B, 1, generator=g, device="cuda") > 0.2).float()
    masks[0] = 0.0
    w_out = rn(H, 3, scale=H ** -0.5)   # keeps the loss's gradients O(1)

    def grads(fn):
        leaves = [xs, hxs] + [v for l in layers for v in l.values()] \
            + list(params["norm"].values())
        leaves = [v.detach().requires_grad_() for v in leaves]
        x_, h_ = leaves[0], leaves[1]
        it = iter(leaves[2:])
        p = {"layers": [{k: next(it) for k in l} for l in layers],
             "norm": {k: next(it) for k in params["norm"]}}
        outs, hT = fn(p, x_, h_, masks)
        loss = ((outs @ w_out) ** 2).sum() + (hT * hT).sum()
        return (outs, hT), torch.autograd.grad(loss, leaves)

    (o1, h1), g1 = grads(cg.sequence)
    (o2, h2), g2 = grads(gru_mod.scan_sequence)
    torch.cuda.synchronize()
    assert_close(torch, "layers=2 outs", o1, o2, 1e-5, 1e-5)
    assert_close(torch, "layers=2 hT", h1, h2, 1e-5, 1e-5)
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert_close(torch, f"layers=2 grad {i}", a, b, 2e-4, 2e-5)
    log(f"  {'recurrent_N=2 autograd':<34} T={T:<3} B={B:<7} H={H:<4} ok")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, names, iters=20):
    """Device time per call of the kernels whose names contain one of
    `names`, summed from torch.profiler; None if it saw no device time.
    At the flagship width the kernels take less than the host needs to
    launch them, so CUDA events around back-to-back calls read the host."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if any(n in e.key for n in names))
    return us / iters / 1e3 if us > 0 else None


def bounds(T, B, H):
    """Least times in ms and what bounds them: each input read once and
    each output written once over the HBM rate, against the three hidden
    products (2*3*H^2*B*T flops forward, three times that backward). The
    products count on the f32 CUDA cores ("fwd", "bwd_f32") or, for the
    tensor-core kernels ("fwd_tc", "bwd_tc"), as three TF32 products each
    (3xTF32) over the dense TF32 peak. Gate elementwise math is not
    counted."""
    seq, st, w = T * B * H * 4, B * H * 4, (3 * H * H + 3 * H) * 4
    m = T * B * 4
    fwd_bytes = 3 * seq + m + st + w + seq + st
    bwd_bytes = 5 * seq + m + 2 * st + w + 3 * seq + st + w
    fwd_flops = 6.0 * H * H * B * T
    out = {}
    for key, nbytes, ops_s in (
            ("fwd", fwd_bytes, fwd_flops / F32_FLOP_S),
            ("fwd_tc", fwd_bytes, 3 * fwd_flops / TF32_FLOP_S),
            ("bwd_f32", bwd_bytes, 3 * fwd_flops / F32_FLOP_S),
            ("bwd_tc", bwd_bytes, 3 * 3 * fwd_flops / TF32_FLOP_S)):
        tb, tf = nbytes / HBM_BYTES_S * 1e3, ops_s * 1e3
        out[key] = (max(tb, tf), "bytes" if tb >= tf else "operations")
    return out


def time_shape(torch, cg, shape, card):
    T, B, H = shape["T"], shape["B"], shape["H"]
    x = make_inputs(torch, T, B, H, seed=11, mask_mode="ones")
    fargs = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
             x["b_hh"])
    outs, _ = cg.gru_layer_fwd_ref(*fargs)
    bargs = (x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    res = {
        "fwd_ms": time_ms(torch, lambda: cg.gru_layer_fwd(*fargs)),
        "bwd_ms": time_ms(torch, lambda: cg.gru_layer_bwd(*bargs)),
        "fwd_device_ms": device_ms(torch, lambda: cg.gru_layer_fwd(*fargs),
                                   ("gru_fwd_kernel",)),
        "bwd_device_ms": device_ms(torch, lambda: cg.gru_layer_bwd(*bargs),
                                   ("gru_bwd_kernel", "gru_bwd_reduce")),
        "fwd_plain_ms": time_ms(torch, lambda: cg.gru_layer_fwd_ref(*fargs),
                                iters=5),
        "bwd_plain_ms": time_ms(torch, lambda: cg.gru_layer_bwd_ref(*bargs),
                                iters=5),
    }
    # yardstick only, never called by the port: cuDNN's GRU on all-ones
    # masks computes the same recurrence, plus the input projection
    gru = torch.nn.GRU(H, H).cuda()
    xin = torch.randn(T, B, H, device="cuda", requires_grad=True)
    h0 = x["h0"][None].clone()
    with torch.no_grad():
        res["fwd_library_ms"] = time_ms(torch, lambda: gru(xin, h0))
    y, _ = gru(xin, h0)
    dy = torch.randn_like(y)
    res["bwd_library_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(y, [xin] + list(gru.parameters()),
                                           dy, retain_graph=True))
    b = bounds(T, B, H)
    res["fwd_bound_f32_ms"], res["fwd_bound_f32_by"] = b["fwd"]
    res["fwd_bound_tc_ms"], res["fwd_bound_tc_by"] = b["fwd_tc"]
    res["bwd_bound_f32_ms"], res["bwd_bound_f32_by"] = b["bwd_f32"]
    res["bwd_bound_tc_ms"], res["bwd_bound_tc_by"] = b["bwd_tc"]
    res["fwd_variant"] = cg.device_fwd_plan(torch.device("cuda"), B, H).name
    res["bwd_variant"] = cg.device_bwd_plan(torch.device("cuda"), B, H).name
    log(f"  times T={T} B={B} H={H} [{card}]: " + json.dumps(res))
    return res


def compare_forwards(torch, cg, shape, card):
    """The CUDA-core forward against the tensor-core one on the same
    inputs, each through an explicit plan, timed in turns (CUDA-core,
    tensor-core, tensor-core, CUDA-core) so that both see the same card:
    CUDA-event ms and torch.profiler device ms of each turn."""
    T, B, H = shape["T"], shape["B"], shape["H"]
    x = make_inputs(torch, T, B, H, seed=13, mask_mode="ones")
    fargs = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
             x["b_hh"])
    limits = cg.device_limits(torch.cuda.current_device())
    plans = {"cuda_core": cg.cuda_core_fwd_plan(B, H, *limits),
             "tensor_core": cg.fwd_plan(B, H, *limits)}
    res = {k: {"plan": plans[k]._asdict(), "event_ms": [], "device_ms": []}
           for k in plans}
    for k in ("cuda_core", "tensor_core", "tensor_core", "cuda_core"):
        fn = lambda: cg.gru_layer_fwd(*fargs, plan=plans[k])
        res[k]["event_ms"].append(time_ms(torch, fn))
        res[k]["device_ms"].append(device_ms(torch, fn, ("gru_fwd_kernel",)))
    log(f"  forward in turns T={T} B={B} H={H} [{card}]: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def check_small_against_cpu(torch):
    """One flagship-width episode at 8 rollout threads, on the card
    (kernels) and on the CPU (plain versions) from the same parameters,
    carry and actions: rollout buffers and the trained state must agree.
    f32 sums reorder between cuBLAS/the kernels and the CPU, and the
    differences pass through 25 env steps and 2 PPO epochs of Adam, hence
    atol 1e-4 / rtol 1e-3 on the buffer and 1e-4 / 1e-3 on parameters."""
    from onpolicy_torch.config import Config, canonicalize_algorithm
    from onpolicy_torch.envs.mpe.world import WorldState
    from onpolicy_torch.runner.shared_runner import SharedRunner
    from onpolicy_torch.utils.tree import tree_leaves, tree_map
    base = canonicalize_algorithm(Config(
        algorithm_name="rmappo", n_rollout_threads=8, episode_length=25,
        num_env_steps=200, ppo_epoch=2, use_ReLU=False, lr=7e-4,
        critic_lr=7e-4))
    gpu = SharedRunner(base.replace(device="cuda"))
    cpu = SharedRunner(base.replace(device="cpu"))
    ts_g, carry_g = gpu.init()
    ts_c, _ = cpu.init()
    to_cpu = lambda c: {**tree_map(lambda t: t.cpu(), {
        k: v for k, v in c.items() if k != "env_states"}),
        "env_states": WorldState.from_tensors(
            tree_map(lambda t: t.cpu(), c["env_states"].tensors()))}
    carry_c = to_cpu(carry_g)
    after_g, buf_g = gpu.rollout(ts_g, carry_g)
    T = base.episode_length
    inject = [{"actions": buf_g.actions[t].cpu()} for t in range(T)]
    inject[-1]["reset_states"] = to_cpu(after_g)["env_states"]
    _, buf_c = cpu.rollout(ts_c, carry_c, inject)
    err = 0.0
    for k in ("obs", "rewards", "action_log_probs", "value_preds",
              "rnn_states", "returns", "advantages"):
        a, b = getattr(buf_g, k).cpu(), getattr(buf_c, k)
        assert_close(torch, f"small rollout {k}", a, b, 1e-3, 1e-4)
        err = max(err, max_err(a, b))
    new_g, _ = gpu.algo.train(ts_g, buf_g, gpu.generator)
    new_c, _ = cpu.algo.train(ts_c, buf_c, cpu.generator)
    torch.cuda.synchronize()
    for part in ("actor_params", "critic_params"):
        for i, (a, b) in enumerate(zip(tree_leaves(getattr(new_g, part)),
                                       tree_leaves(getattr(new_c, part)))):
            assert_close(torch, f"small train {part}[{i}]", a.cpu(), b,
                         1e-3, 1e-4)
            err = max(err, max_err(a.cpu(), b))
    log(f"  card vs CPU, 1 episode at N=8: max abs err {err:.2e}  ok")


def train_main_path(torch, cg):
    from onpolicy_torch.scripts import train_mpe
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["ONPOLICY_TORCH_RESULTS"] = tmp
        cg.FWD_LAUNCHES = 0
        cg.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        _, history = train_mpe.main(TRAIN_ARGV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = cg.FWD_LAUNCHES, cg.BWD_LAUNCHES
    episodes = len([r for r in history if "value_loss" in r])
    if episodes < 10:
        raise AssertionError(f"only {episodes} episodes logged")
    for r in history:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"episode {r['episode']}: {k}={v}")
    want = 20 * episodes   # ppo_epoch 10 x (actor + critic) x recurrent_N 1
    if fwd != want or bwd != want:
        raise AssertionError(f"launches fwd={fwd} bwd={bwd}, want {want}")
    last = history[-1]
    mean_rew = sum(r["average_episode_rewards"] for r in history) / episodes
    log(f"  episodes {episodes}, wall {wall:.2f} s, launches fwd {fwd} "
        f"bwd {bwd}")
    log(f"env_steps_per_s {last['fps']:.1f}")
    log(f"mean_episode_reward {mean_rew:.4f}")
    return fwd, bwd


def main() -> int:
    if not (ROOT / "onpolicy_torch" / "csrc" / "gru_seq.cu").exists():
        print("chip_smoke.py: the onpolicy_torch package is not beside this "
              "script; run it from the root of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from onpolicy_torch.ops import cuda_gru as cg

    log("== 1. card")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("== 2. build")
    t0 = time.perf_counter()
    lib = cg.build()
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_suffix(".ptxas.txt").read_text().strip())

    log("== 3. kernels against their plain versions (f32)")
    f_err, b_err = check_layer(torch, cg, "flagship", **FLAGSHIP, repeat=True)
    check_layer(torch, cg, "bench (16384 threads)", **BENCH, bench_scale=True)
    check_layer(torch, cg, "B=37 (ragged 8-row tiles)", 10, 37, 64)
    check_layer(torch, cg, "B=5 (below one tile)", 10, 5, 64)
    check_layer(torch, cg, "B=803 (8k+3 rows)", 10, 803, 64)
    for walk in (cg.device_fwd_plan(torch.device("cuda"), 5003, 64),
                 cg.device_bwd_plan(torch.device("cuda"), 5003, 64)):
        if -(-5003 // walk.bt) <= walk.grid:
            raise AssertionError(f"B=5003: {walk} walks no second tile")
    check_layer(torch, cg, "B=5003 (ragged 16-row, 2 tiles)", 10, 5003, 64)
    check_layer(torch, cg, "T=1", 1, 960, 64)
    check_layer(torch, cg, "all-ones masks", 10, 960, 64, mask_mode="ones")
    check_layer(torch, cg, "H=48 (tensor-core backward)", 10, 960, 48)
    check_layer(torch, cg, "H=48 (tensor core, 16-row tiles)", 4, 2200, 48)
    check_layer(torch, cg, "H=32 (tensor core, 16-row tiles)", 4, 2200, 32)
    check_layer(torch, cg, "H=32 (tensor core, 8-row tiles)", 4, 300, 32)
    check_layer(torch, cg, "H=16 (tensor core, 8-row tiles)", 4, 300, 16)
    check_layer(torch, cg, "H=16 (tensor core, 16-row tiles)", 4, 2200, 16)
    check_layer(torch, cg, "H=40 (CUDA-core kernels)", 10, 960, 40)
    check_layer(torch, cg, "H=40 B=37 (ragged single tile)", 10, 37, 40)
    check_layer(torch, cg, "H=40 T=1", 1, 300, 40)
    check_layer(torch, cg, "H=40 all-ones masks", 10, 803, 40,
                mask_mode="ones")
    check_layer(torch, cg, "H=256 (weights in L2)", 10, 960, 256)
    check_layer(torch, cg, "H=128 (backward weights in L2)", 5, 333, 128)
    check_layer(torch, cg, "H=128 T=1 all-ones", 1, 37, 128, mask_mode="ones")
    check_sequence_layers(torch, cg)

    log("== 4. times (CUDA events)")
    t_flag = time_shape(torch, cg, FLAGSHIP, card)
    time_shape(torch, cg, BENCH, card)
    compare_forwards(torch, cg, FLAGSHIP, card)
    compare_forwards(torch, cg, BENCH, card)

    log("== 5. main path: train_mpe, flagship rMAPPO simple_spread")
    check_small_against_cpu(torch)
    fwd_n, bwd_n = train_main_path(torch, cg)

    src = "onpolicy_torch/csrc/gru_seq.cu"
    kernels = []
    for d, name, line, n, err in (("fwd", "gru_seq_fwd", 122, fwd_n, f_err),
                                  ("bwd", "gru_seq_bwd", 219, bwd_n, b_err)):
        tc = "tc" if t_flag[f"{d}_variant"] == "tensor_core" else "f32"
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"onpolicy_tpu/ops/pallas_gru.py:{line}",
            "variant": t_flag[f"{d}_variant"],
            "launches": n, "max_abs_err": err,
            "ms": t_flag[f"{d}_ms"], "device_ms": t_flag[f"{d}_device_ms"],
            "plain_ms": t_flag[f"{d}_plain_ms"],
            "bound_ms": t_flag[f"{d}_bound_{tc}_ms"],
            "bound_by": t_flag[f"{d}_bound_{tc}_by"],
            "bound_f32_ms": t_flag[f"{d}_bound_f32_ms"],
            "bound_f32_by": t_flag[f"{d}_bound_f32_by"],
            "library_ms": t_flag[f"{d}_library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
