"""Where one training episode spends its time on the card.

    python -m onpolicy_torch.scripts.profile_episode \
        [--config flagship|bench_mappo|bench_rmappo|reference|comm|
                  happo_spread|mpe_mat|mpe_mat_dec|hatrpo_spread|world_comm|
                  hanabi_device|bench_hanabi_width|hanabi_forward|
                  smac_3s5z|smacv2_protoss_5v5|smacv2_happo|football_3v1] \
        [--episodes 3] [--warmup 2]

Runs one of `train_mpe.CONFIGS` (through the shared or the separated
runner, as the configuration says) or one of `train_hanabi.CONFIGS` on
the card: e.g. the flagship simple_spread rMAPPO (128 rollout threads,
T=25, L=10, 10 PPO epochs, hidden 64; the default), the JAX package's
bench MAPPO (feed-forward, critic dedup) or bench rMAPPO at 16,384
rollout threads in bf16, train_mpe_mat.sh (MAT, 128 threads, n_embd 64:
its rollout decodes the M=3 agents one after another), HATRPO on
simple_spread (separated runner, one TRPO step an agent), the flagship's
flags on simple_world_comm (6 agents through the separated runner),
train_hanabi_device.sh (rMAPPO, Hanabi-Full, hidden 512x2, 1000 fleets,
T=100, 15 PPO epochs), the JAX package's Hanabi bench configuration
(the same in feed-forward MAPPO, bf16), or train_hanabi_forward.sh
(feed-forward MAPPO in f32 on the C++ engine through the host seat loop),
or one of `train_smac.CONFIGS` / `train_football.CONFIGS` through the
host runners (`runner/host_runner.py`, `host_separated_runner.py`) over
the worker-process pool (train_smac_3s5z.sh: rMAPPO, 8 threads, T=400;
train_football_3v1.sh: rMAPPO, 50 threads, T=200, 2 minibatches). Those
need the `smac` / `smacv2` / `gfootball` packages in the process, or
engine stand-ins in their place in `sys.modules` (`chip_smoke.py` installs
its own and calls `main` on smac_3s5z and football_3v1).
Prints one JSON object:
  * host wall time per episode, split into rollout (T env steps, or T
    Hanabi seat rounds, with the policy's acts, and GAE; on the C++
    engine or a host pool the engine's steps and the copies to and from
    the host) and update
    (ppo_epoch PPO steps, or the separated runner's agent-by-agent
    update; for Hanabi the deferred update on the previous episode), each
    phase ended by `torch.cuda.synchronize()`;
  * from `torch.profiler` over one more episode: the device's busy time
    (sum of kernel times; one stream, so kernels do not overlap), its idle
    share of the unprofiled episode time, kernel launches per episode
    (host-to-device copies among them, counted apart), the GRU kernels'
    share, and the kernels that take the most device time;
  * the card's name and power limit.
Refuses to run without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

from onpolicy_torch.scripts import train_football, train_hanabi, train_smac
from onpolicy_torch.scripts.train_mpe import CONFIGS

# the GRU kernels: every forward kernel (gru_fwd_kernel, its _mma twin,
# the wide variant's step kernel gru_fwd_wide_step) and every backward
# kernel (gru_bwd_kernel, its _mma twin, the wide variant's gates GEMM,
# carry and dW GEMM, the reduction)
GRU_KERNELS = ("gru_fwd_", "gru_bwd_")


def _device_time_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def _is_kernel(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


class _CardTimer:
    """Host ms per named phase, each phase starting and ending with the
    card's queue drained, so it holds its own device work."""

    def __init__(self):
        self._ms = {}

    @contextlib.contextmanager
    def phase(self, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self._ms[name] = (self._ms.get(name, 0.0)
                          + (time.perf_counter() - t0) * 1e3)

    def milliseconds(self, name) -> float:
        return self._ms.get(name, 0.0)


class _NoTimer:
    """Phases that are not timed."""

    @staticmethod
    def phase(name):
        return contextlib.nullcontext()


def _shared_episodes(config):
    """(cfg, one episode (timer) -> None) for a `train_mpe.CONFIGS` run."""
    from onpolicy_torch.config import config_from_args
    from onpolicy_torch.runner.shared_runner import SharedRunner
    cfg = config_from_args(CONFIGS[config] + ["--device", "cuda"])
    runner = SharedRunner(cfg)
    box = list(runner.init())

    def episode(timer):
        state, carry = box
        with timer.phase("rollout"):
            carry, buf = runner.rollout(state, carry)
        with timer.phase("update"):
            state, _ = runner.algo.train(state, buf, runner.generator)
        box[:] = state, carry
    return cfg, episode


def _separated_episodes(config):
    """(cfg, one episode (timer) -> None) for a separated-policy
    `train_mpe.CONFIGS` run (HAPPO, HATRPO, comm)."""
    from onpolicy_torch.config import config_from_args
    from onpolicy_torch.runner.separated_runner import SeparatedRunner
    cfg = config_from_args(CONFIGS[config] + ["--device", "cuda"])
    runner = SeparatedRunner(cfg)
    box = list(runner.init())

    def episode(timer):
        states, carry = box
        with timer.phase("rollout"):
            carry, bufs = runner.rollout(states, carry)
        with timer.phase("update"):
            states, _ = runner.update(states, bufs)
        box[:] = states, carry
    return cfg, episode


def _hanabi_episodes(config):
    """(cfg, one episode (timer) -> None) for a `train_hanabi.CONFIGS` run;
    the first episode only collects, every later one trains first."""
    from onpolicy_torch.runner.hanabi_runner import HanabiRunner
    cfg = train_hanabi.config_from_args(train_hanabi.CONFIGS[config]
                                        + ["--device", "cuda"])
    runner = HanabiRunner(cfg)
    box = [*runner.init(), False]

    def episode(timer):
        state, carry, dbuf, trained = box
        state, carry, dbuf, _ = runner.episode(state, carry, dbuf,
                                               do_train=trained, timer=timer)
        box[:] = state, carry, dbuf, True
    return cfg, episode


def _host_episodes(config):
    """(cfg, one episode (timer) -> None) for a `train_smac.CONFIGS` or
    `train_football.CONFIGS` run over the worker-process pool; the
    episode's `close` ends the pool."""
    from onpolicy_torch.envs.host_vec import DummyVecEnv, HostVecEnv
    from onpolicy_torch.runner.host_runner import HostSharedRunner
    from onpolicy_torch.runner.host_separated_runner import \
        HostSeparatedRunner
    smac = config in train_smac.CONFIGS
    module = train_smac if smac else train_football
    ns, cfg = module.config_from_args(module.CONFIGS[config]
                                      + ["--device", "cuda"])
    fns = (train_smac.make_env_fns(ns, cfg, cfg.n_rollout_threads, cfg.seed)
           if smac else train_football.make_env_fns(ns, cfg))
    Pool = DummyVecEnv if cfg.n_rollout_threads == 1 else HostVecEnv
    pool = Pool(fns, protocol="share" if smac else "basic")
    Runner = HostSeparatedRunner if cfg.algorithm_name in (
        "happo", "hatrpo") else HostSharedRunner
    runner = Runner(cfg, pool)
    box = list(runner.init())

    def episode(timer):
        state, start = box
        with timer.phase("rollout"):
            start, buf, _ = runner.rollout(state, start)
        with timer.phase("update"):
            state, _ = runner.update(state, buf)
        box[:] = state, start
    episode.close = pool.close
    return cfg, episode


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    from onpolicy_torch.config import config_from_args
    host = sorted(train_smac.CONFIGS) + sorted(train_football.CONFIGS)
    ap.add_argument("--config", choices=sorted(CONFIGS)
                    + sorted(train_hanabi.CONFIGS) + host,
                    default="flagship")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_episode: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.config in host:
        make = _host_episodes
    elif args.config in train_hanabi.CONFIGS:
        make = _hanabi_episodes
    elif config_from_args(CONFIGS[args.config]
                          + ["--device", "cpu"]).share_policy:
        make = _shared_episodes
    else:
        make = _separated_episodes
    cfg, episode = make(args.config)
    try:
        for _ in range(args.warmup):
            episode(_NoTimer)
        torch.cuda.synchronize()

        rollout_ms, update_ms = [], []
        for _ in range(args.episodes):
            timer = _CardTimer()
            episode(timer)
            rollout_ms.append(timer.milliseconds("rollout"))
            update_ms.append(timer.milliseconds("update"))

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            episode(_NoTimer)
            torch.cuda.synchronize()
    finally:
        getattr(episode, "close", lambda: None)()
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    busy_us = sum(_device_time_us(e) for e in kernels)
    episode_ms = (sum(rollout_ms) + sum(update_ms)) / args.episodes
    top = sorted(kernels, key=_device_time_us, reverse=True)[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {
        "config": args.config,
        "card": card,
        "env_steps_per_episode": cfg.episode_length * cfg.n_rollout_threads,
        "rollout_ms": rollout_ms, "update_ms": update_ms,
        "episode_ms": episode_ms,
        "env_steps_per_s": cfg.episode_length * cfg.n_rollout_threads
        / (episode_ms / 1e3),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / episode_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "h2d_copies": sum(e.count for e in kernels if "HtoD" in e.key),
        "gru_kernels_ms": sum(_device_time_us(e) for e in kernels
                              if any(k in e.key for k in GRU_KERNELS)) / 1e3,
        "gru_kernel_launches": sum(e.count for e in kernels
                                   if any(k in e.key for k in GRU_KERNELS)),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms": _device_time_us(e) / 1e3} for e in top],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
