"""Profiling hooks.

Port of `onpolicy_tpu/utils/profiling.py`: a `torch.profiler` trace of
the host and, for a run on the card, the device around a chosen stretch
of training (a Chrome trace, viewable in Perfetto or chrome://tracing),
and a phase timer whose results can flow into the metrics rows.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(profile_dir, enabled: bool = True, device="cpu"):
    """Write a `torch.profiler` trace of the with-block to
    `<profile_dir>/trace.json`; the card's kernels are traced too when
    `device` is a CUDA device, whose queued work ends the block."""
    if not enabled or not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    d = Path(profile_dir)
    d.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(d / "trace.json"))


class PhaseTimer:
    """Accumulates wall-clock per named phase; `summary()` returns
    {phase: seconds} and resets."""

    def __init__(self):
        self._acc = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0

    def summary(self, reset: bool = True) -> dict:
        out = {f"time/{k}": round(v, 4) for k, v in self._acc.items()}
        if reset:
            self._acc.clear()
        return out
