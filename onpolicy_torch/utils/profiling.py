"""Profiling hooks: the `--profile_dir` trace, and the program's spans and
counters.

`trace` writes a `torch.profiler` trace of the host and, for a run on the
card, the device around a chosen stretch of training (a Chrome trace,
viewable in Perfetto or chrome://tracing).

`span(name)` marks a layer of the program (the runners' act, env step,
host copies, buffer writes and the episode's gather over ranks; MAT's
autoregressive decode; the update's minibatch gather, forward, backward,
all-reduce and optimizer) and `count(name, n)` adds to a named
counter. Both do something only while `torch.profiler` records; else a
span is one flag test and a shared no-op context. While it records, a
span opens a `record_function` of its name, which the profiler's timeline
shows, and appends `(name, parent, t0_ns, t1_ns)` to an in-memory log,
its times from `time.time_ns()`: the clock of the profiler's own events
(`start_ns()`), so the program's spans and the device's operations share
one timeline. The parent is the index of the innermost span open when it
began (-1: none). A span made with `device=True` also records a CUDA
event at each end on the current stream, and `take()` turns each pair
into the device ms between them. `take()` returns the log and clears it;
`trace` clears it as its block ends.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Span(NamedTuple):
    name: str
    parent: int          # index in the log of the enclosing span, or -1
    t0_ns: int           # time.time_ns() at entry and at exit
    t1_ns: int
    device_ms: Optional[float]   # CUDA-event ms of a device span, else None


class _Log:
    """What the spans and counters have recorded since the last `take`."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.spans = []      # [name, parent, t0_ns, t1_ns, events or None]
        self.open = []       # indices of the spans open, innermost last
        self.counters = {}


_LOG = _Log()


class _Off:
    """The span of a run that is not profiled: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "index", "annotation")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        events = None
        if self.device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.index = len(_LOG.spans)
        parent = _LOG.open[-1] if _LOG.open else -1
        _LOG.spans.append([self.name, parent, time.time_ns(), None, events])
        _LOG.open.append(self.index)
        return self

    def __exit__(self, *exc):
        record = _LOG.spans[self.index]
        record[3] = time.time_ns()
        if record[4] is not None:
            record[4][1].record()
        _LOG.open.pop()
        return self.annotation.__exit__(*exc)


def span(name: str, device: bool = False):
    """A context that marks `name` while the profiler records (see the
    module's docstring); `device`: also time it on the card's stream."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while the profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _LOG.counters[name] = _LOG.counters.get(name, 0) + n


def take() -> dict:
    """The spans and counters recorded since the last call, cleared:
    {"spans": [Span, ...] in the order they began, "counters": {name: n}}.
    Call it with no span open. Waits for the card where a device span
    recorded events."""
    if any(s[4] is not None for s in _LOG.spans):
        torch.cuda.synchronize()
    out = {"spans": [Span(name, parent, t0, t1,
                          None if ev is None else ev[0].elapsed_time(ev[1]))
                     for name, parent, t0, t1, ev in _LOG.spans],
           "counters": dict(_LOG.counters)}
    _LOG.clear()
    return out


@contextlib.contextmanager
def trace(profile_dir, enabled: bool = True, device="cpu"):
    """Write a `torch.profiler` trace of the with-block to
    `<profile_dir>/trace.json`; the card's kernels are traced too when
    `device` is a CUDA device, whose queued work ends the block. The
    program's spans show in it; their log is cleared as the block ends."""
    if not enabled or not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    try:
        with profile(activities=activities) as prof:
            yield
            if on_card:
                torch.cuda.synchronize(device)
    finally:
        _LOG.clear()
    d = Path(profile_dir)
    d.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(d / "trace.json"))
