"""The run of one cell: set-up, the measured window, the traced run, the
comparison that decides `correct`, and the result line.

Everything that belongs to one configuration, traffic mix, runner
family, launcher or metric is found by name:
  configs/<config>.json    the flags, the numbers the reference reads,
                           the precision and the limits of `correct`
  traffic/<traffic>.json   threads or fleets, engine flags, iterations
                           warmed up, checked and profiled, the family
                           and the launcher
  drivers/<family>.py      `Driver`: builds the program's runner with the
                           benchmark's weights, runs one iteration
  reference/check_<family>.py   `check`: the plain reference's comparison
  launchers/<launcher>.py  `launch`: how the run's processes start
  metrics/<metric>.py      `read(ctx)`: one metric, or None
The last line of standard output is {"correct", "attempted", "failed",
"metrics", "device"[, "breakdown"], "compared"}; the compared numbers
and their limits are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
# no module of these top-level names may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "onpolicy_tpu")
SPANS = ("rollout", "update")


class RunError(Exception):
    """A run that cannot give a result: no card, a forbidden import."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} present")


def card_info() -> dict:
    """The card's name and the power limit `nvidia-smi` reads."""
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        limit = []
    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "none")
    return {"kind": kind, "power_limit": limit[0] if limit else "unknown"}


class Cell:
    """A workload of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, root: Path, name: str):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise RunError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.bench, self.workload = name, bench, cells[name]
        self.config = load_json(HERE / "configs"
                                / f"{self.workload['config']}.json")
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.workload['traffic']}.json")
        if self.config["family"] != self.traffic["family"]:
            raise RunError(f"{name}: configuration family "
                           f"{self.config['family']} != traffic family "
                           f"{self.traffic['family']}")
        self.family = self.config["family"]

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports in a run: end to end with
        --trace 0, per layer with --trace 1."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


# ---- timing ---------------------------------------------------------
def sync(device: str) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class PhaseClock:
    """Phase totals by the host clock with the card drained at each end,
    so a phase holds its own device work."""

    def __init__(self, device: str):
        self.ms, self.device = {}, device

    @contextlib.contextmanager
    def phase(self, name):
        sync(self.device)
        t = time.perf_counter()
        yield
        sync(self.device)
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3


@contextlib.contextmanager
def span(name):
    with torch.profiler.record_function(name):
        yield


def window(driver, seconds: float, device: str, phase=None):
    """Iterations until `seconds` have passed on the host clock, then the
    card drained. -> (iterations, elapsed s, per-iteration metrics, the
    host clock after each iteration's call returned)."""
    start = time.perf_counter()
    n, metrics, ends = 0, [], []
    while True:
        m = driver.iterate(phase)
        metrics.append(torch.stack([m[k].float() for k in
                                    ("policy_loss", "value_loss",
                                     "dist_entropy")]))
        n += 1
        ends.append(time.perf_counter() - start)
        if ends[-1] >= seconds:
            break
    sync(device)
    return n, time.perf_counter() - start, metrics, ends


def _events(prof) -> list:
    """(name, device?, user annotation?, start us, end us) of every event
    the profiler kept, read from its raw list (building the event tree
    for ~1M host events takes minutes)."""
    return [(e.name(), str(e.device_type()).endswith("CUDA"),
             bool(getattr(e, "is_user_annotation", lambda: False)()),
             e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def traced(driver, profiled: int, device: str) -> dict:
    """`profiled` iterations under torch.profiler, the harness's calls
    into the runner in `rollout` / `update` spans."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            driver.iterate(span)
        sync(device)
        wall = time.perf_counter() - t0
    events = _events(prof)
    # device operations (kernels, copies, sets), without the spans'
    # annotations on the device's timeline
    ops = [(n, s, e) for n, dev, ann, s, e in events
           if dev and not ann and n not in SPANS]
    spans = [(n, s, e) for n, dev, ann, s, e in events
             if not dev and n in SPANS]
    busy = union((s, e) for _, s, e in ops)
    busy_us = sum(e - s for s, e in busy)
    gaps = []
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        label = next((n for n, a, b in spans if a <= mid <= b), "between")
        gaps.append((label, (s1 - e0) / 1e6))
    by_name, idle = {}, {}
    for n, s, e in ops:
        by_name[n[:160]] = by_name.get(n[:160], 0.0) + (e - s) / 1e6
    for label, s in gaps:
        idle[label] = idle.get(label, 0.0) + s
    return {"ops": ops, "busy_s": busy_us / 1e6, "window_s": wall,
            "profiled": profiled, "idle_by_span": idle,
            "device_ops": sorted(by_name.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda x: -x[1])[:10]}


# ---- one run ----------------------------------------------------------
def measure(cell: Cell, seed: int, seconds: float, trace: bool,
            start: float, device: str = "cuda") -> dict:
    """Set-up, the window (and with `trace` the profiled iterations), then
    the comparison. -> the pieces of the result line."""
    config, traffic = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = config["precision"]["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = config["precision"]["allow_tf32"]
    family = importlib.import_module(f"portbench.drivers.{cell.family}")
    imported = time.perf_counter()
    driver = family.Driver(config, traffic, seed, device)
    capture = driver.checked_iterations(traffic["checked_iterations"])
    for _ in range(traffic["warmup_iterations"]
                   - traffic["checked_iterations"]):
        driver.iterate()
    sync(device)
    ctx = {"config": config, "traffic": traffic, "dims": driver.dims(),
           "steps_per_iteration": driver.steps_per_iteration,
           "setup_s": time.perf_counter() - start,
           "imports_s": imported - start}
    clock = PhaseClock(device) if trace else None
    launches0 = driver.launch_counters()
    n, elapsed, losses, ends = window(driver, seconds, device,
                                      clock.phase if clock else None)
    ctx.update(iterations=n, elapsed_s=elapsed, iteration_ends=ends,
               phase_ms={k: v / n for k, v in (clock.ms if clock else
                                               {}).items()})
    if trace:
        ctx["launches_window"] = {
            k: (v - launches0[k]) / n
            for k, v in driver.launch_counters().items()}
        t = time.perf_counter()
        ctx["trace"] = traced(driver, traffic["profiled_iterations"], device)
        ctx["trace_s"] = time.perf_counter() - t
    ctx["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if str(device).startswith("cuda") else 0)
    finite = torch.isfinite(torch.stack(losses)).all(1)
    ctx["failed"] = int((~finite).sum())
    found = forbidden_modules()
    if found:
        raise RunError(f"forbidden modules loaded: {found}")
    driver.close()
    del driver
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    checker = importlib.import_module(f"portbench.reference.check_{cell.family}")
    t = time.perf_counter()
    ctx["readings"] = checker.check(capture, config, device)
    ctx["check_s"] = time.perf_counter() - t
    return ctx


def judge(readings: dict, limits: dict) -> dict:
    """Each compared number beside its limit."""
    return {k: {"value": readings[k], "limit": lim}
            for k, lim in limits.items()}


def metric_values(cell: Cell, ctx: dict, trace: bool) -> dict:
    out = {}
    for m in cell.metrics(trace):
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            if not math.isfinite(value):
                raise RunError(f"{m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, ctx: dict, trace: bool) -> dict:
    compared = judge(ctx["readings"], cell.config["limits"])
    correct = ctx["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    card = card_info()
    device = {"platform": "gpu", "kind": card["kind"],
              "count": cell.workload["chips"],
              "memory_peak_bytes": ctx["memory_peak_bytes"],
              "power_limit": card["power_limit"]}
    line = {"correct": correct, "attempted": ctx["iterations"],
            "failed": ctx["failed"],
            "metrics": metric_values(cell, ctx, trace), "device": device}
    if trace:
        tr = ctx["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                             "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    line["compared"] = compared
    return line


def main(argv, start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(root, args.workload)
        require_cards(cell.workload["chips"])
        launcher = importlib.import_module(
            f"portbench.launchers.{cell.traffic['launcher']}")
        ctx = launcher.launch(measure, cell, args.seed, args.seconds,
                              bool(args.trace), start)
        line = result_line(cell, ctx, bool(args.trace))
        found = forbidden_modules()
        if found:
            raise RunError(f"forbidden modules loaded: {found}")
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 3
    report(ctx, line)
    print(json.dumps(line), flush=True)
    return 0


def halves(ends: list) -> float:
    """The window's second half's iteration rate over its first's."""
    h = len(ends) // 2
    if h < 2:
        return float("nan")
    first = h / ends[h - 1]
    second = (len(ends) - h) / (ends[-1] - ends[h - 1])
    return second / first


def report(ctx: dict, line: dict) -> None:
    """The earlier lines: device, set-up, spread and cross-checks; then,
    last on standard error, each compared number beside its limit."""
    err = lambda s: print(s, file=sys.stderr, flush=True)
    d = line["device"]
    err(f"device: {d['kind']} x{d['count']}, power limit {d['power_limit']}")
    err(f"setup_s {ctx['setup_s']:.3f} (imports and CUDA init "
        f"{ctx['imports_s']:.3f}), window {ctx['elapsed_s']:.3f} s, "
        f"{ctx['iterations']} iterations, check {ctx['check_s']:.1f} s")
    ends = ctx["iteration_ends"]
    each = sorted(b - a for a, b in zip([0.0] + ends, ends))
    if len(each) >= 4:
        q = statistics.quantiles(each, n=4)
        err(f"iteration s (host clock, as each call returned): min "
            f"{each[0]:.4f} quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f} "
            f"max {each[-1]:.4f}; halves' rates {halves(ends):.4f}")
    if ctx.get("phase_ms"):
        err("phase ms an iteration: " + json.dumps(ctx["phase_ms"]))
    if ctx.get("trace"):
        err(f"profiled iterations and their reading: {ctx['trace_s']:.1f} s")
        err("idle s between device operations, by span: "
            + json.dumps(ctx["trace"]["idle_by_span"]))
    if ctx.get("launches_window"):
        err("GRU launch counters an iteration: "
            + json.dumps(ctx["launches_window"]))
    r = ctx["readings"]
    err("reading notes: " + json.dumps(
        {k: v for k, v in r.items() if k not in line["compared"]}))
    for k, c in line["compared"].items():
        err(f"compared {k} {c['value']!r} limit {c['limit']!r}")
