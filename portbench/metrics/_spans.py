"""The program's own spans and counters over the profiled iterations
(`onpolicy_torch/utils/profiling.py`: `span`, `count`, `take`), read
once a run and kept in `ctx`.

Every reading is per profiled iteration: a total over the profiled
iterations divided by `ctx["trace"]["profiled"]`. It is None without a
traced run or where the program keeps no such log, and 0.0 where the
profiled iterations entered no span (or counter) of the name. A span
counts once where it lies inside another of its own name.

Idle time is the gaps between consecutive intervals of the union of the
device operations (`ctx["trace"]["ops"]`, microseconds on the profiler's
clock, which the spans share); each gap goes to the innermost program
span open at its midpoint, the rule `core.traced` uses for its labels.
"""
from __future__ import annotations

import bisect

from portbench.core import union

# the idle metrics' spans; every other gap is `other_idle_ms`'s
IDLE_SPANS = ("rollout.act", "rollout.env", "rollout.copy")


def program_log(ctx):
    """{"spans", "counters"} of the profiled iterations, taken from the
    program once a run; None where the program has no such log."""
    if "program_log" not in ctx:
        from onpolicy_torch.utils import profiling
        take = getattr(profiling, "take", None)
        ctx["program_log"] = take() if take is not None else None
    return ctx["program_log"]


def _per_iteration(ctx):
    """(the log, the profiled iterations), or None."""
    if not ctx.get("trace"):
        return None
    log = program_log(ctx)
    return None if log is None else (log, ctx["trace"]["profiled"])


def _outermost(spans, name):
    """The spans called `name` with no ancestor of the same name."""
    out = []
    for s in spans:
        if s.name != name:
            continue
        p = s.parent
        while p >= 0 and spans[p].name != name:
            p = spans[p].parent
        if p < 0:
            out.append(s)
    return out


def host_ms(ctx, name):
    got = _per_iteration(ctx)
    if got is None:
        return None
    (log, n) = got
    return sum(s.t1_ns - s.t0_ns
               for s in _outermost(log["spans"], name)) / 1e6 / n


def device_ms(ctx, name):
    """The card's ms between the CUDA events at a device span's ends."""
    got = _per_iteration(ctx)
    if got is None:
        return None
    (log, n) = got
    return sum(s.device_ms or 0.0
               for s in _outermost(log["spans"], name)) / n


def counter(ctx, name):
    got = _per_iteration(ctx)
    if got is None:
        return None
    (log, n) = got
    return log["counters"].get(name, 0) / n


def innermost(spans):
    """(times in us, names): names[i] is the innermost span open from
    times[i] to times[i + 1], None where none is. Spans nest, so when one
    closes its parent is the innermost again."""
    events = []
    for i, s in enumerate(spans):
        # at one instant: closes first, inner ones first; then opens,
        # outer ones first
        events.append((s.t1_ns, 0, -i, s.parent))
        events.append((s.t0_ns, 1, i, i))
    events.sort()
    times, names = [float("-inf")], [None]
    for t, _, _, now in events:
        times.append(t / 1e3)
        names.append(spans[now].name if now >= 0 else None)
    return times, names


def idle_ms(ctx):
    """{innermost span name or None: idle ms an iteration}, cached."""
    got = _per_iteration(ctx)
    if got is None:
        return None
    (log, n) = got
    if "program_idle_ms" not in ctx:
        times, names = innermost(log["spans"])
        busy = union((s, e) for _, s, e in ctx["trace"]["ops"])
        idle = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            label = names[bisect.bisect_right(times, 0.5 * (e0 + s1)) - 1]
            idle[label] = idle.get(label, 0.0) + (s1 - e0) / 1e3 / n
        ctx["program_idle_ms"] = idle
    return ctx["program_idle_ms"]


def idle_in(ctx, name):
    """Idle ms an iteration whose innermost span is `name`; `name` None:
    every gap that is not in one of IDLE_SPANS."""
    idle = idle_ms(ctx)
    if idle is None:
        return None
    if name is None:
        return sum((v for k, v in idle.items() if k not in IDLE_SPANS), 0.0)
    return idle.get(name, 0.0)
