"""CPU tests of the metrics that read the program's spans and counters
(`portbench/metrics/_spans.py`) on synthetic device operations and
program spans.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""
import bisect
import importlib
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from onpolicy_torch.utils.profiling import Span  # noqa: E402
from portbench import core  # noqa: E402
from portbench.metrics import _spans  # noqa: E402

IDLE = ("act_idle_ms", "env_idle_ms", "copy_idle_ms", "other_idle_ms")
US = 1000      # ns in a microsecond


def read(name, ctx):
    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def span(name, parent, t0_us, t1_us, device_ms=None):
    return Span(name, parent, t0_us * US, t1_us * US, device_ms)


def ctx_of(ops, spans, counters=None, profiled=2):
    return {"trace": {"ops": [("k", s, e) for s, e in ops],
                      "profiled": profiled},
            "program_log": {"spans": spans, "counters": counters or {}}}


# a "rollout" from 0 to 100 us holding act 0-30 (with a store 10-20
# inside it), env 40-70 and copy 70-90; device operations leave gaps
# 5-15 (mid 10: act, whose store opens at 10), 25-45 (mid 35: in no
# span), 50-60 (env), 80-88 (copy) and 95-99 (mid 97: rollout)
SPANS = [span("rollout", -1, 0, 100), span("rollout.act", 0, 0, 30),
         span("rollout.store", 1, 10, 20), span("rollout.env", 0, 40, 70),
         span("rollout.copy", 0, 70, 90)]
OPS = [(0, 5), (15, 25), (45, 50), (60, 80), (88, 95), (99, 100)]


def test_a_gap_goes_to_the_innermost_span_open_at_its_midpoint():
    times, names = _spans.innermost(SPANS)
    at = lambda us: names[bisect.bisect_right(times, us) - 1]
    assert [at(t) for t in (-1, 5, 10, 15, 25, 35, 50, 75, 95, 101)] == [
        None, "rollout.act", "rollout.store", "rollout.store",
        "rollout.act", "rollout", "rollout.env", "rollout.copy",
        "rollout", None]
    ctx = ctx_of(OPS, SPANS)
    # per iteration of 2, in ms
    assert _spans.idle_ms(ctx) == pytest.approx(
        {"rollout.store": 10 / 2e3, "rollout": (20 + 4) / 2e3,
         "rollout.env": 10 / 2e3, "rollout.copy": 8 / 2e3})
    assert read("act_idle_ms", ctx) == 0.0      # its gap is the store's
    assert read("env_idle_ms", ctx) == pytest.approx(10 / 2e3)
    assert read("copy_idle_ms", ctx) == pytest.approx(8 / 2e3)
    assert read("other_idle_ms", ctx) == pytest.approx(34 / 2e3)


def test_the_four_idle_metrics_sum_to_the_unions_gaps():
    ops = [(0, 3), (2, 7), (12, 20), (31, 33), (33, 40), (55, 58),
           (71, 72), (86, 87), (91, 100)]
    spans = [span("rollout.act", -1, 5, 14), span("rollout.env", -1, 14, 60),
             span("update.forward", -1, 60, 80),
             span("rollout.copy", -1, 80, 95)]
    ctx = ctx_of(ops, spans, profiled=1)
    busy = core.union(ops)
    gaps = sum(s1 - e0 for (_, e0), (s1, _) in zip(busy, busy[1:])) / 1e3
    parts = [read(n, ctx) for n in IDLE]
    assert all(p > 0 for p in parts)
    assert math.isclose(sum(parts), gaps, rel_tol=1e-12)


def test_an_empty_log_reads_zero_and_no_trace_reads_none():
    ctx = ctx_of(OPS, [])
    names = IDLE + ("act_ms", "env_ms", "host_copy_ms",
                    "host_copies_per_iter", "update_forward_ms",
                    "update_backward_ms", "optimizer_ms")
    values = {n: read(n, ctx) for n in names}
    busy = core.union(OPS)
    gaps = sum(s1 - e0 for (_, e0), (s1, _) in zip(busy, busy[1:]))
    assert values.pop("other_idle_ms") == pytest.approx(gaps / 2e3)
    assert values == {n: 0.0 for n in values}
    for n in names:
        assert read(n, {"program_log": {"spans": [], "counters": {}}}) \
            is None
        assert read(n, {"trace": None}) is None


def test_a_program_without_the_log_reads_none(monkeypatch):
    from onpolicy_torch.utils import profiling
    monkeypatch.delattr(profiling, "take")
    ctx = {"trace": {"ops": [("k", 0, 1)], "profiled": 1}}
    assert read("act_ms", ctx) is None and read("env_idle_ms", ctx) is None
    assert ctx["program_log"] is None


def test_host_ms_device_ms_and_counters_per_iteration():
    spans = [span("update", -1, 0, 1000),
             span("update.forward", 0, 0, 300, device_ms=4.0),
             span("update.backward", 0, 300, 700, device_ms=9.0),
             span("update.optimizer", 0, 700, 900, device_ms=1.5),
             span("update.forward", 0, 900, 950, device_ms=2.0),
             # a span inside one of its own name counts once
             span("rollout.act", -1, 1000, 1400),
             span("rollout.act", 5, 1100, 1200),
             span("rollout.env", -1, 1400, 2400)]
    ctx = ctx_of([(0, 1)], spans, {"host_copies": 600}, profiled=4)
    assert read("update_forward_ms", ctx) == pytest.approx(6.0 / 4)
    assert read("update_backward_ms", ctx) == pytest.approx(9.0 / 4)
    assert read("optimizer_ms", ctx) == pytest.approx(1.5 / 4)
    assert read("act_ms", ctx) == pytest.approx(0.4 / 4)
    assert read("env_ms", ctx) == pytest.approx(1.0 / 4)
    assert read("host_copy_ms", ctx) == 0.0
    assert read("host_copies_per_iter", ctx) == 150.0


def test_the_log_is_taken_once_a_run():
    from onpolicy_torch.utils import profiling
    import torch
    profiling.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("rollout.env"):
            pass
        profiling.count("host_copies", 3)
    ctx = {"trace": {"ops": [], "profiled": 1}}
    assert read("host_copies_per_iter", ctx) == 3.0
    assert read("env_ms", ctx) > 0.0
    assert read("host_copies_per_iter", ctx) == 3.0     # kept in ctx
    assert profiling.take() == {"spans": [], "counters": {}}
