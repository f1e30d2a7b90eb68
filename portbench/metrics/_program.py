"""Readings of the program's spans and counters that are None where the
program under test does not record the span or the counter at all (a
commit older than the span), where `_spans` would read 0.0."""
from portbench.metrics import _spans


def _log(ctx):
    got = _spans._per_iteration(ctx)
    return None if got is None else got[0]


def device_ms(ctx, name):
    """`_spans.device_ms`, or None where no span `name` was timed on the
    card."""
    log = _log(ctx)
    if log is None or not any(s.name == name and s.device_ms is not None
                              for s in log["spans"]):
        return None
    return _spans.device_ms(ctx, name)


def counter(ctx, name):
    """`_spans.counter`, or None where the counter was never added to."""
    log = _log(ctx)
    if log is None or name not in log["counters"]:
        return None
    return _spans.counter(ctx, name)


def idle_in(ctx, name):
    """`_spans.idle_in` for span `name`, or None where it was not
    entered."""
    log = _log(ctx)
    if log is None or not any(s.name == name for s in log["spans"]):
        return None
    return _spans.idle_in(ctx, name)
