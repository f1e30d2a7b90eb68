"""Device idle ms an iteration whose gaps fall inside `rollout.env`: the
card waits while the host dispatches or runs the environment step."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.idle_in(ctx, "rollout.env")
