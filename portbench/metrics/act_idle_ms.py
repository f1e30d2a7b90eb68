"""Device idle ms an iteration whose gaps fall inside `rollout.act`: the
card waits while the host dispatches the policy's act."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.idle_in(ctx, "rollout.act")
