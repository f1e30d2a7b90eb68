"""Device idle ms an iteration whose gaps fall inside `rollout.copy`: the
card waits on the host seat loop's copies."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.idle_in(ctx, "rollout.copy")
