"""Device idle ms an iteration in every other gap: inside the buffer
writes, the returns, the update's spans or no program span. With
act_idle_ms, env_idle_ms and copy_idle_ms it partitions the profiled
iterations' idle time."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.idle_in(ctx, None)
