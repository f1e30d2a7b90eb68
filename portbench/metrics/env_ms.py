"""Host ms an iteration in the program's `rollout.env` spans: the
environment step (MPE's vectorized worlds; Hanabi's device engine step,
masked reset and observation, or the C++ engine's step and reset)."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "rollout.env")
