"""Device ms an iteration in the program's `rollout.gather` spans, by
CUDA events: the rollout's rows of every rank gathered into the whole
episode (`BaseRunner._gather_episode`, one all-reduce a dtype). Rank
0's card."""
from portbench.metrics import _program


def read(ctx):
    return _program.device_ms(ctx, "rollout.gather")
