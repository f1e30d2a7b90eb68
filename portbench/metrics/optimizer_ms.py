"""Device ms an iteration in the program's `update.optimizer` spans, by
CUDA events: the two gradient norms, the clip and both Adam steps, every
minibatch of every epoch."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "update.optimizer")
