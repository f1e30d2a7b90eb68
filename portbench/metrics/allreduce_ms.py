"""Device ms an iteration in the program's `update.allreduce` spans, by
CUDA events: the gradients' and loss terms' all-reduce over the ranks,
every minibatch of every epoch (`distributed.sum_over_ranks`). Rank 0's
card."""
from portbench.metrics import _program


def read(ctx):
    return _program.device_ms(ctx, "update.allreduce")
