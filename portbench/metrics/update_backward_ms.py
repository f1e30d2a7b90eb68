"""Device ms an iteration in the program's `update.backward` spans, by CUDA
events: autograd's backward of the PPO loss, every minibatch of every
epoch."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "update.backward")
