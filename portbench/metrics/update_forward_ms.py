"""Device ms an iteration in the program's `update.forward` spans, by CUDA
events: the value normalizer's update and the PPO loss's forward, every
minibatch of every epoch."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "update.forward")
