"""Device ms an iteration in the program's `act.decode` spans, by CUDA
events: MAT's autoregressive decode in the rollout (M decoder passes and
M draws a step, `models/transformer.autoregressive_act`)."""
from portbench.metrics import _program


def read(ctx):
    return _program.device_ms(ctx, "act.decode")
