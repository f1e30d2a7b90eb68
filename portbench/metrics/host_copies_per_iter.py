"""The program's `host_copies` counter an iteration: each `.cpu()` of a
device tensor and each upload of host arrays in the runners' rollout."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.counter(ctx, "host_copies")
