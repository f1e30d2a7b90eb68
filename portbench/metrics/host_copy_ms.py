"""Host ms an iteration in the program's `rollout.copy` spans: the host
seat loop's copies of the actions to the host (the wait on the card
included) and of the engine's outputs to the card."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "rollout.copy")
