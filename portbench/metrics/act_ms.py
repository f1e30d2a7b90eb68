"""Host ms an iteration in the program's `rollout.act` spans: the policy's
act (MPE: actor and critic each step; Hanabi: the actor each seat, the
deferred critic each round)."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "rollout.act")
