"""MAT's rollout decode's share of its roofline: the least time of the
work the `act.decode` spans of an iteration hold (`flops_mat.
decode_bound`: each slot through the decoder once, and the draws) over
their device ms."""
from portbench import flops_mat
from portbench.metrics import _program


def read(ctx):
    ms = _program.device_ms(ctx, "act.decode")
    if not ms:
        return None
    hp = {**ctx["config"]["model"], **ctx["config"]["ppo"]}
    return 100.0 * flops_mat.decode_bound(hp, ctx["dims"])[0] / ms
