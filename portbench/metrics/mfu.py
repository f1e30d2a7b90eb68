"""The model FLOPs of the unprofiled iterations (portbench/flops.py,
from the configuration's shapes) over their elapsed time x the dense TF32
peak of one H100 SXM (495 TFLOP/s)."""
from portbench import flops


def read(ctx):
    hp = {**ctx["config"]["model"], **ctx["config"]["ppo"]}
    work = flops.iteration_flops(hp, ctx["dims"]) * ctx["iterations"]
    return 100.0 * work / (ctx["elapsed_s"] * flops.TF32_FLOP_S)
