"""MAT's model FLOPs of the unprofiled iterations (`flops_mat.
iteration_flops`, from the configuration's shapes) over their elapsed
time x the dense TF32 peak of one H100 SXM (495 TFLOP/s), the peak `mfu`
uses."""
from portbench import flops, flops_mat


def read(ctx):
    hp = {**ctx["config"]["model"], **ctx["config"]["ppo"]}
    work = flops_mat.iteration_flops(hp, ctx["dims"]) * ctx["iterations"]
    return 100.0 * work / (ctx["elapsed_s"] * flops.TF32_FLOP_S)
