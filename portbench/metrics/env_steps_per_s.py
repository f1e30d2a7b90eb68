"""All env-steps of the iterations completed in the window over the time
from the window's start to the synchronize after its last iteration."""


def read(ctx):
    return ctx["iterations"] * ctx["steps_per_iteration"] / ctx["elapsed_s"]
