"""torch.cuda.max_memory_allocated() over the run, before the check."""


def read(ctx):
    return ctx["memory_peak_bytes"] / 2 ** 30
