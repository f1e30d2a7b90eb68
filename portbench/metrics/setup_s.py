"""Process start to the window's start: imports, CUDA init, the GRU
library, the runner's init, the benchmark's weights and the warm-up
iterations (the checked ones among them)."""


def read(ctx):
    return ctx["setup_s"]
