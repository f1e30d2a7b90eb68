"""Device operations (kernels, copies, sets) an iteration in the profiled
iterations."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr["ops"]) / tr["profiled"] if tr["ops"] else None
