"""100 x (1 - the union of device-operation intervals an iteration in the
profiled iterations / the mean wall time of the same run's unprofiled
iterations)."""


def read(ctx):
    tr = ctx["trace"]
    if tr["busy_s"] <= 0:
        return None
    per_iter = ctx["elapsed_s"] / ctx["iterations"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["profiled"] / per_iter)
