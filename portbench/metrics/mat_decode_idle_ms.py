"""Device idle ms an iteration whose gaps fall inside `act.decode`: the
card waits while the host dispatches MAT's decode. `act.decode` nests in
`rollout.act`, so these gaps are not `act_idle_ms`'s; `other_idle_ms`
holds them."""
from portbench.metrics import _program


def read(ctx):
    return _program.idle_in(ctx, "act.decode")
