"""The program's `env_graph_replays` counter an iteration: each replay of
the device engine's captured step or reset chain (`torch_fleet._Graphs`).
0 where the environments run op by op or on the host."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.counter(ctx, "env_graph_replays")
