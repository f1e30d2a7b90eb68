"""The sequence GRU's forward kernels' share of their TF32 roofline."""
from pathlib import Path

from portbench.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, str(Path(__file__).with_suffix(".json")))
