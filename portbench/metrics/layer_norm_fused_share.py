"""The share, in %, of the card's LayerNorm forwards and backwards an
iteration that ran on the fused kernels: 100 x the program's
`layer_norm_fused` counter (+1 a forward or backward on
`ops/cuda_layer_norm.py`'s kernels) over it plus `layer_norm_plain` (+1 a
LayerNorm the card ran in plain ops); 0 where the profiled iterations ran
none. None where the program has no fused LayerNorm (a commit older than
it)."""
import importlib.util

from portbench.metrics import _spans


def read(ctx):
    if importlib.util.find_spec("onpolicy_torch.ops.cuda_layer_norm") is None:
        return None
    fused = _spans.counter(ctx, "layer_norm_fused")
    plain = _spans.counter(ctx, "layer_norm_plain")
    if fused is None:
        return None
    return 100.0 * fused / (fused + plain) if fused + plain else 0.0
