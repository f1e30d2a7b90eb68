"""Work counted from a configuration's shapes, whatever implements it:
the model FLOPs of a training iteration and the least time of the GRU
sequence kernels.

`gru_bounds` is a frozen copy of the port's roofline arithmetic for the
GRU (`chip_smoke.bounds`): bytes over the HBM rate against 6·H²·B·T
operations forward and three times that backward, in TF32 passes over
the dense TF32 peak.
"""
from __future__ import annotations

# one H100 SXM at 700 W (NVIDIA's data sheet, dense)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12


def net_macs(in_dim: int, out_dim: int, hp: dict) -> int:
    """Multiply-adds of one row through the MLP base, the GRU and the
    head (LayerNorms and gate arithmetic not counted)."""
    H = hp["hidden_size"]
    mlp = in_dim * H + hp["layer_N"] * H * H
    gru = hp["recurrent_N"] * 2 * 3 * H * H
    return mlp + gru + H * out_dim


def iteration_flops(hp: dict, dims: dict) -> float:
    """The actor's and the critic's forward passes over every rollout row,
    and forward and backward (3x) over every row of every PPO epoch."""
    actor = net_macs(dims["obs_dim"], dims["n_actions"], hp)
    critic = net_macs(dims["share_dim"], 1, hp)
    rollout = 2.0 * (actor * dims["actor_rows"] + critic * dims["critic_rows"])
    update = 6.0 * (actor + critic) * dims["train_rows"] * hp["ppo_epoch"]
    return rollout + update


def gru_calls(hp: dict, dims: dict) -> tuple:
    """(forward calls an iteration, T, B, H) of the sequence GRU in the
    update: 2 nets x recurrent_N x ppo_epoch x num_mini_batch, each at
    T = data_chunk_length over B = windows / num_mini_batch."""
    L, nmb = hp["data_chunk_length"], hp["num_mini_batch"]
    calls = 2 * hp["recurrent_N"] * hp["ppo_epoch"] * nmb
    return calls, L, dims["train_rows"] // L // nmb, hp["hidden_size"]


def gru_bounds(T, B, H, itemsize=4):
    """Least times in ms, with what bounds them: {"fwd", "fwd_tc",
    "bwd_f32", "bwd_tc"} -> (ms, "bytes" | "operations")."""
    seq, st, w = T * B * H * itemsize, B * H * 4, (3 * H * H + 3 * H) * 4
    m, hprev = T * B * 4, T * B * H * itemsize
    fwd_bytes = 3 * seq + m + st + w + seq + st
    bwd_bytes = 3 * seq + hprev + seq + m + st + w + 3 * seq + st + w
    fwd_flops = 6.0 * H * H * B * T
    bwd_passes = 7 if itemsize == 2 else 9
    out = {}
    for key, nbytes, ops_s in (
            ("fwd", fwd_bytes, fwd_flops / F32_FLOP_S),
            ("fwd_tc", fwd_bytes, 3 * fwd_flops / TF32_FLOP_S),
            ("bwd_f32", bwd_bytes, 3 * fwd_flops / F32_FLOP_S),
            ("bwd_tc", bwd_bytes, bwd_passes * fwd_flops / TF32_FLOP_S)):
        tb, tf = nbytes / HBM_BYTES_S * 1e3, ops_s * 1e3
        out[key] = (max(tb, tf), "bytes" if tb >= tf else "operations")
    return out
