"""Work counted from MAT's shapes, whatever implements it: the model FLOPs
of a training iteration (`mat_mfu`) and the least time of the rollout's
autoregressive decode (`mat_decode_roofline`).

A token is one agent slot of one env. Its multiply-adds through a block
are every linear layer's and the attention's scores and weighted sums
over the slots it sees: all M in the encoder, slots 0..i for slot i in
the decoder's two causal attentions. LayerNorms, GELUs, softmaxes and
the draws' arithmetic are not counted. The decoder is counted once a
slot: the program's act decodes all M slots in each of its M passes, but
an incremental decode (each slot's keys and values kept) computes each
slot once, so the least time stays a bound whatever implements it.

`decode_bound` follows `flops.gru_bounds`' `fwd_tc`: the larger of the
bytes over the HBM rate and 3 x the operations over the dense TF32 peak
(three TF32 passes make an f32-exact product).
"""
from __future__ import annotations

from portbench.flops import HBM_BYTES_S, TF32_FLOP_S


def attention_macs(D: int, keys: int) -> int:
    """Key, query, value and projection, then scores and weighted sum
    over `keys` slots."""
    return 4 * D * D + 2 * keys * D


def encoder_macs(hp: dict, obs_dim: int, M: int) -> int:
    D = hp["n_embd"]
    block = attention_macs(D, M) + 2 * D * D
    return obs_dim * D + hp["n_block"] * block + D * D + D


def decoder_macs(hp: dict, A: int, slot: int) -> int:
    """Slot `slot` (from 0) through the decoder: the action embedding,
    n_block blocks of two causal attentions and an MLP, the head."""
    D = hp["n_embd"]
    block = 2 * attention_macs(D, slot + 1) + 2 * D * D
    return (A + 1) * D + hp["n_block"] * block + D * D + D * A


def decoder_params(hp: dict, A: int) -> int:
    """The decoder's parameters that the decode reads: the action
    embedding (no bias) and its LayerNorm, n_block blocks of two
    attentions (4 linear layers each), an MLP (2) and 3 LayerNorms, and the
    head (2 linear layers and a LayerNorm)."""
    D = hp["n_embd"]
    linear = lambda i, o: i * o + o
    block = 8 * linear(D, D) + 2 * linear(D, D) + 3 * 2 * D
    return ((A + 1) * D + 2 * D + hp["n_block"] * block + linear(D, D)
            + 2 * D + linear(D, A))


def step_decoder_macs(hp: dict, A: int, M: int) -> int:
    """One env's M slots through the decoder, each once."""
    return sum(decoder_macs(hp, A, i) for i in range(M))


def iteration_flops(hp: dict, dims: dict) -> float:
    """The rollout's encoder over T + 1 steps (the acts and the
    bootstrap value) and decoder over T steps, and 3x (forward and
    backward) the encoder and decoder over every token of every PPO
    epoch."""
    T, N = dims["episode_length"], dims["n_rollout_threads"]
    M, A = dims["num_agents"], dims["n_actions"]
    enc = encoder_macs(hp, dims["obs_dim"], M) * M
    dec = step_decoder_macs(hp, A, M)
    rollout = (T + 1) * N * enc + T * N * dec
    update = 3 * (enc + dec) * T * N * hp["ppo_epoch"]
    return 2.0 * (rollout + update)


def decode_bound(hp: dict, dims: dict) -> tuple:
    """The least ms of one iteration's `act.decode` spans (T steps, each
    decoding M slots of N envs and drawing M actions), with what bounds
    it: "bytes" or "operations". Bytes a step: the encoder's
    representation read once, the decoder's weights, one uniform draw
    read and the action (int64) and its log-probability written a
    slot."""
    T, N = dims["episode_length"], dims["n_rollout_threads"]
    M, A, D = dims["num_agents"], dims["n_actions"], hp["n_embd"]
    flops = 2.0 * T * N * step_decoder_macs(hp, A, M)
    nbytes = T * (N * M * D * 4 + decoder_params(hp, A) * 4
                  + N * M * (4 + 8 + 4))
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = 3 * flops / TF32_FLOP_S * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"
