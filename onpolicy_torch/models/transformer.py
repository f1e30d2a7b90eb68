"""Multi-Agent Transformer (MAT) networks.

Port of `onpolicy_tpu/models/transformer.py` (the reference's
`ma_transformer.py` + `transformer_act.py`). Attention runs over the
AGENT axis (L = n_agent):

  Encoder: obs LayerNorm→Linear→GELU embed → LN → n_block blocks of
    [x = LN(x + attn(x)); x = LN(x + mlp(x))] → value head and per-agent
    representation;
  Decoder: shifted one-hot previous-agent actions embedded (bias-free
    Linear(A+1)) → n_block blocks of
    [x = LN(x + masked-attn(x)); x = LN(rep + masked-attn(q=rep, kv=x));
     x = LN(x + mlp(x))] with causal (lower-triangular) agent masking →
    per-agent logits;
  dec_actor variant (mat_dec): plain per-agent (or shared) MLPs over obs.

GELU is the exact erf form (`F.gelu`'s default), as torch's nn.GELU in the
reference; the JAX package fixed a tanh-approximation bug here. Parameters
are nested dicts with the JAX package's names and `[in, out]` weights, so
its trees carry across leaf for leaf (`utils/params.py`). Init:
orthogonal, gain 0.01 on projections, relu gain on pre-GELU layers, zero
bias.

Decoding: `autoregressive_act` loops over the agents (rollout; each
agent's one-hot, or for Box actions its continuous action, feeds the next
slot), `parallel_act` teacher-forces the shifted actions in one decoder
pass (training). While `torch.profiler` records, the agent loop is the
device span `act.decode` (`utils/profiling.py`; the draws inside it) and
every decoder pass adds 1 to the counter `mat_decode_passes`. Attention is plain PyTorch, as the JAX package computes
it in plain jnp.

Box actions (JAX `transformer.py:136, 287-294, 340`): the decoder gives
per-agent means, its `log_std` starts at ones and the std is
σ(log_std)·0.5; the act embedding is a biased Linear(A); log-probs and
entropies are kept per action dimension [B, M, A], as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from onpolicy_torch.models import common as cm
from onpolicy_torch.ops import distributions as D
from onpolicy_torch.utils import profiling

GAIN = 0.01

LOG_2PI = math.log(2.0 * math.pi)


def _lin(din, dout, generator, device, activate=False, bias=True):
    gain = cm.calculate_gain("relu") if activate else GAIN
    p = cm.linear_init(din, dout, gain=gain, use_orthogonal=True,
                       generator=generator, device=device)
    return p if bias else {"w": p["w"]}


def _lin_apply(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


# ---- attention ------------------------------------------------------

def attn_init(n_embd, generator, device):
    return {k: _lin(n_embd, n_embd, generator, device)
            for k in ("key", "query", "value", "proj")}


def attn_apply(p, k_in, v_in, q_in, n_head: int, masked: bool):
    """k/v/q: [B, L, D] → [B, L, D]; optional causal agent mask."""
    B, L, Dm = q_in.shape
    hs = Dm // n_head
    split = lambda x: x.reshape(B, L, n_head, hs).transpose(1, 2)
    k = split(_lin_apply(p["key"], k_in))
    q = split(_lin_apply(p["query"], q_in))
    v = split(_lin_apply(p["value"], v_in))
    att = (q @ k.transpose(-2, -1)) / math.sqrt(hs)
    if masked:
        causal = torch.ones(L, L, dtype=torch.bool, device=att.device).tril()
        att = att.masked_fill(~causal, float("-inf"))
    att = torch.softmax(att, -1)
    y = (att @ v).transpose(1, 2).reshape(B, L, Dm)
    return _lin_apply(p["proj"], y)


def _mlp_block_init(n_embd, generator, device):
    return {"fc1": _lin(n_embd, n_embd, generator, device, activate=True),
            "fc2": _lin(n_embd, n_embd, generator, device)}


def _mlp_block_apply(p, x):
    return _lin_apply(p["fc2"], F.gelu(_lin_apply(p["fc1"], x)))


# ---- encoder --------------------------------------------------------

def encoder_init(obs_dim, n_block, n_embd, generator, device):
    ln = lambda d: cm.layer_norm_init(d, device)
    lin = lambda *a, **k: _lin(*a, generator=generator, device=device, **k)
    return {
        "obs_ln": ln(obs_dim),
        "obs_embed": lin(obs_dim, n_embd, activate=True),
        "ln": ln(n_embd),
        "blocks": [{"ln1": ln(n_embd), "ln2": ln(n_embd),
                    "attn": attn_init(n_embd, generator, device),
                    "mlp": _mlp_block_init(n_embd, generator, device)}
                   for _ in range(n_block)],
        "head1": lin(n_embd, n_embd, activate=True),
        "head_ln": ln(n_embd),
        "head2": lin(n_embd, 1),
    }


def encoder_apply(p, obs, n_head):
    """obs [B, M, Do] → (v_loc [B, M, 1], rep [B, M, D])."""
    x = F.gelu(_lin_apply(p["obs_embed"], cm.layer_norm_apply(p["obs_ln"],
                                                              obs)))
    x = cm.layer_norm_apply(p["ln"], x)
    for blk in p["blocks"]:
        x = cm.layer_norm_apply(
            blk["ln1"], x + attn_apply(blk["attn"], x, x, x, n_head, False))
        x = cm.layer_norm_apply(blk["ln2"], x + _mlp_block_apply(blk["mlp"], x))
    h = F.gelu(_lin_apply(p["head1"], x))
    v = _lin_apply(p["head2"], cm.layer_norm_apply(p["head_ln"], h))
    return v, x


# ---- decoder --------------------------------------------------------

def decoder_init(obs_dim, action_dim, n_block, n_embd, n_agent, generator,
                 device, action_type="Discrete", dec_actor=False,
                 share_actor=False):
    ln = lambda d: cm.layer_norm_init(d, device)
    lin = lambda *a, **k: _lin(*a, generator=generator, device=device, **k)
    discrete = action_type == "Discrete"
    p = {} if discrete else {"log_std": torch.ones(action_dim, device=device)}
    if dec_actor:
        def actor_mlp():
            return {"ln0": ln(obs_dim),
                    "fc1": lin(obs_dim, n_embd, activate=True),
                    "ln1": ln(n_embd),
                    "fc2": lin(n_embd, n_embd, activate=True),
                    "ln2": ln(n_embd),
                    "out": lin(n_embd, action_dim)}
        if share_actor:
            return {**p, "mlp": actor_mlp()}
        return {**p, "mlps": [actor_mlp() for _ in range(n_agent)]}
    return {
        **p,
        "act_embed": lin(action_dim + 1 if discrete else action_dim, n_embd,
                         activate=True, bias=not discrete),
        "obs_ln": ln(obs_dim),
        "obs_embed": lin(obs_dim, n_embd, activate=True),
        "ln": ln(n_embd),
        "blocks": [{"ln1": ln(n_embd), "ln2": ln(n_embd), "ln3": ln(n_embd),
                    "attn1": attn_init(n_embd, generator, device),
                    "attn2": attn_init(n_embd, generator, device),
                    "mlp": _mlp_block_init(n_embd, generator, device)}
                   for _ in range(n_block)],
        "head1": lin(n_embd, n_embd, activate=True),
        "head_ln": ln(n_embd),
        "head2": lin(n_embd, action_dim),
    }


def decoder_apply(p, shifted_action, obs_rep, obs, n_head,
                  dec_actor=False, share_actor=False):
    """→ per-agent logits (Box: means) [B, M, A]."""
    if dec_actor:
        mlps = [p["mlp"]] * obs.shape[1] if share_actor else p["mlps"]
        outs = []
        for i, mp in enumerate(mlps):
            h = cm.layer_norm_apply(mp["ln0"], obs[:, i])
            h = cm.layer_norm_apply(mp["ln1"], F.gelu(_lin_apply(mp["fc1"], h)))
            h = cm.layer_norm_apply(mp["ln2"], F.gelu(_lin_apply(mp["fc2"], h)))
            outs.append(_lin_apply(mp["out"], h))
        return torch.stack(outs, 1)
    x = F.gelu(_lin_apply(p["act_embed"], shifted_action))
    x = cm.layer_norm_apply(p["ln"], x)
    for blk in p["blocks"]:
        x = cm.layer_norm_apply(
            blk["ln1"], x + attn_apply(blk["attn1"], x, x, x, n_head, True))
        x = cm.layer_norm_apply(
            blk["ln2"],
            obs_rep + attn_apply(blk["attn2"], x, x, obs_rep, n_head, True))
        x = cm.layer_norm_apply(blk["ln3"], x + _mlp_block_apply(blk["mlp"], x))
    h = F.gelu(_lin_apply(p["head1"], x))
    return _lin_apply(p["head2"], cm.layer_norm_apply(p["head_ln"], h))


# ---- full model -----------------------------------------------------

class MATConfig:
    def __init__(self, n_agent, action_dim, n_block, n_embd, n_head,
                 action_type="Discrete", dec_actor=False, share_actor=False,
                 encode_state=False):
        self.n_agent = n_agent
        self.action_dim = action_dim
        self.n_block = n_block
        self.n_embd = n_embd
        self.n_head = n_head
        self.action_type = action_type
        self.dec_actor = dec_actor
        self.share_actor = share_actor
        self.encode_state = encode_state


def mat_init(mcfg: MATConfig, obs_dim, generator: torch.Generator, device,
             encoder_dim=None):
    """Parameters drawn from `generator` (a CPU generator), then moved to
    `device`. encoder_dim: the encoder's input width — obs_dim normally,
    the centralized-state width under encode_state."""
    return {
        "encoder": encoder_init(encoder_dim or obs_dim, mcfg.n_block,
                                mcfg.n_embd, generator, device),
        "decoder": decoder_init(obs_dim, mcfg.action_dim, mcfg.n_block,
                                mcfg.n_embd, mcfg.n_agent, generator, device,
                                mcfg.action_type, mcfg.dec_actor,
                                mcfg.share_actor),
    }


def _decode(mcfg, params, shifted, obs_rep, obs):
    profiling.count("mat_decode_passes")
    return decoder_apply(params["decoder"], shifted, obs_rep, obs,
                         mcfg.n_head, mcfg.dec_actor, mcfg.share_actor)


def autoregressive_act(mcfg: MATConfig, params, obs,
                       generator: Optional[torch.Generator],
                       available_actions=None, deterministic=False,
                       enc_in=None, actions=None, noise=None):
    """Rollout decode, one agent after another (`discrete_autoregreesive_
    act` / `continuous_autoregreesive_act`): agent i's action (its one-hot,
    or the continuous action) fills decoder slot i+1 before agent i+1
    decodes. → (actions, logp, values [B,M,1]): Discrete actions and logp
    [B,M,1], Box both [B,M,A]. `enc_in` overrides the encoder input (the
    centralized state under encode_state). Given `actions` (drawn
    elsewhere, e.g. by a test), agent i takes `actions[:, i]` instead of a
    draw; for Box, `noise` [B,M,A] gives the standard normal draws."""
    B, M, _ = obs.shape
    A = mcfg.action_dim
    discrete = mcfg.action_type == "Discrete"
    v_loc, obs_rep = encoder_apply(
        params["encoder"], enc_in if enc_in is not None else obs, mcfg.n_head)
    shifted = torch.zeros(B, M, A + 1 if discrete else A, device=obs.device)
    if discrete:
        shifted[:, 0, 0] = 1.0
    else:
        std = torch.sigmoid(params["decoder"]["log_std"]) * 0.5
    acts, lps = [], []
    with profiling.span("act.decode", device=True):
        for i in range(M):
            out = _decode(mcfg, params, shifted, obs_rep, obs)[:, i]
            if discrete:
                dist = D.Categorical.create(
                    out, None if available_actions is None
                    else available_actions[:, i])
                if actions is not None:
                    a = actions[:, i].long()
                else:
                    a = dist.mode() if deterministic \
                        else dist.sample(generator)
                lps.append(dist.log_prob(a))
                slot = F.one_hot(a[:, 0], A).float()
            else:
                if actions is not None:
                    a = actions[:, i]
                elif deterministic:
                    a = out
                else:
                    dist = D.DiagGaussian(out, std.log().expand_as(out))
                    a = dist.sample(generator,
                                    None if noise is None else noise[:, i])
                lps.append(_box_log_prob(a, out, std))
                slot = a
            acts.append(a.float())
            if i + 1 < M:
                shifted = shifted.clone()
                shifted[:, i + 1, 1 if discrete else 0:] = slot
    return torch.stack(acts, 1), torch.stack(lps, 1), v_loc


def _box_log_prob(a, mean, std):
    """Per-dimension gaussian log-density (the reference keeps it per
    dimension, `transformer_act.py:59-62`)."""
    return -0.5 * (((a - mean) / std).square() + LOG_2PI + 2.0 * std.log())


def parallel_act(mcfg: MATConfig, params, obs, actions,
                 available_actions=None, enc_in=None):
    """Training decode: teacher-forced one pass (`discrete_parallel_act` /
    `continuous_parallel_act`). → (logp, values [B,M,1], entropy):
    Discrete logp and entropy [B,M,1], Box [B,M,A]."""
    B, M, _ = obs.shape
    A = mcfg.action_dim
    v_loc, obs_rep = encoder_apply(
        params["encoder"], enc_in if enc_in is not None else obs, mcfg.n_head)
    if mcfg.action_type != "Discrete":
        shifted = torch.zeros(B, M, A, device=obs.device)
        shifted[:, 1:] = actions[:, :-1]
        mean = _decode(mcfg, params, shifted, obs_rep, obs)
        std = torch.sigmoid(params["decoder"]["log_std"]) * 0.5
        ent = (0.5 + 0.5 * LOG_2PI + std.log()).expand_as(mean)
        return _box_log_prob(actions, mean, std), v_loc, ent
    onehot = F.one_hot(actions[..., 0].long(), A).float()
    shifted = torch.zeros(B, M, A + 1, device=obs.device)
    shifted[:, 0, 0] = 1.0
    shifted[:, 1:, 1:] = onehot[:, :-1]
    logits = _decode(mcfg, params, shifted, obs_rep, obs)
    dist = D.Categorical.create(logits, available_actions)
    return dist.log_prob(actions[..., :1]), v_loc, dist.entropy()[..., None]


def get_values(mcfg: MATConfig, params, obs):
    v_loc, _ = encoder_apply(params["encoder"], obs, mcfg.n_head)
    return v_loc
