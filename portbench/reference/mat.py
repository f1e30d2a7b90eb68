"""Plain MAT, the Multi-Agent Transformer, in float32: the encoder and the
decoder over the agent axis, the autoregressive act with the served
actions injected, the teacher-forced pass, and MAT's PPO update (one
joint loss, one clipped Adam over the whole model).

Written from the published implementation's semantics (Wen et al.,
"Multi-Agent Reinforcement Learning is a Sequence Modeling Problem",
NeurIPS 2022; marlbenchmark on-policy, `onpolicy/algorithms/mat/`:
`algorithm/ma_transformer.py`, `utils/transformer_act.py`,
`mat_trainer.py`), with no kernel, no cache and no batching tricks. It
imports nothing of the program under test. Its matrix products run with
TF32 off unless a caller turns it on (the control, `side.precision`).

Encoder: x = GELU(LN(obs) @ W + b); x = LN(x); n_block blocks of
[x = LN(x + attn(x)); x = LN(x + mlp(x))]; value = head(x), rep = x.
Decoder: x = LN(GELU(shifted @ W)) (bias-free); n_block blocks of
[x = LN(x + attn(x, causal)); x = LN(rep + attn(q=rep, k=v=x, causal));
x = LN(x + mlp(x))]; logits = head(x). attn: per head softmax(q k^T /
sqrt(d_head)) v through a projection; mlp: Linear, GELU, Linear; head:
Linear, GELU, LN, Linear. GELU is the exact erf form (torch's nn.GELU).

Departures from the published code, each without effect on the numbers
compared:
  * Parameters are a flat dict of named tensors whose names are the
    program's tree paths, linear weights stored [in, out] and applied as
    x @ w + b (nn.Linear stores [out, in]).
  * Discrete actions only, the configuration's encoder input (obs, not
    the state: `encode_state` false) and the transformer decoder
    (`dec_actor` false). The encoder's state embedding, unused then, is
    not held; the decoder's obs embedding, built but unused by the
    published decoder, is held and gets no gradient.
  * The act takes the actions the program served instead of drawing:
    log-probabilities are compared, not samples.
  * ValueNorm, GAE and Adam are `ppo.py`'s: torch.optim.Adam's bias
    correction, after `clip_grad_norm_` over the whole gradient.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import ppo

# The benchmark's weights: uniform with the variance gain^2 / fan_in (the
# orthogonal init's scale), gain sqrt(2) before a GELU as the published
# init, and 1 on every other linear layer where the published init puts
# 0.01. At 0.01 the attention's and the decoder's conditioning reach the
# outputs at about 1e-4 of their size, under which a decoder that ignores
# its causal mask hides in rounding.
GELU_GAIN = math.sqrt(2.0)
PLAIN_GAIN = 1.0


# ---- parameter shapes ------------------------------------------------------
def _linear(s, name, din, dout, gain, bias=True):
    s[f"{name}.w"] = ((din, dout), "weight", gain)
    if bias:
        s[f"{name}.b"] = ((dout,), "zero", 0.0)


def _norm(s, name, d):
    s[f"{name}.scale"] = ((d,), "one", 0.0)
    s[f"{name}.bias"] = ((d,), "zero", 0.0)


def _attention(s, name, d):
    for k in ("key", "query", "value", "proj"):
        _linear(s, f"{name}.{k}", d, d, PLAIN_GAIN)


def _mlp(s, name, d):
    _linear(s, f"{name}.fc1", d, d, GELU_GAIN)
    _linear(s, f"{name}.fc2", d, d, PLAIN_GAIN)


def mat_shapes(hp, obs_dim: int, n_actions: int) -> dict:
    """Name -> (shape, kind, gain) of the whole model, in the program's
    tree names and order."""
    D = hp["n_embd"]
    s = {}
    _norm(s, "encoder.obs_ln", obs_dim)
    _linear(s, "encoder.obs_embed", obs_dim, D, GELU_GAIN)
    _norm(s, "encoder.ln", D)
    for i in range(hp["n_block"]):
        b = f"encoder.blocks.{i}"
        _norm(s, f"{b}.ln1", D)
        _norm(s, f"{b}.ln2", D)
        _attention(s, f"{b}.attn", D)
        _mlp(s, f"{b}.mlp", D)
    _linear(s, "encoder.head1", D, D, GELU_GAIN)
    _norm(s, "encoder.head_ln", D)
    _linear(s, "encoder.head2", D, 1, PLAIN_GAIN)
    _linear(s, "decoder.act_embed", n_actions + 1, D, GELU_GAIN, bias=False)
    _norm(s, "decoder.obs_ln", obs_dim)
    _linear(s, "decoder.obs_embed", obs_dim, D, GELU_GAIN)
    _norm(s, "decoder.ln", D)
    for i in range(hp["n_block"]):
        b = f"decoder.blocks.{i}"
        for k in ("ln1", "ln2", "ln3"):
            _norm(s, f"{b}.{k}", D)
        _attention(s, f"{b}.attn1", D)
        _attention(s, f"{b}.attn2", D)
        _mlp(s, f"{b}.mlp", D)
    _linear(s, "decoder.head1", D, D, GELU_GAIN)
    _norm(s, "decoder.head_ln", D)
    _linear(s, "decoder.head2", D, n_actions, PLAIN_GAIN)
    return s


def make_params(hp, obs_dim: int, n_actions: int, generator, device) -> dict:
    """The benchmark's weights from `generator`, drawn in one call."""
    return ppo.make_params(mat_shapes(hp, obs_dim, n_actions), generator,
                           device)


# ---- the networks ------------------------------------------------------------
def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def linear(p, name, x):
    y = x @ p[f"{name}.w"]
    return y + p[f"{name}.b"] if f"{name}.b" in p else y


def norm(p, name, x):
    return ppo.layer_norm(x, p[f"{name}.scale"], p[f"{name}.bias"])


def attention(p, name, kv, q, n_head: int, causal: bool):
    """kv, q [B, L, D] -> [B, L, D]; with `causal` slot i sees slots <= i."""
    B, L, D = q.shape
    hs = D // n_head
    heads = lambda x: x.reshape(B, L, n_head, hs).transpose(1, 2)
    k = heads(linear(p, f"{name}.key", kv))
    v = heads(linear(p, f"{name}.value", kv))
    qh = heads(linear(p, f"{name}.query", q))
    att = (qh @ k.transpose(-2, -1)) * (1.0 / math.sqrt(hs))
    if causal:
        seen = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        att = att.masked_fill(~seen, float("-inf"))
    y = (torch.softmax(att, -1) @ v).transpose(1, 2).reshape(B, L, D)
    return linear(p, f"{name}.proj", y)


def mlp(p, name, x):
    return linear(p, f"{name}.fc2", gelu(linear(p, f"{name}.fc1", x)))


def head(p, name, x):
    h = norm(p, f"{name}.head_ln", gelu(linear(p, f"{name}.head1", x)))
    return linear(p, f"{name}.head2", h)


def encoder(p, hp, obs):
    """obs [B, M, obs_dim] -> (value [B, M, 1], rep [B, M, D])."""
    x = gelu(linear(p, "encoder.obs_embed", norm(p, "encoder.obs_ln", obs)))
    x = norm(p, "encoder.ln", x)
    for i in range(hp["n_block"]):
        b = f"encoder.blocks.{i}"
        x = norm(p, f"{b}.ln1",
                 x + attention(p, f"{b}.attn", x, x, hp["n_head"], False))
        x = norm(p, f"{b}.ln2", x + mlp(p, f"{b}.mlp", x))
    return head(p, "encoder", x), x


def decoder(p, hp, shifted, rep):
    """shifted [B, M, A + 1] (slot 0 the start token, slot i the one-hot
    of agent i-1's action), rep [B, M, D] -> logits [B, M, A]."""
    x = norm(p, "decoder.ln", gelu(linear(p, "decoder.act_embed", shifted)))
    for i in range(hp["n_block"]):
        b = f"decoder.blocks.{i}"
        x = norm(p, f"{b}.ln1",
                 x + attention(p, f"{b}.attn1", x, x, hp["n_head"], True))
        x = norm(p, f"{b}.ln2",
                 rep + attention(p, f"{b}.attn2", x, rep, hp["n_head"], True))
        x = norm(p, f"{b}.ln3", x + mlp(p, f"{b}.mlp", x))
    return head(p, "decoder", x)


def shifted_actions(actions, n_actions: int):
    """actions [B, M, 1] -> the teacher-forced decoder input [B, M, A + 1]."""
    B, M = actions.shape[:2]
    out = torch.zeros(B, M, n_actions + 1, device=actions.device)
    out[:, 0, 0] = 1.0
    out[:, 1:, 1:] = torch.nn.functional.one_hot(
        actions[:, :-1, 0].long(), n_actions).float()
    return out


def log_softmax(logits, avail=None):
    return torch.log_softmax(ppo.masked_logits(logits, avail), -1)


def act(p, hp, obs, actions, n_actions: int, avail=None):
    """The rollout's act with the served actions in place of the draws:
    one decoder pass over all M slots an agent, agent i's one-hot filling
    slot i + 1 before agent i + 1 decodes. -> (log-prob of each action
    [B, M, 1], value [B, M, 1])."""
    B, M = obs.shape[:2]
    value, rep = encoder(p, hp, obs)
    shifted = torch.zeros(B, M, n_actions + 1, device=obs.device)
    shifted[:, 0, 0] = 1.0
    logps = []
    for i in range(M):
        logits = decoder(p, hp, shifted, rep)[:, i]
        a = actions[:, i].long()
        logps.append(log_softmax(
            logits, None if avail is None else avail[:, i]).gather(-1, a))
        if i + 1 < M:
            shifted = shifted.clone()
            shifted[:, i + 1, 1:] = torch.nn.functional.one_hot(
                a[:, 0], n_actions).float()
    return torch.stack(logps, 1), value


def evaluate(p, hp, obs, actions, n_actions: int, avail=None):
    """The training pass: one teacher-forced decoder pass. -> (log-prob
    [B, M, 1], value [B, M, 1], entropy [B, M, 1])."""
    value, rep = encoder(p, hp, obs)
    logsm = log_softmax(decoder(p, hp, shifted_actions(actions, n_actions),
                                rep), avail)
    probs = logsm.exp()
    ent = -torch.where(probs > 0, probs * logsm,
                       torch.zeros_like(logsm)).sum(-1, keepdim=True)
    return logsm.gather(-1, actions.long()), value, ent


# ---- the update --------------------------------------------------------------
def mat_update(hp, params, opt, vn, batch, n_actions: int, on_step=None):
    """ppo_epoch x one minibatch of the T·N env steps, the agent axis kept
    whole (`mat_trainer.train`). `batch` holds [T, N, M, ...] fields obs,
    actions, old_logp, value_preds, returns, advantages, active, avail (or
    None). `on_step(k, params, opt)` is called after the k-th Adam step
    (from 1). -> (params, opt, vn, per-update losses [ppo_epoch] as a
    dict)."""
    if hp["num_mini_batch"] != 1:
        raise ValueError("the reference update takes one minibatch")
    T, N, M = batch["actions"].shape[:3]
    flat = lambda x: None if x is None else x.reshape(T * N, M,
                                                      *x.shape[3:])
    w = flat(batch["active"])
    adv = flat(batch["advantages"])
    n = w.sum().clamp_min(1e-8)
    mean = (adv * w).sum() / n
    std = torch.sqrt(((adv - mean).square() * w).sum() / n)
    adv = (adv - mean) / (std + 1e-5)
    obs, actions = flat(batch["obs"]), flat(batch["actions"])
    old_logp, old_v = flat(batch["old_logp"]), flat(batch["value_preds"])
    returns, avail = flat(batch["returns"]), flat(batch["avail"])
    clip = hp["clip_param"]
    wsum = w.sum().clamp_min(1e-8)
    losses = {"policy_loss": [], "value_loss": [], "dist_entropy": []}
    for _ in range(hp["ppo_epoch"]):
        vn = ppo.vnorm_update(vn, returns.reshape(-1))
        vmean, vstd = ppo.vnorm_stats(vn)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            logp, v, ent = evaluate(p, hp, obs, actions, n_actions, avail)
            entropy = (ent * w).sum() / wsum
            ratio = torch.exp(logp - old_logp)
            surr = torch.minimum(ratio * adv,
                                 ratio.clamp(1 - clip, 1 + clip) * adv)
            pol = -(surr * w).sum() / wsum
            v_clip = old_v + (v - old_v).clamp(-clip, clip)
            target = (returns - vmean) / vstd
            e1 = ppo.huber(target - v, hp["huber_delta"])
            e2 = ppo.huber(target - v_clip, hp["huber_delta"])
            vloss = (torch.maximum(e1, e2) * w).sum() / wsum
            total = (pol - entropy * hp["entropy_coef"]
                     + vloss * hp["value_loss_coef"])
            grads = torch.autograd.grad(total, list(p.values()),
                                        allow_unused=True)
        g = {k: torch.zeros_like(x) if gk is None else gk
             for (k, x), gk in zip(p.items(), grads)}
        params, opt = ppo.adam_step(params, g, opt, hp["lr"],
                                    hp["opti_eps"], hp["max_grad_norm"])
        losses["policy_loss"].append(pol.detach())
        losses["value_loss"].append(vloss.detach())
        losses["dist_entropy"].append(entropy.detach())
        if on_step is not None:
            on_step(len(losses["policy_loss"]), params, opt)
    return params, opt, vn, {k: torch.stack(v) for k, v in losses.items()}
