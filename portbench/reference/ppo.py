"""Plain rMAPPO in float32: the networks, one acting step, GAE with
ValueNorm, and the PPO update with its clipped global norm and Adam.

Written from the reference implementation's semantics (marlbenchmark
on-policy: `r_actor_critic.py`, `r_mappo.py`, `valuenorm.py`,
`separated_buffer.recurrent_generator`), with no kernel, no cache and no
batching tricks. It imports nothing of the program under test. Parameters
are a flat dict of named float32 tensors, linear weights stored
[in, out] and applied as `x @ w + b`; the names are the program's
parameter paths, so one set of weights can be handed to both sides.

Hyperparameters come from the configuration file's `model` and `ppo`
sections (`hp` below is that merged dict).
"""
from __future__ import annotations

import math

import torch

LN_EPS = 1e-5
MASK_NEG = -1e10
VN_BETA, VN_EPS, VN_VAR_MIN = 0.99999, 1e-5, 1e-2
ADAM_B1, ADAM_B2 = 0.9, 0.999


# ---- parameter shapes ------------------------------------------------------
def net_shapes(hp, in_dim: int, out_dim: int, head: str) -> dict:
    """Name -> (shape, kind, gain) of one network: the input LayerNorm,
    1 + layer_N MLP blocks, recurrent_N GRU layers with an output
    LayerNorm, and the head (`act.out` or `v_out`)."""
    H = hp["hidden_size"]
    mlp_gain = math.sqrt(2.0) if hp["use_ReLU"] else 5.0 / 3.0
    s = {}
    if hp["use_feature_normalization"]:
        s["base.feature_norm.scale"] = ((in_dim,), "one", 0.0)
        s["base.feature_norm.bias"] = ((in_dim,), "zero", 0.0)
    d = in_dim
    for i in range(1 + hp["layer_N"]):
        s[f"base.layers.{i}.lin.w"] = ((d, H), "weight", mlp_gain)
        s[f"base.layers.{i}.lin.b"] = ((H,), "zero", 0.0)
        s[f"base.layers.{i}.ln.scale"] = ((H,), "one", 0.0)
        s[f"base.layers.{i}.ln.bias"] = ((H,), "zero", 0.0)
        d = H
    for i in range(hp["recurrent_N"]):
        s[f"rnn.layers.{i}.w_ih"] = ((H, 3 * H), "weight", 1.0)
        s[f"rnn.layers.{i}.w_hh"] = ((H, 3 * H), "weight", 1.0)
        s[f"rnn.layers.{i}.b_ih"] = ((3 * H,), "zero", 0.0)
        s[f"rnn.layers.{i}.b_hh"] = ((3 * H,), "zero", 0.0)
    s["rnn.norm.scale"] = ((H,), "one", 0.0)
    s["rnn.norm.bias"] = ((H,), "zero", 0.0)
    if head == "actor":
        s["act.out.w"] = ((H, out_dim), "weight", hp["gain"])
        s["act.out.b"] = ((out_dim,), "zero", 0.0)
    else:
        s["v_out.w"] = ((H, 1), "weight", 1.0)
        s["v_out.b"] = ((1,), "zero", 0.0)
    return s


def make_params(shapes: dict, generator: torch.Generator, device) -> dict:
    """Weights drawn in one call: uniform with the variance gain^2/fan_in
    (the orthogonal init's scale), biases 0, LayerNorm scales 1."""
    sizes = [math.prod(shape) for shape, kind, _ in shapes.values()
             if kind == "weight"]
    u = torch.rand(sum(sizes), generator=generator, device=device) * 2 - 1
    out, at = {}, 0
    for name, (shape, kind, gain) in shapes.items():
        if kind == "weight":
            n = math.prod(shape)
            bound = gain * math.sqrt(3.0 / shape[0])
            out[name] = (u[at:at + n] * bound).reshape(shape).contiguous()
            at += n
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ---- networks ----------------------------------------------------------------
def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale + bias


def features(p, hp, x):
    """The MLP base: [B, in] -> [B, H]."""
    act = torch.relu if hp["use_ReLU"] else torch.tanh
    if hp["use_feature_normalization"]:
        x = layer_norm(x, p["base.feature_norm.scale"],
                       p["base.feature_norm.bias"])
    for i in range(1 + hp["layer_N"]):
        x = act(x @ p[f"base.layers.{i}.lin.w"] + p[f"base.layers.{i}.lin.b"])
        x = layer_norm(x, p[f"base.layers.{i}.ln.scale"],
                       p[f"base.layers.{i}.ln.bias"])
    return x


def gru_cell(p, i, x, h):
    """torch.nn.GRU's cell (gates r, z, n), h' = (1 - z) n + z h."""
    gi = x @ p[f"rnn.layers.{i}.w_ih"] + p[f"rnn.layers.{i}.b_ih"]
    gh = h @ p[f"rnn.layers.{i}.w_hh"] + p[f"rnn.layers.{i}.b_hh"]
    ir, iz, inn = gi.chunk(3, -1)
    hr, hz, hn = gh.chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1.0 - z) * n + z * h


def recurrent(p, hp, x, h, mask):
    """One step of the stacked GRU: x [B, H], h [B, L, H], mask [B, 1] ->
    (LayerNorm of the top output, new h [B, L, H])."""
    h = h * mask[..., None]
    outs, inp = [], x
    for i in range(hp["recurrent_N"]):
        inp = gru_cell(p, i, inp, h[:, i])
        outs.append(inp)
    return layer_norm(inp, p["rnn.norm.scale"], p["rnn.norm.bias"]), \
        torch.stack(outs, 1)


def masked_logits(logits, avail):
    if avail is None:
        return logits
    return torch.where(avail > 0, logits, torch.full_like(logits, MASK_NEG))


def actor_step(p, hp, obs, h, mask, avail=None):
    """-> (log-softmax of the masked logits [B, A], new h)."""
    x, h = recurrent(p, hp, features(p, hp, obs), h, mask)
    logits = masked_logits(x @ p["act.out.w"] + p["act.out.b"], avail)
    return torch.log_softmax(logits, -1), h


def critic_step(p, hp, share_obs, h, mask):
    """-> (value [B, 1] in ValueNorm's normalized space, new h)."""
    x, h = recurrent(p, hp, features(p, hp, share_obs), h, mask)
    return x @ p["v_out.w"] + p["v_out.b"], h


def run_sequence(p, hp, xs, h0, masks):
    """The stacked GRU over [L, B] steps from h0 [B, N, H], masks [L, B, 1],
    gating h by the mask at every step -> LayerNormed outputs [L, B, H]."""
    L, B = xs.shape[:2]
    feats = features(p, hp, xs.reshape(L * B, -1)).reshape(L, B, -1)
    h, outs = h0, []
    for t in range(L):
        y, h = recurrent(p, hp, feats[t], h, masks[t])
        outs.append(y)
    return torch.stack(outs)


# ---- ValueNorm, GAE ------------------------------------------------------
def vnorm_init(device) -> dict:
    z = lambda: torch.zeros((), dtype=torch.float64, device=device)
    return {"mean": z(), "mean_sq": z(), "debias": z()}


def vnorm_stats(vn):
    """(mean, std) as float32 scalars."""
    debias = torch.clamp_min(vn["debias"], VN_EPS)
    mean = vn["mean"] / debias
    var = torch.clamp_min(vn["mean_sq"] / debias - mean.square(), VN_VAR_MIN)
    return mean.float(), torch.sqrt(var).float()


def vnorm_update(vn, x):
    x = x.double()
    w = VN_BETA
    return {"mean": vn["mean"] * w + x.mean() * (1 - w),
            "mean_sq": vn["mean_sq"] * w + x.square().mean() * (1 - w),
            "debias": vn["debias"] * w + (1 - w)}


def gae(rewards, values, masks, vn, gamma, lam):
    """rewards [T, ...], values [T+1, ...] normalized, masks [T+1, ...]
    -> (returns, advantages) [T, ...] on denormalized values."""
    mean, std = vnorm_stats(vn)
    v = values * std + mean
    T = rewards.shape[0]
    adv = torch.zeros_like(rewards)
    run = torch.zeros_like(rewards[0])
    for t in reversed(range(T)):
        delta = rewards[t] + gamma * v[t + 1] * masks[t + 1] - v[t]
        run = delta + gamma * lam * masks[t + 1] * run
        adv[t] = run
    return adv + v[:-1], adv


# ---- the update ----------------------------------------------------------
def huber(e, delta):
    a = e.abs()
    return torch.where(a <= delta, 0.5 * e.square(), delta * (a - 0.5 * delta))


def chunked(x, L):
    """[T, N, M, ...] -> [L, n_chunks, ...]: the env-major stream cut into
    L-step windows (a window may run across an episode's end), the
    remainder dropped."""
    T, N, M = x.shape[:3]
    y = x.movedim(0, 2).reshape(N * M * T, *x.shape[3:])
    n = (N * M * T) // L
    return y[:n * L].reshape(n, L, *x.shape[3:]).transpose(0, 1)


def chunk_starts(x, L):
    """[T, N, M, ...] -> the first step's entry of each window."""
    T, N, M = x.shape[:3]
    y = x.movedim(0, 2).reshape(N * M * T, *x.shape[3:])
    n = (N * M * T) // L
    return y[torch.arange(n, device=x.device) * L]


def adam_step(p, g, opt, lr, eps, max_norm):
    """Clip the whole gradient by its global norm, then Adam (optax's
    bias correction); -> (params, opt)."""
    norm = torch.sqrt(sum(x.square().sum() for x in g.values()))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    k = opt["count"] + 1
    c1, c2 = 1 - ADAM_B1 ** k, 1 - ADAM_B2 ** k
    new_p, mu, nu = {}, {}, {}
    for name, w in p.items():
        gi = g[name] * scale
        mu[name] = ADAM_B1 * opt["mu"][name] + (1 - ADAM_B1) * gi
        nu[name] = ADAM_B2 * opt["nu"][name] + (1 - ADAM_B2) * gi * gi
        u = (mu[name] / c1) / (torch.sqrt(nu[name] / c2) + eps)
        new_p[name] = w - lr * u
    return new_p, {"count": k, "mu": mu, "nu": nu}


def adam_init(p) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in p.items()},
            "nu": {k: torch.zeros_like(v) for k, v in p.items()}}


def ppo_update(hp, actor, critic, a_opt, c_opt, vn, batch, on_step=None):
    """ppo_epoch x one minibatch of every window. `batch` holds [T(+1), N,
    M, ...] fields: obs, share_obs, actions, old_logp, value_preds,
    returns, advantages, masks, active, avail (or None), rnn_actor,
    rnn_critic (the rollout's states at each step). `on_step(k, actor,
    critic, a_opt, c_opt)` is called after the k-th Adam step (from 1).
    -> (actor, critic, a_opt, c_opt, vn, per-update losses [ppo_epoch] as
    a dict)."""
    L = hp["data_chunk_length"]
    if hp["num_mini_batch"] != 1:
        raise ValueError("the reference update takes one minibatch")
    act = batch["active"]
    adv = batch["advantages"]
    n = act.sum().clamp_min(1e-8)
    mean = (adv * act).sum() / n
    std = torch.sqrt(((adv - mean).square() * act).sum() / n)
    adv = (adv - mean) / (std + 1e-5)
    seq = {k: chunked(batch[k], L) for k in
           ("obs", "share_obs", "actions", "old_logp", "value_preds",
            "returns", "masks", "active")}
    seq["adv"] = chunked(adv, L)
    seq["avail"] = (chunked(batch["avail"], L) if batch["avail"] is not None
                    else None)
    h_a = chunk_starts(batch["rnn_actor"], L)
    h_c = chunk_starts(batch["rnn_critic"], L)
    ret = seq["returns"].reshape(-1)
    clip = hp["clip_param"]
    losses = {"policy_loss": [], "value_loss": [], "dist_entropy": []}
    for _ in range(hp["ppo_epoch"]):
        vn = vnorm_update(vn, ret)
        vmean, vstd = vnorm_stats(vn)
        ap = {k: v.detach().requires_grad_(True) for k, v in actor.items()}
        cp = {k: v.detach().requires_grad_(True) for k, v in critic.items()}
        with torch.enable_grad():
            x = run_sequence(ap, hp, seq["obs"], h_a, seq["masks"])
            logits = masked_logits(x @ ap["act.out.w"] + ap["act.out.b"],
                                   seq["avail"])
            logsm = torch.log_softmax(logits, -1)
            logp = logsm.gather(-1, seq["actions"].long())
            probs = logsm.exp()
            ent_rows = -torch.where(probs > 0, probs * logsm,
                                    torch.zeros_like(logsm)).sum(-1)
            w = seq["active"]
            wsum = w.sum().clamp_min(1e-8)
            entropy = (ent_rows * w[..., 0]).sum() / wsum
            ratio = torch.exp(logp - seq["old_logp"])
            surr = torch.minimum(ratio * seq["adv"],
                                 ratio.clamp(1 - clip, 1 + clip) * seq["adv"])
            pol = -(surr * w).sum() / wsum
            xv = run_sequence(cp, hp, seq["share_obs"], h_c, seq["masks"])
            v = xv @ cp["v_out.w"] + cp["v_out.b"]
            old = seq["value_preds"]
            v_clip = old + (v - old).clamp(-clip, clip)
            target = (seq["returns"] - vmean) / vstd
            e1 = huber(target - v, hp["huber_delta"])
            e2 = huber(target - v_clip, hp["huber_delta"])
            vloss = (torch.maximum(e1, e2) * w).sum() / wsum
            total = (pol - entropy * hp["entropy_coef"]
                     + vloss * hp["value_loss_coef"])
            grads = torch.autograd.grad(total, list(ap.values())
                                        + list(cp.values()))
        ga = dict(zip(ap, grads[:len(ap)]))
        gc = dict(zip(cp, grads[len(ap):]))
        actor, a_opt = adam_step(actor, ga, a_opt, hp["lr"], hp["opti_eps"],
                                 hp["max_grad_norm"])
        critic, c_opt = adam_step(critic, gc, c_opt, hp["critic_lr"],
                                  hp["opti_eps"], hp["max_grad_norm"])
        losses["policy_loss"].append(pol.detach())
        losses["value_loss"].append(vloss.detach())
        losses["dist_entropy"].append(entropy.detach())
        if on_step is not None:
            on_step(len(losses["policy_loss"]), actor, critic, a_opt, c_opt)
    return actor, critic, a_opt, c_opt, vn, {
        k: torch.stack(v) for k, v in losses.items()}
