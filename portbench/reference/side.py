"""One side of the comparison that decides `correct`: the plain reference
following the program's first training iterations, and what is compared.

`Side` holds the reference's own weights, Adam states and ValueNorm
statistics from the benchmark's initial weights on, and for each
iteration recomputes the acting step over the rollout's rows and runs
the update on the iteration's batch. With `tf32` it computes its matrix
products in TF32: the control, the next precision below the
configuration's float32 with TF32 off.

The update is compared over the first STEPS Adam steps of the first
iteration, where both sides start from the same weights and data: each
step's loss (`step_loss_gap`), and, by the median parameter leaf's gap
of norms, the first gradient as Adam got it, worked out from its first
moment after one step (mu = (1 - beta1) g), and the parameters' change
after the STEPS steps (`step_gaps`). The worst leaf is a small one whose
gradient is a cancelling sum over every row (the critic's value bias,
its last LayerNorm's bias), whose gap swings from seed to seed; it is
kept as a note. Later steps
compound the rounding of both sides' reductions through Adam (a
gradient element near zero takes a step of about lr whatever its size),
so they are judged through the acting step on the later rollouts.
"""
from __future__ import annotations

import contextlib

import torch

from portbench.reference import ppo

# a leaf whose reference gradient is under this share of the median
# leaf's is moved by Adam's round-off alone, and is left out of the
# change of the parameters
STILL_LEAF = 1e-3
# the Adam steps whose losses, first gradient and parameter change are
# compared
STEPS = 3


@contextlib.contextmanager
def precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Side:
    def __init__(self, hp, weights: dict, device, tf32: bool = False):
        self.hp, self.device, self.tf32 = hp, device, tf32
        to = lambda d: {k: v.to(device) for k, v in d.items()}
        self.actor, self.critic = to(weights["actor"]), to(weights["critic"])
        self.start = {"actor": self.actor, "critic": self.critic}
        self.prev = self.start
        self.a_opt, self.c_opt = (ppo.adam_init(self.actor),
                                  ppo.adam_init(self.critic))
        self.vn = ppo.vnorm_init(device)
        self.steps = None

    def params(self, which: str = "current"):
        if which == "previous":
            return self.prev
        return {"actor": self.actor, "critic": self.critic}

    @torch.no_grad()
    def act(self, rows: dict, which: str = "current") -> dict:
        """Flat rows: obs, h_in, mask, action, share_obs, hc_in [, avail]
        -> logp of the action, the next actor state, value, next critic
        state."""
        p = self.params(which)
        with precision(self.tf32):
            logsm, h = ppo.actor_step(p["actor"], self.hp, rows["obs"],
                                      rows["h_in"], rows["mask"],
                                      rows.get("avail"))
            v, hc = ppo.critic_step(p["critic"], self.hp, rows["share_obs"],
                                    rows["hc_in"], rows["mask"])
        return {"logp": logsm.gather(-1, rows["action"].long()),
                "h_out": h, "value": v, "hc_out": hc}

    @torch.no_grad()
    def value(self, share_obs, hc_in, mask):
        with precision(self.tf32):
            v, _ = ppo.critic_step(self.critic, self.hp, share_obs, hc_in,
                                   mask)
        return v

    def returns(self, rewards, values, masks):
        return ppo.gae(rewards, values, masks, self.vn, self.hp["gamma"],
                       self.hp["gae_lambda"])

    def train(self, batch: dict) -> None:
        """One iteration's update; the first also records its first STEPS
        steps (`steps`: losses, Adam's first moments after step 1, the
        parameters after step STEPS)."""
        self.prev = {"actor": self.actor, "critic": self.critic}
        rec = None
        if self.steps is None:
            rec = self.steps = {}

            def on_step(k, actor, critic, a_opt, c_opt):
                if k == 1:
                    rec["mu_first"] = {"actor": a_opt["mu"],
                                       "critic": c_opt["mu"]}
                if k == STEPS:
                    rec["params"] = {"actor": actor, "critic": critic}
        with precision(self.tf32):
            (self.actor, self.critic, self.a_opt, self.c_opt, self.vn,
             losses) = ppo.ppo_update(self.hp, self.actor, self.critic,
                                      self.a_opt, self.c_opt, self.vn, batch,
                                      on_step if rec is not None else None)
        if rec is not None:
            rec["losses"] = [{k: float(v[i]) for k, v in losses.items()}
                             for i in range(STEPS)]


def loss_gap(hp, prog: dict, ref: dict) -> float:
    """|total loss gap| over the sum of the reference's terms' sizes (the
    total itself may cancel to near zero)."""
    w = {"policy_loss": 1.0, "dist_entropy": -hp["entropy_coef"],
         "value_loss": hp["value_loss_coef"]}
    gap = sum(c * (prog[k] - ref[k]) for k, c in w.items())
    size = sum(abs(c * ref[k]) for k, c in w.items())
    return abs(gap) / max(size, 1e-12)


def step_gaps(hp, prog: dict, ref: dict, start: dict) -> dict:
    """The first STEPS Adam steps of the two sides (each {"losses",
    "mu_first", "params"}; `start` the weights both began from) -> the
    compared numbers (the worst step's loss gap; the median leaf's gap of
    the first gradient and of the change) and, as notes, each step's loss
    gap and the worst leaves with their gaps."""
    losses = [loss_gap(hp, p, r)
              for p, r in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["mu_first"], ref["mu_first"])
    change = lambda side: {net: {k: side["params"][net][k] - start[net][k]
                                 for k in start[net]}
                           for net in ("actor", "critic")}
    upd = leaf_gaps(change(prog), change(ref),
                    keep=moving_leaves(ref["mu_first"]))
    worst = lambda g: max(g.items(), key=lambda kv: kv[1])
    return {"step_loss_gap": max(losses), "step_loss_gaps": losses,
            "grad_gap": median(grad.values()),
            "update_gap": median(upd.values()),
            "grad_worst": worst(grad), "update_worst": worst(upd)}


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2]


def _norms(tree: dict) -> dict:
    return {f"{net}.{k}": float(v.double().norm())
            for net, leaves in tree.items() for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm(ref)), over the leaves in `keep` (all by default)."""
    p, r = _norms(prog), _norms(ref)
    names = [k for k in r if keep is None or k in keep]
    med = median(r[k] for k in names)
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in names}


def moving_leaves(mu_ref: dict) -> set:
    """The leaves whose first moment after the first step is at least
    STILL_LEAF of the median leaf's."""
    r = _norms(mu_ref)
    med = median(r.values())
    return {k for k, v in r.items() if v >= STILL_LEAF * med}


def widest(a, b, where=None) -> float:
    d = (a.double() - b.double()).abs()
    if where is not None:
        d = d[where.expand_as(d)] if where.shape != d.shape else d[where]
    return float(d.max()) if d.numel() else 0.0


def acting(gaps: list) -> dict:
    """The acting step's widest gap on the first rollout, where both
    sides hold the benchmark's weights (`act_gap`), and on the later ones,
    after each side's own updates (`later_act_gap`)."""
    return {"act_gap": gaps[0],
            "later_act_gap": max(gaps[1:]) if len(gaps) > 1 else 0.0}


def update_gaps(hp, cap: dict, ref: Side, other) -> dict:
    """`step_gaps` of the program (or the control) against the
    reference."""
    if other is not None:
        prog = other.steps
    else:
        dev = lambda tree: {net: {k: v.to(ref.device) for k, v in t.items()}
                            for net, t in tree.items()}
        prog = {"losses": cap["steps"]["losses"],
                "mu_first": dev(cap["steps"]["mu_first"]),
                "params": dev(cap["steps"]["params"])}
    return step_gaps(hp, prog, ref.steps, ref.start)

