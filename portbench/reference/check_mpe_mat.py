"""The comparison that decides `correct` for the MPE MAT family.

For each checked iteration the capture holds the rollout buffer as the
program handed it to its update ([T+1, N, M, ...]: observations, the
served actions with their log-probabilities, the encoder's values,
rewards, masks, returns), and for the first iteration's first Adam steps
their losses, Adam's first moment after the first and the parameters
after the last. The plain reference (`reference/mat.py`)
  * steps simple_spread's physics from each observed state with the
    served actions (`mpe_spread.check_rollout`),
  * recomputes every act by its own autoregressive decode, the served
    actions injected, with its own weights (`act_gap` on the first
    rollout, `later_act_gap` on the later ones, after each side's own
    update), and
  * computes GAE with its own ValueNorm and runs MAT's update itself,
whose first steps are held to the program's over MAT's one parameter
tree (`step_loss_gap`, `grad_gap`, `update_gap`, as `side.step_gaps`).
"""
from __future__ import annotations

import torch

from portbench.reference import mat, mpe_spread, ppo
from portbench.reference.side import (STEPS, acting, leaf_gaps, loss_gap,
                                      median, moving_leaves, precision,
                                      widest)

TREE = "mat"


class MATSide:
    """The reference following the program: its weights, Adam state and
    ValueNorm statistics from the benchmark's initial weights on. With
    `tf32` its matrix products run in TF32: the control."""

    def __init__(self, hp, weights: dict, n_actions: int, device,
                 tf32: bool = False):
        self.hp, self.n_actions, self.tf32 = hp, n_actions, tf32
        self.params = {k: v.to(device) for k, v in weights.items()}
        self.start = {TREE: self.params}
        self.opt = ppo.adam_init(self.params)
        self.vn = ppo.vnorm_init(device)
        self.steps = None

    @torch.no_grad()
    def act(self, obs, actions) -> dict:
        with precision(self.tf32):
            logp, value = mat.act(self.params, self.hp, obs, actions,
                                  self.n_actions)
        return {"logp": logp, "value": value}

    @torch.no_grad()
    def value(self, obs):
        with precision(self.tf32):
            return mat.encoder(self.params, self.hp, obs)[0]

    def train(self, batch: dict) -> None:
        """One iteration's update; the first also records its first STEPS
        steps."""
        rec = None
        if self.steps is None:
            rec = self.steps = {}

            def on_step(k, params, opt):
                if k == 1:
                    rec["mu_first"] = {TREE: opt["mu"]}
                if k == STEPS:
                    rec["params"] = {TREE: params}
        with precision(self.tf32):
            self.params, self.opt, self.vn, losses = mat.mat_update(
                self.hp, self.params, self.opt, self.vn, batch,
                self.n_actions, on_step if rec is not None else None)
        if rec is not None:
            rec["losses"] = [{k: float(v[i]) for k, v in losses.items()}
                             for i in range(STEPS)]


def _iteration(side: MATSide, d: dict) -> dict:
    """The reference's acts, returns and update on one captured rollout
    -> its outputs in the buffer's layout."""
    T, N, M = d["actions"].shape[:3]
    rows = lambda x: x.reshape(T * N, M, *x.shape[3:])
    out = side.act(rows(d["obs"][:T]), rows(d["actions"]))
    out = {k: v.reshape(T, N, M, 1) for k, v in out.items()}
    boot = side.value(d["obs"][T])
    values = torch.cat([out["value"], boot[None]], 0)
    ret, adv = ppo.gae(d["rewards"], values, d["masks"], side.vn,
                       side.hp["gamma"], side.hp["gae_lambda"])
    out["returns"] = ret
    side.train({"obs": d["obs"][:T], "actions": d["actions"],
                "old_logp": out["logp"], "value_preds": out["value"],
                "returns": ret, "advantages": adv,
                "active": d["active"][:T], "avail": None})
    return out


def _program(d: dict) -> dict:
    T = d["actions"].shape[0]
    return {"logp": d["logp"], "value": d["values"][:T],
            "returns": d["returns"]}


def step_gaps(hp, prog: dict, ref: dict, start: dict) -> dict:
    """`side.step_gaps` over MAT's one tree: the worst of the first STEPS
    steps' loss gaps, the median leaf's gap of the first gradient and of
    the change after STEPS steps, and as notes each step's loss gap and
    the worst leaves."""
    losses = [loss_gap(hp, p, r)
              for p, r in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["mu_first"], ref["mu_first"])
    change = lambda side: {TREE: {k: side["params"][TREE][k] - v
                                  for k, v in start[TREE].items()}}
    upd = leaf_gaps(change(prog), change(ref),
                    keep=moving_leaves(ref["mu_first"]))
    worst = lambda g: max(g.items(), key=lambda kv: kv[1])
    return {"step_loss_gap": max(losses), "step_loss_gaps": losses,
            "grad_gap": median(grad.values()),
            "update_gap": median(upd.values()),
            "grad_worst": worst(grad), "update_worst": worst(upd)}


def check(cap: dict, config: dict, device, control: bool = False) -> dict:
    """-> the compared numbers. With `control` the reference in TF32 takes
    the program's place."""
    hp = {**config["model"], **config["ppo"]}
    env = config["env"]
    A = cap["n_actions"]
    ref = MATSide(hp, cap["weights"], A, device)
    other = MATSide(hp, cap["weights"], A, device, tf32=True) \
        if control else None
    r = {"obs_gap": 0.0, "reward_gap": 0.0, "guard_failures": 0,
         "ambiguous_steps": 0, "act_gaps": []}
    for it in cap["iterations"]:
        d = {k: v.to(device) for k, v in it.items()}
        M = d["obs"].shape[2]
        e = mpe_spread.check_rollout(d["obs"], d["actions"], d["rewards"],
                                     d["masks"], env["num_landmarks"],
                                     env["episode_length"])
        share = d["obs"].reshape(*d["obs"].shape[:2], 1, -1).expand(
            -1, -1, M, -1)
        r["guard_failures"] += (int(not e["resets_fresh"])
                                + int(not e["masks_ok"])
                                + int(not torch.equal(share, d["share_obs"])))
        r["obs_gap"] = max(r["obs_gap"], e["obs_gap"])
        r["reward_gap"] = max(r["reward_gap"], e["reward_gap"])
        r["ambiguous_steps"] += e["ambiguous_steps"]
        want = _iteration(ref, d)
        got = _iteration(other, d) if control else _program(d)
        r["act_gaps"].append(max(widest(got[k], want[k])
                                 for k in ("logp", "value")))
        if "returns_gap" not in r:
            # GAE with ValueNorm on the first rollout, from the same weights
            scale = float(want["returns"].abs().mean())
            r["returns_gap"] = (widest(got["returns"], want["returns"])
                                / max(scale, 1e-12))
        del d, want, got
    if other is not None:
        prog = other.steps
    else:
        dev = lambda tree: {TREE: {k: v.to(device)
                                   for k, v in tree.items()}}
        prog = {"losses": cap["steps"]["losses"],
                "mu_first": dev(cap["steps"]["mu_first"]),
                "params": dev(cap["steps"]["params"])}
    r.update(acting(r["act_gaps"]), **step_gaps(hp, prog, ref.steps,
                                                ref.start))
    return r
