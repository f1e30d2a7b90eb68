"""The comparison that decides `correct` for the MPE shared-policy family.

For each checked iteration the capture holds the rollout buffer as the
program handed it to its update ([T+1, N, M, ...]: observations, the
served actions with their log-probabilities, values, rewards, masks, the
recurrent states before each step, returns), and for the first
iteration's first Adam steps their losses, Adam's first moments after the
first and the parameters after the last (`side.step_gaps`). The
reference
  * steps simple_spread's physics from each observed state with the
    served actions (`mpe_spread.check_rollout`),
  * recomputes the acting step from the stored recurrent states with its
    own weights, and
  * computes GAE with its own ValueNorm and runs the update itself,
so each iteration starts from where the reference's last ended, and only
the environment's data (observations, actions, rewards, masks) and the
recurrent states at the window starts come from the program.
"""
from __future__ import annotations

import torch

from portbench.reference import mpe_spread
from portbench.reference.side import Side, acting, update_gaps, widest


def _rows(d: dict, T: int) -> dict:
    flat = lambda x: x.reshape(-1, *x.shape[3:])
    return {"obs": flat(d["obs"][:T]), "h_in": flat(d["rnn_actor"][:T]),
            "mask": flat(d["masks"][:T]), "action": flat(d["actions"]),
            "share_obs": flat(d["share_obs"][:T]),
            "hc_in": flat(d["rnn_critic"][:T])}


def _iteration(side: Side, d: dict) -> dict:
    """The reference's acting step, returns and update on one captured
    rollout -> its outputs in the buffer's layout."""
    T, N, M = d["actions"].shape[:3]
    out = side.act(_rows(d, T))
    shape = lambda x: x.reshape(T, N, M, *x.shape[1:])
    out = {k: shape(v) for k, v in out.items()}
    flat = lambda x: x.reshape(N * M, *x.shape[2:])
    boot = side.value(flat(d["share_obs"][T]), flat(d["rnn_critic"][T]),
                      flat(d["masks"][T])).reshape(N, M, 1)
    values = torch.cat([out["value"], boot[None]], 0)
    ret, adv = side.returns(d["rewards"], values, d["masks"])
    batch = {"obs": d["obs"][:T], "share_obs": d["share_obs"][:T],
             "actions": d["actions"], "old_logp": out["logp"],
             "value_preds": out["value"], "returns": ret,
             "advantages": adv, "masks": d["masks"][:T],
             "active": d["active"][:T], "avail": None,
             "rnn_actor": d["rnn_actor"][:T],
             "rnn_critic": d["rnn_critic"][:T]}
    out["returns"] = ret
    side.train(batch)
    return out


def _program(d: dict) -> dict:
    T = d["actions"].shape[0]
    return {"logp": d["logp"], "h_out": d["rnn_actor"][1:],
            "value": d["values"][:T], "hc_out": d["rnn_critic"][1:],
            "returns": d["returns"]}


def check(cap: dict, config: dict, device, control: bool = False) -> dict:
    """-> the compared numbers. With `control` the reference in TF32 takes
    the program's place."""
    hp = {**config["model"], **config["ppo"]}
    env = config["env"]
    ref = Side(hp, cap["weights"], device)
    other = Side(hp, cap["weights"], device, tf32=True) if control else None
    r = {"obs_gap": 0.0, "reward_gap": 0.0, "guard_failures": 0,
         "ambiguous_steps": 0, "act_gaps": []}
    for it in cap["iterations"]:
        d = {k: (v.to(device) if torch.is_tensor(v) else v)
             for k, v in it.items()}
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
                                 for k in ("logp", "value", "h_out",
                                           "hc_out")))
        if "returns_gap" not in r:
            # GAE with ValueNorm on the first rollout, from the same weights
            scale = float(want["returns"].abs().mean())
            r["returns_gap"] = (widest(got["returns"], want["returns"])
                                / max(scale, 1e-12))
        del d, want, got
    r.update(acting(r["act_gaps"]),
             **update_gaps(hp, cap, ref, other))
    return r

