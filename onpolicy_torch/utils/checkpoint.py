"""Full-state checkpointing with `torch.save`.

Port of `onpolicy_tpu/utils/checkpoint.py`. The reference saves only the
actor/critic weights; here the whole `TrainState` (parameters, both
optimizer states, ValueNorm) or the separated runner's tuple of per-agent
`TrainState`s, the episode counter, the generators' states and the
rollout carry (env states, obs, rnn states, masks) round-trip, so
training resumes exactly. Everything is stored as plain containers of
tensors, loadable with `weights_only=True`.

Layout: <dir>/ckpt_<step>.pt + latest.txt pointer.

A checkpoint does not depend on the mesh: on a `(data, model)` mesh the
runner gathers the whole state (`parallel/mesh.StateShards.full`) and
rank 0 writes it as one process would, and `restore` cuts each rank's
blocks of it (`cut`).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch

from onpolicy_torch.utils.tree import tree_map


def _state_dict(train_state):
    if isinstance(train_state, tuple):
        return [_state_dict(s) for s in train_state]
    d = {f.name: getattr(train_state, f.name)
         for f in dataclasses.fields(train_state)}
    if train_state.vnorm is not None:
        v = train_state.vnorm
        d["vnorm"] = {"running_mean": v.running_mean,
                      "running_mean_sq": v.running_mean_sq,
                      "debiasing_term": v.debiasing_term}
    return tree_map(lambda t: t.detach().cpu(), d)


def save(ckpt_dir, train_state, step: int, generators: dict,
         carry: Optional[dict] = None) -> Path:
    """`generators`: name → torch.Generator whose state is saved."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    payload = {
        "state": _state_dict(train_state),
        "step": int(step),
        "generators": {k: g.get_state() for k, g in generators.items()},
        "carry": None if carry is None else
        tree_map(lambda t: t.detach().cpu(), carry),
    }
    path = d / f"ckpt_{step}.pt"
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    (d / "latest.txt").write_text(path.name)
    return path


def latest_path(ckpt_dir) -> Optional[Path]:
    d = Path(ckpt_dir)
    pointer = d / "latest.txt"
    if pointer.exists():
        p = d / pointer.read_text().strip()
        return p if p.exists() else None
    cands = sorted((p for p in d.glob("ckpt_*.pt")
                    if p.stem.split("_")[1].isdigit()),
                   key=lambda p: int(p.stem.split("_")[1]))
    return cands[-1] if cands else None


def _from_state_dict(s: dict, template, device):
    s = tree_map(lambda t: t.to(device), s)
    if s["vnorm"] is not None:
        s["vnorm"] = template.vnorm.replace(**s["vnorm"])
    return template.replace(**s)


def restore(ckpt_dir, template, device, generators: dict, cut=None):
    """→ (train_state, step, carry or None). `template` is a `TrainState`
    (or a tuple of them) giving the ValueNorm's static fields; the
    generators named in `generators` get their saved state back. `cut`
    maps the whole saved state to what this rank keeps of it."""
    path = Path(ckpt_dir)
    if path.is_dir():
        path = latest_path(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(template, tuple):
        state = tuple(_from_state_dict(s, t, device)
                      for s, t in zip(payload["state"], template))
    else:
        state = _from_state_dict(payload["state"], template, device)
    if cut is not None:
        state = cut(state)
    for k, g in generators.items():
        g.set_state(payload["generators"][k])
    carry = payload["carry"]
    if carry is not None:
        carry = tree_map(lambda t: t.to(device), carry)
    return state, payload["step"], carry

