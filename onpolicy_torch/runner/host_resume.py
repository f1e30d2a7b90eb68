"""The exact-resume protocol of the host runners.

Port of `onpolicy_tpu/runner/host_resume.py`, onto the port's
`utils/checkpoint.py`: the train state (or the tuple of per-agent
states), the episode counter, the generators' states (in the place of
JAX's key) and the staging carry (obs, share_obs, available actions and
masks as tensors from their numpy blocks; the rnn states, which are
tensors already) go through one checkpoint, beyond the reference's
weights-only restore (`base_runner.py:143-162`). The external env
cannot be saved (SC2 and GRF are live processes): the pool is reset, and
the restored carry keeps every input of the policy and the trainer as it
was. Over a data mesh the checkpoint holds the global carry (gathered on
every rank, written by the rank given a `save_dir`); each rank restores
it and keeps its envs' rows. On a `(data, model)` mesh the caller hands
`save_run_state` the whole gathered state and `restore_run_state` the
`cut` to this rank's blocks, so the file is one process's.
"""
from __future__ import annotations

import numpy as np
import torch

from onpolicy_torch.parallel import distributed
from onpolicy_torch.utils import checkpoint as ckpt_lib

# the carry's host-side entries, numpy between episodes
_HOST = ("obs", "share_obs", "avail", "masks", "active", "bad")


def restore_run_state(cfg, state, start: dict, device, generators: dict,
                      mesh=None, cut=None):
    """→ (state, start, first episode). With cfg.model_dir: the state
    (through `cut`, as `utils/checkpoint.restore`), the carry (this
    rank's rows of it over a `mesh`) and the generators from its
    checkpoint; else as given, from episode 0."""
    if not cfg.model_dir:
        return state, start, 0
    state, step, carry = ckpt_lib.restore(cfg.model_dir, state, device,
                                          generators, cut)
    if carry is not None:
        if mesh is not None:
            carry = {k: v[mesh.rows(v.shape[0])] for k, v in carry.items()}
        start = {**start, **{k: v.cpu().numpy() if k in _HOST else v
                             for k, v in carry.items()}}
    return state, start, step


def save_run_state(save_dir, state, step: int, generators: dict,
                   start: dict, mesh=None):
    """The full checkpoint, `step` the episode to resume at, written into
    `save_dir` when it is given. Called after the episode's eval, so the
    saved generators continue the uninterrupted stream. Over a `mesh`
    every rank calls it: the carry is gathered, and `state` is the whole
    one."""
    carry = {k: torch.from_numpy(np.ascontiguousarray(v))
             if isinstance(v, np.ndarray) else v
             for k, v in start.items() if v is not None}
    if mesh is not None:
        carry = distributed.gather_rows(
            {k: v.to(mesh.device) for k, v in carry.items()}, 0, mesh)
    if save_dir:
        ckpt_lib.save(save_dir, state, step, generators, carry)
