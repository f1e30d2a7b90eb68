"""Faults planted in the exchange between the ranks of a data-parallel
run, to show that the comparison which decides `correct` catches a rank
that trains or checks without the other ranks' part:

  local_allreduce  `distributed.sum_over_ranks` returns each rank's own
                   gradients and loss terms: the all-reduce left out
  local_gather     `distributed.gather_rows` returns each rank's
                   zero-filled global buffer with only its own rows in
                   it: the all-reduce left out

The ranks are processes of their own (`launchers/torchrun.py`), so a
fault is planted in each: `measure_planted` is `core.measure` with the
fault planted around it, and is what the launcher is given.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from portbench import core, faults

NAMES = ("local_allreduce", "local_gather")


def _local_sum(old):
    def sum_over_ranks(grads, aux, mesh):
        return old(grads, aux, None)
    return sum_over_ranks


def _local_gather(old):
    def gather_rows(x, axis, mesh):
        if mesh is None:
            return x

        def own(t):
            shape = list(t.shape)
            rows = shape[axis]
            shape[axis] *= mesh.size
            out = t.new_zeros(shape)
            out.narrow(axis, mesh.rank * rows, rows).copy_(t)
            return out
        if isinstance(x, torch.Tensor):
            return own(x)
        return {k: own(t) for k, t in x.items()}
    return gather_rows


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` (None: as it is)."""
    if name is None:
        yield
        return
    from onpolicy_torch.parallel import distributed
    make = {"local_allreduce": ("sum_over_ranks", _local_sum),
            "local_gather": ("gather_rows", _local_gather)}
    if name not in make:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
    with faults._patched(distributed, *make[name]):
        yield


def _measure(fault, cell, seed, seconds, trace, start, device="cuda"):
    with planted(fault):
        return core.measure(cell, seed, seconds, trace, start, device)


def measure_planted(fault):
    """`core.measure` with `fault` planted in the rank that calls it."""
    return functools.partial(_measure, fault)
