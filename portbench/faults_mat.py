"""Faults planted in MAT's path through the program under test, in the
running process only, to show that the comparison which decides `correct`
for the MPE MAT family catches them (`faults.py`'s four at MAT's seams,
and one of the transformer's own):

  stale_update      `MAT.train` returns its state unchanged
  half_batch        MAT's sampler (`buffer.transformer_minibatches`) keeps
                    the first half of each minibatch's env steps
  altered_action    each action the decode draws is replaced by the next
                    one after its log-probability was taken and its
                    one-hot fed to the next agent's slot
  stale_env         the MPE world's step returns its state unchanged
                    (only its clock moves on)
  unmasked_decoder  the decoder's attentions see every slot: the causal
                    mask over the agents is dropped

Each is a context manager that patches a module attribute of the program
and restores it on exit.
"""
from __future__ import annotations

import contextlib

import torch

from portbench import faults

NAMES = ("stale_update", "half_batch", "altered_action", "stale_env",
         "unmasked_decoder")


def _half_batch(old):
    def sample(*args, **kw):
        return [{k: x.narrow(0, 0, x.shape[0] // 2) for k, x in mb.items()}
                for mb in old(*args, **kw)]
    return sample


def _altered_action(old):
    def decode(mcfg, params, obs, generator, available_actions=None,
               deterministic=False, enc_in=None, actions=None, noise=None):
        a, logp, v = old(mcfg, params, obs, generator, available_actions,
                         deterministic, enc_in, actions, noise)
        if actions is None and not deterministic:
            a = torch.remainder(a + 1, mcfg.action_dim)
        return a, logp, v
    return decode


def _unmasked(old):
    def attn_apply(p, k_in, v_in, q_in, n_head, masked):
        return old(p, k_in, v_in, q_in, n_head, False)
    return attn_apply


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` (None: as it is)."""
    if name is None:
        yield
        return
    if name == "stale_update":
        from onpolicy_torch.algorithms.mat import MAT
        with faults._patched(MAT, "train", faults._stale_update):
            yield
    elif name == "half_batch":
        from onpolicy_torch import buffer
        with faults._patched(buffer, "transformer_minibatches", _half_batch):
            yield
    elif name == "altered_action":
        from onpolicy_torch.models import transformer
        with faults._patched(transformer, "autoregressive_act",
                             _altered_action):
            yield
    elif name == "stale_env":
        from onpolicy_torch.envs.mpe import env
        with faults._patched(env, "physics_step", faults._stale_env):
            yield
    elif name == "unmasked_decoder":
        from onpolicy_torch.models import transformer
        with faults._patched(transformer, "attn_apply", _unmasked):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
