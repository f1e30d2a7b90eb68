"""Faults planted in the program under test, in the running process only,
to show that the comparison which decides `correct` catches them:

  stale_update    the training step returns its state unchanged
  half_batch      each minibatch keeps half of its windows, and the loss
                  is the mean over the rest
  altered_action  each drawn action is replaced by the next one after its
                  log-probability was taken
  stale_env       the environment's step returns its state unchanged: the
                  MPE world (only its clock moves on); the Hanabi
                  engine, on the device (the tensor engine's step) and
                  on the host (the C++ engine's batched step)

Each is a context manager that patches a module attribute of the
program and restores it on exit.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("stale_update", "half_batch", "altered_action", "stale_env")


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _stale_update(old):
    def train(self, state, buf, *args, **kw):
        _, metrics = old(self, state, buf, *args, **kw)
        return state, metrics
    return train


def _half_batch(old):
    def sample(*args, **kw):
        out = []
        for mb in old(*args, **kw):
            half = {}
            for k, x in mb.items():
                axis = 0 if k in ("rnn_states", "rnn_states_critic") else 1
                n = x.shape[axis] // 2
                half[k] = x.narrow(axis, 0, n)
            out.append(half)
        return out
    return sample


def _altered_action(old):
    def sample(cfg, params, space, x, generator, available_actions=None,
               actions=None, deterministic=False):
        a, lp = old(cfg, params, space, x, generator, available_actions,
                    actions, deterministic)
        if actions is None and not deterministic:
            a = torch.remainder(a + 1, space.n)
        return a, lp
    return sample


def _stale_env(old):
    def physics_step(spec, state, u, c, noise=None):
        return state.replace(t=state.t + 1)
    return physics_step


def _stale_device_hanabi(old):
    def step(game, s, uid):
        return s, torch.zeros(s.deck.shape[0], device=s.deck.device)
    return step


def _stale_host_hanabi(old):
    def step(self, actions):
        return self._rew * 0.0
    return step


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` (None: as it is)."""
    if name is None:
        yield
        return
    if name == "stale_update":
        from onpolicy_torch.algorithms.mappo import MAPPO
        with _patched(MAPPO, "train", _stale_update):
            yield
    elif name == "half_batch":
        from onpolicy_torch import buffer
        with _patched(buffer, "recurrent_minibatches", _half_batch):
            yield
    elif name == "altered_action":
        from onpolicy_torch.models import act
        with _patched(act, "sample", _altered_action):
            yield
    elif name == "stale_env":
        from onpolicy_torch.envs.hanabi import binding, torch_engine
        from onpolicy_torch.envs.mpe import env
        with _patched(env, "physics_step", _stale_env), \
                _patched(torch_engine, "step", _stale_device_hanabi), \
                _patched(binding.HanabiBatch, "step", _stale_host_hanabi):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
