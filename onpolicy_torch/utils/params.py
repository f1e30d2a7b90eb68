"""Carry trainer state between the JAX package and the port.

Both sides keep the same trees: parameters as nested dicts/lists with
linear weights `[in, out]` and the GRU's `w_ih [in, 3H]`, `w_hh [H, 3H]`.
These functions take and give numpy only (the caller does the
`jax.device_get`), so the port never imports JAX:

  * parameter trees: numpy leaves ↔ tensors; the one layout that differs
    is a CNN base's convolution kernel (a `"conv"` node's 4-D `"w"`),
    HWIO in JAX and OIHW in the port (`models/cnn.py`), moved by
    `to_torch` / `to_numpy` (optimizer moments too);
  * optimizer state: optax's `(EmptyState, (ScaleByAdamState(count, mu,
    nu), ...))` chain ↔ the port's `{"count", "mu", "nu"}`;
  * `ValueNormState` (running_mean, running_mean_sq, debiasing_term);
  * a whole `TrainState` (MAPPO, HAPPO, HATRPO) or `MATTrainState` (MAT:
    one parameter tree, one optimizer), and the MPE `WorldState` of a
    rollout carry.

Objects from the JAX side are read by attribute name (duck typing), and
written back through the template's own `replace` / `_replace`.
"""
from __future__ import annotations

import numpy as np
import torch

from onpolicy_torch.envs.mpe.world import WorldState
from onpolicy_torch.ops import valuenorm as vn
from onpolicy_torch.utils.tree import tree_map


def _conv_kernels(tree, fn):
    """`tree` with `fn` applied to each CNN convolution kernel (the 4-D
    "w" of a "conv" node)."""
    if isinstance(tree, dict):
        out = {k: _conv_kernels(v, fn) for k, v in tree.items()}
        conv = out.get("conv")
        if isinstance(conv, dict) and getattr(conv.get("w"), "ndim", 0) == 4:
            out["conv"] = {**conv, "w": fn(conv["w"])}
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_conv_kernels(v, fn) for v in tree)
    return tree


def to_torch(tree, device="cpu", dtype=None):
    """Nested dicts/lists of numpy arrays → the same tree of tensors (a
    convolution kernel HWIO → OIHW)."""
    def conv(x):
        t = torch.as_tensor(np.array(x), device=device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return _conv_kernels(tree_map(conv, tree),
                         lambda w: w.permute(3, 2, 0, 1).contiguous())


def to_numpy(tree):
    """Tensors → numpy (a convolution kernel OIHW → HWIO)."""
    return _conv_kernels(tree_map(lambda t: t.detach().cpu().numpy(), tree),
                         lambda w: np.ascontiguousarray(w.transpose(2, 3, 1, 0)))


def _fields(s) -> tuple:
    """A NamedTuple's field names (optax states are NamedTuples; note that
    every tuple has a `count` method, so `hasattr` cannot tell)."""
    return getattr(s, "_fields", ())


def _find_adam(opt_state):
    """The ScaleByAdamState inside an optax chain state."""
    if {"count", "mu", "nu"} <= set(_fields(opt_state)):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, device="cpu") -> dict:
    s = _find_adam(opt_state)
    if s is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    return {"count": torch.tensor(np.asarray(s.count, np.int32),
                                  device=device),
            "mu": to_torch(s.mu, device), "nu": to_torch(s.nu, device)}


def adam_state_to_optax(state: dict, template):
    """Write the port's Adam state into a (numpy) optax chain state shaped
    like `template`; schedule counters take the Adam count."""
    count = np.asarray(state["count"].cpu().numpy(), np.int32)

    def rebuild(s):
        if {"count", "mu", "nu"} <= set(_fields(s)):
            return s._replace(count=count, mu=to_numpy(state["mu"]),
                              nu=to_numpy(state["nu"]))
        if "count" in _fields(s):
            return s._replace(count=count)
        if isinstance(s, tuple) and not _fields(s):
            return tuple(rebuild(x) for x in s)
        return s
    return rebuild(template)


def valuenorm_from_jax(s, device="cpu") -> vn.ValueNormState:
    return vn.ValueNormState(
        running_mean=torch.as_tensor(np.array(s.running_mean), device=device),
        running_mean_sq=torch.as_tensor(np.array(s.running_mean_sq),
                                        device=device),
        debiasing_term=torch.as_tensor(np.array(s.debiasing_term),
                                       device=device),
        beta=s.beta, per_element_update=s.per_element_update,
        norm_axes=s.norm_axes)


def valuenorm_to_numpy(s: vn.ValueNormState) -> dict:
    return {k: getattr(s, k).detach().cpu().numpy()
            for k in ("running_mean", "running_mean_sq", "debiasing_term")}


def _vnorm_from_jax(s, device):
    return None if s is None else valuenorm_from_jax(s, device)


def train_state_from_jax(ts, device="cpu"):
    """A (numpy) JAX `TrainState` → the port's `TrainState`; a JAX
    `MATTrainState` (it has `params`) → the port's `MATTrainState`."""
    if hasattr(ts, "params"):
        from onpolicy_torch.algorithms.mat import MATTrainState
        return MATTrainState(
            params=to_torch(ts.params, device),
            opt_state=adam_state_from_optax(ts.opt_state, device),
            vnorm=_vnorm_from_jax(ts.vnorm, device))
    from onpolicy_torch.algorithms.mappo import TrainState
    return TrainState(
        actor_params=to_torch(ts.actor_params, device),
        critic_params=to_torch(ts.critic_params, device),
        actor_opt_state=adam_state_from_optax(ts.actor_opt_state, device),
        critic_opt_state=adam_state_from_optax(ts.critic_opt_state, device),
        vnorm=_vnorm_from_jax(ts.vnorm, device))


def train_state_to_jax(ts, template):
    """The port's `TrainState` (or `MATTrainState`) → a numpy JAX one like
    `template`."""
    vnorm = template.vnorm
    if ts.vnorm is not None:
        vnorm = vnorm.replace(**valuenorm_to_numpy(ts.vnorm))
    if hasattr(template, "params"):
        return template.replace(
            params=to_numpy(ts.params),
            opt_state=adam_state_to_optax(ts.opt_state, template.opt_state),
            vnorm=vnorm)
    return template.replace(
        actor_params=to_numpy(ts.actor_params),
        critic_params=to_numpy(ts.critic_params),
        actor_opt_state=adam_state_to_optax(ts.actor_opt_state,
                                            template.actor_opt_state),
        critic_opt_state=adam_state_to_optax(ts.critic_opt_state,
                                             template.critic_opt_state),
        vnorm=vnorm)


def world_state_from_jax(s, device="cpu", dtype=None) -> WorldState:
    """A batched (numpy) JAX MPE `WorldState` → the port's."""
    conv = lambda x: to_torch(x, device, dtype)
    return WorldState(
        agent_pos=conv(s.agent_pos), agent_vel=conv(s.agent_vel),
        agent_comm=conv(s.agent_comm), landmark_pos=conv(s.landmark_pos),
        landmark_vel=conv(s.landmark_vel),
        t=torch.tensor(np.asarray(s.t, np.int32), device=device),
        extras={k: conv(v) for k, v in dict(s.extras).items()})
