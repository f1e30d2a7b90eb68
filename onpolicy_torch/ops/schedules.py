"""The optimizer, as optax computes it.

Port of `onpolicy_tpu/ops/schedules.py`. The JAX package chains
`optax.clip_by_global_norm(max_norm)` and `optax.adam(lr, eps)` (or
`adamw` under weight decay). torch's own pieces differ from those:
`clip_grad_norm_` scales by `max_norm/(‖g‖+1e-6)` whenever ‖g‖ > max_norm,
while optax scales by `max_norm/‖g‖` only when ‖g‖ ≥ max_norm; and
`torch.optim.Adam(weight_decay)` is coupled decay. So the transform is
written out here, on parameter trees:

  clip:  g ← g                  if ‖g‖ < max_norm
         g ← g / ‖g‖ · max_norm otherwise
  adam:  μ ← (1−β1)·g + β1·μ ;  ν ← (1−β2)·g² + β2·ν ;  k ← k+1
         u = (μ / (1−β1^k)) / (sqrt(ν / (1−β2^k)) + eps)
         (adamw: u ← u + wd·p)
  step:  p ← p − lr(k−1)·u

The state is {"count": int32, "mu": tree, "nu": tree}, optax's
`ScaleByAdamState`; `utils/params.py` carries it across.

On a `(data, model)` mesh a rank's parameters and moments are its blocks
of the full ones (`parallel/mesh.py`). `update` then takes the full
gradient (summed over the ranks), clips it by its global norm, and cuts
it to the rank's blocks (`cut`) before Adam: Adam is elementwise, so the
update of a block is that block of the full update.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from onpolicy_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

B1, B2 = 0.9, 0.999


class Optimizer:
    """Global-norm clip → Adam(eps) [→ decoupled weight decay] → −lr."""

    def __init__(self, lr: Union[float, Callable], eps: float,
                 weight_decay: float, max_grad_norm: float,
                 use_max_grad_norm: bool = True):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm if use_max_grad_norm else None

    def init(self, params) -> dict:
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state: dict, params, cut=None):
        """→ (new params, new state). `grads` has `params`' structure; with
        `cut` it is the full gradient, whose leaves `cut` maps to the
        blocks that `params` and `state` hold, after the clip."""
        g = tree_leaves(grads)
        if self.max_grad_norm is not None:
            norm = torch.sqrt(torch.stack([x.square().sum() for x in g]).sum())
            keep = norm < self.max_grad_norm
            g = [torch.where(keep, x, x / norm * self.max_grad_norm) for x in g]
        if cut is not None:
            g = cut(g)
        count = state["count"] + 1
        kf = count.float()
        c1 = 1.0 - torch.pow(B1, kf)
        c2 = 1.0 - torch.pow(B2, kf)
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        p = tree_leaves(params)
        mu, nu, new_p = [], [], []
        for x, m, v, w in zip(g, tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), p):
            m = (1.0 - B1) * x + B1 * m
            v = (1.0 - B2) * (x * x) + B2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * w
            new_p.append(w + (-lr) * u)
            mu.append(m)
            nu.append(v)
        return tree_unflatten(params, new_p), {
            "count": count, "mu": tree_unflatten(params, mu),
            "nu": tree_unflatten(params, nu)}


def make_optimizer(lr, eps: float, weight_decay: float, max_grad_norm,
                   use_max_grad_norm: bool = True) -> Optimizer:
    return Optimizer(lr, eps, weight_decay, max_grad_norm, use_max_grad_norm)
