"""Nested dict/list/tuple trees of tensors (the port's parameter layout).

Parameters, optimizer moments and minibatches are plain nested
containers, as in the JAX package, so a JAX tree carries across leaf for
leaf. These helpers walk them in a fixed order: dict keys sorted, as `jax.tree_util` orders them.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """Rebuild `tree`'s structure from `leaves` in `tree_leaves` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
