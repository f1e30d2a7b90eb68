"""The mesh: D·M processes on the `(data, model)` axes.

Port of `onpolicy_tpu/parallel/mesh.py`. JAX's 1-D mesh `(data,)` shards
the env batch over D devices and replicates the parameters; its 2-D mesh
`(data, model)` also shards each parameter leaf and both Adam moments
along 'model' by one leaf rule (`_param_spec`, `model_sharded_state`
there), and XLA gathers what a computation needs. Here the D·M devices
are D·M processes of one torch.distributed group
(`parallel/distributed.py`), rank r = d·M + m, and `make_mesh` returns a
record of the group: its size, this process's rank, the device, and its
model group (the M ranks d·M .. d·M + M − 1) with its rank in it.

Rows (envs, minibatch rows) split over all D·M ranks, as in the data
mesh, so no rank repeats another's work. The model axis changes what a
rank keeps: the parameters and the moments of its trainers' states are
its block along the dimension the leaf rule gives (`param_dim`), cut by
`StateShards`. A rank gathers the full parameter trees over its model
group before the rollout and before each minibatch's forward
(`distributed.gather_model`, one collective a call) and computes on
them; the gathered weights live for that forward and backward only. The
update sums the full gradient over every rank, clips it by its global
norm, and applies Adam to this rank's block (`ops/schedules.py`). So the
numbers are one process's, up to the order of the gradient's sum: as
JAX says of its shardings, they change layout, not semantics.

The GRU kernels need every column of W_hh at every step of a time loop
inside one launch, which is why the compute runs on gathered weights
rather than on column blocks (JAX's XLA gathers a `pallas_call`'s
operands likewise).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from onpolicy_torch.parallel import distributed
from onpolicy_torch.utils.tree import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class DataMesh:
    size: int                 # D·M, the ranks that split the rows
    rank: int                 # this process's rank, d·M + m
    device: torch.device      # this rank's device
    group: Any = None         # the process group (None: the default one)
    model_size: int = 1       # M
    model_rank: int = 0       # m
    model_group: Any = None   # the M ranks of this rank's model group

    def rows(self, global_batch: int) -> slice:
        """This rank's block of a global batch of rows (or envs)."""
        return distributed.local_batch_slice(global_batch, self.size,
                                             self.rank)


def check_shape(mesh_shape) -> Tuple[int, ...]:
    """A 1-D `(data,)` or a 2-D `(data, model)` mesh shape."""
    shape = tuple(int(x) for x in mesh_shape)
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"mesh_shape must be (data,) or (data, model), "
                         f"got {shape}")
    return shape


def make_mesh(mesh_shape=(1,), device="cpu") -> Optional[DataMesh]:
    """The mesh of `mesh_shape` over the process group, or None for one
    process without a group (no collective at all). D·M must equal the
    world size; under torchrun at world size 1 the mesh is made, and its
    collectives run."""
    shape = check_shape(mesh_shape)
    D, M = (shape + (1,))[:2]
    ranks = distributed.world_size()
    if D * M != ranks:
        launch = f"{D}" if len(shape) == 1 else f"{D},{M}"
        raise ValueError(
            f"mesh_shape {shape} asks for D·M = {D * M} ranks, but the "
            f"process group has {ranks} (WORLD_SIZE); launch with torchrun "
            f"--nproc_per_node {D * M} ... --mesh_shape {launch}")
    if not dist.is_initialized():
        return None
    rank = dist.get_rank()
    return DataMesh(size=ranks, rank=rank, device=torch.device(device),
                    model_size=M, model_rank=rank % M,
                    model_group=distributed.model_group(M) if M > 1
                    else None)


# ---- the leaf rule ----------------------------------------------------------

def param_dim(shape, m: int) -> Optional[int]:
    """The dimension of a leaf of `shape` that is sharded over a model
    axis of `m`, or None (replicated): JAX's `_param_spec` — the last
    dimension where m divides it, else the second-to-last (the [H, 1]
    value head); a 1-D leaf where m divides it; nothing else."""
    shape = tuple(shape)
    if len(shape) >= 2:
        if shape[-1] % m == 0:
            return len(shape) - 1
        if shape[-2] % m == 0:
            return len(shape) - 2
    elif len(shape) == 1 and shape[0] % m == 0:
        return 0
    return None


# a CNN kernel is OIHW here and HWIO in JAX (`models/cnn.py`): the rule
# reads its JAX shape, and HWIO dim k is OIHW dim _OIHW_OF_HWIO[k]
_OIHW_OF_HWIO = (2, 3, 1, 0)


def leaf_dims(tree, m: int) -> List[Optional[int]]:
    """`param_dim` of every leaf of a parameter tree, in `tree_leaves`
    order, a convolution kernel (a "conv" node's 4-D "w") by its JAX
    layout."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            v = tree[k]
            if k == "conv" and isinstance(v, dict) and \
                    getattr(v.get("w"), "ndim", 0) == 4:
                for kk in sorted(v):
                    if kk == "w":
                        o, i, h, w = v["w"].shape
                        d = param_dim((h, w, i, o), m)
                        out.append(None if d is None else _OIHW_OF_HWIO[d])
                    else:
                        out += leaf_dims(v[kk], m)
            else:
                out += leaf_dims(v, m)
        return out
    if isinstance(tree, (list, tuple)):
        return [d for v in tree for d in leaf_dims(v, m)]
    return [] if tree is None else [param_dim(tree.shape, m)]


class Layout:
    """One parameter tree's layout along 'model' on `mesh`: the leaf
    rule's dimension of each leaf, from the tree's full shapes."""

    def __init__(self, full_tree, mesh: DataMesh):
        self.mesh = mesh
        self.dims = leaf_dims(full_tree, mesh.model_size)

    def cut_leaves(self, leaves: Sequence[torch.Tensor]) -> list:
        """Full leaves → this rank's blocks (copies: the full tensors are
        not kept alive through them)."""
        M, m = self.mesh.model_size, self.mesh.model_rank
        return [x if d is None else x.chunk(M, d)[m].clone()
                for x, d in zip(leaves, self.dims)]

    def cut(self, tree):
        return tree_unflatten(tree, self.cut_leaves(tree_leaves(tree)))


def gather(layouts: Sequence[Layout], trees: Sequence) -> list:
    """Trees of this rank's blocks → the full trees, one collective over
    the model group for all of them."""
    leaves = [tree_leaves(t) for t in trees]
    full = distributed.gather_model(
        [x for part in leaves for x in part],
        [d for lay in layouts for d in lay.dims], layouts[0].mesh)
    out, at = [], 0
    for t, part in zip(trees, leaves):
        out.append(tree_unflatten(t, full[at:at + len(part)]))
        at += len(part)
    return out


class StateShards:
    """A trainer's train state along 'model'. `fields` names each
    (parameter field, optimizer field) pair of the state; an optimizer
    state is `ops/schedules`' {"count", "mu", "nu"}, whose moments mirror
    the parameters. The step count and the normalizer stay replicated.
    Without a model axis every method gives the state as it is."""

    def __init__(self, mesh, fields: Sequence[Tuple[str, str]]):
        self.mesh = mesh
        self.fields = tuple(fields)
        self.layouts = None

    @property
    def on(self) -> bool:
        return self.mesh is not None and self.mesh.model_size > 1

    def cut(self, state):
        """A full state → this rank's: its block of every parameter and
        moment leaf the rule shards. Records the layout."""
        if not self.on:
            return state
        self.layouts = {p: Layout(getattr(state, p), self.mesh)
                        for p, _ in self.fields}
        kw = {}
        for p, o in self.fields:
            lay, opt = self.layouts[p], getattr(state, o)
            kw[p] = lay.cut(getattr(state, p))
            kw[o] = {**opt, "mu": lay.cut(opt["mu"]),
                     "nu": lay.cut(opt["nu"])}
        return state.replace(**kw)

    def _layouts(self):
        if self.layouts is None:
            raise RuntimeError("gather of a train state that was never cut")
        return [self.layouts[p] for p, _ in self.fields]

    def params(self, state) -> dict:
        """Parameter field → its full tree (one collective)."""
        if not self.on:
            return {p: getattr(state, p) for p, _ in self.fields}
        full = gather(self._layouts(),
                      [getattr(state, p) for p, _ in self.fields])
        return dict(zip((p for p, _ in self.fields), full))

    def gathered(self, state):
        """The state with its full parameters (the moments as they are):
        what the rollout, the bootstrap and the eval act with."""
        if not self.on:
            return state
        return state.replace(**self.params(state))

    def full(self, state):
        """The whole state as one process holds it: parameters and both
        moments gathered (one collective), what a checkpoint holds."""
        if not self.on:
            return state
        lays = self._layouts()
        trees = []
        for p, o in self.fields:
            opt = getattr(state, o)
            trees += [getattr(state, p), opt["mu"], opt["nu"]]
        full = gather([lay for lay in lays for _ in range(3)], trees)
        kw = {}
        for i, (p, o) in enumerate(self.fields):
            kw[p] = full[3 * i]
            kw[o] = {**getattr(state, o), "mu": full[3 * i + 1],
                     "nu": full[3 * i + 2]}
        return state.replace(**kw)

    def cut_tree(self, field: str, tree):
        """A full tree of parameter field `field` → this rank's blocks."""
        return self.layouts[field].cut(tree) if self.on else tree

    def cut_grads(self, field: str):
        """For `ops/schedules.Optimizer.update`: the full gradient's leaves
        of parameter field `field` → this rank's blocks; None without a
        model axis."""
        if not self.on:
            return None
        return self.layouts[field].cut_leaves


def each_state(shards: Sequence[StateShards], state, method: str):
    """A runner's state — one train state, or the tuple of per-agent ones
    of a separated runner — through each trainer's `StateShards.<method>`
    ("cut", "gathered" or "full")."""
    if isinstance(state, tuple):
        return tuple(getattr(s, method)(x) for s, x in zip(shards, state))
    return getattr(shards[0], method)(state)
