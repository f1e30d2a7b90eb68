"""Data parallelism across processes on torch.distributed.

Port of `onpolicy_tpu/parallel/distributed.py`. There every host runs
the same program, `jax.distributed` joins them and one mesh spans every
chip. Here a mesh of D·M devices on the `(data, model)` axes is D·M
processes, one device each, in one process group:

    torchrun --standalone --nproc_per_node R \
        -m onpolicy_torch.scripts.train_mpe ... --mesh_shape R      # (R,)
    torchrun --standalone --nproc_per_node D·M \
        -m onpolicy_torch.scripts.train_mpe ... --mesh_shape D,M    # (D, M)

Every rank builds the same parameters from cfg.seed and holds the same
run generator. The rows split over all D·M ranks: a rank steps its block
of the envs (`local_batch_slice`: contiguous, rank-major), gathers the
episode into the whole buffer (`gather_rows`), cuts each minibatch from
it as one process would, and runs the networks on its share of the
minibatch's rows. The gradients and the loss terms are summed over the
ranks in one flat buffer (`all_reduce_sum`), so the clip and Adam see
the same gradients on every rank. On a model axis of 1 the parameters
stay replicated; over M > 1 each rank keeps its block of them
(`parallel/mesh.py`) and gathers the full trees over its model group
(`gather_model`) before it computes.

  * `initialize`: the process group, from torchrun's RANK / WORLD_SIZE /
    LOCAL_RANK / LOCAL_WORLD_SIZE or from explicit arguments (the tests
    give a `FileStore`). NCCL on the card and gloo on the CPU, or gloo
    when asked (`--dist_backend gloo`): NCCL refuses two ranks on one
    GPU, so ranks that share a card run gloo over CUDA tensors.
  * `setup(cfg)`: what the training scripts call first.
  * `RowDraws`: each random draw of the rollout made at the global shape
    and cut to the rank's rows, so that D·M ranks draw what one draws.
  * `global_batch(mesh)`: within it, `batch_total` and `batch_mean`
    reduce over the ranks; `ops/losses.masked_mean` divides by the whole
    minibatch's mask sum through them.

gloo takes CUDA tensors in `broadcast`, `all_reduce` and `barrier` only,
so the collectives here are all-reduces: `gather_rows` and
`gather_model` add the ranks' zero-filled global buffers, which is
exact. A failed collective raises; nothing falls back to the CPU or
skips a collective, at world size 1 too.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from onpolicy_torch.utils import profiling

BACKENDS = ("nccl", "gloo")


def plan(backend: Optional[str], kind: str, local_rank: int,
         local_world_size: int, n_devices: int
         ) -> Tuple[str, torch.device]:
    """→ (backend, this rank's device) for a rank on a `kind` ("cuda" or
    "cpu") device, `local_world_size` ranks on a node of `n_devices`
    cards. Local rank i takes card i mod n_devices. Raises where the
    process group could not work: NCCL without cards, or NCCL with more
    ranks than cards on the node (two ranks on one GPU, which NCCL
    refuses as "Duplicate GPU detected")."""
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"dist_backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if kind == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; a run on "
                             "the CPU takes gloo")
        return backend, torch.device("cpu")
    if n_devices == 0:
        raise RuntimeError("device cuda asked for, but no CUDA device is "
                           "visible")
    if backend == "nccl" and local_world_size > n_devices:
        raise ValueError(
            f"nccl cannot run {local_world_size} ranks on the {n_devices} "
            "GPU(s) of this node: NCCL refuses two ranks on one GPU "
            "('Duplicate GPU detected'). Give each rank its own card, or "
            "pass --dist_backend gloo to let ranks share a card")
    return backend, torch.device("cuda", local_rank % n_devices)


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None,
               backend: Optional[str] = None, device: str = "cuda",
               store=None) -> torch.device:
    """Join the process group; → this rank's device (made current on the
    card). The ranks come from the arguments, else from torchrun's
    environment. Without `store` the group rendezvouses through
    torchrun's MASTER_ADDR / MASTER_PORT."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    kind = torch.device(device).type
    n_devices = torch.cuda.device_count() if kind == "cuda" else 0
    backend, dev = plan(backend, kind, local_rank, local_world_size,
                        n_devices)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return dev


def setup(cfg):
    """The training scripts' first step. Under torchrun (WORLD_SIZE set)
    join the process group with cfg.dist_backend and put the run on this
    rank's device; then check cfg.mesh_shape against the world size
    (`parallel.mesh.make_mesh`). → cfg, with the rank's device."""
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dev = initialize(backend=cfg.dist_backend, device=cfg.device)
        cfg = cfg.replace(device=str(dev))
    from onpolicy_torch.parallel import mesh as mesh_lib
    mesh_lib.make_mesh(cfg.mesh_shape, cfg.device)
    return cfg


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    _MODEL_GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh_shape(cfg=None) -> Tuple[int, ...]:
    """The mesh spanning every rank. A 2-D (data, model) mesh keeps its
    model axis; only the data axis scales with the world size."""
    n = world_size()
    tp = cfg.mesh_shape[1] if cfg is not None and \
        len(cfg.mesh_shape) == 2 else 1
    if n % tp != 0:
        raise ValueError(f"model axis {tp} does not divide {n} ranks")
    return (n // tp, tp) if tp > 1 else (n,)


# model axis → this rank's model group, made once a process group
_MODEL_GROUPS = {}


def model_group(m: int):
    """This rank's group of the model axis `m`: ranks d·m .. d·m + m − 1.
    Every rank makes every group, in the same order (`dist.new_group` is
    collective over the world), once a process group."""
    if m not in _MODEL_GROUPS:
        n, mine = world_size(), None
        for d in range(n // m):
            ranks = list(range(d * m, (d + 1) * m))
            group = dist.new_group(ranks)
            if rank() in ranks:
                mine = group
        _MODEL_GROUPS[m] = mine
    return _MODEL_GROUPS[m]


def local_batch_slice(global_batch: int, size: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The [start, stop) block of the global batch that rank `index` of
    `size` (this process of the group, by default) owns: contiguous,
    rank-major."""
    size = world_size() if size is None else size
    index = rank() if index is None else index
    if global_batch % size != 0:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{size} ranks (D·M of the mesh: every rank of "
                         "the (data, model) mesh steps its own rows)")
    per = global_batch // size
    return slice(index * per, (index + 1) * per)


# ---- collectives ----------------------------------------------------------

def all_reduce_sum(tensors, mesh) -> list:
    """The sums over the ranks of `tensors` (one dtype, one device), in one
    all-reduce of a flat buffer; `mesh` None: the tensors themselves."""
    if mesh is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    return [p.view_as(t) for p, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def share_rows(mb: dict, mesh, sequences: bool) -> dict:
    """This rank's contiguous 1/R of a minibatch's rows: axis 1 of
    [L, B, ...] sequences (`sequences`), else axis 0; the rnn states
    [B, ...] on axis 0. `mesh` None or of one rank: `mb` itself."""
    if mesh is None or mesh.size == 1:
        return mb
    out = {}
    for k, x in mb.items():
        axis = 1 if sequences and k not in ("rnn_states",
                                            "rnn_states_critic") else 0
        n = x.shape[axis]
        if n % mesh.size != 0:
            raise ValueError(
                f"a minibatch of {n} rows (or chunks) does not split over "
                f"{mesh.size} ranks; choose n_rollout_threads, "
                "num_mini_batch and data_chunk_length so that it does")
        rows = mesh.rows(n)
        out[k] = x[:, rows] if axis == 1 else x[rows]
    return out


def sum_over_ranks(grads: list, aux: dict, mesh):
    """The gradients and the loss terms (each rank's part) summed over the
    ranks in one all-reduce; → (grads, aux detached)."""
    with profiling.span("update.allreduce", device=True):
        aux = {k: v.detach() for k, v in aux.items()}
        if mesh is None:
            return grads, aux
        keys = sorted(aux)
        out = all_reduce_sum(
            list(grads) + [aux[k] for k in keys], mesh)
        return out[:len(grads)], dict(zip(keys, out[len(grads):]))


def gather_rows(x, axis: int, mesh):
    """Every rank's rows of `x` (a tensor, or a dict of tensors that share
    the axis) concatenated along `axis` in rank order. Each rank writes its
    block into a zero-filled global buffer and the buffers are summed: one
    all-reduce a dtype, exact (it adds zeros), on NCCL and on gloo.
    `mesh` None: `x` itself."""
    if mesh is None:
        return x
    items = {"": x} if isinstance(x, torch.Tensor) else dict(x)
    out = {}
    by_dtype = {}
    for k, t in items.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    for dtype, keys in by_dtype.items():
        shapes = []
        for k in keys:
            shape = list(items[k].shape)
            shape[axis] *= mesh.size
            shapes.append(shape)
        flat = torch.zeros(sum(math.prod(s) for s in shapes), dtype=dtype,
                           device=items[keys[0]].device)
        views, at = [], 0
        for k, shape in zip(keys, shapes):
            n = math.prod(shape)
            view = flat[at:at + n].view(shape)
            at += n
            local = items[k]
            rows = local.shape[axis]
            view.narrow(axis, mesh.rank * rows, rows).copy_(local)
            views.append(view)
        dist.all_reduce(flat, group=mesh.group)
        out.update(zip(keys, views))
    return out[""] if isinstance(x, torch.Tensor) else out


def gather_model(leaves: list, dims: list, mesh) -> list:
    """This rank's blocks of parameter leaves → the full leaves, gathered
    over its model group: leaf i is cut along `dims[i]` into M blocks in
    model-rank order (None: replicated, given as it is). Each rank writes
    its blocks into a zero-filled buffer of the full leaves and the
    buffers are summed: one all-reduce a dtype, exact."""
    M, m = mesh.model_size, mesh.model_rank
    out = list(leaves)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    by_dtype = {}
    for i in sharded:
        by_dtype.setdefault(leaves[i].dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        shapes = []
        for i in idx:
            shape = list(leaves[i].shape)
            shape[dims[i]] *= M
            shapes.append(shape)
        flat = torch.zeros(sum(math.prod(s) for s in shapes), dtype=dtype,
                           device=leaves[idx[0]].device)
        at = 0
        for i, shape in zip(idx, shapes):
            n = math.prod(shape)
            view = flat[at:at + n].view(shape)
            at += n
            block = leaves[i].shape[dims[i]]
            view.narrow(dims[i], m * block, block).copy_(leaves[i])
            out[i] = view
        dist.all_reduce(flat, group=mesh.model_group)
    return out


def gather_objects(obj, mesh) -> list:
    """Every rank's picklable `obj`, in rank order; `mesh` None: [obj]."""
    if mesh is None:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def any_rank(flag: bool, mesh) -> bool:
    """Whether `flag` holds on some rank (one all-reduce)."""
    if mesh is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return bool(t.item() > 0)


# ---- draws at the global shape ------------------------------------------

class RowDraws:
    """The run generator's draws for this rank's rows. Each draw of shape
    [n, ...] is made at [n·R, ...] and cut to block `rank`, so R ranks
    whose rows are contiguous blocks of an env-major batch draw exactly
    what one process draws for the whole batch. `ops/distributions`
    draws through `rand` / `randn`."""

    def __init__(self, generator: torch.Generator, mesh):
        self.generator, self.size, self.rank = generator, mesh.size, mesh.rank

    def _draw(self, fn, shape, dtype, device):
        n = shape[0]
        full = fn((n * self.size, *shape[1:]), generator=self.generator,
                  dtype=dtype, device=device)
        return full[self.rank * n:(self.rank + 1) * n]

    def rand(self, shape, dtype=None, device=None):
        return self._draw(torch.rand, shape, dtype, device)

    def randn(self, shape, dtype=None, device=None):
        return self._draw(torch.randn, shape, dtype, device)


# ---- reductions over the global minibatch ----------------------------------

# The mesh of the update running in this process, set by `global_batch`
# for its extent (as torch.no_grad sets its mode): the batch reductions
# sit deep in the model code (each action head's entropy), which takes no
# mesh of its own.
_BATCH_MESH = None


@contextlib.contextmanager
def global_batch(mesh):
    """Within: the batch reductions of the loss (`batch_total`,
    `batch_mean`) reduce over the ranks of `mesh`, each rank holding its
    share of the minibatch's rows. `mesh` None: one process, no
    collective."""
    global _BATCH_MESH
    outer, _BATCH_MESH = _BATCH_MESH, mesh
    try:
        yield
    finally:
        _BATCH_MESH = outer


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of a value that does not need a gradient
    (a mask's sum: a denominator of the whole minibatch)."""
    if _BATCH_MESH is None:
        return x
    return all_reduce_sum([x.detach()], _BATCH_MESH)[0]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's part of the mean over the whole minibatch, whose shares
    are equal: its mean over R. The parts add up to the mean."""
    if _BATCH_MESH is None or _BATCH_MESH.size == 1:
        return x.mean()
    return x.mean() / _BATCH_MESH.size
