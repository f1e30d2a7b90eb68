"""The data mesh: R processes on the `data` axis.

Port of `onpolicy_tpu/parallel/mesh.py:35-46`. JAX's 1-D mesh `(data,)`
shards the env batch over R devices and replicates the parameters; XLA
turns the gradient and normalizer reductions into psums over 'data'.
Here the R devices are R processes of one torch.distributed group
(`parallel/distributed.py`), and `make_mesh` returns a record of the
group: its size, this process's rank, the device and the group.

JAX's placement helpers (`replicated`, `data_sharded`,
`shard_train_inputs`, `model_sharded_state`) have no counterpart: every
rank builds the same replicated parameters from the seed, and the
runners and trainers take the mesh record and do the rest (the rank's
env rows, the gathered episode, each minibatch's share, the summed
gradients). The 2-D `(data, model)` tensor-parallel mesh is not ported
(ROADMAP.md, Slice G2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from onpolicy_torch.parallel import distributed

G2_REFUSAL = "not ported yet: (data, model) mesh (ROADMAP.md, Slice G2)"


@dataclass(frozen=True)
class DataMesh:
    size: int                 # R, the ranks on the data axis
    rank: int                 # this process's rank
    device: torch.device      # this rank's device
    group: Any = None         # the process group (None: the default one)

    def rows(self, global_batch: int) -> slice:
        """This rank's block of a global batch of rows (or envs)."""
        return distributed.local_batch_slice(global_batch, self.size,
                                             self.rank)


def check_shape(mesh_shape) -> Tuple[int, ...]:
    """A 1-D `(data,)` mesh shape, or a 2-D one whose model axis is 1;
    a model axis over 1 raises NotImplementedError (Slice G2)."""
    shape = tuple(int(x) for x in mesh_shape)
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"mesh_shape must be (data,) or (data, model), "
                         f"got {shape}")
    if len(shape) == 2 and shape[1] > 1:
        raise NotImplementedError(G2_REFUSAL)
    return shape


def make_mesh(mesh_shape=(1,), device="cpu") -> Optional[DataMesh]:
    """The mesh of `mesh_shape` over the process group, or None for one
    process without a group (no collective at all). The data axis must
    equal the world size; under torchrun at world size 1 the mesh is
    made, and its collectives run."""
    shape = check_shape(mesh_shape)
    ranks = distributed.world_size()
    if shape[0] != ranks:
        raise ValueError(
            f"mesh_shape {shape} asks for {shape[0]} ranks on the data "
            f"axis, but the process group has {ranks} (WORLD_SIZE); launch "
            f"with torchrun --nproc_per_node {shape[0]} ... --mesh_shape "
            f"{shape[0]}")
    if not dist.is_initialized():
        return None
    return DataMesh(size=ranks, rank=dist.get_rank(),
                    device=torch.device(device))
