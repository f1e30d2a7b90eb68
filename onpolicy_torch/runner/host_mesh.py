"""Data parallelism for the host-ingestion runners.

Port of `onpolicy_tpu/runner/host_mesh.py:36-113`. There the staged
episode goes to the devices once an episode with its env axis sharded
along 'data', each process contributing its local rows, and XLA inserts
the psums of the update. Here each rank of the process group
(`parallel/distributed.py`) owns a local pool of `n_rollout_threads`
envs: the global env batch is n_rollout_threads × ranks (JAX's
multi-process rule, `host_mesh.py:43` there), and env i of rank r is
global env r·n + i (`env_offset`), which is how the scripts seed it. A
rank acts for its envs with its rows of each global draw
(`distributed.RowDraws`); the staged blocks, the policy's outputs and the
last slot are gathered rank-major into the whole episode before the
returns and the update, which every rank runs on its share of each
minibatch (`algorithms/mappo.py`). The envs' infos are gathered for the
env metrics (`gather_infos`).

The mesh is `parallel.mesh.make_mesh`'s, and the episode's gather is
`distributed.gather_rows` on the env axis. JAX's `shard_state` (the
state replicated, or model-sharded on a 2-D mesh) is the trainers' own
cut (`parallel/mesh.StateShards`, applied by `init_state` and by the
restore), and its `act_state` (a process-local copy of the parameters
for acting) is the copy `runner/host_runner.py` gathers over the model
group once an update. JAX refuses to act across processes with
model-sharded parameters, because its global arrays need every host to
pass the same values; the port's ranks each act on their own envs with
their gathered copy, which is what JAX's single-process (2, 2) host run
computes, so the refusal is not carried (ROADMAP.md, Queue 3).
`put_batched` needs no counterpart: nothing is placed, the gathers take
its place.
"""
from __future__ import annotations

from onpolicy_torch.parallel import distributed


def env_offset(n_envs: int) -> int:
    """The global index of this rank's first env."""
    return distributed.rank() * n_envs


def gather_infos(mesh, infos: list) -> list:
    """This rank's per-env infos → every rank's, rank-major."""
    return [i for part in distributed.gather_objects(list(infos), mesh)
            for i in part]
