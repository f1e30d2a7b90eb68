"""Data-parallel training of the port on torch.distributed, on the CPU.

One job of two gloo ranks (`tests/test_torch_dp_worker.py`, worker
processes joined through a `FileStore` under tmp_path; they import no
JAX) runs:

* the MPE cases of `test_torch_dp_worker.DEVICE_CASES` through
  `train_mpe.make_runner(...).run`: shared rMAPPO at 2 minibatches whose
  chunks straddle agents, episodes and ranks (a rank's N·M·T is no
  multiple of L), MAPPO at 2 minibatches, MAPPO with the critic dedup,
  MAT at 2 minibatches, separated HAPPO and HATRPO. Each must train what
  one process trains over the same global envs: the parameters at rtol
  2e-4 / atol 2e-5 (the JAX package's tolerance of
  tests/test_sharding.py) and every logged metric, the two ranks' bit for
  bit alike;
* rMAPPO's trainer on one episode of the JAX package's runner on a mesh
  of (2,) virtual CPU devices, with JAX's permutations: the trained state
  and the metrics within TRAINED (1e-4 / 5e-5) of JAX's.

The one-process references run here while the workers run. Also the
refusals: a 2-D mesh whose D·M is not the world size, a mesh_shape
other than the world size, an env batch or a minibatch that does not
split, NCCL with two ranks on one card, and the Hanabi runner (JAX's
has no mesh path).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.runner.shared_runner import SharedRunner as JaxRunner

from onpolicy_torch import buffer as t_buf
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.parallel import distributed, mesh as mesh_lib
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         train_state_to_jax)
from tests import test_torch_dp_worker as w

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DP = dict(rtol=2e-4, atol=2e-5)
TRAINED = dict(rtol=1e-4, atol=5e-5)
# JAX's episode: rMAPPO, 4 envs sharded 2 a device, T=10, L=10, 2
# minibatches of 6 chunks (3 a rank)
JAX_FLAGS = dict(algorithm_name="rmappo", scenario_name="simple_spread",
                 num_agents=3, num_landmarks=3, n_rollout_threads=4,
                 episode_length=10, num_env_steps=40, hidden_size=16,
                 data_chunk_length=10, ppo_epoch=3, num_mini_batch=2,
                 use_ReLU=False, lr=7e-4, critic_lr=7e-4)


def spawn(tmp_path, job, extra=(), env=None, ranks=2):
    """Start the `ranks` ranks of `job`; → (processes, output paths)."""
    store = str(tmp_path / f"{job}_store")
    outs = [tmp_path / f"{job}_rank{r}.pt" for r in range(ranks)]
    env = {**os.environ, "PYTHONPATH": str(REPO), "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "test_torch_dp_worker.py"),
         str(r), str(ranks), store, job, str(outs[r]), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(ranks)]
    return procs, outs


def collect(procs, outs, timeout=240):
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), \
        "a rank failed:\n" + "\n----\n".join(logs)
    return [torch.load(o, weights_only=False) for o in outs]


def assert_ranks_agree(ranks, name):
    """Every rank trained the same parameters, bit for bit."""
    for r in ranks[1:]:
        for i, (a, b) in enumerate(zip(ranks[0][name]["params"],
                                       r[name]["params"])):
            assert torch.equal(a, b), f"{name}: leaf {i} differs by rank"


def assert_trains_like(got, want, name, tol=DP):
    assert len(got["params"]) == len(want["params"])
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"{name} leaf {i}", **tol)
    assert [r.keys() for r in got["rows"]] == [r.keys() for r in want["rows"]]
    for g, r in zip(got["rows"], want["rows"]):
        for k, v in r.items():
            np.testing.assert_allclose(g[k], v, err_msg=f"{name} {k}", **tol)


def _jax_episode(path, flags=JAX_FLAGS, mesh_shape=(2,)):
    """One jitted episode of JAX's runner at `flags` on a `mesh_shape`
    mesh, its buffer and key captured at the trainer (as outputs of the
    jitted episode), saved for the ranks; → (JAX's trained state, its
    metrics)."""
    cfg = j_canon(JaxConfig(**flags, mesh_shape=mesh_shape)).validate()
    jr = JaxRunner(cfg)
    state, carry = jr.init(jax.random.PRNGKey(0))
    assert len(jr.mesh.devices.flat) == np.prod(mesh_shape)
    train = jr.algo.train

    def episode(state, carry, key):
        captured = {}

        def capture(ts, buf, key, factor=None):
            captured.update(buf=buf, key=key)
            return train(ts, buf, key, factor)
        jr.algo.train = capture
        try:
            new_state, _, metrics = jr._episode(state, carry, key)
        finally:
            jr.algo.train = train
        return new_state, metrics, captured["buf"], captured["key"]
    new_state, metrics, buf, key = jax.jit(episode)(
        state, carry, jax.random.PRNGKey(7))
    buf = jax.device_get(buf)
    n_chunks = (flags["episode_length"] * flags["n_rollout_threads"]
                * flags["num_agents"] // flags["data_chunk_length"])
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, n_chunks)))
             for k in jax.random.split(key, flags["ppo_epoch"])]
    torch.save({
        "flags": flags, "perms": perms,
        "state": train_state_from_jax(jax.device_get(state)),
        "buf": {k: None if getattr(buf, k) is None else
                torch.tensor(np.asarray(getattr(buf, k)))
                for k in t_buf.RolloutBuffer.__dataclass_fields__}}, path)
    return jax.device_get(new_state), {k: float(v)
                                       for k, v in metrics.items()}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    given = tmp / "jax_episode.pt"
    jax_state, jax_metrics = _jax_episode(given)
    procs, outs = spawn(tmp, "device", (str(given),))
    try:
        models = str(tmp / "one" / "models")
        one = {name: w.run_device_case(
            name, 1, models if name == "rmappo_chunks" else None)
            for name in w.DEVICE_CASES}
        one["rmappo_resumed"] = w.run_device_case(
            "rmappo_chunks", 1, model_dir=models, episodes=3)
    finally:
        ranks = collect(procs, outs)
    return dict(ranks=ranks, one=one, tmp=tmp, jax_state=jax_state,
                jax_metrics=jax_metrics)


@pytest.mark.parametrize("name", [*w.DEVICE_CASES, "rmappo_resumed"])
def test_two_ranks_train_what_one_trains(job, name):
    """rmappo_resumed: each run restores its own checkpoint (the 2-rank
    one written by rank 0, cut to each rank's envs) for a third episode."""
    ranks, one = job["ranks"], job["one"][name]
    assert_ranks_agree(ranks, name)
    got = ranks[0][name]
    assert got["N"] * 2 == one["N"]          # each rank steps half the envs
    assert got["episodes"] == one["episodes"]
    assert_trains_like(got, one, name)


def test_two_ranks_train_what_the_jax_mesh_trains(job):
    want = job["jax_state"]
    got = [r["jax_episode"] for r in job["ranks"]]
    back = [train_state_to_jax(g["state"], want) for g in got]
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        leaves = jax.tree_util.tree_leaves(getattr(want, part))
        for r in back:
            for i, (a, b) in enumerate(zip(
                    jax.tree_util.tree_leaves(getattr(r, part)), leaves)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           err_msg=f"{part}[{i}]", **TRAINED)
    assert got[0]["metrics"] == got[1]["metrics"]
    for k, v in got[0]["metrics"].items():
        np.testing.assert_allclose(v, job["jax_metrics"][k], err_msg=k,
                                   **TRAINED)


def test_checkpoint_holds_the_global_carry(job):
    """Rank 0 alone writes; its checkpoint holds every rank's envs, as the
    one-process run's does, and the same generators."""
    tmp = job["tmp"]
    (two,), (one,) = [sorted((tmp / d / "models").glob("ckpt_*.pt"))[-1:]
                      for d in (".", "one")]
    assert two.name == one.name == "ckpt_2.pt"
    load = lambda p: torch.load(p, weights_only=True)
    a, b = load(two), load(one)
    assert a["step"] == b["step"]
    for k in a["generators"]:
        assert torch.equal(a["generators"][k], b["generators"][k]), k
    flat = lambda c: {k: v for k, v in sorted(c.items()) if k != "env_states"}
    for k, v in flat(b["carry"]).items():
        np.testing.assert_allclose(a["carry"][k].numpy(), v.numpy(),
                                   err_msg=k, **DP)
    for k, v in b["carry"]["env_states"].items():
        np.testing.assert_allclose(a["carry"]["env_states"][k].numpy(),
                                   v.numpy(), err_msg=k, **DP)


# ---- refusals and the pieces ---------------------------------------------

def _cfg(**kw):
    return canonicalize_algorithm(Config(**{
        "algorithm_name": "rmappo", "device": "cpu", "n_rollout_threads": 4,
        "episode_length": 5, "hidden_size": 16, **kw}))


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_the_2d_mesh_names_slice_g2(shape):
    """The (data, model) mesh of Slice G2 is ported: in one process it
    asks for D·M ranks that the world (WORLD_SIZE 1) does not have, and
    says how to launch them (tests/test_torch_parallel_2d.py runs it)."""
    n = shape[0] * shape[1]
    with pytest.raises(ValueError, match=rf"WORLD_SIZE.*--nproc_per_node "
                                         rf"{n} .* --mesh_shape "
                                         rf"{shape[0]},{shape[1]}"):
        mesh_lib.make_mesh(shape)


def test_mesh_shape_must_equal_the_world_size():
    from onpolicy_torch.scripts.train_mpe import make_runner
    assert mesh_lib.make_mesh((1,)) is None    # one process, no group
    assert distributed.global_mesh_shape() == (1,)
    assert distributed.global_mesh_shape(_cfg(mesh_shape=(1, 1))) == (1,)
    assert (distributed.world_size(), distributed.rank()) == (1, 0)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        make_runner(_cfg(mesh_shape=(2,)))
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        distributed.setup(_cfg(mesh_shape=(4,)))


def test_an_env_batch_that_does_not_split_is_refused():
    assert distributed.local_batch_slice(8, 2, 1) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        distributed.local_batch_slice(5, 2, 0)
    mesh = mesh_lib.DataMesh(size=2, rank=1, device=torch.device("cpu"))
    cfg = _cfg(n_rollout_threads=5)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        make_vec_env(cfg, torch.device("cpu"), torch.Generator(), mesh=mesh)
    env = make_vec_env(_cfg(n_rollout_threads=6), torch.device("cpu"),
                       torch.Generator(), mesh=mesh)
    assert (env.n_envs, env.rows, env.n_draw) == (3, slice(3, 6), 6)


def test_a_minibatch_that_does_not_split_is_refused():
    mesh = mesh_lib.DataMesh(size=2, rank=1, device=torch.device("cpu"))
    mb = {"obs": torch.arange(20.).reshape(2, 5, 2),
          "rnn_states": torch.zeros(5, 1, 4)}
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        distributed.share_rows(mb, mesh, sequences=True)
    mb = {"obs": torch.arange(16.).reshape(2, 4, 2),
          "rnn_states": torch.arange(4.).reshape(4, 1, 1)}
    got = distributed.share_rows(mb, mesh, sequences=True)
    assert torch.equal(got["obs"], mb["obs"][:, 2:])
    assert torch.equal(got["rnn_states"], mb["rnn_states"][2:])


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="Duplicate GPU detected"):
        distributed.plan("nccl", "cuda", 1, 2, 1)
    assert distributed.plan("gloo", "cuda", 1, 2, 1) == (
        "gloo", torch.device("cuda", 0))
    assert distributed.plan(None, "cuda", 1, 2, 2) == (
        "nccl", torch.device("cuda", 1))
    assert distributed.plan(None, "cpu", 3, 4, 0) == (
        "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="needs CUDA devices"):
        distributed.plan("nccl", "cpu", 0, 1, 0)
    with pytest.raises(ValueError, match="dist_backend must be one of"):
        distributed.plan("mpi", "cpu", 0, 1, 0)


def test_row_draws_cut_the_global_draw():
    """A rank's draws are its block of the one-process draw of the global
    batch (6 rows, 3 a rank), in the generator's order."""
    g = torch.Generator().manual_seed(11)
    full = torch.rand((6, 5), generator=g), torch.randn((6, 2), generator=g)
    for rank in range(2):
        d = distributed.RowDraws(
            torch.Generator().manual_seed(11),
            mesh_lib.DataMesh(size=2, rank=rank, device=None))
        rows = slice(3 * rank, 3 * rank + 3)
        assert torch.equal(d.rand((3, 5)), full[0][rows])
        assert torch.equal(d.randn((3, 2)), full[1][rows])


def test_the_hanabi_runner_refuses_the_mesh():
    from onpolicy_torch.runner.hanabi_runner import HanabiRunner
    cfg = canonicalize_algorithm(Config(
        algorithm_name="rmappo", env_name="Hanabi", device="cpu",
        mesh_shape=(2,)))
    with pytest.raises(ValueError, match="no mesh path"):
        HanabiRunner(cfg)
