"""The port's 2-D (data, model) mesh on torch.distributed, on the CPU.

Two jobs of gloo ranks (`tests/test_torch_dp_worker.py`, worker
processes joined through a `FileStore` under tmp_path; they import no
JAX): "model12" on 2 ranks at mesh (1, 2) and "model22" on 4 at (2, 2).
Each runs the MPE cases of `test_torch_dp_worker.DEVICE_CASES` and MAPPO
with PopArt through `train_mpe.make_runner(...).run`; "model12" also the
host cases (`HostSharedRunner` rMAPPO, `HostSeparatedRunner` HAPPO, 4 envs
a rank) and the resume of a one-process checkpoint, "model22" also the
trainers on two episodes of JAX's own (2, 2) mesh. Held:

* each case trains what one process trains over the same global envs:
  the parameters at rtol 2e-4 / atol 2e-5 (the JAX package's tolerance of
  tests/test_sharding.py) and every logged metric; the ranks' gathered
  parameters bit for bit alike (rmappo_chunks runs at 8 threads, T=17
  and L=10 on 4 ranks, against one process at the same flags:
  `test_torch_dp_worker.FOUR_RANKS` says why);
* each rank keeps only its blocks: every parameter and moment leaf the
  leaf rule shards is 1/M of the full leaf, the block at its model rank,
  bit for bit, and the model group's gather gives the full leaf back;
* rMAPPO's trainer and the separated HAPPO update at (2, 2) give what
  JAX's (2, 2) mesh trains on the same episode (its buffers, states and
  permutations captured), at the same tolerance;
* rank 0 writes the checkpoint one process writes; a one-process
  checkpoint resumes under (1, 2) and a (2, 2) one in one process.

Also, in this process: the leaf rule against JAX's `_param_spec` (the
shapes of test_sharding.py and the flagship's real trees, placed by
JAX's `model_sharded_state`), the cut and the gather on one process, and
the refusals (a model axis that does not divide the world, an env batch
that does not split over D·M).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.parallel import mesh as j_mesh
from onpolicy_tpu.runner.separated_runner import \
    SeparatedRunner as JaxSeparatedRunner
from onpolicy_tpu.runner.shared_runner import SharedRunner as JaxRunner

from onpolicy_torch import buffer as t_buf
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.parallel import distributed, mesh as mesh_lib
from onpolicy_torch.utils.params import (_find_adam, train_state_from_jax,
                                         train_state_to_jax)
from onpolicy_torch.utils.tree import tree_leaves
from tests import test_torch_dp_worker as w
from tests.test_torch_parallel import (DP, JAX_FLAGS, _jax_episode,
                                       assert_ranks_agree,
                                       assert_trains_like, collect, spawn)

torch.set_num_threads(1)

SHAPES = {"model12": (1, 2), "model22": (2, 2)}
# JAX's (2, 2) episodes: rMAPPO as tests/test_torch_parallel.py's but 8
# envs (24 chunks: 2 minibatches of 12, 3 a rank), and the separated HAPPO
# episode of tests/test_sharding.py:56-68 in its agent order
JAX22_FLAGS = {**JAX_FLAGS, "n_rollout_threads": 8, "num_env_steps": 80}
SEPARATED_FLAGS = dict(algorithm_name="happo", scenario_name="simple_spread",
                       n_rollout_threads=8, episode_length=10,
                       num_env_steps=80, ppo_epoch=2, hidden_size=32,
                       share_policy=False)
ORDER = (1, 0, 2)
MPE_CASES = [*w.DEVICE_CASES, "mappo_popart"]
CASES = ([(job, name) for job in SHAPES for name in MPE_CASES]
         + [("model12", "rmappo_resumed")]
         + [("model12", name) for name in w.HOST_CASES])


def _jax_separated(path):
    """The separated HAPPO episode on JAX's (2, 2) mesh, jitted, each
    agent's buffer captured at its trainer (as outputs), saved for the
    ranks with the states it started from; → (JAX's trained states, its
    metrics)."""
    cfg = j_canon(JaxConfig(**SEPARATED_FLAGS,
                            mesh_shape=(2, 2))).validate()
    runner = JaxSeparatedRunner(cfg)
    states, carry = runner.init(jax.random.PRNGKey(0))
    trains = [algo.train for algo in runner.algos]

    def episode(states, carry, key):
        captured = {}
        for i, algo in enumerate(runner.algos):
            def capture(ts, buf, key, factor=None, i=i, train=trains[i]):
                captured[i] = buf
                return train(ts, buf, key, factor=factor)
            algo.train = capture
        try:
            new_states, _, metrics = runner._episode(ORDER, states, carry,
                                                     key)
        finally:
            for algo, train in zip(runner.algos, trains):
                algo.train = train
        return new_states, metrics, [captured[i] for i in range(len(states))]
    new_states, metrics, bufs = jax.device_get(jax.jit(episode)(
        states, carry, jax.random.PRNGKey(1)))
    torch.save({
        "flags": SEPARATED_FLAGS, "order": ORDER,
        "states": [train_state_from_jax(jax.device_get(s)) for s in states],
        "bufs": [{k: None if getattr(b, k) is None else
                  torch.tensor(np.asarray(getattr(b, k)))
                  for k in t_buf.RolloutBuffer.__dataclass_fields__}
                 for b in bufs]}, path)
    return new_states, metrics


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp2d")
    one_models = str(tmp / "one" / "models")
    one = {"rmappo_chunks": w.run_device_case("rmappo_chunks", 1,
                                              one_models)}
    procs = {"model12": spawn(tmp, "model12", (one_models,), ranks=2)}
    try:
        jax_state, jax_metrics = _jax_episode(tmp / "jax22.pt", JAX22_FLAGS,
                                              (2, 2))
        sep_states, sep_metrics = _jax_separated(tmp / "sep22.pt")
        procs["model22"] = spawn(
            tmp, "model22", (one_models, str(tmp / "jax22.pt"),
                             str(tmp / "sep22.pt")), ranks=4)
        for name in MPE_CASES[1:]:
            one[name] = w.run_device_case(name, 1)
        one["rmappo_resumed"] = w.run_device_case(
            "rmappo_chunks", 1, model_dir=one_models, episodes=3)
        for name in w.HOST_CASES:
            one[name] = w.run_host_case(name, 1)
        # the one-process references of the cases whose flags 4 ranks
        # change
        four_models = str(tmp / "one4" / "models")
        one4 = {name: w.run_device_case(
            name, 1, four_models if name == "rmappo_chunks" else None,
            four_ranks=True) for name in w.FOUR_RANKS}
        one4["rmappo_resumed"] = w.run_device_case(
            "rmappo_chunks", 1, model_dir=four_models, episodes=3,
            four_ranks=True)
    finally:
        ranks = {job: collect(*p, timeout=600) for job, p in procs.items()}
    # the checkpoint that rank 0 of (2, 2) wrote, resumed in one process
    resumed22 = w.run_device_case(
        "rmappo_chunks", 1, model_dir=str(tmp / "model22_models"),
        episodes=3, four_ranks=True)
    return dict(ranks=ranks, one=one, one4=one4, resumed22=resumed22,
                tmp=tmp, jax_state=jax_state, jax_metrics=jax_metrics,
                sep_states=sep_states, sep_metrics=sep_metrics)


def _reference(jobs, job, name):
    if job == "model22" and name in w.FOUR_RANKS:
        return jobs["one4"][name]
    return jobs["one"][name]


@pytest.mark.parametrize("job,name", CASES)
def test_the_mesh_trains_what_one_process_trains(jobs, job, name):
    """rmappo_resumed: (1, 2) restores the one-process checkpoint (cut to
    each rank's blocks and envs) for a third episode, against one process
    restoring it."""
    ranks, one = jobs["ranks"][job], _reference(jobs, job, name)
    assert_ranks_agree(ranks, name)
    got = ranks[0][name]
    assert got["N"] * len(ranks) == one["N"]   # the rows split over D·M
    assert got["episodes"] == one["episodes"]
    assert_trains_like(got, one, name)


@pytest.mark.parametrize("job,name", CASES)
def test_each_rank_keeps_only_its_blocks(jobs, job, name):
    """Parameters and both moments: a leaf the rule shards is kept as the
    block at the rank's model rank, 1/M of the leaf, bit for bit that
    block of the gathered whole; the gathered whole is every rank's, bit
    for bit; ranks of one model rank keep equal blocks."""
    ranks, M = jobs["ranks"][job], SHAPES[job][1]
    first = ranks[0][name]
    assert any(d is not None for d in first["dims"])
    by_model_rank = {}
    for r, rec in enumerate(x[name] for x in ranks):
        assert rec["model_rank"] == r % M
        assert rec["dims"] == first["dims"]
        assert len(rec["kept"]) == len(rec["full"]) == len(rec["dims"])
        for i, (kept, full, d) in enumerate(zip(rec["kept"], rec["full"],
                                                rec["dims"])):
            assert torch.equal(full, first["full"][i]), (name, i, r)
            if d is None:
                assert torch.equal(kept, full), (name, i)
                continue
            want = list(full.shape)
            want[d] //= M
            assert list(kept.shape) == want, (name, i, kept.shape)
            assert torch.equal(kept, full.chunk(M, d)[r % M]), (name, i)
        prev = by_model_rank.setdefault(r % M, rec["kept"])
        assert all(torch.equal(a, b) for a, b in zip(prev, rec["kept"]))


def test_2x2_trains_what_the_jax_2x2_mesh_trains(jobs):
    want = jobs["jax_state"]
    got = [r["jax_episode"] for r in jobs["ranks"]["model22"]]
    back = [train_state_to_jax(g["state"], want) for g in got]
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        leaves = jax.tree_util.tree_leaves(getattr(want, part))
        for r in back:
            for i, (a, b) in enumerate(zip(
                    jax.tree_util.tree_leaves(getattr(r, part)), leaves)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           err_msg=f"{part}[{i}]", **DP)
    assert all(g["metrics"] == got[0]["metrics"] for g in got)
    for k, v in got[0]["metrics"].items():
        np.testing.assert_allclose(v, jobs["jax_metrics"][k], err_msg=k,
                                   **DP)


def test_2x2_separated_happo_trains_what_the_jax_2x2_mesh_trains(jobs):
    want = jobs["sep_states"]
    got = [r["jax_separated"] for r in jobs["ranks"]["model22"]]
    for g in got:
        assert g["metrics"] == got[0]["metrics"]
        for i, (s, j) in enumerate(zip(g["states"], want)):
            back = train_state_to_jax(s, j)
            for a, b in zip(jax.tree_util.tree_leaves(back),
                            jax.tree_util.tree_leaves(j)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           err_msg=f"agent {i}", **DP)
    metrics = jobs["sep_metrics"]
    for i in range(len(want)):
        for k, v in metrics[f"agent{i}"].items():
            np.testing.assert_allclose(got[0]["metrics"][f"agent{i}/{k}"],
                                       np.asarray(v), err_msg=f"{i} {k}",
                                       **DP)


@pytest.mark.parametrize("job", list(SHAPES))
def test_rank0_writes_the_one_process_checkpoint(jobs, job):
    """The same file layout (state, step, generators, the global carry),
    the whole state within the tolerance of one process's."""
    tmp = jobs["tmp"]
    one = "one4" if job == "model22" else "one"
    (got,), (want,) = [sorted((tmp / d).glob("ckpt_*.pt"))[-1:]
                       for d in (f"{job}_models", f"{one}/models")]
    assert got.name == want.name == "ckpt_2.pt"
    a, b = [torch.load(p, weights_only=True) for p in (got, want)]
    assert a.keys() == b.keys() and a["step"] == b["step"]
    for k in b["generators"]:
        assert torch.equal(a["generators"][k], b["generators"][k]), k
    flat = lambda d: {f"{k}/{i}": x for k, v in sorted(d.items())
                      for i, x in enumerate(tree_leaves(v))}
    for part in ("state", "carry"):
        sa, sb = flat(a[part]), flat(b[part])
        assert sa.keys() == sb.keys()
        for k, v in sb.items():
            assert sa[k].shape == v.shape, k
            np.testing.assert_allclose(sa[k].numpy(), v.numpy(),
                                       err_msg=f"{part} {k}", **DP)


def test_a_2x2_checkpoint_resumes_in_one_process(jobs):
    assert_trains_like(jobs["resumed22"], jobs["one4"]["rmappo_resumed"],
                       "rmappo_resumed")


# ---- the leaf rule, the cut and the gather, the refusals -----------------

def _spec_dim(spec):
    """The dimension a PartitionSpec shards along 'model', or None."""
    return next((i for i, a in enumerate(spec) if a == j_mesh.MODEL_AXIS),
                None)


@pytest.mark.parametrize("shape", [(18, 32), (32, 1), (32,), (3, 5), ()])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_the_leaf_rule_is_jaxs_param_spec(shape, m):
    want = _spec_dim(j_mesh._param_spec(jnp.zeros(shape), m))
    assert mesh_lib.param_dim(shape, m) == want


def _jax_flagship():
    cfg = j_canon(JaxConfig(
        algorithm_name="rmappo", scenario_name="simple_spread",
        num_agents=3, num_landmarks=3, n_rollout_threads=2, episode_length=5,
        hidden_size=64, use_ReLU=False)).validate()
    state, _ = JaxRunner(cfg).init(jax.random.PRNGKey(0))
    return state


def test_the_leaf_rule_places_the_flagship_as_jax_does():
    """The flagship's actor and critic and both Adam moments, at M=2: the
    port's dims are those of JAX's `model_sharded_state` on a (1, 2)
    mesh, leaf for leaf; a CNN kernel's by its JAX (HWIO) layout."""
    state = _jax_flagship()
    placed = j_mesh.model_sharded_state(j_mesh.make_mesh((1, 2)), state)
    port = train_state_from_jax(jax.device_get(state))
    for p, o in (("actor_params", "actor_opt_state"),
                 ("critic_params", "critic_opt_state")):
        want = [_spec_dim(x.sharding.spec)
                for x in jax.tree_util.tree_leaves(getattr(placed, p))]
        got = mesh_lib.leaf_dims(getattr(port, p), 2)
        assert got == want, p
        assert any(d is not None for d in got)
        adam = _find_adam(getattr(placed, o))
        for moment in ("mu", "nu"):
            assert [_spec_dim(x.sharding.spec) for x in
                    jax.tree_util.tree_leaves(getattr(adam, moment))] == want
    conv = {"conv": {"w": torch.zeros(6, 3, 3, 3), "b": torch.zeros(6)}}
    hwio = jnp.zeros((3, 3, 3, 6))
    assert _spec_dim(j_mesh._param_spec(hwio, 2)) == 3        # HWIO's O
    assert mesh_lib.leaf_dims(conv, 2) == [0, 0]               # OIHW's O
    assert mesh_lib.leaf_dims(conv, 4) == [None, None]


def test_cut_and_gather_round_trip_bitwise(monkeypatch):
    """The flagship state cut for model ranks 0 and 1 of M=2: the blocks
    are copies that hold 1/M of each sharded leaf and tile it; the gather
    (its all-reduce done by hand over the two ranks' buffers) gives the
    whole state back bit for bit."""
    from onpolicy_torch.algorithms.mappo import TrainState
    whole = train_state_from_jax(jax.device_get(_jax_flagship()))
    fields = (("actor_params", "actor_opt_state"),
              ("critic_params", "critic_opt_state"))
    shards = [mesh_lib.StateShards(mesh_lib.DataMesh(
        size=2, rank=m, device=torch.device("cpu"), model_size=2,
        model_rank=m), fields) for m in range(2)]
    kept = [s.cut(whole) for s in shards]
    assert all(isinstance(k, TrainState) for k in kept)
    leaves = lambda st: tree_leaves(
        (st.actor_params, st.critic_params, st.actor_opt_state,
         st.critic_opt_state))
    full = leaves(whole)
    dims = shards[0].layouts["actor_params"].dims
    assert dims == mesh_lib.leaf_dims(whole.actor_params, 2)
    for k in kept:
        assert sum(x.numel() for x in leaves(k)) < sum(
            x.numel() for x in full)
    sharded = 0
    for i, x in enumerate(full):
        a, b = leaves(kept[0])[i], leaves(kept[1])[i]
        if a.shape == x.shape:
            assert torch.equal(a, x) and torch.equal(b, x)
            continue
        sharded += 1
        d = next(j for j in range(x.ndim) if a.shape[j] != x.shape[j])
        assert torch.equal(torch.cat([a, b], d), x)
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
    assert sharded > 0

    buffers = []
    monkeypatch.setattr(distributed.dist, "all_reduce",
                        lambda t, group=None: buffers.append(t))
    gathered = [s.full(k) for s, k in zip(shards, kept)]
    assert len(buffers) == 2                 # one collective a gather
    total = buffers[0] + buffers[1]
    for b in buffers:
        b.copy_(total)
    for g in gathered:
        for a, b in zip(leaves(g), full):
            assert torch.equal(a, b)
        assert torch.equal(g.vnorm.running_mean, whole.vnorm.running_mean)


def _cfg(**kw):
    return canonicalize_algorithm(Config(**{
        "algorithm_name": "rmappo", "device": "cpu", "n_rollout_threads": 4,
        "episode_length": 5, "hidden_size": 16, **kw}))


def test_a_model_axis_that_does_not_divide_the_world_is_refused(
        monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 6)
    assert distributed.global_mesh_shape(_cfg(mesh_shape=(1, 2))) == (3, 2)
    assert distributed.global_mesh_shape(_cfg(mesh_shape=(9, 3))) == (2, 3)
    assert distributed.global_mesh_shape() == (6,)
    with pytest.raises(ValueError, match="model axis 4 does not divide 6"):
        distributed.global_mesh_shape(_cfg(mesh_shape=(1, 4)))
    with pytest.raises(ValueError, match=r"D·M = 4 ranks.*has 6"):
        mesh_lib.make_mesh((2, 2))


def test_an_env_batch_that_does_not_split_over_the_mesh_is_refused():
    mesh = mesh_lib.DataMesh(size=4, rank=3, device=torch.device("cpu"),
                             model_size=2, model_rank=1)
    with pytest.raises(ValueError, match=r"does not split over 4 ranks "
                                         r"\(D·M"):
        make_vec_env(_cfg(n_rollout_threads=6), torch.device("cpu"),
                     torch.Generator(), mesh=mesh)
    env = make_vec_env(_cfg(n_rollout_threads=8), torch.device("cpu"),
                       torch.Generator(), mesh=mesh)
    assert (env.n_envs, env.rows) == (2, slice(6, 8))
