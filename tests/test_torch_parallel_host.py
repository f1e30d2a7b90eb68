"""Data-parallel training of the port's host runners and training
scripts on torch.distributed, on the CPU.

One job of two gloo ranks (`tests/test_torch_dp_worker.py`, worker
processes joined through a `FileStore` under tmp_path; they import no
JAX) runs:

* the host cases of `test_torch_dp_worker.HOST_CASES`: `HostSharedRunner`
  rMAPPO at 2 minibatches over worker-process pools and
  `HostSeparatedRunner` HAPPO in process, over `DeadAgentSmacEnv` (dead
  agents, whose obs follow the env's global index), each rank owning 4
  envs; they must train what one process trains over the same 8 envs (the
  parameters at rtol 2e-4 / atol 2e-5, every logged metric, the win rate
  of every rank's infos included), the ranks bit for bit alike;
* `scripts/train_mpe.main` (the flagship's flags) and
  `scripts/train_smac.main` (train_smac_3s5z.sh over the engine stand-ins
  of chip_smoke.py) with `--mesh_shape 2` in the group, against the same
  scripts in one process: rank 0 alone logs (metrics.jsonl), saves and
  evaluates.

The one-process references run here while the workers run.
"""
import json
import sys

import pytest
import torch

import chip_smoke
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.host_vec import DummyVecEnv
from onpolicy_torch.runner import host_mesh
from onpolicy_torch.runner.host_runner import HostSharedRunner
from onpolicy_torch.scripts import train_smac
from tests import test_torch_dp_worker as w
from tests.test_torch_parallel import (assert_ranks_agree,
                                       assert_trains_like, collect, spawn)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_host")
    two, one = tmp / "two", tmp / "one"
    procs, outs = spawn(tmp, "host", env={"ONPOLICY_TORCH_RESULTS": str(two)})
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("ONPOLICY_TORCH_RESULTS", str(one))
        for name, mod in chip_smoke.engine_standin_modules().items():
            mp.setitem(sys.modules, name, mod)
        ref = {name: w.run_host_case(name, 1) for name in w.HOST_CASES}
        for script in ("train_mpe", "train_smac"):
            ref[script] = w.run_main(script, 1)
    finally:
        mp.undo()
        ranks = collect(procs, outs)
    return dict(ranks=ranks, one=ref, two_dir=two, one_dir=one)


@pytest.mark.parametrize("name", list(w.HOST_CASES))
def test_two_ranks_train_what_one_trains(job, name):
    ranks, one = job["ranks"], job["one"][name]
    assert_ranks_agree(ranks, name)
    assert ranks[0][name]["N"] * 2 == one["N"] == w.HOST_ENVS
    assert ranks[0][name]["episodes"] == one["episodes"]
    assert_trains_like(ranks[0][name], one, name)
    assert any(r.get("dead_ratio", 0) > 0 for r in one["rows"]) \
        or name == "host_happo"


@pytest.mark.parametrize("script", ["train_mpe", "train_smac"])
def test_the_scripts_train_over_two_ranks(job, script):
    """Rank 0 logs every row to its run directory (one, as one process
    makes), rank 1 logs none; the eval (train_smac) is rank 0's alone."""
    ranks, one = job["ranks"], job["one"][script]
    assert_ranks_agree(ranks, script)
    drop = lambda rows: [{k: v for k, v in r.items() if not k.startswith(
        "eval_")} for r in rows]
    got = dict(ranks[0][script], rows=drop(ranks[0][script]["rows"]))
    assert_trains_like(got, dict(one, rows=drop(one["rows"])), script)
    env = {"train_mpe": "MPE", "train_smac": "StarCraft2"}[script]
    logs = list((job["two_dir"] / env).rglob("metrics.jsonl"))
    assert len(logs) == 1, logs
    rows = [json.loads(x) for x in logs[0].read_text().splitlines()]
    assert [r["episode"] for r in rows] == [r["episode"] for r in one["rows"]]
    if script == "train_smac":
        assert "eval_win_rate" in ranks[0][script]["rows"][0]
        assert not any("eval_win_rate" in r for r in ranks[1][script]["rows"])
    else:
        assert len(list(logs[0].parent.glob("models/ckpt_*.pt"))) == 2


def test_train_smac_seeds_each_rank_by_global_env(monkeypatch):
    for name, mod in chip_smoke.engine_standin_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    ns, cfg = train_smac.config_from_args(
        train_smac.CONFIGS["smac_3s5z"] + ["--device", "cpu"])
    fns = train_smac.make_env_fns(ns, cfg, 2, cfg.seed, first=4)
    assert [f()._seed for f in fns] == [cfg.seed + 4000, cfg.seed + 5000]
    assert host_mesh.env_offset(4) == 0        # one process


def test_a_host_mesh_needs_its_ranks():
    cfg = canonicalize_algorithm(Config(
        algorithm_name="rmappo", device="cpu", n_rollout_threads=2,
        episode_length=4, hidden_size=16, mesh_shape=(2,)))
    envs = DummyVecEnv(w.host_env_fns(2, 0), protocol="share")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        HostSharedRunner(cfg, envs)
    with pytest.raises(ValueError, match="D·M = 2 ranks.*WORLD_SIZE"):
        HostSharedRunner(cfg.replace(mesh_shape=(1, 2)), envs)
