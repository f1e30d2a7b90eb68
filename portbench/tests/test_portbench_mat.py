"""CPU tests of what the benchmark has for MAT and for the four-card cell:
MAT's work counted by hand, the new files found by name, a small whole
run of the `mpe_mat` family that comes out correct while each of MAT's
planted faults (`portbench/faults_mat.py`) does not, the readers that
find nothing on a program without the spans, and the torchrun launcher
(whose four-card cell, `mpe_spread_rmappo.t16k.dp4`, is out of
BENCHMARK.json until its rate stops following the host; its traffic,
launcher and readers stay): two gloo ranks run a small data-parallel
cell to a correct line that reads the collectives' spans, and to a line
that is not correct where either exchange between the ranks is left
out (`portbench/faults_dp.py`); the ranks are pinned to blocks of the
cores; a rank that hangs is killed at the deadline.

    python -m pytest portbench/tests/test_portbench_mat.py -q
"""
import importlib
import json
import math
import multiprocessing as mp
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from onpolicy_torch.utils.profiling import Span  # noqa: E402
from portbench import core, faults_dp, faults_mat, flops_mat  # noqa: E402
from portbench.launchers import torchrun  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MAT_CELL, DP_CELL = "mpe_spread_mat.t16k", "mpe_spread_rmappo.t16k.dp4"
HP = {"n_embd": 64, "n_block": 1, "n_head": 1, "ppo_epoch": 10}
DIMS = {"obs_dim": 18, "n_actions": 5, "num_agents": 3,
        "episode_length": 25, "n_rollout_threads": 16384}


def test_mat_flops_by_hand():
    # encoder: 18*64 + (4*64^2 + 2*3*64) + 2*64^2 + 64^2 + 64 = 30,272
    assert flops_mat.encoder_macs(HP, 18, 3) == 30272
    # decoder slot i: 6*64 + 2*(4*64^2 + 2*(i+1)*64) + 2*64^2 + 64^2
    # + 64*5 = 45,760 + 256*(i+1)
    assert [flops_mat.decoder_macs(HP, 5, i) for i in range(3)] == [
        46016, 46272, 46528]
    enc, dec = 3 * 30272, 46016 + 46272 + 46528
    rollout = 26 * 16384 * enc + 25 * 16384 * dec
    update = 3 * (enc + dec) * 25 * 16384 * 10
    assert flops_mat.iteration_flops(HP, DIMS) == 2.0 * (rollout + update)
    assert math.isclose(flops_mat.iteration_flops(HP, DIMS), 5.8345e12,
                        rel_tol=1e-4)
    ms, by = flops_mat.decode_bound(HP, DIMS)
    assert by == "operations"
    assert math.isclose(ms, 3 * 2.0 * 25 * 16384 * dec / 495e12 * 1e3,
                        rel_tol=1e-12)


def test_decoder_params_count_the_programs_tree():
    import torch

    from onpolicy_torch.models import transformer as tfm
    from portbench.program import flatten
    for n_block in (1, 2):
        p = tfm.mat_init(tfm.MATConfig(3, 5, n_block, 64, 1), 18,
                         torch.Generator().manual_seed(0), "cpu")
        read = sum(v.numel() for k, v in flatten(p["decoder"]).items()
                   if not k.startswith("obs_"))
        assert flops_mat.decoder_params(dict(HP, n_block=n_block), 5) == read


def test_new_cells_files_and_metrics_resolve():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[MAT_CELL]["chips"] == 1
    cell = core.Cell(ROOT, MAT_CELL)
    assert cell.family == "mpe_mat"
    assert cell.traffic["launcher"] == "single"
    for mod in ("drivers.mpe_mat", "reference.check_mpe_mat",
                "launchers.single"):
        importlib.import_module(f"portbench.{mod}")
    for m in cell.metrics(False) + cell.metrics(True):
        assert hasattr(importlib.import_module(
            f"portbench.metrics.{m['name']}"), "read")
    assert "setup_s" in [m["name"] for m in cell.metrics(False)]
    mat = {m["name"] for m in cell.metrics(True)}
    assert {"mat_decode_ms", "mat_decode_idle_ms", "mat_decode_roofline",
            "mat_decode_passes_per_iter", "mat_mfu"} <= mat
    # the GRU's readers need its widths
    assert not {"mfu", "gru_fwd_roofline", "gru_bwd_roofline"} & mat
    # what brings the four-card cell back: a workloads entry and the
    # collectives' two per_layer entries
    dp = dp_cell(4)
    assert dp.family == "mpe_shared"
    assert dp.traffic["launcher"] == "torchrun"
    importlib.import_module("portbench.launchers.torchrun")
    for name in ("allreduce_ms", "gather_rows_ms"):
        assert hasattr(importlib.import_module(
            f"portbench.metrics.{name}"), "read")
    config = core.Cell(ROOT, MAT_CELL).config
    source = [c for c in BENCH["configs"] if c["name"] == config["name"]][0]
    assert config["source"] == source["source"]
    assert config["reduced"] == source["reduced"]


def tiny_mat() -> core.Cell:
    cell = core.Cell(ROOT, MAT_CELL)
    cell.traffic = dict(cell.traffic, profiled_iterations=1,
                        flags=["--n_rollout_threads", "4"])
    c = cell.config
    cell.config = dict(
        c, flags=c["flags"] + ["--n_embd", "16", "--ppo_epoch", "3"],
        model=dict(c["model"], n_embd=16), ppo=dict(c["ppo"], ppo_epoch=3))
    return cell


def run_line(cell, fault, seed=2 ** 31 + 7, trace=False):
    with faults_mat.planted(fault):
        ctx = core.measure(cell, seed, 0.5, trace, time.perf_counter(),
                           device="cpu")
    return core.result_line(cell, ctx, trace), ctx


def test_sound_mat_run_is_correct_and_counts_its_decoder_passes():
    line, ctx = run_line(tiny_mat(), None, trace=True)
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    m = {k: v["value"] for k, v in line["metrics"].items()}
    # T x M autoregressive passes, one a PPO minibatch
    assert m["mat_decode_passes_per_iter"] == 25 * 3 + 3
    assert m["mat_mfu"] > 0 and m["mat_decode_idle_ms"] == 0.0
    # no card: no CUDA events, so the device ms and the share are absent
    assert "mat_decode_ms" not in m and "mat_decode_roofline" not in m


@pytest.mark.parametrize("fault", faults_mat.NAMES)
def test_planted_mat_fault_is_not_correct(fault):
    line, _ = run_line(tiny_mat(), fault)
    assert line["correct"] is False, (fault, line["compared"])


def test_new_readers_find_nothing_where_the_program_has_no_span():
    # a log of a commit whose MAT has no decode span, and whose
    # all-reduce is a host span
    spans = [Span("rollout.act", -1, 0, 10_000, None),
             Span("update.allreduce", -1, 20_000, 30_000, None)]
    ctx = {"trace": {"ops": [("k", 0.0, 5.0), ("k", 8.0, 9.0)],
                     "profiled": 1},
           "program_log": {"spans": spans, "counters": {}}}
    for name in ("mat_decode_ms", "mat_decode_idle_ms",
                 "mat_decode_passes_per_iter", "mat_decode_roofline",
                 "allreduce_ms", "gather_rows_ms"):
        assert importlib.import_module(
            f"portbench.metrics.{name}").read(ctx) is None, name
    spans.append(Span("rollout.gather", -1, 40_000, 50_000, 1.5))
    read = importlib.import_module("portbench.metrics.gather_rows_ms").read
    assert read(ctx) == 1.5


def dp_cell(chips: int) -> core.Cell:
    """The four-card cell as its workloads entry would make it: t16k's
    configuration under the traffic `t16k_dp4`."""
    cell = core.Cell(ROOT, "mpe_spread_rmappo.t16k")
    cell.name = DP_CELL
    cell.workload = dict(cell.workload, name=DP_CELL, traffic="t16k_dp4",
                         chips=chips)
    cell.traffic = core.load_json(ROOT / "portbench" / "traffic"
                                  / "t16k_dp4.json")
    assert cell.config["family"] == cell.traffic["family"]
    return cell


def tiny_dp() -> core.Cell:
    cell = dp_cell(2)
    cell.traffic = dict(cell.traffic, profiled_iterations=1,
                        flags=["--n_rollout_threads", "4", "--mesh_shape",
                               "2"])
    c = cell.config
    cell.config = dict(
        c, flags=c["flags"] + ["--hidden_size", "16", "--ppo_epoch", "3"],
        model=dict(c["model"], hidden_size=16),
        ppo=dict(c["ppo"], ppo_epoch=3))
    return cell


def test_two_gloo_ranks_run_the_data_parallel_cell_to_a_correct_line():
    cell = tiny_dp()
    ctx = torchrun.run_ranks(core.measure, cell, 2 ** 31 + 7, 1.0, True,
                             time.perf_counter(), ranks=2, device="cpu",
                             backend="gloo", deadline=600)
    line = core.result_line(cell, ctx, True)
    assert line["correct"] is True, line["compared"]
    names = {s.name for s in ctx["program_log"]["spans"]}
    assert {"rollout.gather", "update.allreduce"} <= names
    # 25 steps of 4 threads, global
    assert ctx["steps_per_iteration"] == 100
    assert not mp.active_children()


@pytest.mark.parametrize("fault", faults_dp.NAMES)
def test_two_gloo_ranks_without_an_exchange_are_not_correct(fault):
    cell = tiny_dp()
    ctx = torchrun.run_ranks(faults_dp.measure_planted(fault), cell,
                             2 ** 31 + 7, 1.0, False, time.perf_counter(),
                             ranks=2, device="cpu", backend="gloo",
                             deadline=600)
    line = core.result_line(cell, ctx, False)
    assert line["correct"] is False, (fault, line["compared"])
    assert not mp.active_children()


def test_ranks_take_blocks_of_the_cores():
    assert torchrun.core_blocks(range(8), 4) == [[0, 1], [2, 3], [4, 5],
                                                 [6, 7]]
    assert torchrun.core_blocks([5, 1, 3], 2) == [[1], [3]]
    assert torchrun.core_blocks([0, 1], 4) == [[0], [1], [0], [1]]


def hang_on_rank_one(cell, seed, seconds, trace, start, device):
    import torch.distributed as dist
    if dist.get_rank() == 1:
        time.sleep(3600)
    return {}


def test_deadline_kills_a_rank_that_hangs():
    t = time.monotonic()
    with pytest.raises(core.RunError, match=r"ranks \[1\] of 2"):
        torchrun.run_ranks(hang_on_rank_one, tiny_dp(), 1, 1.0, False,
                           time.perf_counter(), ranks=2, device="cpu",
                           backend="gloo", deadline=30)
    assert time.monotonic() - t < 90
    assert not mp.active_children()
