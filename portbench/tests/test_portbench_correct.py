"""The comparison that decides `correct`, driven through the rest of a run
on the CPU at a size a test can hold (4 rollout threads or fleets,
narrow networks, 3 PPO epochs): the program as it is comes out correct,
and each fault planted under the timed path (`portbench/faults.py`)
comes out not correct. The control (the reference in TF32 in the
program's place) needs the card: TF32 does not exist on the CPU.

    python -m pytest portbench/tests -q
"""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import core, faults  # noqa: E402


def tiny(name: str) -> core.Cell:
    cell = core.Cell(ROOT, name)
    uses = [f for f in cell.traffic["flags"] if f.startswith("--use")]
    cell.traffic = dict(cell.traffic, profiled_iterations=1,
                        flags=["--n_rollout_threads", "4"] + uses)
    c = cell.config
    if cell.family == "hanabi":
        cell.config = dict(
            c, flags=c["flags"] + ["--hidden_size", "32", "--episode_length",
                                   "20", "--ppo_epoch", "3"],
            model=dict(c["model"], hidden_size=32),
            ppo=dict(c["ppo"], ppo_epoch=3),
            env=dict(c["env"], episode_length=20))
    else:
        cell.config = dict(
            c, flags=c["flags"] + ["--hidden_size", "16", "--ppo_epoch", "3"],
            model=dict(c["model"], hidden_size=16),
            ppo=dict(c["ppo"], ppo_epoch=3))
    return cell


def run_line(cell, fault, seed=2 ** 31 + 7, trace=False):
    with faults.planted(fault):
        ctx = core.measure(cell, seed, 0.5, trace, time.perf_counter(),
                           device="cpu")
    return core.result_line(cell, ctx, trace), ctx


CASES = [("mpe_spread_rmappo.t16k", f) for f in
         ("stale_update", "half_batch", "altered_action", "stale_env")] + [
    ("hanabi_full_rmappo.f1000", f) for f in
    ("stale_update", "half_batch", "altered_action", "stale_env")] + [
    ("hanabi_full_rmappo.cpp1000", f) for f in
    ("altered_action", "stale_env")]


@pytest.mark.parametrize("name", ["mpe_spread_rmappo.t16k",
                                  "hanabi_full_rmappo.f1000",
                                  "hanabi_full_rmappo.cpp1000"])
def test_sound_run_is_correct(name):
    line, ctx = run_line(tiny(name), None)
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "compared"


def test_traced_run_reads_its_per_layer_metrics():
    line, ctx = run_line(tiny("mpe_spread_rmappo.t16k"), None, trace=True)
    assert line["correct"] is True
    assert {"rollout_ms", "update_ms", "mfu"} <= set(line["metrics"])
    # no device on the CPU: the trace's readers return nothing
    assert "device_idle_share" not in line["metrics"]
    assert "kernel_launches_per_iter" not in line["metrics"]


@pytest.mark.parametrize("name,fault", CASES)
def test_planted_fault_is_not_correct(name, fault):
    line, _ = run_line(tiny(name), fault)
    assert line["correct"] is False, (fault, line["compared"])


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists on the card only")
    from portbench import calibrate
    for name in ("mpe_spread_rmappo.t16k", "hanabi_full_rmappo.f1000"):
        cell = tiny(name)
        lines = calibrate.readings(cell, 5, None, True, "cuda")
        ctl = [x["readings"] for x in lines if x["side"] == "control"][0]
        compared = core.judge(ctl, cell.config["limits"])
        assert any(c["value"] > c["limit"] for c in compared.values())
