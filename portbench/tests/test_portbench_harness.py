"""CPU tests of the benchmark harness: the work it counts, its files, its
result line, the no-JAX rule, the reference's imports, and that a run
without a card gives no result.

    python -m pytest portbench/tests -q
"""
import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import core, flops  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

FLAGSHIP = {"hidden_size": 64, "layer_N": 1, "recurrent_N": 1,
            "ppo_epoch": 10, "num_mini_batch": 1, "data_chunk_length": 10}
HANABI = {"hidden_size": 512, "layer_N": 2, "recurrent_N": 1,
          "ppo_epoch": 15, "num_mini_batch": 1, "data_chunk_length": 10}


def dims(obs, share, actions, T, N, M):
    rows = T * N * M
    return {"obs_dim": obs, "share_dim": share, "n_actions": actions,
            "actor_rows": rows, "critic_rows": rows + N * M,
            "train_rows": rows}


def test_flagship_flops_by_hand():
    # actor 18*64 + 64*64 + 2*3*64*64 + 64*5 = 30,144 multiply-adds a row;
    # critic 54*64 + 64*64 + 2*3*64*64 + 64 = 32,192; 9,600 rows
    d = dims(18, 54, 5, 25, 128, 3)
    rollout = 2 * (30144 * 9600 + 32192 * 9984)
    update = 6 * (30144 + 32192) * 9600 * 10
    assert flops.iteration_flops(FLAGSHIP, d) == rollout + update
    assert math.isclose(flops.iteration_flops(FLAGSHIP, d), 37.12e9,
                        rel_tol=1e-3)


def test_hanabi_flops_by_hand():
    # actor 660*512 + 2*512*512 + 6*512*512 + 512*20 = 2,445,312;
    # critic 787*512 + 2*512*512 + 6*512*512 + 512 = 2,500,608
    d = dims(660, 787, 20, 100, 1000, 2)
    assert flops.net_macs(660, 20, HANABI) == 2445312
    assert flops.net_macs(787, 1, HANABI) == 2500608
    want = (2 * (2445312 * 200000 + 2500608 * 202000)
            + 6 * (2445312 + 2500608) * 200000 * 15)
    assert flops.iteration_flops(HANABI, d) == want


def test_gru_calls_and_bounds_by_hand():
    calls, T, B, H = flops.gru_calls(
        HANABI, dims(660, 787, 20, 100, 1000, 2))
    assert (calls, T, B, H) == (30, 10, 20000, 512)
    b = flops.gru_bounds(10, 20000, 512)
    # 6 * 512^2 * 20,000 * 10 = 3.146e11 flops; 3 TF32 passes at 495e12
    assert math.isclose(b["fwd_tc"][0], 3 * 3.145728e11 / 495e12 * 1e3,
                        rel_tol=1e-9)
    assert b["fwd_tc"][1] == "operations"
    assert math.isclose(b["bwd_tc"][0], 9 * 3.145728e11 / 495e12 * 1e3,
                        rel_tol=1e-9)
    # the flagship's windows: T=10 over 960, bound by the bytes
    calls, T, B, H = flops.gru_calls(FLAGSHIP, dims(18, 54, 5, 25, 128, 3))
    assert (calls, T, B, H) == (20, 10, 960, 64)
    assert flops.gru_bounds(T, B, H)["fwd_tc"][1] == "bytes"


def test_benchmark_file_and_every_cell_load():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        cell = core.Cell(ROOT, w["name"])
        assert cell.family in ("mpe_shared", "hanabi")
        assert cell.metrics(False) and cell.metrics(True)
        assert "setup_s" in [m["name"] for m in cell.metrics(False)]


def test_result_line_keys():
    cell = core.Cell(ROOT, "mpe_spread_rmappo.t16k")
    ctx = {"readings": {k: 0.0 for k in cell.config["limits"]},
           "failed": 0, "memory_peak_bytes": 1, "iterations": 10,
           "steps_per_iteration": 409600, "elapsed_s": 5.0, "setup_s": 9.0}
    line = core.result_line(cell, ctx, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"env_steps_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert line["metrics"]["env_steps_per_s"]["value"] == 819200.0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    ctx["readings"]["act_gap"] = 1.0
    assert core.result_line(cell, ctx, trace=False)["correct"] is False


def test_forbidden_modules_by_whole_top_level_name():
    found = core.forbidden_modules(["jax", "jaxlib.xla", "flax.linen",
                                    "onpolicy_tpu.ops", "onpolicy_torch",
                                    "onpolicy_torch.ops", "jaxtyping",
                                    "flaxen", "onpolicy_tpux"])
    assert found == ["flax.linen", "jax", "jaxlib.xla", "onpolicy_tpu.ops"]


def test_reference_imports_nothing_of_the_program():
    banned = {"onpolicy_torch", "onpolicy_tpu", "jax", "jaxlib", "flax"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, (path.name, m)


def test_run_without_a_card_fails_and_prints_no_result():
    try:
        import torch
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device")
    except ImportError:
        pass
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mpe_spread_rmappo.t16k", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_traced_line_reports_every_per_layer_metric_of_the_cell():
    from portbench.metrics import _roofline
    assert _roofline.function_name(
        "void (anonymous namespace)::gru_fwd_wide_step<float>(float const*,"
        " int)") == "gru_fwd_wide_step"
    assert _roofline.function_name("void gru_bwd_reduce(float*, int)") \
        == "gru_bwd_reduce"
    cell = core.Cell(ROOT, "hanabi_full_rmappo.f1000")
    ops = [("void (anonymous namespace)::gru_fwd_wide_step<float>(float*)",
            0.0, 7000.0),
           ("void (anonymous namespace)::gru_bwd_carry<float>(float*)",
            7000.0, 29000.0),
           ("sm80_xmma_gemm_f32f32_f32f32", 29000.0, 60000.0)]
    ctx = {"readings": {k: 0 for k in cell.config["limits"]}, "failed": 0,
           "memory_peak_bytes": 1, "iterations": 7, "elapsed_s": 49.0,
           "steps_per_iteration": 100000, "setup_s": 30.0,
           "config": cell.config, "traffic": cell.traffic,
           "phase_ms": {"rollout": 3000.0, "update": 3300.0},
           "dims": {"obs_dim": 660, "share_dim": 787, "n_actions": 20,
                    "actor_rows": 200000, "critic_rows": 202000,
                    "train_rows": 200000},
           "trace": {"ops": ops, "busy_s": 0.06, "window_s": 10.0,
                     "profiled": 1, "device_ops": [], "idle_gaps": []}}
    line = core.result_line(cell, ctx, trace=True)
    assert set(line["metrics"]) == {m["name"] for m in cell.metrics(True)}
    # 30 calls at the TF32 bound of T=10 B=20,000 H=512 over 7 ms
    fwd = line["metrics"]["gru_fwd_roofline"]["value"]
    assert math.isclose(fwd, 100 * 30 * flops.gru_bounds(
        10, 20000, 512)["fwd_tc"][0] / 7.0, rel_tol=1e-9)
    assert {"busy_s", "window_s"} <= set(line["device"])
