"""Learning checks of the JAX package's launch scripts on the card.

    python -m onpolicy_torch.scripts.learning_check [--out DIR] \
        [--deadline 2700] [--runs reference,comm,happo_spread]

Trains each run of `--runs` at seed 1, all as concurrent processes of
`python -m onpolicy_torch.scripts.train_mpe` or `train_hanabi` on one
card:
  * "reference" (`train_mpe.CONFIGS`, simple_reference, shared rMAPPO) to
    3M env steps, "comm" (simple_speaker_listener, separated rMAPPO) to 2M
    steps and on towards 6M while it has not reached −13, and
    "happo_spread" (HAPPO, simple_spread) to 3.4M steps, "mpe_mat"
    (train_mpe_mat.sh: MAT, simple_spread, n_embd 64) to 20M steps, its
    mark the JAX package's −154.9 at 20M (RESULTS.md:103), and
    "hatrpo_spread" (HATRPO, simple_spread, hidden 64) to 3M steps, its
    mark −138.8 at 3M (RESULTS.md:101), each logging
    every 5 episodes (the script's default); the level at a step is the
    mean of `average_episode_rewards` over the last 10 logged rows up to
    it (50 episodes, 160,000 env steps);
  * "hanabi_small" (RESULTS.md:137-138: MAPPO, Hanabi-Small, 2 agents, 256
    fleets, hidden 256x2, the JAX package's defaults for every other flag
    but logging, on the device engine) to 1,024,000 buffer steps, its mark
    an average score of 0.5 by 215k buffer steps (the JAX package read
    0.59, random play 0.02), and "hanabi_small_host", the same on the C++
    engine through the host seat loop (the engine RESULTS.md:135-138 puts
    the figure beside);
  * "hanabi_device" (`train_hanabi.CONFIGS`, train_hanabi_device.sh at
    full width) until the deadline; no mark is set;
each Hanabi run logging every episode, its level at a step the
`average_score` of the last logged row up to it. The marks are learning
levels of the JAX package, printed beside the port's level.
A run still going at the deadline (seconds) is stopped, and so is "comm"
once past 2M steps with its level at −13 or better. Prints the card's
name and power limit and one JSON object: per run, its level every 10
logged rows, env-steps/s over the run (first episode included, as
logged), its level at its reporting steps (RESULTS.md:41-45, :99, :137)
and at its last row, and for "comm" the first step at which it reached
−13. Writes each run's log, its metrics and the result (with the curve:
steps and level of each logged row) under DIR (default
`chiprun_out/learning`); the runs' checkpoints go to a temporary
directory that is removed at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from onpolicy_torch.scripts import train_hanabi
from onpolicy_torch.scripts.train_mpe import CONFIGS

HANABI_SMALL_HOST = ["--env_name", "Hanabi", "--algorithm_name", "mappo",
                     "--hanabi_name", "Hanabi-Small", "--num_agents", "2",
                     "--n_rollout_threads", "256", "--hidden_size", "256",
                     "--layer_N", "2"]
HANABI_SMALL = HANABI_SMALL_HOST + ["--use_jax_env", "--use_scan_rounds"]
# name → (script, flags, steps to run, steps at which to read the level)
RUNS = {"reference": ("train_mpe", CONFIGS["reference"], 3_000_000,
                      (2_000_000, 3_000_000)),
        "comm": ("train_mpe", CONFIGS["comm"], 6_000_000,
                 (2_000_000, 6_000_000)),
        "happo_spread": ("train_mpe", CONFIGS["happo_spread"], 3_400_000,
                         (3_400_000,)),
        "hanabi_small": ("train_hanabi", HANABI_SMALL, 1_024_000,
                         (215_000,)),
        "hanabi_small_host": ("train_hanabi", HANABI_SMALL_HOST, 1_024_000,
                              (215_000,)),
        "hanabi_device": ("train_hanabi", train_hanabi.CONFIGS["hanabi_device"],
                          10_000_000_000, ()),
        "mpe_mat": ("train_mpe", CONFIGS["mpe_mat"], 20_000_000,
                    (3_000_000, 10_000_000, 20_000_000)),
        "hatrpo_spread": ("train_mpe", CONFIGS["hatrpo_spread"], 3_000_000,
                          (3_000_000,))}
# the JAX package's level at the last reporting step (RESULTS.md:101-103)
MARKS = {"mpe_mat": -154.9, "hatrpo_spread": -138.8}
COMM_MARK, COMM_MIN_STEPS = -13.0, 2_000_000
HANABI_SMALL_MARK = 0.5
WINDOW = 10


def _rows(results: Path, name: str) -> list:
    files = sorted((results / name).rglob("metrics.jsonl"))
    if not files:
        return []
    return [json.loads(line) for line in files[0].read_text().splitlines()
            if line.strip()]


def _reward_key(name: str) -> str:
    return ("average_score" if RUNS[name][0] == "train_hanabi"
            else "average_episode_rewards")


def level(rows: list, steps: int, key="average_episode_rewards",
          window=WINDOW):
    """Mean of `key` over the last `window` rows at or before `steps`."""
    upto = [r[key] for r in rows if r["steps"] <= steps and key in r]
    return sum(upto[-window:]) / len(upto[-window:]) if upto else None


def run_level(name: str, rows: list, steps: int):
    hanabi = RUNS[name][0] == "train_hanabi"
    return level(rows, steps, _reward_key(name), 1 if hanabi else WINDOW)


def first_reaching(name: str, rows: list, mark: float):
    """The first logged step whose level is at `mark` or better (an MPE
    run's once its window of rows is full)."""
    full = 0 if RUNS[name][0] == "train_hanabi" else WINDOW - 1
    for r in rows[full:]:
        value = run_level(name, rows, r["steps"])
        if value is not None and value >= mark:
            return r["steps"]
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/learning")
    ap.add_argument("--deadline", type=float, default=2700.0)
    ap.add_argument("--runs", default="reference,comm,happo_spread")
    args = ap.parse_args(argv)
    runs = args.runs.split(",")
    unknown = set(runs) - set(RUNS)
    if unknown:
        raise SystemExit(f"learning_check: unknown runs {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("learning_check: needs a CUDA device")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    procs, logs, stopped = {}, {}, {}
    results = Path(tempfile.mkdtemp(prefix="learning_check_"))
    start = time.perf_counter()
    try:
        for name in runs:
            script, flags, steps, _ = RUNS[name]
            if script == "train_hanabi":
                flags = flags + ["--log_interval", "1"]
            env = {**os.environ,
                   "ONPOLICY_TORCH_RESULTS": str(results / name)}
            logs[name] = open(out / f"{name}.log", "w")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"onpolicy_torch.scripts.{script}",
                 *flags, "--experiment_name", "learning_check",
                 "--num_env_steps", str(steps)],
                env=env, stdout=logs[name], stderr=subprocess.STDOUT)
        while any(p.poll() is None for p in procs.values()):
            time.sleep(10)
            late = time.perf_counter() - start > args.deadline
            rows = _rows(results, "comm")
            comm_done = (rows and rows[-1]["steps"] >= COMM_MIN_STEPS
                         and run_level("comm", rows, rows[-1]["steps"])
                         >= COMM_MARK)
            for name, p in procs.items():
                if p.poll() is None and (late or (name == "comm"
                                                  and comm_done)):
                    stopped[name] = "deadline" if late else "reached mark"
                    p.terminate()
                    p.wait(timeout=60)
        all_rows = {name: _rows(results, name) for name in runs}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
        shutil.rmtree(results, ignore_errors=True)

    result = {"card": card, "seconds": time.perf_counter() - start}
    for name in runs:
        marks = RUNS[name][3]
        rows = all_rows[name]
        key = _reward_key(name)
        (out / f"{name}.metrics.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
        result[name] = {
            "returncode": procs[name].returncode,
            "stopped": stopped.get(name),
            "last_steps": rows[-1]["steps"] if rows else None,
            "env_steps_per_s": rows[-1]["fps"] if rows else None,
            "level_last": run_level(name, rows, rows[-1]["steps"])
            if rows else None,
            "levels": {str(m): run_level(name, rows, m) for m in marks},
            "curve": [[r["steps"], r[key]] for r in rows],
            "levels_every_window": [[r["steps"],
                                     run_level(name, rows, r["steps"])]
                                    for r in rows[WINDOW - 1::WINDOW]]}
        if name in MARKS:
            result[name]["mark"] = MARKS[name]
        if rows and "true_steps" in rows[-1]:
            result[name]["true_steps"] = rows[-1]["true_steps"]
    if "comm" in runs:
        result["comm"]["first_reaching_-13"] = first_reaching(
            "comm", all_rows["comm"], COMM_MARK)
    for name in ("hanabi_small", "hanabi_small_host"):
        if name in runs:
            result[name]["first_reaching_0.5"] = first_reaching(
                name, all_rows[name], HANABI_SMALL_MARK)
    print(card)
    print(json.dumps({k: ({**v, "curve": len(v["curve"])}
                          if isinstance(v, dict) else v)
                      for k, v in result.items()}))
    (out / "result.json").write_text(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
