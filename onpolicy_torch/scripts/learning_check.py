"""Learning check of the JAX package's other MPE launch scripts on the card.

    python -m onpolicy_torch.scripts.learning_check [--out DIR] \
        [--deadline 2700]

Trains `train_mpe.CONFIGS` "reference" (simple_reference, shared rMAPPO)
to 3M env steps, "comm" (simple_speaker_listener, separated rMAPPO) to 2M
steps and on towards 6M while it has not reached −13, and "happo_spread"
(HAPPO, simple_spread) to 3.4M steps, all at seed 1, as three concurrent
processes of `python -m onpolicy_torch.scripts.train_mpe` on one card
(each logs every 5 episodes, the script's default). A run still going at
the deadline (seconds) is stopped, and so is "comm" once past 2M steps
with its level at −13 or better. The level at a step is the mean of
`average_episode_rewards` over the last 10 logged rows up to it (50
episodes, 160,000 env steps). Prints the card's name and power limit and
one JSON object: per run, its level every 10 logged rows,
env-steps/s over the run (first episode included, as logged), its level
at the JAX package's reporting steps (RESULTS.md:41-45, :99) and at its
last row, and for "comm" the first step at which it reached −13. Writes
each run's log, its metrics and the result (with the curve: steps and
reward of each logged row) under DIR (default
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

from onpolicy_torch.scripts.train_mpe import CONFIGS

# config → (steps to run, steps at which to read the level)
RUNS = {"reference": (3_000_000, (2_000_000, 3_000_000)),
        "comm": (6_000_000, (2_000_000, 6_000_000)),
        "happo_spread": (3_400_000, (3_400_000,))}
COMM_MARK, COMM_MIN_STEPS = -13.0, 2_000_000
WINDOW = 10


def _rows(results: Path, config: str) -> list:
    files = sorted((results / config).rglob("metrics.jsonl"))
    if not files:
        return []
    return [json.loads(line) for line in files[0].read_text().splitlines()
            if line.strip()]


def level(rows: list, steps: int):
    """Mean reward of the last WINDOW rows at or before `steps`."""
    upto = [r["average_episode_rewards"] for r in rows if r["steps"] <= steps]
    return sum(upto[-WINDOW:]) / len(upto[-WINDOW:]) if upto else None


def first_reaching(rows: list, mark: float):
    for i in range(WINDOW - 1, len(rows)):
        if level(rows, rows[i]["steps"]) >= mark:
            return rows[i]["steps"]
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/learning")
    ap.add_argument("--deadline", type=float, default=2700.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("learning_check: needs a CUDA device")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    procs, logs = {}, {}
    results = Path(tempfile.mkdtemp(prefix="learning_check_"))
    start = time.perf_counter()
    try:
        for config, (steps, _) in RUNS.items():
            env = {**os.environ,
                   "ONPOLICY_TORCH_RESULTS": str(results / config)}
            logs[config] = open(out / f"{config}.log", "w")
            procs[config] = subprocess.Popen(
                [sys.executable, "-m", "onpolicy_torch.scripts.train_mpe",
                 *CONFIGS[config], "--experiment_name", "learning_check",
                 "--num_env_steps", str(steps)],
                env=env, stdout=logs[config], stderr=subprocess.STDOUT)
        stopped = {}
        while any(p.poll() is None for p in procs.values()):
            time.sleep(10)
            late = time.perf_counter() - start > args.deadline
            rows = _rows(results, "comm")
            comm_done = (rows and rows[-1]["steps"] >= COMM_MIN_STEPS
                         and level(rows, rows[-1]["steps"]) >= COMM_MARK)
            for config, p in procs.items():
                if p.poll() is None and (late or (config == "comm"
                                                  and comm_done)):
                    stopped[config] = "deadline" if late else "reached mark"
                    p.terminate()
                    p.wait(timeout=60)
        all_rows = {config: _rows(results, config) for config in RUNS}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
        shutil.rmtree(results, ignore_errors=True)

    result = {"card": card, "seconds": time.perf_counter() - start}
    for config, (steps, marks) in RUNS.items():
        rows = all_rows[config]
        (out / f"{config}.metrics.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
        result[config] = {
            "returncode": procs[config].returncode,
            "stopped": stopped.get(config),
            "last_steps": rows[-1]["steps"] if rows else None,
            "env_steps_per_s": rows[-1]["fps"] if rows else None,
            "level_last": level(rows, rows[-1]["steps"]) if rows else None,
            "levels": {str(m): level(rows, m) for m in marks},
            "curve": [[r["steps"], r["average_episode_rewards"]]
                      for r in rows],
            "levels_every_window": [[r["steps"], level(rows, r["steps"])]
                                    for r in rows[WINDOW - 1::WINDOW]]}
    result["comm"]["first_reaching_-13"] = first_reaching(all_rows["comm"],
                                                           COMM_MARK)
    print(card)
    print(json.dumps({k: ({**v, "curve": len(v["curve"])}
                          if isinstance(v, dict) else v)
                      for k, v in result.items()}))
    (out / "result.json").write_text(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
