"""The readings that the limits of `correct` are set from: for one cell,
on each seed, the compared numbers of the program as it is, of the
control (the reference in TF32 in the program's place, over the same
run's data) and of the program with each planted fault
(`portbench/faults.py`). Set-up and the checked iterations only: the
numbers need no measured window.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--faults half_batch,altered_action] [--program 0] [--out FILE]

One JSON line a reading on standard output (and appended to --out).
Runs on the card only, as the benchmark does.
"""
import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import core, faults  # noqa: E402


def readings(cell, seed: int, fault, control: bool, device: str) -> list:
    """Build the cell's driver under `fault`, run its checked
    iterations, free the program and compare; -> the program's (or the
    faulted program's) readings, and with `control` the control's."""
    config, traffic = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = config["precision"]["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = config["precision"]["allow_tf32"]
    family = importlib.import_module(f"portbench.drivers.{cell.family}")
    checker = importlib.import_module(
        f"portbench.reference.check_{cell.family}")
    t = time.perf_counter()
    with faults.planted(fault):
        driver = family.Driver(config, traffic, seed, device)
        capture = driver.checked_iterations(traffic["checked_iterations"])
        driver.close()
    del driver
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    setup = time.perf_counter() - t
    out = []
    for ctl in ((False, True) if control else (False,)):
        t = time.perf_counter()
        r = checker.check(capture, config, device, control=ctl)
        out.append({"workload": cell.name, "seed": seed,
                    "side": "control" if ctl else (fault or "program"),
                    "setup_s": setup, "check_s": time.perf_counter() - t,
                    "readings": r})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--program", type=int, default=1,
                    help="0: only the faulted program's readings")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = core.Cell(ROOT, args.workload)
    core.require_cards(cell.workload["chips"])
    seeds = [int(s) for s in args.seeds.split(",")]
    names = [f for f in args.faults.split(",") if f]
    for seed in seeds:
        for fault in [None] * bool(args.program) + names:
            for line in readings(cell, seed, fault,
                                 bool(args.control) and fault is None,
                                 "cuda"):
                text = json.dumps(line)
                print(text, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(text + "\n")
    found = core.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
