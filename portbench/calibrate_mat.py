"""The readings that the limits of `correct` are set from, for a cell of
the MPE MAT family: `calibrate.py`'s readings (the program as it is, the
control, the program with each planted fault) with MAT's faults
(`faults_mat.py`) planted around them.

    python3 portbench/calibrate_mat.py --workload mpe_spread_mat.t16k \
        --seeds 1,2,3 [--faults half_batch,unmasked_decoder] \
        [--program 0] [--out FILE]

One JSON line a reading on standard output (and appended to --out).
Runs on the card only, as the benchmark does.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import calibrate, core, faults_mat  # noqa: E402


def readings(cell, seed: int, fault, control: bool, device: str) -> list:
    """`calibrate.readings` with MAT's fault `fault` planted."""
    with faults_mat.planted(fault):
        out = calibrate.readings(cell, seed, None, control, device)
    for line in out:
        if line["side"] == "program":
            line["side"] = fault or "program"
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
    names = [f for f in args.faults.split(",") if f]
    for seed in [int(s) for s in args.seeds.split(",")]:
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
