"""The benchmark of onpolicy_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell, its configuration and its
traffic are read from BENCHMARK.json and the files under portbench/; the
last line of standard output is one JSON object (see portbench/core.py).
"""
import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], START, ROOT))
