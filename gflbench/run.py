"""Run one cell of the port's benchmark once (see ``gflbench/README.md``).

    python3 gflbench/run.py --workload sec5-hybrid --seed 1 --seconds 30 \
        --trace 0

Run from the root of a checkout: the program is ``src/repro_torch``, and
every build or kernel cache stays inside the checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# one process with one host thread a library: no pool of spinning threads
# takes the cores that the program's host path runs on
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# in place of this file's own folder, whose module names are the package's
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from gflbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
