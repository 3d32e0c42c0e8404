"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are looked up by name in ``BENCHMARK.json`` and under ``bench/``
(see ``bench/README.md``); the program is the checkout's
``src/repro_torch``.  Exits with a code other than 0, and prints no result,
without a CUDA card or without the program.

The run is one process with one compute thread: the math libraries'
thread pools are set to one thread before they load, and the process is
held to the first two CPUs it may use, so that runs on one machine share
as little as they can with whatever else runs there.
"""
import time

T_START = time.time()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
if hasattr(os, "sched_setaffinity"):
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from litsbench.harness import run_cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(run_cell(sys.argv[1:], root=HERE.parent, t_start=T_START))
