#!/usr/bin/env python3
"""Runs one cell of the benchmark of `density_tpu_torch` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with the cards the cell asks for. See
README.md.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# import the benchmark as the package `portbench` from the checkout's
# root, and not this folder's modules under bare names
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
