#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the package under test, `bng_tpu_torch`,
is imported from there. See `gpubench/harness.py` for how a cell's files
are found and `BENCHMARK.json` for the cells.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the checkout's root, not this folder, is where modules come from
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from gpubench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
