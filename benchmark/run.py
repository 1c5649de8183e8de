#!/usr/bin/env python3
"""The benchmark of opendog_tpu_torch: one cell of ``BENCHMARK.json``, one
seed, one run, from the root of a checkout:

    python3 benchmark/run.py --workload go1_trot_k4096 --seed 7 \
        --seconds 20 --trace 0

See ``benchmark/harness/cli.py``."""
import os
import sys
import time

START_WALL = time.time()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], START_WALL))
