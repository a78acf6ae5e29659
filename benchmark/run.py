#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result's line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA GPUs:
without them it exits non-zero and prints no result.  See
``benchmark/README.md``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
