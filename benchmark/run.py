#!/usr/bin/env python3
"""The benchmark of neighborretr_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout (cells, metrics and bounds in BENCHMARK.json).
It exits non-zero and prints no result without a CUDA card, or with fewer
cards than the cell asks for.  The last line of standard output is the
result as one JSON object; the numbers that decided `correct` are the last
lines of standard error.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from benchmark.harness.cli import main
    sys.exit(main(sys.argv[1:]))
