"""Run one cell of the benchmark of ar_slam_tpu_torch.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output (see benchmark/README.md).
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], start=START))
