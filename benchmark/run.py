"""The benchmark of mmloam_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout holding the port.  Prints the set-up's
parts, the window and the compared numbers on standard error, and the
result as one JSON object on the last line of standard output.  Needs a
CUDA device: without one it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

if __name__ == "__main__":
    # imported here, not above: the input builder's spawned workers load
    # this file too, and need numpy alone
    from harness import main

    sys.exit(main.main(sys.argv[1:], T_START))
