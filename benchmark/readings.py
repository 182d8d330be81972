"""Readings of `correct`'s numbers over many seeds: see
`harness/readings.py`."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

if __name__ == "__main__":
    from harness import readings

    sys.exit(readings.main(sys.argv[1:]))
