"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices
(without them it exits 2 and prints no result).  Every build and kernel
cache goes to a fixed directory inside the checkout (``build/``)."""
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from perfbench import bench, harness
    bench.set_cache_env()
    sys.exit(harness.main(sys.argv[1:], T_START))
