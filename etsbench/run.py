"""The benchmark's command: one run of one cell.

    python3 etsbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``python -m etsbench.run`` works too).
Prints the run's result as the last line of standard output, and each
number the correctness check compared, beside its limit, as the last
lines of standard error.  Exits 2, printing no result, without a CUDA
card, without the program under test, or when a module of another
stack (jax, flax, the reference package ``repro``) was loaded.
"""
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.environ.setdefault("USE_FLAX", "0")
    from etsbench.harness import main
    sys.exit(main(t_start=T_START))
