"""Run one cell of BENCHMARK.json on the CUDA cards of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output; exits nonzero, printing no
result, without enough cards, without the port, or if a module of the JAX
side was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this folder, whose module names would
# shadow the standard library's
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
