"""Run one cell of the port's benchmark on the CUDA device.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json and the port beside portbench/).
The last line of standard output is the result, a JSON object; the numbers
the comparison with the reference read, each beside its limit, are the last
lines of standard error.  Without a CUDA device it exits 2 and prints no
result."""
import time

T_START = time.perf_counter()  # set-up is timed from here, the process's first statement

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # the checkout's root: the port (which builds its kernels into its own _build/) and this package

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
