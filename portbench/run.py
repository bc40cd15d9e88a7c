"""Run one cell of the port's benchmark (BENCHMARK.json at the root).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result, one JSON object; the
last lines of standard error give each number compared beside its limit.
The run needs the CUDA devices its cell asks for, and fails without them.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# The bytecode of every module the run imports, torch's among them, is
# kept in the checkout at a fixed path, so that only a checkout's first
# run compiles it: an installation that ships no bytecode and an
# environment that writes none (PYTHONDONTWRITEBYTECODE) would otherwise
# compile torch's sources again in every run's set-up, seconds that
# spread with the load on the host's cores.
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False

from portbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(t_start=T_START))
