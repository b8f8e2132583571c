"""Run one benchmark cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, as one JSON object; the
numbers compared for ``correct`` are the last lines of standard error.
Without a CUDA card it exits with 3 and prints no result.
"""

import time

T_START = time.monotonic()  # set-up is counted from here

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], t_start=T_START))
