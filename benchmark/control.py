"""Readings of the check, not a benchmark run: the program on many seeds,
and the control and each planted fault on a few, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds 1,2,3 --faults none,control,unchanged,half,flip [--device cpu]

``none`` is the program as it is; the others are ``harness/faults.py``'s.
One JSON line a run: the fault, the seed, ``correct`` and every number
compared. Each limit in ``benchmark/harness/check.py`` is set from these
readings (PERF.md gives them).
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark.harness import manifest, runner  # noqa: E402


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="none,control")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    for fault in args.faults.split(","):
        for seed in args.seeds.split(","):
            run_args = runner.parse(["--workload", args.workload, "--seed", seed,
                                     "--seconds", str(args.seconds)])
            line, _ = runner.measure(run_args, cell, time.monotonic(), device=args.device,
                                     fault=None if fault == "none" else fault)
            print(json.dumps({"fault": fault, "seed": int(seed), "correct": line["correct"],
                              "attempted": line["attempted"], "failed": line["failed"],
                              "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
