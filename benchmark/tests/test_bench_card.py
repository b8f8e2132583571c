"""A short run of each cell on the card, through the command itself."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.manifest()["workloads"]])
def test_a_short_run_on_the_card_is_correct(root, cell, tmpdir_env):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           "2147483700", "--seconds", "2", "--trace", "1"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
