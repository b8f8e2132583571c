"""The command's contract: no card, no result; the last line's keys."""

import json
import subprocess
import sys
import time

import pytest

from benchmark.harness import runner

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_a_run_without_a_card_exits_nonzero_with_no_result(root, cpu_cell, tmpdir_env):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cpu_cell, "--seed",
         "3000000007", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == runner.EXIT_NO_CARD
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_an_unknown_cell_exits_nonzero_with_no_result(root):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nope.nope",
                           "--seed", "1", "--seconds", "1"],
                          cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == runner.EXIT_NAME and proc.stdout == ""


def test_a_checkout_of_the_benchmark_alone_fails(root, cpu_cell, tmp_path):
    """Without the port beside it the command cannot run a cell."""
    import shutil

    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cpu_cell,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contract_keys(trace, capsys, cpu_cell, tmpdir_env):
    rc = runner.main(["--workload", cpu_cell, "--seed", "2147483659",
                      "--seconds", "1", "--trace", str(trace)],
                     t_start=time.monotonic(), device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS[:5] + (["breakdown"] if trace else []) + KEYS[5:]
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the broker's RPC metering is read; device metrics need the card
        assert set(line["metrics"]) == {"broker.run_ms.session",
                                        "controller.outside_broker_ms.session"}
    else:
        assert set(line["metrics"]) == {"setup_s", "cell_updates_per_s"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
