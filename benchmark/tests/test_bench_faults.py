"""The check fails under each fault a cell can have, and passes without.

Each run drives the whole harness on the CPU (the broker with ``-device
cpu``) with the fault planted in the broker's replies, where the boards are
produced. The faults: a step that returns its state unchanged, half of the
requests left out, an answer altered, and the control (the reference in the
program's place with the torus's wrap, the configuration's guarantee,
broken). One chip holds these cells, so there is no exchange between chips
to leave out; the wrap is the single board's counterpart and the control's.
"""

import time

import pytest

from benchmark.harness import manifest, runner


def _run(cell, seed, fault=None, seconds="1"):
    args = runner.parse(["--workload", cell, "--seed", str(seed), "--seconds", seconds])
    line, _ = runner.measure(args, manifest.cell(cell), time.monotonic(), device="cpu",
                             fault=fault)
    return line


def test_sound_runs_are_correct(cpu_cell, tmpdir_env):
    line = _run(cpu_cell, 4_000_000_001)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "flip", "control"])
def test_each_fault_makes_the_run_incorrect(cpu_cell, fault, tmpdir_env):
    # ``half`` leaves out every second request, the warm-up session's first:
    # the window has to hold a second session
    line = _run(cpu_cell, 4_000_000_003, fault,
                seconds={"half": "12", "control": "2"}.get(fault, "1"))
    assert line["correct"] is False, (fault, line["checks"])
    assert line["checks"]["boards_checked"]["value"] >= 1
