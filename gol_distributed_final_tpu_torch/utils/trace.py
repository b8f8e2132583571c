"""Profiling / tracing hooks — the TestTrace analogue (reference:
trace_test.go:12-29 wraps a run in runtime/trace for goroutine inspection).

Here the equivalent is a ``torch.profiler`` trace around any region,
exported as a Chrome trace (open it in Perfetto or chrome://tracing): the
host's operator ranges, each CUDA kernel on the card's timeline, and the
``record_function`` ranges obs/tracing.annotate pushes.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time


@contextlib.contextmanager
def trace(log_dir="trace_out"):
    """Context manager: profile everything inside into ``log_dir``, as
    ``torch_trace_<pid>.json`` (Chrome trace format). The card's activity
    is traced where CUDA is available, the host's always.

    The profiler starts INSIDE the try and stops only once it started: a
    body that raises must still stop the profiler (or the next ``trace()``
    would find one already running), while a start failure must not be
    followed by a stop of a never-started profiler (which raises its own
    error and masks the original one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    started = False
    try:
        prof.start()
        started = True
        yield log_dir
    finally:
        if started:
            prof.stop()
            prof.export_chrome_trace(str(log_dir / f"torch_trace_{os.getpid()}.json"))


class TurnsPerSecond:
    """Tiny throughput meter: feed completed-turn counts, read turns/sec
    and cell-updates/sec (the driver metric, BASELINE.json).

    The clock is sampled once per ``update``, so the rate properties are
    mutually consistent between updates (cell_updates_per_second ==
    turns_per_second * cells_per_turn exactly, tests/test_aux.py)."""

    def __init__(self, cells_per_turn: int):
        self.cells_per_turn = cells_per_turn
        self._t0 = time.monotonic()
        self._turns = 0
        self._elapsed = 0.0

    def update(self, turns_completed: int):
        self._turns = turns_completed
        self._elapsed = time.monotonic() - self._t0

    @property
    def elapsed(self) -> float:
        return self._elapsed

    @property
    def turns_per_second(self) -> float:
        return self._turns / self._elapsed if self._elapsed else 0.0

    @property
    def cell_updates_per_second(self) -> float:
        return self.turns_per_second * self.cells_per_turn
