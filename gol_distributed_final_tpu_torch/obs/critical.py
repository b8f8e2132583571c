"""Straggler / critical-path attribution for the fan-out data plane.

    python -m gol_distributed_final_tpu_torch.obs.critical :8040   # live table
    python -m gol_distributed_final_tpu_torch.obs.critical --selfcheck

Every workers-backend turn is a barrier: the broker's gather completes
when the SLOWEST worker replies, so one persistently slow worker sets
the whole cluster's turn rate — invisibly, because nothing fails. This
module makes the gating visible: the broker records each worker's
per-call round-trip wall (``gol_strip_step_seconds{addr}`` for resident
StripStep batches; scatter Update calls feed the tracker too), and per
K-batch the tracker attributes the gather to the worker that gated it,
keeping per-address service-time EWMAs, gated counts, and a roster skew
ratio (slowest EWMA / roster median) published on
``gol_worker_skew_ratio`` — the 'worker-skew' SLO GrowthRule's feed.

The tracker's ``snapshot()`` rides the broker's Status payload
(``critical_path``), so the doctor's ``straggler`` heuristic and the
watch dashboard name the gating worker with per-address evidence rows —
within one K-batch of the skew appearing, because attribution happens at
every batch commit, not on a sampling window.

Pure stdlib; the hot-loop feed is guarded by ``metrics.enabled()`` AND
``perf.attribution_enabled()`` (the bench's decomposition-overhead gate
A/Bs the latter).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import threading
from typing import Dict, List, Optional, Tuple

from . import instruments as _ins
from ..utils import locksan as _locksan

#: EWMA smoothing for per-address service times (one K-batch is one step)
EWMA_ALPHA = 0.2
#: a worker is a STRAGGLER when it gated more than this share of batches...
STRAGGLER_GATED_SHARE = 0.5
#: ...AND its service-time EWMA exceeds the roster median by this ratio
STRAGGLER_SKEW_RATIO = 2.0


class _WorkerStat:
    __slots__ = ("ewma_s", "last_s", "calls", "gated")

    def __init__(self):
        self.ewma_s: Optional[float] = None
        self.last_s = 0.0
        self.calls = 0
        self.gated = 0


class CriticalPathTracker:
    """Per-address service-time EWMAs + per-batch gating attribution.

    ``record_batch`` is called once per committed K-batch from the
    broker's turn loop (single-threaded per run, but Status polls read
    concurrently — every touch is locked)."""

    _GUARDED_BY = {
        "_stats": "_lock",
        "_batches": "_lock",
        "_last_gating": "_lock",
    }

    def __init__(self):
        self._lock = _locksan.lock("CriticalPathTracker._lock")
        self._stats: Dict[str, _WorkerStat] = {}
        self._batches = 0
        self._last_gating: Optional[str] = None

    def record_batch(
        self,
        entries: List[Tuple[str, float, Optional[float]]],
        turn: int = 0,
        k: int = 1,
    ) -> Optional[str]:
        """Fold one batch's per-worker walls: ``entries`` is
        ``[(addr, round_trip_s, service_s | None)]`` (service is the
        worker-reported handler wall when the reply carried it — version
        skew degrades to the round trip). Returns the gating address.
        Updates the skew gauge; flight-records a gating change only when
        the skew is material (the ring must not churn per batch)."""
        if len(entries) < 1:
            return None
        gating_addr, gating_wall = None, -1.0
        with self._lock:
            for addr, rt, service in entries:
                wall = service if service else rt
                st = self._stats.setdefault(addr, _WorkerStat())
                st.last_s = wall
                st.calls += 1
                st.ewma_s = (
                    wall
                    if st.ewma_s is None
                    else (1 - EWMA_ALPHA) * st.ewma_s + EWMA_ALPHA * wall
                )
                if rt > gating_wall:
                    gating_addr, gating_wall = addr, rt
            self._batches += 1
            self._stats[gating_addr].gated += 1
            skew, _ = self._skew_locked()
            changed = gating_addr != self._last_gating
            self._last_gating = gating_addr
        _ins.WORKER_SKEW_RATIO.set(skew)
        if changed and skew >= STRAGGLER_SKEW_RATIO:
            from . import flight as _flight

            _flight.record(
                "critical.gate", gating_addr, turn=turn, k=k,
                skew=round(skew, 2),
            )
        return gating_addr

    def _skew_locked(self) -> Tuple[float, Optional[str]]:  # gol: holds(_lock)
        """(worst skew ratio, its address): slowest EWMA over the roster
        median. 1.0 for rosters of fewer than two measured workers (a
        lone worker cannot be skewed against anyone)."""
        ewmas = [
            (addr, st.ewma_s)
            for addr, st in self._stats.items()
            if st.ewma_s is not None
        ]
        if len(ewmas) < 2:
            return 1.0, None
        med = statistics.median(e for _, e in ewmas)
        if med <= 0:
            return 1.0, None
        addr, worst = max(ewmas, key=lambda p: p[1])
        return worst / med, addr

    def snapshot(self) -> dict:
        """JSON-able state for the Status payload: per-address evidence
        rows + the straggler verdict (None when the roster is
        balanced)."""
        with self._lock:
            batches = self._batches
            rows = [
                {
                    "addr": addr,
                    "ewma_s": round(st.ewma_s, 6) if st.ewma_s is not None else None,
                    "last_s": round(st.last_s, 6),
                    "calls": st.calls,
                    "gated": st.gated,
                    "gated_share": (
                        round(st.gated / batches, 4) if batches else 0.0
                    ),
                }
                for addr, st in sorted(self._stats.items())
            ]
            skew, skew_addr = self._skew_locked()
        out = {
            "batches": batches,
            "skew_ratio": round(skew, 3),
            "workers": rows,
            "straggler": None,
        }
        if batches and skew_addr is not None and skew >= STRAGGLER_SKEW_RATIO:
            row = next(r for r in rows if r["addr"] == skew_addr)
            if row["gated_share"] > STRAGGLER_GATED_SHARE:
                out["straggler"] = dict(row, skew=round(skew, 3))
        return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._batches = 0
            self._last_gating = None


# the process-global tracker (one broker per process — the obs posture)
_TRACKER = CriticalPathTracker()


def tracker() -> CriticalPathTracker:
    return _TRACKER


def attribute_batches(matrix: List[Dict[str, float]]) -> dict:
    """Pure-function attribution over a canned timing matrix
    (``[{addr: seconds}]`` per batch) through a FRESH tracker — the
    synthetic-fixture surface the tests pin the straggler math on."""
    t = CriticalPathTracker()
    for batch in matrix:
        t.record_batch([(a, s, None) for a, s in batch.items()])
    return t.snapshot()


def render(cp: dict) -> str:
    """Terminal table — pure function of a critical_path snapshot."""
    head = (
        f"critical path — {cp.get('batches', 0)} batch(es), roster skew "
        f"{cp.get('skew_ratio', 1.0):.2f}x"
    )
    cols = (
        f"{'worker':<24} {'ewma':>10} {'last':>10} {'calls':>6} "
        f"{'gated':>6} {'share':>7}"
    )
    lines = [head, cols, "-" * len(cols)]
    for r in cp.get("workers") or []:
        ewma = r.get("ewma_s")
        lines.append(
            f"{r.get('addr', '?'):<24} "
            f"{(f'{ewma * 1e3:.2f}ms' if ewma is not None else '-'):>10} "
            f"{r.get('last_s', 0.0) * 1e3:>8.2f}ms "
            f"{r.get('calls', 0):>6} {r.get('gated', 0):>6} "
            f"{100 * (r.get('gated_share') or 0.0):>6.1f}%"
        )
    s = cp.get("straggler")
    if s:
        lines.append(
            f"STRAGGLER: {s.get('addr')} gates {100 * s['gated_share']:.0f}% "
            f"of batches at {s.get('skew', 0):.1f}x the roster median"
        )
    return "\n".join(lines)


def _selfcheck() -> int:
    """The ``scripts/check --perf`` straggler smoke: a synthetic
    4-worker timing matrix with one 6x-slow worker must be attributed
    to that worker — and a balanced matrix must NOT name anyone."""
    slow = [
        {":8030": 0.010, ":8031": 0.011, ":8032": 0.060, ":8033": 0.009}
        for _ in range(5)
    ]
    cp = attribute_batches(slow)
    print(render(cp))
    s = cp.get("straggler")
    if not s or s.get("addr") != ":8032":
        print("critical selfcheck FAILED: straggler not attributed to "
              ":8032", file=sys.stderr)
        return 1
    balanced = [
        {":8030": 0.010, ":8031": 0.011, ":8032": 0.010, ":8033": 0.009}
        for _ in range(5)
    ]
    if attribute_batches(balanced).get("straggler") is not None:
        print("critical selfcheck FAILED: balanced roster produced a "
              "straggler", file=sys.stderr)
        return 1
    print("critical selfcheck ok: straggler attribution exact on the "
          "synthetic matrix")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="critical-path / straggler attribution over the "
        "read-only Status verb"
    )
    parser.add_argument(
        "address", nargs="?", default=None,
        help="broker host:port (or :port)",
    )
    parser.add_argument(
        "-timeout", type=float, default=5.0, metavar="SECONDS",
        help="poll reply bound (default 5)",
    )
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="synthetic-matrix attribution smoke (the scripts/check "
             "--perf gate)",
    )
    args = parser.parse_args(argv)
    if args.selfcheck:
        return _selfcheck()
    if not args.address:
        parser.error("an address is required (or --selfcheck)")
    from .status import StatusUnavailable, fetch_status

    try:
        payload = fetch_status(args.address, timeout=args.timeout)
    except StatusUnavailable as exc:
        print(f"critical: no status — {exc}", file=sys.stderr)
        return 1
    except Exception as exc:
        print(f"critical: poll failed — {exc}", file=sys.stderr)
        return 1
    cp = payload.get("critical_path")
    if not cp or not cp.get("batches"):
        print("critical: the broker has recorded no fan-out batches "
              "(tpu backend, or the run has not started)", file=sys.stderr)
        return 1
    print(render(cp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
