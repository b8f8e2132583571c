"""Performance attribution: the roofline classifier + dispatch-wall
decomposition summary.

    python -m gol_distributed_final_tpu_torch.obs.perf :8040          # live poll
    python -m gol_distributed_final_tpu_torch.obs.perf BENCH_r04.json # bench round
    python -m gol_distributed_final_tpu_torch.obs.perf --selfcheck    # CI smoke

Every unclaimed ROADMAP compute lever (fused-K kernel, 2-D sharding,
sparsity) is justified by a claim like "the 128² case is latency-bound"
that until now lived only as a prose note beside BENCH_r04. This module
turns that claim into a measurement: it joins each launch's int32
operation and byte counts (the roofline bound's model, ``gol_kernel_flops
{site}`` / ``gol_kernel_bytes_accessed{site}``) with its device time from
CUDA events (``gol_kernel_dispatch_seconds{site}``, accumulated exactly
per launch in obs/device.py) to compute achieved operations/s and bytes/s
per kernel site, and classifies each site against calibrated device
ceilings:

* ``compute-bound``   — FLOP utilization dominates and is substantial;
* ``memory-bound``    — bytes/s utilization dominates and is substantial;
* ``launch-bound``    — the site achieves a small fraction of BOTH
  ceilings: neither the ALUs nor the memory system is the limit, so the
  wall is launch/issue latency — the class the fused-K kernel exists to
  kill, and the class admission for that PR is gated on.

Ceilings are calibrated ONCE per device kind and cached: the H100 maps
to its int32 and HBM peaks (``KNOWN_CUDA_PEAKS``), TPU kinds (a JAX
package's broker polled from here) to a table of known (approximate,
vector-unit) peaks; anything else gets
a fitted CPU ceiling from a one-shot numpy microbench (GEMM for FLOP/s,
a large copy for bytes/s). The calibration caveats are documented in the
README "Performance attribution" section — the classes are coarse by
design (an order-of-magnitude utilization call), not a profiler.

``decomposition_summary`` renders the dispatch-wall decomposition
(``gol_turn_segment_seconds{component,segment}`` — engine/sessions/
broker walls split into host_prep / device_compute / wire / demux) from
any registry snapshot: the RunReport embeds it and the watch dashboard's
WHERE-TIME-GOES panel renders it.

``set_attribution(False)`` disables the whole hot-loop attribution layer
(segment observes, per-worker call walls, the critical-path tracker) —
the A/B lever the bench's ≤2 % decomposition-overhead gate prices.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from . import instruments as _ins
from . import metrics as _metrics

logger = logging.getLogger(__name__)

#: the stable class vocabulary (the ``gol_kernel_bound{class}`` label set)
BOUND_CLASSES = ("compute-bound", "memory-bound", "launch-bound")

#: a site achieving less than this fraction of BOTH ceilings is limited by
#: neither compute nor memory — launch/issue latency is the residual
LAUNCH_UTILIZATION = 0.10

#: analytic cost model for bench cases (per cell per turn) — used when a
#: BENCH round carries only the per-turn fit (salvaged tails have no
#: stage_timings). The packed bitboard kernel does ~44 word ops per 32
#: cells per turn (~1.4 ops/cell) and touches each packed word twice
#: (read + write: 2/8 byte per cell). Documented caveats in the README.
MODEL_FLOPS_PER_CELL = 1.4
MODEL_BYTES_PER_CELL = 0.25

#: approximate VECTOR-unit peaks per TPU device kind: (flop/s, bytes/s).
#: These are deliberately coarse published-order-of-magnitude numbers for
#: the non-MXU ops a bitboard stencil issues — good enough to separate
#: "saturating a ceiling" from "two orders below every ceiling", which is
#: all the classifier claims. Matched by substring on device_kind.
KNOWN_TPU_PEAKS = (
    ("v6e", 4.0e13, 1.6e12),
    ("trillium", 4.0e13, 1.6e12),
    ("v5p", 2.3e13, 2.7e12),
    ("v5e", 2.0e13, 8.1e11),
    ("v5lite", 2.0e13, 8.1e11),
    ("v4", 1.5e13, 1.2e12),
    ("v3", 1.0e13, 9.0e11),
    ("v2", 6.0e12, 7.0e11),
    ("tpu", 1.5e13, 8.0e11),  # unrecognised TPU kind: a conservative floor
)

#: the card's ceilings by ``torch.cuda.get_device_name()`` substring:
#: (int32 operations/s, bytes/s). The H100 SXM's int32 rate is 64 int32
#: instructions a clock an SM (CUDA C++ Programming Guide, compute
#: capability 9.0 throughput table) x 132 SMs x 1980 MHz (its
#: ``clocks.max.sm``) = 1.673e13 per s; its HBM3 moves 3.35e12 B/s (NVIDIA's
#: data sheet). Both assume the 700 W power limit; the bitboard kernels'
#: bound (PERF.md section 3) uses the same two figures.
KNOWN_CUDA_PEAKS = (
    ("h100", 1.673e13, 3.35e12),
)


@dataclass
class Ceilings:
    """One device kind's calibrated roofline ceilings."""

    device_kind: str
    flops_per_s: float
    bytes_per_s: float
    launch_seconds: float  # per-dispatch floor (reported, not classifying)
    source: str  # "known" (H100 or TPU table) | "fitted" (numpy microbench)


# one-time-per-device-kind calibration cache (the ISSUE's contract: the
# microbench runs on first use per kind, never per classification)
_CEILINGS_CACHE: Dict[str, Ceilings] = {}
_CEILINGS_LOCK = threading.Lock()
# microbench invocation count — the test hook pinning the cache contract
_FIT_RUNS = 0

# hot-loop attribution switch (segments + per-call walls + the critical-
# path tracker): the bench's decomposition-overhead gate A/Bs it
_ATTRIBUTION = True

# refresh-failure tally: paces the warning log so a per-poll bug does not
# flood stderr while still leaving UNCONDITIONAL evidence (the PR 9
# rulebook-evaluation posture — a silently dead roofline layer is the
# failure mode this exists to prevent)
_REFRESH_ERRORS = 0


def set_attribution(on: bool) -> None:
    global _ATTRIBUTION
    _ATTRIBUTION = bool(on)


def attribution_enabled() -> bool:
    """One module-global read — the hot-loop guard every decomposition
    site checks alongside ``metrics.enabled()``."""
    return _ATTRIBUTION


def _fit_cpu_ceilings() -> tuple:
    """One-shot numpy microbench: attainable FLOP/s from a small GEMM
    (the classic peak proxy) and bytes/s from a large array copy. Both
    min-over-reps so a scheduler hiccup inflates nothing."""
    global _FIT_RUNS
    _FIT_RUNS += 1
    import numpy as np

    n = 384
    a = np.random.default_rng(0).random((n, n), dtype=np.float32)
    b = np.random.default_rng(1).random((n, n), dtype=np.float32)
    a @ b  # warm
    t_gemm = None
    for _ in range(3):
        t0 = time.perf_counter()
        a @ b
        dt = time.perf_counter() - t0
        t_gemm = dt if t_gemm is None else min(t_gemm, dt)
    flops = 2.0 * n * n * n / max(t_gemm, 1e-9)

    src = np.zeros(32 << 20, dtype=np.uint8)  # 32 MiB
    np.copy(src)  # warm
    t_copy = None
    for _ in range(3):
        t0 = time.perf_counter()
        np.copy(src)
        dt = time.perf_counter() - t0
        t_copy = dt if t_copy is None else min(t_copy, dt)
    bytes_per_s = 2.0 * src.nbytes / max(t_copy, 1e-9)
    return flops, bytes_per_s


def _measure_launch_floor() -> float:
    """Median wall of a tiny op followed by its wait — the per-launch floor
    the launch-bound class names: ``x + 1`` on the card then
    ``torch.cuda.synchronize()``, or on the CPU where there is no card.
    Median of 7, after one warm-up."""
    try:
        import torch

        cuda = torch.cuda.is_available()
        x = torch.zeros((8, 8), dtype=torch.int32, device="cuda" if cuda else "cpu")

        def once():
            y = x + 1
            if cuda:
                torch.cuda.synchronize()
            return y

        once()  # first-use set-up outside the timing
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            once()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[len(walls) // 2]
    # the launch floor is reported decoration, not a classifying input —
    # a backend that cannot measure it returns the 0 sentinel
    except Exception:
        return 0.0


def _local_device_kind() -> str:
    """The local card's name (``torch.cuda.get_device_name(0)``), or
    ``cpu`` without one."""
    try:
        import torch

        if not torch.cuda.is_available():
            return "cpu"
        return torch.cuda.get_device_name(0).lower()
    # an unqueryable card degrades to the fitted CPU ceilings —
    # calibration must never raise out of a Status poll
    except Exception:
        return "cpu"


def calibrate(device_kind: Optional[str] = None) -> Ceilings:
    """The ceilings for one device kind, calibrated once and cached.

    The H100 resolves from ``KNOWN_CUDA_PEAKS`` and TPU kinds from
    ``KNOWN_TPU_PEAKS`` (source="known"); anything
    else pays the one-shot numpy microbench (source="fitted"). The cache
    key is the NORMALISED kind string, so every later call — Status
    polls, bench cases, CLI renders — is a dict hit."""
    kind = (device_kind or _local_device_kind()).lower()
    with _CEILINGS_LOCK:
        hit = _CEILINGS_CACHE.get(kind)
    if hit is not None:
        return hit
    peaks = None
    for needle, fl, by in KNOWN_CUDA_PEAKS + KNOWN_TPU_PEAKS:
        if needle in kind:
            peaks = (fl, by, "known")
            break
    if peaks is None:
        fl, by = _fit_cpu_ceilings()
        peaks = (fl, by, "fitted")
    ceil = Ceilings(
        device_kind=kind,
        flops_per_s=peaks[0],
        bytes_per_s=peaks[1],
        launch_seconds=_measure_launch_floor(),
        source=peaks[2],
    )
    with _CEILINGS_LOCK:
        # first writer wins: a racing second calibration of the same kind
        # must not replace the object callers already hold
        return _CEILINGS_CACHE.setdefault(kind, ceil)


def _ceilings_if_ready() -> Optional[Ceilings]:
    """The local device's ceilings WITHOUT paying calibration inline:
    a cache hit returns immediately; a miss kicks ONE background daemon
    calibration and returns None. This is the Status-poll path — the
    poll that exists to debug a busy broker must not block on a GEMM
    microbench or queue launch-floor dispatches behind the workload
    (classes appear from the next poll on, typically <1 s later)."""
    kind = _local_device_kind()
    with _CEILINGS_LOCK:
        hit = _CEILINGS_CACHE.get(kind)
        if hit is not None:
            return hit
        if _CALIBRATING[0]:
            return None
        _CALIBRATING[0] = True

    def _bg():
        try:
            calibrate(kind)
        except Exception as exc:
            logger.warning("background ceiling calibration failed: %s", exc)
        finally:
            _CALIBRATING[0] = False

    threading.Thread(target=_bg, name="gol-perf-calibrate", daemon=True).start()
    return None


# one in-flight background calibration at a time (list: mutated from the
# worker thread without rebinding a module global under the lock)
_CALIBRATING = [False]


def reset_ceilings() -> None:
    """Forget the calibration cache and fit counter (tests)."""
    global _FIT_RUNS
    with _CEILINGS_LOCK:
        _CEILINGS_CACHE.clear()
    _FIT_RUNS = 0


# -- the classifier core ------------------------------------------------------


def classify(
    achieved_flops: float, achieved_bytes_per_s: float, ceilings: Ceilings
) -> dict:
    """One site/case's roofline verdict from its achieved throughputs.

    A site far below BOTH ceilings (< ``LAUNCH_UTILIZATION`` of each) is
    ``launch-bound`` — neither the ALUs nor the memory system explains
    its wall, so launch/issue latency does. Otherwise the larger
    utilization names the binding ceiling. A zero-flops degenerate site
    (cost analysis reported nothing) can still be memory-bound via its
    bytes; all-zero sites are launch-bound by definition."""
    u_c = achieved_flops / ceilings.flops_per_s if ceilings.flops_per_s else 0.0
    u_m = (
        achieved_bytes_per_s / ceilings.bytes_per_s
        if ceilings.bytes_per_s
        else 0.0
    )
    if max(u_c, u_m) < LAUNCH_UTILIZATION:
        bound = "launch-bound"
    elif u_c >= u_m:
        bound = "compute-bound"
    else:
        bound = "memory-bound"
    return {
        "achieved_flops": achieved_flops,
        "achieved_bytes_per_s": achieved_bytes_per_s,
        "flops_utilization": u_c,
        "memory_utilization": u_m,
        "bound_class": bound,
    }


def classify_case(
    height: int, width: int, per_turn_s: float, ceilings: Ceilings
) -> dict:
    """A bench kernel case's roofline fields from its geometry and
    per-turn fit, via the analytic stencil cost model (the path salvaged
    BENCH rounds — no stage_timings — still support). Returns the fields
    bench.py embeds per case: achieved_flops / achieved_bytes_per_s /
    bound_class (+ utilizations)."""
    cells = float(height) * float(width)
    if per_turn_s <= 0:
        return classify(0.0, 0.0, ceilings)
    out = classify(
        cells * MODEL_FLOPS_PER_CELL / per_turn_s,
        cells * MODEL_BYTES_PER_CELL / per_turn_s,
        ceilings,
    )
    out["cost_model"] = (
        f"{MODEL_FLOPS_PER_CELL} flops + {MODEL_BYTES_PER_CELL} B "
        "per cell-turn (packed bitboard model)"
    )
    return out


# -- live-site classification (the obs/device.py accumulators) ---------------


def refresh_metrics(ceilings: Optional[Ceilings] = None) -> List[dict]:
    """Classify every instrumented kernel site from the exact dispatch
    accumulators (obs/device.dispatch_stats) and publish the results on
    the ``gol_kernel_achieved_flops`` / ``_achieved_bytes_per_s`` /
    ``gol_kernel_bound`` gauges. Called from Status polls and report
    writes; a process with no dispatch stats (a worker that launched no
    kernel) returns
    immediately. Never raises — attribution must only observe."""
    from . import device as _device

    try:
        stats = _device.dispatch_stats()
        if not stats or not _metrics.enabled():
            return []
        if ceilings is None:
            # never calibrate INLINE on this path (Status polls ride it):
            # a miss kicks a background calibration and this poll
            # publishes achieved gauges only — classes follow next poll
            ceilings = _ceilings_if_ready()
        rows = []
        for site, s in sorted(stats.items()):
            wall = s["wall_s"]
            if wall <= 0 or not s["calls"]:
                continue
            af = s["flops"] / wall
            ab = s["bytes_accessed"] / wall
            _ins.KERNEL_ACHIEVED_FLOPS.labels(site).set(af)
            _ins.KERNEL_ACHIEVED_BYTES.labels(site).set(ab)
            if ceilings is None:
                continue
            row = classify(af, ab, ceilings)
            row.update(
                site=site,
                calls=s["calls"],
                wall_s=wall,
                mean_dispatch_s=wall / s["calls"],
            )
            for cls in BOUND_CLASSES:
                _ins.KERNEL_BOUND.labels(site, cls).set(
                    1.0 if cls == row["bound_class"] else 0.0
                )
            rows.append(row)
        return rows
    except Exception as exc:
        # refresh rides Status polls and report writes — a calibration/
        # attribution bug must degrade to "no roofline rows", never break
        # the poll that exists to debug it. But it must leave evidence:
        # paced (first + every 60th) so a broken roofline layer is
        # visible instead of silently never classifying again.
        global _REFRESH_ERRORS
        _REFRESH_ERRORS += 1
        if _REFRESH_ERRORS == 1 or _REFRESH_ERRORS % 60 == 0:
            logger.warning(
                "roofline refresh failed (%d time(s)): %s",
                _REFRESH_ERRORS, exc,
            )
        return []


# -- dispatch-wall decomposition summary --------------------------------------

SEGMENTS = ("host_prep", "device_compute", "wire", "demux")


def decomposition_summary(snap: Optional[dict] = None) -> dict:
    """WHERE-TIME-GOES from a registry snapshot: per component, each
    segment's total wall, observation count, and share of the
    component's decomposed wall — the RunReport's embedded breakdown and
    the watch panel's feed. Empty dict when nothing was decomposed."""
    if snap is None:
        snap = _metrics.registry().snapshot()
    per: Dict[str, Dict[str, dict]] = {}
    for fam in snap.get("families", []):
        if fam.get("name") != "gol_turn_segment_seconds":
            continue
        for s in fam.get("series", []):
            labels = s.get("labels") or []
            if len(labels) != 2 or not s.get("count"):
                continue
            component, segment = labels
            per.setdefault(component, {})[segment] = {
                "sum_s": round(s.get("sum", 0.0), 6),
                "count": s.get("count", 0),
            }
    for component, segs in per.items():
        total = sum(e["sum_s"] for e in segs.values())
        for e in segs.values():
            e["share"] = round(e["sum_s"] / total, 4) if total > 0 else 0.0
        segs["_total_s"] = round(total, 6)
    return per


# -- rendering ----------------------------------------------------------------


def _fmt_rate(v: float) -> str:
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if v >= scale:
            return f"{v / scale:.2f}{suffix}"
    return f"{v:.1f}"


def render_roofline(rows: List[dict], ceilings: Ceilings) -> str:
    """The roofline table — pure function of classified rows (the
    obs/watch.py renderer posture, unit-testable without a device)."""
    head = (
        f"roofline vs {ceilings.device_kind} ceilings "
        f"({_fmt_rate(ceilings.flops_per_s)}FLOP/s, "
        f"{_fmt_rate(ceilings.bytes_per_s)}B/s, {ceilings.source}"
        + (
            f", launch floor {ceilings.launch_seconds * 1e6:.1f}us"
            if ceilings.launch_seconds
            else ""
        )
        + ")"
    )
    cols = (
        f"{'site/case':<30} {'flop/s':>9} {'bytes/s':>9} "
        f"{'%flop':>6} {'%mem':>6}  class"
    )
    lines = [head, cols, "-" * len(cols)]
    for row in rows:
        lines.append(
            f"{row.get('site') or row.get('case', '?'):<30} "
            f"{_fmt_rate(row['achieved_flops']):>9} "
            f"{_fmt_rate(row['achieved_bytes_per_s']):>9} "
            f"{100 * row['flops_utilization']:>5.1f}% "
            f"{100 * row['memory_utilization']:>5.1f}%  "
            f"{row['bound_class']}"
        )
    return "\n".join(lines)


# -- BENCH round rendering ----------------------------------------------------

# kernel-case geometry parses from the stable case-name convention
# (c2_128_..., c5_65536_...); non-kernel cases (wire, loadgen) have no
# board size in their name and are skipped by the model path
_CASE_SIZE_RE = re.compile(r"^c\d+_(\d+)_")


def rows_from_bench(path, ceilings: Ceilings, bench: Optional[dict] = None) -> List[dict]:
    """Roofline rows for one BENCH round: per kernel case, the embedded
    roofline fields when the round carries them (bench.py embeds them
    from this PR on), else the analytic model from the case-name
    geometry + per-turn fit (the only path a salvaged tail supports).
    ``bench`` skips the load when the caller already holds the loaded
    round (the CLI loads once for provenance and reuses it here)."""
    from .regress import load_bench

    if bench is None:
        bench = load_bench(path)
    rows = []
    for name, case in sorted(bench["cases"].items()):
        per_turn_us = case.get("per_turn_us")
        if not per_turn_us or per_turn_us <= 0:
            # a non-positive fit is a broken measurement (the round-2 c5
            # negative-throughput class): excluded, never classified
            continue
        if case.get("bound_class") and case.get("achieved_flops") is not None:
            row = {
                "achieved_flops": case["achieved_flops"],
                "achieved_bytes_per_s": case.get("achieved_bytes_per_s", 0.0),
                "flops_utilization": case.get("flops_utilization", 0.0),
                "memory_utilization": case.get("memory_utilization", 0.0),
                "bound_class": case["bound_class"],
            }
        else:
            m = _CASE_SIZE_RE.match(name)
            if not m:
                continue
            size = int(m.group(1))
            row = classify_case(size, size, per_turn_us * 1e-6, ceilings)
        row["case"] = name
        row["per_turn_us"] = per_turn_us
        rows.append(row)
    return rows


def server_bound_classes(snap: dict) -> Dict[str, str]:
    """``{site: class}`` from a snapshot's ``gol_kernel_bound`` gauges —
    the one extraction of the server-published classification, shared by
    ``rows_from_status`` and the watch ROOFLINE panel so the gauge's
    label shape cannot silently diverge between the two readers."""
    from .status import series_map

    return {
        labels[0]: labels[1]
        for labels, s in series_map(snap, "gol_kernel_bound").items()
        if len(labels) == 2 and s.get("value")
    }


def rows_from_status(payload: dict, ceilings: Ceilings) -> List[dict]:
    """Roofline rows from a live Status payload. The SERVER's published
    bound class (``gol_kernel_bound`` — classified against the ceilings
    of the device that actually ran the kernels) is authoritative and
    kept when present (``class_source: "server"``); the caller-side
    ``ceilings`` only fill in the utilization columns and the class for
    version-skewed servers that never published one — the only case
    where a local reclassification is honest."""
    from .status import series_map

    snap = payload.get("metrics") or {}
    achieved_f = series_map(snap, "gol_kernel_achieved_flops")
    achieved_b = series_map(snap, "gol_kernel_achieved_bytes_per_s")
    dispatch = series_map(snap, "gol_kernel_dispatch_seconds")
    server_cls = server_bound_classes(snap)
    rows = []
    for labels in sorted(achieved_f):
        site = labels[0] if labels else "?"
        af = (achieved_f.get(labels) or {}).get("value") or 0.0
        ab = (achieved_b.get(labels) or {}).get("value") or 0.0
        row = classify(af, ab, ceilings)
        if site in server_cls:
            row["bound_class"] = server_cls[site]
            row["class_source"] = "server"
        else:
            row["class_source"] = "local-ceilings"
        d = dispatch.get(labels)
        if d and d.get("count"):
            row["calls"] = d["count"]
            row["mean_dispatch_s"] = d.get("sum", 0.0) / d["count"]
        row["site"] = site
        rows.append(row)
    return rows


# -- CLI ----------------------------------------------------------------------


def _selfcheck() -> int:
    """The ``scripts/check --perf`` smoke: enable metrics, push a real
    (CPU) kernel through the instrumented dispatch path, calibrate the
    fitted ceilings, classify, and render — failing on an empty table,
    an unknown class, or a calibration cache miss on the second hit."""
    import numpy as np

    from ..device import resolve_device
    from ..models import CONWAY
    from ..ops.auto import auto_plane
    from . import device as _device

    _metrics.enable()
    import torch

    dev = resolve_device("cuda" if torch.cuda.is_available() else "cpu")
    plane = auto_plane(CONWAY, (128, 128), dev)
    if plane is None:
        from ..ops.plane import BytePlane

        plane = BytePlane(CONWAY, device=dev)
    rng = np.random.default_rng(3)
    board = np.where(rng.random((128, 128)) < 0.3, 255, 0).astype(np.uint8)
    state = plane.encode(board)
    for _ in range(3):
        state = plane.step_n(state, 8)
        plane.alive_count(state)  # force the dispatch to completion
    stats = _device.dispatch_stats()
    if not stats:
        print("perf selfcheck FAILED: no instrumented dispatches recorded",
              file=sys.stderr)
        return 1
    ceilings = calibrate()
    fits_before = _FIT_RUNS
    again = calibrate()
    if again is not ceilings or _FIT_RUNS != fits_before:
        print("perf selfcheck FAILED: ceiling calibration was not cached",
              file=sys.stderr)
        return 1
    rows = refresh_metrics(ceilings)
    if not rows or any(r["bound_class"] not in BOUND_CLASSES for r in rows):
        print("perf selfcheck FAILED: no classified roofline rows",
              file=sys.stderr)
        return 1
    print(render_roofline(rows, ceilings))
    decomp = decomposition_summary()
    print(f"perf selfcheck ok: {len(rows)} site(s) classified, "
          f"{len(decomp)} decomposed component(s)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="roofline attribution: classify kernel sites/cases "
        "as compute-/memory-/launch-bound against calibrated device "
        "ceilings"
    )
    parser.add_argument(
        "target", nargs="?", default=None,
        help="a broker host:port (live Status poll) or a BENCH_r*.json "
             "round",
    )
    parser.add_argument(
        "--device-kind", dest="device_kind", default=None,
        help="classify against this device kind's ceilings instead of "
             "the local device's (required for honest classes when a "
             "BENCH round's provenance was truncated away)",
    )
    parser.add_argument(
        "-timeout", type=float, default=5.0, metavar="SECONDS",
        help="live-poll reply bound (default 5)",
    )
    parser.add_argument(
        "-json", action="store_true",
        help="print the classified rows as JSON instead of the table",
    )
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="loopback smoke: instrumented CPU dispatches -> calibrate "
             "-> classify -> render (the scripts/check --perf gate)",
    )
    args = parser.parse_args(argv)
    if args.selfcheck:
        return _selfcheck()
    if not args.target:
        parser.error("a target is required (or --selfcheck)")

    import pathlib

    is_file = args.target.endswith(".json") or pathlib.Path(args.target).is_file()
    if is_file:
        from .regress import BenchLoadError, load_bench

        try:
            bench = load_bench(args.target)
        except (OSError, BenchLoadError) as exc:
            print(f"perf: {exc}", file=sys.stderr)
            return 2
        prov = bench.get("provenance") or {}
        kind = args.device_kind or prov.get("device_kind") or prov.get("platform")
        if kind is None:
            print(
                "warning: round carries no provenance (truncated tail?) "
                "and no --device-kind was given — classifying against "
                "the LOCAL device's ceilings, which is only honest if "
                "this round was measured here", file=sys.stderr,
            )
        ceilings = calibrate(kind)
        rows = rows_from_bench(args.target, ceilings, bench=bench)
    else:
        from .status import StatusUnavailable, fetch_status

        try:
            payload = fetch_status(args.target, timeout=args.timeout)
        except StatusUnavailable as exc:
            print(f"perf: no status — {exc}", file=sys.stderr)
            return 1
        except Exception as exc:
            print(f"perf: poll failed — {exc}", file=sys.stderr)
            return 1
        ceilings = calibrate(args.device_kind)
        rows = rows_from_status(payload, ceilings)
        if not args.device_kind and any(
            r.get("class_source") == "local-ceilings" for r in rows
        ):
            print(
                "warning: the server published no bound class for some "
                "sites (version skew) — those classes are computed "
                "against the LOCAL device's ceilings, which is only "
                "honest if the server runs the same device kind (pass "
                "--device-kind otherwise)", file=sys.stderr,
            )
        decomp = decomposition_summary(payload.get("metrics") or {})
        if decomp and not args.json:
            print("WHERE TIME GOES (per component):")
            for component, segs in sorted(decomp.items()):
                parts = [
                    f"{seg} {e['sum_s']:.3f}s ({100 * e['share']:.0f}%)"
                    for seg, e in sorted(segs.items())
                    if isinstance(e, dict)
                ]
                print(f"  {component:<10} " + "  ".join(parts))
            print()
    if not rows:
        print("perf: nothing to classify (no kernel sites/cases with "
              "dispatch data)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(
            {"ceilings": ceilings.__dict__, "rows": rows}, indent=1,
            default=str,
        ))
    else:
        print(render_roofline(rows, ceilings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
