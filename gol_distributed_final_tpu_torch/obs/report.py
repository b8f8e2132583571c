"""RunReport writer + Status payload builder.

A RunReport is the per-run attribution artifact: the full metrics snapshot
plus the device inventory (the CUDA devices of ``torch.cuda``) and per-device memory
stats, dumped to ``out/report_<W>x<H>x<Turns>.json`` when the controller
reaches ``FinalTurnComplete``. BENCH rounds embed its compact
``stage_timings`` so every published number carries its own breakdown
(bench.py), instead of the ad-hoc timers earlier rounds hand-rolled.

The Status payload is the same registry snapshot without the inventory —
served by the broker's and worker's read-only ``Status`` RPC verb, so an
operator can interrogate a RUNNING process without disturbing it
(``python -m gol_distributed_final_tpu_torch.obs.status host:port``).
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Optional

from . import accounting, flight, metrics, timeline, tracing
from . import critical as _critical
from . import journal as _journal
from . import perf as _perf
from . import profiler as _profiler

SCHEMA = "gol-run-report/1"


def status_payload(
    timeline_since: int = 0, accounting_since: int = 0,
    journal_since: int = 0, profile_since: int = 0, **extra
) -> dict:
    """The ``Status`` verb's reply body: registry snapshot + identity.

    Deliberately device-free: it queries no card (no inventory, no
    synchronisation), so the verb stays cheap enough to poll while an
    engine runs.

    With tracing on, the payload also carries the span ring (the material
    a controller's Chrome-trace export is built from) and the flight
    recorder's last-events ring — so a WEDGED process can be post-mortemed
    live over one read-only RPC.

    With the timeline sampler on (``-timeline``), the payload carries an
    INCREMENTAL metric-timeline window — only samples past the caller's
    ``timeline_since`` seq (the ``Request.timeline_since`` extension
    field), with server-computed rates/quantiles in its ``summary`` —
    plus the SLO rulebook's alert states (obs/slo.py), so one poll sees
    cluster health without client-side reconstruction."""
    reg = metrics.registry()
    # refresh the roofline gauges BEFORE the snapshot: a process with
    # instrumented kernel dispatches publishes achieved FLOP/s, bytes/s,
    # and bound classes on its own poll (obs/perf.py; a no-op in a
    # process that never launched a kernel)
    _perf.refresh_metrics()
    payload = {
        "schema": "gol-status/1",
        "pid": os.getpid(),
        "time_unix": time.time(),
        "metrics_enabled": reg.enabled,
        "metrics": reg.snapshot(),
    }
    cp = _critical.tracker().snapshot()
    if cp.get("batches"):
        # straggler/critical-path attribution (obs/critical.py) — the
        # doctor's 'straggler' heuristic and the watch panel read this
        payload["critical_path"] = cp
    if tracing.enabled():
        payload["trace_spans"] = tracing.tracer().snapshot()
    if flight.enabled():
        payload["flight"] = flight.recorder().snapshot()
    sampler = timeline.sampler()
    if sampler is not None:
        # opportunistic tick: a GIL-saturated (or just-started) process
        # whose background thread has not run still answers the poll
        # with a due sample instead of a stale ring
        sampler.maybe_sample()
        payload["timeline"] = sampler.window(since=timeline_since)
        if sampler.rulebook is not None:
            payload["alerts"] = sampler.rulebook.snapshot()
    ledger = accounting.ledger()
    if ledger.has_data:
        # the per-tenant usage ledger (obs/accounting.py) — incremental
        # past the caller's accounting_since seq, bounded at top-K
        # tenants + the 'other' bucket either way
        payload["accounting"] = ledger.window(since=accounting_since)
    jw = _journal.window(since=journal_since)
    if jw is not None:
        # the lifecycle journal's incremental tail (obs/journal.py) —
        # the live half of `python -m ..obs.history` and the watch
        # JOURNAL panel; only events past the caller's journal_since
        payload["journal"] = jw
    pw = _profiler.window(since=profile_since)
    if pw is not None:
        # the continuous profiler's incremental window (obs/profiler.py)
        # — only frames whose hits moved past the caller's profile_since
        # seq; the doctor's hotspot join, the watch PROFILE panel, and
        # obs/flame.py's live lane all read this
        payload["profile"] = pw
    payload.update(extra)
    return payload


def stage_timings(snap: Optional[dict] = None) -> dict:
    """Compact per-stage attribution from a snapshot: every nonzero
    histogram series as ``{count, sum_s, mean_s}`` and every nonzero
    counter as its value, keyed ``name{label=value,...}``. The form BENCH
    rounds embed (bench.py) — small enough to diff across rounds."""
    if snap is None:
        snap = metrics.registry().snapshot()
    out: dict = {}
    for fam in snap.get("families", []):
        labelnames = fam.get("labelnames", [])
        for s in fam["series"]:
            pairs = ",".join(
                f"{n}={v}" for n, v in zip(labelnames, s["labels"])
            )
            key = fam["name"] + (f"{{{pairs}}}" if pairs else "")
            if fam["type"] == "histogram":
                if s["count"]:
                    out[key] = {
                        "count": s["count"],
                        "sum_s": round(s["sum"], 6),
                        "mean_s": round(s["sum"] / s["count"], 9),
                    }
            elif s["value"]:
                out[key] = s["value"]
    return out


def device_inventory() -> dict:
    """The local devices' identity + per-device memory stats: every CUDA
    device of ``torch.cuda``, or the CPU where there is none (its
    ``memory_stats`` null).

    ``hbm_peak_observed_bytes`` is the high-water ``bytes_in_use`` across
    every sample this process took (per turn-chunk and at every
    checkpoint — obs/device.py), NOT just the final reading: a mid-run
    HBM spike that subsided before FinalTurnComplete still shows here.
    ``process_index`` is the ``torch.distributed`` rank, else 0."""
    import torch

    from . import device as _device

    rank, world = 0, 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    peaks = _device.hbm_peak_observed()
    devices = []
    if torch.cuda.is_available():
        for index in range(torch.cuda.device_count()):
            devices.append({
                "id": index,
                "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(index),
                "process_index": rank,
                "memory_stats": _device.card_memory_stats(index),
                "hbm_peak_observed_bytes": peaks.get(str(index)),
            })
    else:
        devices.append({
            "id": 0,
            "platform": "cpu",
            "device_kind": "cpu",
            "process_index": rank,
            "memory_stats": None,
            "hbm_peak_observed_bytes": None,
        })
    return {
        "backend": devices[0]["platform"],
        "process_count": world,
        "local_devices": devices,
    }


def report_path(params, out_dir="out") -> pathlib.Path:
    # rides the load-bearing <W>x<H>x<Turns> naming convention
    # (params.output_filename, gol/distributor.go:165)
    return pathlib.Path(out_dir) / f"report_{params.output_filename}.json"


def write_run_report(
    params,
    out_dir="out",
    *,
    wall_seconds: Optional[float] = None,
    extra: Optional[dict] = None,
) -> pathlib.Path:
    """Dump the registry + device inventory for a finished run. Written to
    a temp name then renamed, like the checkpoint writer, so a crash
    mid-dump never leaves a half-parseable report."""
    _perf.refresh_metrics()  # achieved/bound gauges land in the snapshot
    snap = metrics.registry().snapshot()
    report = {
        "schema": SCHEMA,
        "params": {
            "image_width": params.image_width,
            "image_height": params.image_height,
            "turns": params.turns,
            "threads": params.threads,
        },
        "time_unix": time.time(),
        "wall_seconds": wall_seconds,
        "metrics_enabled": metrics.enabled(),
        "devices": device_inventory(),
        "metrics": snap,
        "stage_timings": stage_timings(snap),
    }
    sampler = timeline.sampler()
    if sampler is not None:
        # the run-health verdict rides in the final artifact: a timeline
        # summary (rate/mean/p50/p99 per active series) plus every SLO
        # rule's state and fire count — "was this run healthy" without
        # replaying logs
        report["timeline"] = sampler.summary()
        if sampler.rulebook is not None:
            alerts = sampler.rulebook.snapshot()
            report["alerts"] = alerts
            report["alerts_fired"] = sorted(
                a["rule"] for a in alerts if a.get("fired_total")
            )
    ledger = accounting.ledger()
    if ledger.has_data:
        # who spent this run's capacity: the bounded per-tenant ledger
        # rides the final artifact beside the timeline verdict
        report["accounting"] = ledger.window()
    js = _journal.summary()
    if js is not None:
        # what HAPPENED this run: the lifecycle journal's by-kind totals
        # and drop/rotation accounting (the segments on disk hold the
        # full causally-stamped history)
        report["journal"] = js
    ps = _profiler.summary()
    if ps is not None:
        # WHICH CODE the wall went to: the profiler's head + top frames
        # (the full trie lands in the collapsed/speedscope artifacts the
        # mains write at run end — obs/flame.py renders those)
        report["profile"] = ps
    decomp = _perf.decomposition_summary(snap)
    if decomp:
        # WHERE the wall went: the dispatch-wall decomposition breakdown
        # (host_prep / device_compute / wire / demux per component)
        report["where_time_goes"] = decomp
    cp = _critical.tracker().snapshot()
    if cp.get("batches"):
        report["critical_path"] = cp
    if extra:
        report.update(extra)
    path = report_path(params, out_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(report, indent=1, default=str))
    tmp.replace(path)
    return path
