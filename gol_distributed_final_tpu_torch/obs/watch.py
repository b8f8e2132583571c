"""Live cluster dashboard — a ``top`` for a running GoL deployment.

    python -m gol_distributed_final_tpu_torch.obs.watch :8040
    python -m gol_distributed_final_tpu_torch.obs.watch 10.0.0.2:8040 \\
        -worker 10.0.0.3:8030 -worker 10.0.0.4:8030 -interval 2

Polls the broker's read-only ``Status`` verb — workers are discovered
from its ``worker_health`` roster automatically; ``-worker`` adds
extras — and renders a refreshing terminal panel: turn throughput, per-verb
RPC latency, compile-cache hit rate + kernel cost analysis, per-device
HBM occupancy, and the flight-recorder tail. Built ENTIRELY on the Status
surface — the dashboard can be attached to and detached from a live run
at will, costs the server one registry snapshot per poll, and never
touches the engine or the board (unlike ``RetrieveCurrentData``).

Rates (turns/s, calls/s) are derived client-side from successive counter
snapshots, so the servers stay stateless about their observers.

Every payload read goes through ``dict.get``: a server that predates a
field renders a gap, not a crash — the skew contract of the whole obs
surface. Pure stdlib, no jax import (pollable from any machine).

``-once`` renders a single frame and exits (scripting / test hook);
the default loop clears the screen between frames until Ctrl-C.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple

from .status import fetch_many, norm_address
from .status import scalar_value as _scalar
from .status import series_map as _series_map
from .timeline import counter_delta

_CLEAR = "\x1b[2J\x1b[H"


def _hist_stats(series: dict) -> Tuple[int, float]:
    """(count, mean seconds) of one histogram series."""
    count = series.get("count") or 0
    return count, (series.get("sum", 0.0) / count if count else 0.0)


def _human_bytes(n: Optional[float]) -> str:
    if n is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return "?"


def _human_seconds(s: float) -> str:
    if s < 1e-3:
        return f"{s * 1e6:.1f}us"
    if s < 1.0:
        return f"{s * 1e3:.1f}ms"
    return f"{s:.2f}s"


# -- panel renderers ---------------------------------------------------------


def _alert_lines(payload: dict) -> List[str]:
    """The SLO panel (obs/slo.py states shipped in the Status payload):
    firing alerts are the headline — rule, severity, age, and the
    server-side evaluation detail. All-ok rulebooks render one quiet
    summary line; servers without ``-timeline`` render nothing."""
    alerts = payload.get("alerts")
    if not alerts:
        return []
    firing = [a for a in alerts if a.get("state") == "firing"]
    if not firing:
        fired = sum(int(a.get("fired_total") or 0) for a in alerts)
        line = f"  {len(alerts)} rules evaluated, none firing"
        if fired:
            line += f"   ({fired} past firing(s) — see flight ring)"
        return ["ALERTS (slo rulebook ok)", line]
    now = time.time()
    out = [f"ALERTS — {len(firing)} FIRING"]
    for a in firing:
        since = a.get("since_unix")
        age = (
            f"{now - since:6.0f}s"
            if isinstance(since, (int, float)) and since
            else "     ?"
        )
        out.append(
            f"  ** {str(a.get('severity', '?')).upper():<4} "
            f"{a.get('rule', '?'):<24} for {age}   "
            f"{a.get('detail', '')}"
        )
    return out


def _fleet_lines(payload: dict) -> List[str]:
    """The cluster panel (obs/fleet.py collector payloads): per-target
    scrape health — a STALE target is the headline — merge exclusions
    (version skew, named and counted, never averaged in), per-broker
    sessions + server-side turn rates from each broker's own timeline
    summary, and the cross-broker tenant-skew verdict. Non-fleet
    payloads render nothing."""
    fl = payload.get("fleet")
    if not isinstance(fl, dict):
        return []
    targets = fl.get("targets") or []
    stale = sum(1 for t in targets if t.get("state") == "stale")
    head = (
        f"FLEET ({len(targets)} target(s) @ {fl.get('interval_s', '?')}s "
        f"sweeps, {fl.get('sweeps', 0)} sweep(s) done)"
    )
    if stale:
        head += f"   ** {stale} STALE **"
    out = [head]
    for t in targets:
        state = str(t.get("state", "?"))
        mark = "**" if state == "stale" else "  "
        kind = "worker" if t.get("worker") else "broker"
        age = t.get("last_success_age_s")
        age_s = f"{age:.1f}s ago" if isinstance(age, (int, float)) else "never"
        line = (
            f"  {mark}{t.get('address', '?'):<22} {kind:<6} {state:<8}"
            f" ok {int(t.get('ok_total') or 0):>4}"
            f"  err {int(t.get('err_total') or 0):>4}  last ok {age_s}"
        )
        fails = t.get("consecutive_failures") or 0
        if fails:
            line += f"  ({fails} consecutive: {t.get('error')})"
        out.append(line)
    for addr, why in sorted((fl.get("merge_excluded") or {}).items()):
        out.append(f"  !! {addr} EXCLUDED from merge: {why}")
    brokers = fl.get("broker_status") or {}
    if brokers:
        out.append(
            "  per-broker                sessions  turns/s  universe-turns/s"
        )
        for addr in sorted(brokers):
            p = brokers[addr]
            summary = (p.get("timeline") or {}).get("summary") or {}
            tr = (summary.get("gol_engine_turns_total") or {}).get("rate_per_s")
            sr = (summary.get("gol_session_turns_total") or {}).get(
                "rate_per_s")
            active = _scalar(p.get("metrics") or {}, "gol_sessions_active")
            out.append(
                f"  {addr:<26} {int(active or 0):>8}  "
                f"{(f'{tr:,.1f}' if tr is not None else '-'):>7}  "
                f"{(f'{sr:,.1f}' if sr is not None else '-'):>7}"
            )
    skew = fl.get("tenant_skew") or {}
    if skew.get("tenant") is not None:
        out.append(
            f"  tenant skew {skew.get('value', 0):.2f}x fair share: "
            f"'{skew['tenant']}' hottest on {skew.get('address')}"
        )
    return out


# summary entries worth a dashboard line, in render order (the rest stay
# pollable via obs/status -format json)
_TIMELINE_KEYS = (
    "gol_engine_turns_total",
    "gol_session_turns_total",
    "gol_session_turn_seconds",
    "gol_session_admit_wait_seconds",
    "gol_rpc_dispatch_seconds{method=Operations.SessionRun}",
    "gol_rpc_server_errors_total",
    "gol_scatter_deadline_seconds",
    # GC observability (obs/profiler.py's gc.callbacks hook): pause
    # quantiles + per-generation collection rates on the dashboard —
    # a stop-the-world pause is wall no segment decomposition names
    "gol_gc_pause_seconds",
    "gol_gc_collections_total{gen=0}",
    "gol_gc_collections_total{gen=1}",
    "gol_gc_collections_total{gen=2}",
)


def _timeline_lines(payload: dict) -> List[str]:
    """Server-computed rates/quantiles (obs/timeline.py summary): unlike
    the client-side counter-delta rates elsewhere on this dashboard,
    these survive dashboard restarts and are exactly what the SLO rules
    evaluated."""
    tl = payload.get("timeline") or {}
    summary = tl.get("summary") or {}
    if not summary:
        return []
    out = [
        f"TIMELINE (server-side, last {int(tl.get('summary_window_s') or 0)}s"
        f" @ {tl.get('period_s', '?')}s cadence)"
    ]
    shown = 0
    for key in _TIMELINE_KEYS:
        entry = summary.get(key)
        if not isinstance(entry, dict):
            continue
        parts = [f"  {key:<44}"]
        rate = entry.get("rate_per_s")
        if rate is not None:
            parts.append(f"{rate:,.1f}/s")
        if entry.get("p99_s") is not None:
            parts.append(
                f"p50 {_human_seconds(entry.get('p50_s') or 0)}"
                f"  p99 {_human_seconds(entry['p99_s'])}"
            )
        elif "value" in entry:
            parts.append(f"now {entry['value']:,.3g}")
        out.append("  ".join(parts))
        shown += 1
    if shown == 0:
        out.append(f"  {len(summary)} active series (none on the dashboard shortlist)")
    return out


def _throughput_lines(snap: dict, rate: Optional[float]) -> List[str]:
    turns = _scalar(snap, "gol_engine_turns_total")
    chunks = _scalar(snap, "gol_engine_chunks_total")
    chunk_size = _scalar(snap, "gol_engine_chunk_size")
    step = _series_map(snap, "gol_engine_step_seconds").get(())
    if turns is None and step is None:
        return []
    rate_s = f"{rate:,.0f} turns/s" if rate is not None else "rate: first poll"
    line = (
        f"  turns {int(turns or 0):,}   {rate_s}   "
        f"chunks {int(chunks or 0):,}   chunk size {int(chunk_size or 0):,}"
    )
    out = ["THROUGHPUT", line]
    if step:
        count, mean = _hist_stats(step)
        if count:
            out.append(f"  step mean {_human_seconds(mean)}/turn over {count:,} turns")
    return out


def _rpc_lines(snap: dict) -> List[str]:
    calls = _series_map(snap, "gol_rpc_server_requests_total")
    errors = _series_map(snap, "gol_rpc_server_errors_total")
    latency = _series_map(snap, "gol_rpc_server_request_seconds")
    verbs = sorted(set(calls) | set(latency))
    if not verbs:
        return []
    out = ["RPC (server side)          calls    errs   mean"]
    for verb in verbs:
        n = int((calls.get(verb) or {}).get("value") or 0)
        e = int((errors.get(verb) or {}).get("value") or 0)
        lat = latency.get(verb)
        count, mean = _hist_stats(lat) if lat else (0, 0.0)
        mean_s = _human_seconds(mean) if count else "-"
        out.append(f"  {(verb[0] if verb else '?'):<24} {n:>6}  {e:>6}   {mean_s}")
    return out


def _wire_lines(snap: dict) -> List[str]:
    """The data-plane comms column: frame bytes this process's RPC
    clients moved per verb and direction (``gol_wire_bytes_total`` — the
    broker's scatter/StripStep traffic when polling a broker), the
    resident halo traffic split by axis (``gol_halo_bytes_total``:
    row/col/corner — the -grid tile plane's O(K·edge) claim, measured),
    the turns-per-batch histogram (``gol_turn_batch_size``: K in resident
    wire mode, 1 in full/haloed), and the resident full-resync count."""
    by_verb: Dict[str, Dict[str, float]] = {}
    for labels, series in _series_map(snap, "gol_wire_bytes_total").items():
        if len(labels) != 2:
            continue
        verb, direction = labels
        by_verb.setdefault(verb, {})[direction] = series.get("value") or 0.0
    batch = _series_map(snap, "gol_turn_batch_size").get(())
    resyncs = _scalar(snap, "gol_strip_resync_total")
    if not by_verb and not batch and not resyncs:
        return []
    out = ["WIRE (data plane)          sent        received"]
    for verb in sorted(by_verb):
        d = by_verb[verb]
        out.append(
            f"  {verb:<24} {_human_bytes(d.get('sent')):>9}  "
            f"{_human_bytes(d.get('received')):>9}"
        )
    halo = _series_map(snap, "gol_halo_bytes_total")
    if halo:
        # resident halo traffic split by axis: on a -grid tile run the
        # row/col/corner shares show the O(K*edge) scaling directly; the
        # strip plane is all row-axis
        parts = " ".join(
            f"{(labels[0] if labels else '?')} "
            f"{_human_bytes(series.get('value'))}"
            for labels, series in sorted(halo.items())
            if series.get("value")
        )
        if parts:
            out.append(f"  halo bytes by axis: {parts}")
    tail = []
    if batch:
        count, mean = _hist_stats(batch)
        if count:
            tail.append(f"batches {count:,} (mean {mean:.1f} turns/rpc)")
    if resyncs:
        tail.append(f"strip resyncs {int(resyncs)}")
    if tail:
        out.append("  " + "   ".join(tail))
    return out


def _session_lines(snap: dict) -> List[str]:
    """The multi-universe serving column (engine/sessions.py +
    rpc/broker.SessionScheduler): universes currently batched, admissions
    and refusals (by reason — a nonzero 'capacity' stream means traffic is
    hitting the -session-capacity bound), and universe-turns served. A
    broker that never serves sessions renders nothing."""
    active = _scalar(snap, "gol_sessions_active")
    admitted = _scalar(snap, "gol_sessions_admitted_total")
    rejected = _series_map(snap, "gol_sessions_rejected_total")
    turns = _scalar(snap, "gol_session_turns_total")
    total_rejected = sum(s.get("value") or 0 for s in rejected.values())
    if not active and not admitted and not total_rejected and not turns:
        return []
    out = ["SESSIONS (multi-universe)"]
    line = (
        f"  active {int(active or 0):,}   admitted {int(admitted or 0):,}"
        f"   rejected {int(total_rejected)}"
    )
    if total_rejected:
        reasons = ", ".join(
            f"{(labels[0] if labels else '?')} {int(s.get('value') or 0)}"
            for labels, s in sorted(rejected.items())
            if s.get("value")
        )
        line += f"  ({reasons})"
    out.append(line)
    if turns:
        out.append(f"  universe-turns served {int(turns):,}")
    return out


def _sparsity_lines(snap: dict) -> List[str]:
    """The activity-sparse column (ops/sparse.py + the dirty-tile wire
    deltas): current frontier size (``gol_active_tiles`` — the sparse
    stepper's bitmap, or a resident broker's latest batch dirty total),
    the tiles the activity bitmap saved, delta-frame bytes shipped
    instead of full gathers, and the runs short-circuited arithmetically
    by kind. A fully dense deployment renders nothing."""
    active = _scalar(snap, "gol_active_tiles")
    skips = _scalar(snap, "gol_tile_skips_total")
    delta_bytes = _scalar(snap, "gol_sparse_frame_bytes_total")
    exits = _series_map(snap, "gol_early_exit_total")
    total_exits = sum(s.get("value") or 0 for s in exits.values())
    if not active and not skips and not delta_bytes and not total_exits:
        return []
    out = ["SPARSITY (activity-sparse)"]
    out.append(
        f"  active tiles {int(active or 0):,}   tile skips "
        f"{int(skips or 0):,}   delta frames "
        f"{_human_bytes(delta_bytes or 0)}"
    )
    if total_exits:
        kinds = ", ".join(
            f"{(labels[0] if labels else '?')} {int(s.get('value') or 0)}"
            for labels, s in sorted(exits.items())
            if s.get("value")
        )
        out.append(f"  early exits {int(total_exits)}  ({kinds})")
    return out


def _tenant_lines(payload: dict, top: int = 8) -> List[str]:
    """The usage-accounting column (obs/accounting.py TenantLedger,
    shipped as the Status ``accounting`` payload): who is spending this
    broker's capacity — device-seconds, universe-turns, board bytes,
    rejects, and errors per tenant (top-K + the ``other`` overflow
    bucket), with the aggregate row last. Brokers that never served a
    session render nothing."""
    acct = payload.get("accounting") or {}
    tenants = acct.get("tenants") or []
    other = acct.get("other")
    totals = acct.get("totals") or {}
    if not tenants and not other:
        return []
    out = [
        f"TENANTS (usage, top-{acct.get('top_k', '?')})"
        f"{'':<10} dev-s      turns      bytes  rej  err"
    ]

    def row(e: dict, name: str) -> str:
        return (
            f"  {name:<22} {e.get('device_seconds') or 0.0:>9.3f} "
            f"{int(e.get('turns') or 0):>10,} "
            f"{_human_bytes(e.get('wire_bytes')):>10} "
            f"{int(e.get('rejects_total') or 0):>4} "
            f"{int(e.get('errors') or 0):>4}"
        )

    for e in tenants[:top]:
        out.append(row(e, str(e.get("tenant", "?"))))
    if len(tenants) > top:
        out.append(f"  ... {len(tenants) - top} more tracked tenant(s)")
    if other:
        out.append(row(
            other,
            f"other({other.get('distinct_tenants', '?')} tenants)",
        ))
    if totals:
        out.append(row(dict(totals, rejects_total=totals.get("rejects")),
                       "TOTAL"))
    return out


def _worker_lines(payload: dict) -> List[str]:
    """The broker's roster health column (WorkersBackend.worker_health)
    plus the fault-tolerance counters: who is connected, who is lost and
    when it will next be probed, and how much recovery has happened."""
    roster = payload.get("workers") or []
    snap = payload.get("metrics") or {}
    totals = [
        (label, _scalar(snap, name))
        for label, name in (
            ("lost", "gol_worker_lost_total"),
            ("readmitted", "gol_worker_readmitted_total"),
            ("turn retries", "gol_turn_retry_total"),
            ("auto ckpts", "gol_auto_checkpoint_total"),
        )
    ]
    if not roster and not any(v for _, v in totals):
        return []
    out = ["WORKERS (roster health)"]
    for w in roster:
        state = w.get("state", "?")
        line = f"  {w.get('address', '?'):<22} {state}"
        retry = w.get("retry_in_s")
        if state != "connected" and retry is not None:
            line += f"   next probe in {retry}s"
        out.append(line)
    counted = "   ".join(
        f"{label} {int(v)}" for label, v in totals if v
    )
    if counted:
        out.append(f"  {counted}")
    return out


def _integrity_lines(snap: dict) -> List[str]:
    """The silent-corruption column (rpc/integrity.py): verifications
    performed, failures broken out by kind (frame / strip / edges /
    attest / fetch — each one is a corruption that was CAUGHT), and
    checkpoint digest verifications by result. All-zero registries render
    nothing; a nonzero failure line is the headline an operator attaches
    this dashboard for."""
    checks = _scalar(snap, "gol_integrity_checks_total")
    fails = _series_map(snap, "gol_integrity_failures_total")
    ckpt = _series_map(snap, "gol_ckpt_verify_total")
    total_fail = sum(s.get("value") or 0 for s in fails.values())
    total_ckpt = sum(s.get("value") or 0 for s in ckpt.values())
    # value-based, not series-presence-based: a reset registry keeps its
    # label series at 0.0, and an all-zero panel is noise
    if not checks and not total_fail and not total_ckpt:
        return []
    out = ["INTEGRITY"]
    line = f"  checks {int(checks or 0):,}   failures {int(total_fail)}"
    if total_fail:
        kinds = ", ".join(
            f"{(labels[0] if labels else '?')} {int(s.get('value') or 0)}"
            for labels, s in sorted(fails.items())
            if s.get("value")
        )
        line += f"  ({kinds})  ** CORRUPTION CAUGHT **"
    out.append(line)
    if ckpt:
        ok = (ckpt.get(("ok",)) or {}).get("value") or 0
        bad = (ckpt.get(("fail",)) or {}).get("value") or 0
        out.append(f"  ckpt verify ok {int(ok)}   fail {int(bad)}")
    return out


def _where_time_lines(snap: dict) -> List[str]:
    """The dispatch-wall decomposition panel (obs/perf.py): per component
    (engine / sessions / broker), where each turn-chunk's wall went —
    host_prep / device_compute / wire / demux totals and shares. Servers
    that never decomposed a chunk render nothing."""
    from .perf import decomposition_summary

    decomp = decomposition_summary(snap)
    if not decomp:
        return []
    out = ["WHERE TIME GOES (dispatch-wall decomposition)"]
    for component, segs in sorted(decomp.items()):
        parts = [
            f"{seg} {_human_seconds(e['sum_s'])} ({100 * e['share']:.0f}%)"
            for seg, e in sorted(segs.items())
            if isinstance(e, dict)
        ]
        total = segs.get("_total_s") or 0.0
        out.append(
            f"  {component:<9} {_human_seconds(total):>9}   " + "  ".join(parts)
        )
    return out


def _critical_lines(payload: dict) -> List[str]:
    """The straggler/critical-path panel (obs/critical.py snapshot in the
    Status payload): per-worker service-time EWMAs, who gated how many
    K-batches, and the straggler headline when one worker persistently
    gates the gather."""
    cp = payload.get("critical_path") or {}
    workers = cp.get("workers") or []
    if not cp.get("batches") or not workers:
        return []
    out = [
        f"CRITICAL PATH ({cp.get('batches')} batch(es), skew "
        f"{cp.get('skew_ratio', 1.0):.2f}x)          ewma    gated  share"
    ]
    for w in workers:
        ewma = w.get("ewma_s")
        out.append(
            f"  {w.get('addr', '?'):<24} "
            f"{(_human_seconds(ewma) if ewma is not None else '-'):>10} "
            f"{w.get('gated', 0):>6} "
            f"{100 * (w.get('gated_share') or 0.0):>5.0f}%"
        )
    s = cp.get("straggler")
    if s:
        out.append(
            f"  ** STRAGGLER {s.get('addr', '?')}: gates "
            f"{100 * (s.get('gated_share') or 0):.0f}% of batches at "
            f"{s.get('skew', 0):.1f}x the roster median **"
        )
    return out


def _roofline_lines(snap: dict) -> List[str]:
    """The roofline classification panel (obs/perf.py): achieved FLOP/s
    and bytes/s per instrumented kernel site plus the bound class the
    server classified it as (the gol_kernel_bound gauge). Servers
    without instrumented dispatches render nothing."""
    from .perf import server_bound_classes

    achieved_f = _series_map(snap, "gol_kernel_achieved_flops")
    achieved_b = _series_map(snap, "gol_kernel_achieved_bytes_per_s")
    if not achieved_f:
        return []
    classes = server_bound_classes(snap)
    out = ["ROOFLINE (achieved per site)"]
    for labels in sorted(achieved_f):
        site = labels[0] if labels else "?"
        af = (achieved_f.get(labels) or {}).get("value") or 0.0
        ab = (achieved_b.get(labels) or {}).get("value") or 0.0
        out.append(
            f"  {site:<18} {af:.3g} flop/s   {_human_bytes(ab)}/s   "
            f"{classes.get(site, '?')}"
        )
    return out


def _compile_lines(snap: dict) -> List[str]:
    requests = _series_map(snap, "gol_compile_cache_requests_total")
    misses = _series_map(snap, "gol_compile_cache_misses_total")
    compile_s = _series_map(snap, "gol_compile_seconds")
    flops = _series_map(snap, "gol_kernel_flops")
    accessed = _series_map(snap, "gol_kernel_bytes_accessed")
    sites = sorted(set(requests) | set(compile_s) | set(flops))
    if not sites:
        return []
    out = ["COMPILE + KERNELS"]
    for site in sites:
        label = site[0] if site else "?"
        parts = [f"  {label:<18}"]
        req = (requests.get(site) or {}).get("value")
        if req:
            miss = (misses.get(site) or {}).get("value") or 0
            parts.append(
                f"cache {int(req - miss)}/{int(req)} hit "
                f"({100.0 * (req - miss) / req:.0f}%)"
            )
        comp = compile_s.get(site)
        if comp:
            count, mean = _hist_stats(comp)
            if count:
                parts.append(f"compiles {count} (mean {_human_seconds(mean)})")
        fl = (flops.get(site) or {}).get("value")
        if fl:
            parts.append(f"{fl:.3g} flops")
        by = (accessed.get(site) or {}).get("value")
        if by:
            parts.append(f"{_human_bytes(by)} accessed")
        if len(parts) > 1:
            out.append("  ".join(parts))
    return out if len(out) > 1 else []


def _hbm_lines(snap: dict) -> List[str]:
    in_use = _series_map(snap, "gol_device_hbm_bytes_in_use")
    peak = _series_map(snap, "gol_device_hbm_peak_bytes")
    limit = _series_map(snap, "gol_device_hbm_bytes_limit")
    devices = sorted(set(in_use) | set(peak))
    out = ["HBM (per device)"]
    if not devices:
        out.append("  no samples (CPU backend, or engine not running here)")
        return out
    for dev in devices:
        used = (in_use.get(dev) or {}).get("value")
        cap = (limit.get(dev) or {}).get("value")
        pk = (peak.get(dev) or {}).get("value")
        pct = f" ({100.0 * used / cap:.0f}%)" if used and cap else ""
        out.append(
            f"  device {dev[0] if dev else '?'}: "
            f"{_human_bytes(used)} / {_human_bytes(cap)}{pct}   "
            f"peak {_human_bytes(pk)}"
        )
    return out


def _flight_lines(payload: dict, tail: int = 6) -> List[str]:
    events = payload.get("flight") or []
    if not events:
        return []
    now = time.time()
    out = [f"FLIGHT (last {min(tail, len(events))} of {len(events)} events)"]
    for ev in events[-tail:]:
        age = now - (ev.get("t_unix") or now)
        out.append(
            f"  -{age:6.1f}s  {ev.get('kind', '?'):<12} {ev.get('name', '?')}"
        )
    return out


def _journal_lines(payload: dict, tail: int = 8) -> List[str]:
    """The lifecycle-journal tail (obs/journal.py window): the last few
    HLC-stamped events this process persisted — admissions, losses,
    recoveries, checkpoints — plus the drop counter, which must be loud
    on a dashboard (a dropping journal is an incomplete postmortem)."""
    jw = payload.get("journal")
    if not isinstance(jw, dict):
        return []
    events = jw.get("events") or []
    dropped = jw.get("dropped", 0)
    head = f"JOURNAL (seq {jw.get('seq', '?')}"
    if dropped:
        head += f", {dropped} DROPPED"
    head += ")"
    out = [head]
    if not events:
        out.append("  no new events this window")
        return out
    now = time.time()
    for ev in events[-tail:]:
        age = now - (ev.get("t_unix") or now)
        args = ev.get("args") or {}
        detail = " ".join(f"{k}={v}" for k, v in list(args.items())[:4])
        out.append(
            f"  -{age:6.1f}s  {ev.get('kind', '?'):<16} "
            f"{ev.get('name', '?')} {detail}".rstrip()
        )
    return out


def _profile_lines(payload: dict, top: int = 6) -> List[str]:
    """The continuous profiler's hot-frame shortlist (obs/profiler.py
    window): self/cum shares of the hottest frames, the adaptive
    cadence, and the gc-pause tally. Parked frames (accept/select/wait
    leaves) are skipped — the busy view; the full table stays pollable
    via obs/flame.py."""
    from .profiler import is_idle_frame

    pw = payload.get("profile")
    if not isinstance(pw, dict):
        return []
    stacks = pw.get("stacks") or 0
    head = (
        f"PROFILE (seq {pw.get('seq', '?')}, {stacks:,} stacks @ "
        f"{pw.get('period_ms', '?')}ms)"
    )
    backoffs = pw.get("backoffs") or 0
    if backoffs:
        head = head[:-1] + f", {backoffs} backoff(s))"
    out = [head]
    gc_sect = pw.get("gc") or {}
    if gc_sect.get("pauses"):
        out.append(
            f"  gc: {gc_sect['pauses']} pause(s), "
            f"max {_human_seconds(gc_sect.get('max_pause_s') or 0)}, "
            f"total {_human_seconds(gc_sect.get('pause_s') or 0)}"
        )
    shown = 0
    for row in pw.get("frames") or []:
        if shown >= top:
            break
        if is_idle_frame(str(row.get("func", "")), str(row.get("file", ""))):
            continue
        s = row.get("self") or 0
        c = row.get("cum") or 0
        denom = max(stacks, 1)
        out.append(
            f"  {100.0 * s / denom:>5.1f}% self {100.0 * c / denom:>5.1f}% "
            f"cum  {row.get('func', '?')} "
            f"({row.get('file', '?')}:{row.get('line', '?')})"
        )
        shown += 1
    if shown == 0:
        out.append("  no busy frames sampled yet")
    return out


def render_status(
    label: str,
    payload: dict,
    turns_rate: Optional[float] = None,
) -> str:
    """One target's full panel from its Status payload — pure function of
    the payload (plus the client-side rate), so it is unit-testable
    without a server."""
    role = payload.get("role", "?")
    pid = payload.get("pid", "?")
    enabled = payload.get("metrics_enabled")
    head = f"== {label}  ({role}, pid {pid})"
    if not enabled:
        head += "   [metrics DISABLED — start the server with -metrics]"
    snap = payload.get("metrics") or {}
    sections = [
        _alert_lines(payload),
        _fleet_lines(payload),
        _throughput_lines(snap, turns_rate),
        _timeline_lines(payload),
        _rpc_lines(snap),
        _wire_lines(snap),
        _session_lines(snap),
        _sparsity_lines(snap),
        _tenant_lines(payload),
        _integrity_lines(snap),
        _worker_lines(payload),
        _where_time_lines(snap),
        _critical_lines(payload),
        _roofline_lines(snap),
        _compile_lines(snap),
        _hbm_lines(snap),
        _flight_lines(payload),
        _journal_lines(payload),
        _profile_lines(payload),
    ]
    lines = [head]
    for sec in sections:
        if sec:
            lines.append("")
            lines.extend(sec)
    return "\n".join(lines)


class Watcher:
    """Polls one broker + N workers, remembering the previous poll per
    target so counter deltas become rates.

    Workers are AUTO-DISCOVERED from the broker's ``worker_health``
    roster each frame (manual ``-worker`` flags are additive extras,
    not a requirement), and all targets are polled in parallel
    (``status.fetch_many``) so one wedged target costs one timeout.
    Pointed at a fleet collector (obs/fleet.py, ``role="fleet"``), the
    frame renders the FLEET panel plus one sub-panel per broker from
    the collector's ``broker_status`` — one address, whole cluster."""

    def __init__(self, broker: str, workers: List[str], timeout: float):
        self.targets = [(norm_address(broker), False)] + [
            (norm_address(w), True) for w in workers
        ]
        self.timeout = timeout
        self._prev: Dict[str, Tuple[float, float]] = {}  # addr -> (t, turns)
        # addr -> last timeline seq received: echoed back so a -timeline
        # server ships incremental windows instead of the whole ring
        self._tl_seq: Dict[str, int] = {}
        # addr -> last journal seq received (the journal twin)
        self._jr_seq: Dict[str, int] = {}
        # addr -> last profile seq received + the frame cache the
        # incremental windows overlay (a -profile server ships only
        # frames whose hits MOVED past the echoed seq; the dashboard
        # merges them over what it already holds)
        self._pr_seq: Dict[str, int] = {}
        self._pr_frames: Dict[str, Dict[tuple, dict]] = {}

    def _turns_rate(self, addr: str, payload: dict) -> Optional[float]:
        now = time.monotonic()
        turns = _scalar(payload.get("metrics") or {}, "gol_engine_turns_total")
        prev = self._prev.get(addr)
        if turns is not None:
            self._prev[addr] = (now, turns)
        if prev is None or turns is None:
            return None
        t0, turns0 = prev
        dt = now - t0
        # counter_delta (obs/timeline.py — the server rings' reset logic,
        # shared): a broker or worker restarted between polls reports a
        # SMALLER total, and the raw subtraction used to render that as a
        # negative/garbage rate; reset-aware, the new total IS the delta
        return counter_delta(turns0, turns) / dt if dt > 0 else None

    def _merge_profile(self, addr: str, payload: dict) -> None:
        """Overlay an incremental profile window onto the cached frame
        table: a frame absent from this window simply hasn't MOVED since
        the echoed seq — its last-known counts still render."""
        pw = payload.get("profile")
        if not isinstance(pw, dict):
            return
        seq = pw.get("seq")
        if isinstance(seq, int):
            self._pr_seq[addr] = seq
        cache = self._pr_frames.setdefault(addr, {})
        for row in pw.get("frames") or []:
            if isinstance(row, dict):
                cache[(row.get("func"), row.get("file"),
                       row.get("line"))] = row
        pw["frames"] = sorted(
            cache.values(), key=lambda r: -(r.get("self") or 0)
        )[:40]

    def _spec(self, addr: str, is_worker: bool) -> dict:
        return {
            "address": addr, "worker": is_worker,
            "timeline_since": self._tl_seq.get(addr, 0),
            "journal_since": self._jr_seq.get(addr, 0),
            "profile_since": self._pr_seq.get(addr, 0),
        }

    def frame(self) -> Tuple[str, bool]:
        """(rendered frame, primary target ok)."""
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        blocks = [f"gol watch — {stamp}   (read-only Status polls)"]
        primary_ok = False
        ordered = list(self.targets)
        results = fetch_many(
            [self._spec(a, w) for a, w in ordered], timeout=self.timeout
        )
        # roster auto-discovery: workers each broker payload names get a
        # second (also parallel) round — no -worker flags required
        seen = {a for a, _ in ordered}
        discovered: List[Tuple[str, bool]] = []
        for addr, is_worker in list(ordered):
            payload = (results.get(addr) or (None,))[0]
            if payload is None or is_worker:
                continue
            for entry in payload.get("workers") or []:
                if not isinstance(entry, dict):
                    continue
                waddr = entry.get("address")
                if not isinstance(waddr, str) or ":" not in waddr:
                    continue
                waddr = norm_address(waddr)
                if waddr not in seen:
                    seen.add(waddr)
                    discovered.append((waddr, True))
        if discovered:
            results.update(fetch_many(
                [self._spec(a, w) for a, w in discovered],
                timeout=self.timeout,
            ))
            ordered.extend(discovered)
        for i, (addr, is_worker) in enumerate(ordered):
            kind = "worker" if is_worker else "broker"
            payload, _fetched_at, error = results.get(addr) or (
                None, 0.0, "no result")
            if error is not None:
                blocks.append(f"== {kind} {addr}: poll failed — {error}")
                continue
            seq = (payload.get("timeline") or {}).get("seq")
            if isinstance(seq, int):
                self._tl_seq[addr] = seq
            jseq = (payload.get("journal") or {}).get("seq")
            if isinstance(jseq, int):
                self._jr_seq[addr] = jseq
            self._merge_profile(addr, payload)
            if i == 0:
                primary_ok = True
            is_fleet = payload.get("role") == "fleet"
            blocks.append(
                render_status(
                    f"{'fleet' if is_fleet else kind} {addr}", payload,
                    self._turns_rate(addr, payload),
                )
            )
            if is_fleet:
                # one sub-panel per broker the collector scraped this
                # sweep — the whole cluster behind ONE address
                brokers = (payload.get("fleet") or {}).get(
                    "broker_status") or {}
                for baddr in sorted(brokers):
                    bp = brokers[baddr]
                    blocks.append(render_status(
                        f"broker {baddr} (via fleet)", bp,
                        self._turns_rate(baddr, bp),
                    ))
        return "\n\n".join(blocks), primary_ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="live terminal dashboard over the read-only Status verb"
    )
    parser.add_argument(
        "address",
        help="broker host:port (or :port) — or a fleet collector "
             "(obs/fleet.py) address, which renders the whole cluster",
    )
    parser.add_argument(
        "-worker", action="append", default=[], metavar="HOST:PORT",
        help="extra worker to poll beyond the broker's worker_health "
             "roster, which is auto-discovered every frame (repeatable)",
    )
    parser.add_argument(
        "-interval", type=float, default=2.0, metavar="SECONDS",
        help="seconds between polls (default 2)",
    )
    parser.add_argument(
        "-timeout", type=float, default=5.0, metavar="SECONDS",
        help="per-target poll timeout (default 5); a wedged server costs "
             "one interval, never hangs the dashboard",
    )
    parser.add_argument(
        "-once", action="store_true",
        help="render a single frame and exit (scripting hook)",
    )
    parser.add_argument(
        "-no-clear", dest="no_clear", action="store_true",
        help="append frames instead of clearing the screen (logs/pipes)",
    )
    args = parser.parse_args(argv)
    watcher = Watcher(args.address, args.worker, args.timeout)
    try:
        while True:
            frame, ok = watcher.frame()
            if not (args.once or args.no_clear):
                sys.stdout.write(_CLEAR)
            print(frame, flush=True)
            if args.once:
                return 0 if ok else 1
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
