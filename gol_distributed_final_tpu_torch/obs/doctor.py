"""Cluster triage doctor — one shot from symptoms to a ranked diagnosis.

    python -m gol_distributed_final_tpu_torch.obs.doctor tcp://127.0.0.1:8040
    python -m gol_distributed_final_tpu_torch.obs.doctor :8040 \\
        -worker :8030 -worker :8031 -out out

PR 4/6 made failures *detectable* (worker_health, quarantine backoff,
integrity counters, flight events); this CLI makes them *explained*: it
pulls ``Status`` from the broker and its workers (auto-discovered from
the ``worker_health`` roster; ``-worker`` adds extras) — or from a
fleet collector (obs/fleet.py), whose per-broker payloads are expanded
and whose scrape health becomes findings — correlates timelines,
flight rings, span statistics, worker health, and active SLO alerts into
a ranked finding list ("worker :8041 quarantined 3x, resync counter
climbing, wire bytes/turn 12x baseline -> suspect flapping transport"),
prints a terminal report, and writes ``out/doctor_<ts>.json`` so the
diagnosis is an artifact, not scrollback.

Built ENTIRELY on the read-only Status surface (the obs/watch.py
posture): attachable to a live, degraded, or wedged cluster; every
payload read goes through ``dict.get`` so version skew renders a gap,
never a crash. The correlation core (``diagnose``) is a pure function of
the fetched payloads — unit-testable on canned multi-process fixtures.

``--selfcheck`` spins a loopback broker in-process, runs a tiny job,
polls and diagnoses it, and fails on an empty or unrenderable diagnosis
— the ``scripts/check --doctor`` smoke gate.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

from .status import fetch_many
from .status import norm_address as _norm_addr
from .status import scalar_value as _scalar
from .status import series_map as _series_map

SCHEMA = "gol-doctor/1"

_SEVERITY_ORDER = {"page": 0, "warn": 1, "info": 2}


def collect(
    broker: str, workers: List[str], timeout: float = 5.0
) -> Dict[str, dict]:
    """One PARALLEL Status poll per target (``status.fetch_many`` — a
    wedged target costs one timeout, not the whole round). Failed polls
    become ``{"error": ...}`` entries — a dead worker is EVIDENCE, not a
    fetch failure.

    Workers are auto-discovered from each broker payload's
    ``worker_health`` roster (manual ``-worker`` flags stay additive
    extras), and a fleet collector payload (obs/fleet.py,
    ``role="fleet"``) is EXPANDED: every broker Status it scraped this
    sweep is diagnosed as if polled directly, so one address triages the
    whole cluster."""
    specs: List[dict] = []
    seen = set()
    for addr, is_worker in [(broker, False)] + [(w, True) for w in workers]:
        addr = _norm_addr(addr)
        if addr not in seen:
            seen.add(addr)
            specs.append({"address": addr, "worker": is_worker})
    results = fetch_many(specs, timeout=timeout)
    discovered: List[dict] = []
    for spec in specs:
        payload = (results.get(spec["address"]) or (None,))[0]
        if payload is None or spec["worker"]:
            continue
        for entry in payload.get("workers") or []:
            if not isinstance(entry, dict):
                continue
            waddr = entry.get("address")
            if not isinstance(waddr, str) or ":" not in waddr:
                continue
            waddr = _norm_addr(waddr)
            if waddr not in seen:
                seen.add(waddr)
                discovered.append({"address": waddr, "worker": True})
    if discovered:
        results.update(fetch_many(discovered, timeout=timeout))
        specs.extend(discovered)
    statuses: Dict[str, dict] = {}
    for spec in specs:
        addr = spec["address"]
        kind = "worker" if spec["worker"] else "broker"
        payload, _fetched_at, error = results.get(addr) or (
            None, 0.0, "no result")
        if error is not None:
            statuses[f"{kind} {addr}"] = {"error": f"poll failed: {error}"}
            continue
        if payload.get("role") == "fleet":
            statuses[f"fleet {addr}"] = payload
            brokers = (payload.get("fleet") or {}).get("broker_status") or {}
            for baddr in sorted(brokers):
                statuses.setdefault(f"broker {baddr}", brokers[baddr])
        else:
            statuses[f"{kind} {addr}"] = payload
    return statuses


def _label_total(snap: dict, name: str) -> Tuple[float, Dict[str, float]]:
    """(sum across label children, {label0: value}) for one counter."""
    by = {}
    for labels, s in _series_map(snap, name).items():
        v = s.get("value") or 0.0
        if v:
            by[labels[0] if labels else "?"] = v
    return sum(by.values()), by


def _finding(severity: str, score: float, title: str, detail: str,
             evidence: List[str], suspects: List[str],
             target: str) -> dict:
    return {
        "severity": severity,
        "score": round(score, 2),
        "title": title,
        "detail": detail,
        "evidence": evidence,
        "suspects": sorted(set(suspects)),
        "target": target,
    }


# -- correlation heuristics (each: payloads -> findings) ---------------------


def _flight_counts(payload: dict, kind: str) -> Dict[str, int]:
    """Occurrences of one flight-event kind by name (e.g. how many times
    each worker address appears in ``worker.lost`` events)."""
    out: Dict[str, int] = {}
    for ev in payload.get("flight") or []:
        if ev.get("kind") == kind:
            name = str(ev.get("name", "?"))
            out[name] = out.get(name, 0) + 1
    return out


def _find_unreachable(statuses) -> List[dict]:
    out = []
    for label, payload in statuses.items():
        if "error" in payload:
            sev = "page" if label.startswith("broker") else "warn"
            out.append(_finding(
                sev, 100.0 if sev == "page" else 60.0,
                f"{label} unreachable",
                str(payload["error"]),
                [f"Status poll failed: {payload['error']}"],
                [label.split(" ", 1)[-1]],
                label,
            ))
    return out


def _find_lost_workers(statuses) -> List[dict]:
    """The flapping-transport correlation: roster health + per-address
    loss/quarantine history + resync + wire-byte amplification."""
    out = []
    for label, payload in statuses.items():
        roster = payload.get("workers") or []
        lost = [w for w in roster if w.get("state") == "lost"]
        if not lost:
            continue
        snap = payload.get("metrics") or {}
        loss_events = _flight_counts(payload, "worker.lost")
        readmits = _scalar(snap, "gol_worker_readmitted_total") or 0
        resyncs = _scalar(snap, "gol_strip_resync_total") or 0
        retries = _scalar(snap, "gol_turn_retry_total") or 0
        turns = _scalar(snap, "gol_engine_turns_total")
        wire_total, _ = _label_total(snap, "gol_wire_bytes_total")
        for w in lost:
            addr = w.get("address", "?")
            losses = loss_events.get(addr, 0)
            evidence = [f"roster marks {addr} lost"]
            retry = w.get("retry_in_s")
            if retry is not None:
                evidence.append(f"next readmission probe in {retry}s")
            if losses:
                evidence.append(
                    f"flight ring shows {losses} loss event(s) for {addr}"
                )
            if readmits:
                evidence.append(f"{int(readmits)} readmission(s) so far")
            if resyncs:
                evidence.append(
                    f"strip resync counter at {int(resyncs)} and climbing "
                    "with each loss"
                )
            if retries:
                evidence.append(f"{int(retries)} turn retr(ies) paid")
            flapping = losses >= 2 or (losses >= 1 and readmits >= 1)
            if flapping:
                title = (
                    f"worker {addr} quarantined {losses}x — suspect "
                    "flapping transport"
                )
                detail = (
                    "repeat loss/readmit cycles: each readmission taxes "
                    "the next turn a scatter deadline; the probe backoff "
                    "is escalating. Check the network path or restart "
                    "the worker."
                )
            else:
                title = f"worker {addr} lost from the scatter set"
                detail = (
                    "the broker re-split its rows over the survivors; "
                    "the readmission probe is dialling it."
                )
            if wire_total and turns:
                evidence.append(
                    f"wire bytes/turn currently "
                    f"{wire_total / max(turns, 1):,.0f}"
                )
            out.append(_finding(
                "page", 90.0 + 5.0 * losses, title, detail,
                evidence, [addr], label,
            ))
    return out


def _find_alerts(statuses) -> List[dict]:
    out = []
    for label, payload in statuses.items():
        for alert in payload.get("alerts") or []:
            if alert.get("state") != "firing":
                continue
            sev = alert.get("severity", "warn")
            if sev not in _SEVERITY_ORDER:
                sev = "warn"
            since = alert.get("since_unix")
            age = (
                f"for {time.time() - since:.0f}s"
                if isinstance(since, (int, float)) and since else "now"
            )
            out.append(_finding(
                sev, 80.0 if sev == "page" else 50.0,
                f"SLO rule '{alert.get('rule', '?')}' firing {age}",
                str(alert.get("detail", "")),
                [f"server-side evaluation: {alert.get('detail', '')}"],
                [], label,
            ))
    return out


def _find_integrity(statuses) -> List[dict]:
    out = []
    for label, payload in statuses.items():
        snap = payload.get("metrics") or {}
        total, by_kind = _label_total(snap, "gol_integrity_failures_total")
        if not total:
            continue
        kinds = ", ".join(f"{k} {int(v)}" for k, v in sorted(by_kind.items()))
        suspects = sorted(_flight_counts(payload, "integrity.fail"))
        out.append(_finding(
            "page", 95.0,
            f"{int(total)} integrity failure(s) caught ({kinds})",
            "corrupted data was DETECTED and quarantined, never served; "
            "the suspect worker(s) were routed through loss recovery.",
            [f"gol_integrity_failures_total{{{kinds}}}"]
            + [f"flight names suspect {s}" for s in suspects],
            suspects, label,
        ))
    return out


def _find_error_ratio(statuses) -> List[dict]:
    out = []
    for label, payload in statuses.items():
        snap = payload.get("metrics") or {}
        errs, by_verb = _label_total(snap, "gol_rpc_server_errors_total")
        reqs, _ = _label_total(snap, "gol_rpc_server_requests_total")
        if not reqs or not errs:
            continue
        ratio = errs / reqs
        if ratio <= 0.01:
            continue
        verbs = ", ".join(
            f"{k.rsplit('.', 1)[-1]} {int(v)}"
            for k, v in sorted(by_verb.items())
        )
        out.append(_finding(
            "warn", 55.0 + min(30.0, 100.0 * ratio),
            f"RPC error ratio {100 * ratio:.1f}% ({int(errs)}/{int(reqs)})",
            f"error replies by verb: {verbs}",
            [f"gol_rpc_server_errors_total / _requests_total = {ratio:.4f}"],
            [], label,
        ))
    return out


def _rate_from_timeline(payload: dict, metric: str) -> Optional[float]:
    """The server-computed rate for one summary entry. The summary DROPS
    zero-increase counters (obs/timeline.py keeps it small), so when the
    timeline payload exists but the entry is absent, the truthful answer
    is 0.0 — exactly the stalled case; None only when the server ships
    no timeline at all (can't judge)."""
    tl = payload.get("timeline")
    if not isinstance(tl, dict):
        return None
    entry = (tl.get("summary") or {}).get(metric)
    if isinstance(entry, dict):
        return entry.get("rate_per_s")
    return 0.0


def _find_stall(statuses) -> List[dict]:
    """A process whose turn counters have history but a ~zero recent
    rate: wedged or starved, the flight tail names its last act."""
    out = []
    for label, payload in statuses.items():
        snap = payload.get("metrics") or {}
        turns = _scalar(snap, "gol_engine_turns_total")
        if not turns:
            continue
        rate = _rate_from_timeline(payload, "gol_engine_turns_total")
        if rate is None or rate > 0.01:
            continue
        tail = [
            f"last act: {ev.get('kind', '?')} {ev.get('name', '?')}"
            for ev in (payload.get("flight") or [])[-3:]
        ]
        out.append(_finding(
            "warn", 65.0,
            f"turn counter stalled at {int(turns)}",
            "the engine evolved turns earlier but the server-side "
            "timeline shows a ~zero recent rate — wedged, paused, or "
            "the run ended.",
            [f"timeline rate {rate:.4f} turns/s over the summary window"]
            + tail,
            [], label,
        ))
    return out


def _find_tenant_skew(statuses) -> List[dict]:
    """The hot-tenant correlation (the 'names the flapping worker'
    pattern, applied to the accounting ledger): one tenant holding the
    majority of device-seconds, or driving the dominant reject / burn
    share, is named with its ledger evidence rows — the operator's
    first question when the error budget burns is WHO."""
    out = []
    for label, payload in statuses.items():
        acct = payload.get("accounting") or {}
        tenants = acct.get("tenants") or []
        other = acct.get("other")
        totals = acct.get("totals") or {}
        entries = tenants + ([other] if other else [])
        if len(entries) < 2:
            continue  # one tenant IS 100% of everything — not skew

        def ev(e: dict) -> str:
            return (
                f"tenant {e.get('tenant', '?')}: "
                f"{e.get('device_seconds') or 0.0:.3f} dev-s, "
                f"{int(e.get('turns') or 0)} turns, "
                f"{int(e.get('rejects_total') or 0)} reject(s), "
                f"{int(e.get('errors') or 0)} error(s)"
            )

        total_dev = totals.get("device_seconds") or 0.0
        top = max(entries, key=lambda e: e.get("device_seconds") or 0.0)
        if total_dev > 0:
            share = (top.get("device_seconds") or 0.0) / total_dev
            if share > 0.5 and top is not other:
                out.append(_finding(
                    "warn", 64.0 + 20.0 * share,
                    f"tenant {top.get('tenant', '?')} holds "
                    f"{100 * share:.0f}% of device-seconds",
                    "one tenant dominates the batch's capacity: every "
                    "other tenant's admission waits and turn latency "
                    "ride behind it. Per-tenant admission quotas are "
                    "the fix the ROADMAP front door plans.",
                    [ev(e) for e in entries[:3]]
                    + [f"ledger totals: {total_dev:.3f} dev-s, "
                       f"{int(totals.get('turns') or 0)} turns"],
                    [f"tenant {top.get('tenant', '?')}"], label,
                ))
        total_rej = totals.get("rejects") or 0
        total_err = totals.get("errors") or 0
        burn_total = total_rej + total_err
        if burn_total >= 5:
            hot = max(
                entries,
                key=lambda e: (e.get("rejects_total") or 0)
                + (e.get("errors") or 0),
            )
            hot_burn = (hot.get("rejects_total") or 0) + (hot.get("errors") or 0)
            if hot_burn / burn_total > 0.5 and hot is not other:
                reasons = ", ".join(
                    f"{k} {v}"
                    for k, v in sorted((hot.get("rejects") or {}).items())
                ) or "errors only"
                out.append(_finding(
                    "warn", 60.0,
                    f"tenant {hot.get('tenant', '?')} drives "
                    f"{100 * hot_burn / burn_total:.0f}% of the "
                    "reject/error burn",
                    "the error-budget burn is one tenant's traffic "
                    f"({reasons}), not global overload: shed or quota "
                    "that tenant before raising -session-capacity.",
                    [ev(hot)]
                    + [f"cluster burn: {total_rej} reject(s) + "
                       f"{total_err} error(s)"],
                    [f"tenant {hot.get('tenant', '?')}"], label,
                ))
    return out


def _find_straggler(statuses) -> List[dict]:
    """The critical-path correlation (obs/critical.py snapshot riding the
    broker's Status): a worker that persistently GATES the K-batch
    gather — slow, not failed, so nothing else pages — is named with
    per-address service-time evidence rows. This is the finding that
    explains 'the cluster is healthy but turns are slow'."""
    out = []
    for label, payload in statuses.items():
        cp = payload.get("critical_path") or {}
        s = cp.get("straggler")
        if not s:
            continue
        rows = [
            f"{w.get('addr', '?')}: service ewma "
            f"{(w.get('ewma_s') or 0.0) * 1e3:.1f} ms, gated "
            f"{w.get('gated', 0)}/{cp.get('batches', 0)} batch(es) "
            f"({100 * (w.get('gated_share') or 0.0):.0f}%)"
            for w in cp.get("workers") or []
        ]
        out.append(_finding(
            "warn",
            85.0 + min(10.0, 2.0 * (s.get("skew") or 0.0)),
            f"worker {s.get('addr', '?')} is the persistent straggler — "
            f"gated {100 * (s.get('gated_share') or 0.0):.0f}% of "
            f"{cp.get('batches', 0)} K-batch gather(s)",
            "every fan-out turn completes at the slowest worker: this "
            f"one runs at {s.get('skew', 0.0):.1f}x the roster's median "
            "service time, so it sets the whole cluster's turn rate. "
            "Nothing has failed, so only this attribution sees it. "
            "Rebalance its strip share, or drain and replace the host.",
            rows,
            [s.get("addr", "?")],
            label,
        ))
    return out


def _find_hbm(statuses) -> List[dict]:
    out = []
    for label, payload in statuses.items():
        snap = payload.get("metrics") or {}
        in_use = _series_map(snap, "gol_device_hbm_bytes_in_use")
        limits = _series_map(snap, "gol_device_hbm_bytes_limit")
        for labels, s in in_use.items():
            used = s.get("value") or 0
            cap = (limits.get(labels) or {}).get("value") or 0
            if cap and used / cap > 0.9:
                dev = labels[0] if labels else "?"
                out.append(_finding(
                    "warn", 70.0,
                    f"device {dev} HBM at {100 * used / cap:.0f}%",
                    "the next admission or chunk growth may OOM; shrink "
                    "-session-capacity or the board.",
                    [f"gol_device_hbm_bytes_in_use {used:.3g} / {cap:.3g}"],
                    [], label,
                ))
    return out


def _find_checkpoint(statuses) -> List[dict]:
    out = []
    for label, payload in statuses.items():
        snap = payload.get("metrics") or {}
        errs = _scalar(snap, "gol_engine_checkpoint_errors_total") or 0
        ck = _series_map(snap, "gol_ckpt_verify_total")
        bad = (ck.get(("fail",)) or {}).get("value") or 0
        if not errs and not bad:
            continue
        evidence = []
        if errs:
            evidence.append(f"{int(errs)} periodic checkpoint write failure(s)")
        if bad:
            evidence.append(f"{int(bad)} checkpoint digest verification failure(s)")
        out.append(_finding(
            "warn", 60.0,
            "checkpoint trouble: crash-recovery coverage is degraded",
            "the run continues, but a crash now may lose more turns than "
            "-auto-checkpoint promises; check disk space and the "
            "-ckpt-keep generations.",
            evidence, [], label,
        ))
    return out


#: where _find_journal reads persisted segments from — module-level so
#: tests (and the selfcheck's tmp dir) can point it elsewhere
_JOURNAL_DIR = "out"


def _find_journal(statuses) -> List[dict]:
    """Journal-fed findings that SURVIVE restarts: unlike every other
    heuristic (which reads live Status payloads), this one reads the
    on-disk journal segments (obs/journal.py) — so a worker that flapped
    three times YESTERDAY, under a broker that has since restarted and
    forgotten, still surfaces. Two findings:

    * repeat-loss/flap correlation: an address with repeated
      lost->readmitted cycles across the whole persisted history;
    * torn/corrupted records: crc-detected damage in the segments
      themselves (a SIGKILL mid-append) — loud, never silent."""
    from . import journal as _jn

    events, problems = _jn.read_segments(_JOURNAL_DIR)
    # fold in live in-memory tails when the polled processes ship them
    # (events not yet flushed to a segment)
    for label, payload in statuses.items():
        jw = payload.get("journal")
        if isinstance(jw, dict) and isinstance(jw.get("events"), list):
            events.extend(e for e in jw["events"] if isinstance(e, dict))
    out = []
    losses: Dict[str, int] = {}
    readmits: Dict[str, int] = {}
    seen_ev = set()
    for e in events:
        key = (_jn.event_node(e), e.get("seq"), e.get("kind"))
        if key in seen_ev:
            continue  # an event in both a live tail and a segment
        seen_ev.add(key)
        if e.get("kind") == "worker.lost":
            losses[e.get("name", "?")] = losses.get(e.get("name", "?"), 0) + 1
        elif e.get("kind") == "worker.readmit":
            readmits[e.get("name", "?")] = (
                readmits.get(e.get("name", "?"), 0) + 1
            )
    for addr, n in sorted(losses.items(), key=lambda kv: -kv[1]):
        if n < 2:
            continue
        back = readmits.get(addr, 0)
        out.append(_finding(
            "warn", 75.0 + min(15.0, 3.0 * n),
            f"worker {addr} flapped: {n} losses / {back} readmissions "
            "across the persisted journal history",
            "repeat lost->readmitted cycles — a flapper taxes every turn "
            "a deadline when admitted. This evidence comes from the "
            "on-disk journal segments, so it survives broker restarts "
            "that reset the live loss counters. Quarantine backoff is "
            "escalating (worker.quarantine events); consider draining "
            "the host.",
            [f"journal: {n} worker.lost, {back} worker.readmit for {addr}"],
            [addr], "journal",
        ))
    if problems:
        out.append(_finding(
            "warn", 55.0,
            f"{len(problems)} damaged journal record(s)/segment(s) "
            "detected (crc)",
            "torn tails are expected after a SIGKILL mid-append — the "
            "surviving records still reconstruct; repeated damage on a "
            "LIVE process suggests disk trouble.",
            problems[:8], [], "journal",
        ))
    return out


def _find_hotspot(statuses) -> List[dict]:
    """The profile x decomposition join (obs/profiler.py x obs/perf.py):
    when a ``-profile`` target's busy samples concentrate in one frame,
    NAME it — and when the PR 12 segment decomposition also has a
    dominant segment, say which wall that code is ("host_prep 58% of the
    turn; 71% of busy samples in pickle.dumps"). Idle leaves (accept/
    select/wait) are excluded: a parked server thread is not a hotspot."""
    from .perf import decomposition_summary
    from .profiler import is_idle_frame

    out = []
    for label, payload in statuses.items():
        pw = payload.get("profile")
        if not isinstance(pw, dict):
            continue
        stacks = pw.get("stacks") or 0
        busy = [
            r for r in pw.get("frames") or []
            if isinstance(r, dict) and (r.get("self") or 0) > 0
            and not is_idle_frame(
                str(r.get("func", "")), str(r.get("file", ""))
            )
        ]
        if stacks < 20 or not busy:
            continue  # too few samples to name anything honestly
        busy_total = sum(r.get("self") or 0 for r in busy)
        if not busy_total:
            continue
        top = busy[0]  # windows ship hottest-self-first
        share = (top.get("self") or 0) / busy_total
        if share < 0.25:
            continue
        func = str(top.get("func", "?"))
        where = f"{top.get('file', '?')}:{top.get('line', '?')}"
        evidence = [
            f"{top.get('self')} of {busy_total} busy sample(s) "
            f"({share:.0%}) at {func} ({where}); {stacks} stacks total "
            f"@ {pw.get('period_ms', '?')}ms cadence"
        ]
        for hs in pw.get("hot_stacks") or []:
            # caller context: the hottest leaf path through this frame —
            # a leaf alone (e.g. a helper) can be ambiguous
            if isinstance(hs, dict) and func in str(hs.get("stack", "")):
                evidence.append(
                    f"hot path ({hs.get('self')} hit(s)): {hs['stack']}"
                )
                break
        seg_note = ""
        decomp = decomposition_summary(payload.get("metrics") or {})
        hot_seg, hot_share, hot_comp = None, 0.0, None
        for comp, segs in decomp.items():
            for seg, e in segs.items():
                if not seg.startswith("_") and isinstance(e, dict) \
                        and e.get("share", 0) > hot_share:
                    hot_seg, hot_share, hot_comp = seg, e["share"], comp
        if hot_seg and hot_share >= 0.4:
            seg_note = (
                f" while segment '{hot_seg}' holds {hot_share:.0%} of "
                f"{hot_comp}'s decomposed wall"
            )
            evidence.append(
                f"gol_turn_segment_seconds: {hot_comp}/{hot_seg} "
                f"share {hot_share:.0%}"
            )
        out.append(_finding(
            "warn", 40.0 + 55.0 * share,
            f"hotspot: {func} holds {share:.0%} of busy samples",
            f"the continuous profiler names {func} ({where}) as the "
            f"dominant busy frame{seg_note}. If this is unexpected, "
            "diff against a clean run: python -m "
            "gol_distributed_final_tpu_torch.obs.flame -diff OLD NEW.",
            evidence, [], label,
        ))
    return out


def _find_fleet_targets(statuses) -> List[dict]:
    """Fleet scrape-health findings (obs/fleet.py collector payloads): a
    STALE target is a dead process named WITH its scrape evidence —
    last-success age, consecutive-failure count, the last error string —
    and a stale BROKER outranks every other page (a broker the fleet
    lost is the first thing to fix). Failing-but-not-yet-stale targets
    and merge-excluded (version-skewed) snapshots warn."""
    out = []
    for label, payload in statuses.items():
        fl = payload.get("fleet")
        if not isinstance(fl, dict):
            continue
        for t in fl.get("targets") or []:
            state = t.get("state")
            if state not in ("stale", "failing"):
                continue
            addr = str(t.get("address", "?"))
            kind = "worker" if t.get("worker") else "broker"
            fails = int(t.get("consecutive_failures") or 0)
            age = t.get("last_success_age_s")
            evidence = [
                f"scrape health: {fails} consecutive failure(s), "
                f"{int(t.get('ok_total') or 0)} ok / "
                f"{int(t.get('err_total') or 0)} error(s) lifetime",
                "last successful scrape: "
                + (f"{age:.1f}s ago" if isinstance(age, (int, float))
                   else "never"),
            ]
            if t.get("error"):
                evidence.append(f"last scrape error: {t['error']}")
            if state == "stale":
                out.append(_finding(
                    "page" if kind == "broker" else "warn",
                    110.0 + fails,
                    f"fleet target {kind} {addr} is DOWN (stale)",
                    "no successful Status scrape past the staleness "
                    f"bound ({fl.get('stale_after_s', '?')}s): its "
                    "metrics left the merged registry (the fleet sums "
                    "now cover the survivors only) and the "
                    "'target-down' fleet rule pages on the "
                    "gol_fleet_targets_down gauge.",
                    evidence, [addr], label,
                ))
            else:
                out.append(_finding(
                    "warn", 58.0 + fails,
                    f"fleet target {kind} {addr} failing scrapes",
                    "recent scrapes failed but the last success is "
                    "still inside the staleness bound — a blip, or the "
                    "start of an outage.",
                    evidence, [addr], label,
                ))
        for eaddr, why in sorted((fl.get("merge_excluded") or {}).items()):
            out.append(_finding(
                "warn", 57.0,
                f"fleet target {eaddr} EXCLUDED from the merged registry",
                "its snapshot could not be merged exactly (version skew "
                "across the fleet); it was dropped and counted "
                "(gol_fleet_merge_failures_total), never averaged in.",
                [why], [eaddr], label,
            ))
    return out


def _find_fleet_share(statuses) -> List[dict]:
    """The cross-broker balance findings (fleet payloads only): one
    broker holding a disproportionate share of the fleet's
    device-seconds, and one tenant riding far past its fair share on a
    single broker (the merged-ledger skew the gol_fleet_tenant_skew
    gauge tracks)."""
    out = []
    for label, payload in statuses.items():
        fl = payload.get("fleet")
        if not isinstance(fl, dict):
            continue
        dev: Dict[str, float] = {}
        for addr, bp in (fl.get("broker_status") or {}).items():
            totals = (bp.get("accounting") or {}).get("totals") or {}
            ds = totals.get("device_seconds")
            if isinstance(ds, (int, float)) and ds > 0:
                dev[addr] = float(ds)
        if len(dev) >= 2:
            total = sum(dev.values())
            hot = max(dev, key=dev.get)
            share = dev[hot] / total
            if share > max(0.6, 2.0 / len(dev)):
                out.append(_finding(
                    "warn", 62.0 + 20.0 * share,
                    f"broker {hot} holds {100 * share:.0f}% of fleet "
                    "device-seconds",
                    "the fleet's device time is concentrated on one "
                    "broker while the rest idle — the load view the "
                    "ROADMAP's session-router tier will route against.",
                    [f"{a}: {v:.3f} dev-s ({100 * v / total:.0f}%)"
                     for a, v in sorted(dev.items(), key=lambda kv: -kv[1])],
                    [hot], label,
                ))
        sk = fl.get("tenant_skew") or {}
        val = sk.get("value")
        if isinstance(val, (int, float)) and val > 3.0:
            out.append(_finding(
                "warn", 61.0,
                f"tenant '{sk.get('tenant')}' rides {val:.1f}x its fair "
                f"share on broker {sk.get('address')}",
                "cross-broker tenant skew from the merged ledgers: this "
                "tenant's device-seconds pile onto one broker instead "
                "of spreading — respread it, or the hot broker's "
                "co-tenants pay its admission waits.",
                [f"gol_fleet_tenant_skew = {val:.2f} "
                 "(the fleet-tenant-skew rule warns past 3.0)"],
                [str(sk.get("address"))], label,
            ))
    return out


def _find_fleet_provenance(statuses) -> List[dict]:
    """Divergent provenance across fleet targets: brokers that disagree
    on the Status payload schema, the metrics snapshot schema, or the
    backend class are running different code or config. Merged sums
    stay exact either way, but cross-broker comparisons stop meaning
    one thing — and schema skew is the usual root of a merge
    exclusion."""
    out = []
    for label, payload in statuses.items():
        fl = payload.get("fleet")
        if not isinstance(fl, dict):
            continue
        brokers = fl.get("broker_status") or {}
        if len(brokers) < 2:
            continue
        stamps = {
            addr: (
                str(bp.get("schema")),
                str((bp.get("metrics") or {}).get("schema")),
                str(bp.get("backend")),
            )
            for addr, bp in brokers.items()
        }
        if len(set(stamps.values())) > 1:
            out.append(_finding(
                "warn", 59.0,
                "divergent provenance across fleet brokers",
                "targets report different status/metrics schemas or "
                "backend classes — a mixed-version or mixed-config "
                "fleet.",
                [f"{a}: status {s[0]}, metrics {s[1]}, backend {s[2]}"
                 for a, s in sorted(stamps.items())],
                sorted(stamps), label,
            ))
    return out


_HEURISTICS = (
    _find_unreachable,
    _find_fleet_targets,
    _find_lost_workers,
    _find_integrity,
    _find_alerts,
    _find_error_ratio,
    _find_straggler,
    _find_tenant_skew,
    _find_stall,
    _find_hbm,
    _find_checkpoint,
    _find_journal,
    _find_hotspot,
    _find_fleet_share,
    _find_fleet_provenance,
)


def diagnose(statuses: Dict[str, dict]) -> List[dict]:
    """The correlation core: pure function of the fetched payloads.
    Returns findings ranked severity-then-score, deduplicated by
    (severity, title); ALWAYS non-empty — a clean bill of health is
    itself a finding (the smoke gate's renderable-diagnosis contract)."""
    findings: List[dict] = []
    seen = set()
    for heuristic in _HEURISTICS:
        try:
            batch = heuristic(statuses)
        except Exception as exc:  # a probe bug must not sink the triage
            batch = [_finding(
                "info", 0.0, f"heuristic {heuristic.__name__} failed",
                str(exc), [], [], "-",
            )]
        for f in batch:
            key = (f["severity"], f["title"])
            if key not in seen:
                seen.add(key)
                findings.append(f)
    if not findings:
        polled = sum(1 for p in statuses.values() if "error" not in p)
        findings.append(_finding(
            "info", 0.0, "no anomalies detected",
            f"{polled}/{len(statuses)} target(s) answered Status; no lost "
            "workers, no firing alerts, no integrity failures, no error "
            "ratio past 1%.",
            [], [], "-",
        ))
    findings.sort(
        key=lambda f: (_SEVERITY_ORDER.get(f["severity"], 9), -f["score"])
    )
    for rank, f in enumerate(findings, 1):
        f["rank"] = rank
    return findings


def render(findings: List[dict], statuses: Dict[str, dict]) -> str:
    """Terminal report — pure function of the diagnosis (testable without
    a cluster, the obs/watch.py renderer posture)."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    lines = [f"gol doctor — {stamp}   ({len(statuses)} target(s) polled)"]
    for label, payload in statuses.items():
        state = (
            f"UNREACHABLE — {payload['error']}"
            if "error" in payload
            else f"ok (pid {payload.get('pid', '?')}"
            + (
                "" if payload.get("metrics_enabled")
                else ", metrics DISABLED"
            )
            + ")"
        )
        lines.append(f"  {label}: {state}")
    lines.append("")
    for f in findings:
        lines.append(
            f"#{f['rank']} [{f['severity'].upper()}] {f['title']}"
        )
        if f.get("detail"):
            lines.append(f"    {f['detail']}")
        for e in f.get("evidence", []):
            lines.append(f"    - {e}")
        if f.get("suspects"):
            lines.append(f"    suspects: {', '.join(f['suspects'])}")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def write_report(
    findings: List[dict], statuses: Dict[str, dict], out_dir="out"
) -> pathlib.Path:
    """``out/doctor_<ts>.json``: diagnosis + per-target identity (NOT the
    full payloads — flight rings and timelines would bloat the artifact;
    the evidence strings carry what mattered). Temp-name + atomic rename
    like every other artifact writer."""
    path = pathlib.Path(out_dir) / f"doctor_{int(time.time())}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    targets = {}
    for label, payload in statuses.items():
        if "error" in payload:
            targets[label] = {"error": payload["error"]}
        else:
            targets[label] = {
                "pid": payload.get("pid"),
                "role": payload.get("role"),
                "metrics_enabled": payload.get("metrics_enabled"),
                "firing_alerts": [
                    a.get("rule") for a in payload.get("alerts") or []
                    if a.get("state") == "firing"
                ],
            }
    report = {
        "schema": SCHEMA,
        "generated_unix": time.time(),
        "targets": targets,
        "findings": findings,
    }
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(report, indent=1, default=str))
    tmp.replace(path)
    return path


# artifact globs a bundle collects out of the artifact directory — the
# files post-hoc triage used to mean hand-gathering. Newest-first per
# pattern, capped (keep=N) so a long-lived out/ does not balloon the
# bundle — EXCEPT the journal segments (keep=None: unlimited): the
# lifecycle journal is the causal event history, and a rotated .g2
# segment may hold exactly the loss/recovery sequence being triaged, so
# EVERY generation of every process's journal is collected. Whatever a
# cap drops is recorded in the manifest's ``dropped`` list — a bundle
# must never look more complete than it is. The accounting ledger has
# no on-disk artifact of its own: it rides each target's FULL Status
# payload, which the bundle writes verbatim.
_BUNDLE_GLOBS = (
    ("trace", "trace_*.json", 3),
    ("flight", "flight_*.jsonl", 3),
    ("report", "report_*.json", 3),
    ("doctor", "doctor_*.json", 3),
    ("history", "history_*.json", 3),
    ("journal", "journal_*.jsonl", None),
    # continuous-profiler artifacts (obs/profiler.py): the run-end and
    # crash profiles of every process — the flame/diff feedstock; 6
    # keeps both forms for a broker + a couple of workers
    ("profile", "profile_*.collapsed", 6),
    ("profile", "profile_*.speedscope.json", 6),
    ("analysis", "analysis.json", 1),
)


def write_bundle(
    findings: List[dict], statuses: Dict[str, dict], out_dir="out"
) -> pathlib.Path:
    """One ``out/bundle_<ts>/`` incident directory: the diagnosis, every
    target's FULL Status payload (metrics + timeline + flight ring +
    accounting — the live evidence), and copies of the existing on-disk
    artifacts (traces, flight dumps, run reports, prior diagnoses, the
    analysis posture), indexed by a ``manifest.json`` — so post-hoc
    triage is one directory to attach, not five files to hand-gather."""
    import shutil

    out = pathlib.Path(out_dir)
    bdir = out / f"bundle_{int(time.time())}"
    bdir.mkdir(parents=True, exist_ok=True)
    entries = []

    def _write(name: str, payload, source: str) -> None:
        path = bdir / name
        path.write_text(json.dumps(payload, indent=1, default=str))
        entries.append({
            "file": name, "source": source, "bytes": path.stat().st_size,
        })

    _write(
        "doctor.json",
        {"schema": SCHEMA, "generated_unix": time.time(),
         "findings": findings},
        "diagnosis",
    )
    for label, payload in statuses.items():
        slug = label.replace(" ", "_").replace(":", "").replace("/", "_")
        _write(f"status_{slug}.json", payload, f"live Status poll: {label}")
    dropped = []
    for kind, pattern, keep in _BUNDLE_GLOBS:
        found = [
            p for p in sorted(
                out.glob(pattern),
                key=lambda p: p.stat().st_mtime, reverse=True,
            )
            if bdir not in p.parents  # never re-collect this bundle's own
        ]
        take = found if keep is None else found[:keep]
        for src in found[len(take):]:
            # capped out: the manifest NAMES what the bundle left behind,
            # so an incomplete bundle never masquerades as the full record
            dropped.append({
                "file": src.name, "kind": kind,
                "why": f"newest-{keep} cap for {kind} artifacts",
            })
        for src in take:
            dst = bdir / src.name
            try:
                shutil.copy2(src, dst)
            except OSError as exc:
                # a copy failure is ALSO a dropped file: stamp it into
                # the same manifest list with its family and reason (the
                # cap-drop shape, applied uniformly), so a postmortem
                # reads ONE list of what this bundle is missing and why
                dropped.append({
                    "file": src.name, "kind": kind,
                    "why": f"copy failed: {exc}",
                })
                continue
            entries.append({
                "file": src.name, "source": f"{kind} artifact ({src})",
                "bytes": dst.stat().st_size,
            })
    manifest = {
        "schema": "gol-bundle/1",
        "generated_unix": time.time(),
        "targets": sorted(statuses),
        "entries": entries,
        "dropped": dropped,
    }
    (bdir / "manifest.json").write_text(
        json.dumps(manifest, indent=1, default=str)
    )
    return bdir


def _selfcheck(out_dir: str, device: str = "cuda") -> int:
    """The ``scripts/check --doctor`` smoke: loopback broker on ``device``
    (the card unless "cpu"), tiny run, poll + diagnose + render + write,
    fail on empty/unrenderable."""
    import numpy as np

    from ..obs import metrics as _metrics
    from ..obs import timeline as _timeline
    from ..rpc.broker import serve
    from ..rpc.client import RpcClient
    from ..rpc.protocol import Methods, Request

    _metrics.enable()
    _timeline.enable(period=0.1)
    server, _service = serve(port=0, device=device)
    try:
        addr = f"127.0.0.1:{server.port}"
        rng = np.random.default_rng(7)
        board = np.where(rng.random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
        client = RpcClient(addr)
        try:
            client.call(
                Methods.BROKER_RUN,
                Request(world=board, turns=8, image_width=64,
                        image_height=64, threads=1),
                timeout=120.0,
            )
        finally:
            client.close()
        time.sleep(0.3)  # at least two sampler ticks land
        statuses = collect(addr, [])
        findings = diagnose(statuses)
        text = render(findings, statuses)
        path = write_report(findings, statuses, out_dir)
        sys.stdout.write(text)
        tl = statuses.get(f"broker {addr}", {}).get("timeline") or {}
        if not findings or not text.strip():
            print("doctor selfcheck FAILED: empty diagnosis", file=sys.stderr)
            return 1
        if not tl.get("series"):
            print(
                "doctor selfcheck FAILED: broker shipped no timeline window",
                file=sys.stderr,
            )
            return 1
        print(f"doctor selfcheck ok: report at {path}")
        return 0
    finally:
        _timeline.disable()
        server.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="one-shot cluster triage over the read-only Status verb"
    )
    parser.add_argument(
        "address", nargs="?", default=None,
        help="broker host:port (tcp:// prefix and :port shorthand accepted)",
    )
    parser.add_argument(
        "-worker", action="append", default=[], metavar="HOST:PORT",
        help="extra worker to poll beyond the broker's worker_health "
             "roster, which is auto-discovered (repeatable)",
    )
    parser.add_argument(
        "-timeout", type=float, default=5.0, metavar="SECONDS",
        help="per-target poll bound (default 5); an unreachable target "
             "becomes evidence, not a hang",
    )
    parser.add_argument(
        "-out", default="out", metavar="DIR",
        help="directory for doctor_<ts>.json (default out)",
    )
    parser.add_argument(
        "-json", action="store_true",
        help="print the JSON report to stdout instead of the terminal text",
    )
    parser.add_argument(
        "-bundle", action="store_true",
        help="also collect a full incident bundle: out/bundle_<ts>/ with "
             "the diagnosis, every target's full Status payload (metrics "
             "+ timeline + flight + accounting), and copies of the "
             "existing trace/flight/report/analysis artifacts, indexed "
             "by manifest.json",
    )
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="spin a loopback broker, run a tiny job, diagnose it, and "
             "fail on an empty diagnosis (the scripts/check --doctor gate)",
    )
    parser.add_argument(
        "-device", default="cuda",
        help="--selfcheck's broker: cuda (default; fails without a card) "
             "or cpu",
    )
    args = parser.parse_args(argv)
    if args.selfcheck:
        return _selfcheck(args.out, args.device)
    if not args.address:
        parser.error("an address is required (or --selfcheck)")
    statuses = collect(args.address, args.worker, timeout=args.timeout)
    findings = diagnose(statuses)
    path = write_report(findings, statuses, args.out)
    if args.bundle:
        bdir = write_bundle(findings, statuses, args.out)
        print(f"incident bundle collected at {bdir}", file=sys.stderr)
    if args.json:
        print(json.dumps(
            {"findings": findings, "report_path": str(path)},
            indent=1, default=str,
        ))
    else:
        sys.stdout.write(render(findings, statuses))
        print(f"report written to {path}")
    broker_label = next(iter(statuses), None)
    broker_ok = broker_label is not None and "error" not in statuses[broker_label]
    return 0 if broker_ok else 1


if __name__ == "__main__":
    sys.exit(main())
