"""Cross-process postmortem reconstruction: one causally-ordered timeline.

    python -m gol_distributed_final_tpu_torch.obs.history myrun
    python -m gol_distributed_final_tpu_torch.obs.history crash -dir out
    python -m gol_distributed_final_tpu_torch.obs.history live -broker :8040 \
        -worker :8030 -worker :8031
    python -m gol_distributed_final_tpu_torch.obs.history t7 -tenant 7
    python -m gol_distributed_final_tpu_torch.obs.history w0 -address 127.0.0.1:8030

Every ``-journal`` process (broker, workers, engine) appends its
lifecycle events to its own ``out/journal_<role>_<pid>.jsonl`` segment,
each event stamped with a hybrid logical clock (obs/journal.py). This
CLI is the merge: it reads the on-disk segments of DEAD processes,
optionally fetches the live in-memory tails of RUNNING ones (the
incremental Status window, ``Request.journal_since`` — the
timeline_since pattern), dedups events that appear in both a live
window and a flushed segment, sorts everything by HLC key, and renders
the universe's history as one causal timeline: admission -> chunk
commits -> worker lost -> recovery/resplit -> readmission -> final.

Causality is what makes the merge meaningful: wall clocks across the
processes may disagree by seconds, but every RPC carries an HLC stamp
both ways (rpc/client.py / rpc/server.py), so a broker-side event
CAUSED by a worker's reply always sorts after the worker-side events
that produced it — no NTP assumption anywhere.

Torn or corrupted records (a SIGKILL mid-append) are crc-detected,
skipped, and reported LOUDLY in the ``problems`` section — never a
crash, never a silent gap.

Output: a terminal report plus ``out/history_<tag>.json`` (schema
``gol-history/1``), written tmp-then-rename like every other artifact.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import List, Optional, Tuple

from . import journal as _journal

SCHEMA = "gol-history/1"

#: terminal render cap — the JSON artifact always carries everything
DEFAULT_SHOW = 200


#: the emitting process's identity (segment records carry it inside the
#: HLC stamp) — shared with doctor's journal heuristic
_node = _journal.event_node


def _dedup_key(event: dict) -> tuple:
    """Identity of one event across sources: the same record can arrive
    via a live Status window AND (later) the flushed on-disk segment —
    (node, seq) is unique per process journal, with the HLC stamp as a
    fallback for events from a pre-seq source."""
    node = _node(event)
    seq = event.get("seq")
    if isinstance(seq, int):
        return (node, seq)
    hlc = event.get("hlc")
    return (node, tuple(hlc) if isinstance(hlc, list) else event.get("t_unix"))


def merge_events(
    *sources: List[dict],
) -> List[dict]:
    """Merge event lists from any number of sources (segments, live
    windows) into ONE list in HLC order, deduplicating records seen via
    more than one source. Ties (same physical+logical) break on node id
    — deterministic regardless of input order."""
    seen = set()
    out: List[dict] = []
    for events in sources:
        for ev in events:
            if not isinstance(ev, dict):
                continue
            k = _dedup_key(ev)
            if k in seen:
                continue
            seen.add(k)
            out.append(ev)
    out.sort(key=_journal.hlc_key)
    return out


def _matches(
    event: dict,
    tenant: Optional[str],
    address: Optional[str],
    since_ms: Optional[int] = None,
    until_ms: Optional[int] = None,
) -> bool:
    if tenant is not None:
        args = event.get("args") or {}
        if str(args.get("tenant", "")) != tenant:
            return False
    if address is not None:
        # worker-address filter: matches the event NAME (loss/readmit/
        # quarantine events name the address) or the source node
        if address not in str(event.get("name", "")) and address not in _node(
            event
        ):
            return False
    if since_ms is not None or until_ms is not None:
        # time-window filter on the HLC's PHYSICAL milliseconds (the
        # sort key's first component) — the same clock the render
        # stamps, so a window cut from a rendered timeline round-trips.
        # Both bounds inclusive; an event with no usable stamp (hlc_key
        # falls back to 0) only survives an unbounded-below window.
        phys = _journal.hlc_key(event)[0]
        if since_ms is not None and phys < since_ms:
            return False
        if until_ms is not None and phys > until_ms:
            return False
    return True


def fetch_live_events(
    brokers: List[str], workers: List[str], timeout: float
) -> Tuple[List[dict], List[str]]:
    """Fetch the in-memory journal tails of live processes via Status
    (full window: since=0). A dead or journal-less process is a note,
    not a failure — its on-disk segments still tell its story."""
    from .status import fetch_status

    events: List[dict] = []
    problems: List[str] = []
    for addr, worker in [(a, False) for a in brokers] + [
        (a, True) for a in workers
    ]:
        role = "worker" if worker else "broker"
        try:
            payload = fetch_status(addr, worker=worker, timeout=timeout)
        except Exception as exc:  # dead process: its segments still tell
            problems.append(f"{role} {addr}: live fetch failed ({exc})")
            continue
        jw = payload.get("journal")
        if not isinstance(jw, dict):
            problems.append(
                f"{role} {addr}: answered Status but ships no journal "
                "window (started without -journal, or version skew)"
            )
            continue
        evs = jw.get("events")
        if isinstance(evs, list):
            events.extend(e for e in evs if isinstance(e, dict))
        dropped = jw.get("dropped", 0)
        if dropped:
            problems.append(
                f"{role} {addr}: journal reports {dropped} dropped "
                "event(s) (queue overflow or rotation past -journal keep)"
            )
    return events, problems


def build_history(
    tag: str,
    out_dir: str = "out",
    brokers: Optional[List[str]] = None,
    workers: Optional[List[str]] = None,
    tenant: Optional[str] = None,
    address: Optional[str] = None,
    timeout: float = 5.0,
    since_ms: Optional[int] = None,
    until_ms: Optional[int] = None,
) -> dict:
    """The full reconstruction: segments + live windows -> one merged,
    filtered, HLC-ordered history dict (schema ``gol-history/1``).
    ``since_ms``/``until_ms`` bound the window on HLC physical
    milliseconds (unix epoch ms, both inclusive)."""
    seg_paths = _journal.segment_paths(out_dir)
    seg_events, problems = _journal.read_segments(seg_paths)
    live_events: List[dict] = []
    if brokers or workers:
        live_events, live_problems = fetch_live_events(
            brokers or [], workers or [], timeout
        )
        problems.extend(live_problems)
    merged = merge_events(seg_events, live_events)
    filtered = [
        e for e in merged
        if _matches(e, tenant, address, since_ms, until_ms)
    ]
    by_kind: dict = {}
    nodes = set()
    for e in filtered:
        by_kind[e.get("kind", "?")] = by_kind.get(e.get("kind", "?"), 0) + 1
        nodes.add(_node(e))
    return {
        "schema": SCHEMA,
        "tag": tag,
        "time_unix": time.time(),
        "segments": [str(p) for p in seg_paths],
        "nodes": sorted(nodes),
        "events_total": len(filtered),
        "by_kind": dict(sorted(by_kind.items())),
        "filters": {
            "tenant": tenant, "address": address,
            "since_ms": since_ms, "until_ms": until_ms,
        },
        "problems": problems,
        "events": filtered,
    }


def _fmt_event(event: dict) -> str:
    hlc = event.get("hlc")
    if isinstance(hlc, list) and len(hlc) == 3:
        ts = time.strftime("%H:%M:%S", time.localtime(hlc[0] / 1000.0))
        stamp = f"{ts}.{int(hlc[0]) % 1000:03d}+{hlc[1]}"
    else:
        t = event.get("t_unix")
        stamp = (
            time.strftime("%H:%M:%S", time.localtime(t))
            if isinstance(t, (int, float)) else "--:--:--"
        )
    node = _node(event)
    kind = event.get("kind", "?")
    name = event.get("name", "")
    args = event.get("args") or {}
    detail = " ".join(f"{k}={v}" for k, v in args.items())
    return f"{stamp}  {node:<24} {kind:<18} {name} {detail}".rstrip()


def render(history: dict, show: int = DEFAULT_SHOW) -> str:
    lines = [
        f"history '{history['tag']}': {history['events_total']} event(s) "
        f"across {len(history['nodes'])} process(es)",
    ]
    for node in history["nodes"]:
        lines.append(f"  node {node}")
    if history["by_kind"]:
        kinds = ", ".join(f"{k}x{n}" for k, n in history["by_kind"].items())
        lines.append(f"  kinds: {kinds}")
    events = history["events"]
    shown = events[-show:] if show and len(events) > show else events
    if len(shown) < len(events):
        lines.append(
            f"  ... showing the last {len(shown)} of {len(events)} "
            "(the JSON artifact carries all)"
        )
    lines.append("")
    for e in shown:
        lines.append("  " + _fmt_event(e))
    if history["problems"]:
        lines.append("")
        lines.append(f"PROBLEMS ({len(history['problems'])}):")
        for p in history["problems"]:
            lines.append(f"  !! {p}")
    return "\n".join(lines)


def write_history(history: dict, out_dir: str = "out") -> pathlib.Path:
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"history_{history['tag']}.json"
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(history, indent=1, default=str))
    tmp.replace(path)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="merge journal segments + live tails into one "
                    "causally-ordered (HLC) cross-process timeline"
    )
    parser.add_argument(
        "tag", help="artifact tag: writes out/history_<tag>.json"
    )
    parser.add_argument(
        "-dir", default="out", metavar="DIR",
        help="directory holding journal_<role>_<pid>[.gN].jsonl segments "
             "(default out/) — also where the history artifact lands",
    )
    parser.add_argument(
        "-broker", action="append", default=[], metavar="ADDR",
        help="also fetch a LIVE broker's in-memory journal tail via "
             "Status (repeatable)",
    )
    parser.add_argument(
        "-worker", action="append", default=[], metavar="ADDR",
        help="also fetch a LIVE worker's in-memory journal tail via "
             "Status (repeatable)",
    )
    parser.add_argument(
        "-tenant", default=None,
        help="filter: only events attributed to this tenant id",
    )
    parser.add_argument(
        "-address", default=None,
        help="filter: only events naming this worker address (losses, "
             "readmissions, quarantines) or emitted by it",
    )
    parser.add_argument(
        "-since", type=int, default=None, metavar="MS",
        help="filter: only events whose HLC physical stamp is at or "
             "after this unix-epoch millisecond (the merge's sort key — "
             "skew-safe across processes, unlike per-host wall clocks)",
    )
    parser.add_argument(
        "-until", type=int, default=None, metavar="MS",
        help="filter: only events whose HLC physical stamp is at or "
             "before this unix-epoch millisecond (pairs with -since to "
             "cut an incident window out of a long run)",
    )
    parser.add_argument(
        "-show", type=int, default=DEFAULT_SHOW, metavar="N",
        help=f"terminal rows rendered (default {DEFAULT_SHOW}; 0 = all); "
             "the JSON artifact always carries every event",
    )
    parser.add_argument(
        "-timeout", type=float, default=5.0, metavar="SECS",
        help="bound per live Status fetch (default 5)",
    )
    args = parser.parse_args(argv)
    history = build_history(
        args.tag,
        out_dir=args.dir,
        brokers=args.broker,
        workers=args.worker,
        tenant=args.tenant,
        address=args.address,
        timeout=args.timeout,
        since_ms=args.since,
        until_ms=args.until,
    )
    print(render(history, show=args.show))
    path = write_history(history, args.dir)
    print(f"\nwrote {path}")
    # problems are loud but not fatal: a torn tail is EXPECTED after a
    # SIGKILL — the report names it and the surviving records still
    # reconstruct; only a totally empty reconstruction fails the run
    if not history["events"]:
        print("no journal events found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
