"""The arithmetic of the program's own spans in a traced run.

A traced run can carry ``records["spans"]``: ``{"records": [...],
"dropped": n}``, every span both processes finished over the window
(``gol_distributed_final_tpu_torch/obs/tracing.py``'s records, each with
its ``role``, ``controller`` or ``broker``, and its ``start_ns`` and
``end_ns`` on the profiler's clock), and how many spans their rings
evicted. Where a ring evicted any, the window is not whole and every
reader here returns None, as it does where a run carries no spans.

A session is the ``trace_id`` of a ``controller.session`` span inside the
window: every span of that session, on either process, carries it. The
spans overlap (a collection can fall inside ``controller.final_cells``),
so the per-session readings are not parts of a session that add up.
"""

from __future__ import annotations

#: spans that only wrap others: a host phase is what lies inside them
WRAPPERS = frozenset({"controller.session", "rpc.client.call", "rpc.server.dispatch"})
#: the span during which the host waits for the card
SYNC = "engine.sync"


def spans_of(r):
    """The run's span records, or None where it has none or lost some."""
    found = r.get("spans")
    if not found or found.get("dropped", 0) > 0 or not found.get("records"):
        return None
    return found["records"]


def clip(spans, t0: int, t1: int) -> list:
    """``(span, start, end)`` of each span cut to the window, the empty
    ones left out."""
    out = []
    for s in spans:
        start, end = max(s["start_ns"], t0), min(s["end_ns"], t1)
        if end > start:
            out.append((s, start, end))
    return out


def sessions(spans, t0: int, t1: int) -> set:
    """The trace ids of the ``controller.session`` spans inside the
    window."""
    return {s["trace_id"] for s in spans if s["name"] == "controller.session"
            and t0 <= s["start_ns"] and s["end_ns"] <= t1}


def innermost(spans, role: str, at: int):
    """The innermost span open on process ``role`` at instant ``at``: of
    the spans holding it, the one that started last (the shorter on a
    tie); None where none is open."""
    best = None
    for s in spans:
        if s["role"] == role and s["start_ns"] <= at < s["end_ns"]:
            if best is None or (s["start_ns"], -s["end_ns"]) > (best["start_ns"], -best["end_ns"]):
                best = s
    return best


def per_session_ms(r, names, *, method=None):
    """The mean time a window's session spends in spans named ``names``
    (on either process; of RPC verb ``method`` where given), in ms."""
    spans = spans_of(r)
    if spans is None:
        return None
    t0, t1 = r["window_ns"]
    ids = sessions(spans, t0, t1)
    if not ids:
        return None
    total = sum(end - start for s, start, end in clip(spans, t0, t1)
                if s["name"] in names and s["trace_id"] in ids
                and (method is None or s["args"].get("method") == method))
    return total / len(ids) / 1e6


def window_per_session_ms(r, name: str, role: str):
    """The window's total time in ``name`` spans of process ``role``, over
    the window's sessions, in ms: for spans that belong to no session."""
    spans = spans_of(r)
    if spans is None:
        return None
    t0, t1 = r["window_ns"]
    ids = sessions(spans, t0, t1)
    if not ids:
        return None
    total = sum(end - start for s, start, end in clip(spans, t0, t1)
                if s["name"] == name and s["role"] == role)
    return total / len(ids) / 1e6


def _union(intervals) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _covered(intervals, merged) -> int:
    """The time of the sorted, disjoint ``intervals`` that the sorted,
    merged ``merged`` cover: one pass over both."""
    total, k = 0, 0
    for start, end in intervals:
        while k < len(merged) and merged[k][1] <= start:
            k += 1
        j = k
        while j < len(merged) and merged[j][0] < end:
            total += min(end, merged[j][1]) - max(start, merged[j][0])
            j += 1
    return total


def idle_unspanned_pct(r):
    """The share of the window's device-idle time during which neither
    process has a span open other than the wrappers: idle time no host
    phase accounts for."""
    spans, trace = spans_of(r), r.get("trace")
    if spans is None or trace is None:
        return None
    t0, t1 = r["window_ns"]
    gaps = sorted(trace["gaps"])
    idle = sum(end - start for start, end in gaps)
    if idle <= 0:
        return None
    covered = _union((start, end) for s, start, end in clip(spans, t0, t1)
                     if s["name"] not in WRAPPERS)
    return 100.0 * (idle - _covered(gaps, covered)) / idle


def gap_spans(spans, role: str, start: int, end: int) -> dict:
    """``{span name: ns}``: over the gap [start, end), how long each span
    was the innermost one open on process ``role``; ``None`` keys the time
    with none open."""
    inside = [s for s in spans if s["role"] == role
              and s["start_ns"] < end and s["end_ns"] > start]
    cuts = sorted({start, end} | {t for s in inside for t in (s["start_ns"], s["end_ns"])
                                  if start < t < end})
    out: dict = {}
    for a, b in zip(cuts, cuts[1:]):
        top = innermost(inside, role, a)
        key = None if top is None else top["name"]
        out[key] = out.get(key, 0) + (b - a)
    return out


def describe_gaps(r, n: int = 10) -> list:
    """One line for each of the window's ``n`` longest device-idle gaps:
    its length and, on each process, the innermost spans over it with
    their time. A gap that holds an ``engine.sync`` span had the card
    busy: the profiler lost that work's records."""
    spans, trace = spans_of(r), r.get("trace")
    if spans is None or trace is None:
        return []
    lines = []
    for start, end in sorted(trace["gaps"], key=lambda g: g[0] - g[1])[:n]:
        parts = []
        lost = False
        for role in ("controller", "broker"):
            found = gap_spans(spans, role, start, end)
            lost = lost or SYNC in found
            named = sorted(found.items(), key=lambda kv: -kv[1])
            parts.append(f"{role}: " + ", ".join(
                f"{name or '(none)'} {ns / 1e6:.3f} ms" for name, ns in named))
        note = "; the card was busy (an engine.sync span): the profiler lost its records" \
            if lost else ""
        lines.append(f"idle gap {(end - start) / 1e6:.3f} ms; " + "; ".join(parts) + note)
    return lines


def final_cells_ms(r):
    return per_session_ms(r, {"controller.final_cells"})


def ticker_join_ms(r):
    return per_session_ms(r, {"controller.ticker_stop"})


def pgm_ms(r):
    return per_session_ms(r, {"io.pgm.read", "io.pgm.write"})


def gc_ms(r):
    return window_per_session_ms(r, "runtime.gc", "controller")


def codec_ms(r):
    return per_session_ms(r, {"rpc.encode", "rpc.decode"}, method="Operations.Run")


def sync_ms(r):
    return per_session_ms(r, {SYNC})


def board_io_ms(r):
    return per_session_ms(r, {"engine.encode", "engine.decode"})
