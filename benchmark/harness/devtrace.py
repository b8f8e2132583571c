"""The reduction of the broker's profiler records to device time.

Records come from ``broker_child.py``: ``device`` holds ``[name, start,
end]`` of every kernel, copy and set on the card, ``launch_calls`` the
start of every host call that launched a kernel, all in ns since the
epoch, the clock of the benchmark's own spans. Only what lies inside the
traced window counts, cut at its edges.
"""

from __future__ import annotations

import re


def clip(intervals, t0: int, t1: int):
    """``(name, start, end)`` cut to the window, the empty ones left out."""
    out = []
    for name, start, end in intervals:
        start, end = max(start, t0), min(end, t1)
        if end > start:
            out.append((name, start, end))
    return sorted(out, key=lambda x: x[1])


def union(intervals) -> list[tuple[int, int]]:
    """The busy spans: overlapping or touching intervals merged."""
    spans = []
    for _, start, end in sorted(intervals, key=lambda x: x[1]):
        if spans and start <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], end)
        else:
            spans.append([start, end])
    return [tuple(s) for s in spans]


def gaps(spans, t0: int, t1: int) -> list[tuple[int, int]]:
    """The idle spans of the window between the busy ones."""
    out, at = [], t0
    for start, end in spans:
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if t1 > at:
        out.append((at, t1))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def reduce(records: dict, t0: int, t1: int) -> dict:
    """Busy and window seconds, device seconds by operation, the idle gaps,
    and the kernel launches of the window."""
    device = clip(records["device"], t0, t1)
    spans = union(device)
    by_op: dict = {}
    for name, start, end in device:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0) + (end - start)
    calls = [t for t in records["launch_calls"] if t0 <= t < t1]
    kernels = sum(1 for name, _, _ in device if is_kernel(name))
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": sum(end - start for start, end in spans) / 1e9,
        "device_s": sum(end - start for _, start, end in device) / 1e9,
        "by_op_s": {k: v / 1e9 for k, v in by_op.items()},
        "gaps": gaps(spans, t0, t1),
        # the host's launch calls where the trace holds them (a trace can
        # lose device records, not the calls), else the kernel records
        "launches": len(calls) if calls else kernels,
        "kernel_records": kernels,
    }


def name_gap(gap, sessions) -> str:
    """What the benchmark's host side was doing during an idle gap, by the
    sessions in flight at its middle."""
    mid = (gap[0] + gap[1]) // 2
    live = [s for s in sessions if s.start_ns <= mid < (s.end_ns or mid + 1)]
    if not live:
        return "no session in flight"
    if len(live) > 1:
        return f"{len(live)} sessions in flight"
    s = live[0]
    if gap[0] < s.start_ns:
        return "a session's start (controller, PGM read, RPC) to its first device op"
    if s.end_ns and gap[1] > s.end_ns:
        return "a session's last device op to its end (reply, PGM write)"
    return "between device ops of one session"
