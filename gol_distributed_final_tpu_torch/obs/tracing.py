"""Cross-process span tracer + Chrome trace-event export.

The metrics registry (obs/metrics.py) answers "how much / how fast" in
aggregate; this module answers the *causal* questions aggregates cannot —
which turn, on which host, inside which RPC, was in flight when a run
wedged. Podracer-style TPU stacks (arXiv:2104.06272) debug exactly this
class of stall from per-actor timelines; here the timeline is a set of
SPANS with explicit start/end:

* **Cheap when off.** Like the registry, the process-global tracer starts
  disabled; every instrumented site is one attribute load and a branch —
  no clock reads, no id generation, no allocation — until an entry point
  opts in (the ``-trace`` CLI flags).
* **Cross-process.** Spans carry ``trace_id``/``span_id``/``parent_id``.
  The RPC client stamps its current context into ``Request.trace_ctx``
  and the server parents its dispatch span on it (both sides read the
  field via ``getattr``, so version skew degrades to "no trace", exactly
  like the other extension fields). One session's controller ticker,
  broker verbs, worker Update strips, and engine chunk dispatches all
  share one ``trace_id``.
* **Bounded.** Finished spans land in a ring (``deque(maxlen=...)``), so
  a million-turn run keeps the most recent window instead of growing
  without bound — the same posture as the flight recorder (obs/flight.py).
  ``enable(capacity=...)`` sizes it, and ``Tracer.dropped`` counts the
  spans it evicted, so a reader can tell a complete window from a cut one.
* **On the profiler's clock.** A span's ``start_ns``/``end_ns`` are
  ``time.time_ns()``: ns since the epoch, the clock of ``torch.profiler``'s
  device records, so host spans and device kernels share one timeline.
  ``ts_us``/``dur_us`` (the Chrome export's fields) derive from them.
* **Collections are spans.** While the tracer is on, a ``gc.callbacks``
  hook records each collection's pause as ``runtime.gc`` under the
  collecting thread's innermost span; with it off no hook is registered.
* **Perfetto-loadable.** ``write_chrome_trace`` renders any collection of
  span records (from any number of processes — the Status verb ships them
  across) as Chrome trace-event JSON: ``ph: "X"`` complete events with
  ``process_name`` metadata per process, one named track each.

Span *names* are a stable operator contract like metric names: declared
once here (``span_name(...)``), documented in the README "Tracing" table,
and linted by ``obs/lint.py``.

Device-side timelines: ``device_trace`` routes a ``torch.profiler`` trace
(utils/trace.py) into the same out dir and flips a flag that makes
``annotate(name)`` return a real ``torch.profiler.record_function`` — so the
host spans and the profiler's device tracks line up by name.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pathlib
import random
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

from . import flight as _flight

# -- span-name registry (the lint contract, like obs/instruments.py) ---------

_SPAN_NAMES: set = set()


def span_name(name: str) -> str:
    """Declare a span name. All names flow into the README lint
    (obs/lint.py): adding a site without documenting it fails the build."""
    _SPAN_NAMES.add(name)
    return name


def registered_span_names() -> List[str]:
    return sorted(_SPAN_NAMES)


SPAN_CONTROLLER_SESSION = span_name("controller.session")
SPAN_CONTROLLER_TICK = span_name("controller.tick")
SPAN_CONTROLLER_KEY = span_name("controller.key")
SPAN_RPC_CLIENT = span_name("rpc.client.call")
SPAN_RPC_SERVER = span_name("rpc.server.dispatch")
SPAN_ENGINE_CHUNK = span_name("engine.chunk")
SPAN_ENGINE_PARK = span_name("engine.park")
SPAN_ENGINE_CHECKPOINT = span_name("engine.checkpoint")
SPAN_BROKER_TURN = span_name("broker.turn")
SPAN_HALO_DISPATCH = span_name("halo.dispatch")
SPAN_IO_PGM_READ = span_name("io.pgm.read")
SPAN_IO_PGM_WRITE = span_name("io.pgm.write")
SPAN_CONTROLLER_FINAL_CELLS = span_name("controller.final_cells")
SPAN_CONTROLLER_TICKER_STOP = span_name("controller.ticker_stop")
SPAN_RPC_ENCODE = span_name("rpc.encode")
SPAN_RPC_DECODE = span_name("rpc.decode")
SPAN_ENGINE_ENCODE = span_name("engine.encode")
SPAN_ENGINE_SYNC = span_name("engine.sync")
SPAN_ENGINE_DECODE = span_name("engine.decode")
SPAN_RUNTIME_GC = span_name("runtime.gc")

#: the ring's size unless ``enable(capacity=...)`` says otherwise
DEFAULT_CAPACITY = 4096

#: the span clock: ns since the epoch, as ``torch.profiler``'s records
now_ns = time.time_ns


class _Process:
    """What a span record needs of its process, read without a system call
    a span: the pid, and a generator of ids seeded once from
    ``os.urandom``; both are taken again in a forked child."""

    def __init__(self):
        self.refresh()

    def refresh(self) -> None:
        self.pid = os.getpid()
        self.ids = random.Random(os.urandom(16))


_PROCESS = _Process()
os.register_at_fork(after_in_child=_PROCESS.refresh)


def _new_id() -> str:
    """A 64-bit random id as 16 hex chars, unique enough for per-run
    traces across processes (each seeds its own generator)."""
    return f"{_PROCESS.ids.getrandbits(64):016x}"


class Span:
    """One in-flight span. Created only when the tracer records (enabled
    and sampled) — the disabled path returns None before any allocation."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "sampled",
        "start_ns", "tid", "args",
    )

    def __init__(self, name, trace_id, span_id, parent_id, sampled, args):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.start_ns = now_ns()
        self.tid = threading.get_ident()
        self.args = args

    def ctx(self) -> dict:
        """The wire form carried in Request/Response.trace_ctx: plain dict
        of strings/bool, so it crosses the restricted unpickler."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
        }


class Tracer:
    """Explicit start/end span tracer with a per-thread context stack.

    ``start_span`` parents on (in order) an explicit ``parent_ctx`` (an
    RPC peer's wire context, or a captured local one for work handed to a
    pool thread), else the calling thread's innermost open span, else
    starts a new trace (root) — applying ``sample_rate`` once per trace,
    at the root; the decision propagates in the context.

    ``dropped`` counts the finished spans the ring evicted since the last
    ``reset``.
    """

    def __init__(self, enabled: bool = False, capacity: int = DEFAULT_CAPACITY):
        self.enabled = enabled
        self.sample_rate = 1.0
        self.process_name = ""  # role label for the Chrome process track
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._tls = threading.local()
        # collections finished since the last commit: the gc hook appends
        # (list.append is atomic) and never takes the lock, which the
        # collecting thread may already hold; the ring's users drain it
        self._gc_done: list = []
        self._gc_t0 = 0
        self._gc_hook = None

    # -- recording --------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _lineage(self, parent_ctx: Optional[dict], stack: Optional[list]):
        """``(trace_id, parent_id, sampled)`` of a new span: an explicit
        ``parent_ctx``, else the innermost span of ``stack``, else a new
        trace root (the one place sampling is decided)."""
        if parent_ctx is None and stack:
            parent = stack[-1]
            return parent.trace_id, parent.span_id, parent.sampled
        if parent_ctx:
            return (
                str(parent_ctx.get("trace_id") or _new_id()),
                str(parent_ctx.get("span_id") or ""),
                bool(parent_ctx.get("sampled", True)),
            )
        sampled = (
            self.sample_rate >= 1.0
            or int.from_bytes(os.urandom(2), "big") / 65536.0 < self.sample_rate
        )
        return _new_id(), "", sampled

    def start_span(
        self, name: str, parent_ctx: Optional[dict] = None, **args
    ) -> Optional[Span]:
        """Open a span; returns None (one flag check, nothing else) when
        the tracer is off. The span is pushed as the thread's current
        context until ``end_span``."""
        if not self.enabled:
            return None
        stack = self._stack()
        trace_id, parent_id, sampled = self._lineage(parent_ctx, stack)
        span = Span(name, trace_id, _new_id(), parent_id, sampled, args)
        stack.append(span)
        if sampled:
            _flight.record("span.open", name, trace_id=trace_id,
                           span_id=span.span_id)
        return span

    def end_span(self, span: Optional[Span], **more_args) -> None:
        """Close ``span`` (None-safe: the disabled path's start returned
        None) and commit it to the ring if its trace is sampled."""
        if span is None:
            return
        end_ns = now_ns()
        stack = getattr(self._tls, "stack", None)
        if stack and span in stack:
            # remove through the top so a missed inner end can't leave the
            # stack permanently wedged on this thread
            while stack and stack.pop() is not span:
                pass
        if not span.sampled:
            return
        if more_args:
            span.args.update(more_args)
        record = self._record(
            span.name, span.trace_id, span.span_id, span.parent_id, span.tid,
            span.start_ns, end_ns, span.args,
        )
        with self._lock:
            self._commit(record)
        _flight.record("span.close", span.name, trace_id=span.trace_id,
                       span_id=span.span_id, dur_us=(end_ns - span.start_ns) // 1000)

    def add_span(
        self, name: str, start_ns: int, end_ns: int,
        parent_ctx: Optional[dict] = None, **args,
    ) -> None:
        """Commit a span that has already ended, timed by the caller on
        ``now_ns``: for work whose parent is known only once it is done
        (a frame decoded before its call's context can be read). Parents
        on ``parent_ctx``, else starts a trace; never on the thread's
        stack. A no-op when the tracer is off."""
        if not self.enabled:
            return
        trace_id, parent_id, sampled = self._lineage(parent_ctx, None)
        if not sampled:
            return
        record = self._record(
            name, trace_id, _new_id(), parent_id, threading.get_ident(),
            start_ns, end_ns, args,
        )
        with self._lock:
            self._commit(record)

    def _record(self, name, trace_id, span_id, parent_id, tid, start_ns, end_ns,
                args) -> tuple:
        """A finished span as the ring holds it: a flat tuple of strings and
        numbers, its arguments' keys and values in turn, which the garbage
        collector stops tracking, so a full ring does not lengthen every
        full collection of the process it measures. ``snapshot`` makes the
        record dicts."""
        return (name, trace_id, span_id, parent_id, _PROCESS.pid, tid, self.process_name,
                start_ns, end_ns, *(x for item in args.items() for x in item))

    def _commit(self, record: tuple) -> None:
        """Append one record, and every collection finished since the
        last commit, to the ring, counting what it evicts. The caller
        holds ``_lock``."""
        self._drain_gc()
        self._append(record)

    def _append(self, record: tuple) -> None:
        if len(self._spans) == self._spans.maxlen:
            self.dropped += 1
        self._spans.append(record)

    @contextlib.contextmanager
    def span(self, name: str, parent_ctx: Optional[dict] = None, **args):
        s = self.start_span(name, parent_ctx=parent_ctx, **args)
        try:
            yield s
        finally:
            self.end_span(s)

    # -- collections ------------------------------------------------------

    def hook_gc(self, on: bool) -> None:
        """Register (``on``) or remove this tracer's ``gc.callbacks`` hook."""
        if on and self._gc_hook is None:
            self._gc_hook = self._gc_callback
            gc.callbacks.append(self._gc_hook)
        elif not on and self._gc_hook is not None:
            try:
                gc.callbacks.remove(self._gc_hook)
            except ValueError:  # pragma: no cover - an external clear
                pass
            self._gc_hook = None
            self._gc_t0 = 0

    def _gc_callback(self, phase: str, info: dict) -> None:
        """A collection's start and stop. Runs inside the collection, on
        whichever thread allocated: it takes no lock and touches neither
        the ring nor the flight recorder, only a clock, the thread's stack
        and an atomic list append."""
        if phase == "start":
            self._gc_t0 = now_ns()
            return
        start, self._gc_t0 = self._gc_t0, 0
        if not start:
            return
        stack = getattr(self._tls, "stack", None)
        self._gc_done.append((
            start, now_ns(), stack[-1] if stack else None, threading.get_ident(),
            info.get("generation"), info.get("collected"),
        ))

    def _drain_gc(self) -> None:
        """Commit the finished collections, each under the span that was
        innermost on its thread. The caller holds ``_lock``; a collection
        set off in here only appends to the list this loop drains."""
        done = self._gc_done
        while done:
            start, end, parent, tid, generation, collected = done.pop(0)
            if parent is None:
                trace_id, parent_id = _new_id(), ""
            elif parent.sampled:
                trace_id, parent_id = parent.trace_id, parent.span_id
            else:
                continue
            self._append(self._record(
                SPAN_RUNTIME_GC, trace_id, _new_id(), parent_id, tid, start, end,
                {"generation": generation, "collected": collected},
            ))

    # -- context ----------------------------------------------------------

    def current_ctx(self) -> Optional[dict]:
        """The calling thread's innermost open span as a wire context
        (what the RPC client stamps into Request.trace_ctx); None when no
        span is open or the tracer is off."""
        if not self.enabled:
            return None
        stack = getattr(self._tls, "stack", None)
        return stack[-1].ctx() if stack else None

    # -- inspection -------------------------------------------------------

    def set_capacity(self, capacity: int) -> None:
        """A new, empty ring of ``capacity`` spans."""
        if capacity < 1:
            raise ValueError(f"span ring capacity must be >= 1, got {capacity}")
        with self._lock:
            self._spans = deque(maxlen=capacity)
            self._gc_done.clear()
            self.dropped = 0

    def snapshot(self, clear: bool = False) -> List[dict]:
        """Finished span records, oldest first (the Status payload form)."""
        with self._lock:
            self._drain_gc()
            held = list(self._spans)
            if clear:
                self._spans.clear()
        return [_as_dict(r) for r in held]

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._gc_done.clear()
            self.dropped = 0


def _as_dict(r: tuple) -> dict:
    """A ring entry (``Tracer._record``) as the record dict every reader
    takes: ``ts_us``/``dur_us`` derive from ``start_ns``/``end_ns``."""
    name, trace_id, span_id, parent_id, pid, tid, role, start_ns, end_ns = r[:9]
    return {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "pid": pid,
        "tid": tid,
        "role": role,
        "start_ns": start_ns,
        "end_ns": end_ns,
        "ts_us": start_ns // 1000,
        "dur_us": (end_ns - start_ns) // 1000,
        "args": dict(zip(r[9::2], r[10::2])),
    }


# -- the process-global default tracer ---------------------------------------

_DEFAULT = Tracer(enabled=False)


def tracer() -> Tracer:
    return _DEFAULT


def enable(on: bool = True, sample_rate: float = 1.0,
           capacity: Optional[int] = None) -> None:
    """Turn span recording on or off; ``capacity`` gives the ring a new,
    empty size. The ``runtime.gc`` hook is registered exactly while the
    tracer is on."""
    if capacity is not None:
        _DEFAULT.set_capacity(capacity)
    _DEFAULT.sample_rate = sample_rate
    _DEFAULT.enabled = on
    _DEFAULT.hook_gc(on)


def enabled() -> bool:
    return _DEFAULT.enabled


def set_process_name(role: str) -> None:
    """Label this process's Chrome track (controller / broker / worker)."""
    _DEFAULT.process_name = role


def start_span(name: str, parent_ctx: Optional[dict] = None, **args):
    return _DEFAULT.start_span(name, parent_ctx=parent_ctx, **args)


def end_span(span, **more_args) -> None:
    _DEFAULT.end_span(span, **more_args)


def add_span(name: str, start_ns: int, end_ns: int,
             parent_ctx: Optional[dict] = None, **args) -> None:
    _DEFAULT.add_span(name, start_ns, end_ns, parent_ctx=parent_ctx, **args)


def span(name: str, parent_ctx: Optional[dict] = None, **args):
    return _DEFAULT.span(name, parent_ctx=parent_ctx, **args)


def current_ctx() -> Optional[dict]:
    return _DEFAULT.current_ctx()


# -- Chrome trace-event export -----------------------------------------------


def to_chrome_trace(spans: Iterable[dict], counters: Iterable[dict] = ()) -> dict:
    """Render span records (from any number of processes) as a Chrome
    trace-event JSON object Perfetto accepts: one ``ph: "X"`` complete
    event per span (``ts``/``dur`` in microseconds, both from the span's
    ``time.time_ns()`` ends, so processes and the device trace align),
    plus ``process_name`` metadata so every process is a named track.

    Tracks are keyed by (role, pid), not pid alone: two processes on
    DIFFERENT hosts can share an os.getpid(), and a cross-host span set
    (collect_remote_spans) must not interleave them on one track. Each
    distinct process gets a synthetic track id; the real pid rides in the
    span args.

    ``counters`` are metric-timeline samples (obs/timeline.py
    ``chrome_counter_samples``: ``{"name", "ts_us", "value"}`` dicts),
    rendered as ``ph: "C"`` counter events on one dedicated "metrics
    timeline" track — so Perfetto shows throughput/HBM/queue depth on
    the SAME timeline as the spans."""
    spans = list(spans)
    track_ids: Dict[tuple, int] = {}
    roles: Dict[tuple, str] = {}
    for s in spans:
        pid = int(s["pid"])
        role = s.get("role") or ""
        key = (role, pid)
        if key not in track_ids:
            track_ids[key] = len(track_ids) + 1
        # first writer wins; a later span with a proper role upgrades a
        # fallback label (a process that set its name after early spans)
        if roles.get(key, "") == "":
            roles[key] = role or f"pid {pid}"
    events: List[dict] = []
    for s in spans:
        pid = int(s["pid"])
        args = dict(s.get("args") or {})
        method = args.get("method")
        args.update(
            trace_id=s["trace_id"], span_id=s["span_id"],
            parent_id=s.get("parent_id", ""), os_pid=pid,
        )
        events.append({
            "name": f"{s['name']} {method}" if method else s["name"],
            "cat": s["name"],
            "ph": "X",
            "ts": int(s["ts_us"]),
            "dur": max(1, int(s["dur_us"])),
            "pid": track_ids[(s.get("role") or "", pid)],
            "tid": int(s["tid"]),
            "args": args,
        })
    for key, track in sorted(track_ids.items(), key=lambda kv: kv[1]):
        events.append({
            "name": "process_name", "ph": "M", "ts": 0, "pid": track,
            "tid": 0, "args": {"name": roles[key]},
        })
    counters = list(counters or ())
    if counters:
        counter_track = len(track_ids) + 1
        for c in counters:
            events.append({
                "name": str(c["name"]), "ph": "C",
                "ts": int(c["ts_us"]), "pid": counter_track, "tid": 0,
                "args": {"value": float(c["value"])},
            })
        events.append({
            "name": "process_name", "ph": "M", "ts": 0,
            "pid": counter_track, "tid": 0,
            "args": {"name": "metrics timeline"},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_path(params, out_dir="out") -> pathlib.Path:
    # rides the <W>x<H>x<Turns> naming convention like report_path
    return pathlib.Path(out_dir) / f"trace_{params.output_filename}.json"


def write_chrome_trace(
    path, spans: Iterable[dict], counters: Iterable[dict] = ()
) -> pathlib.Path:
    """Dump spans (plus optional timeline counter samples — see
    ``to_chrome_trace``) as Chrome trace JSON, via temp-name + atomic
    rename like the checkpoint and report writers."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(to_chrome_trace(spans, counters)))
    tmp.replace(path)
    return path


# -- device-trace fold-in (utils/trace.py's torch.profiler surface) ----------

_DEVICE_TRACE_ACTIVE = False


def device_trace_active() -> bool:
    return _DEVICE_TRACE_ACTIVE


@contextlib.contextmanager
def device_trace(log_dir):
    """A ``torch.profiler`` trace (utils/trace.trace, CPU and CUDA
    activities) routed into ``log_dir`` with host-span alignment: while
    active, ``annotate(name)`` pushes real ``record_function`` ranges so
    the profiler's timeline carries the same names as the host spans (the
    ``-trace-device`` flag)."""
    global _DEVICE_TRACE_ACTIVE
    from ..utils.trace import trace as _profiler_trace

    with _profiler_trace(str(log_dir)) as p:
        _DEVICE_TRACE_ACTIVE = True
        try:
            yield p
        finally:
            _DEVICE_TRACE_ACTIVE = False


# genuinely SHARED (nullcontext is stateless and reentrant): the inactive
# path of annotate() must not allocate per call — it sits inside per-chunk
# (and, under emit_flips, per-turn) dispatch loops
_NULL_CTX = contextlib.nullcontext()


def annotate(name: str):
    """A ``torch.profiler.record_function(name)`` while a device trace is
    active, else a shared no-op context — one flag check, no allocation,
    on the hot path."""
    if not _DEVICE_TRACE_ACTIVE:
        return _NULL_CTX
    import torch

    return torch.profiler.record_function(name)
