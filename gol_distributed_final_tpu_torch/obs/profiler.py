"""Continuous sampling profiler: names per wall, dependency-free.

The PR 12 decomposition (obs/perf.py) prices WHERE a turn's wall went —
``host_prep`` vs ``device_compute`` vs ``wire`` vs ``demux`` — but not
WHICH CODE. The ROADMAP's next tier (pod-scale sharding, a 10k-session
front door) lives or dies on host-side orchestration overhead, exactly
the controller-off-the-hot-path concern Podracer (arXiv:2104.06272)
architects around: this module turns "58% of the turn is host_prep"
into "71% of host samples are in ``pickle.dumps`` via rpc/protocol.py".

* **A daemon sampler over ``sys._current_frames()``.** ``enable(ms)``
  (the ``-profile [MS]`` CLI flags, default cadence 10 ms) walks every
  thread's stack each tick and folds it twice: into a bounded per-thread
  call-tree TRIE (self/cumulative hits per node — the artifact form) and
  into a bounded FLAT frame table (the Status/doctor/diff form). Both
  are capped — past ``max_nodes``/``max_frames`` new frames fold into a
  single ``<other>`` bucket, so a pathological stack set cannot grow
  memory without bound.
* **Adaptive cadence.** Each tick meters its own cost into an EWMA;
  when sampling itself exceeds ``budget`` (default 1%) of the period,
  the period doubles (up to ``max_period_ms``) and
  ``gol_profile_backoffs_total`` ticks — the profiler is the one obs
  layer that must never become the hotspot it exists to find. When the
  cost falls back, the period decays toward the configured base.
* **GC pauses.** ``gc.callbacks`` metering (on by default with the
  profiler; the callback is REMOVED on disable — analysis/hygiene.py
  checks the pairing) feeds ``gol_gc_pause_seconds`` +
  ``gol_gc_collections_total{gen}`` and the ``gc-pause`` SLO rule: a
  stop-the-world pause is wall time no segment decomposition can name.
* **Allocation snapshots.** Opt-in tracemalloc top-N (``alloc_top_n``)
  rides the same window/summary payloads.
* **Three shipping lanes.** Incremental Status windows
  (``window(since=seq)`` — only frames whose counts moved since the
  poller's echoed seq, the ``timeline_since``/``journal_since`` twin,
  via ``Request.profile_since``); on-disk artifacts in collapsed-stack
  and speedscope-JSON form at run end and on crash
  (``flush_on_crash`` — the obs/journal.py posture: never raises); and
  the obs/flame.py CLI, which renders/merges/diffs either lane.

Like every obs layer: pure stdlib, OFF by default, one global load per
call site until an entry point opts in.
"""

from __future__ import annotations

import gc
import json
import logging
import pathlib
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils import locksan as _locksan

logger = logging.getLogger(__name__)

SCHEMA = "gol-profile/1"

#: default sampling cadence (milliseconds) — the ``-profile`` flags'
#: implied value. 10 ms ~ 100 stacks/s/thread: enough to name a frame
#: holding >=5% of the wall within a couple of Status polls.
DEFAULT_PERIOD_MS = 10.0
#: adaptive-backoff ceiling: a GIL-saturated 100-thread process degrades
#: to 10 stacks/s rather than stealing the wall it is measuring
MAX_PERIOD_MS = 200.0
#: fraction of wall clock sampling may consume before backing off
DEFAULT_BUDGET = 0.01
#: call-tree trie node cap (all threads pooled) before the <other> fold
DEFAULT_MAX_NODES = 4096
#: flat frame-table cap before the <other> fold
DEFAULT_MAX_FRAMES = 2048
#: stack depth cap — deeper stacks keep the LEAF side (the hot end)
MAX_DEPTH = 64
#: frames shipped per Status window / rendered per artifact summary
WINDOW_TOP = 80
#: hot leaf-paths shipped in every window (the doctor's caller context)
HOT_STACKS_TOP = 5

#: the fold bucket: where frames land once a bound is hit
OTHER_FRAME = ("<other>", "", 0)

#: leaf frames that mean "parked, not working": a wall-clock sampler
#: sees idle server threads blocked in accept/select/wait forever, and
#: a hotspot report that names ``Event.wait`` as the top frame would be
#: noise. Shared with obs/doctor.py and obs/flame.py (-active).
_IDLE_FUNCS = frozenset((
    "wait", "select", "poll", "accept", "recv", "recv_into", "readinto",
    "read", "readline", "get", "sleep", "_wait_for_tstate_lock", "join",
    "flush", "epoll",
    # the rpc/protocol.py frame pump: these loops spend their wall parked
    # in sock.recv/sendall (C frames the sampler cannot see past), so the
    # Python leaf is the loop itself — a resident-wire worker would
    # otherwise report its own idle connection as the process hotspot.
    # Serialize/deserialize cost is priced by the perf decomposition
    # (host_prep/wire segments), not by wall-clock stack sampling.
    "recv_frame_sized", "recv_frame", "send_frame",
    "_recv_exact", "_recv_into_exact",
))
_IDLE_FILES = (
    "threading.py", "selectors.py", "socket.py", "socketserver.py",
    "queue.py", "ssl.py", "connection.py", "subprocess.py",
    # the obs samplers' own loops: self-profiles would otherwise list
    # the measurement as the workload
    "timeline.py", "profiler.py",
)


def is_idle_frame(func: str, file: str) -> bool:
    """True when a LEAF frame means the thread was parked (blocking
    accept/select/wait) or inside an obs sampler loop — the frames the
    hotspot heuristics and ``flame -active`` exclude from shares."""
    return func in _IDLE_FUNCS or str(file).endswith(_IDLE_FILES)


def short_file(path: str) -> str:
    """Render a code path relative to the package (or the last two
    components for foreign code) — stable across checkouts, so collapsed
    goldens and cross-host diffs line up."""
    s = str(path).replace("\\", "/")
    marker = "gol_distributed_final_tpu_torch/"
    i = s.find(marker)
    if i >= 0:
        return s[i:]
    parts = s.rsplit("/", 2)
    return "/".join(parts[-2:]) if len(parts) > 1 else s


def frame_name(func: str, file: str, line: int) -> str:
    """One frame's collapsed-stack token: ``func (file:line)``. Parsed
    back by obs/flame.py with rsplit on the final space-count split, so
    the embedded space is safe within this toolchain."""
    if not file and not line:
        return func
    return f"{func} ({short_file(file)}:{line})"


class _Node:
    """One call-tree trie node: children keyed by (func, file, line)."""

    __slots__ = ("self_hits", "cum_hits", "children")

    def __init__(self):
        self.self_hits = 0
        self.cum_hits = 0
        self.children: Dict[Tuple[str, str, int], "_Node"] = {}


class ContinuousProfiler:
    """The per-process profile: a bounded trie + flat frame table over
    ``sys._current_frames()``, advanced by ``sample_once`` (the daemon
    thread, or a test injecting stacks). All public queries take the
    internal lock; one tick is O(threads x depth)."""

    # the trie/table mutate under _lock during ticks while Status polls
    # and artifact writers iterate them — the timeline's posture,
    # machine-enforced (analysis/locks.py)
    _GUARDED_BY = {
        "_roots": "_lock",
        "_frames": "_lock",
        "_seq": "_lock",
        "_nodes": "_lock",
        "_stacks": "_lock",
        # NOTE: the _gc_* tallies are deliberately NOT lock-guarded.
        # They are mutated only inside the gc callback, which can
        # preempt ANY thread at ANY allocation — including one already
        # holding this lock or the metrics registry lock — so the
        # callback must never acquire a lock (observed: a worker's
        # Status thread self-deadlocking when gc fired inside
        # metrics.snapshot()). The collecting thread holds the GIL for
        # the whole callback, which is all the synchronisation plain
        # counter bumps need.
    }

    def __init__(
        self,
        period_ms: float = DEFAULT_PERIOD_MS,
        *,
        budget: float = DEFAULT_BUDGET,
        max_period_ms: float = MAX_PERIOD_MS,
        max_nodes: int = DEFAULT_MAX_NODES,
        max_frames: int = DEFAULT_MAX_FRAMES,
        track_gc: bool = True,
        alloc_top_n: int = 0,
    ):
        if period_ms <= 0:
            raise ValueError(f"period_ms must be > 0, got {period_ms}")
        if max_nodes < 8 or max_frames < 8:
            raise ValueError("max_nodes/max_frames must be >= 8")
        self.base_period_s = period_ms / 1000.0
        self.period_s = self.base_period_s
        self.max_period_s = max(max_period_ms, period_ms) / 1000.0
        self.budget = float(budget)
        self.max_nodes = int(max_nodes)
        self.max_frames = int(max_frames)
        self.alloc_top_n = int(alloc_top_n)
        # RLock: readers (window/artifacts) hold it across whole walks
        # of structures a concurrent tick mutates
        self._lock = _locksan.rlock("ContinuousProfiler._lock")
        # serialises ticks: the thread and a test's sample_once must
        # produce one fold each, never interleaved
        self._tick_lock = _locksan.lock("ContinuousProfiler._tick_lock")
        self._roots: Dict[str, _Node] = {}  # thread name -> trie root
        # (func, file, line) -> [self_hits, cum_hits, last_seq]
        self._frames: Dict[Tuple[str, str, int], List[int]] = {}
        self._seq = 0
        self._nodes = 0
        self._stacks = 0  # stack samples folded (threads x ticks)
        self._cost_ewma_s = 0.0
        self._backoffs = 0
        self._started_unix = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # gc-pause metering (callback installed by enable())
        self._gc_t0: Optional[float] = None
        self._gc_installed = False
        self._gc_pauses = 0
        self._gc_pause_s = 0.0
        self._gc_max_s = 0.0
        # (pause_s, generation) rows the callback defers; the sampler
        # (or a window build) flushes them into the metrics registry
        # from a thread that is NOT inside a collection
        self._gc_pending: List[Tuple[float, str]] = []
        self._tracemalloc_started = False

    # -- sampling ----------------------------------------------------------

    def _extract_stacks(self) -> List[Tuple[str, List[Tuple[str, str, int]]]]:
        """(thread_name, root-first frame list) per thread, skipping the
        sampler's own thread — a profiler that profiles itself walking
        stacks reports its own overhead as the workload."""
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        out = []
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack: List[Tuple[str, str, int]] = []
            f = frame
            while f is not None and len(stack) < MAX_DEPTH:
                code = f.f_code
                stack.append(
                    (code.co_name, code.co_filename, code.co_firstlineno)
                )
                f = f.f_back
            stack.reverse()  # leaf-up walk -> root-first fold
            out.append((names.get(ident, f"tid-{ident}"), stack))
        return out

    def _fold(  # gol: holds(_lock)
        self, thread: str, stack: List[Tuple[str, str, int]], seq: int
    ) -> None:
        """Fold one root-first stack into the trie and the flat table.
        Caller holds ``self._lock`` (the holds() marker declares the
        contract to analysis/locks.py)."""
        node = self._roots.get(thread)
        if node is None:
            node = self._roots[thread] = _Node()
            self._nodes += 1
        for key in stack:
            child = node.children.get(key)
            if child is None:
                if self._nodes >= self.max_nodes:
                    key = OTHER_FRAME
                    child = node.children.get(key)
                if child is None:
                    child = node.children[key] = _Node()
                    self._nodes += 1
            child.cum_hits += 1
            node = child
        node.self_hits += 1
        leaf = stack[-1] if stack else OTHER_FRAME
        for key in dict.fromkeys(stack):  # unique: recursion counts once
            row = self._frames.get(key)
            if row is None:
                if len(self._frames) >= self.max_frames:
                    key = OTHER_FRAME
                    row = self._frames.get(key)
                if row is None:
                    row = self._frames[key] = [0, 0, 0]
            row[1] += 1
            row[2] = seq
        # the leaf's self hit: a leaf that overflowed the table above
        # lands in <other> like its cum hit did
        lrow = self._frames.get(leaf)
        if lrow is None:
            lrow = self._frames.setdefault(OTHER_FRAME, [0, 0, 0])
        lrow[0] += 1
        lrow[2] = seq
        self._stacks += 1

    def sample_once(self, cost: Optional[float] = None,
                    stacks=None) -> int:
        """One tick: walk every thread's stack, fold, meter own cost,
        adapt the cadence. Both knobs are injectable for deterministic
        tests: ``stacks`` as ``[(thread_name, [(func, file, line),
        ...root-first])]``, ``cost`` as the tick's claimed sampling cost
        in seconds (drives ``_adapt``). Returns the tick's seq."""
        with self._tick_lock:
            t0 = time.perf_counter()
            extracted = self._extract_stacks() if stacks is None else stacks
            with self._lock:
                self._seq += 1
                seq = self._seq
                for thread, stack in extracted:
                    if stack:
                        self._fold(thread, list(stack), seq)
            if cost is None:
                cost = time.perf_counter() - t0
            self._cost_ewma_s = 0.8 * self._cost_ewma_s + 0.2 * cost
            self._adapt()
            from . import instruments

            instruments.PROFILE_SAMPLES_TOTAL.inc()
            self._flush_gc_metrics()
            return seq

    def _adapt(self) -> None:
        """Back the cadence off when sampling exceeds its budget share
        of the period; decay back toward the base once it is cheap
        again. Tick-lock serialised (only sample_once calls this)."""
        if self._cost_ewma_s > self.budget * self.period_s:
            new = min(self.period_s * 2.0, self.max_period_s)
            if new > self.period_s:
                self.period_s = new
                self._backoffs += 1
                from . import instruments

                instruments.PROFILE_BACKOFFS_TOTAL.inc()
        elif (
            self.period_s > self.base_period_s
            and self._cost_ewma_s < 0.25 * self.budget * self.period_s
        ):
            self.period_s = max(self.base_period_s, self.period_s / 2.0)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="gol-profiler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.sample_once()
            # gol: allow(hygiene): the 100 Hz sampler loop must survive
            # interpreter-shutdown races in _current_frames; recording
            # each period would churn the flight ring
            except Exception:  # pragma: no cover - shutdown races
                pass

    # -- gc-pause metering -------------------------------------------------

    def _gc_callback(self, phase: str, info: dict) -> None:
        """gc.callbacks hook: pause = start->stop wall.

        MUST NOT acquire any lock or touch the metrics registry: a
        collection can trigger at any allocation, so this hook can
        preempt a thread that already holds ``self._lock`` or the
        registry lock — taking either here self-deadlocks that thread
        and wedges the whole process (every later metric op parks on
        the dead lock). Plain attribute ops suffice: the collecting
        thread holds the GIL for the entire callback. The histogram
        observations are deferred to ``_flush_gc_metrics``."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
            return
        t0, self._gc_t0 = self._gc_t0, None
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        self._gc_pauses += 1
        self._gc_pause_s += dt
        if dt > self._gc_max_s:
            self._gc_max_s = dt
        self._gc_pending.append((dt, str(info.get("generation", "?"))))

    def _flush_gc_metrics(self) -> None:
        """Drain callback-deferred gc pauses into the registry. Runs on
        the sampler thread (every tick) and on window builds — never
        inside a collection, so taking the registry lock is safe here.
        Atomic ``list.pop(0)`` keeps this drain lock-free against the
        callback's concurrent ``append``."""
        if not self._gc_pending:
            return
        from . import instruments

        while True:
            try:
                dt, gen = self._gc_pending.pop(0)
            except IndexError:
                break
            instruments.GC_PAUSE_SECONDS.observe(dt)
            instruments.GC_COLLECTIONS_TOTAL.labels(gen).inc()

    def install_gc(self) -> None:
        if not self._gc_installed:
            gc.callbacks.append(self._gc_callback)
            self._gc_installed = True

    def remove_gc(self) -> None:
        if self._gc_installed:
            self._gc_installed = False
            try:
                gc.callbacks.remove(self._gc_callback)
            except ValueError:  # pragma: no cover - external clear
                pass

    # -- allocation snapshots ----------------------------------------------

    def start_alloc(self) -> None:
        """Opt-in tracemalloc: started here only if not already tracing
        (an outer harness may own it), remembered so close() stops only
        what it started."""
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start()
            self._tracemalloc_started = True

    def alloc_top(self) -> List[dict]:
        """Top-N allocation sites by live bytes (empty when alloc
        tracking is off) — JSON-able rows for windows/summaries."""
        if self.alloc_top_n <= 0:
            return []
        import tracemalloc

        if not tracemalloc.is_tracing():
            return []
        stats = tracemalloc.take_snapshot().statistics("lineno")
        return [
            {
                "site": f"{short_file(s.traceback[0].filename)}:"
                        f"{s.traceback[0].lineno}",
                "kib": round(s.size / 1024.0, 1),
                "count": s.count,
            }
            for s in stats[: self.alloc_top_n]
        ]

    def close(self) -> None:
        """Stop the thread, unhook gc, stop tracemalloc if owned."""
        self.stop()
        self.remove_gc()
        if self._tracemalloc_started:
            import tracemalloc

            self._tracemalloc_started = False
            tracemalloc.stop()

    # -- queries -----------------------------------------------------------

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def hot_frames(self, top: int = WINDOW_TOP,
                   since: int = 0) -> List[dict]:
        """The flat frame table, hottest self first. ``since`` keeps it
        incremental: only frames whose counts moved past that seq."""
        with self._lock:
            rows = [
                {
                    "func": k[0], "file": short_file(k[1]), "line": k[2],
                    "self": v[0], "cum": v[1],
                }
                for k, v in self._frames.items()
                if v[2] > since
            ]
        rows.sort(key=lambda r: (-r["self"], -r["cum"], r["func"]))
        return rows[:top]

    def hot_stacks(self, top: int = HOT_STACKS_TOP) -> List[dict]:
        """Hottest LEAF PATHS (collapsed frame strings + self hits),
        merged across threads — the caller context a flat table loses,
        and what the doctor names when a leaf alone is ambiguous."""
        acc: Dict[str, int] = {}
        with self._lock:
            for root in self._roots.values():
                self._walk_leaves(root, [], acc)
        rows = [
            {"stack": k, "self": v}
            for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        ]
        return rows

    def _walk_leaves(  # gol: holds(_lock)
        self, node: _Node, path: List[str], acc: Dict[str, int]
    ) -> None:
        if node.self_hits:
            key = ";".join(path) if path else "<root>"
            acc[key] = acc.get(key, 0) + node.self_hits
        for k, child in node.children.items():
            path.append(frame_name(*k))
            self._walk_leaves(child, path, acc)
            path.pop()

    def window(self, since: int = 0) -> dict:
        """The Status payload form: counters plus only the frames whose
        hits moved past the poller's echoed ``since`` seq (empty when
        nothing was sampled since — the incremental contract that keeps
        a 2 s poll over a 10 ms sampler cheap). Plain JSON-able: the
        payload must cross the restricted unpickler."""
        self._flush_gc_metrics()
        with self._lock:
            seq = self._seq
            stacks = self._stacks
            nodes = self._nodes
            gc_sect = {
                "pauses": self._gc_pauses,
                "pause_s": round(self._gc_pause_s, 6),
                "max_pause_s": round(self._gc_max_s, 6),
                "tracked": self._gc_installed,
            }
            threads = sorted(self._roots)
        out = {
            "schema": SCHEMA,
            "seq": seq,
            "period_ms": round(self.period_s * 1000.0, 3),
            "base_period_ms": round(self.base_period_s * 1000.0, 3),
            "overhead_ewma_ms": round(self._cost_ewma_s * 1000.0, 4),
            "backoffs": self._backoffs,
            "stacks": stacks,
            "nodes": nodes,
            "threads": threads,
            "gc": gc_sect,
            "frames": self.hot_frames(WINDOW_TOP, since=since),
            "hot_stacks": self.hot_stacks(),
        }
        if self.alloc_top_n > 0:
            try:
                out["alloc"] = self.alloc_top()
            except Exception as exc:  # pragma: no cover - tracemalloc off
                out["alloc_error"] = str(exc)[:200]
        return out

    def summary(self) -> dict:
        """The RunReport-embedded form: the window head plus only the
        top-10 frames — bounded, artifact-friendly."""
        w = self.window(since=0)
        w["frames"] = w["frames"][:10]
        return w

    # -- artifacts ---------------------------------------------------------

    def collapsed_lines(self) -> List[str]:
        """Brendan Gregg collapsed-stack form, one line per unique leaf
        path: ``thread;frame;frame... count`` — flamegraph.pl and
        speedscope both ingest it; obs/flame.py diffs it."""
        acc: Dict[str, int] = {}
        with self._lock:
            for thread, root in sorted(self._roots.items()):
                self._walk_leaves(root, [thread], acc)
        return [f"{path} {hits}" for path, hits in sorted(acc.items())]

    def speedscope_dict(self, name: str = "gol-profile") -> dict:
        """The speedscope JSON file format (``type: sampled``): one
        profile per thread, each unique leaf path one weighted sample.
        https://www.speedscope.app/file-format-schema.json"""
        frames: List[dict] = []
        index: Dict[Tuple[str, str, int], int] = {}
        profiles: List[dict] = []
        with self._lock:
            items = sorted(self._roots.items())
            for thread, root in items:
                samples: List[List[int]] = []
                weights: List[int] = []
                self._speedscope_walk(root, [], frames, index,
                                      samples, weights)
                total = sum(weights)
                profiles.append({
                    "type": "sampled",
                    "name": thread,
                    "unit": "none",
                    "startValue": 0,
                    "endValue": total,
                    "samples": samples,
                    "weights": weights,
                })
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": name,
            "exporter": f"gol-profiler ({SCHEMA})",
            "activeProfileIndex": 0,
            "shared": {"frames": frames},
            "profiles": profiles,
        }

    def _speedscope_walk(self, node, path, frames, index, samples,
                         weights) -> None:  # gol: holds(_lock)
        if node.self_hits and path:
            samples.append(list(path))
            weights.append(node.self_hits)
        for k, child in node.children.items():
            i = index.get(k)
            if i is None:
                i = index[k] = len(frames)
                frames.append({
                    "name": k[0] or "?",
                    "file": short_file(k[1]),
                    "line": k[2],
                })
            path.append(i)
            self._speedscope_walk(child, path, frames, index,
                                  samples, weights)
            path.pop()

    def write_artifacts(self, out_dir: str = "out",
                        tag: str = "run") -> List[pathlib.Path]:
        """Both artifact forms, tmp-then-rename like every other obs
        artifact: ``profile_<tag>.collapsed`` + ``.speedscope.json``."""
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        paths = []
        collapsed = out / f"profile_{tag}.collapsed"
        tmp = collapsed.with_name(collapsed.name + ".tmp")
        tmp.write_text("\n".join(self.collapsed_lines()) + "\n")
        tmp.replace(collapsed)
        paths.append(collapsed)
        scope = out / f"profile_{tag}.speedscope.json"
        tmp = scope.with_name(scope.name + ".tmp")
        tmp.write_text(json.dumps(self.speedscope_dict(tag)))
        tmp.replace(scope)
        paths.append(scope)
        return paths


# -- the process-global default profiler --------------------------------------

_PROFILER: Optional[ContinuousProfiler] = None
#: where run-end/crash artifacts land (enable() records the CLI's -dir)
_OUT_DIR = "out"
_TAG = "run"


def profiler() -> Optional[ContinuousProfiler]:
    return _PROFILER


def enabled() -> bool:
    return _PROFILER is not None


def enable(
    period_ms: float = DEFAULT_PERIOD_MS,
    *,
    budget: float = DEFAULT_BUDGET,
    max_nodes: int = DEFAULT_MAX_NODES,
    max_frames: int = DEFAULT_MAX_FRAMES,
    track_gc: bool = True,
    alloc_top_n: int = 0,
    out_dir: str = "out",
    tag: str = "run",
    start_thread: bool = True,
) -> ContinuousProfiler:
    """Start the global profiler (the ``-profile [MS]`` flags). Implies
    ``metrics.enable()`` — the gc/pause/backoff meters must land
    somewhere. ``start_thread=False`` gives tests a profiler they tick
    by hand."""
    global _PROFILER, _OUT_DIR, _TAG
    if _PROFILER is not None:
        disable()
    from . import metrics as _metrics

    _metrics.enable()
    p = ContinuousProfiler(
        period_ms,
        budget=budget,
        max_nodes=max_nodes,
        max_frames=max_frames,
        track_gc=track_gc,
        alloc_top_n=alloc_top_n,
    )
    if track_gc:
        p.install_gc()
    if alloc_top_n > 0:
        p.start_alloc()
    _OUT_DIR = out_dir
    _TAG = tag
    _PROFILER = p
    if start_thread:
        p.start()
    return p


def disable() -> None:
    global _PROFILER
    p, _PROFILER = _PROFILER, None
    if p is not None:
        p.close()


def summary() -> Optional[dict]:
    """The RunReport hook: None when the profiler is off."""
    p = _PROFILER
    return p.summary() if p is not None else None


def window(since: int = 0) -> Optional[dict]:
    """The Status hook: None when the profiler is off."""
    p = _PROFILER
    return p.window(since=since) if p is not None else None


def write_artifacts(tag: Optional[str] = None) -> List[pathlib.Path]:
    """Run-end artifact write (mains call it on clean shutdown)."""
    p = _PROFILER
    if p is None:
        return []
    return p.write_artifacts(_OUT_DIR, tag or _TAG)


def shutdown() -> None:
    """Clean-exit hook for the mains' finally blocks: best-effort
    run-end artifact write, then disable. Never raises — the serving
    process's own exit status is the prize."""
    p = _PROFILER
    if p is None:
        return
    try:
        p.stop()
        p.write_artifacts(_OUT_DIR, _TAG)
    except Exception as exc:  # pragma: no cover - disk-full path
        logger.warning("profiler run-end artifact write failed: %s", exc)
    disable()


def flush_on_crash(exc: BaseException) -> None:
    """Crash-path artifact write, riding the mains' dump_on_crash hook
    next to flight/journal. NEVER raises — the original traceback is
    the prize; losing it to a profiler bug would be absurd."""
    p = _PROFILER
    if p is None:
        return
    try:
        p.stop()
        paths = p.write_artifacts(_OUT_DIR, f"crash_{_TAG}")
        print(
            f"[obs] crash profile: {', '.join(str(x) for x in paths)} "
            f"({type(exc).__name__})",
            file=sys.stderr,
        )
    # gol: allow(hygiene): crash path — the original traceback is the
    # prize; a raising (or even printing-failure) handler here would
    # mask it
    except BaseException:  # pragma: no cover - crash path must not raise
        pass
