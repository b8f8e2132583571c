"""In-process metric timelines: a time-series ring over the registry.

The registry (obs/metrics.py) answers "how much, ever"; the watch
dashboard (obs/watch.py) reconstructs "how fast, lately" CLIENT-side from
successive polls — which loses all history between polls, dies with the
poller, and cannot feed server-side alerting. Production serving stacks
keep the history where the work happens (Podracer, arXiv:2104.06272,
keeps the controller off the hot path for exactly this reason): this
module is that history.

* **A cheap background sampler.** ``enable(period)`` (the ``-timeline
  [SECS]`` CLI flags, default cadence 1 s) starts a daemon thread that
  snapshots every registered counter/gauge/histogram into fixed-size
  per-series rings — bounded memory (``DEFAULT_CAPACITY`` samples per
  series), monotonic timestamps for rate math, wall clocks for display.
  ``maybe_sample()`` sites (the engine chunk loop) opportunistically
  advance the clock when due, so a GIL-saturated process still samples.
* **Counter-reset detection.** Each series keeps an adjusted MONOTONE
  value: when the raw value goes backwards (a registry reset, a
  restarted subprocess merged in), the previous raw total folds into a
  base instead of producing a negative rate — the Prometheus ``rate()``
  posture. ``counter_delta`` exposes the same logic to client-side
  pollers (obs/watch.py rides it).
* **Server-side rates and quantiles.** ``rate``/``increase``/
  ``quantile`` compute over the ring's real timestamps; histogram
  quantiles interpolate within the fixed bucket edges (exact against a
  numpy oracle to bucket resolution — tests/test_slo.py).
* **Incremental Status windows.** ``window(since=seq)`` ships only the
  samples a poller has not seen (the poller echoes the last ``seq`` it
  received via the ``Request.timeline_since`` extension field — getattr-
  skew-safe like ``trace_ctx``), plus a server-computed ``summary`` of
  rates/p50/p99 per series, so ONE poll answers "how fast, lately"
  without client-side reconstruction.
* **Chrome counter tracks.** ``chrome_counter_samples()`` renders the
  rings as trace-event counter samples; ``tracing.write_chrome_trace``
  folds them in so Perfetto shows throughput/HBM/queue depth on the same
  timeline as the spans.

Like the registry, the tracer, and the flight recorder: pure stdlib,
OFF by default, one global-load-and-branch per ``maybe_sample`` site
until an entry point opts in. SLO evaluation (obs/slo.py) attaches a
rulebook that runs after every tick.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics
from ..utils import locksan as _locksan

logger = logging.getLogger(__name__)

#: default sampling cadence (seconds) — the ``-timeline`` flags' implied
#: value; one registry snapshot per tick
DEFAULT_PERIOD = 1.0
#: samples retained per series: 6 minutes of history at the default
#: cadence — enough for every default SLO window (obs/slo.py) with slack
DEFAULT_CAPACITY = 360
#: wall-clock history enable() guarantees the rings cover regardless of
#: cadence: the default rulebook's longest window (120 s) plus slack. A
#: sub-second ``-timeline 0.2`` would otherwise span 360 x 0.2 = 72 s and
#: silently collapse the slow burn-rate window onto the fast one — the
#: very blip-suppression the two-window design exists for.
RULE_HORIZON_S = 150.0

SCHEMA = "gol-timeline/1"

#: summary/rate window (seconds) the Status payload computes over
SUMMARY_WINDOW_S = 60.0


def counter_delta(prev: float, new: float) -> float:
    """Non-negative counter increase across one poll, reset-aware: a
    value that went BACKWARDS means the process restarted (or its
    registry was reset), so everything the new total holds happened
    since — the Prometheus ``rate()`` posture. Shared with client-side
    pollers (obs/watch.py) so server rings and dashboards agree."""
    return new if new < prev else new - prev


def quantile_from_buckets(
    edges: Tuple[float, ...], counts: List[float], q: float
) -> Optional[float]:
    """The ``q``-quantile of a fixed-edge histogram (non-cumulative
    ``counts`` with a trailing overflow slot, the obs/metrics.py layout):
    linear interpolation within the containing bucket, lower bound 0 for
    the first, clamped to the last finite edge for overflow — the
    ``histogram_quantile`` contract. None on an empty histogram."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, n in enumerate(counts):
        if n <= 0:
            continue
        if cum + n >= target:
            lo = edges[i - 1] if i > 0 else 0.0
            if i >= len(edges):
                return float(edges[-1])  # overflow: the honest clamp
            hi = edges[i]
            return float(lo + (hi - lo) * (target - cum) / n)
        cum += n
    return float(edges[-1])


class _SeriesRing:
    """One series' bounded history. Counter/gauge samples are
    ``(seq, t_mono, t_unix, value)``; histogram samples are
    ``(seq, t_mono, t_unix, count, sum, buckets_tuple)``. Counter and
    histogram values are stored ADJUSTED (monotone across resets, see
    ``counter_delta``); ``resets`` counts the backwards jumps seen."""

    __slots__ = ("kind", "edges", "samples", "resets", "_last_raw", "_base")

    def __init__(self, kind: str, capacity: int, edges=None):
        self.kind = kind
        self.edges = edges
        self.samples: deque = deque(maxlen=capacity)
        self.resets = 0
        self._last_raw = None  # last RAW observation (reset detection)
        self._base = None  # accumulated pre-reset totals

    def push_scalar(self, seq: int, t_mono: float, t_unix: float, raw: float):
        if self.kind == "gauge":
            self.samples.append((seq, t_mono, t_unix, float(raw)))
            return
        if self._base is None:
            self._base = 0.0
        if self._last_raw is not None and raw < self._last_raw:
            self._base += self._last_raw
            self.resets += 1
        self._last_raw = raw
        self.samples.append((seq, t_mono, t_unix, self._base + raw))

    def push_hist(self, seq, t_mono, t_unix, count, total, buckets):
        if self._base is None:
            self._base = (0, 0.0, (0,) * len(buckets))
        # reset detection per BUCKET, not just the count: a restart
        # followed by heavy traffic can push the new count past the old
        # total, but no individual bucket can shrink without a reset
        if self._last_raw is not None and (
            count < self._last_raw[0]
            or any(b < pb for b, pb in zip(buckets, self._last_raw[2]))
        ):
            pc, ps, pb = self._last_raw
            bc, bs, bb = self._base
            self._base = (bc + pc, bs + ps,
                          tuple(x + y for x, y in zip(bb, pb)))
            self.resets += 1
        self._last_raw = (count, total, tuple(buckets))
        bc, bs, bb = self._base
        self.samples.append((
            seq, t_mono, t_unix, bc + count, bs + total,
            tuple(x + y for x, y in zip(bb, buckets)),
        ))

    # -- window queries ----------------------------------------------------

    def pair(self, window_s: float):
        """(oldest-in-window, newest) sample pair, or None with fewer
        than two samples. The oldest is the last sample at or BEFORE the
        window start, so a window slightly longer than the ring still
        uses the full ring instead of returning nothing."""
        if len(self.samples) < 2:
            return None
        newest = self.samples[-1]
        cutoff = newest[1] - window_s
        oldest = None
        for s in self.samples:
            if s[1] <= cutoff:
                oldest = s
            else:
                if oldest is None:
                    oldest = s
                break
        if oldest is None or oldest is newest:
            oldest = self.samples[0]
        if oldest is newest:
            return None
        return oldest, newest


class TimelineSampler:
    """The per-process timeline: rings for every series of a registry,
    advanced by ``sample_once`` (the background thread, or an
    opportunistic ``maybe_sample`` site). All public queries take the
    internal lock; sampling is O(registry snapshot)."""

    # the ring state mutates under _lock during ticks while Status polls
    # iterate it — the exact 'deque mutated during iteration' race the
    # PR 8 review fixed, now machine-enforced (analysis/locks.py)
    _GUARDED_BY = {
        "_series": "_lock",
        "_labelnames": "_lock",
        "_seq": "_lock",
        "_prev_stamp": "_lock",
    }

    def __init__(
        self,
        registry=None,
        period: float = DEFAULT_PERIOD,
        capacity: int = DEFAULT_CAPACITY,
    ):
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self._registry = registry if registry is not None else _metrics.registry()
        self.period = float(period)
        self.capacity = int(capacity)
        # RLock: every reader holds it for its WHOLE computation (ring
        # deques mutate under it during sample ticks — an unlocked
        # iteration would race a concurrent append), and window() nests
        # summary() under the same lock
        self._lock = _locksan.rlock("TimelineSampler._lock")
        # serialises ticks + rule evaluation: concurrent maybe_sample
        # sites (engine chunk loop, Status polls, the background thread)
        # must produce ONE tick and ONE rulebook pass, or a single
        # worker-lost transition could double-increment the alert meter
        self._tick_lock = _locksan.lock("TimelineSampler._tick_lock")
        self._series: Dict[Tuple[str, Tuple[str, ...]], _SeriesRing] = {}
        self._labelnames: Dict[str, Tuple[str, ...]] = {}
        self._seq = 0
        self._last_t = 0.0
        self._prev_stamp: Optional[Tuple[float, float]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rulebook = None  # obs/slo.RuleBook, attached by enable()
        # rulebook-failure tally (tick-lock serialised): paces the
        # warning log so a per-tick rule bug doesn't flood stderr
        self._rule_errors = 0

    # -- sampling ----------------------------------------------------------

    def attach_rulebook(self, rulebook) -> None:
        self._rulebook = rulebook

    @property
    def rulebook(self):
        return self._rulebook

    def sample_once(self, now: Optional[float] = None,
                    wall: Optional[float] = None) -> int:
        """Snapshot every series into the rings; returns the tick's seq.
        ``now``/``wall`` are injectable for deterministic tests."""
        with self._tick_lock:
            return self._sample_locked(now, wall)

    def _sample_locked(self, now: Optional[float] = None,
                       wall: Optional[float] = None) -> int:
        t_mono = time.monotonic() if now is None else now
        t_unix = time.time() if wall is None else wall
        snap = self._registry.snapshot()
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._last_t = t_mono
            for fam in snap.get("families", []):
                name, kind = fam["name"], fam["type"]
                self._labelnames[name] = tuple(fam.get("labelnames", ()))
                edges = tuple(fam["le"]) if kind == "histogram" else None
                for s in fam["series"]:
                    key = (name, tuple(s["labels"]))
                    ring = self._series.get(key)
                    if ring is None:
                        ring = self._series[key] = _SeriesRing(
                            kind, self.capacity, edges
                        )
                        if self._prev_stamp is not None and kind != "gauge":
                            # a series BORN mid-window (first labelled
                            # observation — e.g. the first SessionRun's
                            # dispatch histogram) was truthfully zero at
                            # the previous tick: seed that zero so its
                            # first value counts as an increase instead
                            # of an invisible flat line
                            pm, pw = self._prev_stamp
                            if kind == "histogram":
                                ring.push_hist(
                                    seq, pm, pw, 0, 0.0,
                                    (0,) * (len(edges) + 1),
                                )
                            else:
                                ring.push_scalar(seq, pm, pw, 0.0)
                    if kind == "histogram":
                        ring.push_hist(
                            seq, t_mono, t_unix,
                            s["count"], s["sum"], s["buckets"],
                        )
                    else:
                        ring.push_scalar(seq, t_mono, t_unix, s["value"])
            self._prev_stamp = (t_mono, t_unix)
        rb = self._rulebook
        if rb is not None:
            # after the tick, outside the ring lock: rules read back
            # through the public query surface
            try:
                rb.evaluate(self, now=t_mono, wall=t_unix)
            except Exception as exc:
                # an alert bug must never kill the sampler — but it must
                # leave evidence UNCONDITIONALLY: the flight ring only
                # records when the trace flags enabled it, so the log
                # line (paced: first failure, then every 60th — the
                # broker's outage-log posture, since this fires per tick)
                # is what guarantees a broken rulebook is visible instead
                # of silently never paging again
                self._rule_errors += 1
                if self._rule_errors == 1 or self._rule_errors % 60 == 0:
                    logger.warning(
                        "SLO rulebook evaluation failed (%d time(s)): %s",
                        self._rule_errors, exc,
                    )
                from . import flight

                flight.record(
                    "slo.error", "rulebook", error=str(exc)[:200]
                )
        return seq

    def maybe_sample(self) -> bool:
        """Sample if a full period has elapsed — the opportunistic form
        hot loops call so a GIL-saturated process still gets ticks. The
        cheap unlocked check runs first (the hot-path cost); the due
        path re-checks under the tick lock so racing sites produce one
        tick, not one each."""
        if time.monotonic() - self._last_t < self.period:
            return False
        with self._tick_lock:
            if time.monotonic() - self._last_t < self.period:
                return False
            self._sample_locked()
            return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="gol-timeline", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            try:
                # an opportunistic site may have just ticked; don't double
                if time.monotonic() - self._last_t >= 0.5 * self.period:
                    self.sample_once()
            # gol: allow(hygiene): the 1 Hz sampler loop must survive
            # registry bugs; recording each period would churn the
            # flight ring — the rulebook path above records once
            except Exception:  # pragma: no cover - registry bugs
                pass

    # -- queries (the obs/slo.py rule surface) -----------------------------

    def _rings(self, name: str, labels=None) -> List[_SeriesRing]:  # gol: holds(_lock)
        """Matching rings. Caller must hold ``self._lock`` across BOTH
        this call and any iteration of the returned rings' deques — a
        sample tick appends under the same lock (every query above/below
        wraps this call in ``with self._lock`` — the holds() marker
        declares that caller contract to analysis/locks.py)."""
        return [
            ring
            for (n, lv), ring in self._series.items()
            if n == name and (labels is None or lv == tuple(labels))
        ]

    def increase(self, name: str, window_s: float, labels=None) -> Optional[float]:
        """Summed adjusted increase across matching series over the
        window; None when no series has two samples yet. Histograms
        count their observation COUNT."""
        total, seen = 0.0, False
        with self._lock:
            for ring in self._rings(name, labels):
                pair = ring.pair(window_s)
                if pair is None:
                    continue
                old, new = pair
                total += new[3] - old[3]
                seen = True
        return total if seen else None

    def rate(self, name: str, window_s: float, labels=None) -> Optional[float]:
        """Per-second rate over the window's REAL elapsed time."""
        best_dt = 0.0
        total, seen = 0.0, False
        with self._lock:
            for ring in self._rings(name, labels):
                pair = ring.pair(window_s)
                if pair is None:
                    continue
                old, new = pair
                total += new[3] - old[3]
                best_dt = max(best_dt, new[1] - old[1])
                seen = True
        if not seen or best_dt <= 0:
            return None
        return total / best_dt

    def quantile(self, name: str, q: float, window_s: float,
                 labels=None) -> Optional[float]:
        """Histogram quantile over the window: element-wise bucket deltas
        summed across matching series, interpolated within the fixed
        edges. None without histogram data in the window."""
        edges = None
        acc: Optional[List[float]] = None
        with self._lock:
            for ring in self._rings(name, labels):
                if ring.kind != "histogram" or ring.edges is None:
                    continue
                pair = ring.pair(window_s)
                if pair is None:
                    continue
                old, new = pair
                delta = [x - y for x, y in zip(new[5], old[5])]
                if edges is None:
                    edges, acc = ring.edges, delta
                elif ring.edges == edges:
                    acc = [a + d for a, d in zip(acc, delta)]
        if acc is None:
            return None
        return quantile_from_buckets(edges, acc, q)

    def gauge_values(self, name: str) -> Dict[Tuple[str, ...], float]:
        """Latest value per labelled gauge series."""
        out = {}
        with self._lock:
            for (n, lv), ring in self._series.items():
                if n == name and ring.kind == "gauge" and ring.samples:
                    out[lv] = ring.samples[-1][3]
        return out

    def gauge_window(self, name: str, window_s: float,
                     labels=None) -> Optional[Tuple[float, float]]:
        """(earliest-in-window, latest) gauge value — the growth-rule
        surface (e.g. the scatter-deadline EWMA)."""
        with self._lock:
            for ring in self._rings(name, labels):
                if ring.kind != "gauge":
                    continue
                pair = ring.pair(window_s)
                if pair is not None:
                    return pair[0][3], pair[1][3]
        return None

    # -- exposition --------------------------------------------------------

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def reset_count(self, name: str, labels=None) -> int:
        with self._lock:
            return sum(r.resets for r in self._rings(name, labels))

    def summary(self, window_s: float = SUMMARY_WINDOW_S) -> dict:
        """Server-computed rates/quantiles per series over ``window_s``,
        keyed ``name{label=value,...}`` like report.stage_timings:
        counters -> rate; histograms -> count rate + mean + p50/p99;
        gauges -> latest/min/max over the window. Zero-activity series
        are skipped (the stage_timings posture)."""
        out: dict = {}
        with self._lock:
            for (name, lv), ring in self._series.items():
                pairs = ",".join(
                    f"{n}={v}"
                    for n, v in zip(self._labelnames.get(name, ()), lv)
                )
                key = name + (f"{{{pairs}}}" if pairs else "")
                pair = ring.pair(window_s)
                if pair is None:
                    continue
                old, new = pair
                dt = new[1] - old[1]
                if ring.kind == "counter":
                    inc = new[3] - old[3]
                    if inc:
                        out[key] = {
                            "rate_per_s": round(inc / dt, 6) if dt > 0 else None,
                            "increase": inc,
                        }
                elif ring.kind == "histogram":
                    dcount = new[3] - old[3]
                    if not dcount:
                        continue
                    dsum = new[4] - old[4]
                    delta = [x - y for x, y in zip(new[5], old[5])]
                    out[key] = {
                        "rate_per_s": round(dcount / dt, 6) if dt > 0 else None,
                        "count": dcount,
                        "mean_s": round(dsum / dcount, 9),
                        "p50_s": quantile_from_buckets(ring.edges, delta, 0.50),
                        "p99_s": quantile_from_buckets(ring.edges, delta, 0.99),
                    }
                else:  # gauge
                    window = [
                        s[3] for s in ring.samples if s[1] >= new[1] - window_s
                    ]
                    if new[3] or any(window):
                        out[key] = {
                            "value": new[3],
                            "min": min(window) if window else new[3],
                            "max": max(window) if window else new[3],
                        }
        return out

    def window(self, since: int = 0, window_s: float = SUMMARY_WINDOW_S) -> dict:
        """The Status payload form: every sample with seq > ``since``
        (the poller echoes the last seq it saw — incremental windows),
        plus the server-computed ``summary``. Counter/gauge samples ship
        ``[seq, t_unix, value]``; histograms ``[seq, t_unix, count,
        sum]`` (quantiles are server business — the summary carries
        them, so windows stay small). Plain JSON-able throughout: the
        payload must cross the restricted unpickler."""
        series = []
        with self._lock:
            seq = self._seq
            for (name, lv), ring in self._series.items():
                if ring.kind == "histogram":
                    samples = [
                        [s[0], round(s[2], 3), s[3], round(s[4], 6)]
                        for s in ring.samples if s[0] > since
                    ]
                else:
                    samples = [
                        [s[0], round(s[2], 3), s[3]]
                        for s in ring.samples if s[0] > since
                    ]
                if not samples:
                    continue
                series.append({
                    "name": name,
                    "labels": list(lv),
                    "labelnames": list(self._labelnames.get(name, ())),
                    "kind": ring.kind,
                    "resets": ring.resets,
                    "samples": samples,
                })
        return {
            "schema": SCHEMA,
            "seq": seq,
            "period_s": self.period,
            "summary_window_s": window_s,
            "series": series,
            "summary": self.summary(window_s),
        }

    def chrome_counter_samples(self) -> List[dict]:
        """Trace-event counter samples (``ph: "C"`` feedstock for
        tracing.write_chrome_trace): counters as per-second rates between
        consecutive ticks, gauges as raw values — so Perfetto shows
        throughput/HBM/queue depth ON the span timeline. Histograms are
        summarised elsewhere and skipped here."""
        out: List[dict] = []
        with self._lock:
            items = [
                (name, lv, ring.kind, list(ring.samples))
                for (name, lv), ring in self._series.items()
            ]
            labelnames = dict(self._labelnames)
        for name, lv, kind, samples in items:
            if kind == "histogram":
                continue
            pairs = ",".join(
                f"{n}={v}" for n, v in zip(labelnames.get(name, ()), lv)
            )
            track = name + (f"{{{pairs}}}" if pairs else "")
            if kind == "gauge":
                if not any(s[3] for s in samples):
                    continue
                for s in samples:
                    out.append({
                        "name": track, "ts_us": int(s[2] * 1e6),
                        "value": s[3],
                    })
            else:
                if len(samples) < 2 or samples[-1][3] == samples[0][3]:
                    continue
                for prev, cur in zip(samples, samples[1:]):
                    dt = cur[1] - prev[1]
                    if dt <= 0:
                        continue
                    out.append({
                        "name": track + " /s", "ts_us": int(cur[2] * 1e6),
                        "value": (cur[3] - prev[3]) / dt,
                    })
        return out


# -- the process-global default sampler --------------------------------------

_SAMPLER: Optional[TimelineSampler] = None


def sampler() -> Optional[TimelineSampler]:
    return _SAMPLER


def enabled() -> bool:
    return _SAMPLER is not None


def enable(
    period: float = DEFAULT_PERIOD,
    capacity: Optional[int] = None,
    rules=None,
    start_thread: bool = True,
) -> TimelineSampler:
    """Start the global timeline (the ``-timeline [SECS]`` flags).
    Implies ``metrics.enable()`` — a timeline over a disabled registry
    would record a flat zero forever. Attaches the default SLO rulebook
    (obs/slo.py) unless ``rules`` overrides it (pass ``rules=[]`` for a
    timeline with no alerting). Default capacity scales with the period
    so the rings always span ``RULE_HORIZON_S`` of wall clock — the slow
    SLO windows must be real windows at any cadence."""
    global _SAMPLER
    if _SAMPLER is not None:
        disable()
    _metrics.enable()
    if capacity is None:
        capacity = max(DEFAULT_CAPACITY, int(RULE_HORIZON_S / period) + 2)
    s = TimelineSampler(period=period, capacity=capacity)
    from . import slo as _slo  # lazy: slo imports this module's helpers

    s.attach_rulebook(_slo.RuleBook(
        _slo.default_rules() if rules is None else rules
    ))
    _SAMPLER = s
    if start_thread:
        s.start()
    return s


def disable() -> None:
    global _SAMPLER
    s, _SAMPLER = _SAMPLER, None
    if s is not None:
        s.stop()


def maybe_sample() -> None:
    """Hot-loop hook (engine chunk boundaries): one global load and a
    branch when the timeline is off; an opportunistic due-tick when on."""
    s = _SAMPLER
    if s is not None:
        s.maybe_sample()
