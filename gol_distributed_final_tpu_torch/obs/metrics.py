"""Dependency-free metrics registry: counters, gauges, histograms.

Design constraints, in priority order:

* **Cheap when off.** The engine run loop and the RPC dispatch path call
  these per chunk / per request; with the registry disabled every
  instrument method is one attribute load and a branch — no clock reads,
  no locking, no allocation. The global default registry starts disabled
  and is switched on by the ``-metrics`` CLI flags (``enable()``).
* **Exact cross-host merge.** Histograms use FIXED bucket edges declared
  at registration (monotonic-clock seconds by default), so merging two
  hosts' snapshots is element-wise addition of bucket counts — no
  re-binning error, ever. ``merge_snapshots`` refuses mismatched edges
  instead of approximating.
* **No dependencies.** Pure stdlib: the RPC layer (which must import this)
  stays importable in a worker process that never loads jax or numpy.

Exposition: ``Registry.snapshot()`` is a plain-JSON dict (the wire/report
format); ``snapshot_to_prometheus`` renders the standard text format
(cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``), and
``parse_prometheus_text`` reads that text back into ``{sample: value}``
for round-trip checks and scrapers without a real Prometheus.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

# Default histogram edges (seconds), spanning a 10 us kernel dispatch to a
# multi-minute checkpoint. FIXED at registration so cross-host merges are
# exact; change requires bumping the README metric table (obs/lint.py).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5,
    1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0,
)


def clock() -> float:
    """The one timestamp source for every instrument: monotonic seconds."""
    return time.monotonic()


class _Child:
    """One labelled series. ``_reg`` is consulted on every mutation so a
    disabled registry records nothing regardless of when the instrument
    was created."""

    __slots__ = ("_reg", "labels_values")

    def __init__(self, reg: "Registry", labels_values: Tuple[str, ...]):
        self._reg = reg
        self.labels_values = labels_values


class Counter(_Child):
    __slots__ = ("value",)

    def __init__(self, reg, labels_values):
        super().__init__(reg, labels_values)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        with self._reg._lock:
            self.value += amount


class Gauge(_Child):
    __slots__ = ("value",)

    def __init__(self, reg, labels_values):
        super().__init__(reg, labels_values)
        self.value = 0.0

    def set(self, value: float) -> None:
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self.value = float(value)


class Histogram(_Child):
    """Fixed-edge histogram. ``counts`` is NON-cumulative per bucket with a
    trailing +inf overflow slot (len(edges) + 1 entries); exposition
    cumulates on the way out, merge adds element-wise."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, reg, labels_values, edges: Tuple[float, ...]):
        super().__init__(reg, labels_values)
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.observe_n(value, 1)

    def observe_n(self, value: float, n: int) -> None:
        """Record ``n`` identical observations in one call — the engine's
        chunked dispatch records a whole chunk's per-turn time at once, so
        the histogram count still equals the TURN count."""
        if not self._reg.enabled or n <= 0:
            return
        i = bisect.bisect_left(self.edges, value)
        with self._reg._lock:
            self.counts[i] += n
            self.sum += value * n
            self.count += n


class _Family:
    """One named metric and its labelled children. With no labelnames the
    family owns a single default child and proxies its mutators, so
    ``FAMILY.inc()`` / ``FAMILY.observe()`` work directly."""

    def __init__(self, reg, name, kind, help_text, labelnames, edges=None):
        self.reg = reg
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.edges = edges
        self.children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._default = self.labels()

    def _make_child(self, values: Tuple[str, ...]) -> _Child:
        if self.kind == "counter":
            return Counter(self.reg, values)
        if self.kind == "gauge":
            return Gauge(self.reg, values)
        return Histogram(self.reg, values, self.edges)

    def labels(self, *values: str) -> _Child:
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        child = self.children.get(values)
        if child is None:
            with self.reg._lock:
                child = self.children.setdefault(values, self._make_child(values))
        return child

    # unlabelled convenience surface
    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def set(self, value: float) -> None:
        self._default.set(value)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def observe_n(self, value: float, n: int) -> None:
        self._default.observe_n(value, n)

    @property
    def value(self) -> float:
        return self._default.value


class Registry:
    """A set of metric families. Registration is idempotent by name (the
    instruments module may be imported from several entry points); a
    re-registration with a DIFFERENT kind/labels/edges is a programming
    error and raises."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _register(self, name, kind, help_text, labelnames, edges=None):
        fam = self._families.get(name)
        if fam is not None:
            if (fam.kind, fam.labelnames, fam.edges) != (
                kind, tuple(labelnames), edges,
            ):
                raise ValueError(
                    f"metric {name} re-registered with a different signature"
                )
            return fam
        fam = _Family(self, name, kind, help_text, labelnames, edges)
        self._families[name] = fam
        return fam

    def counter(self, name, help_text="", labelnames=()):
        return self._register(name, "counter", help_text, labelnames)

    def gauge(self, name, help_text="", labelnames=()):
        return self._register(name, "gauge", help_text, labelnames)

    def histogram(self, name, help_text="", labelnames=(), buckets=DEFAULT_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"bucket edges must be strictly increasing: {edges}")
        return self._register(name, "histogram", help_text, labelnames, edges)

    def families(self) -> List[_Family]:
        return list(self._families.values())

    def reset(self) -> None:
        """Zero every series (keeps registrations) — test/bench isolation."""
        with self._lock:
            for fam in self._families.values():
                for child in fam.children.values():
                    if isinstance(child, Histogram):
                        child.counts = [0] * (len(child.edges) + 1)
                        child.sum = 0.0
                        child.count = 0
                    else:
                        child.value = 0.0

    def snapshot(self) -> dict:
        """Plain-JSON state of every family — the wire/report format, and
        the merge operand."""
        fams = []
        with self._lock:
            for fam in self._families.values():
                series = []
                for values, child in sorted(fam.children.items()):
                    if isinstance(child, Histogram):
                        series.append({
                            "labels": list(values),
                            "buckets": list(child.counts),
                            "sum": child.sum,
                            "count": child.count,
                        })
                    else:
                        series.append({
                            "labels": list(values),
                            "value": child.value,
                        })
                entry = {
                    "name": fam.name,
                    "type": fam.kind,
                    "help": fam.help,
                    "labelnames": list(fam.labelnames),
                    "series": series,
                }
                if fam.edges is not None:
                    entry["le"] = list(fam.edges)
                fams.append(entry)
        return {"schema": "gol-metrics/1", "families": fams}


# -- snapshot algebra --------------------------------------------------------


def merge_snapshots(a: dict, b: dict) -> dict:
    """Element-wise merge of two snapshots (e.g. two hosts of an SPMD job):
    counters and histogram buckets/sum/count ADD (exact, because edges are
    fixed and must match), gauges take the MAX (commutative and meaningful
    for high-water readings like chunk size). Families or series present
    on one side only pass through."""
    out = {"schema": "gol-metrics/1", "families": []}
    b_fams = {f["name"]: f for f in b.get("families", [])}
    seen = set()
    for fa in a.get("families", []):
        fb = b_fams.get(fa["name"])
        seen.add(fa["name"])
        if fb is None:
            out["families"].append(_copy_family(fa))
            continue
        if fa["type"] != fb["type"] or fa.get("le") != fb.get("le"):
            raise ValueError(
                f"cannot merge {fa['name']}: type/bucket-edge mismatch "
                "(fixed edges are the exactness contract)"
            )
        merged = _copy_family(fa)
        index = {tuple(s["labels"]): s for s in merged["series"]}
        for sb in fb["series"]:
            key = tuple(sb["labels"])
            sa = index.get(key)
            if sa is None:
                merged["series"].append(dict(sb))
                continue
            if fa["type"] == "histogram":
                sa["buckets"] = [
                    x + y for x, y in zip(sa["buckets"], sb["buckets"])
                ]
                sa["sum"] += sb["sum"]
                sa["count"] += sb["count"]
            elif fa["type"] == "counter":
                sa["value"] += sb["value"]
            else:  # gauge
                sa["value"] = max(sa["value"], sb["value"])
        out["families"].append(merged)
    for name, fb in b_fams.items():
        if name not in seen:
            out["families"].append(_copy_family(fb))
    return out


def merge_many(snaps) -> dict:
    """Left fold of ``merge_snapshots`` over N per-process snapshots —
    the fleet collector's cluster-registry primitive. The merged result
    keeps the exactness contract: every counter equals the ARITHMETIC
    SUM of its per-process values, every histogram bucket the per-bucket
    sum. An empty iterable yields an empty snapshot; a single snapshot
    comes back as a deep-ish copy (same shape as a merge result), so
    callers may mutate it without aliasing a target's cached payload."""
    merged = {"schema": "gol-metrics/1", "families": []}
    for snap in snaps:
        merged = merge_snapshots(merged, snap)
    return merged


def _copy_family(fam: dict) -> dict:
    out = {k: v for k, v in fam.items() if k != "series"}
    out["series"] = [dict(s, labels=list(s["labels"])) for s in fam["series"]]
    for s in out["series"]:
        if "buckets" in s:
            s["buckets"] = list(s["buckets"])
    return out


# -- Prometheus text exposition ---------------------------------------------


def _label_str(labelnames: Iterable[str], values: Iterable[str],
               extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, values)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    body = ",".join(f'{n}="{_escape(v)}"' for n, v in pairs)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(x: float) -> str:
    if x == float("inf"):
        return "+Inf"
    if float(x) == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def snapshot_to_prometheus(snap: dict) -> str:
    """Render a snapshot in the Prometheus text format (histograms go out
    CUMULATIVE with a +Inf bucket, per the format's contract)."""
    lines: List[str] = []
    for fam in snap.get("families", []):
        name, kind = fam["name"], fam["type"]
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape(fam['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        labelnames = fam.get("labelnames", [])
        for s in fam["series"]:
            if kind == "histogram":
                cum = 0
                for edge, n in zip(
                    list(fam["le"]) + [float("inf")], s["buckets"]
                ):
                    cum += n
                    ls = _label_str(labelnames, s["labels"], ("le", _fmt(edge)))
                    lines.append(f"{name}_bucket{ls} {cum}")
                ls = _label_str(labelnames, s["labels"])
                lines.append(f"{name}_sum{ls} {_fmt(s['sum'])}")
                lines.append(f"{name}_count{ls} {_fmt(s['count'])}")
            else:
                ls = _label_str(labelnames, s["labels"])
                lines.append(f"{name}{ls} {_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Minimal reader for the text format THIS module emits: returns
    ``{sample_line_without_value: value}`` — enough for exposition
    round-trip tests and for a scraper-less operator to diff two Status
    snapshots. Not a general Prometheus parser."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        out[key] = float("inf") if value == "+Inf" else float(value)
    return out


# -- the process-global default registry ------------------------------------

# Disabled until an entry point opts in (-metrics / -report / enable()):
# every instrument bound to it is a no-op flag check until then.
_DEFAULT = Registry(enabled=False)


def registry() -> Registry:
    return _DEFAULT


def enable(on: bool = True) -> None:
    _DEFAULT.enabled = on


def enabled() -> bool:
    return _DEFAULT.enabled
