"""Serving SLOs: declarative rules evaluated in-process on the timeline.

The Gemma-on-TPU serving comparison (arXiv:2605.25645) frames every
serving result as a latency/throughput OBJECTIVE; this module makes those
objectives executable against the obs/timeline.py rings, where the
history already lives — server-side, off the poller, surviving dashboard
detach (the Podracer controller-off-the-hot-path posture).

Rule kinds (each a small class with one ``evaluate(timeline) -> (firing,
value, detail)``):

* ``BurnRateRule`` — Google-SRE multi-window burn rate on an error
  RATIO (numerator/denominator counter rates): fires only when the
  ratio exceeds ``factor x (1 - objective)`` over BOTH the fast window
  (catches a fresh outage quickly) and the slow window (a brief blip
  de-asserts instead of paging) — the two-window recipe from the SRE
  workbook, scaled to in-process window lengths.
* ``QuantileRule`` — a latency objective: the histogram's q-quantile
  above the threshold over both windows (with a minimum observation
  count, so three slow requests at 3 a.m. don't page).
* ``IncreaseRule`` — an any-increase-is-an-event counter (worker losses,
  integrity failures): fires while the window contains an increase.
* ``GaugeRatioRule`` — a headroom bound on a gauge pair per label set
  (HBM in-use / limit).
* ``GrowthRule`` — a drift detector on a gauge (the scatter-deadline
  EWMA): fires when the latest value grew past ``factor x`` the value a
  window ago — the "cluster is getting slower" signal before any
  absolute threshold trips.

``RuleBook`` owns the state machine: a rule TRANSITIONING to firing
increments ``gol_slo_alerts_total{rule,severity}``, lands a structured
``slo.fire`` event in the flight recorder (PR 2), and appears in the
``Status`` payload (rendered as obs/watch.py's ALERTS panel) until it
clears. Rule NAMES are a stable operator contract like metric names:
``DEFAULT_RULE_NAMES`` is documented in the README "SLOs & alerting"
table and linted by obs/lint.py.

Thresholds are deliberately serving-loose defaults (CPU loopback must
not page); operators tune by passing their own rule list to
``timeline.enable(rules=...)``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from . import flight as _flight
from . import instruments as _ins

SEVERITIES = ("page", "warn")


class Rule:
    """Base: ``name`` and ``severity`` are the alert's stable identity
    (the ``gol_slo_alerts_total`` label pair)."""

    def __init__(self, name: str, severity: str):
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")
        self.name = name
        self.severity = severity

    def evaluate(self, tl) -> Tuple[bool, Optional[float], str]:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class BurnRateRule(Rule):
    """Multi-window burn rate on ``numerator``/``denominator`` counter
    rates. Burn threshold = ``factor x (1 - objective)``; fires when the
    ratio exceeds it over BOTH windows."""

    def __init__(self, name, severity, numerator, denominator, *,
                 objective=0.999, factor=14.4, fast_s=30.0, slow_s=120.0):
        super().__init__(name, severity)
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.numerator = numerator
        self.denominator = denominator
        self.objective = objective
        self.factor = factor
        self.fast_s = fast_s
        self.slow_s = slow_s

    @property
    def threshold(self) -> float:
        return self.factor * (1.0 - self.objective)

    def _ratio(self, tl, window_s) -> Optional[float]:
        num = tl.increase(self.numerator, window_s)
        den = tl.increase(self.denominator, window_s)
        if num is None or not den:
            return None
        return num / den

    def evaluate(self, tl):
        fast = self._ratio(tl, self.fast_s)
        slow = self._ratio(tl, self.slow_s)
        firing = (
            fast is not None and slow is not None
            and fast > self.threshold and slow > self.threshold
        )
        value = fast if fast is not None else slow
        return firing, value, (
            f"{self.numerator}/{self.denominator} "
            f"{'?' if fast is None else f'{fast:.4f}'} fast / "
            f"{'?' if slow is None else f'{slow:.4f}'} slow "
            f"(burn threshold {self.threshold:.4f})"
        )


class QuantileRule(Rule):
    """Histogram p``q`` over ``threshold`` seconds in both windows, with
    at least ``min_count`` observations in the fast window."""

    def __init__(self, name, severity, metric, *, q=0.99, threshold=0.25,
                 fast_s=30.0, slow_s=120.0, min_count=10):
        super().__init__(name, severity)
        self.metric = metric
        self.q = q
        self.threshold = threshold
        self.fast_s = fast_s
        self.slow_s = slow_s
        self.min_count = min_count

    def evaluate(self, tl):
        fast = tl.quantile(self.metric, self.q, self.fast_s)
        slow = tl.quantile(self.metric, self.q, self.slow_s)
        count = tl.increase(self.metric, self.fast_s) or 0
        firing = (
            fast is not None and slow is not None
            and count >= self.min_count
            and fast > self.threshold and slow > self.threshold
        )
        return firing, fast, (
            f"{self.metric} p{int(self.q * 100)} "
            f"{'?' if fast is None else f'{fast:.4f}s'} fast / "
            f"{'?' if slow is None else f'{slow:.4f}s'} slow "
            f"(> {self.threshold}s, n={int(count)})"
        )


class IncreaseRule(Rule):
    """Fires while the window holds a counter increase above
    ``threshold`` (default: ANY increase — worker losses, integrity
    failures). The alert self-clears once the increase ages out of the
    window.

    ``labels`` optionally restricts the count to specific label-value
    tuples of the family, summed — the canary-failure rule watches only
    ``gol_canary_probes_total``'s failure results, never the ``ok``
    stream that moves on every healthy probe."""

    def __init__(self, name, severity, metric, *, threshold=0.0,
                 window_s=60.0, labels=None):
        super().__init__(name, severity)
        self.metric = metric
        self.threshold = threshold
        self.window_s = window_s
        self.labels = [tuple(l) for l in labels] if labels else None

    def evaluate(self, tl):
        if self.labels is None:
            inc = tl.increase(self.metric, self.window_s)
        else:
            seen = [
                v
                for l in self.labels
                for v in (tl.increase(self.metric, self.window_s, labels=l),)
                if v is not None
            ]
            inc = sum(seen) if seen else None
        where = (
            "{" + "|".join(",".join(l) for l in self.labels) + "}"
            if self.labels else ""
        )
        firing = inc is not None and inc > self.threshold
        return firing, inc, (
            f"{self.metric}{where} +{0 if inc is None else int(inc)} over "
            f"{int(self.window_s)}s (> {int(self.threshold)})"
        )


class GaugeRatioRule(Rule):
    """Fires when any label set's ``num/den`` exceeds ``max_ratio`` —
    the headroom bound (HBM in-use vs limit, per device)."""

    def __init__(self, name, severity, num_metric, den_metric, *,
                 max_ratio=0.92):
        super().__init__(name, severity)
        self.num_metric = num_metric
        self.den_metric = den_metric
        self.max_ratio = max_ratio

    def evaluate(self, tl):
        nums = tl.gauge_values(self.num_metric)
        dens = tl.gauge_values(self.den_metric)
        worst, worst_labels = None, None
        for labels, num in nums.items():
            den = dens.get(labels)
            if not den:
                continue
            ratio = num / den
            if worst is None or ratio > worst:
                worst, worst_labels = ratio, labels
        firing = worst is not None and worst > self.max_ratio
        where = ",".join(worst_labels) if worst_labels else "-"
        return firing, worst, (
            f"{self.num_metric}/{self.den_metric} "
            f"{'?' if worst is None else f'{worst:.2f}'} at [{where}] "
            f"(> {self.max_ratio})"
        )


class GaugeAboveRule(Rule):
    """Fires when any label set's latest gauge value exceeds an absolute
    ``threshold`` — the simplest possible bound, used where the gauge
    itself already encodes the judgement (the fleet collector's
    ``gol_fleet_targets_down`` count: ANY nonzero value is a dead
    target)."""

    def __init__(self, name, severity, metric, *, threshold=0.0):
        super().__init__(name, severity)
        self.metric = metric
        self.threshold = threshold

    def evaluate(self, tl):
        vals = tl.gauge_values(self.metric)
        worst, worst_labels = None, None
        for labels, v in vals.items():
            if worst is None or v > worst:
                worst, worst_labels = v, labels
        firing = worst is not None and worst > self.threshold
        where = ",".join(worst_labels) if worst_labels else "-"
        return firing, worst, (
            f"{self.metric} {'?' if worst is None else f'{worst:.3g}'} "
            f"at [{where}] (> {self.threshold:.3g})"
        )


class GrowthRule(Rule):
    """Fires when a gauge's latest value grew past ``factor x`` its
    value a window ago (both nonzero) — drift, not an absolute bound
    (the scatter-deadline EWMA's 'cluster is getting slower')."""

    def __init__(self, name, severity, metric, *, factor=3.0,
                 window_s=120.0, floor=0.0):
        super().__init__(name, severity)
        self.metric = metric
        self.factor = factor
        self.window_s = window_s
        self.floor = floor  # ignore growth below this absolute value

    def evaluate(self, tl):
        pair = tl.gauge_window(self.metric, self.window_s)
        if pair is None:
            return False, None, f"{self.metric}: no window yet"
        earlier, latest = pair
        firing = (
            earlier > 0 and latest > self.floor
            and latest >= self.factor * earlier
        )
        growth = latest / earlier if earlier > 0 else None
        return firing, growth, (
            f"{self.metric} {earlier:.3g} -> {latest:.3g} over "
            f"{int(self.window_s)}s "
            f"({'?' if growth is None else f'{growth:.1f}x'}, "
            f"fires at {self.factor}x)"
        )


def default_rules() -> List[Rule]:
    """The default serving rulebook — one rule per objective on the
    README "SLOs & alerting" table (names are the stable contract,
    ``DEFAULT_RULE_NAMES`` below; obs/lint.py enforces the docs)."""
    return [
        # losing a worker mid-run is the page: recovery machinery (PR 4)
        # hides the latency cost, so an operator would otherwise only
        # notice at the Nth loss of a flapping transport
        IncreaseRule(
            "worker-lost", "page", "gol_worker_lost_total", window_s=60.0,
        ),
        # any integrity failure is a caught corruption — page immediately
        IncreaseRule(
            "integrity-failures", "page", "gol_integrity_failures_total",
            window_s=120.0,
        ),
        # the blackbox closure (obs/canary.py): a probe that came back
        # WRONG ('corrupt') or failed loudly ('error') means the serving
        # path itself is broken end to end — page within one probe
        # period instead of waiting for a user to notice. The 'ok'
        # stream is excluded: a healthy canary must never arm the rule.
        IncreaseRule(
            "canary-failure", "page", "gol_canary_probes_total",
            window_s=120.0, labels=[("corrupt",), ("error",)],
        ),
        # 99.9% availability objective at 14.4x burn (the SRE workbook's
        # fast-burn page): >1.44% of RPCs erroring in both windows
        BurnRateRule(
            "rpc-error-ratio", "page",
            "gol_rpc_server_errors_total", "gol_rpc_server_requests_total",
            objective=0.999, factor=14.4, fast_s=30.0, slow_s=120.0,
        ),
        # per-universe-turn serving latency (engine/sessions.py): the
        # batch is supposed to amortise dispatch — p99 above 250 ms per
        # chunk-normalized turn means it is not
        QuantileRule(
            "session-turn-latency", "page", "gol_session_turn_seconds",
            q=0.99, threshold=0.25, fast_s=30.0, slow_s=120.0,
        ),
        # admission should be near-instant (a lock + a table append);
        # waiting a second means the driver thread is starved or wedged
        QuantileRule(
            "session-admit-latency", "warn",
            "gol_session_admit_wait_seconds",
            q=0.99, threshold=1.0, fast_s=30.0, slow_s=120.0, min_count=3,
        ),
        # per-verb handler latency on the serving surface
        QuantileRule(
            "rpc-dispatch-latency", "warn", "gol_rpc_dispatch_seconds",
            q=0.99, threshold=1.0, fast_s=30.0, slow_s=120.0,
        ),
        # HBM headroom: past 92% in-use the next admission OOMs
        GaugeRatioRule(
            "hbm-headroom", "page",
            "gol_device_hbm_bytes_in_use", "gol_device_hbm_bytes_limit",
            max_ratio=0.92,
        ),
        # the adaptive scatter deadline (rpc/broker.py) tracks the
        # turn-time EWMA: 3x growth means the cluster is getting slower
        # even though nothing has failed yet
        GrowthRule(
            "scatter-deadline-growth", "warn",
            "gol_scatter_deadline_seconds", factor=3.0, window_s=120.0,
            floor=1.0,
        ),
        # per-worker service-time skew (obs/critical.py: slowest EWMA /
        # roster median, updated per K-batch): every fan-out turn lands
        # at the slowest worker's pace, so a skew that DOUBLES means one
        # host quietly started setting the whole cluster's turn rate —
        # the straggler signal before anything fails. floor 1.5 keeps a
        # balanced roster's jitter (~1.0) from ever arming it.
        GrowthRule(
            "worker-skew", "warn",
            "gol_worker_skew_ratio", factor=2.0, window_s=120.0,
            floor=1.5,
        ),
        # stop-the-world GC pauses (obs/profiler.py's gc.callbacks
        # hook): a 50 ms pause under a 250 ms turn budget IS the p99,
        # and no segment decomposition will ever name it — the rule
        # only arms while a -profile run is metering pauses
        QuantileRule(
            "gc-pause", "warn", "gol_gc_pause_seconds",
            q=0.99, threshold=0.05, fast_s=30.0, slow_s=120.0,
            min_count=3,
        ),
    ]


def fleet_rules() -> List[Rule]:
    """Fleet-scope rules the collector (obs/fleet.py) adds ON TOP of the
    re-instantiated default rulebook — each reads a ``gol_fleet_*`` gauge
    the collector maintains in its OWN registry from scrape health and
    the merged ledgers, so the rules ride the same timeline surface as
    every other objective (names documented in the README "Fleet" rule
    table, ``FLEET_RULE_NAMES`` below; obs/lint.py enforces the docs)."""
    return [
        # a target whose last-success age crossed the staleness bound is
        # DOWN — the page every other fleet reading depends on, since a
        # dead broker's sessions silently vanish from the merged sums
        GaugeAboveRule(
            "target-down", "page", "gol_fleet_targets_down", threshold=0.0,
        ),
        # summed live sessions vs summed broker capacity: past 90% the
        # fleet has no room to reshard a dead broker's tenants into
        GaugeRatioRule(
            "fleet-capacity-headroom", "warn",
            "gol_fleet_sessions_active", "gol_fleet_capacity_total",
            max_ratio=0.90,
        ),
        # a tenant whose device-seconds pile onto ONE broker at >3x its
        # fair share defeats the sharding the fleet exists to provide
        GaugeAboveRule(
            "fleet-tenant-skew", "warn", "gol_fleet_tenant_skew",
            threshold=3.0,
        ),
    ]


#: the stable rule-name contract (README "SLOs & alerting", obs/lint.py)
DEFAULT_RULE_NAMES = (
    "worker-lost",
    "integrity-failures",
    "canary-failure",
    "rpc-error-ratio",
    "session-turn-latency",
    "session-admit-latency",
    "rpc-dispatch-latency",
    "hbm-headroom",
    "scatter-deadline-growth",
    "worker-skew",
    "gc-pause",
)

#: the fleet collector's rule-name contract (README "Fleet", obs/lint.py)
FLEET_RULE_NAMES = (
    "target-down",
    "fleet-capacity-headroom",
    "fleet-tenant-skew",
)


class _AlertState:
    __slots__ = ("firing", "since_mono", "since_unix", "value", "detail",
                 "fired_total")

    def __init__(self):
        self.firing = False
        self.since_mono = 0.0
        self.since_unix = 0.0
        self.value = None
        self.detail = ""
        self.fired_total = 0


class RuleBook:
    """Rule states + transition side effects. ``evaluate`` runs after
    every timeline tick (TimelineSampler calls it); ``snapshot`` is the
    JSON-able list the Status payload ships (the ALERTS panel's feed and
    the doctor's correlation input)."""

    def __init__(self, rules: List[Rule]):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules = list(rules)
        self._states = {r.name: _AlertState() for r in self.rules}

    def evaluate(self, tl, now: Optional[float] = None,
                 wall: Optional[float] = None) -> List[dict]:
        """Evaluate every rule; returns the transitions that happened
        this tick (fired/cleared) for callers that want them."""
        now = time.monotonic() if now is None else now
        wall = time.time() if wall is None else wall
        transitions = []
        for rule in self.rules:
            state = self._states[rule.name]
            try:
                firing, value, detail = rule.evaluate(tl)
            except Exception as exc:  # a rule bug must not kill the tick
                firing, value, detail = False, None, f"rule error: {exc}"
            state.value, state.detail = value, detail
            if firing and not state.firing:
                state.firing = True
                state.since_mono, state.since_unix = now, wall
                state.fired_total += 1
                _ins.SLO_ALERTS_TOTAL.labels(rule.name, rule.severity).inc()
                _flight.record(
                    "slo.fire", rule.name, severity=rule.severity,
                    value=value, detail=detail[:200],
                )
                transitions.append({"rule": rule.name, "event": "fire"})
            elif state.firing and not firing:
                state.firing = False
                state.since_mono, state.since_unix = now, wall
                _flight.record("slo.clear", rule.name, severity=rule.severity)
                transitions.append({"rule": rule.name, "event": "clear"})
        return transitions

    def active(self) -> List[dict]:
        return [a for a in self.snapshot() if a["state"] == "firing"]

    def snapshot(self) -> List[dict]:
        """Every rule's current state, firing first — plain JSON-able
        (the Status payload form; crosses the restricted unpickler)."""
        out = []
        for rule in self.rules:
            s = self._states[rule.name]
            out.append({
                "rule": rule.name,
                "severity": rule.severity,
                "state": "firing" if s.firing else "ok",
                "since_unix": s.since_unix or None,
                "value": s.value,
                "detail": s.detail,
                "fired_total": s.fired_total,
            })
        out.sort(key=lambda a: (a["state"] != "firing",
                                SEVERITIES.index(a["severity"])
                                if a["severity"] in SEVERITIES else 9))
        return out


def active_alerts() -> List[dict]:
    """The global sampler's firing alerts ([] when the timeline — and so
    alerting — is off). The doctor and report surfaces read this."""
    from . import timeline as _timeline

    s = _timeline.sampler()
    if s is None or s.rulebook is None:
        return []
    return s.rulebook.active()


def alerts_snapshot() -> Optional[List[dict]]:
    """Every rule state, or None when alerting is off — the Status
    payload's ``alerts`` field."""
    from . import timeline as _timeline

    s = _timeline.sampler()
    if s is None or s.rulebook is None:
        return None
    return s.rulebook.snapshot()
