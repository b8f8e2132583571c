"""Fleet collector: ONE address that speaks for many brokers.

    python -m gol_distributed_final_tpu_torch.obs.fleet tcp://hostA:8040 \
        tcp://hostB:8040 [-port 8050] [-interval SECS]

Every observability consumer before this module (obs/watch.py,
obs/doctor.py, the SLO rulebook, timeline rings, tenant ledger) polls
exactly one process at a time. The collector gives the CLUSTER its own
control-plane process, Podracer-style — out of the data plane's hot
loop — that scrapes every broker's read-only ``Status`` verb on a fixed
cadence, auto-discovers each broker's workers from the
``worker_health`` roster the broker already ships, and folds the fleet
into one model:

- **Exact metric merge.** ``metrics.merge_snapshots`` is the primitive:
  merged counters equal the arithmetic SUM of per-process snapshots,
  histograms per-bucket (fixed edges are the exactness contract). Only
  the CURRENT sweep's successful scrapes are merged, so a dead target
  leaves the merged totals within one sweep — the sums stay exactly
  equal to the sum of the SURVIVING targets' own snapshots. A snapshot
  the merge refuses (type/edge mismatch = version skew) is dropped and
  counted in ``gol_fleet_merge_failures_total``: skew degrades loudly,
  never wrongly.
- **Scrape health.** Per target: last-success age, consecutive-failure
  count, ok/error totals, last error string. A target whose
  last-success age passes ``STALE_INTERVALS`` sweeps is STALE — a dead
  broker is first-class data (a finding, a gauge, a firing rule), not a
  timeout traceback.
- **Fleet timeline + SLOs.** A private ``TimelineSampler`` samples the
  merged registry each sweep, and a ``RuleBook`` of the standard rules
  PLUS the fleet rules (``target-down``, ``fleet-capacity-headroom``,
  ``fleet-tenant-skew`` — obs/slo.py ``fleet_rules``) evaluates over
  the merged series.
- **Incremental cursors.** The four ``*_since`` cursors
  (timeline/accounting/journal/profile) are tracked and echoed PER
  TARGET, so N targets ship deltas, not full windows, every sweep. A
  target restart (pid change) resets its cursors to 0.

The collector serves its own read-only Status verb (same
``Operations.Status`` surface, ``role="fleet"``), so ``obs/watch.py``
and ``obs/doctor.py`` pointed at this ONE address render/diagnose the
whole fleet."""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from . import instruments as _ins
from . import metrics as _metrics
from .status import fetch_many, norm_address, scalar_value
from .timeline import RULE_HORIZON_S, TimelineSampler

# the gol_fleet_* families exist only where a collector can live: their
# registration rides this import so a plain broker/worker Status payload
# never carries them (the incremental-reply size budget counts every
# registered family, empty or not)
_ins.register_fleet_instruments()

SCHEMA = "gol-fleet/1"
DEFAULT_PORT = 8050
DEFAULT_INTERVAL = 5.0
# sweeps a target may miss before it is STALE (gol_fleet_targets_down,
# the target-down page) — one slow scrape is noise, three is an outage
STALE_INTERVALS = 3
_CURSOR_KEYS = (
    "timeline_since", "accounting_since", "journal_since", "profile_since",
)
_CURSOR_SOURCES = ("timeline", "accounting", "journal", "profile")


class _TargetHealth:
    """Scrape-health bookkeeping for one target address."""

    __slots__ = (
        "address", "worker", "via", "last_success_unix", "last_attempt_unix",
        "consecutive_failures", "ok_total", "err_total", "error", "pid",
    )

    def __init__(self, address: str, worker: bool, via: str):
        self.address = address
        self.worker = worker
        self.via = via  # "configured" or the discovering broker's address
        self.last_success_unix: Optional[float] = None
        self.last_attempt_unix: Optional[float] = None
        self.consecutive_failures = 0
        self.ok_total = 0
        self.err_total = 0
        self.error: Optional[str] = None
        self.pid: Optional[int] = None

    def state(self, now: float, stale_after: float) -> str:
        """``ok`` | ``failing`` | ``stale`` | ``pending`` — the operator
        word for this target. ``stale`` means the last-success age passed
        the bound (or it NEVER succeeded despite attempts): the fleet no
        longer has current truth about it."""
        if self.last_attempt_unix is None:
            return "pending"
        if self.consecutive_failures == 0:
            return "ok"
        if self.last_success_unix is None:
            return "stale"
        if now - self.last_success_unix > stale_after:
            return "stale"
        return "failing"

    def row(self, now: float, stale_after: float, cursors: dict) -> dict:
        return {
            "address": self.address,
            "worker": self.worker,
            "via": self.via,
            "state": self.state(now, stale_after),
            "last_success_age_s": (
                None if self.last_success_unix is None
                else round(now - self.last_success_unix, 3)
            ),
            "consecutive_failures": self.consecutive_failures,
            "ok_total": self.ok_total,
            "err_total": self.err_total,
            "error": self.error,
            # the incremental cursors echoed per address: what this
            # collector will send on the NEXT scrape of this target
            "cursors": dict(cursors),
        }


class _CompositeRegistry:
    """Registry-shaped adapter over the collector's merged cluster
    snapshot, so a stock ``TimelineSampler`` (which only needs
    ``.snapshot()``) can ring-buffer the FLEET's series."""

    def __init__(self, collector: "FleetCollector"):
        self._collector = collector

    def snapshot(self) -> dict:
        return self._collector.composite_snapshot()


class FleetCollector:
    """Scrapes many Status endpoints, merges them into one cluster
    model, and answers Status for the whole fleet.

    ``sweep(now=None, wall=None)`` is one full poll: fan-out fetch
    (``status.fetch_many`` — parallel, per-target timeout), roster
    auto-discovery, exact merge, fleet gauges, timeline sample, rule
    evaluation. The clock args are injectable so tests drive staleness
    and rule transitions deterministically."""

    def __init__(
        self,
        brokers,
        extra_workers=(),
        interval: float = DEFAULT_INTERVAL,
        timeout: float = 5.0,
    ):
        self.brokers = [norm_address(b) for b in brokers]
        self.extra_workers = [norm_address(w) for w in extra_workers]
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.stale_after = STALE_INTERVALS * self.interval
        self._lock = threading.Lock()
        self._health: Dict[str, _TargetHealth] = {}
        self._cursors: Dict[str, Dict[str, int]] = {}
        # workers each broker's roster named, kept across sweeps so a
        # dead broker's workers stay scraped (their health still matters)
        self._discovered: Dict[str, str] = {}  # worker addr -> via broker
        # latest SUCCESSFUL broker payloads from the CURRENT sweep only:
        # what watch renders per-broker panels from (a dead broker gets a
        # health row, not a panel of stale numbers)
        self._broker_status: Dict[str, dict] = {}
        # cumulative per-broker per-tenant device-seconds: the tenant
        # ledger ships INCREMENTAL windows (only tenants whose seq
        # moved), so skew needs last-known cumulative values cached
        self._tenant_dev: Dict[str, Dict[str, float]] = {}
        self._merge_excluded: Dict[str, str] = {}
        self._merged: dict = {"schema": "gol-metrics/1", "families": []}
        self._sweeps = 0
        from .slo import RuleBook, default_rules, fleet_rules

        self._timeline = TimelineSampler(
            registry=_CompositeRegistry(self),
            period=self.interval,
            capacity=max(360, int(RULE_HORIZON_S / self.interval) + 2),
        )
        # fleet-scope SLOs: the standard rulebook re-instantiated over
        # the MERGED series, plus the fleet-only rules
        self._timeline.attach_rulebook(
            RuleBook(list(default_rules()) + list(fleet_rules()))
        )

    @property
    def sweeps(self) -> int:
        """Completed sweep count (bench embeds it beside the scrape p99)."""
        with self._lock:
            return self._sweeps

    # -- target bookkeeping --------------------------------------------------

    def _target_specs(self) -> List[dict]:
        """Current scrape set: configured brokers, then extra workers,
        then roster-discovered workers — each with its echoed cursors."""
        specs = []
        seen = set()
        for addr in self.brokers:
            if addr in seen:
                continue
            seen.add(addr)
            self._health.setdefault(addr, _TargetHealth(addr, False, "configured"))
            specs.append({"address": addr, "worker": False,
                          **self._cursors.get(addr, {})})
        for addr, via in list(
            [(w, "configured") for w in self.extra_workers]
            + sorted(self._discovered.items())
        ):
            if addr in seen:
                continue
            seen.add(addr)
            self._health.setdefault(addr, _TargetHealth(addr, True, via))
            specs.append({"address": addr, "worker": True,
                          **self._cursors.get(addr, {})})
        return specs

    def _note_result(self, addr: str, payload, fetched_at, error) -> None:
        h = self._health[addr]
        h.last_attempt_unix = fetched_at
        if error is None:
            h.consecutive_failures = 0
            h.last_success_unix = fetched_at
            h.error = None
            h.ok_total += 1
            _ins.FLEET_SCRAPES_TOTAL.labels("ok").inc()
            pid = payload.get("pid")
            if isinstance(pid, int) and pid != h.pid:
                if h.pid is not None:
                    # restart: the server's seqs began again at 0 — a
                    # stale cursor would silently suppress its windows
                    self._cursors.pop(addr, None)
                h.pid = pid
            cur = self._cursors.setdefault(addr, {})
            for key, source in zip(_CURSOR_KEYS, _CURSOR_SOURCES):
                part = payload.get(source)
                seq = part.get("seq") if isinstance(part, dict) else None
                if isinstance(seq, int):
                    cur[key] = seq
        else:
            h.consecutive_failures += 1
            h.err_total += 1
            h.error = error
            _ins.FLEET_SCRAPES_TOTAL.labels("error").inc()

    def _discover(self, broker_addr: str, payload: dict) -> None:
        """Fold the broker's ``worker_health`` roster into the scrape
        set. LOST workers are kept: a worker the broker cannot reach may
        still answer Status, and its scrape health is exactly the
        evidence the doctor wants."""
        roster = payload.get("workers")
        if not isinstance(roster, list):
            return
        for entry in roster:
            if not isinstance(entry, dict):
                continue
            addr = entry.get("address")
            if not isinstance(addr, str) or ":" not in addr:
                continue
            addr = norm_address(addr)
            if addr in self.brokers or addr in self.extra_workers:
                continue
            self._discovered.setdefault(addr, broker_addr)

    # -- the sweep -----------------------------------------------------------

    def sweep(self, now: Optional[float] = None,
              wall: Optional[float] = None) -> dict:
        """One poll of the whole fleet. Returns the fleet section of the
        Status payload (handy for tests and ``-once``)."""
        wall = time.time() if wall is None else wall
        t0 = time.monotonic()
        with self._lock:
            specs = self._target_specs()
        results = fetch_many(specs, timeout=self.timeout)
        with self._lock:
            payloads: Dict[str, dict] = {}
            for spec in specs:
                addr = spec["address"]
                payload, fetched_at, error = results.get(
                    addr, (None, wall, "no result"))
                self._note_result(addr, payload, fetched_at, error)
                if payload is not None:
                    payloads[addr] = payload
                    if not self._health[addr].worker:
                        self._discover(addr, payload)
            self._merge(payloads)
            self._set_fleet_gauges(payloads, wall)
            self._broker_status = {
                a: p for a, p in payloads.items()
                if not self._health[a].worker
            }
            self._sweeps += 1
            _ins.FLEET_SCRAPE_SECONDS.observe(time.monotonic() - t0)
            fleet = self._fleet_section(wall)
        # sample OUTSIDE the collector lock: the sampler snapshots the
        # composite (which re-takes the lock) and runs the rulebook
        self._timeline.sample_once(now=now, wall=wall)
        return fleet

    def _merge(self, payloads: Dict[str, dict]) -> None:
        """Exact merge of the CURRENT sweep's snapshots. Exclusions
        (missing metrics = version skew, merge refusal = edge/type
        skew) are counted and named, never averaged in."""
        merged = {"schema": "gol-metrics/1", "families": []}
        excluded: Dict[str, str] = {}
        for addr in sorted(payloads):
            snap = payloads[addr].get("metrics")
            if not isinstance(snap, dict) or "families" not in snap:
                excluded[addr] = "payload carries no metrics snapshot (skew)"
                _ins.FLEET_MERGE_FAILURES_TOTAL.inc()
                continue
            try:
                merged = _metrics.merge_snapshots(merged, snap)
            except (ValueError, KeyError, TypeError) as exc:
                excluded[addr] = str(exc)
                _ins.FLEET_MERGE_FAILURES_TOTAL.inc()
        self._merged = merged
        self._merge_excluded = excluded

    def _set_fleet_gauges(self, payloads: Dict[str, dict],
                          wall: float) -> None:
        states = [
            h.state(wall, self.stale_after) for h in self._health.values()
        ]
        _ins.FLEET_TARGETS_TOTAL.set(float(len(states)))
        _ins.FLEET_TARGETS_DOWN.set(
            float(sum(1 for s in states if s == "stale")))
        sessions = 0.0
        capacity = 0.0
        for addr, payload in payloads.items():
            if self._health[addr].worker:
                continue
            v = scalar_value(payload.get("metrics") or {},
                             "gol_sessions_active")
            if isinstance(v, (int, float)):
                sessions += v
            cap = payload.get("session_capacity")
            if isinstance(cap, (int, float)):
                capacity += cap
            acct = payload.get("accounting")
            if isinstance(acct, dict):
                dev = self._tenant_dev.setdefault(addr, {})
                for row in acct.get("tenants") or []:
                    if isinstance(row, dict) and "tenant" in row:
                        ds = row.get("device_seconds")
                        if isinstance(ds, (int, float)):
                            dev[str(row["tenant"])] = float(ds)
        _ins.FLEET_SESSIONS_ACTIVE.set(sessions)
        _ins.FLEET_CAPACITY_TOTAL.set(capacity)
        _ins.FLEET_TENANT_SKEW.set(self._tenant_skew()[0])

    def _tenant_skew(self):
        """Worst cross-broker tenant skew from the cached cumulative
        ledgers: hottest broker's share of a tenant's fleet
        device-seconds, times the ledger-shipping broker count (1.0 =
        perfectly spread, N = all on one broker). ``(value, tenant,
        address)``; 0 until >=2 brokers have shipped ledgers."""
        ledgers = {a: d for a, d in self._tenant_dev.items() if d}
        if len(ledgers) < 2:
            return 0.0, None, None
        n = len(ledgers)
        worst = (0.0, None, None)
        tenants = set()
        for dev in ledgers.values():
            tenants.update(dev)
        for tenant in tenants:
            per = {a: d.get(tenant, 0.0) for a, d in ledgers.items()}
            total = sum(per.values())
            if total <= 0.0:
                continue
            hot = max(per, key=per.get)
            skew = per[hot] / total * n
            if skew > worst[0]:
                worst = (skew, tenant, hot)
        return worst

    # -- the cluster model, read out -----------------------------------------

    def composite_snapshot(self) -> dict:
        """The fleet registry: merged data-plane families from the
        targets, plus the collector's OWN ``gol_fleet_*`` families.
        Stripping ``gol_fleet_*`` from the merged side keeps the split
        clean even when a scraped process shares this registry (the
        in-process selfcheck); dropping the collector's other families
        keeps its own RPC-server counters out of the data-plane sums —
        scraping the fleet must not perturb the fleet's numbers."""
        with self._lock:
            merged = self._merged
        own = _metrics.registry().snapshot()
        families = [
            f for f in merged.get("families", [])
            if not str(f.get("name", "")).startswith("gol_fleet_")
        ]
        families.extend(
            f for f in own.get("families", [])
            if str(f.get("name", "")).startswith("gol_fleet_")
        )
        return {"schema": "gol-metrics/1", "families": families}

    def _fleet_section(self, now: float) -> dict:
        rows = [
            h.row(now, self.stale_after, self._cursors.get(a, {}))
            for a, h in sorted(self._health.items())
        ]
        skew, tenant, hot = self._tenant_skew()
        return {
            "schema": SCHEMA,
            "interval_s": self.interval,
            "stale_after_s": self.stale_after,
            "sweeps": self._sweeps,
            "targets": rows,
            "merge_excluded": dict(self._merge_excluded),
            "tenant_skew": {"value": skew, "tenant": tenant, "address": hot},
            "broker_status": dict(self._broker_status),
        }

    def status_payload(self, timeline_since: int = 0) -> dict:
        """The collector's own Status payload: ``role="fleet"``, the
        merged registry as ``metrics``, the fleet timeline window +
        alert states, and the ``fleet`` section (scrape health, cursors,
        per-broker payloads). Same ``gol-status/1`` envelope every
        Status consumer already parses."""
        with self._lock:
            fleet = self._fleet_section(time.time())
        payload = {
            "schema": "gol-status/1",
            "pid": os.getpid(),
            "time_unix": time.time(),
            "role": "fleet",
            "metrics_enabled": True,
            "metrics": self.composite_snapshot(),
            "timeline": self._timeline.window(since=timeline_since),
            "fleet": fleet,
        }
        rb = self._timeline.rulebook
        if rb is not None:
            payload["alerts"] = rb.snapshot()
        return payload


def serve(collector: FleetCollector, host: str = "127.0.0.1",
          port: int = DEFAULT_PORT):
    """Expose the collector's Status on its own RPC port. Both the
    broker-surface and worker-surface Status verbs are registered (and
    nothing else — the collector is read-only by construction), so any
    existing poller reaches it unchanged."""
    from ..rpc.protocol import Methods, Response
    from ..rpc.server import RpcServer

    server = RpcServer(host=host, port=port)

    def _status(req) -> Response:
        since = getattr(req, "timeline_since", 0)
        return Response(status=collector.status_payload(
            timeline_since=since if isinstance(since, int) else 0))

    server.register(Methods.STATUS, _status)
    server.register(Methods.WORKER_STATUS, _status)
    server.serve_background()
    return server


def _selfcheck(device: str = "cuda") -> int:
    """The ``scripts/check --fleet`` smoke: two loopback brokers on
    ``device`` (the card unless "cpu"), a tiny run on one, two collector sweeps, then every fleet consumer — exact
    merge pinned against the scraped payloads, watch renders the FLEET
    panel through the collector's OWN Status port, fleet doctor
    diagnoses through it."""
    import numpy as np

    from ..rpc.broker import serve as broker_serve
    from ..rpc.client import RpcClient
    from ..rpc.protocol import Methods, Request

    _metrics.enable()
    server_a, _svc_a = broker_serve(port=0, device=device)
    server_b, _svc_b = broker_serve(port=0, device=device)
    fleet_server = None
    try:
        addr_a = f"127.0.0.1:{server_a.port}"
        addr_b = f"127.0.0.1:{server_b.port}"
        rng = np.random.default_rng(11)
        board = np.where(rng.random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
        client = RpcClient(addr_a)
        try:
            client.call(
                Methods.BROKER_RUN,
                Request(world=board, turns=8, image_width=64,
                        image_height=64, threads=1),
                timeout=120.0,
            )
        finally:
            client.close()
        collector = FleetCollector([addr_a, addr_b], interval=0.2,
                                   timeout=10.0)
        collector.sweep()
        collector.sweep()
        payload = collector.status_payload()
        fleet = payload.get("fleet") or {}
        scraped = fleet.get("broker_status") or {}
        if set(scraped) != {addr_a, addr_b}:
            print("fleet selfcheck FAILED: not all brokers scraped: "
                  f"{sorted(scraped)}", file=sys.stderr)
            return 1
        # exactness: merged counter == arithmetic sum of the scraped
        # per-target snapshots (both brokers share this process's
        # registry, so the merged value is exactly 2x either)
        want = sum(
            scalar_value(p.get("metrics") or {}, "gol_engine_turns_total")
            or 0.0
            for p in scraped.values()
        )
        got = scalar_value(payload.get("metrics") or {},
                           "gol_engine_turns_total")
        if not want or got != want:
            print(f"fleet selfcheck FAILED: merged gol_engine_turns_total "
                  f"{got} != sum of targets {want}", file=sys.stderr)
            return 1
        fleet_server = serve(collector, port=0)
        fleet_addr = f"127.0.0.1:{fleet_server.port}"
        from .watch import Watcher

        frame, ok = Watcher(fleet_addr, [], timeout=10.0).frame()
        sys.stdout.write(frame + "\n")
        if not ok or "FLEET" not in frame:
            print("fleet selfcheck FAILED: watch at the collector did not "
                  "render a FLEET panel", file=sys.stderr)
            return 1
        from . import doctor as _doctor

        statuses = _doctor.collect(fleet_addr, [], timeout=10.0)
        findings = _doctor.diagnose(statuses)
        text = _doctor.render(findings, statuses)
        sys.stdout.write(text)
        if not findings or not text.strip():
            print("fleet selfcheck FAILED: empty fleet diagnosis",
                  file=sys.stderr)
            return 1
        print("fleet selfcheck ok")
        return 0
    finally:
        if fleet_server is not None:
            fleet_server.stop()
        server_a.stop()
        server_b.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="fleet Status collector: scrape many brokers, merge "
                    "exactly, serve one cluster-level Status"
    )
    parser.add_argument(
        "brokers", nargs="*",
        help="broker Status addresses (tcp://host:port, host:port, :port)",
    )
    parser.add_argument(
        "-worker", action="append", default=[], metavar="HOST:PORT",
        help="extra worker target beyond roster auto-discovery (repeatable)",
    )
    parser.add_argument(
        "-port", type=int, default=DEFAULT_PORT,
        help=f"port the collector's own Status listens on "
             f"(default {DEFAULT_PORT})",
    )
    parser.add_argument("-host", default="127.0.0.1")
    parser.add_argument(
        "-interval", type=float, default=DEFAULT_INTERVAL, metavar="SECS",
        help=f"scrape cadence (default {DEFAULT_INTERVAL}); staleness is "
             f"{STALE_INTERVALS} missed intervals",
    )
    parser.add_argument(
        "-timeout", type=float, default=5.0, metavar="SECONDS",
        help="per-target scrape bound (default 5); a wedged target costs "
             "one timeout, in parallel with the rest of the sweep",
    )
    parser.add_argument(
        "-once", action="store_true",
        help="one sweep, print the fleet Status payload as JSON, exit",
    )
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="loopback smoke over two in-process brokers (scripts/check "
             "--fleet)",
    )
    parser.add_argument(
        "-device", default="cuda",
        help="--selfcheck's brokers: cuda (default; fails without a card) "
             "or cpu",
    )
    args = parser.parse_args(argv)
    if args.selfcheck:
        return _selfcheck(args.device)
    if not args.brokers:
        parser.error("at least one broker address is required")
    _metrics.enable()
    collector = FleetCollector(
        args.brokers, extra_workers=args.worker,
        interval=args.interval, timeout=args.timeout,
    )
    if args.once:
        collector.sweep()
        print(json.dumps(collector.status_payload(), indent=1, default=str))
        return 0
    server = serve(collector, host=args.host, port=args.port)
    print(
        f"fleet collector on {args.host}:{server.port} scraping "
        f"{len(collector.brokers)} broker(s) every {args.interval}s",
        file=sys.stderr,
    )
    try:
        while True:
            t0 = time.time()
            collector.sweep()
            time.sleep(max(0.0, args.interval - (time.time() - t0)))
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
