"""Open-loop traffic generator — the arrival process the front door will
be admitted against.

    python -m gol_distributed_final_tpu_torch.obs.loadgen :8040 \\
        -rate 100 -sessions 500 -tenants 30 -arrival poisson
    python -m gol_distributed_final_tpu_torch.obs.loadgen --loopback -rate 200
    python -m gol_distributed_final_tpu_torch.obs.loadgen --selfcheck -device cpu

``bench.py`` replays CLOSED-loop batches: the next unit of work waits for
the previous one, so the measured system is never behind — which is
exactly the regime real serving is not in. The ROADMAP's front-door gate
("p99 admission-to-first-turn at 10k+ concurrent sessions") needs an
**open-loop** generator: arrivals fire on the wall clock regardless of
completions (a deterministic seeded schedule — Poisson exponential
inter-arrivals or periodic bursts), so queueing delay is *measured*, not
hidden.

Each arrival is one ``Operations.SessionRun`` with a tenant-packed
``session_id`` (obs/accounting.py convention: tenant id in the high 32
bits, drawn uniform or zipf over ``-tenants``), issued on its own worker
thread over ONE multiplexed RpcClient. Two client-side latency
histograms merge into the registry (lint-enforced, README "Canary & load
harness"):

* ``gol_loadgen_admit_to_first_turn_seconds`` — arrival to the first
  turn being VISIBLE via the tagged retrieve poller (one shared thread
  round-robins the in-flight tags at ``think_s`` cadence; a session that
  drains before the poller sees it records its end-to-end wall — the
  honest upper bound, quantized by the poll cadence);
* ``gol_loadgen_session_seconds`` — arrival to the final board.

``gol_loadgen_sessions_total{outcome}`` counts ``ok`` / ``rejected`` /
``error``; rejects classify by the STRUCTURED reason the error envelope
now carries (``RpcError.reason`` — no string matching).

``--selfcheck`` is the ``scripts/check --loadgen`` gate: a loopback
broker, 30 tenants, mixed Poisson + burst arrivals, then the
reconciliation assert — the accounting ledger's per-tenant turn and
session totals must agree exactly with ``gol_session_turns_total`` /
``gol_sessions_admitted_total``, and its device-seconds with the
``gol_session_turn_seconds`` sum.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import random
import sys
import threading
import time
from typing import Dict, List, Optional

from . import accounting as _acct
from . import instruments as _ins

#: loadgen outcome labels (``gol_loadgen_sessions_total{outcome}``)
OUTCOMES = ("ok", "rejected", "error")

#: process-global session-nonce stream: tags must be unique across EVERY
#: run this process issues against a broker — a per-run index would
#: collide with the broker's finished-session snapshot cache, and the
#: first-turn poller would record a PREVIOUS run's final snapshot as a
#: near-zero admission latency
_nonce = itertools.count(1)


@dataclasses.dataclass
class LoadConfig:
    """One load shape. ``rate`` paces the arrival clock (sessions/s);
    ``arrival`` picks the process: ``poisson`` (exponential
    inter-arrivals) or ``burst`` (``burst`` simultaneous arrivals every
    ``burst/rate`` seconds). ``max_inflight`` is a safety bound on
    concurrent worker threads — past it the generator BLOCKS the arrival
    clock (documented closed-loop degradation; raise it rather than let
    a wedged broker spawn unbounded threads). ``tenant_dist`` spreads
    tags over ``tenants`` ids: ``uniform`` or ``zipf`` (weight 1/rank —
    the skew shape the doctor's hot-tenant finding exists for)."""

    rate: float = 50.0
    sessions: int = 100
    arrival: str = "poisson"  # "poisson" | "burst"
    burst: int = 10
    tenants: int = 4
    tenant_dist: str = "uniform"  # "uniform" | "zipf"
    size: int = 16
    turns: int = 16
    think_s: float = 0.002  # first-turn poll cadence
    timeout: float = 120.0
    seed: int = 0
    max_inflight: int = 1024

    def validate(self) -> None:
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.sessions < 1:
            raise ValueError(f"sessions must be >= 1, got {self.sessions}")
        if self.arrival not in ("poisson", "burst"):
            raise ValueError(f"arrival must be poisson|burst, got {self.arrival!r}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {self.tenants}")
        if self.tenant_dist not in ("uniform", "zipf"):
            raise ValueError(
                f"tenant_dist must be uniform|zipf, got {self.tenant_dist!r}"
            )
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}"
            )


def _quantiles_us(samples: List[float]) -> dict:
    """Exact client-side quantiles of a latency sample list, in µs (the
    embedded-bench form: p99_admit_to_first_turn_us etc.)."""
    if not samples:
        return {"n": 0}
    s = sorted(samples)

    def q(p: float) -> float:
        return s[min(len(s) - 1, int(p * len(s)))]

    return {
        "n": len(s),
        "mean_us": round(sum(s) / len(s) * 1e6, 1),
        "p50_us": round(q(0.50) * 1e6, 1),
        "p90_us": round(q(0.90) * 1e6, 1),
        "p99_us": round(q(0.99) * 1e6, 1),
        "max_us": round(s[-1] * 1e6, 1),
    }


class LoadGenerator:
    """One run of one ``LoadConfig`` against one broker address.
    ``on_reply(i, response)``, where given, sees each completed session's
    reply (its final board), e.g. to hold it against an oracle of
    ``board_for(i)``."""

    def __init__(self, address: str, config: LoadConfig, on_reply=None):
        from .status import norm_address

        config.validate()
        self.address = norm_address(address)
        self.config = config
        self._on_reply = on_reply
        self._lock = threading.Lock()
        self._outstanding: Dict[int, float] = {}  # tag -> submit t_mono
        self._first_turn: Dict[int, float] = {}  # tag -> latency_s
        self._e2e: List[float] = []
        self._outcomes: Dict[str, int] = {o: 0 for o in OUTCOMES}
        self._rejects: Dict[str, int] = {}
        self._per_tenant_issued: Dict[int, int] = {}

    # -- the arrival schedule (deterministic per seed) ---------------------

    def _schedule(self) -> List[float]:
        cfg = self.config
        rng = random.Random(cfg.seed)
        times: List[float] = []
        if cfg.arrival == "poisson":
            t = 0.0
            for _ in range(cfg.sessions):
                t += rng.expovariate(cfg.rate)
                times.append(t)
        else:  # burst: `burst` simultaneous arrivals, rate-paced groups
            interval = cfg.burst / cfg.rate
            for i in range(cfg.sessions):
                times.append((i // cfg.burst) * interval)
        return times

    def _tenants_for(self) -> List[int]:
        cfg = self.config
        rng = random.Random(cfg.seed ^ 0x7E7A)
        ids = list(range(1, cfg.tenants + 1))
        if cfg.tenant_dist == "uniform":
            return [rng.choice(ids) for _ in range(cfg.sessions)]
        weights = [1.0 / rank for rank in range(1, cfg.tenants + 1)]
        return rng.choices(ids, weights=weights, k=cfg.sessions)

    def board_for(self, i: int):
        import numpy as np

        cfg = self.config
        rng = np.random.default_rng((cfg.seed << 16) ^ i)
        return np.where(
            rng.random((cfg.size, cfg.size)) < 0.3, 255, 0
        ).astype(np.uint8)

    # -- one session -------------------------------------------------------

    def _session(self, client, i: int, tenant: int, slots) -> None:
        from ..rpc.client import RpcError
        from ..rpc.protocol import Methods, Request

        cfg = self.config
        tag = _acct.make_tag(tenant, next(_nonce))
        t0 = time.monotonic()
        with self._lock:
            self._outstanding[tag] = t0
        try:
            res = client.call(
                Methods.SESSION_RUN,
                Request(
                    world=self.board_for(i), turns=cfg.turns,
                    image_height=cfg.size, image_width=cfg.size,
                    threads=1, session_id=tag,
                ),
                timeout=cfg.timeout,
            )
        except RpcError as exc:
            with self._lock:
                self._outstanding.pop(tag, None)
                if exc.kind == "SessionRejected":
                    # the structured reject reason (the error_reason
                    # envelope key): classification without string-matching
                    reason = exc.reason or "unknown"
                    self._outcomes["rejected"] += 1
                    self._rejects[reason] = self._rejects.get(reason, 0) + 1
                else:
                    self._outcomes["error"] += 1
            _ins.LOADGEN_SESSIONS_TOTAL.labels(
                "rejected" if exc.kind == "SessionRejected" else "error"
            ).inc()
            return
        except Exception:
            with self._lock:
                self._outstanding.pop(tag, None)
                self._outcomes["error"] += 1
            _ins.LOADGEN_SESSIONS_TOTAL.labels("error").inc()
            return
        finally:
            slots.release()
        e2e = time.monotonic() - t0
        if self._on_reply is not None:
            self._on_reply(i, res)
        with self._lock:
            self._outstanding.pop(tag, None)
            self._e2e.append(e2e)
            self._outcomes["ok"] += 1
            if tag not in self._first_turn:
                # drained before the poller saw turn 1: the end-to-end
                # wall is the honest (poll-cadence-quantized) upper bound
                self._first_turn[tag] = e2e
        _ins.LOADGEN_SESSIONS_TOTAL.labels("ok").inc()
        _ins.LOADGEN_SESSION_SECONDS.observe(e2e)
        _ins.LOADGEN_ADMIT_TO_FIRST_TURN_SECONDS.observe(
            self._first_turn[tag]
        )

    def _first_turn_poller(self, client, done: threading.Event) -> None:
        """ONE shared thread round-robins the outstanding tags with
        count-only tagged retrieves: the first poll that sees
        ``turns_completed >= 1`` records that session's
        admission-to-first-turn latency. A completed tag still answers
        (the scheduler's finished-snapshot cache); only a
        NOT-YET-ADMITTED tag errors, and those polls back off per tag —
        the generator's own probing must not burn the server's
        rpc-error-ratio budget."""
        from ..rpc.client import RpcError
        from ..rpc.protocol import Methods, Request

        cfg = self.config
        not_before: Dict[int, float] = {}  # tag -> (next poll, backoff)
        backoff: Dict[int, float] = {}
        while not done.wait(cfg.think_s):
            now = time.monotonic()
            with self._lock:
                pending = [
                    (tag, t0) for tag, t0 in self._outstanding.items()
                    if tag not in self._first_turn
                    and not_before.get(tag, 0.0) <= now
                ]
            for tag, t0 in pending:
                try:
                    snap = client.call(
                        Methods.RETRIEVE,
                        Request(include_world=False, session_id=tag),
                        timeout=5.0,
                    )
                except RpcError:
                    # not yet admitted: back this tag off (25 ms
                    # doubling to 200 ms) instead of erroring every round
                    b = min(0.2, backoff.get(tag, 0.0125) * 2)
                    backoff[tag] = b
                    not_before[tag] = time.monotonic() + b
                    continue
                except OSError:
                    return
                backoff.pop(tag, None)
                not_before.pop(tag, None)
                if snap.turns_completed >= 1:
                    with self._lock:
                        if tag not in self._first_turn:
                            self._first_turn[tag] = time.monotonic() - t0

    # -- the run -----------------------------------------------------------

    def run(self) -> dict:
        """Issue the whole schedule, wait for every session, and return
        the summary dict (also printed as the CLI's JSON line)."""
        from ..rpc.client import RpcClient

        cfg = self.config
        client = RpcClient(self.address, timeout=10.0)
        done = threading.Event()
        poller = threading.Thread(
            target=self._first_turn_poller, args=(client, done),
            name="gol-loadgen-poll", daemon=True,
        )
        poller.start()
        slots = threading.Semaphore(cfg.max_inflight)
        schedule = self._schedule()
        tenants = self._tenants_for()
        threads: List[threading.Thread] = []
        t_start = time.monotonic()
        try:
            for i, (at, tenant) in enumerate(zip(schedule, tenants)):
                # open loop: sleep to the ARRIVAL time, never to a completion
                delay = t_start + at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                slots.acquire()  # the documented safety bound
                self._per_tenant_issued[tenant] = (
                    self._per_tenant_issued.get(tenant, 0) + 1
                )
                t = threading.Thread(
                    target=self._session, args=(client, i, tenant, slots),
                    name=f"gol-loadgen-{i}", daemon=True,
                )
                t.start()
                threads.append(t)
            deadline = time.monotonic() + cfg.timeout
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            wall = time.monotonic() - t_start
        finally:
            done.set()
            poller.join(timeout=2.0)
            client.close()
        hung = sum(1 for t in threads if t.is_alive())
        with self._lock:
            completed = self._outcomes["ok"]
            summary = {
                "schema": "gol-loadgen/1",
                "address": self.address,
                "config": dataclasses.asdict(cfg),
                "issued": len(threads),
                "completed": completed,
                "rejected": dict(sorted(self._rejects.items())),
                "rejected_total": self._outcomes["rejected"],
                "errors": self._outcomes["error"] + hung,
                "hung": hung,
                "wall_s": round(wall, 4),
                "sessions_per_s": round(completed / wall, 2) if wall > 0 else None,
                "universe_turns": completed * cfg.turns,
                "admit_to_first_turn": _quantiles_us(
                    list(self._first_turn.values())
                ),
                "session_e2e": _quantiles_us(list(self._e2e)),
                "per_tenant_issued": {
                    str(t): n
                    for t, n in sorted(self._per_tenant_issued.items())
                },
            }
        return summary


def _selfcheck(device: str = "cuda") -> int:
    """``scripts/check --loadgen``: loopback broker on ``device`` (the
    card unless "cpu"), 30 tenants, mixed
    Poisson + burst arrival, then the ledger-vs-metrics reconciliation
    (the acceptance contract: per-tenant turn/session totals agree
    EXACTLY with the session counters; device-seconds with the chunk
    walls the latency histogram recorded)."""
    from . import metrics as _metrics
    from .status import scalar_value, series_map
    from ..rpc.broker import serve

    _metrics.registry().reset()
    _acct.ledger().reset()
    _metrics.enable()
    server, service = serve(port=0, session_capacity=256, device=device)
    addr = f"127.0.0.1:{server.port}"
    failures: List[str] = []
    try:
        for arrival in ("poisson", "burst"):
            cfg = LoadConfig(
                rate=400.0, sessions=40, arrival=arrival, burst=8,
                tenants=30, tenant_dist="zipf", size=16, turns=8,
                seed=3 if arrival == "poisson" else 4,
            )
            summary = LoadGenerator(addr, cfg).run()
            print(json.dumps(summary), flush=True)
            if summary["completed"] + summary["rejected_total"] + summary[
                "errors"
            ] != summary["issued"]:
                failures.append(f"{arrival}: outcomes do not sum to issued")
            if summary["errors"]:
                failures.append(
                    f"{arrival}: {summary['errors']} session error(s)"
                )
        snap = _metrics.registry().snapshot()
        win = _acct.ledger().window()
        totals = win.get("totals") or {}
        turns_metric = scalar_value(snap, "gol_session_turns_total") or 0
        admitted = scalar_value(snap, "gol_sessions_admitted_total") or 0
        if totals.get("turns") != int(turns_metric):
            failures.append(
                f"ledger turns {totals.get('turns')} != "
                f"gol_session_turns_total {int(turns_metric)}"
            )
        if totals.get("sessions") != int(admitted):
            failures.append(
                f"ledger sessions {totals.get('sessions')} != "
                f"gol_sessions_admitted_total {int(admitted)}"
            )
        hist = series_map(snap, "gol_session_turn_seconds").get(()) or {}
        dev = totals.get("device_seconds") or 0.0
        hsum = hist.get("sum") or 0.0
        if abs(dev - hsum) > 1e-6 + 1e-6 * max(dev, hsum):
            failures.append(
                f"ledger device-seconds {dev} != "
                f"gol_session_turn_seconds sum {hsum}"
            )
        tracked = win.get("tracked") or 0
        if tracked > _acct.ledger().top_k:
            failures.append(f"ledger tracked {tracked} tenants past top_k")
        if not (win.get("other") or {}).get("sessions"):
            failures.append(
                "30 tenants at top_k=16 left the 'other' bucket empty — "
                "the cardinality bound did not engage"
            )
        if failures:
            for f in failures:
                print(f"loadgen selfcheck FAILED: {f}", file=sys.stderr)
            return 1
        print(
            f"loadgen selfcheck ok: {int(admitted)} sessions over 30 "
            f"tenants, ledger reconciles ({totals.get('turns')} turns, "
            f"{dev:.4f} device-seconds, {tracked} tracked + other)"
        )
        return 0
    finally:
        service.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="open-loop session traffic generator (Poisson/burst "
        "arrivals, tenant-tagged, client-side latency histograms)"
    )
    parser.add_argument(
        "address", nargs="?", default=None,
        help="broker host:port (tcp:// prefix and :port shorthand accepted)",
    )
    parser.add_argument("-rate", type=float, default=50.0, metavar="PER_S")
    parser.add_argument("-sessions", type=int, default=100, metavar="N")
    parser.add_argument(
        "-arrival", choices=("poisson", "burst"), default="poisson",
    )
    parser.add_argument("-burst", type=int, default=10, metavar="N")
    parser.add_argument("-tenants", type=int, default=4, metavar="N")
    parser.add_argument(
        "-tenant-dist", dest="tenant_dist", choices=("uniform", "zipf"),
        default="uniform",
    )
    parser.add_argument("-size", type=int, default=16, metavar="CELLS")
    parser.add_argument("-turns", type=int, default=16)
    parser.add_argument(
        "-think", dest="think_s", type=float, default=0.002, metavar="SECS",
        help="first-turn poll cadence (default 2 ms)",
    )
    parser.add_argument("-timeout", type=float, default=120.0, metavar="SECS")
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument(
        "-max-inflight", dest="max_inflight", type=int, default=1024,
    )
    parser.add_argument(
        "--loopback", action="store_true",
        help="spin an in-process broker and run the load against it",
    )
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="loopback smoke + ledger reconciliation (the scripts/check "
             "--loadgen gate)",
    )
    parser.add_argument(
        "-device", default="cuda",
        help="the --loopback / --selfcheck broker's device: cuda "
             "(default; fails without a card) or cpu",
    )
    args = parser.parse_args(argv)
    if args.selfcheck:
        return _selfcheck(args.device)
    from . import metrics as _metrics

    _metrics.enable()  # the client-side histograms must record
    server = service = None
    address = args.address
    if args.loopback:
        from ..rpc.broker import serve

        server, service = serve(port=0, session_capacity=1024, device=args.device)
        address = f"127.0.0.1:{server.port}"
    elif not address:
        parser.error("an address is required (or --loopback / --selfcheck)")
    cfg = LoadConfig(
        rate=args.rate, sessions=args.sessions, arrival=args.arrival,
        burst=args.burst, tenants=args.tenants,
        tenant_dist=args.tenant_dist, size=args.size, turns=args.turns,
        think_s=args.think_s, timeout=args.timeout, seed=args.seed,
        max_inflight=args.max_inflight,
    )
    try:
        summary = LoadGenerator(address, cfg).run()
    finally:
        if service is not None:
            service.shutdown()
    print(json.dumps(summary))
    return 0 if not summary["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
