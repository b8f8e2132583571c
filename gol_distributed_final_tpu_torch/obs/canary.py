"""Blackbox canary prober — continuous end-to-end CORRECTNESS probing.

    python -m gol_distributed_final_tpu_torch.obs.canary :8040            # forever
    python -m gol_distributed_final_tpu_torch.obs.canary :8040 -once
    python -m gol_distributed_final_tpu_torch.obs.canary :8040 -verb run
    python -m gol_distributed_final_tpu_torch.obs.canary --selfcheck   # on the card
    python -m gol_distributed_final_tpu_torch.obs.canary --selfcheck -device cpu

Every defense so far is WHITE-box: integrity digests verify what the
workers claim, SLO rules watch the metrics the code emits. None of them
would notice a serving path that is *silently wrong end to end* — a stale
kernel, a bad resplit, a session demux bug that hands tenant A tenant B's
board. The canary is the blackbox closure: a daemon that continuously
drives a tiny KNOWN-ORACLE universe through the full client path —
admission → turns → tagged mid-flight retrieve → final board — and
verifies **bit-exactness** against an independent numpy oracle (the same
``np.roll`` math as ``tests/oracle.vector_step``, inlined so the prober
ships with the package). A wrong bit anywhere pages within one probe
period (the ``canary-failure`` SLO rule) instead of being discovered by a
user.

Probe verbs:

* ``session`` (default) — ``Operations.SessionRun`` tagged with the
  canary's tenant (``CANARY_TENANT`` high bits, see obs/accounting.py),
  with a concurrent tagged ``RetrieveCurrentData`` mid-flight: the
  retrieve's ``(turn, alive)`` must match the oracle's count AT that
  turn (the per-session demux contract), and the final board must be
  bit-exact. Safe to run against a serving broker: sessions never
  conflict with client traffic.
* ``run`` — the classic blocking ``Operations.Run``: exercises the
  backend data plane itself (scatter / resident strips on a workers
  broker). Opt-in: a broker serves ONE Run at a time, so this verb
  would collide with real single-board traffic.

Metrics (lint-enforced, README "Canary & load harness"):
``gol_canary_probes_total{result}`` (``ok`` / ``corrupt`` — wrong bits
served — / ``error`` — the path failed loudly) and
``gol_canary_latency_seconds`` (probe round-trip). Failures also land a
``canary.fail`` flight event for the doctor.

The broker's ``-canary [SECS]`` flag runs this prober in-process against
its own loopback port (full RPC path through the real server socket);
``scripts/check --canary`` runs ``--selfcheck`` — one loopback probe,
bit-exact or nonzero exit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import sys
import threading
import time
from typing import List, Optional, Tuple

from . import flight as _flight
from . import instruments as _ins

logger = logging.getLogger(__name__)

#: the canary's tenant id (the ``session_id`` high bits — 0xCA): its
#: usage shows up in the accounting ledger like any tenant's
CANARY_TENANT = 0xCA

#: stable result-label set of ``gol_canary_probes_total``
RESULTS = ("ok", "corrupt", "error")

_nonce = itertools.count(1)


def _oracle_evolve(board, turns: int) -> Tuple[object, List[int]]:
    """``(final board, alive count per turn 0..turns)`` by the
    independent numpy oracle (tests/oracle.vector_step's math, inlined:
    obs/ must not import the test tree)."""
    import numpy as np

    b = (np.asarray(board) != 0).astype(np.int32)
    counts = [int(b.sum())]
    for _ in range(turns):
        n = sum(
            np.roll(np.roll(b, dy, 0), dx, 1)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)
        )
        b = ((n == 3) | ((b == 1) & (n == 2))).astype(np.int32)
        counts.append(int(b.sum()))
    return (b * 255).astype(np.uint8), counts


def canary_board(size: int, seed: int, round_no: int):
    """Deterministic probe universe: same (seed, round) → same board, so
    a failing probe replays exactly."""
    import numpy as np

    rng = np.random.default_rng((seed << 20) ^ round_no)
    return np.where(rng.random((size, size)) < 0.35, 255, 0).astype(np.uint8)


class CanaryProber:
    """One prober: a reusable client plus an optional daemon loop."""

    def __init__(
        self,
        address: str,
        *,
        period: float = 5.0,
        size: int = 16,
        turns: int = 16,
        verb: str = "session",
        timeout: float = 60.0,
        seed: int = 0,
        tenant: int = CANARY_TENANT,
    ):
        from .status import norm_address

        if verb not in ("session", "run"):
            raise ValueError(f"verb must be 'session' or 'run', got {verb!r}")
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        self.address = norm_address(address)
        self.period = period
        self.size = size
        self.turns = turns
        self.verb = verb
        self.timeout = timeout
        self.seed = seed
        self.tenant = tenant
        self._round = 0
        self._client = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _connect(self):
        from ..rpc.client import RpcClient

        if self._client is None:
            self._client = RpcClient(
                self.address, timeout=10.0, reconnect=True
            )
        return self._client

    # -- one probe ---------------------------------------------------------

    def probe_once(self) -> dict:
        """Drive one known-oracle universe through the full path and
        verify it. Returns ``{"result", "verb", "round", "latency_s",
        "detail"}`` and meters ``gol_canary_probes_total{result}`` +
        ``gol_canary_latency_seconds`` either way."""
        self._round += 1
        round_no = self._round
        board = canary_board(self.size, self.seed, round_no)
        want, counts = _oracle_evolve(board, self.turns)
        t0 = time.monotonic()
        try:
            if self.verb == "session":
                result, detail = self._probe_session(board, want, counts)
            else:
                result, detail = self._probe_run(board, want, counts)
        except Exception as exc:  # transport/reply failure: loud, not wrong
            result, detail = "error", f"{type(exc).__name__}: {exc}"
        latency = time.monotonic() - t0
        _ins.CANARY_PROBES_TOTAL.labels(result).inc()
        _ins.CANARY_LATENCY_SECONDS.observe(latency)
        if result != "ok":
            _flight.record(
                "canary.fail", self.address, result=result,
                detail=str(detail)[:200],
            )
            logger.error(
                "CANARY %s (%s verb, round %d): %s",
                result, self.verb, round_no, detail,
            )
        return {
            "result": result,
            "verb": self.verb,
            "round": round_no,
            "latency_s": round(latency, 6),
            "detail": detail,
        }

    def _verify_board(self, got, want) -> Optional[str]:
        import numpy as np

        if got is None:
            return "final board missing from the reply"
        got = np.asarray(got)
        if got.shape != want.shape:
            return f"final board shape {got.shape} != {want.shape}"
        if not np.array_equal(got, want):
            bad = int(np.count_nonzero(got != want))
            return (
                f"final board diverges from the oracle in {bad} cell(s) "
                f"after {self.turns} turns"
            )
        return None

    def _probe_session(self, board, want, counts) -> Tuple[str, str]:
        """SessionRun + a concurrent tagged retrieve: the blocking call
        parks a helper thread while this one polls the per-session
        snapshot — exactly the two-threaded client shape real tenants
        use. Mid-flight ``(turn, alive)`` must match the oracle AT that
        turn; the final board must be bit-exact."""
        from . import accounting as _acct
        from ..rpc.client import RpcError
        from ..rpc.protocol import Methods, Request

        client = self._connect()
        tag = _acct.make_tag(self.tenant, next(_nonce))
        req = Request(
            world=board, turns=self.turns,
            image_height=self.size, image_width=self.size,
            threads=1, session_id=tag,
        )
        box: dict = {}

        def runner():
            try:
                box["res"] = client.call(
                    Methods.SESSION_RUN, req, timeout=self.timeout
                )
            except Exception as exc:
                box["exc"] = exc

        t = threading.Thread(target=runner, name="gol-canary-run", daemon=True)
        t.start()
        midflight = None
        deadline = time.monotonic() + self.timeout
        # head start: the SessionRun frame must reach the scheduler
        # before the first tagged poll, or the poll eats an expected
        # "no session with tag" error reply — noise in the very
        # error-ratio budget the canary exists to protect
        t.join(timeout=0.02)
        while t.is_alive() and time.monotonic() < deadline:
            try:
                snap = client.call(
                    Methods.RETRIEVE,
                    Request(include_world=False, session_id=tag),
                    timeout=5.0,
                )
            except RpcError:
                # not yet admitted, or already finished: both fine — a
                # tiny universe can drain between our two calls
                pass
            else:
                turn = snap.turns_completed
                if not 0 <= turn <= self.turns:
                    midflight = (
                        f"tagged retrieve reports turn {turn} outside "
                        f"[0, {self.turns}]"
                    )
                elif snap.alive_count != counts[turn]:
                    midflight = (
                        f"tagged retrieve at turn {turn} counts "
                        f"{snap.alive_count} alive, oracle says "
                        f"{counts[turn]}"
                    )
            t.join(timeout=0.005)
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            return "error", f"SessionRun did not return within {self.timeout}s"
        if "exc" in box:
            raise box["exc"]
        res = box.get("res")
        bad = self._verify_board(getattr(res, "world", None), want)
        if bad is None and res.alive_count != counts[self.turns]:
            bad = (
                f"final alive count {res.alive_count} != oracle "
                f"{counts[self.turns]}"
            )
        if bad is None and midflight is not None:
            bad = midflight
        return ("corrupt", bad) if bad else ("ok", "")

    def _probe_run(self, board, want, counts) -> Tuple[str, str]:
        """The classic blocking Run — the backend data plane end to end
        (on a workers broker: scatter / resident strips, the path an
        ``-integrity off`` deployment leaves undefended)."""
        from ..rpc.protocol import Methods, Request

        client = self._connect()
        res = client.call(
            Methods.BROKER_RUN,
            Request(
                world=board, turns=self.turns,
                image_height=self.size, image_width=self.size, threads=0,
            ),
            timeout=self.timeout,
        )
        bad = self._verify_board(getattr(res, "world", None), want)
        if bad is None and res.alive_count != counts[self.turns]:
            bad = (
                f"final alive count {res.alive_count} != oracle "
                f"{counts[self.turns]}"
            )
        return ("corrupt", bad) if bad else ("ok", "")

    # -- the daemon loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gol-canary", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
        if self._client is not None:
            self._client.close()
            self._client = None

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.probe_once()
            except Exception:  # the prober must outlive any probe bug
                logger.exception("canary probe crashed")


def _selfcheck(device: str = "cuda") -> int:
    """The ``scripts/check --canary`` smoke: loopback broker on ``device``
    (the card unless "cpu"), ONE probe round-trip, bit-exact or nonzero
    exit — with the probe counters checked so a silently-unmetered
    canary cannot pass."""
    from . import metrics as _metrics
    from .status import series_map
    from ..rpc.broker import serve

    _metrics.registry().reset()
    _metrics.enable()
    server, service = serve(port=0, device=device)
    try:
        prober = CanaryProber(
            f"127.0.0.1:{server.port}", size=16, turns=16, verb="session"
        )
        try:
            out = prober.probe_once()
        finally:
            prober.stop()
        print(json.dumps(out))
        snap = _metrics.registry().snapshot()
        probes = series_map(snap, "gol_canary_probes_total")
        metered = (probes.get(("ok",)) or {}).get("value") or 0
        if out.get("result") != "ok":
            print(f"canary selfcheck FAILED: {out}", file=sys.stderr)
            return 1
        if metered != 1:
            print(
                "canary selfcheck FAILED: probe not metered "
                f"(gol_canary_probes_total{{ok}}={metered})",
                file=sys.stderr,
            )
            return 1
        print("canary selfcheck ok: one loopback probe, bit-exact")
        return 0
    finally:
        service.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="blackbox canary prober: known-oracle universes "
        "through the full RPC + session path, bit-exact or paged"
    )
    parser.add_argument(
        "address", nargs="?", default=None,
        help="broker host:port (tcp:// prefix and :port shorthand accepted)",
    )
    parser.add_argument(
        "-period", type=float, default=5.0, metavar="SECS",
        help="seconds between probes (default 5)",
    )
    parser.add_argument(
        "-count", type=int, default=0, metavar="N",
        help="stop after N probes (0 = forever); nonzero exit if any failed",
    )
    parser.add_argument(
        "-once", action="store_true", help="exactly one probe (== -count 1)",
    )
    parser.add_argument(
        "-verb", choices=("session", "run"), default="session",
        help="probe path: SessionRun + tagged retrieve (default; safe "
             "beside live traffic) or the classic blocking Run (opt-in: "
             "one Run at a time per broker)",
    )
    parser.add_argument("-size", type=int, default=16, metavar="CELLS")
    parser.add_argument("-turns", type=int, default=16)
    parser.add_argument("-timeout", type=float, default=60.0, metavar="SECS")
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="loopback broker + one probe (the scripts/check --canary gate)",
    )
    parser.add_argument(
        "-device", default="cuda",
        help="--selfcheck's broker: cuda (default; fails without a card) "
             "or cpu",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.selfcheck:
        return _selfcheck(args.device)
    if not args.address:
        parser.error("an address is required (or --selfcheck)")
    from . import metrics as _metrics

    _metrics.enable()  # the probe counters must record
    prober = CanaryProber(
        args.address, period=args.period, size=args.size, turns=args.turns,
        verb=args.verb, timeout=args.timeout, seed=args.seed,
    )
    count = 1 if args.once else args.count
    failures = 0
    try:
        n = 0
        while True:
            out = prober.probe_once()
            print(json.dumps(out), flush=True)
            if out.get("result") != "ok":
                failures += 1
            n += 1
            if count and n >= count:
                break
            time.sleep(args.period)
    except KeyboardInterrupt:
        pass
    finally:
        prober.stop()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
