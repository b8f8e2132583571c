"""Operator one-liner: snapshot a RUNNING broker or worker's metrics.

    python -m gol_distributed_final_tpu_torch.obs.status 127.0.0.1:8040
    python -m gol_distributed_final_tpu_torch.obs.status -worker 127.0.0.1:8030
    python -m gol_distributed_final_tpu_torch.obs.status -format prom :8040

Read-only: the ``Status`` verb snapshots the server's registry under its
lock and replies — it never touches the engine, the board, or the run
loop, so polling it mid-run is safe (unlike ``RetrieveCurrentData``, whose
full-world form costs a device->host transfer)."""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional


def norm_address(address: str) -> str:
    """Accept ``tcp://host:port``, ``host:port``, and ``:port`` — the one
    normalization every Status-surface CLI shares (doctor, canary,
    loadgen, watch, this module)."""
    if address.startswith("tcp://"):
        address = address[len("tcp://"):]
    if address.startswith(":"):
        address = "127.0.0.1" + address
    return address


def series_map(snap: dict, name: str) -> Dict[tuple, dict]:
    """``{labels_tuple: series_dict}`` for one family of a registry
    snapshot — the skew-safe reader every Status consumer (obs/watch.py
    panels, obs/doctor.py heuristics) shares: an absent family reads as
    empty, never a KeyError."""
    for fam in snap.get("families", []):
        if fam.get("name") == name:
            return {tuple(s.get("labels", ())): s for s in fam.get("series", [])}
    return {}


def scalar_value(snap: dict, name: str, labels: tuple = ()) -> Optional[float]:
    """One series' value from a snapshot, or None when absent."""
    s = series_map(snap, name).get(labels)
    return None if s is None else s.get("value")


class StatusUnavailable(RuntimeError):
    """The server answered, but no usable status payload came back. The
    message distinguishes the two distinct situations an operator needs
    to tell apart: an OLD server whose Response pickle predates the
    ``status`` field entirely, vs a current server that replied with an
    EMPTY payload."""


def extract_status(res) -> dict:
    """Classify a Status reply: the payload dict, or StatusUnavailable
    with a message naming WHICH failure mode this is. A missing attribute
    (old server's Response pickle) and a present-but-None field (handler
    never populated it) are the same operator situation — no payload —
    and share a message; an EMPTY dict is a different, current-server
    situation and gets its own."""
    status = getattr(res, "status", None)
    if status is None:
        raise StatusUnavailable(
            "server predates the Status payload (reply carries no status "
            "field) — upgrade the server, or you are polling a non-Status "
            "verb"
        )
    if not status:
        raise StatusUnavailable(
            "server knows the Status verb but replied with an EMPTY "
            "payload — unexpected server state, not version skew"
        )
    return status


def fetch_status(
    address: str,
    worker: bool = False,
    timeout: float = 10.0,
    timeline_since: int = 0,
    accounting_since: int = 0,
    journal_since: int = 0,
    profile_since: int = 0,
) -> dict:
    """One Status round-trip against a broker (default) or worker.

    ``timeline_since`` echoes the last timeline seq this poller received
    (``payload["timeline"]["seq"]``) so a ``-timeline`` server ships
    only NEWER samples — the incremental-window contract; 0 asks for the
    full ring, and a pre-timeline server ignores the field entirely.
    ``accounting_since`` is the tenant ledger's twin (broker only): a
    ``-accounting`` broker ships only ledger deltas past this seq.
    ``journal_since`` is the lifecycle journal's twin (obs/journal.py):
    a ``-journal`` server ships only events past this seq.
    ``profile_since`` is the continuous profiler's twin
    (obs/profiler.py): a ``-profile`` server ships only frames whose
    hit counts moved past this seq.

    Raises ``StatusUnavailable`` (with a mode-specific message, see
    ``extract_status``) instead of returning an empty dict, so callers
    and operators can tell "old server" from "empty reply" apart."""
    from ..rpc.client import RpcClient
    from ..rpc.protocol import Methods, Request

    address = norm_address(address)
    client = RpcClient(address, timeout=timeout)
    try:
        # timeout bounds the REPLY wait too, not just the connect: a
        # wedged server must fail this poller, never hang it
        res = client.call(
            Methods.WORKER_STATUS if worker else Methods.STATUS,
            Request(
                timeline_since=timeline_since,
                accounting_since=accounting_since,
                journal_since=journal_since,
                profile_since=profile_since,
            ),
            timeout=timeout,
        )
    finally:
        client.close()
    return extract_status(res)


def fetch_many(
    targets,
    timeout: float = 10.0,
) -> Dict[str, tuple]:
    """Parallel Status fan-out: one thread per target, each bounded by
    its own ``timeout``, so a single wedged target costs ONE timeout
    instead of stacking sequentially across the whole poll (the failure
    mode a fleet-of-N collector cannot afford).

    ``targets`` is an iterable of dicts, each at least
    ``{"address": ...}`` plus optional ``worker`` (bool) and the four
    ``*_since`` cursor fields — the same kwargs ``fetch_status`` takes.

    Returns ``{address: (payload, fetched_at, error)}`` keyed by the
    NORMALIZED address: exactly one of ``payload``/``error`` is non-None,
    and ``fetched_at`` is the local wall clock at reply (or failure) —
    the raw material for scrape-health bookkeeping (last-success age,
    consecutive failures). Errors are captured as strings, never raised:
    a dead target is DATA to a fleet consumer, not an exception."""
    import threading
    import time as _time

    specs = []
    for t in targets:
        spec = dict(t)
        spec["address"] = norm_address(spec["address"])
        specs.append(spec)
    results: Dict[str, tuple] = {}
    lock = threading.Lock()

    def one(spec: dict) -> None:
        addr = spec["address"]
        try:
            payload = fetch_status(
                addr,
                worker=bool(spec.get("worker", False)),
                timeout=timeout,
                timeline_since=int(spec.get("timeline_since", 0)),
                accounting_since=int(spec.get("accounting_since", 0)),
                journal_since=int(spec.get("journal_since", 0)),
                profile_since=int(spec.get("profile_since", 0)),
            )
            with lock:
                results[addr] = (payload, _time.time(), None)
        except Exception as exc:
            with lock:
                results[addr] = (None, _time.time(), str(exc) or type(exc).__name__)

    threads = [
        threading.Thread(target=one, args=(s,), daemon=True) for s in specs
    ]
    for th in threads:
        th.start()
    for th in threads:
        # join is bounded: fetch_status itself times out, so a small
        # grace on top covers thread scheduling, never a hung socket
        th.join(timeout + 5.0)
    with lock:
        for s in specs:
            # a thread that somehow outlived its bounded join still
            # yields a result row — consumers never KeyError on a target
            results.setdefault(
                s["address"], (None, _time.time(), "fetch thread timed out")
            )
        return dict(results)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="snapshot a running broker/worker's metrics registry"
    )
    parser.add_argument("address", help="host:port (or :port for loopback)")
    parser.add_argument(
        "-worker", action="store_true",
        help="query a worker's GameOfLifeOperations.Status instead of the "
             "broker's Operations.Status",
    )
    parser.add_argument(
        "-format", choices=("json", "prom"), default="json",
        help="json: the full status payload; prom: Prometheus text "
             "exposition of the metrics snapshot",
    )
    parser.add_argument(
        "-timeout", type=float, default=10.0, metavar="SECONDS",
        help="bound on connect AND reply wait (default 10); a wedged "
             "server fails the poll after this instead of hanging it",
    )
    args = parser.parse_args(argv)
    try:
        status = fetch_status(
            args.address, worker=args.worker, timeout=args.timeout
        )
    except StatusUnavailable as exc:
        print(f"no status: {exc}", file=sys.stderr)
        return 1
    except Exception as exc:
        print(f"status fetch failed: {exc}", file=sys.stderr)
        return 1
    if args.format == "prom":
        from .metrics import snapshot_to_prometheus

        sys.stdout.write(snapshot_to_prometheus(status.get("metrics", {})))
    else:
        print(json.dumps(status, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
