"""Hang flight-recorder: a bounded ring of the last N structured events.

The SPMD rank-desync hang (ADVICE r5) and broker->worker fan-out stalls
leave no artifact: the process is alive, the metrics counters have simply
stopped moving, and the interesting question — what was the LAST thing
each process did — is unanswerable after the fact. This module answers it:

* every process keeps a ring buffer (``deque(maxlen=N)``) of structured
  events — span open/close (obs/tracing.py feeds these), RPC send/recv
  (rpc/client.py + rpc/server.py), checkpoint agreement votes
  (engine/engine.py) — each stamped with wall + monotonic clocks, pid,
  thread id, and a monotonically increasing sequence number;
* the ring is snapshotted into the ``Status`` verb payload, so a WEDGED
  run can be interrogated live from any surviving rank
  (``python -m gol_distributed_final_tpu_torch.obs.status host:port``);
* an unhandled engine exception dumps the ring to
  ``out/flight_<host>.jsonl`` before propagating (``dump_on_crash``), so
  a crashed rank leaves its last-events record on disk for post-mortem.

Like the registry and the tracer, recording is **off by default** and every
``record`` call is one flag check until the ``-trace`` flags opt in.
Events are plain JSON-able dicts: the ring must cross the restricted
unpickler inside Status replies and serialise to JSONL without help.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import threading
import time
from collections import deque

from ..utils import locksan as _locksan
from typing import List, Optional

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Thread-safe bounded event ring. ``record`` is the only hot-path
    surface: one flag check when disabled, one lock + deque append when
    enabled (the deque's maxlen does the eviction — no manual trimming)."""

    # ring + seq move together under the lock (analysis/locks.py)
    _GUARDED_BY = {"_ring": "_lock", "_seq": "_lock"}

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = False):
        self.enabled = enabled
        self._lock = _locksan.lock("FlightRecorder._lock")
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0

    @property
    def capacity(self) -> int:
        # gol: allow(lock-discipline): maxlen is fixed at construction —
        # reading it races nothing
        return self._ring.maxlen

    def record(self, kind: str, name: str, **args) -> None:
        """Append one event. ``kind`` is the event class (``span.open``,
        ``rpc.send``, ``ckpt.vote``, ...), ``name`` the specific site or
        verb, ``args`` small JSON-able details (never boards or frames)."""
        if not self.enabled:
            return
        event = {
            "kind": kind,
            "name": name,
            "t_unix": time.time(),
            "t_mono": time.monotonic(),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._ring.append(event)

    def snapshot(self) -> List[dict]:
        """The ring's current contents, oldest first — what the Status
        verb embeds. Copies are shallow: events are append-only records."""
        with self._lock:
            return list(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0

    def dump(self, path) -> pathlib.Path:
        """Write the ring as JSONL (one event per line, oldest first).
        Temp-name + atomic rename, like every other artifact writer."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        events = self.snapshot()
        tmp = path.with_name(path.name + ".tmp")
        with tmp.open("w") as f:
            for event in events:
                f.write(json.dumps(event, default=str) + "\n")
        tmp.replace(path)
        return path


# -- the process-global default recorder -------------------------------------

_DEFAULT = FlightRecorder(enabled=False)

# where dump_on_crash writes; entry points with an -out notion may redirect
_DUMP_DIR = "out"


def recorder() -> FlightRecorder:
    return _DEFAULT


def enable(on: bool = True) -> None:
    _DEFAULT.enabled = on


def enabled() -> bool:
    return _DEFAULT.enabled


def record(kind: str, name: str, **args) -> None:
    _DEFAULT.record(kind, name, **args)


def set_dump_dir(path) -> None:
    global _DUMP_DIR
    _DUMP_DIR = str(path)


def crash_dump_path(out_dir: Optional[str] = None) -> pathlib.Path:
    host = socket.gethostname() or "localhost"
    return pathlib.Path(out_dir or _DUMP_DIR) / f"flight_{host}.jsonl"


def dump_on_crash(exc: BaseException, out_dir: Optional[str] = None):
    """Best-effort post-mortem dump for an unhandled engine exception: the
    exception itself is recorded as the ring's final event, then the ring
    goes to ``out/flight_<host>.jsonl``. Never raises (a broken disk must
    not mask the original exception) and is a no-op while disabled.
    Returns the written path, or None."""
    if not _DEFAULT.enabled:
        return None
    try:
        _DEFAULT.record(
            "crash", type(exc).__name__, message=str(exc)[:500]
        )
        return _DEFAULT.dump(crash_dump_path(out_dir))
    except Exception as dump_exc:  # pragma: no cover - depends on disk state
        print(f"flight-recorder dump failed: {dump_exc}")
        return None
