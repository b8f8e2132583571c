"""Durable universe lifecycle journal — HLC-stamped, crc-framed, rotated.

Every evidence store before this one is volatile and process-local: the
flight ring, the timeline rings, the tenant ledger and the critical-path
EWMAs all die with their process, so "what happened to universe X,
across its whole life, in what order across the broker and its workers?"
is unanswerable the moment a run ends. This module is the durable
substrate the persistent-universes tier (ROADMAP) admits against:

* **An append-only on-disk journal per process.** ``enable(role=...)``
  opens ``out/journal_<role>_<pid>.jsonl`` and a buffered writer thread;
  ``record(kind, name, **args)`` is the only hot-path surface — one
  global load and a branch while disabled, one lock + two deque appends
  while enabled (the Podracer posture, arXiv:2104.06272: history lives
  on the control path, never in the kernel hot loop). The bench prices
  it like timeline/attribution before it (``journal_overhead_pct``,
  gated <= 2% beyond the fits' noise band).
* **crc32-framed records** (rpc/integrity.py's frame-word API): each
  line is ``<crc32-hex> <json>`` with the crc computed over the json
  bytes, so a record torn by a crash mid-write — or a flipped byte in a
  cold segment — is DETECTED and skipped loudly by the reader
  (``read_segment`` returns the problems beside the events), never
  mis-parsed into a silently-wrong history.
* **Hybrid logical clock stamps.** Every record carries ``[physical_ms,
  logical, node]``; the process clock ticks on local events and merges
  remote stamps carried on the ``Request.hlc`` / ``Response.hlc``
  extension fields (rpc/client.py + rpc/server.py stamp every call both
  ways, getattr-skew-safe like ``trace_ctx``), so events from all
  processes merge into ONE causal order: a broker-side ``worker.lost``
  is always ordered after the worker events that caused it, even under
  wall-clock skew or regression between hosts. ``HLC_ORDER``/
  ``hlc_key`` are the shared sort contract (obs/history.py).
* **Bounded retention, drops metered never silent.** Segments rotate at
  ``rotate_bytes`` (active -> ``.g1`` -> ``.g2`` ..., the checkpoint
  generation-chain naming), keeping ``keep`` generations; a retired
  segment's record count and any write-queue overflow are counted on
  ``gol_journal_drops_total`` — bounded disk can lose history, but it
  can never lose it silently.
* **Incremental Status windows.** ``window(since=seq)`` ships only the
  tail events a poller has not seen (the ``Request.journal_since``
  extension field — the ``timeline_since`` pattern), so live processes
  are queryable (obs/history.py, the watch JOURNAL panel) and dead ones
  leave their segments for the same reader.

``EVENT_KINDS`` is the declared vocabulary: every lifecycle event kind
emitted anywhere in the tree must appear here (the registry-drift lint,
obs/lint.py ``lint-journal-kinds``) with a one-line meaning — the table
the README section and the history renderer share.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..rpc import integrity as _integrity
from ..utils import locksan as _locksan
from . import instruments as _ins

SCHEMA = "gol-journal/1"

#: rotate the active segment past this many bytes (4 MiB: ~20k records)
DEFAULT_ROTATE_BYTES = 4 << 20
#: generations kept per process (active + keep-1 rotated)
DEFAULT_KEEP = 4
#: in-memory tail ring shipped through Status windows
DEFAULT_TAIL_CAPACITY = 512
#: bounded write queue: a wedged disk drops (metered), never blocks
DEFAULT_QUEUE_CAPACITY = 4096
#: background writer drain cadence (seconds)
FLUSH_INTERVAL = 0.2

#: the declared event-kind vocabulary: kind -> one-line meaning. The
#: registry-drift lint (obs/lint.py) fails when a ``journal.record``
#: site anywhere in the tree emits a kind missing from this table, and
#: the README event-kind table must name every row.
EVENT_KINDS: Dict[str, str] = {
    "run.start": "an engine/broker run began (geometry, turns, wire mode)",
    "run.end": "a run completed (turns done, alive count)",
    "session.admit": "a universe was admitted into the session batch",
    "session.reject": "an admission was refused (tenant + reason)",
    "session.final": "a session reached FinalTurnComplete",
    "chunk.commit": "a turn chunk committed (turn range, alive, route)",
    "snapshot": "a mid-run snapshot was served (Retrieve)",
    "ckpt.write": "a checkpoint (full or delta) was written",
    "ckpt.verify": "a checkpoint digest verification (ok/fail)",
    "ckpt.replay": "a resume replayed state from a checkpoint",
    "worker.lost": "a worker was marked lost (address, error)",
    "worker.quarantine": "a lost worker entered the probe/backoff cycle",
    "worker.readmit": "a lost worker was probed alive and readmitted",
    "recovery.resplit": "surviving workers were re-split over the board",
    "integrity.fail": "an integrity check caught corruption",
    "early.exit": "a run short-circuited (still/period2/dead)",
    "slo.fire": "an SLO burn-rate rule started firing",
    "slo.clear": "a firing SLO rule resolved",
    "canary.verdict": "a blackbox canary probe verdict (ok/fail)",
    "journal.drop": "journal retention retired a segment (count, path)",
    "crash": "an unhandled exception dumped this process's evidence",
}

_SEGMENT_RE = re.compile(
    r"^journal_(?P<role>[A-Za-z0-9-]+)_(?P<pid>\d+)(?:\.g(?P<gen>\d+))?\.jsonl$"
)


# -- the hybrid logical clock -------------------------------------------------


class HLC:
    """A hybrid logical clock (Kulkarni et al.): stamps are
    ``[physical_ms, logical, node]`` — physical tracks the max wall
    clock observed (ms), logical breaks ties within one ms, node breaks
    ties between processes deterministically. ``tick`` stamps a local
    event; ``merge`` folds a remote stamp in on message receipt, so a
    stamp issued after a merge always orders AFTER the remote event that
    carried it — causality survives wall-clock skew and regression.

    Stamps are plain lists of (int, int, str): they cross the restricted
    unpickler on ``Request.hlc``/``Response.hlc`` and serialise to JSON
    in journal records without help."""

    _GUARDED_BY = {"_physical": "_lock", "_logical": "_lock"}

    def __init__(self, node: Optional[str] = None, now=time.time):
        self.node = node or f"{socket.gethostname() or 'localhost'}-{os.getpid()}"
        self._now = now  # injectable: the skew/regression property tests
        self._lock = _locksan.lock("HLC._lock")
        self._physical = 0
        self._logical = 0

    def tick(self) -> List:
        """Stamp a local event: physical never goes backwards even when
        the wall clock does (logical advances instead)."""
        wall = int(self._now() * 1000)
        with self._lock:
            if wall > self._physical:
                self._physical, self._logical = wall, 0
            else:
                self._logical += 1
            return [self._physical, self._logical, self.node]

    def merge(self, remote) -> Optional[List]:
        """Fold a remote stamp in (message receipt). Malformed stamps —
        a skewed peer without the field sends None — are ignored: skew
        means "no causality hint", never an exception."""
        try:
            rp, rl = int(remote[0]), int(remote[1])
        except (TypeError, ValueError, IndexError):
            return None
        wall = int(self._now() * 1000)
        with self._lock:
            if wall > self._physical and wall > rp:
                self._physical, self._logical = wall, 0
            elif self._physical == rp:
                self._physical = rp
                self._logical = max(self._logical, rl) + 1
            elif self._physical > rp:
                self._logical += 1
            else:
                self._physical, self._logical = rp, rl + 1
            return [self._physical, self._logical, self.node]

    def read(self) -> List:
        """The current stamp WITHOUT advancing the clock (diagnostics)."""
        with self._lock:
            return [self._physical, self._logical, self.node]


def event_node(event: dict) -> str:
    """The emitting process's identity for one journal event: segment
    records carry it inside the HLC stamp (``[physical, logical,
    node]``); window-level consumers may have stamped it top-level;
    role-pid is the last resort for foreign records."""
    node = event.get("node")
    if node:
        return str(node)
    stamp = event.get("hlc")
    if isinstance(stamp, (list, tuple)) and len(stamp) == 3 and stamp[2]:
        return str(stamp[2])
    return f"{event.get('role', '?')}-{event.get('pid', '?')}"


def hlc_key(event: dict) -> Tuple[int, int, str]:
    """The total-order sort key of one journal event: (physical,
    logical, node) — deterministic tie-break by node id, so two merges
    of the same segments always render the same timeline. Events without
    a usable stamp (foreign records) fall back to wall-clock ms, which
    orders them best-effort without poisoning the stamped order."""
    stamp = event.get("hlc")
    try:
        return int(stamp[0]), int(stamp[1]), str(stamp[2])
    except (TypeError, ValueError, IndexError):
        return int(float(event.get("t_unix") or 0.0) * 1000), 0, ""


# -- the per-process journal --------------------------------------------------


def _frame(record_json: bytes) -> bytes:
    """One framed line: ``<crc32-hex> <json>\\n`` — the crc is the
    rpc/integrity.py frame word over the json bytes, so the reader
    detects a torn or flipped record with the same primitive the wire
    plane trusts."""
    crc = _integrity.crc_add(_integrity.crc_new(), record_json)
    return _integrity.crc_pack(crc).hex().encode() + b" " + record_json + b"\n"


def _unframe(line: bytes):
    """One line back to its record dict, or a string describing why it
    cannot be trusted (torn tail, flipped byte, foreign content)."""
    parts = line.rstrip(b"\n").split(b" ", 1)
    if len(parts) != 2 or len(parts[0]) != 8:
        return "unframed line (no crc word)"
    word, payload = parts
    try:
        crc = _integrity.crc_add(_integrity.crc_new(), payload)
        _integrity.crc_check(crc, bytes.fromhex(word.decode()), "journal record")
    except (ValueError, _integrity.IntegrityError):
        return "crc mismatch (torn or corrupted record)"
    try:
        record = json.loads(payload)
    except ValueError:
        return "crc ok but unparseable json (framing bug)"
    if not isinstance(record, dict):
        return "record is not an object"
    return record


class Journal:
    """One process's durable event journal: a buffered writer draining a
    bounded queue into crc-framed, size-rotated segments, plus an
    in-memory tail ring for incremental Status windows. ``record`` is
    the only hot surface; everything else is control-path."""

    # tail/queue/seq/counters move together under the lock; the writer
    # thread owns the file handle exclusively (single consumer)
    _GUARDED_BY = {
        "_tail": "_lock",
        "_queue": "_lock",
        "_seq": "_lock",
        "_dropped": "_lock",
        "_counts": "_lock",
        "_writing": "_lock",
    }

    def __init__(
        self,
        out_dir="out",
        role: str = "engine",
        rotate_bytes: int = DEFAULT_ROTATE_BYTES,
        keep: int = DEFAULT_KEEP,
        tail_capacity: int = DEFAULT_TAIL_CAPACITY,
        queue_capacity: int = DEFAULT_QUEUE_CAPACITY,
        clock: Optional[HLC] = None,
    ):
        if rotate_bytes < 1024:
            raise ValueError(f"rotate_bytes must be >= 1024, got {rotate_bytes}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.out_dir = pathlib.Path(out_dir)
        self.role = str(role)
        self.rotate_bytes = int(rotate_bytes)
        self.keep = int(keep)
        self.clock = clock if clock is not None else HLC()
        self._lock = _locksan.lock("Journal._lock")
        self._tail: deque = deque(maxlen=tail_capacity)
        self._queue: deque = deque()
        self._queue_capacity = int(queue_capacity)
        self._seq = 0
        self._dropped = 0
        self._writing = False
        self._counts: Dict[str, int] = {}
        self._bytes_written = 0
        self._rotations = 0
        # records per on-disk generation (gen 0 = active), so retention
        # can meter exactly how many events a retired segment took away
        self._gen_records: Dict[int, int] = {0: 0}
        self._file = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._thread = threading.Thread(
            target=self._run, name="gol-journal", daemon=True
        )
        self._thread.start()

    # -- paths ---------------------------------------------------------------

    @property
    def path(self) -> pathlib.Path:
        """The active segment (generation 0)."""
        return self.out_dir / f"journal_{self.role}_{os.getpid()}.jsonl"

    def _gen_path(self, gen: int) -> pathlib.Path:
        p = self.path
        return p if gen == 0 else p.with_name(
            p.name[: -len(".jsonl")] + f".g{gen}.jsonl"
        )

    # -- the hot surface -----------------------------------------------------

    def record(self, kind: str, name: str, /, **args) -> None:
        """Append one lifecycle event: HLC tick, tail ring, write queue.
        A full queue drops the event METERED (``gol_journal_drops_total``)
        — a wedged disk must never block a chunk commit. ``kind`` and
        ``name`` are positional-only so event args may reuse those
        names (``ckpt.verify`` carries the error's ``kind=``)."""
        event = {
            "kind": kind,
            "name": name,
            "t_unix": time.time(),
            "hlc": self.clock.tick(),
            "pid": os.getpid(),
            "role": self.role,
            "args": args,
        }
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._tail.append(event)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if len(self._queue) >= self._queue_capacity:
                self._dropped += 1
                _ins.JOURNAL_DROPS_TOTAL.inc()
            else:
                self._queue.append(event)
        _ins.JOURNAL_EVENTS_TOTAL.labels(kind).inc()
        self._wake.set()

    # -- the writer thread ---------------------------------------------------

    def _run(self) -> None:
        while True:
            self._wake.wait(FLUSH_INTERVAL)
            self._wake.clear()
            try:
                self._drain()
            # gol: allow(hygiene): the journal writer must survive disk
            # errors — the drop meter is the loud evidence, and the next
            # drain retries with a fresh open
            except Exception:  # pragma: no cover - depends on disk state
                pass
            if self._stop.is_set():
                with self._lock:
                    remaining = len(self._queue)
                if remaining == 0:
                    break
        f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:  # pragma: no cover
                pass

    def _drain(self) -> None:
        """Write every queued event (writer thread only)."""
        while True:
            with self._lock:
                if not self._queue:
                    # in-flight flag cleared only once the last batch (and
                    # anything it enqueued, e.g. journal.drop on rotation)
                    # is on disk — flush() barriers on it, not just on an
                    # empty queue
                    self._writing = False
                    return
                batch = list(self._queue)
                self._queue.clear()
                self._writing = True
            for event in batch:
                if self._file is None:  # lazy (re)open after a rotation
                    self._file = open(self.path, "ab")
                    self._bytes_written = self.path.stat().st_size
                line = _frame(
                    json.dumps(event, separators=(",", ":"), default=str).encode()
                )
                self._file.write(line)
                self._bytes_written += len(line)
                self._gen_records[0] = self._gen_records.get(0, 0) + 1
                _ins.JOURNAL_BYTES_TOTAL.inc(len(line))
                # per-record, not per-batch: one giant drain must not
                # blow the segment past its size cap
                if self._bytes_written >= self.rotate_bytes:
                    self._file.flush()
                    self._rotate()
            if self._file is not None:
                self._file.flush()

    def _rotate(self) -> None:
        """Retire the active segment down the generation chain (writer
        thread only): active -> .g1 -> ... -> .g<keep-1>, the oldest
        beyond ``keep`` unlinked with its record count metered on the
        drop counter — retention is bounded, never silent."""
        self._file.close()
        self._file = None
        retired = self._gen_path(self.keep - 1)
        if self.keep > 1 and retired.exists():
            lost = self._gen_records.get(self.keep - 1)
            if lost is None:  # a segment from a previous process lifetime
                lost = sum(1 for _ in retired.open("rb"))
            with self._lock:
                self._dropped += lost
            _ins.JOURNAL_DROPS_TOTAL.inc(lost)
            self.record("journal.drop", str(retired), records=lost)
            retired.unlink()
        elif self.keep == 1:
            lost = self._gen_records.get(0, 0)
            with self._lock:
                self._dropped += lost
            _ins.JOURNAL_DROPS_TOTAL.inc(lost)
            self.path.unlink(missing_ok=True)
            self._gen_records[0] = 0
            self._bytes_written = 0
            self._rotations += 1
            _ins.JOURNAL_ROTATIONS_TOTAL.inc()
            return
        for gen in range(self.keep - 2, -1, -1):
            src = self._gen_path(gen)
            if src.exists():
                src.replace(self._gen_path(gen + 1))
                self._gen_records[gen + 1] = self._gen_records.pop(gen, 0)
        self._gen_records[0] = 0
        self._bytes_written = 0
        self._rotations += 1
        _ins.JOURNAL_ROTATIONS_TOTAL.inc()

    # -- control-path queries ------------------------------------------------

    def window(self, since: int = 0) -> dict:
        """The Status payload form: tail events with seq > ``since``
        (the poller echoes the last seq it saw — ``journal_since``).
        Plain JSON-able throughout: the payload crosses the restricted
        unpickler."""
        with self._lock:
            events = [e for e in self._tail if e["seq"] > since]
            seq = self._seq
            dropped = self._dropped
        return {
            "schema": SCHEMA,
            "seq": seq,
            "role": self.role,
            "node": self.clock.node,
            "dropped": dropped,
            "events": events,
        }

    def summary(self) -> dict:
        """Counts by kind + retention state — the RunReport embed."""
        with self._lock:
            counts = dict(self._counts)
            dropped = self._dropped
            total = self._seq
        return {
            "schema": SCHEMA,
            "role": self.role,
            "node": self.clock.node,
            "events_total": total,
            "by_kind": counts,
            "dropped": dropped,
            "rotations": self._rotations,
            "segments": [str(p) for p in self.segments()],
        }

    def segments(self) -> List[pathlib.Path]:
        """This journal's on-disk segments, oldest generation first."""
        out = [
            self._gen_path(gen)
            for gen in range(self.keep - 1, -1, -1)
            if self._gen_path(gen).exists()
        ]
        return out

    def flush(self, timeout: float = 2.0) -> None:
        """Block until everything queued so far is on disk (bounded)."""
        deadline = time.monotonic() + timeout
        self._wake.set()
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and not self._writing:
                    return
            self._wake.set()
            time.sleep(0.01)

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)


# -- segment readers (history, doctor, tests) ---------------------------------


def read_segment(path) -> Tuple[List[dict], List[str]]:
    """One segment -> (events, problems). Every record that fails its
    crc frame or parse — a torn tail from a SIGKILL mid-write, a flipped
    byte in cold storage — lands in ``problems`` with its line number
    and is SKIPPED: detected loudly, never mis-parsed, never a crash."""
    path = pathlib.Path(path)
    events: List[dict] = []
    problems: List[str] = []
    try:
        raw = path.read_bytes()
    except OSError as exc:
        return [], [f"{path}: unreadable ({exc})"]
    for lineno, line in enumerate(raw.split(b"\n"), 1):
        if not line:
            continue
        record = _unframe(line)
        if isinstance(record, dict):
            events.append(record)
        else:
            problems.append(f"{path}:{lineno}: {record} — record skipped")
    return events, problems


def segment_paths(out_dir="out") -> List[pathlib.Path]:
    """Every journal segment under ``out_dir`` (all roles, all pids,
    all generations), sorted by name — the dead-process read surface."""
    out_dir = pathlib.Path(out_dir)
    if not out_dir.is_dir():
        return []
    return sorted(
        p for p in out_dir.iterdir() if _SEGMENT_RE.match(p.name)
    )


def read_segments(paths_or_dir) -> Tuple[List[dict], List[str]]:
    """Many segments (or a directory of them) -> (events merged in HLC
    order, problems). The merge is deterministic: ``hlc_key`` breaks
    ties by node id, so the same segments always render the same
    timeline."""
    if isinstance(paths_or_dir, (str, pathlib.Path)):
        # a directory (possibly absent: no segments yet -> empty), never
        # a char-by-char iteration of the string
        paths = segment_paths(paths_or_dir)
    else:
        paths = [pathlib.Path(p) for p in paths_or_dir]
    events: List[dict] = []
    problems: List[str] = []
    for p in paths:
        ev, pr = read_segment(p)
        events.extend(ev)
        problems.extend(pr)
    events.sort(key=hlc_key)
    return events, problems


# -- the process-global default journal + clock -------------------------------

#: the process HLC: ALWAYS live (stamping/merging costs a few integer
#: compares under a lock), so causality survives even between processes
#: whose journals are off — rpc/client.py and rpc/server.py stamp every
#: call both ways unconditionally
_CLOCK = HLC()

_JOURNAL: Optional[Journal] = None


def clock() -> HLC:
    return _CLOCK


def stamp() -> List:
    """An outbound HLC stamp (rpc/client.py request, rpc/server.py
    reply): one tick of the process clock."""
    return _CLOCK.tick()


def observe(remote) -> None:
    """Merge a received stamp (getattr-read from the ``hlc`` extension
    field; None from a skewed peer is a no-op)."""
    if remote is not None:
        _CLOCK.merge(remote)


def journal() -> Optional[Journal]:
    return _JOURNAL


def enabled() -> bool:
    return _JOURNAL is not None


def enable(
    out_dir="out",
    role: str = "engine",
    rotate_bytes: int = DEFAULT_ROTATE_BYTES,
    keep: int = DEFAULT_KEEP,
) -> Journal:
    """Open the process journal (the ``-journal`` CLI flags). The global
    HLC is shared with the RPC stamping surface, so journal records and
    wire stamps advance one clock."""
    global _JOURNAL
    if _JOURNAL is not None:
        _JOURNAL.close()
    _JOURNAL = Journal(
        out_dir=out_dir, role=role, rotate_bytes=rotate_bytes, keep=keep,
        clock=_CLOCK,
    )
    return _JOURNAL


def disable() -> None:
    global _JOURNAL
    j, _JOURNAL = _JOURNAL, None
    if j is not None:
        j.close()


def record(kind: str, name: str, /, **args) -> None:
    """The module-level hot surface: one global load and a branch while
    disabled (the flight.record posture). ``kind``/``name`` are
    positional-only so event args may reuse those names."""
    j = _JOURNAL
    if j is not None:
        j.record(kind, name, **args)


def window(since: int = 0) -> Optional[dict]:
    """The Status payload section, or None while disabled."""
    j = _JOURNAL
    return j.window(since) if j is not None else None


def summary() -> Optional[dict]:
    j = _JOURNAL
    return j.summary() if j is not None else None


def flush_on_crash(exc: Optional[BaseException] = None) -> None:
    """Best-effort final flush for an unhandled exception (the crash
    hooks in engine/broker/worker): records the crash as the journal's
    final event, then drains the queue to disk. Never raises — a broken
    disk must not mask the original exception."""
    j = _JOURNAL
    if j is None:
        return
    try:
        if exc is not None:
            j.record("crash", type(exc).__name__, message=str(exc)[:500])
        j.flush()
    # gol: allow(hygiene): the crash hook must never mask the original
    # exception with a secondary disk/teardown failure — best-effort
    except Exception:  # pragma: no cover - depends on disk state
        pass
