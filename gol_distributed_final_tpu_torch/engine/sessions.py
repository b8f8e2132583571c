"""Device-batched sessions — many concurrent Run universes in ONE batch.

The engine (engine/engine.py) serves one board per run; serving traffic
is many small, independent universes. A ``SessionTable`` packs up to
``capacity`` concurrent sessions of one geometry and rule into a single
device-resident batch tensor (ops/batched.py planes) and advances them
together: one launch steps every universe and yields every universe's
alive count, and each session's events (AliveCellsCount, TurnComplete,
FinalTurnComplete) demux from those counts, so the controller's event
contract holds per universe.

Lifecycle:

* ``admit(board, turns)`` — admission control: a capacity bound, the
  batch's fixed geometry, and a positive turn budget; refusals raise
  ``SessionRejected`` with a machine-readable ``reason``. Admitted
  universes join the batch at the next ``advance`` boundary.
* ``advance()`` — one driver iteration, from a single driver thread: join
  pending universes, ONE batched launch of k turns (k = the smallest
  remaining budget, capped by ``max_chunk`` and quantised down to a power
  of two), demux counts, retire finished universes by SLOT COMPACTION (a
  device gather keeps the batch dense).
* ``snapshot(session)`` — a per-session Retrieve: (world?, turn, alive)
  consistent with the committed batch state.
* ``cancel(session)`` — mid-batch leave; the slot compacts away at the
  next boundary.

Every per-universe result is bit-identical to a sequential single-board
run of the same rule; the batch changes no arithmetic. The chunk
boundaries, and so the events each session sees, are the JAX package's
(engine/sessions.py there) turn for turn.

Concurrency model: ``admit`` / ``snapshot`` / ``cancel`` may be called
from any thread (RPC handlers); ``advance`` must be called from ONE
driver thread (rpc/broker.SessionScheduler owns it). The batch state and
every session's committed (turns_done, alive_count) move together under
one lock, so a snapshot never pairs a new turn with a stale count. The
table meters admissions, refusals, occupancy, turns and the chunk wall
per universe-turn, feeds the tenant ledger (obs/accounting.py) and
journals admissions, commits and finals, as the JAX package's does. A
handler that decodes a universe outside the lock keeps its own reference
to the state tensor it read under the lock, so the driver replacing the
state cannot free it; every launch and copy runs on the device's current
stream, so the decode orders after the launch that wrote it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..events import AliveCellsCount, FinalTurnComplete, TurnComplete
from ..models import CONWAY, LifeRule
from ..obs import accounting as _acct
from ..obs import instruments as _ins
from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..obs import perf as _perf
from ..ops.auto import auto_batch_plane
from ..ops.reduce import alive_cells

#: admission-refusal reasons (``SessionRejected.reason``), the JAX
#: package's stable label set of ``gol_sessions_rejected_total``
REJECT_REASONS = ("capacity", "geometry", "rule", "turns", "tag")


class SessionRejected(RuntimeError):
    """Admission refusal. ``reason`` is machine-readable (REJECT_REASONS);
    the message is the operator-facing detail."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


def reject(reason: str, message: str, tenant: str = "-") -> SessionRejected:
    """Count, journal and build one admission refusal (table- and
    scheduler-level refusals alike). ``tenant`` is the accounting identity
    where the caller knows it."""
    _ins.SESSIONS_REJECTED_TOTAL.labels(reason).inc()
    _journal.record("session.reject", reason, tenant=tenant, message=message[:200])
    return SessionRejected(reason, message)


class Session:
    """One universe in the batch: its budget, progress, the latest
    demuxed alive count, and the completion handshake."""

    __slots__ = (
        "sid", "turns", "turns_done", "alive_count", "done", "result",
        "cancelled", "error", "on_event", "tenant",
    )

    def __init__(
        self,
        sid: int,
        turns: int,
        initial_turn: int,
        alive_count: int,
        on_event: Optional[Callable] = None,
        tenant: str = "-",
    ):
        self.sid = sid
        self.turns = turns  # the budget: total turns this session runs to
        self.turns_done = initial_turn
        self.alive_count = alive_count
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.cancelled = False
        self.error: Optional[Exception] = None
        self.on_event = on_event
        # the accounting identity (obs/accounting.tenant_of of the session
        # tag): every chunk this session rides attributes its share of the
        # launch's wall to this tenant
        self.tenant = tenant

    @property
    def remaining(self) -> int:
        return max(0, self.turns - self.turns_done)


class SessionTable:
    """Up to ``capacity`` concurrent universes of ONE geometry/rule in a
    device-resident batch tensor (see module docstring). ``device`` places
    the batch: None is the CUDA card (raises without one), ``"cpu"`` runs
    the kernels' plain torch versions."""

    # the batch tensor and the session lists move together under _lock:
    # a snapshot must never pair a new turn with a stale count, and a
    # session must be findable in exactly one list at any instant
    # (machine-enforced: analysis/locks.py)
    _GUARDED_BY = {
        "_state": "_lock",
        "_active": "_lock",
        "_pending": "_lock",
        "_next_sid": "_lock",
    }

    def __init__(
        self,
        rule: LifeRule = CONWAY,
        shape: tuple[int, int] = (0, 0),
        capacity: int = 256,
        *,
        max_chunk: int = 4096,
        device=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_chunk < 1:
            raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
        self.rule = rule
        self.shape = tuple(shape)
        self.capacity = capacity
        self.max_chunk = max_chunk
        # early-retire all-dead universes: under a rule without B0 a
        # universe whose count hit 0 can never change again, so its
        # remaining budget is credited at the boundary instead of burning
        # launches to the end; FinalTurnComplete carries the full budget
        # turn and the (empty) final board, exactly like a computed drain.
        # B0 rules never retire early: a dead board births.
        self.retire_dead = not (rule.birth_mask & 1)
        self._plane = auto_batch_plane(rule, self.shape, device)
        # guards _state, _active, _pending and _next_sid, and every
        # session's committed (turns_done, alive_count): a session is in
        # exactly one of _active/_pending at any instant
        self._lock = threading.Lock()
        self._state = None  # device batch [n, ...]; row i <-> _active[i]
        self._active: List[Session] = []
        self._pending: List[tuple[Session, np.ndarray]] = []
        self._next_sid = 1

    # -- admission control ------------------------------------------------

    def admit(
        self, board, turns: int, on_event: Optional[Callable] = None, tenant: str = "-",
    ) -> Session:
        """Admission-controlled join. The universe enters the device batch
        at the next ``advance`` boundary; until then snapshots serve its
        seed board."""
        board = np.asarray(board, np.uint8)
        if board.shape != self.shape:
            raise reject(
                "geometry",
                f"session board is {board.shape}, this batch serves "
                f"{self.shape} (one geometry per batch)",
                tenant=tenant,
            )
        if turns < 1:
            raise reject("turns", f"turn budget must be >= 1, got {turns}", tenant=tenant)
        with self._lock:
            if len(self._active) + len(self._pending) >= self.capacity:
                raise reject(
                    "capacity", f"session table full ({self.capacity} universes)",
                    tenant=tenant,
                )
            sess = Session(
                self._next_sid, turns, 0, int(np.count_nonzero(board)), on_event,
                tenant,
            )
            self._next_sid += 1
            self._pending.append((sess, board.copy()))
            _ins.SESSIONS_ADMITTED_TOTAL.inc()
            _ins.SESSIONS_ACTIVE.set(len(self._active) + len(self._pending))
        # journal outside the table lock: record() takes its own lock
        _journal.record("session.admit", str(sess.sid), turns=turns, tenant=tenant)
        return sess

    def cancel(self, sess: Session) -> None:
        """Mid-batch leave: the session retires (result=None) and its slot
        compacts away at the next advance boundary."""
        with self._lock:
            sess.cancelled = True

    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._active) + len(self._pending)

    # -- the driver -------------------------------------------------------

    def advance(self) -> int:
        """One driver iteration (single driver thread — see module
        docstring). Returns the number of sessions still in the table."""
        # join: encode pending universes in one batched pack and append.
        # The pending entries leave _pending in the SAME critical section
        # that makes them active, so a concurrent snapshot always finds a
        # session in exactly one list. admit only appends and advance is
        # single-threaded, so the grabbed prefix is stable.
        t_adv0 = time.monotonic()
        attribution = _metrics.enabled() and _perf.attribution_enabled()
        with self._lock:
            pending = list(self._pending)
        if pending:
            new = self._plane.encode(np.stack([b for _, b in pending]))
            with self._lock:
                self._state = self._plane.append(self._state, new)
                self._active.extend(s for s, _ in pending)
                # gol: allow(atomicity): the grabbed prefix is stable by
                # the concurrency contract — admit only APPENDS and
                # advance is the single driver thread, so entries
                # [0, len(pending)) are exactly the ones encoded above
                del self._pending[: len(pending)]
        with self._lock:
            active = list(self._active)
            state = self._state
        if not active:
            _ins.SESSIONS_ACTIVE.set(0)
            return 0

        # one batched launch: k turns for every universe (k bounded by the
        # smallest remaining budget so no session oversteps; a cancelled
        # session contributes nothing to k and retires below)
        remaining = [s.remaining for s in active if not s.cancelled]
        k = min(min(remaining), self.max_chunk) if remaining else 0
        if k > 2:
            # a power of two, as the JAX package quantises it (there to
            # bound its compile cache; a CUDA launch takes k at run time).
            # The chunk boundaries decide which AliveCellsCount/
            # TurnComplete events each session sees, so they stay the
            # reference's; a budget-T session drains in <= log2(T) + 2
            # launches and still lands on its budget exactly.
            k = 1 << (k.bit_length() - 1)
        t_chunk = time.monotonic()
        if k > 0:
            # the chunk's turns AND the per-universe counts in one launch;
            # the host fold of the counts waits for the device
            state, counts = self._plane.step_n_counts(state, k)
        else:
            counts = self._plane.alive_counts(state)
        # the counts' host copy waited for the launch: real time
        dt_chunk = time.monotonic() - t_chunk
        if attribution:
            # dispatch-wall decomposition (obs/perf.py): joining pending
            # universes is host_prep, the launch device_compute; demux
            # closes at the bottom
            _ins.TURN_SEGMENT_SECONDS.labels("sessions", "host_prep").observe(
                max(0.0, t_chunk - t_adv0)
            )
            _ins.TURN_SEGMENT_SECONDS.labels("sessions", "device_compute").observe(dt_chunk)
        t_demux0 = time.monotonic()

        events: List[tuple[Session, object]] = []
        finished: List[int] = []
        advanced: List[str] = []  # tenant per universe this chunk advanced
        died: List[int] = []  # sids early-retired all-dead this chunk
        with self._lock:
            self._state = state
            for i, s in enumerate(active):
                if k > 0 and not s.cancelled:
                    advanced.append(s.tenant)
                    s.turns_done += k
                    s.alive_count = int(counts[i])
                    if s.on_event is not None:
                        events.append(
                            (s, AliveCellsCount(s.turns_done, s.alive_count))
                        )
                        events.append((s, TurnComplete(s.turns_done)))
                    if self.retire_dead and s.alive_count == 0 and s.remaining > 0:
                        # all-dead universe: it can never change again, so
                        # the rest of its budget is credited, not computed
                        s.turns_done = s.turns
                        _ins.EARLY_EXIT_TOTAL.labels("dead").inc()
                        died.append(s.sid)
                if s.cancelled or s.remaining == 0:
                    finished.append(i)
            if advanced:
                _ins.SESSION_TURNS_TOTAL.inc(k * len(advanced))
        if advanced:
            # the serving-latency objective (obs/slo.py) and the per-tenant
            # ledger (obs/accounting.py) split the same chunk wall; all
            # derive from the one `advanced` list the lock committed, so
            # the ledger reconciles with gol_session_turns_total exactly
            m = len(advanced)
            _ins.SESSION_TURN_SECONDS.observe_n(dt_chunk / (k * m), k * m)
            _acct.ledger().record_chunk(advanced, k, dt_chunk)
            _journal.record(
                "chunk.commit", "sessions", k=k, universes=m,
                dt_s=round(dt_chunk, 6), route="fused",
            )
        for sid in died:
            _journal.record("early.exit", "dead", sid=sid)

        # retire + compact: ONE gather + ONE decode for every finishing
        # universe (a burst of equal budgets must not pay a launch per
        # universe at the boundary), then one gather keeps the survivors
        # dense
        if finished:
            fin = set(finished)
            live = [i for i in finished if not active[i].cancelled]
            if live:
                decoded = self._plane.decode(self._plane.take(state, live))
                for j, i in enumerate(live):
                    # a copy: one session's result must not pin the whole
                    # decoded burst
                    active[i].result = decoded[j].copy()
            keep = [i for i in range(len(active)) if i not in fin]
            with self._lock:
                self._state = self._plane.take(state, keep) if keep else None
                # gol: allow(atomicity): only this single driver thread
                # ever REPLACES _active; the earlier snapshot can only
                # trail it by appends-via-_pending, which stay pending
                # until the next advance — the compacted list is exact
                self._active = [active[i] for i in keep]
                left = len(self._active) + len(self._pending)
                _ins.SESSIONS_ACTIVE.set(left)
            for i in finished:
                s = active[i]
                if not s.cancelled:
                    _journal.record(
                        "session.final", str(s.sid), turn=s.turns_done, tenant=s.tenant,
                    )
                if s.on_event is not None and not s.cancelled:
                    events.append(
                        (s, FinalTurnComplete(s.turns_done, alive_cells(s.result)))
                    )
        else:
            with self._lock:
                left = len(self._active) + len(self._pending)
                _ins.SESSIONS_ACTIVE.set(left)

        # callbacks outside the lock: user code must not hold the table
        for s, ev in events:
            try:
                s.on_event(ev)
            # gol: allow(hygiene): an observer callback must never stall
            # the batch, and this runs per event in the serving hot loop —
            # too hot for per-failure logging
            except Exception:
                pass
        # completion LAST: a waiter woken by done must find every event —
        # FinalTurnComplete included — already delivered
        for i in finished:
            active[i].done.set()
        if attribution and (advanced or finished):
            _ins.TURN_SEGMENT_SECONDS.labels("sessions", "demux").observe(
                time.monotonic() - t_demux0
            )
        return left

    def fail_all(self, exc: Exception) -> None:
        """Driver-crash path: every session in the table completes with
        ``error`` set (its waiter re-raises) instead of hanging forever."""
        with self._lock:
            sessions = list(self._active) + [s for s, _ in self._pending]
            self._active, self._pending, self._state = [], [], None
            _ins.SESSIONS_ACTIVE.set(0)
        _journal.record(
            "integrity.fail", "sessions.fail_all",
            error_kind=type(exc).__name__, sessions=len(sessions),
        )
        for s in sessions:
            s.error = exc
            s.done.set()

    # -- per-session retrieve ---------------------------------------------

    def snapshot(self, sess: Session, include_world: bool = False):
        """Per-session Retrieve: ``(world | None, turns_done, alive)`` at
        the committed batch state — count and turn move together."""
        with self._lock:
            if sess.done.is_set() or sess not in self._active:
                for p, board in self._pending:
                    if p is sess:
                        world = board.copy() if include_world else None
                        return world, sess.turns_done, sess.alive_count
                world = sess.result if include_world else None
                return world, sess.turns_done, sess.alive_count
            row = self._active.index(sess)
            state = self._state  # held: the driver may replace it meanwhile
            turn, alive = sess.turns_done, sess.alive_count
        world = self._plane.decode_one(state, row) if include_world else None
        return world, turn, alive
