"""Runtime lock sanitizer: online order checking + a hold watchdog.

The static layer (``analysis/lockorder.py``) proves what the AST can
resolve; dynamic dispatch, module-attribute objects and data-dependent
paths are invisible to it. This module covers the remainder at TEST
time: under ``GOL_LOCKSAN=1`` the instrumented classes' locks
(``locksan.lock("Class._name")`` sites across engine/, rpc/, obs/) are
instrumented wrappers that maintain

* a per-thread HELD STACK (label, acquire time, acquiring stack), and
* a global online order graph: the first observed A-held-acquiring-B
  records the A→B edge with its stack; a later acquisition that closes
  a path back (B..→A observed while holding A and taking B reversed)
  is a :class:`LockOrderViolation` raised IN the acquiring thread —
  both stacks in the message, ``gol_locksan_violations_total{kind=
  "order"}`` metered, and the evidence written to
  ``out/locksan_<ts>.txt`` so a violation swallowed by a broad handler
  still fails ``scripts/check --locksan`` (which globs for artifacts).

A watchdog thread (daemon, started with the first instrumented lock)
fires when a lock has been held past ``GOL_LOCKSAN_DEADLINE`` seconds
(default 30) WITH waiters queued — the wedged-broker shape — dumping
all-thread tracebacks to the same artifact path and metering
``gol_locksan_violations_total{kind="watchdog"}``.

With ``GOL_LOCKSAN`` unset the factories return PLAIN ``threading``
objects — no wrapper type, no per-acquire bookkeeping, zero hot-path
overhead; the one ``if`` runs at construction time only. Identity is
the LABEL, not the instance: two SessionTables nesting each other's
``_lock`` is an unordered-instances hazard the label graph flags, and
cross-run order knowledge accumulates per lock ROLE, which is what the
static checker reasons about too.

Tests drive the sanitizer in-process via :func:`install` /
:func:`uninstall` / :func:`reset` (env is read once at import, so a
monkeypatched environ alone would not re-arm it).
"""

from __future__ import annotations

import os
import pathlib
import sys
import threading
import time
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

_ENV = "GOL_LOCKSAN"
_DEADLINE_ENV = "GOL_LOCKSAN_DEADLINE"

_active = os.environ.get(_ENV, "") not in ("", "0")
_deadline = float(os.environ.get(_DEADLINE_ENV, "") or 30.0)
_out_dir = "out"


class LockOrderViolation(RuntimeError):
    """An observed acquisition inverted the recorded lock order. Raised
    in the acquiring thread BEFORE it blocks — the deadlock is reported
    as a test failure instead of a hang."""


class _Edges:
    """The global order graph + the live-lock registry, guarded by one
    internal lock that is NEVER held while blocking on a user lock."""

    def __init__(self):
        self.meta = threading.Lock()
        # (src label, dst label) -> (stack summary, thread name)
        self.edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.locks: List = []  # every live instrumented lock
        self.violations: List[str] = []
        self.watchdog_fires = 0
        self.watchdog_thread: Optional[threading.Thread] = None

    def reachable(self, src: str, dst: str) -> Optional[List[str]]:
        """A recorded path src -> .. -> dst, or None. Caller holds meta."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in adj.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None


_STATE = _Edges()
_TLS = threading.local()


def _held_stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _meter(kind: str) -> None:
    # lazy import: this module must stay importable before obs/ (and the
    # disabled path must not pay the import at all)
    try:
        from ..obs import instruments as _ins

        _ins.LOCKSAN_VIOLATIONS_TOTAL.labels(kind).inc()
    # gol: allow(hygiene): the violation report/abort that FOLLOWS this
    # meter is the evidence; a broken obs import must not mask it, and
    # logging from inside the sanitizer would recurse into the very
    # locks under test
    except Exception:  # pragma: no cover - metrics must never mask the abort
        pass


def _artifact_path() -> pathlib.Path:
    ts = time.strftime("%Y%m%d_%H%M%S")
    out = pathlib.Path(_out_dir)
    path = out / f"locksan_{ts}.txt"
    n = 1
    while path.exists():
        path = out / f"locksan_{ts}_{n}.txt"
        n += 1
    return path


def _all_thread_tracebacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        parts.append(
            f"--- thread {names.get(ident, '?')} (ident {ident}) ---\n"
            + "".join(traceback.format_stack(frame))
        )
    return "\n".join(parts)


def _write_artifact(header: str, body: str) -> Optional[pathlib.Path]:
    """Best-effort evidence file (temp-name + rename, the repo's
    artifact posture); a broken disk must not mask the violation."""
    try:
        path = _artifact_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(header + "\n\n" + body + "\n")
        tmp.replace(path)
        return path
    except OSError:
        return None


def _site() -> str:
    """The acquiring call site (file:line in func), skipping locksan's
    own frames — cheap enough to stamp EVERY acquisition (full stacks
    are formatted only on first-edge recording and on violations)."""
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    if f is None:  # pragma: no cover - only if called from module top
        return "<unknown>"
    co = f.f_code
    return f"{co.co_filename}:{f.f_lineno} in {co.co_name}"


class _Held:
    __slots__ = ("lock", "count", "t0", "site")

    def __init__(self, lock, site):
        self.lock = lock
        self.count = 1
        self.t0 = time.monotonic()
        self.site = site


class _SanLock:
    """Instrumented ``threading.Lock`` (``reentrant=True``: RLock).
    Implements the full Condition delegate protocol (``_is_owned`` /
    ``_release_save`` / ``_acquire_restore``) so ``threading.Condition``
    over an instrumented lock keeps exact wait/notify semantics —
    including multi-level RLock recursion across a ``wait()``."""

    _reentrant = False

    def __init__(self, label: str):
        self.label = label
        self._inner = (
            threading.RLock() if self._reentrant else threading.Lock()
        )
        # watchdog surface, read without meta (monotonic flags/counters;
        # an occasional torn read costs one watchdog period, never
        # correctness)
        self.holder: Optional[int] = None
        self.held_since = 0.0
        self.waiters = 0
        self.reported = False
        # weakref: per-connection locks (RpcServer.write_lock) must not
        # accumulate in the registry for the process lifetime — the
        # watchdog prunes dead refs as it scans
        with _STATE.meta:
            _STATE.locks.append(weakref.ref(self))
        _ensure_watchdog()

    # -- the lock protocol ---------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        stack = _held_stack()
        mine = next((h for h in stack if h.lock is self), None)
        if mine is not None:
            if not self._reentrant:
                if not blocking:
                    return False  # a try-acquire probe, not a deadlock
                self._violation(
                    f"non-reentrant lock '{self.label}' re-acquired by "
                    f"the thread already holding it (self-deadlock)",
                    mine.site,
                )
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                mine.count += 1
            return ok
        if blocking and stack:
            self._check_order(stack)
        self.waiters += 1
        try:
            ok = self._inner.acquire(blocking, timeout)
        finally:
            self.waiters -= 1
        if ok:
            # a successful TRY-acquire is a real hold (stack push) but
            # not an ordering commitment: it cannot block, so the
            # hold-A/try-B backoff pattern must not poison the graph
            # with an A->B edge that a blocking B->A path then trips
            self._note_acquired(stack, record_edges=blocking)
        return ok

    def release(self):
        stack = _held_stack()
        mine = next(
            (h for h in reversed(stack) if h.lock is self), None
        )
        if mine is not None:
            mine.count -= 1
            if mine.count <= 0:
                stack.remove(mine)
                self.holder = None
                self.reported = False
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- the Condition delegate protocol -------------------------------------

    def _is_owned(self):
        return any(h.lock is self for h in _held_stack())

    def _release_save(self):
        """Fully release for a Condition.wait, whatever the recursion
        depth, returning what _acquire_restore needs to rebuild it."""
        stack = _held_stack()
        mine = next(
            (h for h in reversed(stack) if h.lock is self), None
        )
        count = mine.count if mine is not None else 1
        if mine is not None:
            stack.remove(mine)
            self.holder = None
            self.reported = False
        if self._reentrant:
            return (count, self._inner._release_save())
        self._inner.release()
        return (count, None)

    def _acquire_restore(self, saved):
        count, inner_state = saved
        stack = _held_stack()
        if stack:
            self._check_order(stack)
        self.waiters += 1
        try:
            if inner_state is not None:
                self._inner._acquire_restore(inner_state)
            else:
                self._inner.acquire()
        finally:
            self.waiters -= 1
        self._note_acquired(stack, count=count)

    # -- bookkeeping ---------------------------------------------------------

    def _note_acquired(self, stack, count: int = 1,
                       record_edges: bool = True):
        site = _site()
        if stack and record_edges:
            # record first-observed edges with a full stack: the price
            # is paid once per NEW edge, not per acquisition
            with _STATE.meta:
                for held in stack:
                    key = (held.lock.label, self.label)
                    if key not in _STATE.edges:
                        _STATE.edges[key] = (
                            "".join(traceback.format_stack(limit=16)[:-2]),
                            threading.current_thread().name,
                        )
        self.holder = threading.get_ident()
        self.held_since = time.monotonic()
        held = _Held(self, site)
        held.count = count
        stack.append(held)

    def _check_order(self, stack):
        """Abort BEFORE blocking when taking this lock closes a cycle
        against the recorded order: for any held H, a recorded path
        self -> .. -> H means some thread takes them the other way."""
        for held in stack:
            if held.lock.label == self.label:
                self._violation(
                    f"a second '{self.label}' instance acquired while "
                    f"one is already held — same lock ROLE nested with "
                    f"no defined instance order (ABBA across instances)",
                    held.site,
                )
        with _STATE.meta:
            for held in stack:
                path = _STATE.reachable(self.label, held.lock.label)
                if path is None:
                    continue
                first = _STATE.edges.get((path[0], path[1]))
                self._violation(
                    f"acquiring '{self.label}' while holding "
                    f"'{held.lock.label}' inverts the recorded order "
                    f"{' -> '.join(path + [self.label])}",
                    held.site,
                    recorded=first,
                    locked=True,
                )

    def _violation(self, summary, holder_site, recorded=None,
                   locked=False):
        current = "".join(traceback.format_stack(limit=16)[:-2])
        report = [
            f"LOCK ORDER VIOLATION: {summary}",
            f"thread: {threading.current_thread().name}",
            "",
            "--- acquiring thread, at the violating acquisition ---",
            current,
            f"--- same thread acquired the held lock at ---",
            f"  {holder_site}",
        ]
        if recorded is not None:
            report += [
                f"--- first-recorded conflicting edge (thread "
                f"{recorded[1]}) ---",
                recorded[0],
            ]
        text = "\n".join(report)
        if locked:
            _STATE.violations.append(text)
        else:
            with _STATE.meta:
                _STATE.violations.append(text)
        _meter("order")
        path = _write_artifact("gol_locksan order violation", text)
        raise LockOrderViolation(
            text + (f"\n(evidence: {path})" if path else "")
        )


class _SanRLock(_SanLock):
    _reentrant = True


def _ensure_watchdog() -> None:
    with _STATE.meta:
        if _STATE.watchdog_thread is not None:
            return
        t = threading.Thread(
            target=_watch_loop, name="gol-locksan-watchdog", daemon=True
        )
        _STATE.watchdog_thread = t
    t.start()


def _watch_loop() -> None:
    while True:
        time.sleep(max(0.02, min(_deadline / 4.0, 0.5)))
        now = time.monotonic()
        with _STATE.meta:
            live = [(ref, ref()) for ref in _STATE.locks]
            dead = [ref for ref, lk in live if lk is None]
            if dead:
                _STATE.locks[:] = [ref for ref, lk in live if lk is not None]
        locks = [lk for _ref, lk in live if lk is not None]
        for lk in locks:
            if (
                lk.holder is not None
                and lk.waiters > 0
                and not lk.reported
                and now - lk.held_since > _deadline
            ):
                lk.reported = True
                with _STATE.meta:
                    _STATE.watchdog_fires += 1
                _meter("watchdog")
                _write_artifact(
                    f"gol_locksan watchdog: '{lk.label}' held "
                    f"{now - lk.held_since:.1f}s (deadline {_deadline}s) "
                    f"with {lk.waiters} waiter(s) queued — all-thread "
                    f"tracebacks follow",
                    _all_thread_tracebacks(),
                )


# -- the factories (the ONLY public wiring surface) ---------------------------


def enabled() -> bool:
    return _active


def lock(label: str):
    """A ``threading.Lock`` — instrumented iff the sanitizer is active.
    ``label`` is the lock's ROLE (``Class._attr``), the identity the
    order graph reasons about."""
    return _SanLock(label) if _active else threading.Lock()


def rlock(label: str):
    return _SanRLock(label) if _active else threading.RLock()


def condition(label: str, lock=None):
    """A ``threading.Condition``. Over an instrumented lock the wait /
    notify bookkeeping comes free — Condition delegates acquire/release
    to the lock object, and ``wait()`` releasing the lock pops the held
    stack exactly like a ``with`` exit. With no lock given the implicit
    lock is an instrumented RLock (matching threading's default)."""
    if not _active:
        return threading.Condition(lock)
    if lock is None:
        lock = _SanRLock(label)
    return threading.Condition(lock)


# -- test / tooling surface ---------------------------------------------------


def install(deadline: Optional[float] = None, out_dir=None) -> None:
    """Arm the sanitizer in-process (tests; entry points use the env).
    Affects locks created AFTER the call — existing plain locks stay
    plain, which is fine for tests that construct their subjects after
    installing."""
    global _active, _deadline, _out_dir
    _active = True
    if deadline is not None:
        _deadline = float(deadline)
    if out_dir is not None:
        _out_dir = str(out_dir)
    reset()


def uninstall() -> None:
    """Revert :func:`install`: back to what the ENVIRONMENT says (so a
    test teardown under an env-armed ``--locksan`` run does not disarm
    the sanitizer for the rest of the process)."""
    global _active, _deadline, _out_dir
    _active = os.environ.get(_ENV, "") not in ("", "0")
    _deadline = float(os.environ.get(_DEADLINE_ENV, "") or 30.0)
    _out_dir = "out"
    reset()


def reset() -> None:
    """Forget recorded edges, violations, and registered locks (the
    watchdog thread, once started, idles over an empty registry)."""
    with _STATE.meta:
        _STATE.edges.clear()
        _STATE.locks.clear()
        _STATE.violations.clear()
        _STATE.watchdog_fires = 0


def violations() -> List[str]:
    with _STATE.meta:
        return list(_STATE.violations)


def watchdog_fires() -> int:
    with _STATE.meta:
        return _STATE.watchdog_fires


def set_out_dir(path) -> None:
    """Artifact directory override (entry points with an ``-out`` notion
    and tests; default ``out/``)."""
    global _out_dir
    _out_dir = str(path)
