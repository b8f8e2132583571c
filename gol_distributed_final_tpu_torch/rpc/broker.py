"""The broker process — the Operations service (broker/broker.go) on one
device.

The port of the JAX package's ``rpc/broker.py``, on its on-device
backend: the board lives on the card in an in-process Engine, and the
reference's per-turn scatter/gather collapses into chunked kernel
launches. Beside it, ``Operations.SessionRun`` serves many universes of
one geometry in one device batch (``SessionScheduler`` over
engine/sessions.py).

Control semantics preserved: Run blocks and resets state; Pause toggles;
Quit breaks the loop but keeps the process alive for a reattaching
controller; SuperQuit shuts the broker down (broker/broker.go:236-277,
312-323).

Run it with ``python -m gol_distributed_final_tpu_torch.rpc.broker -port P
[-session-capacity N] [-resume CKPT [-ckpt-keep N]] [-device cuda|cpu]``.
``-resume`` reattaches a crashed run: the first fresh Run continues from
the checkpoint's board, turn and rule. Not ported yet, and refused with an
error naming them: the workers backend and its wires (``-auto-checkpoint``
among them), mesh halo depths, the observability flags, the canary, and
the Status verb.
"""

from __future__ import annotations

import argparse
import collections
import logging
import threading

import numpy as np

from ..device import resolve_device
from ..engine.engine import Engine, EngineConfig, RunResult, Snapshot
from ..models import CONWAY, LifeRule
from . import integrity as _integrity
from .client import RpcError
from .protocol import Methods, Request, Response
from .server import RpcServer

logger = logging.getLogger(__name__)


def _rule_of(req: Request) -> LifeRule:
    """The request's rule; "" (or a skewed pickle without the field) is
    Conway, the server default."""
    rulestring = getattr(req, "rulestring", "")
    return LifeRule.from_rulestring(rulestring) if rulestring else CONWAY


class DeviceBackend:
    """Engine-backed data plane on one device: the counterpart of the JAX
    package's ``TpuBackend`` (rpc/broker.py:88) without its mesh planes.
    One persistent Engine serves every Run, so control verbs that land
    before a Run has initialised are buffered by the engine's own
    pending-control semantics instead of being dropped. A request's
    ``halo_depth`` is accepted and has no effect, as on the reference's
    single-device path: one device has no halo to exchange."""

    def __init__(self, device=None):
        self.engine = Engine(EngineConfig(device=device))
        self.device = self.engine.device
        self._planes: dict = {}

    def _plane_for(self, height: int, width: int, rule: LifeRule):
        """None for the engine's own rule (the engine picks its plane);
        for another rule the plane is handed over explicitly, by the same
        policy as the engine's pick (ops/auto.py)."""
        if rule.rulestring == self.engine.config.rule.rulestring:
            return None
        key = (height, width, rule.rulestring)
        if key not in self._planes:
            from ..ops.auto import auto_plane
            from ..ops.plane import BytePlane

            self._planes[key] = (
                auto_plane(rule, (height, width), self.device)
                or BytePlane(rule, self.device)
            )
        return self._planes[key]

    def run(self, req: Request) -> RunResult:
        from ..params import Params

        params = Params(
            turns=req.turns,
            threads=req.threads,
            image_width=req.image_width,
            image_height=req.image_height,
        )
        plane = self._plane_for(req.image_height, req.image_width, _rule_of(req))
        # initial_turn is an extension field: absent from an older
        # client's Request, meaning 0 (a fresh run)
        return self.engine.run(
            params, req.world, plane=plane, initial_turn=getattr(req, "initial_turn", 0)
        )

    def pause(self):
        self.engine.pause()

    def quit(self):
        self.engine.quit()

    def super_quit(self):
        self.engine.super_quit()

    def retrieve(self, include_world: bool) -> Snapshot:
        return self.engine.retrieve(include_world=include_world)


class SessionScheduler:
    """Multi-universe serving: concurrent ``Operations.SessionRun`` verbs
    packed into ONE device-resident batch (engine/sessions.SessionTable).

    Each SessionRun keeps Run's blocking contract — the handler thread
    parks on its session's completion — while one driver thread advances
    the whole batch: one launch per k-turn chunk for every universe. The
    admission bound (``-session-capacity``) refuses loudly instead of
    queueing; the batch serves one geometry and rule at a time, and the
    first admission after the table drains may claim a new one.

    A nonzero client-chosen ``Request.session_id`` tags the session so a
    concurrent Retrieve with the same tag serves THAT universe. A tag
    whose session completed keeps serving its final snapshot from a cache
    bounded both by entries and by retained board bytes, oldest evicted
    first, so a poller trailing a fast universe gets the final snapshot
    rather than an error."""

    #: completed tagged sessions whose final snapshot stays retrievable
    _FINISHED_CAP = 1024
    _FINISHED_BYTES_CAP = 64 << 20  # 64 MiB of retained final boards

    def __init__(self, capacity: int = 256, max_chunk: int = 4096, device=None):
        if capacity < 1:
            raise ValueError(f"session capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.max_chunk = max_chunk
        self.device = resolve_device(device)
        # guards _table, _tags, _finished, _finished_bytes, _stop and
        # _thread; _work is the driver's wake-up on the same lock
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._table = None  # current SessionTable (one geometry/rule)
        self._tags: dict = {}  # session_id -> Session
        self._finished: collections.OrderedDict = collections.OrderedDict()
        self._finished_bytes = 0  # result bytes the cache pins
        self._thread: threading.Thread | None = None
        self._stop = False

    def submit(self, req: Request) -> RunResult:
        """Blocking: admit this Run into the batch, wait for its universe
        to finish, return its result. Raises ``SessionRejected`` on an
        admission refusal (an error reply to the client)."""
        from ..engine.sessions import SessionTable, reject

        rule = _rule_of(req)
        shape = (req.image_height, req.image_width)
        world = np.asarray(req.world, np.uint8)
        tag = getattr(req, "session_id", 0)
        with self._work:
            if self._stop:
                raise RpcError("broker is shutting down")
            if self._table is not None and self._table.occupancy == 0 and (
                self._table.shape != shape
                or self._table.rule.rulestring != rule.rulestring
            ):
                self._table = None  # drained: a new geometry may claim it
            if self._table is None:
                self._table = SessionTable(
                    rule, shape, self.capacity, max_chunk=self.max_chunk,
                    device=self.device,
                )
            if self._table.rule.rulestring != rule.rulestring:
                raise reject(
                    "rule",
                    f"this batch serves {self._table.rule.rulestring}, "
                    f"not {rule.rulestring} (one rule per batch)",
                )
            if tag and tag in self._tags:
                raise reject("tag", f"session tag {tag} already in use")
            # geometry/capacity/turns admission happens in the table
            sess = self._table.admit(world, req.turns)
            if tag:
                self._tags[tag] = sess
                # a reused tag belongs to its NEW session now
                old = self._finished.pop(tag, None)
                if old is not None and old.result is not None:
                    self._finished_bytes -= old.result.nbytes
            if self._thread is None:
                self._thread = threading.Thread(target=self._drive, daemon=True)
                self._thread.start()
            self._work.notify_all()
        try:
            sess.done.wait()
        finally:
            with self._lock:
                # re-checked under the lock: a racing re-admission of the
                # tag owns it now and is never clobbered
                if tag and self._tags.get(tag) is sess:
                    del self._tags[tag]
                    if sess.error is None and sess.result is not None:
                        # healthy completions only: a failed or cancelled
                        # session stays a loud retrieve error
                        self._finished[tag] = sess
                        self._finished_bytes += sess.result.nbytes
                        while self._finished and (
                            len(self._finished) > self._FINISHED_CAP
                            or self._finished_bytes > self._FINISHED_BYTES_CAP
                        ):
                            _, old = self._finished.popitem(last=False)
                            if old.result is not None:
                                self._finished_bytes -= old.result.nbytes
        if sess.error is not None:
            raise RpcError(f"session batch failed: {sess.error}")
        return RunResult(sess.turns_done, sess.result)

    def retrieve(self, tag: int, include_world: bool) -> Snapshot:
        """ONE universe's (turn, alive) pair — and optionally its board —
        demuxed from the batch; a completed tag from the finished cache; a
        tag never seen (or evicted) is a loud error, never a silent global
        snapshot."""
        with self._lock:
            sess = self._tags.get(tag)
            table = self._table
            done = self._finished.get(tag)
        if sess is not None and table is not None:
            world, turn, alive = table.snapshot(sess, include_world=include_world)
            return Snapshot(world, turn, alive)
        if done is not None:
            return Snapshot(
                done.result if include_world else None, done.turns_done, done.alive_count
            )
        raise RpcError(f"no session with tag {tag}")

    def _drive(self) -> None:
        """The driver thread: advance the batch whenever it has work; on
        an advance failure, fail every in-flight session loudly (their
        blocked handlers re-raise) rather than hang them."""
        while True:
            with self._work:
                while not self._stop and (
                    self._table is None or self._table.occupancy == 0
                ):
                    self._work.wait()
                if self._stop:
                    return
                table = self._table
            try:
                table.advance()
            except Exception as exc:  # noqa: BLE001 — must not hang waiters
                logger.exception("session batch driver failed")
                table.fail_all(exc)

    def close(self) -> None:
        with self._work:
            self._stop = True
            table, self._table = self._table, None
            self._work.notify_all()
        if table is not None:
            table.fail_all(RpcError("broker is shutting down"))


def _require_request(req) -> Request:
    """Skew tolerance is for Request objects missing newer fields (read
    with getattr), never for arbitrary frames: a missing/None/list request
    stays an error reply."""
    if not isinstance(req, Request):
        raise TypeError(f"request must be a Request, got {type(req).__name__}")
    return req


def _reply(result) -> Response:
    # alive stays empty on the wire: the client derives cells from the
    # world it receives instead of this side pickling O(alive) Cells
    return Response(
        alive=[],
        alive_count=int(np.count_nonzero(result.world)),
        turns_completed=result.turns_completed,
        world=result.world,
    )


class BrokerService:
    """Maps the wire verbs onto a backend; owns process shutdown. Every
    board a reply carries is a numpy uint8 array.

    ``resume`` is the crash-recovery stash of ``-resume``: a ``(world,
    turn, rule)`` checkpoint loaded at broker start. The first fresh Run
    (initial_turn 0) is rewritten to continue from the stashed turn, and
    the stash is consumed once that run has progressed past it; later
    Runs start fresh, the reference's reset-on-Run semantics."""

    def __init__(
        self,
        server: RpcServer,
        backend: DeviceBackend,
        resume=None,
        session_capacity: int = 256,
    ):
        self._server = server
        self.backend = backend
        self._resume = resume  # (world, turn, rule) | None
        self.quit_event = threading.Event()
        # built lazily: a broker that never serves sessions never starts
        # the driver
        self._session_capacity = session_capacity
        self._sessions: SessionScheduler | None = None
        self._sessions_lock = threading.Lock()

    def _session_scheduler(self) -> SessionScheduler:
        with self._sessions_lock:
            if self._sessions is None:
                self._sessions = SessionScheduler(
                    self._session_capacity, device=self.backend.device
                )
            return self._sessions

    def _apply_resume(self, req: Request) -> None:
        """Rewrite a fresh Run to continue from the ``-resume`` checkpoint.
        A mismatch is an error: an operator who restarted with -resume must
        not silently get a run from turn 0, or a mislabelled board."""
        world, turn, rule = self._resume
        if req.world is None or req.world.shape != world.shape:
            raise ValueError(
                f"-resume checkpoint board is "
                f"{world.shape[1]}x{world.shape[0]} but the Run asks "
                f"{req.image_width}x{req.image_height}"
            )
        if req.turns <= turn:
            raise ValueError(
                f"-resume checkpoint is at turn {turn}, not before "
                f"turns={req.turns}: nothing would run"
            )
        requested = getattr(req, "rulestring", "")
        if requested:
            # canonical before comparing: "b3/s23" is the Conway it spells
            requested = LifeRule.from_rulestring(requested).rulestring
            if requested != rule.rulestring:
                raise ValueError(
                    f"-resume checkpoint rule {rule.rulestring} conflicts "
                    f"with the Run's {requested}"
                )
        req.world = world
        req.initial_turn = turn
        if rule.rulestring != CONWAY.rulestring:
            req.rulestring = rule.rulestring
        logger.info("Run reattached to -resume checkpoint at turn %d", turn)

    def run(self, req: Request) -> Response:
        req = _require_request(req)
        resumed = False
        if self._resume is not None and not getattr(req, "initial_turn", 0):
            self._apply_resume(req)
            resumed = True
        initial_turn = getattr(req, "initial_turn", 0)
        if not 0 <= initial_turn <= req.turns:
            raise ValueError(f"initial_turn {initial_turn} outside [0, {req.turns}]")
        if req.world is not None and req.world.shape != (req.image_height, req.image_width):
            raise ValueError(
                f"world shape {req.world.shape} does not match params "
                f"{req.image_width}x{req.image_height}"
            )
        result = self.backend.run(req)
        if resumed and result.turns_completed > initial_turn:
            # consumed only once the run progressed past the checkpoint: a
            # Run that a buffered Quit ended at once must not burn it, or
            # the retried Run would silently start from turn 0
            self._resume = None
        return _reply(result)

    def session_run(self, req: Request) -> Response:
        """Operations.SessionRun — Run's blocking contract, many at once:
        concurrent handler threads admit into one device-batched session
        table and each parks until ITS universe finishes."""
        req = _require_request(req)
        if req.world is None or req.world.shape != (req.image_height, req.image_width):
            raise ValueError(
                f"world shape {None if req.world is None else req.world.shape} "
                f"does not match params {req.image_width}x{req.image_height}"
            )
        return _reply(self._session_scheduler().submit(req))

    def pause(self, req: Request) -> Response:
        self.backend.pause()
        return Response()

    def quit(self, req: Request) -> Response:
        self.backend.quit()
        return Response()

    def super_quit(self, req: Request) -> Response:
        self.backend.super_quit()
        # reply first and let an in-flight Run return its result, THEN
        # close the listener (broker/broker.go:312-323's goroutine)
        threading.Thread(target=self._shutdown_when_idle, daemon=True).start()
        return Response()

    def _shutdown_when_idle(self):
        # waits until every dispatch, the SuperQuit call included, has
        # fully SENT its reply
        self._server.wait_idle(timeout=60)
        self.shutdown()

    def retrieve(self, req: Request) -> Response:
        req = _require_request(req)
        include_world = getattr(req, "include_world", True)
        tag = getattr(req, "session_id", 0)
        if tag:
            snap = self._session_scheduler().retrieve(tag, include_world)
        else:
            snap = self.backend.retrieve(include_world)
        return Response(
            alive_count=snap.alive_count,
            turns_completed=snap.turns_completed,
            world=snap.world,
            alive=[],
        )

    def shutdown(self):
        """Fail in-flight sessions loudly, close the listener, and release
        ``quit_event``."""
        with self._sessions_lock:
            sessions = self._sessions
        if sessions is not None:
            sessions.close()
        self._server.stop()
        self.quit_event.set()


def serve(
    port: int = 8040,
    host: str = "127.0.0.1",
    session_capacity: int = 256,
    device=None,
    resume=None,
) -> tuple[RpcServer, BrokerService]:
    """Start a broker on ``device`` (None is the CUDA card, and raises
    without one; "cpu" for the tests) listening on ``host:port`` (0 picks
    a free port, ``server.port`` says which), serving in background
    threads; ``resume`` is a verified ``(world, turn, rule)`` checkpoint
    for the first fresh Run. Stop it with ``service.shutdown()``."""
    backend = DeviceBackend(device)
    server = RpcServer(host=host, port=port)
    service = BrokerService(
        server, backend, resume=resume, session_capacity=session_capacity
    )
    server.register(Methods.BROKER_RUN, service.run)
    server.register(Methods.SESSION_RUN, service.session_run)
    server.register(Methods.PAUSE, service.pause)
    server.register(Methods.QUIT, service.quit)
    server.register(Methods.SUPER_QUIT, service.super_quit)
    server.register(Methods.RETRIEVE, service.retrieve)
    server.serve_background()
    return server, service


#: the reference broker's flags this slice does not carry, each refused
#: by name
_NOT_PORTED = (
    "-workers", "-wire", "-sync-interval", "-grid", "-sparse-sync",
    "-rpc-deadline", "-auto-checkpoint", "-probe-interval", "-metrics", "-timeline", "-trace", "-journal",
    "-profile", "-canary", "-canary-verb",
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="GoL broker on one device", allow_abbrev=False
    )
    parser.add_argument("-port", type=int, default=8040)
    parser.add_argument(
        "-host", default="127.0.0.1",
        help="bind address; 0.0.0.0 opts into external exposure",
    )
    parser.add_argument(
        "-backend", choices=("tpu", "workers"), default="tpu",
        help="tpu: the on-device engine (the reference's name for it; the "
             "only backend ported)",
    )
    parser.add_argument(
        "-halo-depth", dest="halo_depth", type=int, default=1,
        help="turns per halo exchange of the mesh planes (not ported: "
             "only 1, a no-op on one device)",
    )
    parser.add_argument(
        "-integrity", choices=("on", "off"), default="on",
        help="frame checksums (rpc/integrity.py); default on",
    )
    parser.add_argument(
        "-session-capacity", dest="session_capacity", type=int, default=256,
        metavar="N",
        help="max concurrent SessionRun universes in the device batch; "
             "admissions past it are refused with an error reply",
    )
    parser.add_argument(
        "-resume", default=None, metavar="CKPT",
        help="reattach a crashed run: the first fresh Run continues from "
             "this checkpoint's board and turn instead of turn 0 "
             "(consumed once; later Runs start fresh). The checkpoint "
             "must VERIFY (embedded digest, engine/checkpoint.py); with "
             "-ckpt-keep N an unverifiable newest generation falls back "
             "to the newest one that does verify",
    )
    parser.add_argument(
        "-ckpt-keep", dest="ckpt_keep", type=int, default=1, metavar="N",
        help="checkpoint generations -resume searches, newest first, for "
             "one that verifies (default 1: current only)",
    )
    parser.add_argument(
        "-device", default="cuda",
        help="where boards live: cuda (default; fails without a card) or cpu",
    )
    args, rest = parser.parse_known_args(argv)
    for token in rest:
        flag = token.split("=", 1)[0]
        if flag in _NOT_PORTED:
            parser.error(f"{flag} is not ported yet")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.backend == "workers":
        parser.error("-backend workers is not ported yet")
    if args.halo_depth != 1:
        parser.error("-halo-depth other than 1 is not ported yet (no mesh planes)")
    if args.ckpt_keep < 1:
        parser.error(f"-ckpt-keep must be >= 1, got {args.ckpt_keep}")
    if args.ckpt_keep != 1 and not args.resume:
        parser.error("-ckpt-keep rotates -auto-checkpoint generations "
                     "(workers backend) and widens -resume's fallback "
                     "search; it does nothing here")
    if args.session_capacity < 1:
        parser.error(f"-session-capacity must be >= 1, got {args.session_capacity}")
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    resume = None
    if args.resume:
        from ..engine.checkpoint import CheckpointError, load_resume_checkpoint

        try:
            board, turn, rule, gen = load_resume_checkpoint(args.resume, keep=args.ckpt_keep)
        except CheckpointError as exc:
            parser.error(f"-resume {args.resume}: {exc}")
        if gen > 0:
            logger.warning(
                "-resume %s: newest generation(s) failed verification; "
                "fell back to verified generation %d (turn %d)",
                args.resume, gen, turn,
            )
        resume = (board, turn, rule)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    _integrity.set_enabled(args.integrity == "on")
    server, service = serve(
        args.port, host=args.host, session_capacity=args.session_capacity,
        device=device, resume=resume,
    )
    print(f"broker listening on :{server.port} (backend={args.backend})", flush=True)
    service.quit_event.wait()


if __name__ == "__main__":
    main()
