"""The GoL engine — the broker's ``Operations`` service on a board that
stays on the device.

The reference broker runs a host-side per-turn loop that re-ships the full
board to every worker each turn (broker/broker.go:62-234). Here the board
never leaves the device during compute: the engine launches *chunks* of
turns through its data plane (ops/plane.py) and services control traffic —
pause / quit / snapshot, the semantics of broker/broker.go:236-277 —
between chunks. Chunks grow by doubling and are capped by a wall-clock
target so the 2-second alive-count cadence and the 5-second first-report
bound (count_test.go:30-38) hold regardless of board size.

CUDA launches return before the card has run them, so chunk timing waits
for the card: a growth chunk synchronises before its wall is read, and
once growth ends one CUDA event per chunk bounds the chunks in flight to
``_PIPELINE_DEPTH``. Without that, growth would see only enqueue time and
chunks would grow without bound.

Concurrency model: ``run`` executes on the caller's thread; ``pause`` /
``quit`` / ``super_quit`` / ``retrieve`` may be called from any other
thread (the controller's ticker). The state is guarded by a lock, like
the broker's ``cWorld``/``cTurn`` under ``mt sync.Mutex``
(broker/broker.go:32-36). Every kernel launches on the default stream, so
a ticker's copy of the chunk's counts orders after the chunk.

Each chunk is metered as the JAX package's engine meters it (obs/): a
span and an ``engine.chunk`` profiler range, the step, dispatch, park
and checkpoint histograms, turns, chunks and chunk size, HBM samples, the
journal's run, chunk, early-exit and checkpoint records, the flight
recorder's crash dump and a timeline tick. The dispatch wall of a growth
chunk is the synchronised wall above, and the kernels' event pairs
(obs/device.py) are folded in after each synchronisation the loop makes.
With attribution on, a chunk's ``device_compute`` segment is device time:
a timing event before its launches paired with the fence after them.

The host phases of a run are spans (obs/tracing.py): ``engine.encode``
(the host board to the device state), ``engine.chunk`` (a chunk's
enqueue), ``engine.sync`` (the host blocked on the card: a growth chunk's
synchronisation, a pipeline fence, the queued chunks before the final
decode) and ``engine.decode`` (the device state back to the host board at
the run's end).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..events import CellFlipped, TurnComplete
from ..models import CONWAY, LifeRule
from ..obs import device as _device
from ..obs import flight as _flight
from ..obs import instruments as _ins
from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..obs import perf as _perf
from ..obs import timeline as _timeline
from ..obs import tracing as _tracing
from ..ops.reduce import alive_cells
from ..utils.cell import Cell

# chunks in flight before the run loop waits for the oldest: deep enough
# that the host keeps the card fed, shallow enough that at most 4 chunk
# outputs are live on the device and a retrieve observes a state at most
# ~depth dispatch-targets old
_PIPELINE_DEPTH = 3


def _cards(state) -> list:
    """The CUDA devices that hold a plane's ``state``: a tensor, or a
    state holding its board in ``packed`` (ops/sparse.py::SparseState),
    whose blocks may sit on several cards (a mesh state); empty off the
    card."""
    board = getattr(state, "packed", state)
    if not board.is_cuda:
        return []
    return getattr(board, "cuda_devices", [board.device])


class _CrashRecords:
    """Around a run: an exception leaving it dumps the flight ring and
    flushes the journal with the crash recorded (both no-ops when off),
    then propagates. A context manager, so the run loop holds no
    exception handler."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            _flight.dump_on_crash(exc)
            _journal.flush_on_crash(exc)
        return False


class Snapshot(NamedTuple):
    """What ``RetrieveCurrentData`` returns (broker/broker.go:256-277).
    ``world`` is None for count-only snapshots (retrieve(include_world=False))."""

    world: Optional[np.ndarray]
    turns_completed: int
    alive_count: int

    @property
    def alive(self) -> List[Cell]:
        return [] if self.world is None else alive_cells(self.world)


class RunResult:
    """What ``Operations.Run`` returns (broker/broker.go:228-230).

    ``alive`` is derived on first access, from ``world`` when the run
    decoded one, else from the final plane state (a ``final_world=False``
    run, whose byte raster never exists), unless the caller hands the
    cells over (a remote broker that ships them). The positional order is
    the JAX package's.

    ``checkpoint_error`` is the last periodic checkpoint's failure, of any
    type: a failed write does not end the run it protects."""

    __slots__ = (
        "turns_completed", "world", "checkpoint_error", "_alive", "_state", "_plane",
    )

    def __init__(
        self,
        turns_completed: int,
        world: Optional[np.ndarray],
        alive: Optional[List[Cell]] = None,
        state=None,
        plane=None,
        checkpoint_error: Optional[Exception] = None,
    ):
        self.turns_completed = turns_completed
        self.world = world
        self.checkpoint_error = checkpoint_error
        self._alive = alive
        self._state = state
        self._plane = plane

    @property
    def alive(self) -> List[Cell]:
        if self._alive is None:
            if self.world is not None:
                self._alive = alive_cells(self.world)
            else:
                self._alive = self._plane.alive_cells(self._state)
        return self._alive

    @property
    def alive_count(self) -> int:
        """The live-cell total without building the Cell list: a popcount
        on the device for plane-state results."""
        if self._alive is not None:
            return len(self._alive)
        if self.world is not None:
            return int(np.count_nonzero(self.world))
        return int(self._plane.alive_count(self._state))


@dataclasses.dataclass
class EngineConfig:
    rule: LifeRule = CONWAY
    # chunking: double from min_chunk up to max_chunk, but stop growing
    # once a chunk takes target_dispatch_seconds on the device, which keeps
    # control latency (pause, quit, a 2 s tick) low; long headless runs can
    # raise min_chunk to skip the warm-up doublings
    min_chunk: int = 1
    max_chunk: int = 4096
    target_dispatch_seconds: float = 0.25
    # pick the data plane by shape (ops/auto.py); False keeps the byte
    # plane's roll stencil
    auto_fast: bool = True
    # False: RunResult ships world=None and derives `alive` from the plane
    # state instead of decoding the final board
    final_world: bool = True
    # periodic crash-recovery checkpoints: each time the turn counter
    # crosses a multiple of checkpoint_every, the committed state goes to
    # checkpoint_path between chunks (packed .npz for a bitboard plane, no
    # decode; the byte format otherwise); 0 disables them
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None
    # called between chunks as chunk_hook(engine, state, turn)
    chunk_hook: Optional[Callable] = None
    # optional override: a (board, n) -> board step on the uint8 {0,255}
    # board, e.g. ops/fused.fused_step_n or ops/pallas_stencil
    # .pallas_step_n_fn(rule); it gets the board as a tensor on the
    # engine's device and must return one of the same device, dtype and
    # shape
    step_n_fn: Optional[Callable] = None
    # optional override: a full data plane (ops/plane.py interface)
    plane: Optional[object] = None
    # where the board lives: None is the CUDA card (raises without one);
    # "cpu" runs the kernels' plain torch versions
    device: object = None


class Engine:
    """Evolves one board; serves Run/Pause/Quit/SuperQuit/Retrieve."""

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        if self.device.type == "cuda":
            # build the kernels now: a chunk whose wall included an nvcc
            # run would end the chunk doubling at its first step
            from ..ops import _build

            _build.build()
        self._lock = threading.Lock()
        self._control = threading.Condition(self._lock)
        # the device-resident board in its plane's representation, owned by
        # the run loop; kept after a run ends so Retrieve keeps serving the
        # final snapshot (the cWorld analogue)
        self._state = None
        self._plane = None
        # the committed state's alive counts from a fused chunk
        # (step_n_counted): a device vector whose int64 host sum is the
        # alive count; cleared by any other commit
        self._state_counts = None
        self._world_host: np.ndarray | None = None  # last synced host copy
        self._host_dirty = False
        self._turn = 0
        self._paused = False
        self._parked = False  # run loop is actually waiting in the pause gate
        self._quit = False
        self._super_quit = False
        self._running = False

    # -- compute ----------------------------------------------------------

    def _choose_plane(self, world_shape, step_n_fn, plane, emit_flips):
        """Per-run plane selection, in the JAX engine's order: explicit
        plane > explicit step function > config plane > config step
        function > auto bitboard (not with per-cell flips, which diff byte
        boards every turn) > byte stencil. A step function wins even with
        per-cell flips."""
        from ..ops.plane import BytePlane

        rule = self.config.rule
        if plane is not None:
            return plane
        if step_n_fn is not None:
            return BytePlane(rule, self.device, step_n_fn)
        if self.config.plane is not None:
            return self.config.plane
        if self.config.step_n_fn is not None:
            return BytePlane(rule, self.device, self.config.step_n_fn)
        if self.config.auto_fast and not emit_flips:
            from ..ops.auto import auto_plane

            fast = auto_plane(rule, world_shape, self.device)
            if fast is not None:
                return fast
        return BytePlane(rule, self.device)

    def _sync_host(self):
        """Refresh the host snapshot from the device state (under lock)."""
        if self._host_dirty and self._state is not None:
            self._world_host = self._plane.decode(self._state)
            self._host_dirty = False

    # -- Operations.Run (broker/broker.go:62-234) -------------------------

    def run(
        self,
        params,
        world: Optional[np.ndarray],
        *,
        emit: Optional[Callable] = None,
        emit_flips: bool = False,
        step_n_fn: Optional[Callable] = None,
        plane=None,
        initial_turn: int = 0,
        initial_state=None,
    ) -> RunResult:
        """Blocking: evolve ``world`` for ``params.turns`` turns (or until
        quit). Resets the turn counter to ``initial_turn`` — 0, so a
        reattaching controller starts a fresh run (README.md:187,
        broker/broker.go:64); a checkpoint's turn for a resume.

        With ``emit_flips`` every turn emits ``CellFlipped`` for each
        changed cell before ``TurnComplete`` (gol/event.go:50-60) —
        including the initial flips for cells alive in the loaded image.

        ``step_n_fn`` steps the uint8 board for this run in place of the
        data plane the engine would pick (``EngineConfig.step_n_fn`` sets
        one for every run; ``_choose_plane`` says which wins).

        ``initial_state`` starts the run from a state already in
        ``plane``'s representation (``world`` None, ``plane`` explicit,
        ``EngineConfig(final_world=False)``): the board never exists as
        bytes.
        """
        if initial_state is not None:
            if world is not None or emit_flips:
                raise ValueError(
                    "initial_state replaces world (pass world=None) and "
                    "cannot emit per-cell flips"
                )
            if plane is None:
                raise ValueError(
                    "initial_state needs an explicit plane: the engine "
                    "cannot infer the representation from a byte board"
                )
            if self.config.final_world:
                raise ValueError(
                    "initial_state requires EngineConfig(final_world=False)"
                )
        else:
            # defensive copy: the caller may reuse its buffer, and we hand
            # this array out via retrieve()/emit_flips diffs
            world = np.array(world, np.uint8, copy=True)
            world.flags.writeable = False
        with self._lock:
            if self._running:
                raise RuntimeError("engine is already running")
            self._running = True
            self._state_counts = None
            if initial_state is not None:
                self._plane = plane
                self._state = initial_state
                self._world_host = None
                self._host_dirty = True
            else:
                self._plane = self._choose_plane(
                    world.shape, step_n_fn, plane, emit_flips
                )
                encode_span = _tracing.start_span(_tracing.SPAN_ENGINE_ENCODE)
                self._state = self._plane.encode(world)
                _tracing.end_span(encode_span)
                self._world_host = world
                self._host_dirty = False
            self._turn = initial_turn
            # _quit/_paused are NOT reset here: a quit() or pause() issued
            # after the controller started its ticker but before the run
            # loop initialised must still take effect

        # pre-run HBM baseline, once a run: even a run that dies in its
        # first chunk leaves the pre-run occupancy on the gauges
        _device.sample_hbm()

        # a state sharded over several processes (parallel/mesh.py): every
        # rank runs this same loop, and every collective (halos, counts,
        # votes) must come in the same order on every rank, so no decision
        # here may rest on a rank-local wall clock
        multiprocess = not getattr(self._state, "is_fully_addressable", True)
        if multiprocess and self.config.checkpoint_every:
            # only a packed plane has a multi-process format (one shard per
            # rank): fail at entry, not hours in
            if getattr(self._plane, "word_axis", None) is None:
                with self._lock:
                    self._running = False
                    self._control.notify_all()
                raise ValueError(
                    "checkpoint_every on a multi-process state needs a packed "
                    "bitboard plane (per-rank shard checkpoints); this "
                    "plane has no word_axis"
                )

        # an unhandled engine exception is the moment the flight recorder
        # exists for: its ring is dumped (no-op unless -trace) and the
        # journal flushed with the crash recorded, then it propagates
        with _CrashRecords():
            try:
                _journal.record(
                    "run.start", "engine", turns=int(params.turns),
                    initial_turn=initial_turn,
                )
                if emit_flips and emit is not None:
                    for c in alive_cells(world):
                        emit(CellFlipped(0, c))
                chunk = max(1, min(self.config.min_chunk, self.config.max_chunk))
                ckpt_error: Exception | None = None
                # once the chunk size stops growing, chunks are queued without
                # waiting and the loop only blocks when more than
                # _PIPELINE_DEPTH are outstanding (one CUDA event each)
                inflight: deque = deque()
                growth_done = False  # doubling ended (max_chunk OR slow chunk)
                while True:
                    t_iter0 = time.monotonic()
                    park_dt = 0.0
                    with self._lock:
                        if self._paused and not self._quit:
                            # the park gate, timed and spanned: how long
                            # control traffic held the data plane still
                            t_park = time.monotonic()
                            park_span = _tracing.start_span(
                                _tracing.SPAN_ENGINE_PARK, turn=self._turn
                            )
                            while self._paused and not self._quit:
                                self._parked = True
                                self._control.notify_all()
                                self._control.wait()
                            _tracing.end_span(park_span)
                            park_dt = time.monotonic() - t_park
                            _ins.ENGINE_PARK_SECONDS.observe(park_dt)
                        self._parked = False
                        if self._quit or self._turn >= params.turns:
                            break
                        n = min(chunk, params.turns - self._turn)
                        if emit_flips:
                            n = 1
                        state = self._state
                        active_plane = self._plane
                        # early exit (ops/plane.py protocol): a plane that
                        # marked its state steady jumps ALL remaining turns
                        early = None
                        if not emit_flips:
                            from ..ops.plane import plane_steady_kind

                            early = plane_steady_kind(active_plane, state)
                            if early:
                                n = params.turns - self._turn

                    growing = not emit_flips and not growth_done
                    attribution = _metrics.enabled() and _perf.attribution_enabled()
                    # on the card, the chunk's device time opens here and
                    # closes at the fence below (obs/device.py)
                    starts = None
                    if attribution:
                        cards = _cards(state)
                        if cards:
                            starts = _device.chunk_begin(cards)
                    t0 = time.monotonic()
                    # per-chunk span (one flag check when -trace is off): the
                    # enqueue, the wait being engine.sync's; the same name as
                    # a profiler range under -trace-device
                    chunk_span = (
                        _tracing.start_span(_tracing.SPAN_ENGINE_CHUNK, turns=n)
                        if _tracing.enabled() else None
                    )
                    chunk_counts = None
                    with _tracing.annotate("engine.chunk"):
                        if early:
                            new_state = active_plane.fast_forward(state, n)
                        elif not emit_flips and hasattr(active_plane, "step_n_counted"):
                            # the chunk's turns AND its alive reduction
                            # together; the committed counts serve the
                            # count-only Retrieve
                            new_state, chunk_counts = active_plane.step_n_counted(state, n)
                        else:
                            new_state = active_plane.step_n(state, n)
                    if chunk_span is not None:
                        _tracing.end_span(chunk_span, sync=growing)
                    cards = _cards(new_state)
                    if cards:
                        fences = None
                        if not growing or starts is not None:
                            fences = []
                            for card in cards:
                                fences.append(torch.cuda.Event(enable_timing=starts is not None))
                                fences[-1].record(torch.cuda.current_stream(card))
                        if starts is not None:
                            _device.chunk_end(starts, fences)
                        if growing:
                            # the wall below drives the doubling: it must
                            # cover the card's work, not the launch
                            sync_span = _tracing.start_span(_tracing.SPAN_ENGINE_SYNC)
                            for card in cards:
                                torch.cuda.synchronize(card)
                            _tracing.end_span(sync_span)
                        else:
                            inflight.append(fences)
                            if len(inflight) > _PIPELINE_DEPTH:
                                sync_span = _tracing.start_span(_tracing.SPAN_ENGINE_SYNC)
                                for fence in inflight.popleft():
                                    fence.synchronize()
                                _tracing.end_span(sync_span)
                        if _metrics.enabled():
                            # the launches and chunks the card has finished
                            _device.resolve()
                    elapsed = time.monotonic() - t0
                    if attribution:
                        # dispatch-wall decomposition (obs/perf.py): planning
                        # and lock time before the dispatch against the
                        # dispatch itself; the demux segment closes after the
                        # commit below. On the card the dispatch is the
                        # chunk's device time, folded in by resolve()
                        _ins.TURN_SEGMENT_SECONDS.labels("engine", "host_prep").observe(
                            max(0.0, t0 - t_iter0 - park_dt)
                        )
                        if not cards:
                            _ins.TURN_SEGMENT_SECONDS.labels(
                                "engine", "device_compute"
                            ).observe(elapsed)
                    if _metrics.enabled() and not early:
                        # the chunk's wall spread over its turns, so the step
                        # histogram's count is the turn count; an early-exit
                        # jump is excluded: its turns were never computed
                        _ins.ENGINE_DISPATCH_SECONDS.observe(elapsed)
                        _ins.ENGINE_STEP_SECONDS.observe_n(elapsed / n, n)
                        _ins.ENGINE_TURNS_TOTAL.inc(n)
                        _ins.ENGINE_CHUNKS_TOTAL.inc()
                        _ins.ENGINE_CHUNK_SIZE.set(chunk)
                    if _metrics.enabled():
                        _device.sample_hbm()
                    # opportunistic timeline tick at the chunk boundary
                    _timeline.maybe_sample()
                    if growing and multiprocess:
                        # the ranks agree on the slowest rank's wall, so every
                        # rank takes the same growth decision (one all-gather a
                        # growth chunk, at most log2(max_chunk) a run)
                        from ..parallel.multihost import allgather

                        elapsed = float(allgather(np.array([elapsed], np.float64)).max())
                    if growing:
                        if chunk >= self.config.max_chunk or (
                            elapsed >= self.config.target_dispatch_seconds
                        ):
                            # whichever way doubling ends, later chunks go
                            # async and never re-trigger doubling
                            growth_done = True
                        else:
                            chunk = min(chunk * 2, self.config.max_chunk)

                    t_commit0 = time.monotonic()
                    with self._lock:
                        prev_host = self._world_host if emit_flips else None
                        self._state = new_state
                        # a stale count must never outlive its state
                        self._state_counts = chunk_counts
                        self._host_dirty = True
                        self._turn += n
                        turn_now = self._turn
                        if emit_flips:
                            self._sync_host()
                            new_host = self._world_host

                    # journal outside the lock: one record a chunk boundary
                    _journal.record(
                        "chunk.commit", "engine", k=n, turn=turn_now,
                        route="early" if early else (
                            "fused" if chunk_counts is not None else "plain"
                        ),
                    )
                    if early:
                        _journal.record("early.exit", early, turn=turn_now)
                    if emit_flips and emit is not None:
                        changed = np.nonzero(prev_host != new_host)
                        for y, x in zip(*changed):
                            emit(CellFlipped(turn_now, Cell(int(x), int(y))))
                        emit(TurnComplete(turn_now))
                    if attribution:
                        _ins.TURN_SEGMENT_SECONDS.labels("engine", "demux").observe(
                            time.monotonic() - t_commit0
                        )

                    if self.config.chunk_hook is not None:
                        # a hook that blocks IS a pause: the loop cannot
                        # advance past it
                        self.config.chunk_hook(self, new_state, turn_now)

                    every = self.config.checkpoint_every
                    if every and turn_now // every > (turn_now - n) // every:
                        # an HBM sample at every checkpoint, metrics on or off:
                        # it advances the peak the RunReport publishes
                        _device.sample_hbm()
                        t_ckpt = time.monotonic()
                        ckpt_span = _tracing.start_span(
                            _tracing.SPAN_ENGINE_CHECKPOINT, turn=turn_now
                        )
                        err = self._write_checkpoint(new_state, turn_now)
                        if err is None:
                            _journal.record("ckpt.write", "engine", turn=turn_now)
                        else:
                            ckpt_error = err
                            _ins.ENGINE_CHECKPOINT_ERRORS_TOTAL.inc()
                        _tracing.end_span(ckpt_span, ok=err is None)
                        _ins.ENGINE_CHECKPOINT_SECONDS.observe(time.monotonic() - t_ckpt)

                if inflight and self.config.final_world:
                    # the decode below would wait for the queued chunks
                    # anyway: wait here, so that the wait is engine.sync's
                    # and engine.decode times the copy and the unpack
                    sync_span = _tracing.start_span(_tracing.SPAN_ENGINE_SYNC)
                    for fence in inflight[-1]:
                        fence.synchronize()
                    _tracing.end_span(sync_span)
                with self._lock:
                    turns_done = self._turn
                    if self.config.final_world:
                        decode_span = _tracing.start_span(_tracing.SPAN_ENGINE_DECODE)
                        self._sync_host()
                        _tracing.end_span(decode_span)
                        if _metrics.enabled():
                            # the decode waited for the last chunks
                            _device.resolve()
                        return RunResult(
                            turns_done, self._world_host, checkpoint_error=ckpt_error
                        )
                    state_f, plane_f = self._state, self._plane
                return RunResult(
                    turns_done, None, state=state_f, plane=plane_f,
                    checkpoint_error=ckpt_error,
                )
            finally:
                _journal.record("run.end", "engine", turn=self._turn)
                with self._lock:
                    self._running = False
                    self._paused = False
                    self._quit = False  # consumed; a reattached run starts fresh
                    # _plane/_state stay: Retrieve keeps serving the final board
                    self._control.notify_all()

    def _write_checkpoint(self, state, turn: int) -> Optional[Exception]:
        """The periodic checkpoint of ``state`` at ``turn``, between chunks:
        packed for a bitboard plane, the byte format otherwise, under the
        ACTIVE plane's rule (an explicit ``BitPlane(HIGHLIFE)`` run must not
        stamp a Conway checkpoint). Returns the failure, of any type,
        instead of raising it: a full disk, a host buffer that cannot be
        allocated or a failed decode must not end the run the checkpoint
        protects.

        ``state`` is the chunk just committed. No later chunk is queued yet,
        and a plane's step never writes its input (ops/plane.py), so the
        host copy, on the stream after that chunk, reads the state of
        ``turn`` and nothing a queued chunk is writing."""
        from .checkpoint import try_write_checkpoint, try_write_checkpoint_sharded

        path = self.config.checkpoint_path or "out/engine_ck.npz"
        rule = getattr(self._plane, "rule", self.config.rule)
        if not getattr(state, "is_fully_addressable", True):
            # run() entry made sure a multi-process plane is packed
            err = try_write_checkpoint_sharded(path, turn, rule, self._plane, state)
        else:
            err = try_write_checkpoint(path, turn, rule, self._plane, state)
        if err is not None:
            print(f"checkpoint at turn {turn} failed: {err}")
        return err

    # -- control plane (broker/broker.go:236-277) -------------------------

    def pause(self) -> bool:
        """Toggle pause; same RPC both pauses and resumes
        (broker/broker.go:251-254, 83-86, 126-129). Returns new paused state.

        On pause, blocks until the run loop has actually parked (any
        in-flight chunk has committed), so after pause() returns the board
        is guaranteed not to advance until resume."""
        with self._lock:
            self._paused = not self._paused
            state = self._paused
            self._control.notify_all()
            print("State paused" if state else "State unpaused")
            if state:
                while (
                    self._paused
                    and self._running
                    and not self._parked
                    and not self._quit
                ):
                    self._control.wait(timeout=0.1)
            return state

    def quit(self):
        """Break the run loop; the engine object survives and accepts a new
        ``run`` (broker/broker.go:236-239 + README.md:187)."""
        with self._lock:
            self._quit = True
            self._control.notify_all()

    def super_quit(self):
        """Coordinated full shutdown (broker/broker.go:241-249). At engine
        level this is quit and a flag the owning server reads to stop
        serving."""
        with self._lock:
            self._super_quit = True
            self._quit = True
            self._control.notify_all()

    @property
    def super_quit_requested(self) -> bool:
        with self._lock:
            return self._super_quit

    def final_state(self):
        """The current state in its plane's representation, without a
        decode: the latest committed chunk mid-run, the final board after
        (what a big-board caller streams to PGM)."""
        with self._lock:
            return self._state

    def state_snapshot(self):
        """``(state, turns_completed)`` under one lock acquisition: two
        separate reads could straddle a chunk commit and disagree."""
        with self._lock:
            return self._state, self._turn

    def retrieve(self, include_world: bool = True) -> Snapshot:
        """Mutex-guarded snapshot {World, TurnsCompleted, AliveCount}
        (broker/broker.go:256-277).

        With ``include_world=False`` (the 2-second ticker's path) the count
        comes from the committed chunk's counts, or else a popcount on the
        device — a few bytes cross to the host instead of the board."""
        if include_world and not self.config.final_world:
            raise ValueError(
                "retrieve(include_world=True) on a final_world=False "
                "engine would decode the full byte raster this "
                "configuration promises never exists; use "
                "include_world=False (count-only) or state_snapshot()"
            )
        with self._lock:
            turn = self._turn
            if include_world:
                self._sync_host()
                world = self._world_host
            else:
                state, active_plane = self._state, self._plane
                counts = self._state_counts
                world = None
        if not include_world:
            if state is None:
                count = 0
            elif counts is not None:
                from ..ops.fused import fold_counts

                count = fold_counts(counts)
            else:
                count = active_plane.alive_count(state)
            return Snapshot(world, turn, count)
        if world is None:
            world = np.zeros((0, 0), np.uint8)
        return Snapshot(world, turn, int(np.count_nonzero(world)))
