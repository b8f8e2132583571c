"""The controller — the reference distributor + ticker, on queues.

Mirrors gol/distributor.go behavior at the event level:

* load ``images/<W>x<H>.pgm``, make the blocking Run call, then emit
  ``FinalTurnComplete`` -> write ``out/<W>x<H>x<Turns>.pgm`` ->
  ``ImageOutputComplete`` -> ``StateChange{Quitting}`` -> close the stream
  (gol/distributor.go:131-185);
* a ticker thread that every 2 s retrieves a snapshot and emits
  ``AliveCellsCount`` (suppressed while paused) and that dispatches
  keypresses with the reference's exact semantics — including the
  ``TurnsCompleted - 1`` quirk on resume (gol/distributor.go:118)
  (gol/distributor.go:25-129).

The events channel is a ``queue.Queue``; stream end is signalled by the
``CLOSED`` sentinel (the Go ``close(events)`` equivalent). ``iter_events``
adapts a queue to a plain iterator for consumers and tests.
"""

from __future__ import annotations

import queue
import threading
import time

from ..events import (
    AliveCellsCount,
    FinalTurnComplete,
    ImageOutputComplete,
    Quitting,
    State,
    StateChange,
)
from ..io.pgm import read_board, write_board
from ..models import CONWAY
from ..obs import flight as _flight
from ..obs import instruments as _ins
from ..obs import metrics as _metrics
from ..obs import tracing as _tracing
from .engine import Engine, EngineConfig, RunResult

CLOSED = object()
"""Sentinel marking the end of an event stream (Go's close(events))."""


def _emit(events: "queue.Queue", ev) -> None:
    """events.put with per-event-type observability (obs/instruments.py):
    emit latency and a count by event class. A flag check when metrics are
    off; the CLOSED sentinel stays a raw put (stream plumbing, not an
    event)."""
    if not _metrics.enabled():
        events.put(ev)
        return
    t0 = time.monotonic()
    events.put(ev)
    _ins.CONTROLLER_EMIT_SECONDS.observe(time.monotonic() - t0)
    _ins.CONTROLLER_EVENTS_TOTAL.labels(type(ev).__name__).inc()


def iter_events(q: "queue.Queue", timeout: float | None = None):
    """Drain an event queue until the CLOSED sentinel.

    ``timeout`` bounds the wait for each *individual* event; if it expires,
    ``queue.Empty`` propagates. ``timeout=None`` blocks indefinitely.
    """
    while True:
        ev = q.get(timeout=timeout)
        if ev is CLOSED:
            return
        yield ev


class InProcessBroker:
    """The broker surface (stubs/stubs.go verbs) served by a same-process
    Engine — the session's default backend (rpc.client.RemoteBroker is the
    remote one)."""

    def __init__(self, engine: Engine):
        if not engine.config.final_world:
            raise ValueError(
                "the session controller needs a world-shipping engine "
                "(final_world=True)"
            )
        self.engine = engine

    def run(
        self, params, world, *, emit=None, emit_flips=False, initial_turn=0, rule=None,
    ) -> RunResult:
        if rule is not None and rule.rulestring != self.engine.config.rule.rulestring:
            # the session builds the engine from a resumed checkpoint's
            # rule, so a mismatch is a caller's engine configured otherwise
            raise ValueError(
                f"checkpoint rule {rule.rulestring} does not match the "
                f"engine's {self.engine.config.rule.rulestring}"
            )
        return self.engine.run(
            params, world, emit=emit, emit_flips=emit_flips, initial_turn=initial_turn,
        )

    def pause(self):
        return self.engine.pause()

    def quit(self):
        return self.engine.quit()

    def super_quit(self):
        return self.engine.super_quit()

    def retrieve(self, include_world: bool = True):
        return self.engine.retrieve(include_world=include_world)


class _Ticker:
    """The tickerFunc equivalent (gol/distributor.go:25-129): one thread
    multiplexing the 2 s tick, the keypress stream, and shutdown.

    Between its work the thread waits on ``done``: until the next tick,
    or at most ``_POLL`` where a key queue can deliver, so ``stop()`` wakes
    it at once and a keyless session never polls."""

    _POLL = 0.02

    def __init__(
        self, params, events, keypresses, broker, out_dir, tick_seconds,
        trace_parent=None,
    ):
        self.params = params
        self.events = events
        self.keypresses = keypresses
        self.broker = broker
        self.out_dir = out_dir
        self.tick_seconds = tick_seconds
        # the session span's context: tick and key spans run on THIS
        # thread, where the session's thread-local stack is invisible
        self._trace_parent = trace_parent
        self.done = threading.Event()
        self.paused = False
        self._last_turn = 0  # last turn seen by any successful retrieve
        self._tick_failures = 0  # consecutive, for broker-outage log pacing
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self.done.set()
        self._thread.join()

    def _snapshot_to_pgm(self):
        snap = self.broker.retrieve()
        write_board(snap.world, self.params.output_filename, self.out_dir)
        return snap

    def _try_snapshot_turn(self) -> int:
        """Snapshot-to-PGM for the q/k paths, degrading to a count-only
        turn read, then to the last tick's turn: quitting must never be
        blocked by a broken snapshot."""
        try:
            turn = self._snapshot_to_pgm().turns_completed
            self._last_turn = turn
            return turn
        except Exception as exc:
            print(f"final snapshot failed: {exc}")
        try:
            turn = self.broker.retrieve(include_world=False).turns_completed
            self._last_turn = turn
            return turn
        except Exception as exc:
            print(f"turn read failed: {exc}")
            return self._last_turn

    def _loop(self):
        next_tick = time.monotonic() + self.tick_seconds
        while not self.done.is_set():
            key = None
            if self.keypresses is not None:
                try:
                    key = self.keypresses.get_nowait()
                except queue.Empty:
                    key = None
            if key is not None:
                t_key = time.monotonic() if _metrics.enabled() else 0.0
                key_span = _tracing.start_span(
                    _tracing.SPAN_CONTROLLER_KEY, parent_ctx=self._trace_parent, key=key,
                )
                try:
                    self._handle_key(key)
                except Exception as exc:
                    # the control thread must survive a failed key action:
                    # dying here silently kills the 2 s tick AND q/k/p
                    print(f"key '{key}' failed: {exc}")
                finally:
                    _tracing.end_span(key_span)
                    if t_key:
                        _ins.CONTROLLER_KEY_SECONDS.labels(key).observe(
                            time.monotonic() - t_key
                        )
                continue
            if time.monotonic() >= next_tick:
                # re-anchor rather than increment: missed ticks coalesce
                # like Go's time.Ticker instead of bursting
                next_tick = time.monotonic() + self.tick_seconds
                t_tick = time.monotonic() if _metrics.enabled() else 0.0
                tick_span = _tracing.start_span(
                    _tracing.SPAN_CONTROLLER_TICK, parent_ctx=self._trace_parent,
                )
                try:
                    snap = self.broker.retrieve(include_world=False)
                except Exception as exc:
                    # a raising tick must not kill the control thread —
                    # keypresses (including 'q') still need servicing. A
                    # broker outage fails every tick: log the first and
                    # every 10th, and leave each in the flight ring
                    self._tick_failures += 1
                    _flight.record(
                        "controller.tick_error", type(exc).__name__,
                        consecutive=self._tick_failures, message=str(exc)[:200],
                    )
                    if self._tick_failures == 1 or self._tick_failures % 10 == 0:
                        print(f"tick retrieve failed (x{self._tick_failures}): {exc}")
                    continue
                finally:
                    _tracing.end_span(tick_span)
                self._tick_failures = 0
                if t_tick:
                    _ins.CONTROLLER_TICK_SECONDS.observe(time.monotonic() - t_tick)
                self._last_turn = snap.turns_completed
                if not self.paused and not self.done.is_set():
                    _emit(
                        self.events,
                        AliveCellsCount(snap.turns_completed, snap.alive_count),
                    )
                continue
            timeout = next_tick - time.monotonic()
            if self.keypresses is not None:
                timeout = min(self._POLL, timeout)
            if not self.done.wait(min(timeout, threading.TIMEOUT_MAX)) and _metrics.enabled():
                if self.keypresses is not None and not self.keypresses.empty():
                    reason = "key"
                elif time.monotonic() >= next_tick:
                    reason = "tick"
                else:
                    reason = "poll"
                _ins.CONTROLLER_TICKER_WAKEUPS_TOTAL.labels(reason).inc()
        if _metrics.enabled():
            _ins.CONTROLLER_TICKER_WAKEUPS_TOTAL.labels("stop").inc()

    def _handle_key(self, key):
        # gol/distributor.go:61-122
        if key == "q":
            turn = self._try_snapshot_turn()
            _emit(self.events, StateChange(turn, Quitting))
            self.done.set()
            self.broker.quit()
        elif key == "s":
            print(self.params.output_filename)
            self._snapshot_to_pgm()
        elif key == "k":
            turn = self._try_snapshot_turn()
            _emit(self.events, StateChange(turn, Quitting))
            self.done.set()
            self.broker.super_quit()
        elif key == "p":
            snap = self.broker.retrieve(include_world=False)
            self._last_turn = snap.turns_completed
            # pause() BEFORE the StateChange: if the broker call raises,
            # no Paused/Executing event has been emitted yet
            if not self.paused:
                self.broker.pause()
                _emit(self.events, StateChange(snap.turns_completed, State.PAUSED))
                self.paused = True
            else:
                self.broker.pause()
                # the reference reports one turn fewer on resume
                # (gol/distributor.go:118) — preserved for parity
                _emit(
                    self.events, StateChange(snap.turns_completed - 1, State.EXECUTING)
                )
                self.paused = False


def _export_trace(params, out_dir, broker) -> None:
    """Write the session's Chrome trace: this process's spans and whatever
    the broker's Status verb ships back (its own, and a workers-backend
    broker's workers'). A failed export must not fail the session."""
    try:
        spans = _tracing.tracer().snapshot()
        status_fn = getattr(broker, "status", None)
        if callable(status_fn):
            payload = status_fn()
            spans.extend(payload.get("trace_spans") or [])
        # -timeline: counter tracks on the same timeline as the spans
        from ..obs import timeline as _timeline

        sampler = _timeline.sampler()
        counters = sampler.chrome_counter_samples() if sampler else ()
        path = _tracing.write_chrome_trace(
            _tracing.trace_path(params, out_dir), spans, counters
        )
        print(f"chrome trace written to {path}")
    except Exception as exc:
        print(f"trace export failed: {exc}")


def run(
    params,
    events: "queue.Queue | None" = None,
    keypresses: "queue.Queue | None" = None,
    *,
    broker=None,
    rule=None,
    engine_config: EngineConfig | None = None,
    emit_flips: bool = False,
    images_dir="images",
    out_dir="out",
    tick_seconds: float = 2.0,
    device=None,
    resume_from=None,
    report: bool = False,
    trace_export: bool = False,
) -> RunResult:
    """Run a full Game of Life session (gol.Run + distributor, gol/gol.go:12).

    Blocking; returns the engine's RunResult. Events are pushed to ``events``
    (created if None), ending with the CLOSED sentinel. ``keypresses`` is an
    optional queue of single-character commands ('s', 'q', 'k', 'p').

    ``device`` places the engine's board: None is the CUDA card (and
    raises without one), ``"cpu"`` the CPU.

    ``broker`` selects the backend: None for an in-process engine, or any
    object with the stubs verb surface, e.g. ``rpc.client.RemoteBroker``
    (the reference's ``-server``). A remote broker computes on its own
    device and with the rule this session sends it, so ``device`` and
    ``engine_config`` belong to the in-process engine only.

    ``resume_from`` continues from a checkpoint (engine/checkpoint.py)
    instead of loading images/<W>x<H>.pgm at turn 0: a path, verified or
    refused here, or a ``(board, turn, rule)`` tuple that
    ``load_verified_checkpoint`` returned (the ``-resume`` CLI verifies
    early and passes it on, so the file is read and hashed once). The
    session runs under the checkpoint's rule, and a remote broker is sent
    its board, turn and rule.

    ``report`` writes a RunReport (obs/report.py: the metrics registry and
    the device inventory) to ``out_dir/report_<W>x<H>x<Turns>.json`` at
    ``FinalTurnComplete`` — the ``-report`` CLI flag. The registry must be
    enabled (``obs.metrics.enable()``; the flag does it) for the report to
    carry timings; a report failure is printed, never fatal.

    ``trace_export`` writes the session's Chrome trace to
    ``out_dir/trace_<W>x<H>x<Turns>.json`` at its end: this process's
    spans and those a remote broker's ``Status`` ships back (the ``-trace``
    CLI flag sets it and turns the tracer on). Recording needs only the
    tracer on (``obs.tracing.enable()``): without ``trace_export`` the
    session neither calls ``Status`` nor writes a file, and its spans stay
    in the ring for whoever reads it.
    """
    initial_turn = 0
    ckpt_rule = None
    if resume_from is not None:
        if isinstance(resume_from, tuple):
            ckpt_world, initial_turn, ckpt_rule = resume_from
        else:
            from .checkpoint import load_verified_checkpoint

            ckpt_world, initial_turn, ckpt_rule = load_verified_checkpoint(resume_from)
        if ckpt_world.shape != (params.image_height, params.image_width):
            raise ValueError(
                f"checkpoint board is {ckpt_world.shape[1]}x"
                f"{ckpt_world.shape[0]} but params say "
                f"{params.image_width}x{params.image_height}: the output "
                "filename and visualiser window would mislabel the board"
            )
        if params.turns <= initial_turn:
            raise ValueError(
                f"turns={params.turns} is not beyond the checkpoint's "
                f"turn {initial_turn}: nothing would run, yet the output "
                f"would be named ...x{params.turns}.pgm"
            )
    if rule is not None and ckpt_rule is not None and rule.rulestring != ckpt_rule.rulestring:
        raise ValueError(
            f"rule={rule.rulestring} conflicts with the checkpoint's "
            f"{ckpt_rule.rulestring}: a resumed board must continue "
            "under the rule it was evolved with"
        )
    if events is None:
        events = queue.Queue()
    if broker is not None and (device is not None or engine_config is not None):
        raise ValueError(
            "device and engine_config configure the in-process engine; a "
            "remote broker computes on its own device"
        )
    if engine_config is None:
        engine_config = EngineConfig(
            rule=rule if rule is not None else (ckpt_rule or CONWAY), device=device
        )
    elif rule is not None or device is not None:
        raise ValueError(
            "pass the rule and device inside engine_config "
            "(EngineConfig(rule=..., device=...)); the separate arguments "
            "would be silently ignored"
        )

    ticker = None
    t_session = time.monotonic()
    # the session root span (one flag check when -trace is off): every
    # tick, keypress, RPC and remote engine chunk of this session parents
    # under it — one trace_id across every process
    session_span = _tracing.start_span(
        _tracing.SPAN_CONTROLLER_SESSION,
        turns=params.turns,
        board=f"{params.image_width}x{params.image_height}",
    )
    try:
        if broker is None:
            broker = InProcessBroker(Engine(engine_config))
        world = ckpt_world if resume_from is not None else read_board(params, images_dir)
        ticker = _Ticker(
            params, events, keypresses, broker, out_dir, tick_seconds,
            trace_parent=session_span.ctx() if session_span else None,
        )
        ticker.start()
        # a resumed checkpoint's rule, or a non-Conway session rule, rides
        # along to the broker, which cannot otherwise know it (the
        # in-process one checks it against its engine); only when set, as
        # the reference does
        wire_rule = ckpt_rule if ckpt_rule is not None else rule
        if wire_rule is None and engine_config.rule.rulestring != CONWAY.rulestring:
            wire_rule = engine_config.rule
        extra = {} if wire_rule is None else {"rule": wire_rule}
        if initial_turn:
            extra["initial_turn"] = initial_turn
        result = broker.run(
            params,
            world,
            emit=events.put if emit_flips else None,
            emit_flips=emit_flips,
            **extra,
        )
        # join the ticker BEFORE the closing sequence so no stray
        # AliveCellsCount can interleave after StateChange{Quitting}
        stop_span = _tracing.start_span(_tracing.SPAN_CONTROLLER_TICKER_STOP)
        ticker.stop()
        _tracing.end_span(stop_span)
        cells_span = _tracing.start_span(_tracing.SPAN_CONTROLLER_FINAL_CELLS)
        alive = result.alive
        _tracing.end_span(cells_span)
        _emit(events, FinalTurnComplete(result.turns_completed, alive))
        if report:
            # the run's attribution artifact; a failed dump must not fail
            # the session it describes
            try:
                from ..obs.report import write_run_report

                path = write_run_report(
                    params,
                    out_dir,
                    wall_seconds=time.monotonic() - t_session,
                    extra={"turns_completed": result.turns_completed},
                )
                print(f"run report written to {path}")
            except Exception as exc:
                print(f"run report failed: {exc}")
        write_board(result.world, params.output_filename, out_dir)
        _emit(
            events, ImageOutputComplete(result.turns_completed, params.output_filename)
        )
        _emit(events, StateChange(result.turns_completed, Quitting))
        if trace_export and _tracing.enabled():
            # close the session span FIRST so it lands in the export
            _tracing.end_span(session_span)
            session_span = None
            _export_trace(params, out_dir, broker)
        return result
    finally:
        # None when already closed for the export above; ends the error
        # paths' span so the thread-local stack cannot wedge across runs
        _tracing.end_span(session_span)
        if ticker is not None:
            ticker.done.set()
        # the stream must always terminate, even on error — a consumer
        # blocked on iter_events would otherwise hang forever
        events.put(CLOSED)
