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
from .engine import Engine, EngineConfig, RunResult

CLOSED = object()
"""Sentinel marking the end of an event stream (Go's close(events))."""


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
    multiplexing the 2 s tick, the keypress stream, and shutdown."""

    _POLL = 0.02

    def __init__(self, params, events, keypresses, broker, out_dir, tick_seconds):
        self.params = params
        self.events = events
        self.keypresses = keypresses
        self.broker = broker
        self.out_dir = out_dir
        self.tick_seconds = tick_seconds
        self.done = threading.Event()
        self.paused = False
        self._last_turn = 0  # last turn seen by any successful retrieve
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
                try:
                    self._handle_key(key)
                except Exception as exc:
                    # the control thread must survive a failed key action:
                    # dying here silently kills the 2 s tick AND q/k/p
                    print(f"key '{key}' failed: {exc}")
                continue
            if time.monotonic() >= next_tick:
                # re-anchor rather than increment: missed ticks coalesce
                # like Go's time.Ticker instead of bursting
                next_tick = time.monotonic() + self.tick_seconds
                try:
                    snap = self.broker.retrieve(include_world=False)
                except Exception as exc:
                    # a raising tick must not kill the control thread —
                    # keypresses (including 'q') still need servicing
                    print(f"tick retrieve failed: {exc}")
                    continue
                self._last_turn = snap.turns_completed
                if not self.paused and not self.done.is_set():
                    self.events.put(
                        AliveCellsCount(snap.turns_completed, snap.alive_count)
                    )
                continue
            time.sleep(self._POLL)

    def _handle_key(self, key):
        # gol/distributor.go:61-122
        if key == "q":
            turn = self._try_snapshot_turn()
            self.events.put(StateChange(turn, Quitting))
            self.done.set()
            self.broker.quit()
        elif key == "s":
            print(self.params.output_filename)
            self._snapshot_to_pgm()
        elif key == "k":
            turn = self._try_snapshot_turn()
            self.events.put(StateChange(turn, Quitting))
            self.done.set()
            self.broker.super_quit()
        elif key == "p":
            snap = self.broker.retrieve(include_world=False)
            self._last_turn = snap.turns_completed
            # pause() BEFORE the StateChange: if the broker call raises,
            # no Paused/Executing event has been emitted yet
            if not self.paused:
                self.broker.pause()
                self.events.put(StateChange(snap.turns_completed, State.PAUSED))
                self.paused = True
            else:
                self.broker.pause()
                # the reference reports one turn fewer on resume
                # (gol/distributor.go:118) — preserved for parity
                self.events.put(
                    StateChange(snap.turns_completed - 1, State.EXECUTING)
                )
                self.paused = False


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
    try:
        if broker is None:
            broker = InProcessBroker(Engine(engine_config))
        world = ckpt_world if resume_from is not None else read_board(params, images_dir)
        ticker = _Ticker(params, events, keypresses, broker, out_dir, tick_seconds)
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
        ticker.stop()
        events.put(FinalTurnComplete(result.turns_completed, result.alive))
        write_board(result.world, params.output_filename, out_dir)
        events.put(
            ImageOutputComplete(result.turns_completed, params.output_filename)
        )
        events.put(StateChange(result.turns_completed, Quitting))
        return result
    finally:
        if ticker is not None:
            ticker.done.set()
        # the stream must always terminate, even on error — a consumer
        # blocked on iter_events would otherwise hang forever
        events.put(CLOSED)
