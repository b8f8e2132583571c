"""The port's controller ticker (engine/controller.py::_Ticker) on the CPU,
against a stub broker: its thread waits on ``done`` instead of sleeping a
poll, so ``stop()`` wakes it at once, ticks land on their deadline, keys
still wait at most one poll, and a keyless session never polls.
"""

import queue
import time

import pytest

from gol_distributed_final_tpu_torch import AliveCellsCount, Params, State, StateChange, run
from gol_distributed_final_tpu_torch.engine.controller import CLOSED, _Ticker
from gol_distributed_final_tpu_torch.engine.engine import Snapshot
from gol_distributed_final_tpu_torch.obs import instruments as ins
from gol_distributed_final_tpu_torch.obs import metrics

from helpers import REPO_ROOT
from torch_obs_state import reset_obs

PARAMS = Params(turns=10, image_width=16, image_height=16)


class StubBroker:
    """The verbs the ticker calls; every retrieve is stamped with its
    monotonic time."""

    def __init__(self, turn=5, alive=7):
        self.turn, self.alive = turn, alive
        self.retrieved = []

    def retrieve(self, include_world=True):
        self.retrieved.append(time.monotonic())
        return Snapshot(None, self.turn, self.alive)

    def pause(self):
        pass

    def quit(self):
        pass

    def super_quit(self):
        pass


def _ticker(keypresses, tick_seconds, broker=None, events=None):
    return _Ticker(PARAMS, events if events is not None else queue.Queue(), keypresses,
                   broker or StubBroker(), "out", tick_seconds)


def _wait_in_loop(ticker):
    """Give the thread time to reach its wait."""
    time.sleep(0.1)
    assert ticker._thread.is_alive()


def _drain(events):
    out = []
    while True:
        try:
            ev = events.get_nowait()
        except queue.Empty:
            return out
        if ev is not CLOSED:
            out.append(ev)


@pytest.fixture
def port_metrics():
    reset_obs("gol_distributed_final_tpu_torch")
    metrics.enable()
    yield
    reset_obs("gol_distributed_final_tpu_torch")


def _wakeups():
    fam = ins.CONTROLLER_TICKER_WAKEUPS_TOTAL
    return {r: fam.labels(r).value for r in ("tick", "key", "poll", "stop")}


@pytest.mark.parametrize("keys", [None, "queue"], ids=["keyless", "key-queue"])
def test_stop_wakes_the_thread_at_once_whatever_the_poll(keys):
    """A poll of 30 s: a thread that finished its sleep before it saw
    ``done`` would hold ``stop()`` for up to 30 s."""
    ticker = _ticker(queue.Queue() if keys else None, tick_seconds=3600.0)
    ticker._POLL = 30.0
    ticker.start()
    _wait_in_loop(ticker)
    t0 = time.monotonic()
    ticker.stop()
    assert time.monotonic() - t0 < 1.0
    assert not ticker._thread.is_alive()


def test_stop_wakes_a_thread_whose_tick_never_comes():
    """An infinite tick period is a wait capped at the platform's longest,
    ended by ``stop()``."""
    ticker = _ticker(None, tick_seconds=float("inf"))
    ticker.start()
    _wait_in_loop(ticker)
    t0 = time.monotonic()
    ticker.stop()
    assert time.monotonic() - t0 < 1.0


def test_keyless_ticks_keep_their_cadence():
    """No key queue, a 50 ms tick: the thread sleeps from tick to tick and
    reports at least twice in 0.3 s, each report an AliveCellsCount of the
    broker's count."""
    events = queue.Queue()
    ticker = _ticker(None, tick_seconds=0.05, events=events)
    ticker.start()
    time.sleep(0.3)
    ticker.stop()
    alive = [e for e in _drain(events) if isinstance(e, AliveCellsCount)]
    assert len(alive) >= 2
    assert all((e.completed_turns, e.cells_count) == (5, 7) for e in alive)


def test_a_tick_lands_no_earlier_than_its_deadline():
    """The wait ends at the tick's deadline, not before it."""
    broker = StubBroker()
    ticker = _ticker(None, tick_seconds=0.2, broker=broker)
    t0 = time.monotonic()
    ticker.start()
    time.sleep(0.5)
    ticker.stop()
    assert broker.retrieved and broker.retrieved[0] - t0 >= 0.2


def test_a_key_is_handled_within_one_poll():
    """With a 0.5 s poll and an hour's tick, a 'p' put in the queue while
    the thread waits is handled within one poll (and a scheduler's slack),
    not at the next tick."""
    events, keys = queue.Queue(), queue.Queue()
    ticker = _ticker(keys, tick_seconds=3600.0, events=events)
    ticker._POLL = 0.5
    ticker.start()
    _wait_in_loop(ticker)
    try:
        t0 = time.monotonic()
        keys.put("p")
        ev = events.get(timeout=5)
        assert time.monotonic() - t0 < ticker._POLL + 0.25
        assert isinstance(ev, StateChange) and ev.new_state == State.PAUSED
    finally:
        ticker.stop()


def test_a_keyless_session_counts_one_stop_and_no_poll(tmp_path, port_metrics):
    """A whole in-process session without a key source, metrics on: the
    ticker's one wake-up is its stop."""
    run(Params(turns=4, image_width=16, image_height=16), images_dir=REPO_ROOT / "images",
        out_dir=tmp_path / "out", tick_seconds=3600, device="cpu")
    assert _wakeups() == {"tick": 0, "key": 0, "poll": 0, "stop": 1}


def test_a_key_queue_polls_and_counts_its_key(port_metrics):
    """With a key queue the thread polls, wakes for a key put in the
    middle of a poll, and counts one stop at its end."""
    events, keys = queue.Queue(), queue.Queue()
    ticker = _ticker(keys, tick_seconds=3600.0, events=events)
    ticker._POLL = 0.3
    ticker.start()
    deadline = time.monotonic() + 5
    while _wakeups()["poll"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    keys.put("p")
    assert isinstance(events.get(timeout=5), StateChange)
    ticker.stop()
    counts = _wakeups()
    assert counts["poll"] >= 1 and counts["key"] == 1 and counts["stop"] == 1
    assert counts["tick"] == 0


def test_metrics_off_counts_nothing():
    reset_obs("gol_distributed_final_tpu_torch")
    ticker = _ticker(queue.Queue(), tick_seconds=0.02)
    ticker.start()
    time.sleep(0.1)
    ticker.stop()
    assert _wakeups() == {"tick": 0, "key": 0, "poll": 0, "stop": 0}
