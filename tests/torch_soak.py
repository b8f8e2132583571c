"""The port's two session soaks, shared by the CPU tests
(tests/test_torch_soak.py), the card's (tests/test_torch_cuda.py) and
``chip_smoke.py`` (phases 25 and 26). Neither imports jax or the JAX
package, so they run on the card's host as they are.

* ``control_plane_soak``: the JAX package's
  ``tests/test_engine.py::test_control_plane_soak_random_keys`` on the
  port's ``run``. A seeded random ``p``/``s`` key stream ending in ``q``
  drives a long 64^2 session under a fast ticker; every
  ``AliveCellsCount`` must equal the per-turn history
  (``ops/bitpack.py::alive_history``) at its turn, and the final board
  the state at ``turns_completed``, whatever interleaving of pauses,
  snapshots and chunk commits produced them.
* ``session_soak``: the JAX package's
  ``tests_tpu/test_session_soak_tpu.py`` on the port's ``big_session``:
  the R-pentomino held under the ticker, a mid-run ``s`` snapshot, a
  ``p``/``p`` pause and periodic checkpoints, ended by ``q``, on the
  timeline of that test scaled to ``seconds``; then the run resumed from
  its last periodic checkpoint to ``turns_completed`` must write the same
  PGM byte for byte.

Each raises AssertionError on a failed check and returns what it saw.
"""

import pathlib
import queue
import random
import threading
import time

import numpy as np

from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.bigboard import big_session, r_pentomino, stream_packed_to_pgm
from gol_distributed_final_tpu_torch.engine.checkpoint import load_packed_checkpoint
from gol_distributed_final_tpu_torch.engine.controller import CLOSED
from gol_distributed_final_tpu_torch.engine.engine import Engine, EngineConfig
from gol_distributed_final_tpu_torch.events import (
    AliveCellsCount, FinalTurnComplete, Quitting, State, StateChange,
)
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.models import CONWAY
from gol_distributed_final_tpu_torch.ops import bitpack
from gol_distributed_final_tpu_torch.ops.auto import auto_plane
from gol_distributed_final_tpu_torch.ops.plane import BitPlane

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _drain(events) -> list:
    seen = []
    while True:
        ev = events.get(timeout=30)
        if ev is CLOSED:
            return seen
        seen.append(ev)


#: the soak's turn budget on the card. The JAX test's 200,000 outlast its
#: key stream (~1 s) on a TPU and on the CPU (~10,000 turns there); the
#: H100 runs 200,000 turns of 64^2 before the first 30 ms tick, so on the
#: card the budget is one that only 'q' ends
CARD_TURNS = 10**8


def control_plane_soak(out_dir, device, turns: int = 200_000, seed: int = 7) -> dict:
    """The control-plane soak on ``device``: returns the run's
    ``turns_completed`` (``done``), the port's history for turns
    1..done (``history``), the ticks and the packed start board. The
    history covers the turns the session ran, which is all its checks
    read."""
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    events, keys = queue.Queue(), queue.Queue()
    rng = random.Random(seed)

    def feeder():
        pauses = 0
        for _ in range(12):
            key = rng.choice(["p", "s", "p"])
            pauses += key == "p"
            keys.put(key)
            time.sleep(0.08)
        if pauses % 2:  # 'q' lands on a RUNNING session
            keys.put("p")
        keys.put("q")

    t = threading.Thread(target=feeder)
    t.start()
    result = run(
        Params(turns=turns, image_width=64, image_height=64), events, keys,
        images_dir=REPO_ROOT / "images", out_dir=out_dir, tick_seconds=0.03, device=device,
    )
    t.join()
    collected = _drain(events)

    done = result.turns_completed
    assert 0 < done <= turns
    packed = bitpack.pack(board, 0, device)
    # the oracle: the port's per-turn history, one dispatch, for the turns run
    history = bitpack.alive_history(packed, done)
    initial_alive = int(np.count_nonzero(board))
    ticks = [e for e in collected if isinstance(e, AliveCellsCount)]
    assert ticks, "soak produced no tick events"
    for e in ticks:
        want = initial_alive if e.completed_turns == 0 else int(history[e.completed_turns - 1])
        assert e.cells_count == want, f"turn {e.completed_turns}: {e.cells_count} != {want}"
    finals = [e for e in collected if isinstance(e, FinalTurnComplete)]
    assert len(finals) == 1
    assert len(finals[0].alive) == int(history[done - 1])
    # the final world is exactly the state at that turn
    plane = BitPlane(CONWAY, 0, device)
    np.testing.assert_array_equal(result.world, plane.decode(plane.step_n(packed, done)))
    return {"done": done, "history": history, "ticks": ticks, "packed": packed}


#: the JAX test's timeline in seconds at its full minute: the snapshot
#: key, the snapshot's wait bound, the gap to the pause, the pause, the
#: run to 'q'
TIMELINE = (15.0, 30.0, 10.0, 5.0, 25.0)


def session_soak(out_dir, device, *, size: int = 4096, seconds: float = 60.0,
                 checkpoint_every: int = 50_000, tick_seconds: float = 2.0) -> dict:
    """The session soak on ``device`` with the JAX test's timeline scaled
    to ``seconds`` (60 is that test's minute). The engine keeps its own
    chunk schedule: the JAX test pinned 4096-turn chunks to avoid Mosaic
    recompiles, and the port compiles nothing at run time. Returns the
    observations: turns, ticks, the wall, the plane ``auto_plane`` gives
    the board, the checkpoint's turn."""
    out_dir = pathlib.Path(out_dir)
    scale = seconds / 60.0
    to_snapshot, snapshot_wait, to_pause, pause, to_quit = (s * scale for s in TIMELINE)
    events, keys = queue.Queue(), queue.Queue()
    out_pgm = out_dir / "out" / f"{size}x{size}x1000000000.pgm"
    observed = {}

    def feeder():
        time.sleep(to_snapshot)
        keys.put("s")  # snapshot mid-run
        # the file appearing BEFORE 'q' can only be the mid-run snapshot:
        # the closing sequence writes the same path later
        deadline = time.monotonic() + snapshot_wait
        while time.monotonic() < deadline and not out_pgm.exists():
            time.sleep(0.05)
        observed["snapshot_mid_run"] = out_pgm.exists()
        time.sleep(to_pause)
        keys.put("p")
        time.sleep(pause)
        keys.put("p")
        time.sleep(to_quit)
        keys.put("q")

    feeder_thread = threading.Thread(target=feeder, daemon=True)
    feeder_thread.start()
    ck = out_dir / "soak_ck.npz"
    engine = Engine(EngineConfig(final_world=False, checkpoint_every=checkpoint_every,
                                 checkpoint_path=str(ck), device=device))
    t0 = time.monotonic()
    res = big_session(size, 10**9, cells=r_pentomino(size), engine=engine, events=events,
                      keypresses=keys, tick_seconds=tick_seconds, out_dir=out_dir / "out")
    wall = time.monotonic() - t0
    feeder_thread.join()
    assert 0 < res.turns_completed < 10**9
    assert res.checkpoint_error is None, res.checkpoint_error
    seq = _drain(events)

    ticks = [e for e in seq if isinstance(e, AliveCellsCount)]
    turns = [e.completed_turns for e in ticks]
    # liveness, monotonicity and positivity; cadence is not asserted
    assert len(ticks) >= 5, (len(ticks), wall)
    assert turns == sorted(turns), "tick turns not monotone"
    assert all(e.cells_count > 0 for e in ticks)
    pauses = [e for e in seq if isinstance(e, StateChange) and e.new_state == State.PAUSED]
    assert len(pauses) == 1
    finals = [e for e in seq if isinstance(e, FinalTurnComplete)]
    assert len(finals) == 1
    assert isinstance(seq[-1], StateChange) and seq[-1].new_state is Quitting
    assert ck.exists(), "the periodic checkpoint never fired"
    assert observed.get("snapshot_mid_run"), observed
    assert out_pgm.exists()

    # resume from the last periodic checkpoint to turns_completed: the
    # same PGM byte for byte
    words, ck_turn, rule, word_axis = load_packed_checkpoint(ck)
    assert 0 < ck_turn <= res.turns_completed and rule.rulestring == CONWAY.rulestring
    plane = BitPlane(rule, word_axis, device)
    state = plane.step_n(bitpack.state_from_numpy(words, plane.device),
                         res.turns_completed - ck_turn)
    resumed = out_dir / "resumed.pgm"
    stream_packed_to_pgm(resumed, state, word_axis)
    assert resumed.read_bytes() == out_pgm.read_bytes(), "the resumed run's PGM differs"
    return {
        "turns": res.turns_completed, "ticks": len(ticks), "wall": wall,
        "alive": len(finals[0].alive), "checkpoint_turn": ck_turn,
        "auto_plane": type(auto_plane(CONWAY, (size, size), plane.device)).__name__,
    }
