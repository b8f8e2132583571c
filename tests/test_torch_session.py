"""The PyTorch port's controller session (gol_distributed_final_tpu_torch.run)
on the CPU, against the reference's golden fixtures (gol_test.go:15-47,
pgm_test.go:10-42, count_test.go:17-69) and against the JAX package's own
session. Equality throughout: boards, alive counts, PGM bytes, events.
"""

import queue
import threading

import numpy as np
import pytest

from gol_distributed_final_tpu_torch import (
    AliveCellsCount,
    FinalTurnComplete,
    ImageOutputComplete,
    Params,
    State,
    StateChange,
    run,
)
from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
from gol_distributed_final_tpu_torch.engine.controller import CLOSED
from gol_distributed_final_tpu_torch.io.pgm import read_pgm

from helpers import REPO_ROOT, assert_equal_board, read_alive_cells, read_alive_counts

MATRIX = [(size, turns) for size in (16, 64, 512) for turns in (0, 1, 100)]


def _drain(events):
    out = []
    while True:
        ev = events.get_nowait()
        if ev is CLOSED:
            return out
        out.append(ev)


def _session(size, turns, tmp_path, **kwargs):
    params = Params(turns=turns, image_width=size, image_height=size)
    events = queue.Queue()
    result = run(
        params, events, images_dir=REPO_ROOT / "images",
        out_dir=tmp_path / "out", tick_seconds=3600, device="cpu", **kwargs,
    )
    return params, result, _drain(events)


@pytest.mark.parametrize("size,turns", MATRIX)
def test_golden_final_cells_and_pgm_bytes(size, turns, tmp_path):
    params, result, events = _session(size, turns, tmp_path)
    finals = [e for e in events if isinstance(e, FinalTurnComplete)]
    assert len(finals) == 1 and finals[0].completed_turns == turns
    golden = REPO_ROOT / "check" / "images" / f"{size}x{size}x{turns}.pgm"
    assert_equal_board(finals[0].alive, read_alive_cells(golden), size, size)
    written = tmp_path / "out" / f"{params.output_filename}.pgm"
    assert written.read_bytes() == golden.read_bytes()


def test_event_sequence_tail(tmp_path):
    """gol/distributor.go:161-184: FinalTurnComplete -> ImageOutputComplete
    -> StateChange{Quitting}, then the stream closes."""
    _, _, events = _session(64, 1, tmp_path)
    tail = events[-3:]
    assert isinstance(tail[0], FinalTurnComplete)
    assert isinstance(tail[1], ImageOutputComplete) and tail[1].filename == "64x64x1"
    assert str(tail[1]) == "File 64x64x1 output complete"
    assert isinstance(tail[2], StateChange) and tail[2].new_state == State.QUITTING
    assert str(tail[2]) == "Quitting"


def test_alive_ticks_match_golden_csv_and_q_quits(tmp_path):
    """count_test.go:17-69: every AliveCellsCount is exact for its turn;
    'q' after five ticks ends the run with the closing sequence."""
    counts = read_alive_counts(REPO_ROOT / "check" / "alive" / "64x64.csv")
    params = Params(turns=100_000_000, image_width=64, image_height=64)
    events, keypresses, collected, errors = queue.Queue(), queue.Queue(), [], []

    def consumer():
        ticks = 0
        try:
            while True:
                ev = events.get(timeout=30)
                if ev is CLOSED:
                    return
                collected.append(ev)
                if isinstance(ev, AliveCellsCount):
                    ticks += 1
                    if ticks == 5:
                        keypresses.put("q")
        except BaseException as e:
            errors.append(e)
            keypresses.put("q")

    t = threading.Thread(target=consumer)
    t.start()
    run(params, events, keypresses, images_dir=REPO_ROOT / "images",
        out_dir=tmp_path / "out", tick_seconds=0.2, device="cpu")
    t.join(timeout=30)
    assert not t.is_alive() and not errors, errors
    ticks = [e for e in collected if isinstance(e, AliveCellsCount)]
    assert len(ticks) >= 5
    for ev in ticks:
        want = 2819 if ev.completed_turns == 0 else counts.get(ev.completed_turns, 101)
        assert ev.cells_count == want, ev
    finals = [e for e in collected if isinstance(e, FinalTurnComplete)]
    assert len(finals) == 1 and 0 < finals[0].completed_turns < params.turns
    quits = [e for e in collected
             if isinstance(e, StateChange) and e.new_state == State.QUITTING]
    assert len(quits) == 2


def test_every_turn_alive_count_64_matches_csv():
    """Turns 1..10000 of 64^2, one turn per chunk through Engine.run, each
    count read the way the ticker reads it (the fused plane's counts)."""
    counts = read_alive_counts(REPO_ROOT / "check" / "alive" / "64x64.csv")
    seen = {}

    def hook(engine, state, turn):
        seen[turn] = engine.retrieve(include_world=False).alive_count

    engine = Engine(EngineConfig(max_chunk=1, chunk_hook=hook, device="cpu"))
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    engine.run(Params(turns=10_000, image_width=64, image_height=64), board)
    assert [seen[t] for t in range(1, 10_001)] == [counts[t] for t in range(1, 10_001)]


def test_pause_snapshot_resume_quit(tmp_path):
    """'p' parks the engine (StateChange Paused), 's' writes the board at
    the parked turn, 'p' resumes reporting one turn fewer
    (gol/distributor.go:118), 'q' quits — the 's' PGM equals the JAX
    package's evolution to the parked turn."""
    from gol_distributed_final_tpu.ops import bitpack as jbit

    params = Params(turns=100_000_000, image_width=64, image_height=64)
    events, keypresses = queue.Queue(), queue.Queue()
    out = tmp_path / "out"
    result, errors = {}, []

    def session():
        try:
            result["r"] = run(params, events, keypresses, images_dir=REPO_ROOT / "images",
                              out_dir=out, tick_seconds=0.1, device="cpu")
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=session)
    t.start()

    def wait_for(pred):
        while True:
            ev = events.get(timeout=30)
            assert ev is not CLOSED, "stream closed early"
            if pred(ev):
                return ev

    wait_for(lambda e: isinstance(e, AliveCellsCount))
    keypresses.put("p")
    paused = wait_for(lambda e: isinstance(e, StateChange))
    assert paused.new_state == State.PAUSED
    keypresses.put("s")
    keypresses.put("p")
    resumed = wait_for(lambda e: isinstance(e, StateChange))
    assert resumed.new_state == State.EXECUTING
    snapshot = read_pgm(out / f"{params.output_filename}.pgm")
    keypresses.put("q")
    quit_ev = wait_for(lambda e: isinstance(e, StateChange))
    assert quit_ev.new_state == State.QUITTING
    t.join(timeout=30)
    assert not t.is_alive() and not errors, errors

    parked_turn = resumed.completed_turns + 1
    assert parked_turn >= paused.completed_turns
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    want = jbit.unpack(np.asarray(jbit.bit_step_n(jbit.pack(board, 0), parked_turn, 0)), 0)
    np.testing.assert_array_equal(snapshot, want)
    assert result["r"].turns_completed >= parked_turn


@pytest.mark.parametrize("h,w", [(64, 96), (16, 16), (48, 64)])
def test_same_image_same_world_as_the_jax_session(h, w, tmp_path):
    """One image through the JAX package's run and the port's run: the
    final worlds are equal (bitboard planes for 64x96 and 48x64 — rows
    and columns packed — and the byte stencil for 16x16)."""
    from gol_distributed_final_tpu import run as jax_run

    rng = np.random.default_rng(h * w)
    board = np.where(rng.random((h, w)) < 0.3, 255, 0).astype(np.uint8)
    images = tmp_path / "images"
    images.mkdir()
    (images / f"{w}x{h}.pgm").write_bytes(b"P5\n%d %d\n255\n" % (w, h) + board.tobytes())
    params = Params(turns=37, image_width=w, image_height=h)
    mine = run(params, queue.Queue(), images_dir=images, out_dir=tmp_path / "t",
               tick_seconds=3600, device="cpu")
    theirs = jax_run(params, queue.Queue(), images_dir=images,
                     out_dir=tmp_path / "j", tick_seconds=3600)
    np.testing.assert_array_equal(mine.world, theirs.world)
    assert (tmp_path / "t" / f"{w}x{h}x37.pgm").read_bytes() == \
        (tmp_path / "j" / f"{w}x{h}x37.pgm").read_bytes()


def test_k_shuts_the_session_down(tmp_path):
    params = Params(turns=100_000_000, image_width=16, image_height=16)
    events, keypresses = queue.Queue(), queue.Queue()
    keypresses.put("k")
    result = run(params, events, keypresses, images_dir=REPO_ROOT / "images",
                 out_dir=tmp_path / "out", tick_seconds=3600, device="cpu")
    quits = [e for e in _drain(events)
             if isinstance(e, StateChange) and e.new_state == State.QUITTING]
    assert len(quits) == 2 and result.turns_completed < params.turns


def test_cell_flips_match_the_jax_session(tmp_path):
    """With emit_flips every turn's CellFlipped events, then TurnComplete,
    equal the JAX package's, initial flips included (gol/event.go:50-60)."""
    from gol_distributed_final_tpu import run as jax_run
    from gol_distributed_final_tpu.engine.controller import CLOSED as JAX_CLOSED

    def stream(run_fn, closed, out, **kwargs):
        events = queue.Queue()
        run_fn(Params(turns=4, image_width=16, image_height=16), events,
               images_dir=REPO_ROOT / "images", out_dir=tmp_path / out,
               tick_seconds=3600, emit_flips=True, **kwargs)
        got = []
        while True:
            ev = events.get_nowait()
            if ev is closed:
                return got
            got.append((type(ev).__name__, ev.completed_turns, str(ev),
                        tuple(getattr(ev, "cell", ()))))

    mine = stream(run, CLOSED, "t", device="cpu")
    theirs = stream(jax_run, JAX_CLOSED, "j")
    assert mine == theirs
    assert sum(1 for e in mine if e[0] == "TurnComplete") == 4


# -- the engine's surface, field by field against the JAX engine -------------


def _ref_engine(**config):
    from gol_distributed_final_tpu.engine.engine import Engine as JEngine
    from gol_distributed_final_tpu.engine.engine import EngineConfig as JEngineConfig

    return JEngine(JEngineConfig(**config))


def _chunk_turns(engine, board, turns, **run_kwargs):
    seen = []
    engine.config.chunk_hook = lambda eng, state, turn: seen.append(turn)
    result = engine.run(Params(turns=turns, image_width=board.shape[1],
                               image_height=board.shape[0]), board, **run_kwargs)
    return seen, result


@pytest.mark.parametrize("min_chunk,max_chunk,target", [
    (1, 4096, 3600.0), (10, 10, 3600.0), (3, 64, 3600.0), (50, 8, 3600.0), (4, 4096, 0.0),
])
def test_chunk_sizes_equal_the_jax_engine(min_chunk, max_chunk, target):
    """min_chunk, max_chunk and target_dispatch_seconds give the same chunk
    boundaries in both engines (a target no chunk reaches doubles to
    max_chunk; a target of 0 stops growth after the first chunk)."""
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    config = dict(min_chunk=min_chunk, max_chunk=max_chunk, target_dispatch_seconds=target)
    mine, res = _chunk_turns(Engine(EngineConfig(device="cpu", **config)), board, 300)
    theirs, jres = _chunk_turns(_ref_engine(**config), board, 300)
    assert mine == theirs
    np.testing.assert_array_equal(res.world, jres.world)


def test_initial_turn_and_auto_fast_equal_the_jax_engine():
    rng = np.random.default_rng(41)
    board = np.where(rng.random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
    for auto_fast in (True, False):
        # a target no chunk reaches: growth by doubling alone, whatever
        # the first chunk's compile or the host's load costs
        config = dict(auto_fast=auto_fast, max_chunk=8, target_dispatch_seconds=3600.0)
        mine, res = _chunk_turns(Engine(EngineConfig(device="cpu", **config)), board, 30,
                                 initial_turn=10)
        theirs, jres = _chunk_turns(_ref_engine(**config), board, 30, initial_turn=10)
        assert mine == theirs and mine[0] == 11 and mine[-1] == 30
        assert res.turns_completed == jres.turns_completed == 30
        np.testing.assert_array_equal(res.world, jres.world)
    from gol_distributed_final_tpu_torch.ops.plane import BytePlane

    engine = Engine(EngineConfig(auto_fast=False, device="cpu"))
    engine.run(Params(turns=1, image_width=64, image_height=64), board)
    assert type(engine._plane) is BytePlane


def test_snapshot_run_result_and_state_accessors_equal_the_jax_engine():
    from gol_distributed_final_tpu.engine.engine import RunResult as JRunResult
    from gol_distributed_final_tpu.engine.engine import Snapshot as JSnapshot
    from gol_distributed_final_tpu_torch.engine import RunResult, Snapshot
    from gol_distributed_final_tpu_torch.utils.cell import Cell

    board = read_pgm(REPO_ROOT / "images" / "16x16.pgm")
    assert Snapshot(board, 3, 9).alive == JSnapshot(board, 3, 9).alive != []
    assert Snapshot(None, 3, 9).alive == JSnapshot(None, 3, 9).alive == []
    cells = [Cell(1, 2)]
    # the JAX package's positional order: alive third
    mine, theirs = RunResult(5, board, cells), JRunResult(5, board, cells)
    assert mine.alive == theirs.alive == cells and mine.alive_count == 1
    assert RunResult(5, board).checkpoint_error is None
    err = OSError("disk full")
    assert RunResult(5, board, None, None, None, err).checkpoint_error is err

    engine = Engine(EngineConfig(final_world=False, device="cpu"))
    assert engine.final_state() is None and engine.state_snapshot() == (None, 0)
    from gol_distributed_final_tpu_torch.ops import bitpack
    from gol_distributed_final_tpu_torch.ops.plane import BitPlane

    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    packed = bitpack.pack(board, 1, "cpu")
    res = engine.run(Params(turns=7, image_width=64, image_height=64), None,
                     plane=BitPlane(word_axis=1, device="cpu"), initial_state=packed)
    state, turn = engine.state_snapshot()
    assert turn == 7 and state is engine.final_state() is res._state
    assert _equals_the_oracle(state, board, 7)
    assert not engine.super_quit_requested
    engine.super_quit()
    assert engine.super_quit_requested
    with pytest.raises(ValueError, match="state_snapshot"):
        engine.retrieve(include_world=True)


def _equals_the_oracle(state, board, turns):
    from gol_distributed_final_tpu_torch.ops import bitpack
    from oracle import vector_step

    for _ in range(turns):
        board = vector_step(board)
    return np.array_equal(bitpack.unpack(state, 1).numpy(), board)


def test_super_quit_ends_a_run_and_is_remembered():
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")

    def hook(engine, state, turn):
        if turn >= 20:
            engine.super_quit()

    engine = Engine(EngineConfig(max_chunk=4, chunk_hook=hook, device="cpu"))
    res = engine.run(Params(turns=10_000, image_width=64, image_height=64), board)
    assert 20 <= res.turns_completed < 10_000 and engine.super_quit_requested
    # quit is consumed by the run; the engine serves the next one
    again = engine.run(Params(turns=3, image_width=64, image_height=64), board)
    assert again.turns_completed == 3


@pytest.mark.parametrize("knob,fused", [(None, True), ("auto", True), ("on", True),
                                        ("off", False), ("OFF", False)])
def test_gol_fused_routes_as_the_jax_package(knob, fused, monkeypatch):
    from gol_distributed_final_tpu.ops import auto as jauto
    from gol_distributed_final_tpu.ops.fused import FusedBitPlane as JFused
    from gol_distributed_final_tpu_torch.models import CONWAY
    from gol_distributed_final_tpu_torch.ops.auto import auto_plane
    from gol_distributed_final_tpu_torch.ops.fused import FusedBitPlane, fused_enabled
    from gol_distributed_final_tpu_torch.ops.plane import BitPlane

    if knob is None:
        monkeypatch.delenv("GOL_FUSED", raising=False)
    else:
        monkeypatch.setenv("GOL_FUSED", knob)
    monkeypatch.setattr(jauto, "_PLANE_CACHE", {})
    from gol_distributed_final_tpu.models import CONWAY as J_CONWAY

    assert fused_enabled() is fused
    for shape in ((64, 64), (512, 512)):
        mine = auto_plane(CONWAY, shape, "cpu")
        theirs = jauto.auto_plane(J_CONWAY, shape)
        assert isinstance(mine, FusedBitPlane) is isinstance(theirs, JFused) is fused
        assert type(mine) is (FusedBitPlane if fused else BitPlane)
    # past the gate both packages keep the plain bitboard plane
    assert type(auto_plane(CONWAY, (2048, 2048), "cpu")) is BitPlane
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    res = Engine(EngineConfig(device="cpu")).run(
        Params(turns=100, image_width=64, image_height=64), board)
    golden = read_pgm(REPO_ROOT / "check" / "images" / "64x64x100.pgm")
    np.testing.assert_array_equal(res.world, golden)


def test_ladders_take_the_jax_packages_keywords():
    """The JAX package's interpret/block_rows/block_cols are accepted and
    change nothing: the port's tile is fixed."""
    import torch

    from gol_distributed_final_tpu_torch.ops import bitpack, tiled
    from gol_distributed_final_tpu_torch.ops.fused import fused_bit_step_n

    rng = np.random.default_rng(5)
    board = np.where(rng.random((64, 256)) < 0.3, 255, 0).astype(np.uint8)
    packed = bitpack.pack(board, 0, "cpu")
    want = bitpack.bit_step_n(packed, 13, 0)
    for kwargs in ({}, {"interpret": True, "block_rows": 8, "block_cols": 128},
                   {"interpret": False, "force_tiles": True, "block_rows": None}):
        assert torch.equal(fused_bit_step_n(packed, 13, **kwargs), want)
    step = tiled.tiled_bit_step_n_fn(interpret=True, block_rows=8, block_cols=128)
    assert torch.equal(step(packed, 13), want)
