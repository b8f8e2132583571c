"""The PyTorch port's big-board surface (gol_distributed_final_tpu_torch
.bigboard) on the CPU: the JAX package's tests/test_bigboard.py scenarios
at 256^2 to 1024^2 instead of 4096^2, each held against the JAX package's
bigboard on the same input. 512^2 steps on the whole-board kernel's plain
version, 1024^2 on the tiled kernel's, the route a 65536^2 board takes on
the card. Streamed PGMs are compared byte for byte; tolerance 0.
"""

import os
import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu import bigboard as jbig
from gol_distributed_final_tpu_torch import bigboard as pbig
from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
from gol_distributed_final_tpu.io import sharded as jsharded
from gol_distributed_final_tpu_torch.io import sharded
from gol_distributed_final_tpu_torch.io.sharded import read_shard
from gol_distributed_final_tpu_torch.ops import bitpack, tiled, whole_board
from gol_distributed_final_tpu_torch.ops.bitpack import alive_count_packed
from gol_distributed_final_tpu_torch.ops.plane import BitPlane
from gol_distributed_final_tpu_torch.params import Params

from helpers import REPO_ROOT, oracle_window
from oracle import vector_step

TURNS = 100
WIN = 256  # holds the R-pentomino's 100-turn envelope


def _window(size, turns=TURNS):
    return oracle_window(size, turns, WIN)


def _w0(size):
    return size // 2 - WIN // 2


@pytest.mark.parametrize("size", [512, 1024])
def test_streamed_run_equals_the_reference(size, tmp_path):
    launches = (whole_board.plain_calls, tiled.plain_calls)
    out = tmp_path / "big.pgm"
    alive = pbig.run_big_board(size, TURNS, out, cells=pbig.r_pentomino(size),
                               row_block=128, device="cpu")
    routed = (whole_board.plain_calls - launches[0], tiled.plain_calls - launches[1])
    assert routed == ((1, 0) if size == 512 else (0, 1))
    ref = tmp_path / "ref.pgm"
    ref_alive = jbig.run_big_board(size, TURNS, ref, cells=jbig.r_pentomino(size), row_block=128)
    assert alive == ref_alive == int(np.count_nonzero(_window(size)))
    assert out.read_bytes() == ref.read_bytes()
    w0 = _w0(size)
    np.testing.assert_array_equal(read_shard(out, w0, w0 + WIN)[:, w0:w0 + WIN], _window(size))
    assert not read_shard(out, 0, 64).any()


@pytest.mark.parametrize("word_axis", [0, 1])
def test_streamed_pgm_roundtrip(word_axis, tmp_path):
    path = tmp_path / "seed.pgm"
    state = pbig.seed_packed(512, pbig.r_pentomino(512), word_axis, device="cpu")
    pbig.stream_packed_to_pgm(path, state, word_axis, row_block=96)
    loaded = pbig.load_packed_from_pgm(path, word_axis, row_block=96, device="cpu")
    assert torch.equal(loaded, state) and alive_count_packed(loaded) == 5
    ref = tmp_path / "ref.pgm"
    jbig.stream_packed_to_pgm(ref, jbig.seed_packed(512, jbig.r_pentomino(512), word_axis),
                              word_axis, row_block=96)
    assert path.read_bytes() == ref.read_bytes()
    np.testing.assert_array_equal(
        np.asarray(jbig.load_packed_from_pgm(path, word_axis, row_block=96)), state.numpy())


def test_resume_from_streamed_pgm(tmp_path):
    size = 1024
    mid = tmp_path / "mid.pgm"
    pbig.run_big_board(size, 60, mid, cells=pbig.r_pentomino(size), row_block=256,
                       device="cpu")
    final = tmp_path / "final.pgm"
    alive = pbig.run_big_board(size, 40, final, in_path=mid, row_block=256, device="cpu")
    assert alive == int(np.count_nonzero(_window(size)))
    w0 = _w0(size)
    np.testing.assert_array_equal(read_shard(final, w0, w0 + WIN)[:, w0:w0 + WIN],
                                  _window(size))
    with pytest.raises(ValueError, match="exactly one"):
        pbig.run_big_board(size, 1, None, device="cpu")


@pytest.mark.parametrize("width,height", [(48, 64), (32, 32), (1000, 3)])
def test_sharded_pgm_equals_the_reference(width, height, tmp_path):
    """Shards written out of order, by the one-call form and by writers
    that find the raster through pgm_raster_offset, give the reference's
    bytes; read_shard returns each row range."""
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    rng = np.random.default_rng(width * height)
    board = np.where(rng.random((height, width)) < 0.5, 255, 0).astype(np.uint8)
    cut = height // 2
    shards = [(cut, board[cut:]), (0, board[:cut])]
    port, ref, by_offset = (tmp_path / f"{n}.pgm" for n in ("port", "ref", "offset"))
    sharded.write_board_sharded(port, width, height, shards)
    jsharded.write_board_sharded(ref, width, height, shards)
    assert port.read_bytes() == ref.read_bytes()
    np.testing.assert_array_equal(read_pgm(port), board)
    offset = sharded.pgm_raster_offset(width, height)
    assert offset == jsharded.pgm_raster_offset(width, height)
    assert sharded.create_pgm(by_offset, width, height) == offset
    for start, rows in shards:
        sharded.write_rows_at(by_offset, offset, width, start, rows)
    assert by_offset.read_bytes() == ref.read_bytes()
    np.testing.assert_array_equal(read_shard(port, 1, height), jsharded.read_shard(ref, 1, height))
    with pytest.raises(sharded.PgmError, match="does not match width"):
        sharded.write_rows_at(port, offset, width, 0, board[:, :-1])


@pytest.mark.parametrize("cells", [[(64, 0)], [(0, -1)]])
def test_seed_packed_rejects_out_of_range(cells):
    for mod in (pbig, jbig):
        with pytest.raises(ValueError, match="outside"):
            mod.seed_packed(64, cells, **({"device": "cpu"} if mod is pbig else {}))
    with pytest.raises(ValueError, match="divisible"):
        pbig.seed_packed(40, [], device="cpu")


@pytest.mark.parametrize("word_axis", [0, 1])
def test_seed_packed_row_range_equals_the_reference(word_axis):
    cells = [(3, 5), (50, 37), (63, 32), (0, 63), (3, 6), (3, 5)]  # a duplicate, a shared word
    full = pbig.seed_packed(64, cells, word_axis, device="cpu")
    np.testing.assert_array_equal(full.numpy(), np.asarray(jbig.seed_packed(64, cells, word_axis)))
    local = pbig.seed_packed(64, cells, word_axis, row_range=(32, 64), device="cpu")
    np.testing.assert_array_equal(
        local.numpy(), np.asarray(jbig.seed_packed(64, cells, word_axis, row_range=(32, 64))))
    wlo, whi = (1, 2) if word_axis == 0 else (32, 64)
    assert torch.equal(local, full[wlo:whi])
    with pytest.raises(ValueError, match="outside"):
        pbig.seed_packed(64, [(0, 64)], word_axis, row_range=(0, 32), device="cpu")
    if word_axis == 0:
        with pytest.raises(ValueError, match="word-aligned"):
            pbig.seed_packed(64, cells, 0, row_range=(8, 40), device="cpu")
    assert alive_count_packed(pbig.seed_packed(64, [], word_axis, device="cpu")) == 0


def test_cli_smoke_equals_the_reference(tmp_path, capsys):
    out, ref = tmp_path / "cli.pgm", tmp_path / "ref.pgm"
    assert pbig.main(["-size", "512", "-turns", "20", "-out", str(out), "-device", "cpu",
                      "-row-block", "128"]) == 0
    assert capsys.readouterr().out.strip() == "alive " + str(
        int(np.count_nonzero(oracle_window(512, 20, WIN))))
    assert jbig.main(["-size", "512", "-turns", "20", "-out", str(ref),
                      "-row-block", "128"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    capsys.readouterr()
    # -out '' writes no PGM (a 65536^2 raster is 4 GiB)
    assert pbig.main(["-size", "256", "-turns", "3", "-out", "", "-device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "alive 9"


def test_cli_rule_and_refusals(tmp_path, capsys, monkeypatch):
    out = tmp_path / "hl.pgm"
    assert pbig.main(["-size", "256", "-turns", "30", "-rule", "B36/S23", "-out", str(out),
                      "-device", "cpu"]) == 0
    window = np.zeros((WIN, WIN), np.uint8)
    for x, y in pbig.r_pentomino(256):
        window[y, x] = 255
    for _ in range(30):
        window = vector_step(window, (3, 6), (2, 3))
    np.testing.assert_array_equal(read_shard(out, 0, 256), window)
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        pbig.main(["-size", "64", "-rule", "X", "-device", "cpu"])
    assert exc.value.code == 2 and "rulestring" in capsys.readouterr().err
    # a session always ends on its PGM, so it refuses -out '' before it starts
    with pytest.raises(SystemExit) as exc:
        pbig.main(["-session", "-size", "64", "-turns", "1", "-out", "", "-device", "cpu"])
    assert exc.value.code == 2 and "-out needs a path" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        pbig.main(["-size", "64", "-turns", "1"])
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbig.run_big_board(64, 1, None, cells=pbig.r_pentomino(64))


@pytest.mark.parametrize("size", [512, 1024])
def test_decode_window_equals_the_reference(size):
    from gol_distributed_final_tpu.ops.plane import BitPlane as JBitPlane

    state = BitPlane(device="cpu").step_n(
        pbig.seed_packed(size, pbig.r_pentomino(size), device="cpu"), TURNS)
    ref_state = JBitPlane().step_n(jbig.seed_packed(size, jbig.r_pentomino(size)), TURNS)
    w0 = _w0(size)
    got = pbig.decode_window(state, w0, w0, WIN, WIN)
    np.testing.assert_array_equal(got, _window(size))
    np.testing.assert_array_equal(got, jbig.decode_window(ref_state, w0, w0, WIN, WIN))
    got_off = pbig.decode_window(state, w0 + 5, w0 + 3, WIN - 5, WIN - 3)
    np.testing.assert_array_equal(got_off, _window(size)[5:, 3:])


def test_decode_window_bounds_and_axis1():
    rng = np.random.default_rng(3)
    board = np.where(rng.random((128, 128)) < 0.3, 255, 0).astype(np.uint8)
    for axis in (0, 1):
        packed = bitpack.pack(board, axis, "cpu")
        got = pbig.decode_window(packed, 17, 33, 50, 60, word_axis=axis)
        np.testing.assert_array_equal(got, board[17:67, 33:93])
        assert pbig.window_word_bounds(17, 33, 50, 60, axis) == jbig.window_word_bounds(
            17, 33, 50, 60, axis)
    with pytest.raises(ValueError, match="outside"):
        pbig.decode_window(bitpack.pack(board, 0, "cpu"), 100, 0, 50, 10)
    with pytest.raises(ValueError, match="positive"):
        pbig.decode_window(bitpack.pack(board, 0, "cpu"), 100, 0, -50, 10)


def test_engine_driven_big_board_with_control_plane(tmp_path):
    """The engine steps a packed board it never decodes, the count-only
    retrieve works mid-run, and the streamed PGM equals the reference's."""
    import threading

    size = 1024
    eng = Engine(EngineConfig(final_world=False, min_chunk=4, max_chunk=16, device="cpu"))
    counts, stop = [], threading.Event()

    def ticker():
        while not stop.is_set():
            counts.append(eng.retrieve(include_world=False).alive_count)

    t = threading.Thread(target=ticker)
    t.start()
    out = tmp_path / "eng.pgm"
    try:
        alive = pbig.run_big_board(size, TURNS, out, cells=pbig.r_pentomino(size),
                                   row_block=256, engine=eng)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive() and counts
    assert alive == int(np.count_nonzero(_window(size)))
    ref = tmp_path / "ref.pgm"
    jbig.run_big_board(size, TURNS, ref, cells=jbig.r_pentomino(size), row_block=256)
    assert out.read_bytes() == ref.read_bytes()
    state, turn = eng.state_snapshot()
    assert turn == TURNS and state is eng.final_state()
    with pytest.raises(ValueError, match="final_world=False"):
        pbig.run_big_board(64, 1, None, cells=[], engine=Engine(EngineConfig(device="cpu")))


def test_final_alive_from_packed_rows_matches_golden():
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    p = Params(turns=100, image_width=64, image_height=64)
    ref = Engine(EngineConfig(device="cpu")).run(p, board)
    res = Engine(EngineConfig(final_world=False, device="cpu")).run(
        p, None, plane=BitPlane(device="cpu"), initial_state=bitpack.pack(board, 0, "cpu"))
    assert res.world is None
    assert res.alive == ref.alive and res.alive_count == len(ref.alive)


def _drain(events):
    from gol_distributed_final_tpu_torch.engine.controller import CLOSED

    seq = []
    while True:
        ev = events.get(timeout=120)
        if ev is CLOSED:
            return seq
        seq.append(ev)


def test_big_session_full_event_surface(tmp_path):
    from gol_distributed_final_tpu_torch.events import (
        AliveCellsCount,
        FinalTurnComplete,
        ImageOutputComplete,
        Quitting,
        State,
        StateChange,
    )

    import time

    size = 1024
    events, keys = queue.Queue(), queue.Queue()
    for k in ("s", "p", "p"):
        keys.put(k)

    def hold(engine, state, turn):
        # the ticker handles the keys while the run goes on; on a loaded
        # host the 100 turns could end before it reaches the first 'p', and
        # a stopped ticker handles no more keys. So the run waits at its
        # first chunk until a pause is asked for (it then parks) or every
        # key is taken.
        deadline = time.monotonic() + 120
        while not (engine._paused or keys.empty()) and time.monotonic() < deadline:
            time.sleep(0.005)

    res = pbig.big_session(size, TURNS, cells=pbig.r_pentomino(size), row_block=256,
                           events=events, keypresses=keys, tick_seconds=0.05,
                           out_dir=tmp_path, engine=Engine(EngineConfig(
                               final_world=False, max_chunk=2, chunk_hook=hold,
                               device="cpu")))
    seq = _drain(events)
    final = [e for e in seq if isinstance(e, FinalTurnComplete)]
    assert len(final) == 1 and res.turns_completed == TURNS and res.world is None
    assert len(final[0].alive) == int(np.count_nonzero(_window(size)))
    assert any(isinstance(e, AliveCellsCount) for e in seq)
    states = [e.new_state for e in seq if isinstance(e, StateChange)]
    assert states[:2] == [State.PAUSED, State.EXECUTING] and states[-1] is Quitting
    assert isinstance(seq[-2], ImageOutputComplete)
    ref = tmp_path / "ref.pgm"
    jbig.run_big_board(size, TURNS, ref, cells=jbig.r_pentomino(size), row_block=256)
    assert (tmp_path / f"{size}x{size}x{TURNS}.pgm").read_bytes() == ref.read_bytes()
    # the lazy payload iterates to the cells of the packed rows
    want = bitpack.alive_cells_packed(pbig.seed_packed(size, pbig.r_pentomino(size),
                                                       device="cpu"))
    lazy = pbig._LazyAliveCells(BitPlane(device="cpu"),
                                pbig.seed_packed(size, pbig.r_pentomino(size), device="cpu"))
    assert len(lazy) == 5 and lazy == want and (lazy == 3) is False


def test_big_session_closes_the_stream_on_error():
    events = queue.Queue()
    with pytest.raises(ValueError, match="exactly one"):
        pbig.big_session(64, 1, events=events, device="cpu")
    assert _drain(events) == []


def test_cli_session_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "gol_distributed_final_tpu_torch.bigboard", "-session",
         "-size", "512", "-turns", "50", "-out", str(tmp_path / "x.pgm"), "-row-block", "128",
         "-device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert "Completed Turns 50 Quitting" in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "alive " + str(
        int(np.count_nonzero(oracle_window(512, 50, WIN))))
    assert (tmp_path / "x.pgm").exists() and not (tmp_path / "512x512x50.pgm").exists()
