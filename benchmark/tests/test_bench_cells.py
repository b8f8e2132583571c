"""A configuration whose board is a seeded pattern of live cells: the sparse
reference (``reference.evolve_cells``) against the dense one, placing by
coordinates against ``reference.transform``, the check
(``benchmark/checks/cells.py``) on planted faults, and whole runs on the
CPU of a toy configuration from a manifest the test builds."""

import json
import shutil
import time
import types

import numpy as np
import pytest

from benchmark import reference
from benchmark.harness import boards, manifest, runner
from benchmark.harness.sessions import Session

CELLS = manifest.check("cells")
PATTERN = manifest.BENCH / "inputs" / "r_pentomino.cells"
SIZE, TURNS = 256, 100
CONFIG = {"name": "toy256", "board": {"kind": "cells", "file": "inputs/r_pentomino.cells"},
          "width": SIZE, "height": SIZE, "rule": "B3/S23", "check": "cells"}


def _dense(cells, shape):
    board = np.zeros(shape, np.uint8)
    board[cells] = 255
    return board


def _sparse(board):
    return tuple(a.astype(np.int64) for a in np.nonzero(board))


@pytest.mark.parametrize("sym", range(8))
@pytest.mark.parametrize("size", [256, 512])
def test_sparse_evolution_equals_the_dense_one(size, sym):
    """The R-pentomino under each symmetry, centred and rolled across both
    seams; on 256² its gliders wrap and meet the ash by turn 2000."""
    shape = (size, size)
    ys, xs = boards.pattern(PATTERN, shape)
    # the middle of the pattern's bounding box, (1, 1) in its own frame
    cy, cx = boards.place([size // 2 + 1], [size // 2 + 1], (0, 0, sym), shape)
    for t in ((0, 0, sym), (-int(cy[0]), -int(cx[0]), sym)):
        cells = boards.place(ys, xs, t, shape)
        board, done = _dense(cells, shape), 0
        for turns in (0, 1, 100, 2000):
            board = reference.evolve(board, turns - done)
            cells = reference.evolve_cells(*cells, turns - done, size, size)
            done = turns
            want = _sparse(board)
            assert all(np.array_equal(a, b) for a, b in zip(cells, want)), (t, turns)


@pytest.mark.parametrize("rule", ["B3/S23", "B36/S23", "B2/S", "B3/S012345678"])
def test_sparse_evolution_of_a_soup_under_other_rules(rule):
    board = (np.random.default_rng(5).random((64, 96)) < 0.3).astype(np.uint8) * 255
    cells = reference.evolve_cells(*_sparse(board), 13, 64, 96, rule)
    want = _sparse(reference.evolve_bytes(board, 13, rule))
    assert all(np.array_equal(a, b) for a, b in zip(cells, want))


def test_a_rule_that_gives_birth_on_no_neighbours_is_refused():
    with pytest.raises(ValueError):
        reference.evolve_cells([1], [1], 1, 8, 8, "B03/S23")
    assert [a.tolist() for a in reference.evolve_cells([], [], 5, 8, 8)] == [[], []]


@pytest.mark.parametrize("turns,alive", [(1103, 116), (10000, 116)])
def test_the_r_pentomino_on_65536_settles_as_published(turns, alive):
    """Generation 1103, 116 cells (LifeWiki); its six gliders fly on, and
    none has reached a seam by turn 10^4 on a 65536² torus."""
    ys, xs = boards.pattern(PATTERN, (65536, 65536))
    out = reference.evolve_cells(ys, xs, turns, 65536, 65536)
    assert len(out[0]) == alive


def test_the_pattern_is_the_ports_r_pentomino():
    from gol_distributed_final_tpu_torch import bigboard

    for size in (64, 65536):
        ys, xs = boards.pattern(PATTERN, (size, size))
        assert sorted(zip(xs.tolist(), ys.tolist())) == sorted(bigboard.r_pentomino(size))


@pytest.mark.parametrize("text", ["", "# nothing\n", "1 2 3\n", "1 x\n"])
def test_a_pattern_file_without_pairs_is_refused(tmp_path, text):
    (tmp_path / "p.cells").write_text(text)
    with pytest.raises(ValueError):
        boards.pattern(tmp_path / "p.cells", (8, 8))


@pytest.mark.parametrize("shape", [(64, 64), (32, 64)])
def test_placing_by_coordinates_equals_transforming_the_board(shape):
    ys, xs = boards.pattern(PATTERN, shape)
    board = _dense((ys, xs), shape)
    syms = range(8) if shape[0] == shape[1] else (0, 2, 4, 6)
    for t in [(dy, dx, sym) for sym in syms for dy, dx in ((0, 0), (5, 61), (63, 1))]:
        assert np.array_equal(_dense(boards.place(ys, xs, t, shape), shape),
                              reference.transform(board, *t)), t
    with pytest.raises(ValueError):
        boards.place(ys, xs, (0, 0, 1), (32, 64))


def test_board_0_puts_the_patterns_centre_on_the_corner():
    shape = (64, 64)
    ys, xs = boards.pattern(PATTERN, shape)
    pool = boards.placements(2**33 + 7, 16, shape, ys, xs)
    assert pool[1:] == boards.transforms(2**33 + 7, 16, shape)[1:]
    assert pool[0][2] == boards.transforms(2**33 + 7, 1, shape)[0][2]
    for seed in range(16):
        t = boards.placements(seed, 1, shape, ys, xs)[0]
        y, x = boards.place(ys, xs, t, shape)
        # the centre (1, 1) of the pattern's 3 x 3 box lands on (0, 0)
        assert set(zip(y.tolist(), x.tolist())) <= {(a % 64, b % 64) for a in (-1, 0, 1)
                                                    for b in (-1, 0, 1)}, t
        assert {0, 63} <= set(y.tolist()) and {0, 63} <= set(x.tolist()), t


def _final(t, turns=TURNS):
    ys, xs = boards.pattern(PATTERN, (SIZE, SIZE))
    return reference.evolve(_dense(boards.place(ys, xs, t, (SIZE, SIZE)), (SIZE, SIZE)), turns)


def _sessions(tmp_path, seed=3_000_000_019, count=3, pool=2):
    """Sound sessions on ``pool`` placements taken in turn, answered with
    their cells; the first keeps its final PGM."""
    ys, xs = boards.pattern(PATTERN, (SIZE, SIZE))
    placed = boards.placements(seed, pool, (SIZE, SIZE), ys, xs)
    out = []
    for i in range(count):
        final = _final(placed[i % pool])
        s = Session(i, placed[i % pool], TURNS, answered=True, turns=TURNS,
                    alive=int(np.count_nonzero(final)), cells=_sparse(final))
        if i == 0:
            s.out_path = tmp_path / f"{i}.pgm"
            reference.write_pgm(s.out_path, final)
        out.append(s)
    return out


def _compare(sessions):
    checks = CELLS.compare(sessions, types.SimpleNamespace(config=CONFIG, board=CONFIG["board"]))
    return all(holds for _, _, holds in checks.values()), checks


def test_sound_sessions_hold_and_each_placement_evolves_once(tmp_path, monkeypatch):
    evolved = []
    evolve_cells = reference.evolve_cells

    def counted(*args):
        evolved.append(args[2])
        return evolve_cells(*args)

    monkeypatch.setattr(reference, "evolve_cells", counted)
    sessions = _sessions(tmp_path)
    ok, checks = _compare(sessions)
    assert ok, checks
    assert evolved == [TURNS, TURNS]
    assert checks["sessions_checked"] == (3, 1, True)
    assert checks["wrap_sessions_checked"][0] == 2  # board 0, twice
    assert checks["alive_checked"][0] == sum(s.alive for s in sessions)
    assert not sessions[0].out_path.exists()


def _move(s):
    ys, xs = (a.copy() for a in s.cells)
    xs[3] = (xs[3] + 1) % SIZE
    s.cells = (ys, xs)


def _drop(s):
    s.cells = tuple(a[1:] for a in s.cells)


def _add(s):
    ys, xs = s.cells
    s.cells = (np.append(ys, (ys[0] + 128) % SIZE), np.append(xs, xs[0]))


def _twice(s):
    s.cells = tuple(np.append(a[1:], a[1]) for a in s.cells)


def _turns(s):
    s.turns -= 1


def _alive(s):
    s.alive += 1


def _pgm(s):
    data = bytearray(s.out_path.read_bytes())
    data[-5] = 255 - data[-5]
    s.out_path.write_bytes(bytes(data))


def _no_cells(s):
    s.cells = None


FAULTS = {"cell_moved": (_move, "wrong_cells"), "cell_missing": (_drop, "wrong_cells"),
          "cell_extra": (_add, "wrong_cells"), "cell_twice": (_twice, "wrong_cells"),
          "no_cells": (_no_cells, "wrong_cells"), "turns_short": (_turns, "wrong_turns"),
          "alive_off_by_one": (_alive, "wrong_alive"), "pgm_byte_off": (_pgm, "wrong_pgm")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_check(tmp_path, fault):
    plant, name = FAULTS[fault]
    sessions = _sessions(tmp_path)
    plant(sessions[0])
    ok, checks = _compare(sessions)
    assert not ok and checks[name][0] == 1 and not checks[name][2], checks


def test_closed_edges_on_the_corner_session_fail_the_check(tmp_path):
    """The control: the reference with the torus's wrap broken, which only
    the session on the corner can see."""
    sessions = _sessions(tmp_path)
    for s in sessions:
        closed = reference.evolve(_final(s.board, 0), TURNS, wrap=False)
        s.cells, s.alive = _sparse(closed), int(np.count_nonzero(closed))
    ok, checks = _compare(sessions)
    assert not ok and checks["wrong_cells"][0] == 2, checks  # board 0, twice


def test_a_run_with_no_corner_session_fails_the_check(tmp_path):
    """Every session centred, as board 1 is: the seams go unchecked."""
    sessions = _sessions(tmp_path)
    for s in sessions:
        s.board = (0, 0, s.board[2])
        final = _final(s.board)
        s.cells, s.alive = _sparse(final), int(np.count_nonzero(final))
    ok, checks = _compare(sessions)
    assert not ok and checks["wrap_sessions_checked"] == (0, 1, False), checks
    assert checks["wrong_cells"] == (0, 0, True)


def test_no_session_and_no_live_cell_fail_the_check(tmp_path):
    sessions = _sessions(tmp_path)
    for s in sessions:
        s.answered = False
    ok, checks = _compare(sessions)
    assert not ok and checks["unanswered"] == (3, 0, False)
    assert checks["sessions_checked"] == (0, 1, False)
    # under B/S every cell dies in one turn: sound answers, nothing compared
    sessions = _sessions(tmp_path)
    for s in sessions:
        s.cells, s.alive = (np.zeros(0, np.int64),) * 2, 0
        s.out_path = None
    checks = CELLS.compare(sessions, types.SimpleNamespace(config=dict(CONFIG, rule="B/S"),
                                                           board=CONFIG["board"]))
    assert checks["alive_checked"] == (0, 1, False) and checks["wrong_cells"][0] == 0


def test_a_pgm_of_another_size_fails_the_check(tmp_path):
    sessions = _sessions(tmp_path)
    reference.write_pgm(sessions[0].out_path, np.zeros((SIZE - 1, SIZE), np.uint8))
    assert _compare(sessions)[1]["wrong_pgm"] == (1, 0, False)


def test_the_pgms_cells_are_read_in_blocks(tmp_path, monkeypatch):
    board = (np.random.default_rng(2).random((300, 64)) < 0.2).astype(np.uint8) * 255
    reference.write_pgm(tmp_path / "b.pgm", board)
    monkeypatch.setattr(CELLS, "ROWS", 7)
    got = CELLS.pgm_cells(tmp_path / "b.pgm", (300, 64))
    assert all(np.array_equal(a, b) for a, b in zip(got, _sparse(board)))
    assert CELLS.pgm_cells(tmp_path / "b.pgm", (301, 64)) is None
    assert CELLS.pgm_cells(tmp_path / "b.pgm", (300, 65)) is None


@pytest.mark.parametrize("board,ok", [({"kind": "cells", "file": "inputs/r_pentomino.cells"}, True),
                                      ({"kind": "soup", "density": 0.5}, True),
                                      ({"kind": "raster"}, False), (None, False)])
def test_the_runner_takes_a_seeded_board_of_a_known_kind(board, ok):
    config = {"name": "x", "width": SIZE, "height": SIZE}
    if board is not None:
        config["board"] = board
    if ok:
        assert runner._image(config) is None
    else:
        with pytest.raises(ValueError):
            runner._image(config)


@pytest.fixture
def toy(root, tmp_path, monkeypatch, tmpdir_env):
    """A checkout whose BENCHMARK.json holds a 256 x 256 R-pentomino
    configuration and its one cell, run by the test's driver
    (``cell_sessions.py``) and checked by ``checks/cells.py``; the metrics
    are the repository's."""
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"] = [{"name": "toy256", "source": "https://example.org/toy",
                        "file": "benchmark/configs/toy256.json", "reduced": [], "why": "a test"}]
    data["workloads"] = [{"name": "toy256.cells", "config": "toy256", "traffic": "cells",
                          "chips": 1, "why": "a test"}]
    bench = tmp_path / "checkout" / "benchmark"
    for kind in ("configs", "workloads", "traffic"):
        (bench / kind).mkdir(parents=True)
    for kind in ("metrics", "checks", "inputs"):
        (bench / kind).symlink_to(manifest.BENCH / kind)
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(data))
    (bench / "configs" / "toy256.json").write_text(json.dumps(
        dict(CONFIG, broker_args=["-session-capacity", "8"], reduced=[])))
    (bench / "workloads" / "toy256.cells.json").write_text(json.dumps(
        {"config": "toy256", "driver": "cell_sessions", "turns": 300, "pool": 4}))
    shutil.copy(manifest.BENCH / "tests" / "cell_sessions.py", bench / "traffic")
    monkeypatch.setattr(manifest, "ROOT", bench.parent)
    monkeypatch.setattr(manifest, "BENCH", bench)
    return "toy256.cells"


def test_a_cells_configuration_runs_end_to_end_and_holds(toy, capsys):
    rc = runner.main(["--workload", toy, "--seed", "3000000023", "--seconds", "1"],
                     t_start=time.monotonic(), device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert list(line["checks"]) == ["unanswered", "wrong_turns", "wrong_alive", "wrong_cells",
                                    "wrong_pgm", "sessions_checked", "wrap_sessions_checked",
                                    "alive_checked"]
    assert line["checks"]["sessions_checked"]["value"] == line["attempted"]
    assert line["checks"]["wrap_sessions_checked"]["value"] >= 1
    tail = err.strip().splitlines()[-8:]
    assert tail[0] == "check unanswered 0 (at most 0)"
    assert tail[-3].startswith("check sessions_checked ") and tail[-3].endswith("(at least 1)")


@pytest.mark.parametrize("fault", ["unchanged", "control"])
def test_a_planted_broker_fault_fails_the_cells_configuration(toy, fault):
    """A step that returns its state unchanged, and the control (closed
    edges), which the session placed on the torus's corner sees."""
    args = runner.parse(["--workload", toy, "--seed", "3000000029", "--seconds", "1"])
    line, _ = runner.measure(args, manifest.cell(toy), time.monotonic(), device="cpu",
                             fault=fault)
    assert line["correct"] is False
    assert line["checks"]["wrong_cells"]["value"] >= 1
