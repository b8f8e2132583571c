"""The PyTorch port's activity-sparse plane on the CPU, held against the JAX
package's (ops/sparse.py there and here): the same seeded boards go through
both ``SparseBitPlane``s, and after every ``step_n`` call the boards, the
active-tile ``count`` and the ``steady`` verdict are equal. The scenarios
are those of tests/test_sparse.py: an R-pentomino across tile edges that
overflows and regrows its capacity buckets, the Gosper gun, a glider
across the torus corner, the all-dead board, a soup past the dense
crossover, frontier churn, explicit ragged tiles and every rule without
birth on 0, then routing, the engine's early exits, a sparse session's
periodic checkpoint and ``--selfcheck``. The JAX plane runs jitted on the
CPU, the port's on its plain torch program (ops/sparse_tiles.py); the
CUDA kernel is held against that program on the card
(tests/test_torch_cuda.py). Game of Life is integer-exact: every
comparison is equality.
"""

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.models import LifeRule as JLifeRule
from gol_distributed_final_tpu.ops import sparse as jsparse
from gol_distributed_final_tpu_torch.models import LifeRule
from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

from helpers import REPO_ROOT


def _r_pentomino(h, w):
    board = np.zeros((h, w), np.uint8)
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        board[h // 2 + dy, w // 2 + dx] = 255
    return board


def _glider(h, w, y=1, x=1):
    board = np.zeros((h, w), np.uint8)
    for dy, dx in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        board[(y + dy) % h, (x + dx) % w] = 255
    return board


def _gosper_gun(h, w):
    cells = [
        (5, 1), (5, 2), (6, 1), (6, 2), (5, 11), (6, 11), (7, 11),
        (4, 12), (8, 12), (3, 13), (9, 13), (3, 14), (9, 14), (6, 15),
        (4, 16), (8, 16), (5, 17), (6, 17), (7, 17), (6, 18), (3, 21),
        (4, 21), (5, 21), (3, 22), (4, 22), (5, 22), (2, 23), (6, 23),
        (1, 25), (2, 25), (6, 25), (7, 25), (3, 35), (4, 35), (3, 36),
        (4, 36),
    ]
    board = np.zeros((h, w), np.uint8)
    for y, x in cells:
        board[y, x] = 255
    return board


def _soup(h, w, p, seed, window=None):
    rng = np.random.default_rng(seed)
    board = np.zeros((h, w), np.uint8)
    y0, y1, x0, x1 = window or (0, h, 0, w)
    board[y0:y1, x0:x1] = np.where(rng.random((y1 - y0, x1 - x0)) < p, 255, 0)
    return board


def _planes(rulestring, tile):
    return (jsparse.SparseBitPlane(JLifeRule.from_rulestring(rulestring), tile=tile),
            sparse.SparseBitPlane(LifeRule.from_rulestring(rulestring), tile=tile,
                                  device="cpu"))


def _assert_same(jplane, jstate, pplane, pstate, where):
    assert np.array_equal(pplane.decode(pstate), np.asarray(jplane.decode(jstate))), where
    assert (pstate.count, pstate.steady) == (jstate.count, jstate.steady), where


@pytest.fixture
def dispatches(monkeypatch):
    """Every dispatch the port's plane makes, as returned."""
    seen = []
    real = sparse_tiles.dispatch

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(sparse_tiles, "dispatch", spy)
    return seen


# board, rule, tile (None: the default), step_n calls
SCENARIOS = {
    # 8 x 16 = 128 tiles: the methuselah outgrows its seed buckets
    "r_pentomino_tile_edges": (lambda: _r_pentomino(256, 256), "B3/S23", (1, 16),
                               [1, 299, 8]),
    "gosper_gun": (lambda: _gosper_gun(128, 128), "B3/S23", (1, 16), [3, 61, 136]),
    "glider_torus_corner": (lambda: _glider(64, 64, y=60, x=60), "B3/S23", (1, 8),
                            [5, 120, 125]),
    "all_dead": (lambda: np.zeros((64, 64), np.uint8), "B3/S23", (1, 8), [1000, 7]),
    "soup_dense_crossover": (lambda: _soup(64, 64, 0.3, 3), "B3/S23", (1, 8), [40, 9]),
    "default_tile": (lambda: _soup(256, 256, 0.35, 5, (100, 130, 90, 140)), "B3/S23",
                     None, [16, 3, 45]),
    "ragged_tile_3x12": (lambda: _soup(96, 96, 0.3, 7, (40, 60, 30, 70)), "B3/S23",
                         (3, 12), [9, 30]),
    "tile_1x2_blinker": (lambda: _soup(64, 64, 0.5, 9, (20, 26, 20, 26)), "B3/S23",
                         (1, 2), [3, 40, 11]),
    "highlife": (lambda: _soup(128, 128, 0.3, 11, (50, 80, 40, 90)), "B36/S23", (1, 16),
                 [24, 17]),
    "seeds": (lambda: _soup(128, 128, 0.05, 13, (60, 68, 60, 68)), "B2/S", (1, 8),
              [6, 5]),
    "day_and_night": (lambda: _soup(128, 128, 0.6, 17, (40, 90, 40, 90)),
                      "B3678/S34678", (2, 16), [16, 9]),
    "runtime_rule_b36_s125": (lambda: _soup(128, 128, 0.3, 19, (50, 80, 40, 90)),
                              "B36/S125", (1, 8), [8, 21]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sparse_plane_equals_the_reference_after_every_call(name, dispatches):
    make, rulestring, tile, calls = SCENARIOS[name]
    board = make()
    jplane, pplane = _planes(rulestring, tile)
    dense_calls = []
    dense_step_n = pplane._dense.step_n
    pplane._dense.step_n = lambda packed, n: dense_calls.append(n) or dense_step_n(packed, n)
    jstate, pstate = jplane.encode(board), pplane.encode(board)
    _assert_same(jplane, jstate, pplane, pstate, f"{name} encode")
    seed_count = pstate.count
    for i, n in enumerate(calls):
        jstate, pstate = jplane.step_n(jstate, n), pplane.step_n(pstate, n)
        _assert_same(jplane, jstate, pplane, pstate, f"{name} call {i} (n={n})")
    if name == "r_pentomino_tile_edges":
        assert pstate.count > seed_count
        assert any(d.overflow for d in dispatches), "no bucket overflowed"
    if name == "all_dead":
        assert pstate.steady == "still" and pplane.alive_count(pstate) == 0
    if name == "soup_dense_crossover":
        assert seed_count > sparse.SPARSE_DENSITY_CROSSOVER * 2 * 8
        assert dense_calls[:1] == [calls[0]], "the first call missed the dense plane"


def test_b0_rule_refused():
    for plane in (jsparse.SparseBitPlane, sparse.SparseBitPlane):
        rule = (JLifeRule if plane is jsparse.SparseBitPlane else LifeRule).from_rulestring(
            "B0/S23")
        with pytest.raises(ValueError, match="births on 0"):
            plane(rule)


@pytest.mark.parametrize("mode", [None, "auto", "on", "off"])
@pytest.mark.parametrize("shape,rulestring", [
    ((64, 64), "B3/S23"), ((4096, 4096), "B3/S23"), ((4097, 4096), "B3/S23"),
    ((4096, 4096), "B03/S23"), ((96, 96), "B36/S23"), ((8192, 2048), "B2/S"),
])
def test_sparse_capable_equals_the_reference(monkeypatch, mode, shape, rulestring):
    # the port's floor is the card's break-even; under the reference's
    # floor the port routes as the reference does
    monkeypatch.setattr(sparse, "SPARSE_MIN_CELLS", jsparse.SPARSE_MIN_CELLS)
    if mode is None:
        monkeypatch.delenv("GOL_SPARSE", raising=False)
    else:
        monkeypatch.setenv("GOL_SPARSE", mode)
    got = sparse.sparse_capable(LifeRule.from_rulestring(rulestring), shape)
    assert got == jsparse.sparse_capable(JLifeRule.from_rulestring(rulestring), shape)


@pytest.mark.parametrize("mode,shape", [
    ("on", (96, 96)), ("off", (96, 96)), ("auto", (4096, 4096)), ("auto", (64, 64)),
    ("on", (64, 96)), ("on", (48, 64)),
])
def test_auto_plane_picks_the_plane_the_reference_picks(monkeypatch, mode, shape):
    from gol_distributed_final_tpu.models import CONWAY as J_CONWAY
    from gol_distributed_final_tpu.ops import auto as jauto
    from gol_distributed_final_tpu_torch.models import CONWAY
    from gol_distributed_final_tpu_torch.ops import auto

    monkeypatch.setattr(sparse, "SPARSE_MIN_CELLS", jsparse.SPARSE_MIN_CELLS)
    monkeypatch.setenv("GOL_SPARSE", mode)
    jauto._PLANE_CACHE.pop((J_CONWAY.rulestring, shape), None)
    try:
        want = isinstance(jauto.auto_plane(J_CONWAY, shape), jsparse.SparseBitPlane)
    finally:
        jauto._PLANE_CACHE.pop((J_CONWAY.rulestring, shape), None)
    got = auto.auto_plane(CONWAY, shape, "cpu")
    assert isinstance(got, sparse.SparseBitPlane) == want
    if want:
        assert got.device.type == "cpu"


@pytest.mark.parametrize("shape,sparse_route", [
    ((2048, 4096), False), ((4096, 4096), True), ((8192, 4096), True), ((4096, 16384), True),
    ((16384, 16384), True),
])
def test_the_ports_floor_is_the_cards_break_even(monkeypatch, shape, sparse_route):
    """The port routes from 4096^2 cells, the reference's floor, where the
    sparse plane's wall holds the dense plane's on the H100 (chip_smoke.py
    --sparse-dense); half of it stays dense."""
    from gol_distributed_final_tpu_torch.models import CONWAY
    from gol_distributed_final_tpu_torch.ops import auto

    monkeypatch.delenv("GOL_SPARSE", raising=False)
    assert sparse.SPARSE_MIN_CELLS == 4096 * 4096 == jsparse.SPARSE_MIN_CELLS
    assert sparse.sparse_capable(CONWAY, shape) is sparse_route
    assert isinstance(auto.auto_plane(CONWAY, shape, "cpu"), sparse.SparseBitPlane) is sparse_route


def test_frontier_churn_equals_the_reference_every_turn():
    """100 one-turn calls on a growing and shrinking soup: count and steady
    after every call, the board at the end."""
    board = _soup(256, 256, 0.35, 11, (96, 160, 96, 160))
    jplane, pplane = _planes("B3/S23", (1, 16))
    jstate, pstate = jplane.encode(board), pplane.encode(board)
    counts = set()
    for turn in range(1, 101):
        jstate, pstate = jplane.step_n(jstate, 1), pplane.step_n(pstate, 1)
        assert (pstate.count, pstate.steady) == (jstate.count, jstate.steady), turn
        counts.add(pstate.count)
    assert len(counts) > 5, "the frontier must churn"
    assert np.array_equal(pplane.decode(pstate), np.asarray(jplane.decode(jstate)))


def test_from_packed_adopts_the_reference_words():
    board = _soup(128, 256, 0.2, 23, (10, 60, 100, 200))
    jplane, pplane = _planes("B3/S23", None)
    jstate = jplane.encode(board)
    pstate = pplane.from_packed(np.asarray(jstate.packed))
    assert pstate.count == jstate.count
    assert np.array_equal(pstate.grid.numpy(), np.asarray(jstate.grid))
    assert pplane.active_fraction(pstate) == jplane.active_fraction(jstate)
    assert sparse.active_fraction_of(pstate.packed) == jsparse.active_fraction_of(
        jstate.packed)
    jstate, pstate = jplane.step_n(jstate, 30), pplane.step_n(pstate, 30)
    _assert_same(jplane, jstate, pplane, pstate, "from_packed then 30 turns")


@pytest.mark.parametrize("packed_shape", [(8, 256), (512, 16384), (2048, 65536), (3, 96),
                                          (6, 10), (1, 7)])
def test_default_tile_is_the_reference_tile(packed_shape):
    from gol_distributed_final_tpu.ops.pallas_tiled import sparse_tile_shape

    assert sparse.sparse_tile_shape(packed_shape) == sparse_tile_shape(packed_shape)


@pytest.mark.parametrize("tile", [(1, 1), (1, 2), (1, 16), (8, 128), (3, 12)])
def test_block_turns_equal_the_reference(tile):
    assert sparse.sparse_block_turns(*tile) == jsparse.sparse_block_turns(*tile)


def _emulated_counts(packed, grid, n_blocks, tile, h, capacity):
    """The counts array the kernel leaves: counts[0] from the grid, then
    counts[k + 1] from block k's dilated grid, for the blocks that run."""
    counts = [0] * (n_blocks + 1)
    counts[0] = int(grid.sum())
    for k in range(n_blocks):
        if not 1 <= counts[k] <= capacity:
            break
        run = sparse_tiles.dispatch_plain(packed, grid, 1, tile, h, capacity, 8, 12)
        packed, grid = run.packed, run.grid
        counts[k + 1] = run.count
    return packed, grid, counts


@pytest.mark.parametrize("n_blocks,capacity", [(0, 16), (1, 16), (12, 16), (12, 8),
                                               (40, 64)])
def test_reading_the_counts_stops_where_the_loop_stops(n_blocks, capacity):
    """The kernel's host side finds blocks_done, the overflow, the active
    sum and the count from the counts alone: held against the plain
    program's loop on a glider (which drains nothing), a still life after
    a dying seed (which drains) and an overflow (capacity 8)."""
    for board in (_glider(64, 64, 30, 30), _soup(64, 64, 0.5, 1, (10, 14, 10, 14)),
                  _r_pentomino(64, 64)):
        pplane = sparse.SparseBitPlane(LifeRule.from_rulestring("B3/S23"), tile=(1, 8),
                                       device="cpu")
        st = pplane.encode(board)
        want = sparse_tiles.dispatch_plain(st.packed, st.grid, n_blocks, (1, 8), 8,
                                           capacity, 8, 12)
        packed, grid, counts = _emulated_counts(st.packed, st.grid, n_blocks, (1, 8), 8,
                                                capacity)
        got = sparse_tiles._read_counts(packed, grid, counts, n_blocks, capacity)
        assert (got.blocks_done, got.overflow, got.active_sum, got.count) == (
            want.blocks_done, want.overflow, want.active_sum, want.count)
        assert torch.equal(got.packed, want.packed) and torch.equal(got.grid, want.grid)


def test_dispatch_never_writes_its_inputs():
    pplane = sparse.SparseBitPlane(LifeRule.from_rulestring("B3/S23"), tile=(1, 8),
                                   device="cpu")
    st = pplane.encode(_r_pentomino(64, 64))
    packed, grid = st.packed.clone(), st.grid.clone()
    run = sparse_tiles.dispatch(st.packed, st.grid, 4, (1, 8), 8, 16, 8, 12)
    assert run.blocks_done == 4 and not torch.equal(run.packed, packed)
    assert torch.equal(st.packed, packed) and torch.equal(st.grid, grid)


# -- the engine --------------------------------------------------------------


def _engines(board, turns, tile, **config):
    """The same run through the JAX engine and the port's, each on its own
    sparse plane: ``(jax engine, jax result, port engine, port result)``."""
    from gol_distributed_final_tpu.engine.engine import Engine as JEngine
    from gol_distributed_final_tpu.engine.engine import EngineConfig as JEngineConfig
    from gol_distributed_final_tpu.params import Params as JParams
    from gol_distributed_final_tpu_torch import Params
    from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig

    h, w = board.shape
    jplane, pplane = _planes("B3/S23", tile)
    jeng = JEngine(JEngineConfig(**config))
    jres = jeng.run(JParams(turns=turns, image_width=w, image_height=h), board,
                    plane=jplane)
    peng = Engine(EngineConfig(device="cpu", **config))
    pres = peng.run(Params(turns=turns, image_width=w, image_height=h), board,
                    plane=pplane)
    return jeng, jres, peng, pres


@pytest.mark.parametrize("kind,turns", [("still", 5000), ("period2", 400),
                                        ("period2", 401)])
def test_engine_early_exit_equals_the_reference(kind, turns, dispatches):
    board = np.zeros((64, 64), np.uint8)
    if kind == "still":
        board[30:32, 30:32] = 255  # a block
    else:
        board[20, 19:22] = 255  # a horizontal blinker
    jeng, jres, peng, pres = _engines(board, turns, (1, 2))
    assert pres.turns_completed == jres.turns_completed == turns
    assert np.array_equal(pres.world, np.asarray(jres.world))
    pstate, jstate = peng.final_state(), jeng.final_state()
    assert pstate.steady == jstate.steady == kind
    # the early exit jumped the run: a handful of dispatches, not one a block
    assert len(dispatches) < 40


def test_engine_state_of_a_sparse_run_decodes_as_the_reference():
    board = _r_pentomino(128, 128)
    jeng, jres, peng, pres = _engines(board, 77, None, min_chunk=4, max_chunk=16)
    assert pres.turns_completed == jres.turns_completed == 77
    assert np.array_equal(pres.world, np.asarray(jres.world))
    pstate, jstate = peng.final_state(), jeng.final_state()
    assert isinstance(pstate, sparse.SparseState)
    assert np.array_equal(peng._plane.decode(pstate), np.asarray(jeng._plane.decode(jstate)))
    (ps, pturn), (js, jturn) = peng.state_snapshot(), jeng.state_snapshot()
    assert pturn == jturn == 77
    assert np.array_equal(peng._plane.decode(ps), np.asarray(jeng._plane.decode(js)))
    assert peng.retrieve(include_world=False).alive_count == int(
        np.count_nonzero(pres.world))


def test_sparse_session_periodic_checkpoint_equals_the_reference(tmp_path):
    """A sparse plane's state is no int32 tensor: the engine writes the
    byte checkpoint of its decoded board, the file the JAX engine writes,
    and it resumes to the same board."""
    from gol_distributed_final_tpu_torch import Params
    from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
    from gol_distributed_final_tpu_torch.engine import checkpoint as pck

    from gol_distributed_final_tpu.engine.engine import Engine as JEngine
    from gol_distributed_final_tpu.engine.engine import EngineConfig as JEngineConfig
    from gol_distributed_final_tpu.params import Params as JParams

    board = _r_pentomino(128, 128)
    paths = {name: tmp_path / f"{name}.npz" for name in ("port", "ref")}
    jplane, pplane = _planes("B3/S23", (1, 16))
    jres = JEngine(JEngineConfig(min_chunk=10, max_chunk=10, checkpoint_every=30,
                                 checkpoint_path=str(paths["ref"]))).run(
        JParams(turns=100, image_width=128, image_height=128), board, plane=jplane)
    res = Engine(EngineConfig(min_chunk=10, max_chunk=10, checkpoint_every=30,
                              checkpoint_path=str(paths["port"]), device="cpu")).run(
        Params(turns=100, image_width=128, image_height=128), board, plane=pplane)
    assert res.checkpoint_error is None
    with np.load(paths["port"]) as p, np.load(paths["ref"]) as r:
        assert sorted(p.files) == sorted(r.files)
        for key in p.files:
            assert p[key].dtype == r[key].dtype and np.array_equal(p[key], r[key]), key
    world, turn, rule = pck.load_checkpoint(paths["port"])
    assert turn == 90 and rule.rulestring == "B3/S23"
    resumed = Engine(EngineConfig(device="cpu")).run(
        Params(turns=100, image_width=128, image_height=128), world,
        plane=sparse.SparseBitPlane(tile=(1, 16), device="cpu"), initial_turn=turn)
    assert resumed.turns_completed == 100
    assert np.array_equal(resumed.world, res.world)
    assert np.array_equal(res.world, np.asarray(jres.world))


def test_sparse_route_session_writes_the_golden_pgm(monkeypatch, tmp_path):
    """GOL_SPARSE=on sends a 64^2 controller session to the sparse plane,
    whose PGM is the golden one."""
    from gol_distributed_final_tpu_torch import Params, run

    monkeypatch.setenv("GOL_SPARSE", "on")
    calls = sparse_tiles.plain_calls
    run(Params(turns=100, image_width=64, image_height=64), images_dir=REPO_ROOT / "images",
        out_dir=tmp_path, tick_seconds=3600, device="cpu")
    assert sparse_tiles.plain_calls > calls
    golden = REPO_ROOT / "check" / "images" / "64x64x100.pgm"
    assert (tmp_path / "64x64x100.pgm").read_bytes() == golden.read_bytes()


def test_selfcheck(capsys):
    assert sparse.main(["--selfcheck", "-device", "cpu"]) == 0
    assert "sparse selfcheck ok on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        sparse.main([])
