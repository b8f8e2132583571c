"""The PyTorch port's fused-K ladder (ops/fused.py), its step functions
(ops/pallas_stencil.py, ops/tiled.py, ops/bitpack.py, ops/auto.py) and the
engine's step-function override, against the JAX package's counterparts,
run in interpret mode on the CPU as tests/test_fused.py runs them.

On the CPU each kernel wrapper takes its plain torch version and counts
one plain call per launch it stands in for, so the counts show which
kernel a route would launch on the card, and how often.
Game of Life is integer-exact: equality, tolerance none.
"""

import queue

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.engine import engine as jengine
from gol_distributed_final_tpu.models import life as jlife
from gol_distributed_final_tpu.ops import auto as jauto
from gol_distributed_final_tpu.ops import bitpack as jbit
from gol_distributed_final_tpu.ops import fused as jfused
from gol_distributed_final_tpu.ops import pallas_stencil as jps
from gol_distributed_final_tpu.ops import pallas_tiled as jtiled
from gol_distributed_final_tpu.params import Params as JParams
from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
from gol_distributed_final_tpu_torch.engine.controller import CLOSED
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.models import life as tlife
from gol_distributed_final_tpu_torch.ops import (
    auto, batch_board, bitpack, byte_board, byte_tiled, fused, pallas_stencil, plane,
    tiled, whole_board,
)

from helpers import REPO_ROOT, read_alive_counts

#: the JAX suite's byte-tier geometries (tests/test_fused.py), none of
#: them 32-row-divisible
WIRE_GEOMETRIES = [(24, 33), (64, 64), (16, 40)]

COUNTED = (byte_board, byte_tiled, whole_board, tiled, batch_board)


def _board(h, w, seed, density=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < density, 255, 0).astype(np.uint8)


def _plain_calls():
    return {m.__name__.rsplit(".", 1)[1]: m.plain_calls for m in COUNTED}


def _delta(before):
    return {k: v - before[k] for k, v in _plain_calls().items() if v != before[k]}


def _launches(n, k):
    full, rem_ks = fused._ladder(n, k)
    return full + len(rem_ks)


def _byte_kernel(shape):
    """The kernel a byte board of ``shape`` is routed to: K5 under its gate,
    else K6."""
    return "byte_board" if byte_board.fits(tuple(shape), "cpu") else "byte_tiled"


# -- quantiser and ladder -----------------------------------------------------


def test_quantise_k_and_ladder_equal_jax():
    assert (fused.FUSED_MAX_K, fused.FUSED_K_DEFAULT) == (jfused.FUSED_MAX_K,
                                                         jfused.FUSED_K_DEFAULT)
    for k in range(-2, 12):
        assert fused.quantise_k(k) == jfused.quantise_k(k), k
    for n in range(41):
        for k in range(1, 10):
            assert fused._ladder(n, k) == jfused._ladder(n, k), (n, k)


# -- the byte ladder: fused_step_n --------------------------------------------


@pytest.mark.parametrize("shape", WIRE_GEOMETRIES + [(64, 128), (512, 512)])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_fused_step_n_matches_jax(shape, k):
    """n = 13 turns, K per launch: K5's ladder under the port's gate
    (``byte_board.fits``), K6's past it; one plain call per launch of the
    ladder."""
    board = _board(*shape, seed=shape[0] + k)
    want = np.asarray(jfused.fused_step_n(board, 13, k=k, interpret=True))
    before = _plain_calls()
    got = fused.fused_step_n(torch.from_numpy(board.copy()), 13, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {_byte_kernel(shape): _launches(13, k)}


@pytest.mark.parametrize("k", [1, 4, 8])
def test_fused_step_n_past_the_gate_takes_the_byte_tiles(k, monkeypatch):
    """The gate is ``byte_board.fits`` alone: with its size limit lowered
    under a board, that board's ladder is the byte tiles', launch for
    launch."""
    shape = (64, 128)
    board = _board(*shape, seed=k)
    want = np.asarray(jfused.fused_step_n(board, 13, k=k, interpret=True))
    monkeypatch.setattr(byte_board, "MAX_CELLS", 64 * 128 - 1)
    assert _byte_kernel(shape) == "byte_tiled"
    before = _plain_calls()
    got = fused.fused_step_n(torch.from_numpy(board.copy()), 13, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {"byte_tiled": _launches(13, k)}
    before = _plain_calls()
    got = pallas_stencil.pallas_step_n_fn()(torch.from_numpy(board.copy()), 40)
    assert _delta(before) == {"byte_tiled": 2}  # 32 turns a launch
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfused.fused_step_n(
        board, 40, interpret=True)))


def test_fused_step_n_rules_and_defaults():
    board = _board(64, 128, seed=9)
    for rule in ("HIGHLIFE", "SEEDS", "DAY_AND_NIGHT"):
        jrule, trule = getattr(jlife, rule), getattr(tlife, rule)
        want = np.asarray(jfused.fused_step_n(board, 11, rule=jrule, interpret=True))
        got = fused.fused_step_n(torch.from_numpy(board), 11, rule=trule)
        np.testing.assert_array_equal(got.numpy(), want)
        got = fused.fused_step_n(torch.from_numpy(board), 11,
                                 birth_mask=trule.birth_mask, survive_mask=trule.survive_mask)
        np.testing.assert_array_equal(got.numpy(), want)
    # n <= 0 is the board itself; a numpy board goes where the caller says
    state = torch.from_numpy(board)
    assert fused.fused_step_n(state, 0) is state
    got = fused.fused_step_n(board, 3, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfused.fused_step_n(board, 3, interpret=True))
    )


def test_fused_step_n_past_the_tiles_takes_the_roll_stencil():
    """A board with more rows of tiles than one launch's grid holds is
    the roll stencil's, as the JAX package's is for shapes its byte tiles
    refuse."""
    shape = (byte_tiled.MAX_GRID_ROWS * byte_tiled.TILE[0] + 32, 1)
    assert not fused.can_tile_byte(shape) and not jfused.can_tile_byte(shape)
    board = _board(*shape, seed=2, density=0.5)
    before = _plain_calls()
    got = fused.fused_step_n(torch.from_numpy(board), 2)
    assert _delta(before) == {}
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfused.fused_step_n(board, 2, interpret=True))
    )


def test_fused_step_n_off_the_cpu_never_takes_the_roll_stencil():
    """Off the CPU a board the tiles cannot take goes to the byte tiles all
    the same, which refuse it: no torch stand-in runs on a device."""
    board = torch.zeros((byte_tiled.MAX_GRID_ROWS * byte_tiled.TILE[0] + 32, 1),
                        dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no byte-tile kernel"):
        fused.fused_step_n(board, 2)


# -- the bitboard ladders -----------------------------------------------------


@pytest.mark.parametrize("h,w,word_axis", [(64, 64, 0), (40, 64, 1)])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_fused_bit_step_n_matches_jax(h, w, word_axis, k):
    packed = np.asarray(jbit.pack(_board(h, w, seed=k), word_axis))
    rule = jlife.HIGHLIFE
    want = np.asarray(jfused.fused_bit_step_n(
        packed, 13, k=k, word_axis=word_axis, rule=rule, interpret=True
    ))
    before = _plain_calls()
    got = fused.fused_bit_step_n(
        bitpack.state_from_numpy(packed, "cpu"), 13, k=k, word_axis=word_axis,
        rule=tlife.HIGHLIFE,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {"whole_board": _launches(13, k)}


@pytest.mark.parametrize("blocks", [dict(block_rows=8), dict(block_rows=8, block_cols=128)])
@pytest.mark.parametrize("k", [2, 8])
def test_fused_bit_step_n_forced_tiles_match_jax(blocks, k):
    packed = np.asarray(jbit.pack(_board(512, 256, seed=k), 0))  # (16, 256)
    want = np.asarray(jfused.fused_bit_step_n(packed, 13, k=k, interpret=True, **blocks))
    before = _plain_calls()
    # the port's tile is fixed: it takes force_tiles where JAX takes a block shape
    got = fused.fused_bit_step_n(bitpack.state_from_numpy(packed, "cpu"), 13, k=k,
                                 force_tiles=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {"tiled": _launches(13, k)}


def test_fused_bit_step_n_past_the_gate_takes_the_tiles():
    packed = np.asarray(jbit.pack(_board(1024, 1024, seed=5), 0))  # (32, 1024)
    assert not whole_board.fits(packed.shape, "cpu")
    want = np.asarray(jbit.bit_step_n(packed, 11, 0))
    before = _plain_calls()
    got = fused.fused_bit_step_n(bitpack.state_from_numpy(packed, "cpu"), 11)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {"tiled": _launches(11, 8)}


@pytest.mark.parametrize("size,k", [(64, 8), (128, 4)])
def test_fused_bit_step_n_batch_matches_jax(size, k):
    boards = np.stack([_board(size, size, seed=i) for i in range(3)])
    boards[1] = 0
    packed = np.stack([np.asarray(jbit.pack(b, 0)) for b in boards])
    want = np.asarray(jfused.fused_bit_step_n_batch(packed, 13, k=k, interpret=True))
    before = _plain_calls()
    got = fused.fused_bit_step_n_batch(bitpack.state_from_numpy(packed, "cpu"), 13, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {"batch_board": _launches(13, k)}


def test_fused_bit_step_n_batch_past_the_gate_takes_the_tiles():
    boards = np.stack([_board(1024, 1024, seed=i) for i in range(2)])
    packed = np.stack([np.asarray(jbit.pack(b, 0)) for b in boards])
    want = np.asarray(jfused.fused_bit_step_n_batch(packed, 5, k=4, interpret=True))
    before = _plain_calls()
    got = fused.fused_bit_step_n_batch(bitpack.state_from_numpy(packed, "cpu"), 5, k=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {"tiled": 2 * _launches(5, 4)}


# -- the step functions -------------------------------------------------------


@pytest.mark.parametrize("shape", [(24, 33), (64, 64), (512, 512)])
@pytest.mark.parametrize("rule", ["CONWAY", "SEEDS"])
def test_pallas_step_n_fn_matches_jax(shape, rule):
    board = _board(*shape, seed=shape[1])
    jrule, trule = getattr(jlife, rule), getattr(tlife, rule)
    want = np.asarray(jps.pallas_step_n_fn(jrule, interpret=True)(board, 5))
    before = _plain_calls()
    got = pallas_stencil.pallas_step_n_fn(trule)(torch.from_numpy(board), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    # one K5 launch for all n under the gate; past it one launch of the byte
    # tiles for up to 32 turns, where the JAX package takes its roll stencil
    assert _delta(before) == {_byte_kernel(shape): 1}


def test_pallas_step_n_fn_hands_boards_past_its_gate_to_the_fallback():
    seen = []

    def fallback(board, n):
        seen.append((tuple(board.shape), n))
        return board

    step = pallas_stencil.pallas_step_n_fn(fallback=fallback)
    past = (int(byte_board.MAX_CELLS ** 0.5) + 32,) * 2
    assert not byte_board.fits(past, "cpu")
    board = torch.from_numpy(_board(*past, seed=1))
    assert step(board, 7) is board and seen == [(past, 7)]
    step(torch.from_numpy(_board(128, 128, seed=1)), 7)
    assert len(seen) == 1


@pytest.mark.parametrize("h,w,word_axis", [(64, 64, 0), (40, 64, 1), (1024, 1024, 0)])
def test_pallas_bit_step_n_fn_matches_jax(h, w, word_axis):
    board = _board(h, w, seed=h)
    rule = jlife.HIGHLIFE
    want = np.asarray(jps.pallas_bit_step_n_fn(
        word_axis=word_axis, interpret=True, rule=rule
    )(board, 3))
    before = _plain_calls()
    got = pallas_stencil.pallas_bit_step_n_fn(
        word_axis=word_axis, rule=tlife.HIGHLIFE
    )(torch.from_numpy(board), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # K1 under its gate, the tiled kernel past it (1024^2)
    assert _delta(before) == ({"tiled": 1} if h == 1024 else {"whole_board": 1})


@pytest.mark.parametrize("h,w,word_axis", [(512, 256, 0), (256, 4096, 1)])
def test_tiled_bit_step_n_fn_matches_jax(h, w, word_axis):
    packed = np.asarray(jbit.pack(_board(h, w, seed=7), word_axis))
    rule = jlife.DAY_AND_NIGHT
    want = np.asarray(jtiled.tiled_bit_step_n_fn(
        interpret=True, rule=rule, word_axis=word_axis
    )(packed, 3))
    got = tiled.tiled_bit_step_n_fn(rule=tlife.DAY_AND_NIGHT, word_axis=word_axis)(
        bitpack.state_from_numpy(packed, "cpu"), 3
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,word_axis", [(64, 96, 0), (40, 64, 1)])
def test_packed_step_n_fn_matches_jax(h, w, word_axis):
    board = _board(h, w, seed=w)
    want = np.asarray(jbit.packed_step_n_fn(word_axis, rule=jlife.SEEDS)(board, 6))
    before = _plain_calls()
    got = bitpack.packed_step_n_fn(word_axis, rule=tlife.SEEDS)(torch.from_numpy(board), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _delta(before) == {}  # torch ops, no kernel: the JAX package leaves it to XLA
    got = bitpack.packed_step_n_fn(word_axis, rule=tlife.SEEDS, device="cpu")(board, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(64, 64), (40, 64), (24, 33)])
def test_auto_step_n_fn_matches_jax(shape, monkeypatch):
    jfn = jauto.auto_step_n_fn(jlife.CONWAY, shape)
    tfn = auto.auto_step_n_fn(tlife.CONWAY, shape, "cpu")
    if shape == (24, 33):
        assert jfn is None and tfn is None
        return
    board = _board(*shape, seed=3)
    np.testing.assert_array_equal(tfn(torch.from_numpy(board), 9).numpy(),
                                  np.asarray(jfn(board, 9)))
    # off the card the torch bitboard step, on it the kernels' step
    assert tfn.__qualname__.startswith("packed_step_n_fn.")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    on_card = auto.auto_step_n_fn(tlife.CONWAY, shape)
    assert on_card.__qualname__.startswith("pallas_bit_step_n_fn.")
    np.testing.assert_array_equal(on_card(torch.from_numpy(board), 9).numpy(),
                                  np.asarray(jfn(board, 9)))


# -- the engine's override ----------------------------------------------------


def _events(events):
    return [(type(e).__name__, e.completed_turns,
             (e.cell.x, e.cell.y) if hasattr(e, "cell") else None) for e in events]


def _cells(cells):
    return sorted((c.x, c.y) for c in cells)


@pytest.mark.parametrize("how", ["config", "run"])
@pytest.mark.parametrize("emit_flips", [False, True])
def test_engine_with_a_step_function_matches_jax(how, emit_flips):
    """The same step function in both engines, handed over in the config or
    to run(): the same events, final world and alive cells."""
    size, turns = (64, 20) if emit_flips else (512, 37)
    board = _board(size, size, seed=turns)
    jfn = jfused.fused_step_n
    tfn = fused.fused_step_n
    jcfg, tcfg, jrun, trun = {}, {}, {}, {}
    if how == "config":
        jcfg["step_n_fn"], tcfg["step_n_fn"] = jfn, tfn
    else:
        jrun["step_n_fn"], trun["step_n_fn"] = jfn, tfn
    jev, tev = [], []
    want = jengine.Engine(jengine.EngineConfig(**jcfg)).run(
        JParams(turns=turns, image_width=size, image_height=size), board,
        emit=jev.append, emit_flips=emit_flips, **jrun,
    )
    before = _plain_calls()
    engine = Engine(EngineConfig(device="cpu", **tcfg))
    got = engine.run(Params(turns=turns, image_width=size, image_height=size), board,
                     emit=tev.append, emit_flips=emit_flips, **trun)
    assert isinstance(engine._plane, plane.BytePlane)
    assert set(_delta(before)) == {_byte_kernel((size, size))}
    assert got.turns_completed == want.turns_completed == turns
    np.testing.assert_array_equal(got.world, np.asarray(want.world))
    assert _cells(got.alive) == _cells(want.alive)
    assert _events(tev) == _events(jev)
    assert bool(tev) == emit_flips  # only per-cell flips emit from the engine


def _label(p, fns):
    """What a chosen plane is, comparably across the packages."""
    for name, obj in fns.items():
        if p is obj:
            return name
    step = getattr(p, "_step_n_fn", getattr(p, "_step_n", None))
    for name, obj in fns.items():
        if step is obj:
            return "byte:" + name
    return type(p).__name__


@pytest.mark.parametrize("emit_flips", [False, True])
def test_choose_plane_precedence_matches_jax(emit_flips):
    """explicit plane > explicit step function > config plane > config
    step function > auto > byte stencil, in both engines."""

    def run_fn(board, n):
        return board

    def cfg_fn(board, n):
        return board

    run_plane, cfg_plane = object(), object()
    fns = {"run_fn": run_fn, "cfg_fn": cfg_fn, "run_plane": run_plane, "cfg_plane": cfg_plane}
    for explicit_fn in (None, run_fn):
        for explicit_plane in (None, run_plane):
            for config_fn in (None, cfg_fn):
                for config_plane in (None, cfg_plane):
                    cfg = dict(step_n_fn=config_fn, plane=config_plane)
                    args = ((64, 64), explicit_fn, explicit_plane, emit_flips)
                    want = _label(jengine.Engine(jengine.EngineConfig(**cfg))
                                  ._choose_plane(*args), fns)
                    got = _label(Engine(EngineConfig(device="cpu", **cfg))
                                 ._choose_plane(*args), fns)
                    assert got == want, (explicit_fn, explicit_plane, config_fn,
                                         config_plane, emit_flips)
    # nothing given: the fused bitboard plane, or bytes under per-cell flips
    got = _label(Engine(EngineConfig(device="cpu"))._choose_plane(
        (64, 64), None, None, emit_flips), fns)
    assert got == ("BytePlane" if emit_flips else "FusedBitPlane")


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "numpy"])
def test_a_step_function_that_changes_the_board_raises(bad):
    def step(board, n):
        out = fused.fused_step_n(board, n)
        return {
            "dtype": lambda: out.to(torch.int32),
            "shape": lambda: out[:-1],
            "device": lambda: out.to("meta"),
            "numpy": lambda: out.numpy(),
        }[bad]()

    engine = Engine(EngineConfig(device="cpu", step_n_fn=step))
    with pytest.raises(TypeError, match="the step function returned"):
        engine.run(Params(turns=3, image_width=64, image_height=64), _board(64, 64, seed=0))


# -- golden sessions through the step functions --------------------------------


def _drain(events):
    out = []
    while True:
        ev = events.get_nowait()
        if ev is CLOSED:
            return out
        out.append(ev)


@pytest.mark.parametrize("size", [16, 64, 512])
@pytest.mark.parametrize("turns", [0, 1, 100])
@pytest.mark.parametrize("step", ["fused_step_n", "pallas_step_n_fn"])
def test_golden_sessions_through_a_step_function(size, turns, step, tmp_path):
    step_n_fn = fused.fused_step_n if step == "fused_step_n" else \
        pallas_stencil.pallas_step_n_fn(tlife.CONWAY)
    params = Params(turns=turns, image_width=size, image_height=size)
    events = queue.Queue()
    before = _plain_calls()
    run(params, events, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
        tick_seconds=3600, engine_config=EngineConfig(step_n_fn=step_n_fn, device="cpu"))
    name = f"{size}x{size}x{turns}.pgm"
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()
    assert _drain(events)[-1].completed_turns == turns
    # K5 under its gate, K6 past it
    assert set(_delta(before)) == ({_byte_kernel((size, size))} if turns else set())


def test_per_turn_counts_through_fused_step_n_match_golden_csv():
    want = read_alive_counts(REPO_ROOT / "check" / "alive" / "64x64.csv")
    seen = {}

    def hook(engine, state, turn):
        seen[turn] = engine.retrieve(include_world=False).alive_count

    engine = Engine(EngineConfig(max_chunk=1, chunk_hook=hook, device="cpu",
                                 step_n_fn=fused.fused_step_n))
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    before = byte_board.plain_calls
    engine.run(Params(turns=10_000, image_width=64, image_height=64), board)
    assert [seen[t] for t in range(1, 10_001)] == [want[t] for t in range(1, 10_001)]
    assert byte_board.plain_calls - before == 10_000  # one K5 launch per turn
