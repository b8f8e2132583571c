"""The PyTorch port's byte kernels' modules, ops/byte_board.py (K5) and
ops/byte_tiled.py (K6), against the JAX package's Pallas kernels, run in
interpret mode on the CPU as the JAX package's own tests run them.

On the CPU each wrapper takes its kernel's plain torch version; the
kernels themselves are held against those plain versions on the card by
tests/test_torch_cuda.py (skipped here) and by chip_smoke.py.
Game of Life is integer-exact: equality, tolerance none.
"""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.models import life as jlife
from gol_distributed_final_tpu.ops import fused as jfused
from gol_distributed_final_tpu.ops import pallas_stencil as jps
from gol_distributed_final_tpu.ops import stencil as jstencil
from gol_distributed_final_tpu_torch.models import life as tlife
from gol_distributed_final_tpu_torch.ops import bitpack, byte_board, byte_tiled
from gol_distributed_final_tpu_torch.ops.fused import can_tile_byte

RULES = ["CONWAY", "HIGHLIFE", "SEEDS", "DAY_AND_NIGHT"]


def _board(h, w, seed, density=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < density, 255, 0).astype(np.uint8)


def _rules(name):
    return getattr(jlife, name), getattr(tlife, name)


# -- the whole-board byte kernel (K5) -----------------------------------------


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", [(16, 16), (24, 33), (64, 64)])
@pytest.mark.parametrize("n", [1, 5])
def test_byte_board_matches_pallas(rule, shape, n):
    jrule, trule = _rules(rule)
    board = _board(*shape, seed=shape[0] * 10 + n)
    want = np.asarray(jax.jit(jps.byte_pallas_call(
        n, jrule.birth_mask, jrule.survive_mask, True
    ))(board))
    state = torch.from_numpy(board.copy())
    before = (byte_board.launches, byte_board.plain_calls)
    got = byte_board.step_n(state, n, trule.birth_mask, trule.survive_mask)
    np.testing.assert_array_equal(got.numpy(), want)
    # a CPU tensor takes the plain version: no launch is counted
    assert (byte_board.launches, byte_board.plain_calls) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(state.numpy(), board)  # input untouched


def test_byte_board_reads_any_nonzero_byte_as_alive():
    """The Pallas kernel tests ``b != 0``; so does the port, and both
    write 0 and 255 only."""
    board = np.random.default_rng(4).integers(0, 256, (24, 33)).astype(np.uint8)
    board[board < 160] = 0
    want = np.asarray(jax.jit(jps.byte_pallas_call(
        3, jlife.CONWAY.birth_mask, jlife.CONWAY.survive_mask, True
    ))(board))
    got = byte_board.step_n(torch.from_numpy(board), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 255}


def test_byte_board_zero_turns_copies_without_a_launch():
    state = torch.from_numpy(_board(16, 16, seed=1))
    before = (byte_board.launches, byte_board.plain_calls)
    out = byte_board.step_n(state, 0)
    assert torch.equal(out, state) and out.data_ptr() != state.data_ptr()
    assert (byte_board.launches, byte_board.plain_calls) == before
    with pytest.raises(ValueError, match=">= 0"):
        byte_board.step_n(state, -1)


def test_byte_board_gate_is_two_copies_in_the_cards_shared_memory():
    assert byte_board.smem_bytes((256, 256)) == 131_072
    assert byte_board.fits((256, 256), "cpu")
    assert byte_board.fits((340, 340), "cpu")  # 231,200 B: the largest square
    assert not byte_board.fits((341, 341), "cpu")
    assert not byte_board.fits((512, 512), "cpu")  # JAX's gate admits 512^2
    assert jps.fits_vmem((512, 512), 4)
    assert not byte_board.fits((2, 16, 16), "cpu")  # a batch is no board


# -- the byte tiles (K6) ------------------------------------------------------


@pytest.mark.parametrize("rule", ["CONWAY", "DAY_AND_NIGHT"])
@pytest.mark.parametrize("shape", [(64, 128), (96, 256)])
@pytest.mark.parametrize("turns", [1, 8, 32])
def test_byte_tiles_match_pallas(rule, shape, turns):
    """One launch of ``turns`` turns. At (64, 128) with 32 turns the
    window (96 x 192) is larger than the board, so its rows and columns
    wrap more than once."""
    jrule, trule = _rules(rule)
    board = _board(*shape, seed=turns + shape[0])
    want = np.asarray(jax.jit(jfused.byte_tiled_pallas_call(
        turns, shape, jrule.birth_mask, jrule.survive_mask, True
    ))(board))
    state = torch.from_numpy(board.copy())
    before = (byte_tiled.launches, byte_tiled.plain_calls)
    got = byte_tiled.step_n(
        state, turns, trule.birth_mask, trule.survive_mask, turns_per_launch=turns
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert (byte_tiled.launches, byte_tiled.plain_calls) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(
        byte_tiled.launch_plain(state, turns, trule.birth_mask, trule.survive_mask).numpy(),
        want,
    )
    np.testing.assert_array_equal(state.numpy(), board)  # input untouched


@pytest.mark.parametrize("turns", [0, 33])
def test_byte_tiles_refuse_turns_past_the_halo(turns):
    shape = (64, 128)
    with pytest.raises(ValueError, match="1..32 fused turns"):
        jfused.byte_tiled_pallas_call(turns, shape, 8, 12, True)
    state = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match="1..32 turns"):
        byte_tiled.launch_plain(state, turns)
    with pytest.raises(ValueError, match="1..32 turns"):
        byte_tiled.step_n(state, 40, turns_per_launch=turns)


@pytest.mark.parametrize("shape,turns_per_launch", [((5, 7), 32), ((45, 300), 3),
                                                    ((300, 45), 8), ((1, 1), 4)])
def test_byte_tiles_on_ragged_and_tiny_boards_match_jax_stencil(shape, turns_per_launch):
    """Boards that are no multiple of the tile, or smaller than one
    window: n = 13 turns in launches of k equal the JAX package's roll
    stencil on the whole torus."""
    rule = jlife.HIGHLIFE
    board = _board(*shape, seed=sum(shape))
    want = np.asarray(jstencil.step_n(
        board, 13, birth_mask=rule.birth_mask, survive_mask=rule.survive_mask
    ))
    got = byte_tiled.step_n(torch.from_numpy(board), 13, rule.birth_mask,
                            rule.survive_mask, turns_per_launch=turns_per_launch)
    np.testing.assert_array_equal(got.numpy(), want)


def test_byte_tiles_take_every_shape_the_jax_predicate_takes():
    taken = 0
    for h in range(32, 1025, 32):
        for w in range(128, 4097, 128):
            if jfused.can_tile_byte((h, w)):
                assert can_tile_byte((h, w)), (h, w)
                taken += 1
    assert taken > 500 and jfused.can_tile_byte((512, 512)) and can_tile_byte((512, 512))
    # no alignment and no width limit here; only the launch grid's rows
    assert can_tile_byte((24, 33)) and can_tile_byte((1, 1)) and can_tile_byte((64, 65536))
    assert can_tile_byte((65_535 * 32, 1))
    assert not can_tile_byte((65_535 * 32 + 1, 1))
    assert not can_tile_byte((0, 5)) and not can_tile_byte((2, 16, 16))


def test_byte_tiled_constants_match_the_kernel_source():
    src = (pathlib.Path(byte_tiled.__file__).parents[1] / "csrc" / "byte_tiled.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kTileR|kTileC|kMaxTurns|kMaxGridY) = (\d+);", src
    )}
    assert (consts["kTileR"], consts["kTileC"]) == byte_tiled.TILE
    assert consts["kMaxTurns"] == byte_tiled.MAX_TURNS
    assert consts["kMaxGridY"] == byte_tiled.MAX_GRID_ROWS


def test_byte_wrappers_refuse_other_devices():
    meta = torch.zeros((16, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no whole-board byte kernel"):
        byte_board.step_n(meta, 1)
    with pytest.raises(ValueError, match="no byte-tile kernel"):
        byte_tiled.step_n(meta, 1)


# -- the bound's operation count ----------------------------------------------


@pytest.mark.parametrize("rulestring,per_word", [
    ("B3/S23", 12), ("B36/S23", 12), ("B2/S", 12), ("B3678/S34678", 13),
    ("B3/S2", 11),  # the same T set dead or alive: a smaller select
    ("B/S", 0),  # the next board is empty
])
def test_byte_ops_per_cell(rulestring, per_word):
    """The bitboard form's count per cell: per_word / 32 a turn, plus one
    pack and one unpack a launch."""
    rule = tlife.LifeRule.from_rulestring(rulestring)
    assert bitpack.ops_per_word(rule.birth_mask, rule.survive_mask) == per_word
    for turns, want in ((1, per_word / 32 + 2), (8, per_word / 4 + 2),
                        (100, per_word * 3.125 + 2)):
        got = bitpack.byte_ops_per_cell(rule.birth_mask, rule.survive_mask, turns)
        assert got == (want if per_word else 0), turns
