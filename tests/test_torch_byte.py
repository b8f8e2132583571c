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
from gol_distributed_final_tpu_torch.ops import bitpack, byte_board, byte_tiled, whole_board
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
    """The gate: the form's two copies in a block's shared memory (bytes: the
    board twice; bits: a band of packed lines with its halo twice) and at
    most ``MAX_CELLS`` cells, the measured size where the byte tiles
    overtake."""
    limit = whole_board.H100_SMEM_OPTIN
    # the byte form: 2 * H * W bytes in one block
    assert byte_board.smem_bytes((24, 33)) == 2 * 24 * 33
    assert byte_board.fits((24, 33), "cpu") and byte_board.fits((16, 16), "cpu")
    # its own size limit: a 100^2 board is under MAX_CELLS and still the tiles'
    assert 24 * 33 <= byte_board.MAX_BYTE_FORM_CELLS < 100 * 100 <= byte_board.MAX_CELLS
    assert byte_board.form((100, 100)) == "bytes" and not byte_board.fits((100, 100), "cpu")
    assert byte_board.fits((96, 100), "cpu")  # the same cells in the bit form
    # 340^2 is the largest byte square a block holds, and past the size limit
    assert byte_board.smem_bytes((340, 340)) == 231_200 <= limit
    assert byte_board.smem_bytes((341, 341)) > limit
    assert not byte_board.fits((340, 340), "cpu") and 340 * 340 > byte_board.MAX_CELLS
    # the bit form: 64^2 is 128 words on one block, no halo
    assert byte_board.smem_bytes((64, 64)) == 2 * 4 * 128
    # 256^2 on 8 blocks: 32 lines and 2 * HALO_DEPTH halo lines of 8 words, twice
    depth = byte_board.HALO_DEPTH
    assert byte_board.cluster_size((256, 256)) == 8
    assert byte_board.smem_bytes((256, 256)) == 2 * 4 * (32 + 2 * min(depth, 32)) * 8
    assert byte_board.fits((128, 128), "cpu")
    # the size limit is the named constant, whatever shared memory would hold
    side = int(byte_board.MAX_CELLS ** 0.5) // 32 * 32
    assert byte_board.fits((side, side), "cpu")
    assert not byte_board.fits((side + 32, side + 32), "cpu")
    assert byte_board.smem_bytes((side + 32, side + 32)) <= limit
    assert byte_board.fits((512, 512), "cpu") == (512 * 512 <= byte_board.MAX_CELLS)
    assert jps.fits_vmem((512, 512), 4)  # the JAX package's gate admits 512^2
    assert not byte_board.fits((2, 16, 16), "cpu")  # a batch is no board
    assert not byte_board.fits((0, 32), "cpu")


#: every shape chip_smoke.py gives the whole-board byte kernel, with the form
#: it must pick and the cluster
SMOKE_SHAPES = [
    ((16, 16), "bytes", 1), ((24, 33), "bytes", 1), ((340, 340), "bytes", 1),
    ((64, 64), "bits-cols", 1), ((128, 128), "bits-cols", 1), ((160, 160), "bits-cols", 8),
    ((192, 192), "bits-cols", 8), ((256, 256), "bits-cols", 8), ((100, 100), "bytes", 1),
    ((512, 512), "bits-cols", 8), ((96, 160), "bits-cols", 1), ((64, 48), "bits-rows", 1),
    ((96, 100), "bits-rows", 1), ((512, 500), "bits-rows", 4), ((1024, 1024), "bits-cols", 8),
]


@pytest.mark.parametrize("shape,form,cluster", SMOKE_SHAPES)
def test_byte_board_routes_by_shape(shape, form, cluster):
    """Bits where an axis is a multiple of 32 (columns first), bytes
    otherwise; a cluster from ``MIN_CLUSTER_WORDS`` packed words on, the
    largest of 8, 4, 2 that divides the lines."""
    assert byte_board.form(shape) == form
    assert byte_board.cluster_size(shape) == cluster
    if form == "bytes":
        assert shape[0] % 32 and shape[1] % 32
        assert byte_board.launch_plan(shape) == (form, 1, 0)
        return
    words, lines = byte_board._lines(shape, form)
    # the launch's plan, which the gate reads too
    depth = 0 if cluster == 1 else min(byte_board.HALO_DEPTH, lines // cluster)
    assert byte_board.launch_plan(shape) == (form, cluster, depth)
    assert byte_board.smem_bytes(shape) == 2 * 4 * (lines // cluster + 2 * depth) * words
    assert words * 32 == (shape[0] if form == "bits-rows" else shape[1])
    assert lines % cluster == 0
    assert (cluster > 1) == (words * lines >= byte_board.MIN_CLUSTER_WORDS)
    # every forced cluster needs no more shared memory than one block
    assert byte_board.smem_bytes(shape, form, 1) == 2 * 4 * words * lines
    for c in (2, 4, 8):
        if lines % c == 0 and lines // c >= byte_board.HALO_DEPTH:
            assert byte_board.smem_bytes(shape, form, c) == \
                2 * 4 * (lines // c + 2 * byte_board.HALO_DEPTH) * words


@pytest.mark.parametrize("sizes", [[3], [8, 4, 1], [1] * 5])
def test_byte_board_step_sizes_is_a_ladder_in_one_call(sizes):
    """One plain call per launch it stands in for, the same board as the
    launches one by one, and the input untouched."""
    board = _board(24, 33, seed=len(sizes))
    state = torch.from_numpy(board.copy())
    before = (byte_board.launches, byte_board.plain_calls)
    got = byte_board.step_sizes(state, sizes)
    assert (byte_board.launches, byte_board.plain_calls) == (before[0], before[1] + len(sizes))
    want = np.asarray(jstencil.step_n(board, sum(sizes)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(state.numpy(), board)
    with pytest.raises(ValueError, match=">= 1 turns"):
        byte_board.step_sizes(state, [2, 0])


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
    tallest = byte_tiled.MAX_GRID_ROWS * byte_tiled.TILE[0]  # such a board takes the wide tile
    assert can_tile_byte((tallest, 1)) and byte_tiled.tile_for((tallest, 1)) == byte_tiled.TILE
    assert not can_tile_byte((tallest + 1, 1))
    assert not can_tile_byte((0, 5)) and not can_tile_byte((2, 16, 16))


def _constants(source):
    src = (pathlib.Path(byte_tiled.__file__).parents[1] / "csrc" / source).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_byte_tiled_constants_match_the_kernel_source():
    consts = _constants("byte_tiled.cu")
    assert (consts["kTileR"], consts["kTileC"]) == byte_tiled.TILE
    assert (consts["kSmallTileR"], consts["kSmallTileC"]) == byte_tiled.SMALL_TILE
    assert consts["kMaxTurns"] == byte_tiled.MAX_TURNS
    assert consts["kMaxGridY"] == byte_tiled.MAX_GRID_ROWS
    # whole words wide, and one halo word covers a launch's turns
    assert byte_tiled.TILE[1] % 32 == 0 and byte_tiled.SMALL_TILE[1] % 32 == 0
    assert byte_tiled.MAX_TURNS <= bitpack.WORD


def test_byte_board_constants_match_the_kernel_source():
    """The forms' numbers are the kernel's, and every cluster the plan may
    give is instantiated (8, the portable limit, the largest)."""
    src = (pathlib.Path(byte_board.__file__).parents[1] / "csrc" / "byte_board.cu").read_text()
    forms = re.search(r"enum Form \{ kBitsCols = 0, kBitsRows = 1, kBytes = 2 \};", src)
    assert forms and byte_board.FORMS == ("bits-cols", "bits-rows", "bytes")
    clusters = {int(c) for c in re.findall(r"launch_bits<(\d+)>", src)}
    assert clusters == {1, 2, 4, 8, 16}
    assert byte_board.MAX_CLUSTER == 8


def test_byte_tiles_pick_the_tile_by_the_boards_size():
    """The wide tile from ``MIN_BLOCKS`` wide tiles on, the small one under."""
    tr, tc = byte_tiled.TILE
    assert byte_tiled.tile_for((512, 512)) == byte_tiled.SMALL_TILE
    assert byte_tiled.tile_for((4096, 4096)) == byte_tiled.TILE
    for shape in ((tr * 11, tc * 12), (tr * 12, tc * 11), (tr * 132, 1), (1, tc * 132)):
        assert byte_tiled.tile_for(shape) == byte_tiled.TILE, shape
    for shape in ((tr * 131, tc), (tr * 10, tc * 13), (5, 7)):
        assert byte_tiled.tile_for(shape) == byte_tiled.SMALL_TILE, shape


@pytest.mark.parametrize("tile", ["wide", "small"])
@pytest.mark.parametrize("shape", [(64, 256), (96, 320), (45, 300), (300, 45), (5, 7), (1, 1)])
@pytest.mark.parametrize("turns", [1, 8, 32])
def test_byte_tiles_packed_windows_match_jax_stencil(tile, shape, turns):
    """One launch's plain version on either tile (gather the window in
    cells, pack, ``bit_step_n``, unpack) against the JAX package's roll
    stencil on the whole torus: aligned, ragged and tiny boards, whose
    windows wrap more than once."""
    tile = byte_tiled.TILE if tile == "wide" else byte_tiled.SMALL_TILE
    rule = jlife.DAY_AND_NIGHT
    board = _board(*shape, seed=turns + shape[1])
    want = np.asarray(jstencil.step_n(
        board, turns, birth_mask=rule.birth_mask, survive_mask=rule.survive_mask
    ))
    got = byte_tiled.launch_plain(torch.from_numpy(board), turns, rule.birth_mask,
                                  rule.survive_mask, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)
    got = byte_tiled.step_n(torch.from_numpy(board), turns, rule.birth_mask,
                            rule.survive_mask, turns_per_launch=turns, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", ["wide", "small"])
@pytest.mark.parametrize("turns", [8, 32])
def test_byte_tiles_packed_windows_match_pallas(tile, turns):
    """The same against the Pallas kernel in interpret mode, at the shape
    the JAX package's own test runs it."""
    tile = byte_tiled.TILE if tile == "wide" else byte_tiled.SMALL_TILE
    shape = (96, 256)
    board = _board(*shape, seed=turns)
    want = np.asarray(jax.jit(jfused.byte_tiled_pallas_call(
        turns, shape, jlife.CONWAY.birth_mask, jlife.CONWAY.survive_mask, True
    ))(board))
    got = byte_tiled.launch_plain(torch.from_numpy(board), turns, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)


def test_byte_tiles_read_any_nonzero_byte_as_alive():
    board = np.random.default_rng(6).integers(0, 256, (45, 300)).astype(np.uint8)
    board[board < 170] = 0
    want = np.asarray(jstencil.step_n(np.where(board != 0, 255, 0).astype(np.uint8), 5))
    got = byte_tiled.step_n(torch.from_numpy(board), 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 255}


@pytest.mark.parametrize("turns", [1, 8, 31, 32])
def test_one_halo_word_covers_the_turns_of_a_launch(turns):
    """The halo argument. A window of three words a line, cut from a torus
    five words wide: its halo words' outer neighbours are wrong (the cyclic
    roll hands each the other), which spoils one more of their outer bits a
    turn and nothing else, so after up to 32 turns the middle word is still
    the torus's."""
    assert byte_tiled.halo(turns) == (turns, 32)
    rng = np.random.default_rng(turns)
    wide = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(40, 5), dtype=np.int64).astype(np.int32))
    want = bitpack.bit_step_n(wide, turns, 1)[:, 1:4]
    got = bitpack.bit_step_n(wide[:, 1:4].contiguous(), turns, 1)
    assert torch.equal(got[:, 1], want[:, 1])
    wrong = (got ^ want).to(torch.int64) & 0xFFFFFFFF
    if turns < 32:  # the left word spoils from bit 0 up, the right from bit 31 down
        assert int((wrong[:, 0] >> turns).max()) == 0
        assert int((wrong[:, 2] & ((1 << (32 - turns)) - 1)).max()) == 0
    assert int(wrong[:, 0].max()) > 0 and int(wrong[:, 2].max()) > 0  # and they do spoil


def test_one_halo_word_does_not_cover_33_turns():
    """The bound is tight. Under a rule that grows a blob by one cell a turn
    in every direction, a lone cell just left of the window reaches the
    middle word's first bit at turn 33 on the torus; the window, which never
    held it, stays empty."""
    with pytest.raises(ValueError, match=r"1\.\.32 turns"):
        byte_tiled.halo(33)
    grow = dict(birth_mask=0x1FE, survive_mask=0x1FF)  # B12345678/S012345678
    wide = torch.zeros((80, 5), dtype=torch.int32)
    wide[40, 0] = -2**31  # bit 31 of word 0: the cell next to the window
    for turns, reached in ((32, False), (33, True)):
        want = bitpack.bit_step_n(wide, turns, 1, **grow)[:, 2]
        got = bitpack.bit_step_n(wide[:, 1:4].contiguous(), turns, 1, **grow)[:, 1]
        assert not got.any()
        assert bool(want.any()) == reached
        assert torch.equal(got, want) != reached


@pytest.mark.parametrize("sizes", [[8, 4, 1], [32, 8]])
def test_byte_tiled_step_sizes_is_a_ladder_in_one_call(sizes):
    board = _board(45, 300, seed=sum(sizes))
    state = torch.from_numpy(board.copy())
    before = (byte_tiled.launches, byte_tiled.plain_calls)
    got = byte_tiled.step_sizes(state, sizes)
    assert (byte_tiled.launches, byte_tiled.plain_calls) == (before[0], before[1] + len(sizes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jstencil.step_n(board, sum(sizes))))
    np.testing.assert_array_equal(state.numpy(), board)
    with pytest.raises(ValueError, match="1..32 turns"):
        byte_tiled.step_sizes(state, [8, 33])


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
