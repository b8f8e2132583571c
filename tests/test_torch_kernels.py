"""The PyTorch port's kernel modules (ops/whole_board.py, ops/tiled.py) and
plane routing (ops/auto.py) against the JAX package's Pallas kernels, run
in interpret mode on the CPU as the JAX package's own tests run them.

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
from gol_distributed_final_tpu.ops import auto as jauto
from gol_distributed_final_tpu.ops import bitpack as jbit
from gol_distributed_final_tpu.ops import pallas_stencil, pallas_tiled
from gol_distributed_final_tpu.ops.fused import _fused_bit_counted_compiled
from gol_distributed_final_tpu_torch.models import life as tlife
from gol_distributed_final_tpu_torch.ops import auto as tauto
from gol_distributed_final_tpu_torch.ops import bitpack as tbit
from gol_distributed_final_tpu_torch.ops import tiled, whole_board


def _board(h, w, seed, density=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < density, 255, 0).astype(np.uint8)


# -- the whole-board kernel (K1) ----------------------------------------------


@pytest.mark.parametrize("rule", ["CONWAY", "HIGHLIFE"])
@pytest.mark.parametrize("h,w,word_axis", [(64, 96, 0), (48, 64, 1)])
@pytest.mark.parametrize("n", [1, 5])
def test_whole_board_counted_matches_pallas(rule, h, w, word_axis, n):
    jrule, trule = getattr(jlife, rule), getattr(tlife, rule)
    packed = np.asarray(jbit.pack(_board(h, w, seed=h * n), word_axis))
    want = np.asarray(jax.jit(pallas_stencil.bit_pallas_call(
        n, word_axis, True, jrule.birth_mask, jrule.survive_mask
    ))(packed))
    _, want_counts = _fused_bit_counted_compiled(
        n, word_axis, True, jrule.birth_mask, jrule.survive_mask
    )(packed)
    state = tbit.state_from_numpy(packed, "cpu")
    before = (whole_board.launches, whole_board.plain_calls)
    got, counts = whole_board.step_n(
        state, n, word_axis, trule.birth_mask, trule.survive_mask, counted=True
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert counts.dtype == torch.int32
    # a CPU tensor takes the plain version: no launch is counted
    assert (whole_board.launches, whole_board.plain_calls) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(state.numpy(), packed)  # input untouched


def test_whole_board_gate_is_the_cards_shared_memory():
    assert whole_board.smem_limit("cpu") == whole_board.H100_SMEM_OPTIN == 232_448
    assert whole_board.smem_bytes((16, 512)) == 65_536
    assert whole_board.fits((16, 512), "cpu")  # 512^2 board
    assert whole_board.fits((29, 1000), "cpu")  # 928 x 1000: 232,000 B
    assert not whole_board.fits((32, 1024), "cpu")  # 1024^2 board: 262,144 B


# -- the tiled kernel (K3 / K4) -----------------------------------------------


def _packed_16x256(word_axis, seed):
    """A packed (16, 256) board in either packing: one ragged tile of
    TILE, its window wider than the board on both axes."""
    board = _board(512, 256, seed) if word_axis == 0 else _board(16, 8192, seed)
    packed = np.asarray(jbit.pack(board, word_axis))
    assert packed.shape == (16, 256)
    return packed


@pytest.mark.parametrize("word_axis", [0, 1])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("rule", ["CONWAY", "HIGHLIFE"])
def test_tiled_matches_pallas_rows_mode(k, rule, word_axis):
    """One launch of the plain version (a one-word halo on the packed
    axis, k words on the other) equals the rows-mode Pallas kernel."""
    jrule, trule = getattr(jlife, rule), getattr(tlife, rule)
    packed = _packed_16x256(word_axis, seed=k)
    want = np.asarray(jax.jit(pallas_tiled.tiled_pallas_call(
        k, (16, 256), True, jrule.birth_mask, jrule.survive_mask, word_axis=word_axis
    ))(packed))
    got = tiled.step_n(
        tbit.state_from_numpy(packed, "cpu"), k, word_axis,
        trule.birth_mask, trule.survive_mask, turns_per_launch=k,
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("word_axis", [0, 1])
@pytest.mark.parametrize("k", [2, 8])
def test_tiled_matches_pallas_grid2d_mode(k, word_axis):
    shape = (16, 256)
    mode, _, _ = pallas_tiled._plan(*shape, 8, 128)
    assert mode == "grid2d"
    packed = _packed_16x256(word_axis, seed=10 + k)
    want = np.asarray(jax.jit(pallas_tiled.tiled_pallas_call(
        k, shape, True, block_rows=8, block_cols=128, word_axis=word_axis
    ))(packed))
    got = tiled.step_n(tbit.state_from_numpy(packed, "cpu"), k, word_axis,
                       turns_per_launch=k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("word_axis,h,w,packed_shape", [
    (0, 1280, 160, (40, 160)), (1, 40, 5120, (40, 160)),
    (0, 160, 77, (5, 77)), (1, 77, 160, (77, 5)),
])
@pytest.mark.parametrize("turns_per_launch", [3, 8])
def test_tiled_n_past_one_launch_matches_jax_bit_step_n(word_axis, h, w, packed_shape,
                                                        turns_per_launch):
    """n = 13 turns in launches of k (the last takes the rest) equal the
    JAX package's whole-torus bit_step_n. 40 x 160 words are 2 x 2 tiles
    of TILE, the last row and column of them ragged; 5 x 77 and 77 x 5 are
    smaller than a window on the packed axis, the other, or both."""
    assert tbit.packed_shape(h, w, word_axis) == packed_shape
    assert tiled.TILE == (32, 128)
    rule = jlife.HIGHLIFE
    packed = np.asarray(jbit.pack(_board(h, w, seed=3), word_axis))
    want = np.asarray(
        jbit.bit_step_n(packed, 13, word_axis, rule.birth_mask, rule.survive_mask)
    )
    before = tiled.plain_calls
    got = tiled.step_n(
        tbit.state_from_numpy(packed, "cpu"), 13, word_axis,
        rule.birth_mask, rule.survive_mask,
        turns_per_launch=turns_per_launch,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert tiled.plain_calls == before + 1


def test_tiled_constants_match_the_kernel_source():
    """The plain version tiles the board as the kernel does: TILE and
    MAX_TURNS mirror the compile-time constants of csrc/tiled.cu."""
    src = (pathlib.Path(tiled.__file__).parents[1] / "csrc" / "tiled.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kTileR|kTileC|kMaxTurns) = (\d+);", src
    )}
    assert (consts["kTileR"], consts["kTileC"]) == tiled.TILE
    assert consts["kMaxTurns"] == tiled.MAX_TURNS


def test_compiled_rules_match_the_kernel_source():
    """ops/bitpack.py::COMPILED_RULES mirrors the rule instantiations of
    csrc/bit_step.cuh, and every rule models/life.py names is one of them."""
    src = (pathlib.Path(tiled.__file__).parents[1] / "csrc" / "bit_step.cuh").read_text()
    block = re.search(r"#define GOL_COMPILED_RULES\(X\)(.*?)\n\n", src, re.S).group(1)
    triples = [tuple(int(v) for v in m)
               for m in re.findall(r"X\((\d+)u, (\d+)u, (\d+)u\)", block)]
    assert len(triples) == len(set(triples)) == 4
    assert set(triples) == set(tbit.COMPILED_RULES.values())
    named = [v for v in vars(tlife).values() if isinstance(v, tlife.LifeRule)]
    assert {r.name for r in named} == set(tbit.COMPILED_RULES)
    for rule in named:
        masks = tbit.rule_masks(rule.birth_mask, rule.survive_mask)
        assert tbit.COMPILED_RULES[rule.name] == masks
        assert tbit.is_compiled_rule(rule.birth_mask, rule.survive_mask)
    other = tlife.LifeRule.from_rulestring("B36/S125")
    assert not tbit.is_compiled_rule(other.birth_mask, other.survive_mask)


def test_tiled_rejects_turns_past_the_halo():
    state = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="1..8 turns"):
        tiled.step_n(state, 9, turns_per_launch=9)


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((4, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no whole-board kernel"):
        whole_board.step_n(meta, 1)
    with pytest.raises(ValueError, match="no tiled kernel"):
        tiled.step_n(meta, 1)


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("size", [16, 64, 512])
def test_auto_plane_picks_the_counterpart_class(size):
    jplane = jauto.auto_plane(jlife.CONWAY, (size, size))
    tplane = tauto.auto_plane(tlife.CONWAY, (size, size), "cpu")
    assert type(jplane).__name__ == type(tplane).__name__
    if tplane is not None:
        assert tplane.word_axis == jplane.word_axis


def test_auto_plane_past_the_gate():
    # past both packages' whole-board gates, under the JAX sparse floor
    shape = (4096, 3584)
    jplane = jauto.auto_plane(jlife.CONWAY, shape)
    tplane = tauto.auto_plane(tlife.CONWAY, shape, "cpu")
    assert type(jplane).__name__ == type(tplane).__name__ == "BitPlane"
    # the port's own gate is the card's shared memory: 1024^2 is past it,
    # though the JAX package's VMEM gate keeps it on the fused plane
    assert type(tauto.auto_plane(tlife.CONWAY, (1024, 1024), "cpu")).__name__ == "BitPlane"
    assert tauto.choose_word_axis((48, 64)) == jauto.choose_word_axis((48, 64)) == 1
    assert tauto.choose_word_axis((16, 16)) is None


def test_bitplane_steps_past_the_gate_on_the_tiled_path():
    from gol_distributed_final_tpu_torch.ops.fused import FusedBitPlane, fold_counts

    board = _board(1024, 64, seed=2)  # packed (32, 64): 16 KiB, fits
    plane = FusedBitPlane(tlife.CONWAY, 0, "cpu")
    state = plane.encode(board)
    before = (whole_board.plain_calls, tiled.plain_calls)
    out, counts = plane.step_n_counted(state, 9)
    assert (whole_board.plain_calls, tiled.plain_calls) == (before[0] + 1, before[1])
    want = np.asarray(jbit.bit_step_n(np.asarray(jbit.pack(board, 0)), 9, 0))
    np.testing.assert_array_equal(out.numpy(), want)
    assert fold_counts(counts) == int(np.count_nonzero(jbit.unpack(want, 0)))

    big = _board(1024, 1024, seed=4)  # packed (32, 1024): past the gate
    plane = FusedBitPlane(tlife.CONWAY, 0, "cpu")
    state = plane.encode(big)
    before = (whole_board.plain_calls, tiled.plain_calls)
    out, counts = plane.step_n_counted(state, 2)
    assert (whole_board.plain_calls, tiled.plain_calls) == (before[0], before[1] + 1)
    want = np.asarray(jbit.bit_step_n(np.asarray(jbit.pack(big, 0)), 2, 0))
    np.testing.assert_array_equal(out.numpy(), want)
    assert fold_counts(counts) == int(jbit.alive_count_packed(want))

