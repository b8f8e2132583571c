"""The port's per-turn alive history against the JAX package's: the
bitboard's ``ops/bitpack.py::alive_history`` (the whole-board kernel's
history mode under its gate, the tiled kernel a turn past it; their plain
versions here), the byte stencil's ``ops/stencil.py::alive_history``, and
``LifeRule``'s step API; then the three golden sweeps, every turn
1..10000 of ``check/alive/*.csv``, through the port.

Inputs come from numpy seeds and go through both packages. Game of Life
is integer-exact: equality, tolerance none.
"""

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.models import life as jlife
from gol_distributed_final_tpu.ops import bitpack as jbit
from gol_distributed_final_tpu.ops import stencil as jstencil
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.models import life as tlife
from gol_distributed_final_tpu_torch.ops import bitpack, stencil, tiled, whole_board

from helpers import REPO_ROOT, read_alive_counts

# Conway, HighLife and a rule no kernel compiles in (the run-time rule)
RULES = ["B3/S23", "B36/S23", "B36/S125"]


def _board(h, w, seed, density=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < density, 255, 0).astype(np.uint8)


def _masks(rulestring):
    rule = tlife.LifeRule.from_rulestring(rulestring)
    return rule.birth_mask, rule.survive_mask


@pytest.mark.parametrize("rulestring", RULES)
@pytest.mark.parametrize("word_axis", [0, 1])
@pytest.mark.parametrize("h,w", [(64, 64), (96, 128)])
def test_bitpack_alive_history_matches_jax(rulestring, word_axis, h, w):
    birth, survive = _masks(rulestring)
    board = _board(h, w, seed=h * 7 + w + word_axis)
    want = np.asarray(jbit.alive_history(jbit.pack(board, word_axis), 300, word_axis,
                                         birth, survive))
    whole_board.reset_counts()
    got = bitpack.alive_history(bitpack.pack(board, word_axis), 300, word_axis, birth, survive)
    assert got.dtype == np.int32 and got.shape == (300,)
    np.testing.assert_array_equal(got, want)
    # under the gate: the history mode's plain version, counted apart
    assert (whole_board.history_plain_calls, whole_board.plain_calls) == (1, 0)


def test_history_is_turns_one_to_n():
    """Turn t's count is the board's after t steps, not t - 1; n = 0 is an
    empty history; a negative n raises."""
    board = _board(64, 64, seed=5)
    packed = bitpack.pack(board, 0)
    counts = whole_board.history(packed, 5)
    assert counts.dtype == torch.int32 and counts.device == packed.device
    for t in range(1, 6):
        want = int(bitpack.popcount(bitpack.bit_step_n(packed, t)).sum())
        assert int(counts[t - 1]) == want
    assert whole_board.history(packed, 0).shape == (0,)
    assert bitpack.alive_history(packed, 0).shape == (0,)
    assert stencil.alive_history(torch.from_numpy(board), 0).shape == (0,)
    with pytest.raises(ValueError, match=">= 0"):
        bitpack.alive_history(packed, -1)


def test_alive_history_past_the_gate_runs_the_tiled_route():
    """1024^2 packs to 32768 words, past the whole-board gate: one tiled
    turn a turn (its plain version on the CPU), equal to the JAX
    package's history."""
    board = _board(1024, 1024, seed=11, density=0.3)
    packed = bitpack.pack(board, 0)
    assert not whole_board.fits(tuple(packed.shape), packed.device)
    whole_board.reset_counts()
    tiled.reset_counts()
    got = bitpack.alive_history(packed, 4)
    assert (tiled.plain_calls, whole_board.history_plain_calls) == (4, 0)
    np.testing.assert_array_equal(got, np.asarray(jbit.alive_history(jbit.pack(board, 0), 4)))


@pytest.mark.parametrize("rulestring", RULES[:2])
@pytest.mark.parametrize("h,w", [(16, 16), (24, 24), (40, 24)])
def test_stencil_alive_history_matches_jax(rulestring, h, w):
    birth, survive = _masks(rulestring)
    board = _board(h, w, seed=h + 3 * w)
    want = np.asarray(jstencil.alive_history(board, 300, birth_mask=birth,
                                             survive_mask=survive))
    got = stencil.alive_history(torch.from_numpy(board), 300, birth_mask=birth,
                                survive_mask=survive)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["CONWAY", "HIGHLIFE", "SEEDS", "DAY_AND_NIGHT"])
@pytest.mark.parametrize("h,w", [(64, 64), (96, 128), (40, 24)])
def test_life_rule_step_api_matches_jax(name, h, w):
    jrule, trule = getattr(jlife, name), getattr(tlife, name)
    board = _board(h, w, seed=h * w)
    tboard = torch.from_numpy(board)
    np.testing.assert_array_equal(trule.step(tboard).numpy(), np.asarray(jrule.step(board)))
    np.testing.assert_array_equal(trule.step_n(tboard, 7).numpy(),
                                  np.asarray(jrule.step_n(board, 7)))
    np.testing.assert_array_equal(trule.step_fn()(tboard).numpy(),
                                  np.asarray(jrule.step_fn()(board)))


def test_life_rule_step_api_on_a_run_time_rule():
    rule = tlife.LifeRule.from_rulestring("B36/S125")
    jrule = jlife.LifeRule.from_rulestring("B36/S125")
    board = _board(40, 24, seed=2)
    np.testing.assert_array_equal(rule.step_n(torch.from_numpy(board), 9).numpy(),
                                  np.asarray(jrule.step_n(board, 9)))


def test_models_import_no_op_module():
    """``LifeRule``'s step API imports ops.stencil inside its methods:
    the models module itself imports nothing of ops."""
    import ast

    source = (REPO_ROOT / "gol_distributed_final_tpu_torch" / "models" / "life.py").read_text()
    relative = [n.module or "" for n in ast.parse(source).body
                if isinstance(n, ast.ImportFrom) and n.level > 0]
    assert not [m for m in relative if m.startswith("ops")]


@pytest.mark.parametrize("size", [16, 64, 512])
def test_full_10k_sweep_through_the_port(size):
    """Every per-turn alive count for turns 1..10000 equals the golden
    CSV, as tests/test_alive.py sweeps the JAX package: 32-divisible
    boards through ``bitpack.alive_history`` (the history mode's plain
    version), 16^2 through the byte stencil's."""
    counts = read_alive_counts(REPO_ROOT / "check" / "alive" / f"{size}x{size}.csv")
    turns = max(counts)
    assert turns == 10_000
    board = read_pgm(REPO_ROOT / "images" / f"{size}x{size}.pgm")
    if size % 32 == 0:
        got = bitpack.alive_history(bitpack.pack(board, 0), turns)
    else:
        got = stencil.alive_history(torch.from_numpy(board.copy()), turns)
    want = np.array([counts[t] for t in range(1, turns + 1)], np.int32)
    mismatch = np.nonzero(got != want)[0]
    assert mismatch.size == 0, (
        f"first mismatch at turn {mismatch[0] + 1}: got {got[mismatch[0]]}, "
        f"want {want[mismatch[0]]}"
    )
