"""The PyTorch port's batched kernel family on the CPU, against the JAX
package: the batched kernel's plain version against the Pallas K2 run in
interpret mode (counts from the fused counted program), the batch
helpers word for word, and the batched planes against the JAX planes.

Inputs are numpy-seeded; Game of Life is integer-exact, so every
comparison is equality (tolerance 0).
"""

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu_torch.models import CONWAY, HIGHLIFE
from gol_distributed_final_tpu_torch.ops import batch_board, bitpack, whole_board
from gol_distributed_final_tpu_torch.ops.auto import auto_batch_plane
from gol_distributed_final_tpu_torch.ops.batched import BatchBitPlane, BatchBytePlane
from gol_distributed_final_tpu_torch.ops.reduce import alive_count_batch
from gol_distributed_final_tpu_torch.ops.stencil import step_n_batch

from oracle import vector_step

CPU = torch.device("cpu")


def _mixed_batch(b=4, h=64, w=64, seed=0):
    """Universe 0 all dead, universe 1 a lone glider, the rest dense
    random (tests/test_sessions.py's mix)."""
    rng = np.random.default_rng(seed)
    boards = np.where(rng.random((b, h, w)) < 0.3, 255, 0).astype(np.uint8)
    if b > 1:
        boards[0] = 0
        boards[1] = 0
        for y, x in ((1, 2), (2, 3), (3, 1), (3, 2), (3, 3)):
            boards[1, y, x] = 255
    return boards


def _oracle(boards, n, rule=CONWAY):
    birth = [c for c in range(9) if rule.birth_mask >> c & 1]
    survive = [c for c in range(9) if rule.survive_mask >> c & 1]
    out = []
    for b in boards:
        for _ in range(n):
            b = vector_step(b, birth, survive)
        out.append(b)
    return np.stack(out)


def _words(arr):
    return np.asarray(arr).view(np.uint32)


# -- (a) the batched kernel's plain version against the Pallas K2 ------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("rule", [CONWAY, HIGHLIFE], ids=lambda r: r.name)
@pytest.mark.parametrize("word_axis", [0, 1])
def test_plain_matches_pallas_k2_in_interpret_mode(word_axis, rule, n, batch):
    from gol_distributed_final_tpu.ops import bitpack as jbit
    from gol_distributed_final_tpu.ops.fused import _fused_batch_counted_compiled
    from gol_distributed_final_tpu.ops.pallas_stencil import _bit_compiled_batch

    boards = _mixed_batch(b=batch, h=32, w=64, seed=10 * n + batch)
    jpacked = jbit.pack_device_batch(boards, word_axis)
    packed = bitpack.pack_batch(boards, word_axis)
    assert np.array_equal(_words(packed.numpy()), _words(jpacked))

    birth, survive = rule.birth_mask, rule.survive_mask
    want = _bit_compiled_batch(n, word_axis, True, birth, survive)(jpacked)
    _, want_counts = _fused_batch_counted_compiled(
        n, word_axis, True, birth, survive, True
    )(jpacked)
    batch_board.reset_counts()
    got, got_counts = batch_board.step_n(packed, n, word_axis, birth, survive)
    assert batch_board.plain_calls == 1 and batch_board.launches == 0
    assert np.array_equal(_words(got.numpy()), _words(want))
    assert got_counts.dtype == torch.int32 and got_counts.shape == (batch, packed.shape[1])
    assert np.array_equal(got_counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(
        bitpack.unpack_batch(got, word_axis).numpy(), _oracle(boards, n, rule)
    )


def test_batch_wrapper_validates_turns_and_counts_flag():
    packed = bitpack.pack_batch(_mixed_batch(b=2, h=32, w=32))
    with pytest.raises(ValueError, match=">= 0"):
        batch_board.step_n(packed, -1)
    out = batch_board.step_n(packed, 3, counted=False)
    assert isinstance(out, torch.Tensor)
    same, counts = batch_board.step_n(packed, 0)
    assert torch.equal(same, packed)
    assert torch.equal(counts.sum(dim=1).long(), torch.tensor(
        bitpack.alive_count_packed_batch(packed)))


def test_batch_gate_is_per_universe():
    """K2 applies K1's shared-memory gate to one universe, whatever B."""
    limit = whole_board.H100_SMEM_OPTIN
    assert batch_board.fits((1000, 4, 128), CPU)  # 1000 x 128^2
    assert batch_board.fits((300, 16, 512), CPU)  # 300 x 512^2
    assert whole_board.smem_bytes((30, 960)) <= limit
    assert batch_board.fits((7, 30, 960), CPU)
    assert not batch_board.fits((2, 32, 1024), CPU)  # 1024^2 is past it


# -- the batch helpers against the JAX package, word for word ----------------


@pytest.mark.parametrize("word_axis", [0, 1])
def test_pack_unpack_step_count_batches_match_jax(word_axis):
    from gol_distributed_final_tpu.ops import bitpack as jbit

    boards = _mixed_batch(b=5, h=64, w=96, seed=3)
    packed = bitpack.pack_batch(boards, word_axis)
    jpacked = jbit.pack_device_batch(boards, word_axis)
    assert np.array_equal(_words(packed.numpy()), _words(jpacked))
    np.testing.assert_array_equal(
        bitpack.unpack_batch(packed, word_axis).numpy(),
        np.asarray(jbit.unpack_device_batch(jpacked, word_axis)),
    )
    out = bitpack.bit_step_n_batch(packed, 9, word_axis, HIGHLIFE.birth_mask,
                                   HIGHLIFE.survive_mask)
    jout = jbit.bit_step_n_batch(jpacked, 9, word_axis, HIGHLIFE.birth_mask,
                                 HIGHLIFE.survive_mask)
    assert np.array_equal(_words(out.numpy()), _words(jout))
    counts = bitpack.alive_count_packed_batch(out)
    assert counts.dtype == np.int64
    assert np.array_equal(counts, jbit.alive_count_packed_batch(jout))


def test_batch_helpers_refuse_a_single_board():
    with pytest.raises(ValueError, match="3 axes"):
        bitpack.pack_batch(np.zeros((32, 32), np.uint8))
    with pytest.raises(ValueError, match="3 axes"):
        bitpack.bit_step_n_batch(torch.zeros((1, 32), dtype=torch.int32), 1)


def test_popcounts_of_bit31_words_are_exact():
    """Every word with bit 31 set: the SWAR popcount and the int64 fold
    see all 32 bits of each."""
    packed = torch.full((2, 3, 5), -1, dtype=torch.int32)
    assert bitpack.alive_count_packed_batch(packed).tolist() == [3 * 5 * 32] * 2
    _, counts = batch_board.step_n(packed, 0)
    assert counts.tolist() == [[5 * 32] * 3] * 2


@pytest.mark.parametrize("rule", [CONWAY, HIGHLIFE], ids=lambda r: r.name)
def test_byte_batch_step_and_counts_match_jax(rule):
    from gol_distributed_final_tpu.ops.reduce import alive_count_batch as jcount
    from gol_distributed_final_tpu.ops.stencil import step_n_batch as jstep

    boards = _mixed_batch(b=4, h=16, w=16, seed=4)
    got = step_n_batch(torch.from_numpy(boards), 11, birth_mask=rule.birth_mask,
                       survive_mask=rule.survive_mask)
    want = jstep(boards, 11, birth_mask=rule.birth_mask, survive_mask=rule.survive_mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert alive_count_batch(got).tolist() == np.asarray(jcount(want)).tolist()
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        step_n_batch(torch.from_numpy(boards[0]), 1)


# -- (b) the batched planes against the JAX planes ---------------------------


def _jax_plane(kind, rule, word_axis=0):
    from gol_distributed_final_tpu.ops import batched as jb

    return jb.BatchBitPlane(rule, word_axis) if kind == "bit" else jb.BatchBytePlane(rule)


@pytest.mark.parametrize(
    "kind,shape,word_axis",
    [("bit", (64, 64), 0), ("bit", (48, 64), 1), ("byte", (16, 16), None)],
)
def test_planes_match_jax_planes(kind, shape, word_axis):
    """encode, step_n, step_n_counts, decode, decode_one, alive_counts,
    take and append give the JAX planes' boards and counts, in order."""
    rule = HIGHLIFE
    boards = _mixed_batch(b=6, h=shape[0], w=shape[1], seed=shape[0] + shape[1])
    mine = (BatchBitPlane(rule, word_axis, "cpu") if kind == "bit"
            else BatchBytePlane(rule, "cpu"))
    theirs = _jax_plane(kind, rule, word_axis or 0)

    state, jstate = mine.encode(boards), theirs.encode(boards)
    state, counts = mine.step_n_counts(state, 6)
    jstate, jcounts = theirs.step_n_counts(jstate, 6)
    assert counts.dtype == np.int64
    assert np.array_equal(counts, jcounts)
    np.testing.assert_array_equal(mine.decode(state), theirs.decode(jstate))
    np.testing.assert_array_equal(mine.decode_one(state, 1), theirs.decode_one(jstate, 1))
    assert np.array_equal(mine.alive_counts(state), theirs.alive_counts(jstate))
    np.testing.assert_array_equal(mine.decode(state), _oracle(boards, 6, rule))

    kept, jkept = mine.take(state, [0, 2, 5]), theirs.take(jstate, [0, 2, 5])
    np.testing.assert_array_equal(mine.decode(kept), theirs.decode(jkept))
    joined = mine.append(kept, mine.encode(boards[3:4]))
    jjoined = theirs.append(jkept, theirs.encode(boards[3:4]))
    np.testing.assert_array_equal(mine.decode(joined), theirs.decode(jjoined))
    assert mine.append(None, kept) is kept
    stepped = mine.step_n(joined, 3)
    np.testing.assert_array_equal(mine.decode(stepped),
                                  theirs.decode(theirs.step_n(jjoined, 3)))
    same, zero_counts = mine.step_n_counts(stepped, 0)
    assert same is stepped and np.array_equal(zero_counts, mine.alive_counts(stepped))


def test_bit_plane_under_the_gate_is_one_counted_batch_call():
    plane = BatchBitPlane(CONWAY, 0, "cpu")
    state = plane.encode(_mixed_batch(b=5, h=32, w=32, seed=5))
    batch_board.reset_counts()
    plane.step_n_counts(state, 8)
    assert batch_board.plain_calls == 1


def test_bit_plane_past_the_gate_steps_each_universe_tiled():
    """A universe past the shared-memory gate (1024^2 packed is 256 KiB in
    two copies) routes by shape to the tiled kernel's wrapper, one
    universe at a time, with torch row counts; equal to the JAX plane."""
    from gol_distributed_final_tpu_torch.ops import tiled

    rule = CONWAY
    rng = np.random.default_rng(6)
    boards = np.where(rng.random((2, 1024, 1024)) < 0.2, 255, 0).astype(np.uint8)
    plane = BatchBitPlane(rule, 0, "cpu")
    state = plane.encode(boards)
    assert not batch_board.fits(tuple(state.shape), state.device)
    batch_board.reset_counts()
    tiled.reset_counts()
    out, counts = plane.step_n_counts(state, 3)
    assert batch_board.plain_calls == 0 and tiled.plain_calls == 2
    theirs = _jax_plane("bit", rule)
    jout, jcounts = theirs.step_n_counts(theirs.encode(boards), 3)
    assert np.array_equal(counts, jcounts)
    np.testing.assert_array_equal(plane.decode(out), theirs.decode(jout))


@pytest.mark.parametrize(
    "shape,kind,word_axis",
    [((64, 64), BatchBitPlane, 0), ((64, 50), BatchBitPlane, 0),
     ((50, 64), BatchBitPlane, 1), ((30, 30), BatchBytePlane, None),
     ((16, 16), BatchBytePlane, None)],
)
def test_auto_batch_plane_chooses_like_jax(shape, kind, word_axis):
    from gol_distributed_final_tpu.ops import batched as jb
    from gol_distributed_final_tpu.ops.auto import auto_batch_plane as jauto

    plane = auto_batch_plane(CONWAY, shape, "cpu")
    assert type(plane) is kind and plane.device == CPU
    theirs = jauto(CONWAY, shape)
    assert type(theirs).__name__ == kind.__name__
    if word_axis is not None:
        assert plane.word_axis == word_axis == theirs.word_axis
    boards = _mixed_batch(b=3, h=shape[0], w=shape[1], seed=7)
    state = plane.step_n(plane.encode(boards), 7)
    np.testing.assert_array_equal(plane.decode(state), _oracle(boards, 7))
    assert isinstance(theirs, (jb.BatchBitPlane, jb.BatchBytePlane))


def test_batch_planes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (BatchBitPlane, BatchBytePlane):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        auto_batch_plane(CONWAY, (64, 64), None)
