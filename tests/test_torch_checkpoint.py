"""The PyTorch port's checkpoints and resume on the CPU, held against the
JAX package's (engine/checkpoint.py there and here): the same digests and
``.npz`` fields byte for byte, every ``CheckpointError`` kind from the
same corrupt input, generations and their fallback, delta checkpoints,
packed checkpoints, files written by either package resuming in the
other, the engine's periodic checkpoints, and ``-resume`` on the CLI.
Game of Life is integer-exact: every comparison is equality.
"""

import os
import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.engine import checkpoint as jck
from gol_distributed_final_tpu.models import CONWAY as J_CONWAY
from gol_distributed_final_tpu.models import HIGHLIFE as J_HIGHLIFE
from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
from gol_distributed_final_tpu_torch.engine import checkpoint as pck
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.models import CONWAY, HIGHLIFE
from gol_distributed_final_tpu_torch.ops import bitpack, sparse
from gol_distributed_final_tpu_torch.ops.plane import BitPlane

from helpers import REPO_ROOT, assert_equal_board, read_alive_cells
from oracle import vector_step

PKGS = {"port": (pck, CONWAY, HIGHLIFE), "ref": (jck, J_CONWAY, J_HIGHLIFE)}


def _rand_board(h, w, seed, p=0.4):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < p, 255, 0).astype(np.uint8)


def _evolve(board, turns, birth=(3,), survive=(2, 3)):
    for _ in range(turns):
        board = vector_step(board, birth, survive)
    return board


def _fields(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: (data[k].dtype.str, data[k].shape, data[k].tobytes()) for k in data.files}


# -- the byte format ----------------------------------------------------------


@pytest.mark.parametrize("shape,turn,rulestring", [
    ((12, 9), 17, "B3/S23"), ((64, 32), 0, "B36/S23"), ((1, 300), 123456789, "B2/S"),
])
def test_digest_equals_the_reference(shape, turn, rulestring):
    board = _rand_board(*shape, seed=turn % 97)
    got = pck.checkpoint_digest(board, turn, rulestring)
    assert got == jck.checkpoint_digest(board, turn, rulestring)
    assert got == pck.checkpoint_digest(board, turn, rulestring, format_version=2)
    # every field of the preimage is bound
    assert pck.checkpoint_digest(board, turn + 1, rulestring) != got
    assert pck.checkpoint_digest(board, turn, "B36/S125") != got
    assert pck.checkpoint_digest(board.reshape(shape[::-1]), turn, rulestring) != got


@pytest.mark.parametrize("rule_index", [1, 2])
def test_saved_files_equal_the_reference_field_for_field(rule_index, tmp_path):
    board = _rand_board(32, 48, seed=rule_index)
    port = pck.save_checkpoint(tmp_path / "p", board, 123, PKGS["port"][rule_index])
    ref = jck.save_checkpoint(tmp_path / "r", board, 123, PKGS["ref"][rule_index])
    assert port.name == "p.npz" and ref.name == "r.npz"
    assert _fields(port) == _fields(ref)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_each_package_verifies_the_others_file(writer, reader, tmp_path):
    board = _rand_board(12, 9, seed=1)
    wmod, _, w_highlife = PKGS[writer]
    rmod = PKGS[reader][0]
    path = wmod.save_checkpoint(tmp_path / "ck", board, 17, w_highlife)
    got, turn, rule = rmod.load_verified_checkpoint(path)
    np.testing.assert_array_equal(got, board)
    assert (turn, rule.rulestring) == (17, "B36/S23")
    got2, turn2, _ = rmod.load_checkpoint(path)
    np.testing.assert_array_equal(got2, board)
    assert turn2 == 17


def _corrupt_inputs(tmp_path):
    """name -> (path, kind): every way a file on the -resume surface can
    be wrong, each written once and read by both packages."""
    board = _rand_board(8, 8, seed=2)
    good = jck.save_checkpoint(tmp_path / "good", board, 5, J_CONWAY)
    out = {}
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"this is not an npz at all")
    out["garbage"] = (garbage, "unreadable")
    truncated = tmp_path / "truncated.npz"
    truncated.write_bytes(good.read_bytes()[: good.stat().st_size // 2])
    out["truncated"] = (truncated, "unreadable")
    fields = tmp_path / "fields.npz"
    np.savez(fields, board=board)
    out["fields"] = (fields, "truncated")
    packed = jck.save_packed_checkpoint(tmp_path / "packed", np.zeros((1, 8), np.uint32), 5)
    out["packed"] = (packed, "format")
    legacy = tmp_path / "legacy.npz"
    np.savez(legacy, board=board, turn=np.int64(5), rulestring=np.str_("B3/S23"))
    out["legacy"] = (legacy, "unverified")
    forged = tmp_path / "forged.npz"
    np.savez(forged, board=board, turn=np.int64(5), rulestring=np.str_("B3/S23"),
             format_version=np.int64(2), digest=np.str_("0" * 32))
    out["forged"] = (forged, "digest")
    newer = tmp_path / "newer.npz"
    np.savez(newer, board=board, turn=np.int64(5), rulestring=np.str_("B3/S23"),
             format_version=np.int64(3), digest=np.str_("0" * 32))
    out["newer"] = (newer, "format")
    badrule = tmp_path / "badrule.npz"
    np.savez(badrule, board=board, turn=np.int64(5), rulestring=np.str_("Q9"),
             digest=np.str_("0" * 32))
    out["badrule"] = (badrule, "truncated")
    return out


@pytest.mark.parametrize("case", [
    "garbage", "truncated", "fields", "packed", "legacy", "forged", "newer", "badrule",
])
def test_every_error_kind_equals_the_reference(case, tmp_path):
    path, kind = _corrupt_inputs(tmp_path)[case]
    errors = {}
    for name, (mod, _, _) in PKGS.items():
        with pytest.raises(mod.CheckpointError) as exc:
            mod.load_verified_checkpoint(path)
        errors[name] = exc.value
    assert errors["port"].kind == errors["ref"].kind == kind
    assert str(errors["port"]) == str(errors["ref"])
    assert isinstance(errors["port"], ValueError)


def test_generation_rotation_and_fallback_equal_the_reference(tmp_path):
    board = _rand_board(8, 8, seed=3)
    seen = {}
    for name, (mod, conway, _) in PKGS.items():
        base = tmp_path / name / "auto"
        # the broker's sequence: write the new current, rotate, rename
        for turn in (10, 20, 30):
            written = mod.save_checkpoint(base.with_name("auto.tmp"), board, turn, conway)
            mod.rotate_generations(base, keep=3)
            written.replace(mod.npz_path(base))
        assert mod.generation_path(base, 0) == mod.npz_path(base)
        assert mod.generation_path(base, 2).name == "auto.g2.npz"
        turns = [mod.load_verified_checkpoint(mod.generation_path(base, g))[1] for g in range(3)]
        assert turns == [30, 20, 10]
        got = mod.load_resume_checkpoint(base, keep=3)
        assert (got[1], got[3]) == (30, 0)
        mod.npz_path(base).write_bytes(b"scribble")
        got = mod.load_resume_checkpoint(base, keep=3)
        assert (got[1], got[3]) == (20, 1)
        with pytest.raises(mod.CheckpointError) as exc:
            mod.load_resume_checkpoint(base, keep=1)
        assert exc.value.kind == "exhausted"
        mod.generation_path(base, 1).write_bytes(b"scribble")
        mod.generation_path(base, 2).unlink()
        with pytest.raises(mod.CheckpointError, match="not found") as exc:
            mod.load_resume_checkpoint(base, keep=3)
        assert exc.value.kind == "exhausted"
        assert str(exc.value).count("[unreadable]") == 2
        seen[name] = str(exc.value).replace(str(tmp_path / name), "DIR")
    assert seen["port"] == seen["ref"]


# -- the wire-tile deltas -----------------------------------------------------


def test_tile_delta_helpers_equal_the_reference():
    from gol_distributed_final_tpu.ops import sparse as jsparse

    assert (sparse.WIRE_TILE_ROWS, sparse.WIRE_TILE_COLS) == (
        jsparse.WIRE_TILE_ROWS, jsparse.WIRE_TILE_COLS)
    a = _rand_board(100, 300, seed=5, p=0.2)
    b = a.copy()
    b[0:3, 0:3] ^= 255
    b[97:100, 290:300] ^= 255
    b[80, 120] ^= 255
    dirty = sparse.dirty_tile_grid(a, b)
    np.testing.assert_array_equal(dirty, jsparse.dirty_tile_grid(a, b))
    assert dirty.shape == sparse.wire_tile_grid((100, 300)) == jsparse.wire_tile_grid((100, 300))
    assert int(dirty.sum()) == 3
    flat = sparse.extract_dirty_tiles(b, dirty)
    np.testing.assert_array_equal(flat, jsparse.extract_dirty_tiles(b, dirty))
    np.testing.assert_array_equal(sparse.apply_dirty_tiles(a, dirty, flat), b)
    assert sparse._tile_bounds((100, 300), 1, 1, 64, 256) == (64, 100, 256, 300)
    for bad, match in ((flat[:-1], "truncated"), (np.concatenate([flat, flat[:1]]), "trailing")):
        with pytest.raises(ValueError, match=match):
            sparse.apply_dirty_tiles(a, dirty, bad)
    with pytest.raises(ValueError, match="does not match"):
        sparse.extract_dirty_tiles(b, dirty[:, :1])
    empty = np.zeros_like(dirty)
    assert sparse.extract_dirty_tiles(b, empty).size == 0


def _r_pentomino_board(h, w):
    board = np.zeros((h, w), np.uint8)
    cy, cx = h // 2, w // 2
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        board[cy + dy, cx + dx] = 255
    return board


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_delta_roundtrip_and_refusals(writer, reader, tmp_path):
    """tests/test_sparse.py's delta scenario, with the files written by
    one package and resumed by the other."""
    wmod, rmod = PKGS[writer][0], PKGS[reader][0]
    base = _r_pentomino_board(256, 512)
    later = _evolve(base, 10)
    p = tmp_path / "ck.npz"
    wmod.save_checkpoint(p, base, 100, PKGS[writer][1])
    base_digest = wmod.checkpoint_digest(base, 100, "B3/S23")
    dirty = sparse.dirty_tile_grid(base, later)
    dpath = wmod.save_delta_checkpoint(p, later, dirty, 110, PKGS[writer][1], 100, base_digest)
    assert dpath.name == "ck.d110.npz"
    assert rmod.delta_checkpoint_paths(p) == [(110, dpath)]
    with np.load(dpath, allow_pickle=False) as data:
        assert data["tiles"].nbytes < later.nbytes
    board, turn, rule, gen = rmod.load_resume_checkpoint(p)
    assert (turn, gen, rule.rulestring) == (110, 0, "B3/S23")
    np.testing.assert_array_equal(board, later)

    rconway = PKGS[reader][1]
    with pytest.raises(rmod.CheckpointError) as exc:
        rmod.apply_delta_checkpoint(dpath, np.zeros((128, 128), np.uint8), 100, rconway)
    assert exc.value.kind == "delta-base"
    with pytest.raises(rmod.CheckpointError) as exc:
        rmod.apply_delta_checkpoint(dpath, base, 99, rconway)
    assert exc.value.kind == "delta-base"
    with pytest.raises(rmod.CheckpointError) as exc:
        rmod.apply_delta_checkpoint(dpath, base, 100, PKGS[reader][2])
    assert exc.value.kind == "format"

    # flipped tile bytes: a digest refusal, and resume falls back to the
    # verified full generation
    with np.load(dpath, allow_pickle=False) as data:
        fields = {k: data[k] for k in data.files}
    fields["tiles"] = np.asarray(fields["tiles"], np.uint8) ^ 255
    np.savez_compressed(dpath.with_suffix(""), **fields)
    with pytest.raises(rmod.CheckpointError) as exc:
        rmod.apply_delta_checkpoint(dpath, base, 100, rconway)
    assert exc.value.kind == "digest"
    board, turn, _, _ = rmod.load_resume_checkpoint(p)
    assert turn == 100
    np.testing.assert_array_equal(board, base)

    # a payload cut short, and a file that is no delta
    fields["tiles"] = fields["tiles"][:-1]
    np.savez_compressed(dpath.with_suffix(""), **fields)
    with pytest.raises(rmod.CheckpointError) as exc:
        rmod.apply_delta_checkpoint(dpath, base, 100, rconway)
    assert exc.value.kind == "truncated"
    dpath.write_bytes(b"junk")
    with pytest.raises(rmod.CheckpointError) as exc:
        rmod.apply_delta_checkpoint(dpath, base, 100, rconway)
    assert exc.value.kind == "unreadable"

    rmod.clear_delta_checkpoints(p)
    assert rmod.delta_checkpoint_paths(p) == []


def test_delta_errors_equal_the_reference(tmp_path):
    base = _r_pentomino_board(128, 256)
    later = _evolve(base, 4)
    p = tmp_path / "ck.npz"
    pck.save_checkpoint(p, base, 7, CONWAY)
    dpath = pck.save_delta_checkpoint(
        p, later, sparse.dirty_tile_grid(base, later), 11, CONWAY, 7,
        pck.checkpoint_digest(base, 7, "B3/S23"))
    for args in ((np.zeros((64, 64), np.uint8), 7), (base, 6)):
        msgs = []
        for mod, conway, _ in PKGS.values():
            with pytest.raises(mod.CheckpointError) as exc:
                mod.apply_delta_checkpoint(dpath, args[0], args[1], conway)
            msgs.append((exc.value.kind, str(exc.value)))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="wire-tile grid"):
        pck.save_delta_checkpoint(p, later, np.zeros((1, 1), bool), 11, CONWAY, 7, "x")


# -- the packed format --------------------------------------------------------


def test_packed_checkpoint_roundtrip_and_resume(tmp_path):
    board = _rand_board(128, 128, seed=17, p=0.3)
    packed = bitpack.pack(board, 0, "cpu")
    mid = bitpack.bit_step_n(packed, 40, 0)
    p = pck.save_packed_checkpoint(tmp_path / "big.npz", mid, 40)
    loaded, turn, rule, word_axis = pck.load_packed_checkpoint(p)
    assert (turn, rule.rulestring, word_axis) == (40, "B3/S23", 0)
    assert loaded.dtype == np.int32
    np.testing.assert_array_equal(loaded, mid.numpy())
    resumed = bitpack.bit_step_n(bitpack.state_from_numpy(loaded, "cpu"), 60, word_axis)
    assert torch.equal(resumed, bitpack.bit_step_n(packed, 100, 0))


@pytest.mark.parametrize("word_axis", [0, 1])
def test_packed_files_cross_load_both_ways(word_axis, tmp_path):
    import jax.numpy as jnp

    from gol_distributed_final_tpu.ops import bitpack as jbitpack

    board = _rand_board(64, 96, seed=word_axis + 30, p=0.3)
    port_state = bitpack.pack(board, word_axis, "cpu")
    ref_state = jbitpack.pack(jnp.asarray(board), word_axis)
    pp = pck.save_packed_checkpoint(tmp_path / "p", port_state, 9, HIGHLIFE, word_axis)
    rp = jck.save_packed_checkpoint(tmp_path / "r", ref_state, 9, J_HIGHLIFE, word_axis)
    assert _fields(pp) == _fields(rp)
    for path in (pp, rp):
        for mod in (pck, jck):
            packed, turn, rule, axis = mod.load_packed_checkpoint(path)
            assert (turn, rule.rulestring, axis) == (9, "B36/S23", word_axis)
            np.testing.assert_array_equal(np.asarray(packed), port_state.numpy())
    # the ref's words continue on the port to the same board
    packed, turn, rule, axis = pck.load_packed_checkpoint(rp)
    state = bitpack.state_from_numpy(packed, "cpu")
    got = BitPlane(rule, axis, "cpu").decode(BitPlane(rule, axis, "cpu").step_n(state, 11))
    np.testing.assert_array_equal(got, _evolve(board, 11, (3, 6), (2, 3)))


def test_format_cross_loading_raises(tmp_path):
    board = np.zeros((32, 32), np.uint8)
    bytep = pck.save_checkpoint(tmp_path / "b.npz", board, 1)
    packp = pck.save_packed_checkpoint(tmp_path / "p.npz", bitpack.pack(board, 0, "cpu"), 1)
    for mod in (pck, jck):
        with pytest.raises(ValueError, match="packed-bitboard checkpoint"):
            mod.load_checkpoint(packp)
        with pytest.raises(ValueError, match="byte-board checkpoint"):
            mod.load_packed_checkpoint(bytep)


# -- resume through the controller -------------------------------------------


def _session(turns, tmp_path, **kwargs):
    events = queue.Queue()
    result = run(Params(turns=turns, image_width=64, image_height=64), events,
                 images_dir=REPO_ROOT / "images", out_dir=tmp_path / "out",
                 tick_seconds=3600, **kwargs)
    return result


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_resume_equals_uninterrupted_run(writer, tmp_path):
    """Stop at turn 40, checkpoint (with either package), resume through
    the port's controller to 100: the golden board and PGM bytes."""
    world0 = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    leg1 = Engine(EngineConfig(device="cpu")).run(
        Params(turns=40, image_width=64, image_height=64), world0)
    ck = PKGS[writer][0].save_checkpoint(tmp_path / "ck.npz", leg1.world, leg1.turns_completed)
    result = _session(100, tmp_path, resume_from=ck, device="cpu")
    assert result.turns_completed == 100
    golden = REPO_ROOT / "check" / "images" / "64x64x100.pgm"
    assert_equal_board(result.alive, read_alive_cells(golden), 64, 64)
    assert (tmp_path / "out" / "64x64x100.pgm").read_bytes() == golden.read_bytes()


def test_port_checkpoint_resumes_on_the_reference(tmp_path):
    from gol_distributed_final_tpu import Params as JParams
    from gol_distributed_final_tpu import run as jax_run

    board = _rand_board(64, 64, seed=8, p=0.3)
    leg1 = Engine(EngineConfig(rule=HIGHLIFE, device="cpu")).run(
        Params(turns=30, image_width=64, image_height=64), board)
    ck = pck.save_checkpoint(tmp_path / "ck.npz", leg1.world, 30, HIGHLIFE)
    outs = {}
    for name, (runner, params) in {
        "port": (run, Params(turns=75, image_width=64, image_height=64)),
        "ref": (jax_run, JParams(turns=75, image_width=64, image_height=64)),
    }.items():
        kwargs = {"device": "cpu"} if name == "port" else {}
        result = runner(params, queue.Queue(), resume_from=ck, out_dir=tmp_path / name,
                        tick_seconds=3600, **kwargs)
        assert result.turns_completed == 75
        outs[name] = (tmp_path / name / "64x64x75.pgm").read_bytes()
    want = _evolve(board, 75, (3, 6), (2, 3))
    assert outs["port"] == outs["ref"]
    np.testing.assert_array_equal(read_pgm(tmp_path / "port" / "64x64x75.pgm"), want)


def test_resume_from_a_verified_tuple_and_rule_checks(tmp_path):
    board = _rand_board(64, 64, seed=9, p=0.3)
    ck = pck.save_checkpoint(tmp_path / "ck.npz", board, 10, HIGHLIFE)
    loaded = pck.load_verified_checkpoint(ck)
    result = _session(20, tmp_path, resume_from=loaded, device="cpu")
    np.testing.assert_array_equal(result.world, _evolve(board, 10, (3, 6), (2, 3)))
    with pytest.raises(ValueError, match="conflicts with the checkpoint"):
        _session(20, tmp_path, resume_from=loaded, rule=CONWAY, device="cpu")
    with pytest.raises(ValueError, match="does not match the engine"):
        _session(20, tmp_path, resume_from=loaded,
                 engine_config=EngineConfig(rule=CONWAY, device="cpu"))


def test_resume_validates_shape_and_turns_as_the_reference(tmp_path):
    from gol_distributed_final_tpu import Params as JParams
    from gol_distributed_final_tpu import run as jax_run

    ck = pck.save_checkpoint(tmp_path / "ck.npz", np.zeros((64, 64), np.uint8), 40)
    for size, turns, match in ((128, 100, "mislabel"), (64, 40, "not beyond")):
        msgs = []
        for runner, params in ((run, Params), (jax_run, JParams)):
            with pytest.raises(ValueError, match=match) as exc:
                runner(params(turns=turns, image_width=size, image_height=size),
                       queue.Queue(), None, resume_from=ck)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


# -- the engine's periodic checkpoints ---------------------------------------


def test_periodic_checkpoint_equals_the_reference_and_recovers(tmp_path):
    """EngineConfig(checkpoint_every=...) writes between chunks, packed for
    a bitboard plane: chunks pinned to 10 cross 30 at 30, 60, 90, and the
    file holds turn 90 with the same fields the JAX engine writes."""
    from gol_distributed_final_tpu.engine.engine import Engine as JEngine
    from gol_distributed_final_tpu.engine.engine import EngineConfig as JEngineConfig
    from gol_distributed_final_tpu.ops import bitpack as jbitpack
    from gol_distributed_final_tpu.ops.plane import BitPlane as JBitPlane
    from gol_distributed_final_tpu.params import Params as JParams

    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    paths = {name: tmp_path / f"{name}.npz" for name in ("port", "ref")}
    Engine(EngineConfig(final_world=False, min_chunk=10, max_chunk=10, checkpoint_every=30,
                        checkpoint_path=str(paths["port"]), device="cpu")).run(
        Params(turns=100, image_width=64, image_height=64), None,
        plane=BitPlane(device="cpu"), initial_state=bitpack.pack(board, 0, "cpu"))
    JEngine(JEngineConfig(final_world=False, min_chunk=10, max_chunk=10, checkpoint_every=30,
                          checkpoint_path=str(paths["ref"]))).run(
        JParams(turns=100, image_width=64, image_height=64), None,
        plane=JBitPlane(), initial_state=jbitpack.pack(board, 0))
    assert _fields(paths["port"]) == _fields(paths["ref"])
    assert not list(tmp_path.glob("*.tmp*"))
    packed, turn, rule, word_axis = pck.load_packed_checkpoint(paths["port"])
    assert (turn, rule.rulestring, word_axis) == (90, "B3/S23", 0)
    resumed = Engine(EngineConfig(final_world=False, device="cpu")).run(
        Params(turns=100, image_width=64, image_height=64), None,
        plane=BitPlane(device="cpu"), initial_state=bitpack.state_from_numpy(packed, "cpu"),
        initial_turn=turn)
    assert resumed.turns_completed == 100
    golden = REPO_ROOT / "check" / "images" / "64x64x100.pgm"
    assert_equal_board(resumed.alive, read_alive_cells(golden), 64, 64)


def test_periodic_byte_checkpoint_on_the_byte_plane(tmp_path):
    ck = tmp_path / "auto_byte.npz"
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    result = Engine(EngineConfig(min_chunk=10, max_chunk=10, checkpoint_every=50,
                                 checkpoint_path=str(ck), auto_fast=False,
                                 device="cpu")).run(
        Params(turns=100, image_width=64, image_height=64), board)
    assert result.checkpoint_error is None
    world, turn, rule = pck.load_verified_checkpoint(ck)
    assert turn == 100 and rule.rulestring == "B3/S23"  # crossings at 50 and 100
    np.testing.assert_array_equal(world, result.world)
    np.testing.assert_array_equal(jck.load_verified_checkpoint(ck)[0], world)


def test_periodic_checkpoint_stamps_the_active_plane_rule(tmp_path):
    board = _rand_board(64, 64, seed=6, p=0.3)
    ck = tmp_path / "hl.npz"
    Engine(EngineConfig(final_world=False, min_chunk=10, max_chunk=10, checkpoint_every=20,
                        checkpoint_path=str(ck), device="cpu")).run(
        Params(turns=50, image_width=64, image_height=64), None,
        plane=BitPlane(HIGHLIFE, device="cpu"), initial_state=bitpack.pack(board, 0, "cpu"))
    packed, turn, rule, _ = pck.load_packed_checkpoint(ck)
    assert rule.rulestring == HIGHLIFE.rulestring and turn == 40
    want = bitpack.pack(_evolve(board, 40, (3, 6), (2, 3)), 0, "cpu")
    assert torch.equal(bitpack.state_from_numpy(packed, "cpu"), want)


def test_failed_checkpoint_write_does_not_abort_the_run(tmp_path, capsys):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the checkpoint wants a directory")
    board = _rand_board(64, 64, seed=12, p=0.3)
    res = Engine(EngineConfig(min_chunk=10, max_chunk=10, checkpoint_every=30,
                              checkpoint_path=str(blocker / "ck.npz"), device="cpu")).run(
        Params(turns=100, image_width=64, image_height=64), board)
    assert res.turns_completed == 100
    assert isinstance(res.checkpoint_error, OSError)
    np.testing.assert_array_equal(res.world, _evolve(board, 100))
    assert "checkpoint at turn 30 failed" in capsys.readouterr().out


def test_write_checkpoint_keeps_the_previous_file_on_failure(tmp_path):
    written = pck.write_checkpoint(tmp_path / "ck", 3, CONWAY, board=np.zeros((4, 4), np.uint8))
    assert written == tmp_path / "ck.npz" and written.exists()
    with pytest.raises(Exception):
        pck.write_checkpoint(tmp_path / "ck", 4, CONWAY, board=None)
    assert pck.load_verified_checkpoint(tmp_path / "ck.npz")[1] == 3
    packed = torch.tensor([[1, -1], [0, 7]], dtype=torch.int32)
    pck.write_checkpoint(tmp_path / "ck", 5, CONWAY, packed=packed, word_axis=1)
    words, turn, _, axis = pck.load_packed_checkpoint(tmp_path / "ck.npz")
    assert (turn, axis) == (5, 1) and np.array_equal(words, packed.numpy())


def test_try_write_checkpoint_picks_the_format_and_returns_the_failure(tmp_path):
    from gol_distributed_final_tpu_torch.ops.plane import BytePlane

    board = _rand_board(64, 64, seed=14, p=0.3)
    bit = BitPlane(HIGHLIFE, 1, device="cpu")
    assert pck.try_write_checkpoint(tmp_path / "bit", 7, HIGHLIFE, bit, bit.encode(board)) is None
    words, turn, rule, axis = pck.load_packed_checkpoint(tmp_path / "bit.npz")
    assert (turn, rule.rulestring, axis) == (7, HIGHLIFE.rulestring, 1)
    assert torch.equal(torch.from_numpy(words), bit.encode(board))
    byte = BytePlane(device="cpu")
    assert pck.try_write_checkpoint(tmp_path / "byte", 8, CONWAY, byte,
                                    byte.encode(board)) is None
    np.testing.assert_array_equal(pck.load_verified_checkpoint(tmp_path / "byte.npz")[0], board)
    err = pck.try_write_checkpoint(tmp_path / "byte", 9, CONWAY, byte, None)
    assert isinstance(err, AttributeError)
    assert pck.load_verified_checkpoint(tmp_path / "byte.npz")[1] == 8


def test_failed_decode_in_a_checkpoint_does_not_abort_the_run(tmp_path, capsys):
    """The catch-all covers the whole write, the state's decode or host
    copy included, as the JAX engine's does."""
    from gol_distributed_final_tpu_torch.ops.plane import BytePlane

    class _BadDecode(BytePlane):
        def decode(self, state):
            raise MemoryError("no host buffer for the board")

    board = _rand_board(64, 64, seed=13, p=0.3)
    ck = tmp_path / "ck.npz"
    res = Engine(EngineConfig(final_world=False, min_chunk=10, max_chunk=10,
                              checkpoint_every=30, checkpoint_path=str(ck),
                              device="cpu")).run(
        Params(turns=100, image_width=64, image_height=64), None,
        plane=_BadDecode(device="cpu"), initial_state=torch.from_numpy(board))
    assert res.turns_completed == 100 and not ck.exists()
    assert res.alive_count == int(np.count_nonzero(_evolve(board, 100)))
    assert isinstance(res.checkpoint_error, MemoryError)
    assert "checkpoint at turn 90 failed: no host buffer" in capsys.readouterr().out


# -- -resume on the CLI --------------------------------------------------------


def _cli(args, cwd, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    return subprocess.run([sys.executable, "-m", "gol_distributed_final_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=cwd)


def test_cli_resume_session(tmp_path):
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    ck = jck.save_checkpoint(tmp_path / "ck.npz", _evolve(board, 40), 40)
    # no images/ in the working directory: resume needs no input PGM
    r = _cli(["-w", "64", "-h", "64", "-turns", "100", "-noVis", "-device", "cpu",
              "-resume", str(ck)], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert "Completed Turns 100 Quitting" in r.stdout
    assert (tmp_path / "out" / "64x64x100.pgm").read_bytes() == \
        (REPO_ROOT / "check" / "images" / "64x64x100.pgm").read_bytes()


@pytest.mark.parametrize("case", ["garbage", "legacy", "rule"])
def test_cli_refuses_a_bad_resume_as_the_reference(case, tmp_path, capsys):
    from gol_distributed_final_tpu.__main__ import main as jax_main
    from gol_distributed_final_tpu_torch.__main__ import main as port_main

    if case == "rule":
        ck = pck.save_checkpoint(tmp_path / "ck.npz", np.zeros((16, 16), np.uint8), 1)
        flags = ["-resume", str(ck), "-rule", "B36/S23"]
    else:
        flags = ["-resume", str(_corrupt_inputs(tmp_path)[case][0])]
    errors = []
    for main in (port_main, jax_main):
        with pytest.raises(SystemExit) as exc:
            main(["-noVis", *flags])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "Traceback" not in err
        errors.append(err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1]
