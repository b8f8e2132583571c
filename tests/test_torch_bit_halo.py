"""The port's packed mesh plane (gol_distributed_final_tpu_torch/parallel/
bit_halo.py) against the JAX package's on the 8-device virtual CPU mesh.

Each block of the port's mesh is stepped by the tiled kernel's wrapper
(ops/tiled.step_n), which takes the kernel's plain version for CPU
tensors, or by ``bit_step`` where the JAX package keeps XLA. The JAX side
runs its XLA local step (its Pallas route is interpret-only on the CPU
and computes the same words). Boards, counts and cells must be equal,
exactly. Mirrors tests/test_bit_halo.py.
"""

import queue

import jax
import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.models import CONWAY as J_CONWAY, HIGHLIFE as J_HIGHLIFE
from gol_distributed_final_tpu.ops import bitpack as jbitpack
from gol_distributed_final_tpu.parallel import bit_halo as jbit
from gol_distributed_final_tpu.parallel import mesh as jmesh
from gol_distributed_final_tpu_torch.models import CONWAY, HIGHLIFE
from gol_distributed_final_tpu_torch.ops import bitpack, tiled
from gol_distributed_final_tpu_torch.parallel import bit_halo, halo
from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard, make_mesh

from helpers import REPO_ROOT

MESH_SHAPES = [(8, 1), (1, 8), (4, 2), (2, 4)]


def port_mesh(shape):
    return make_mesh(shape, devices=[torch.device("cpu")] * 8)


def random_words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


def ref_bit_steps(shape, packed, n, rule=J_CONWAY, word_axis=0, **kw):
    mesh = jmesh.make_mesh(shape)
    step = jbit.sharded_bit_step_n_fn(mesh, rule, word_axis, **kw)
    return np.asarray(step(jax.device_put(packed, jbit.packed_sharding(mesh)), n))


def port_bit_steps(shape, packed, n, rule=CONWAY, word_axis=0, **kw):
    mesh = port_mesh(shape)
    step = bit_halo.sharded_bit_step_n_fn(mesh, rule, word_axis, **kw)
    return step(ShardedBoard.from_global(mesh, packed), n).numpy()


def test_choose_bit_layout_equals_the_reference():
    for h in (32, 50, 64, 96, 256, 512, 1024):
        for w in (32, 50, 64, 96, 256):
            for shape in MESH_SHAPES + [(1, 1), (2, 2), (3, 1)]:
                assert (bit_halo.choose_bit_layout((h, w), shape)
                        == jbit.choose_bit_layout((h, w), shape)), (h, w, shape)


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("word_axis", [0, 1])
@pytest.mark.parametrize("depth", [1, 2, 3, 8])
def test_sharded_bit_step_equals_the_reference(shape, word_axis, depth):
    """Random words, blocks of 8 x 16 words: every depth up to the tiled
    kernel's bound fits, and n = 2 * depth + 1 takes the remainder path."""
    packed = random_words((8 * shape[0], 16 * shape[1]), seed=31 + depth)
    n = 2 * depth + 1
    got = port_bit_steps(shape, packed, n, word_axis=word_axis, halo_depth=depth)
    want = ref_bit_steps(shape, packed, n, word_axis=word_axis, halo_depth=depth)
    np.testing.assert_array_equal(got, want)


def test_depth_past_the_kernel_bound_runs_bit_step():
    """Depth 9 (past one launch's 8 turns) stays on bit_step and stays
    exact, against the depth-1 mesh and the reference."""
    packed = random_words((32, 1024), seed=35)  # blocks (16, 256) on (2, 4)
    mesh = port_mesh((2, 4))
    step = bit_halo.sharded_bit_step_n_fn(mesh, halo_depth=9)
    for n in (9, 10):
        tiled.reset_counts()
        got = step(ShardedBoard.from_global(mesh, packed), n).numpy()
        assert tiled.plain_calls == 0
        np.testing.assert_array_equal(got, port_bit_steps((2, 4), packed, n))
        np.testing.assert_array_equal(got, ref_bit_steps((2, 4), packed, n, halo_depth=9))


def test_sharded_bit_highlife():
    rng = np.random.default_rng(8)
    board = np.where(rng.random((64, 128)) < 0.3, 255, 0).astype(np.uint8)
    word_axis = bit_halo.choose_bit_layout(board.shape, (2, 4))
    packed = bitpack.pack(board, word_axis).numpy()
    got = port_bit_steps((2, 4), packed, 2, HIGHLIFE, word_axis)
    want = ref_bit_steps((2, 4), packed, 2, J_HIGHLIFE, word_axis)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_bit_glider_crosses_shard_boundaries(shape):
    board = np.zeros((64, 64), np.uint8)
    for x, y in [(1, 0), (2, 1), (0, 2), (1, 2), (2, 2)]:
        board[y, x] = 255
    word_axis = bit_halo.choose_bit_layout(board.shape, shape)
    packed = bitpack.pack(board, word_axis).numpy()
    got = port_bit_steps(shape, packed, 4 * 64, word_axis=word_axis)
    np.testing.assert_array_equal(got, packed)
    np.testing.assert_array_equal(got, ref_bit_steps(shape, packed, 4 * 64, word_axis=word_axis))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_bit_plane_golden_64(shape):
    """ShardedBitPlane vs the 64x64x100 golden and the JAX plane: encode
    once, 100 turns on the mesh, decode once; counts and cells equal."""
    from gol_distributed_final_tpu.io.pgm import read_pgm

    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    plane = bit_halo.make_bit_plane(port_mesh(shape), board.shape)
    jplane = jbit.make_bit_plane(jmesh.make_mesh(shape), board.shape)
    assert plane.word_axis == jplane.word_axis
    state = plane.step_n(plane.encode(board), 100)
    jstate = jplane.step_n(jplane.encode(board), 100)
    got = plane.decode(state)
    golden = read_pgm(REPO_ROOT / "check" / "images" / "64x64x100.pgm")
    np.testing.assert_array_equal(got, golden)
    np.testing.assert_array_equal(got, jplane.decode(jstate))
    assert plane.alive_count(state) == jplane.alive_count(jstate) == int(np.count_nonzero(got))
    assert ([tuple(c) for c in plane.alive_cells(state)]
            == [tuple(c) for c in jplane.alive_cells(jstate)])
    np.testing.assert_array_equal(plane.decode_global(state).numpy(), got)


def test_engine_runs_on_sharded_bit_plane(tmp_path):
    """A full session on the packed mesh plane: golden end to end, and the
    count-only retrieve served by the sharded popcount."""
    from gol_distributed_final_tpu_torch import FinalTurnComplete, Params, run
    from gol_distributed_final_tpu_torch.engine.controller import CLOSED
    from gol_distributed_final_tpu_torch.engine.engine import Engine, EngineConfig

    plane = bit_halo.make_bit_plane(port_mesh((4, 2)), (64, 64))
    assert isinstance(plane, bit_halo.ShardedBitPlane)
    events = queue.Queue()
    run(Params(turns=100, image_width=64, image_height=64), events,
        engine_config=EngineConfig(plane=plane, device="cpu"),
        images_dir=REPO_ROOT / "images", out_dir=tmp_path / "out", tick_seconds=3600)
    finals = []
    while True:
        ev = events.get_nowait()
        if ev is CLOSED:
            break
        if isinstance(ev, FinalTurnComplete):
            finals.append(ev)
    assert len(finals) == 1
    assert ((tmp_path / "out" / "64x64x100.pgm").read_bytes()
            == (REPO_ROOT / "check" / "images" / "64x64x100.pgm").read_bytes())
    engine = Engine(EngineConfig(plane=plane, device="cpu"))
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    res = engine.run(Params(turns=100, image_width=64, image_height=64),
                     read_pgm(REPO_ROOT / "images" / "64x64.pgm"))
    assert engine.retrieve(include_world=False).alive_count == int(np.count_nonzero(res.world))


def test_the_tiled_route_reaches_the_kernels_plain_version():
    """The port's gate: row packing and a depth one launch can step take
    the tiled kernel (its plain version for these CPU blocks: one call a
    block a launch); column packing and depth 9 stay on bit_step."""
    mesh = port_mesh((2, 4))
    assert bit_halo._auto_use_tiled(1, 0) and bit_halo._auto_use_tiled(8, 0)
    assert not bit_halo._auto_use_tiled(9, 0) and not bit_halo._auto_use_tiled(1, 1)
    packed = random_words((32, 1024), seed=21)
    tiled.reset_counts()
    step = bit_halo.sharded_bit_step_n_fn(mesh, halo_depth=3)
    got = step(ShardedBoard.from_global(mesh, packed), 7)  # 2 wide, 1 single
    assert tiled.plain_calls == 8 * 3 and tiled.launches == 0
    xla = bit_halo.sharded_bit_step_n_fn(mesh, pallas_local=False, halo_depth=3)
    np.testing.assert_array_equal(got.numpy(), xla(ShardedBoard.from_global(mesh, packed), 7).numpy())
    assert tiled.plain_calls == 8 * 3
    np.testing.assert_array_equal(got.numpy(), bitpack.bit_step_n(torch.from_numpy(packed), 7).numpy())
    tiled.reset_counts()
    col = bit_halo.sharded_bit_step_n_fn(mesh, word_axis=1)
    col(ShardedBoard.from_global(mesh, random_words((64, 32), seed=4)), 2)
    assert tiled.plain_calls == 0


def test_wide_knobs_refused_like_the_reference():
    mesh, jm = port_mesh((2, 4)), jmesh.make_mesh((2, 4))
    for fn, m in ((bit_halo.sharded_bit_step_n_fn, mesh), (jbit.sharded_bit_step_n_fn, jm)):
        with pytest.raises(ValueError, match="halo_depth"):
            fn(m, halo_depth=0)
        with pytest.raises(ValueError, match="pallas"):
            fn(m, halo_depth=9, pallas_local=True)
        fn(m, halo_depth=9)  # auto routing with a deep halo builds
    with pytest.raises(ValueError, match="word_axis=0"):
        bit_halo.sharded_bit_step_n_fn(mesh, word_axis=1, pallas_local=True)
    step = bit_halo.sharded_bit_step_n_fn(mesh, halo_depth=3)  # local (2, 32)
    with pytest.raises(ValueError, match="exceeds the local block"):
        step(ShardedBoard.from_global(mesh, np.zeros((4, 128), np.int32)), 3)


def test_make_bit_plane_returns_none_where_the_reference_does():
    for h, w in ((64, 64), (96, 96), (256, 256), (512, 512), (50, 50), (64, 32)):
        for shape in MESH_SHAPES:
            for depth in (1, 2, 4, 9):
                want = jbit.make_bit_plane(jmesh.make_mesh(shape), (h, w), halo_depth=depth)
                got = bit_halo.make_bit_plane(port_mesh(shape), (h, w), halo_depth=depth)
                assert (got is None) == (want is None), (h, w, shape, depth)
                if got is not None:
                    assert got.word_axis == want.word_axis


def test_multi_process_count_sums_local_blocks():
    """The alive count of a sharded state is its blocks' popcounts summed
    in int64 (the all-gather over ranks is tests/test_torch_multihost.py's)."""
    mesh = port_mesh((4, 2))
    packed = random_words((32, 256), seed=7)
    sharded = ShardedBoard.from_global(mesh, packed)
    assert bitpack.alive_count_packed(sharded) == jbitpack.alive_count_packed(
        jax.device_put(packed, jbit.packed_sharding(jmesh.make_mesh((4, 2)))))
    assert halo.exchanges_per_dispatch(17, 8) == 3
