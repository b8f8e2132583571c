"""The port's byte halo plane (gol_distributed_final_tpu_torch/parallel/
halo.py) against the JAX package's on the 8-device virtual CPU mesh.

The same numpy-seeded boards go through the JAX ``shard_map`` step
(ppermute halos) and the port's mesh of eight CPU shards (halos as tensor
copies); boards must be equal, exactly. Mirrors tests/test_halo.py.
"""

import queue

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.models import HIGHLIFE as J_HIGHLIFE
from gol_distributed_final_tpu.parallel import halo as jhalo
from gol_distributed_final_tpu.parallel import mesh as jmesh
from gol_distributed_final_tpu_torch.models import HIGHLIFE
from gol_distributed_final_tpu_torch.parallel import halo, mesh as pmesh
from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard

from helpers import REPO_ROOT
from oracle import vector_step

MESH_SHAPES = [(8, 1), (1, 8), (4, 2), (2, 4)]


def random_board(h, w, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < density, 255, 0).astype(np.uint8)


def port_mesh(shape):
    """Eight shards on the CPU: the port's counterpart of the virtual
    8-device mesh the JAX side runs on."""
    return pmesh.make_mesh(shape, devices=[torch.device("cpu")] * 8)


def port_steps(mesh, board, n, **kw):
    return halo.sharded_step_n_fn(mesh, **kw)(torch.from_numpy(board), n).numpy()


def ref_steps(shape, board, n, rule=None, **kw):
    args = (jmesh.make_mesh(shape),) + ((rule,) if rule else ())
    return np.asarray(jhalo.sharded_step_n_fn(*args, **kw)(board, n))


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_step_n_equals_the_reference(shape):
    board = random_board(64, 64, seed=11)
    got = port_steps(port_mesh(shape), board, 23)
    np.testing.assert_array_equal(got, ref_steps(shape, board, 23))


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_glider_crosses_shard_boundaries(shape):
    """A glider crossing every internal boundary and the torus edge comes
    home after 128 turns, as on the JAX mesh."""
    board = np.zeros((32, 32), np.uint8)
    for x, y in [(1, 0), (2, 1), (0, 2), (1, 2), (2, 2)]:
        board[y, x] = 255
    got = port_steps(port_mesh(shape), board, 4 * 32)
    np.testing.assert_array_equal(got, board)
    np.testing.assert_array_equal(got, ref_steps(shape, board, 4 * 32))


def test_one_turn_step_and_a_non_conway_rule():
    board = random_board(16, 16, seed=8)
    got = halo.sharded_step_fn(port_mesh((2, 4)), HIGHLIFE)(torch.from_numpy(board)).numpy()
    want = np.asarray(jhalo.sharded_step_fn(jmesh.make_mesh((2, 4)), J_HIGHLIFE)(board))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vector_step(board, birth=(3, 6), survive=(2, 3)))


@pytest.mark.parametrize("depth", [2, 5])
def test_wide_halos_equal_depth_one_and_the_reference(depth):
    board = random_board(64, 64, seed=32)
    mesh = port_mesh((2, 4))
    for n in (depth * 2, depth * 2 + 1):
        got = port_steps(mesh, board, n, halo_depth=depth)
        np.testing.assert_array_equal(got, port_steps(mesh, board, n))
        np.testing.assert_array_equal(got, ref_steps((2, 4), board, n, halo_depth=depth))


def test_output_keeps_sharding():
    """A ShardedBoard in, a ShardedBoard out, blocks on their slots."""
    mesh = port_mesh((4, 2))
    board = ShardedBoard.from_global(mesh, random_board(32, 32, seed=2))
    out = halo.sharded_step_n_fn(mesh)(board, 3)
    assert isinstance(out, ShardedBoard)
    assert out.sharding == halo.board_sharding(mesh)
    assert sorted(out.blocks) == mesh.local_slots()
    assert out.block_shape == (8, 16) and out.shape == (32, 32)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 12])
def test_best_mesh_shape_equals_the_reference(n_devices):
    for h in (8, 9, 16, 24, 64, 96, 512):
        for w in (8, 9, 16, 32, 64, 128, 512):
            try:
                want = jmesh.best_mesh_shape(n_devices, h, w)
            except ValueError as exc:
                with pytest.raises(ValueError, match="factorisation"):
                    pmesh.best_mesh_shape(n_devices, h, w)
                assert "factorisation" in str(exc)
                continue
            assert pmesh.best_mesh_shape(n_devices, h, w) == want


def test_exchanges_per_dispatch_equals_the_reference():
    for depth in range(1, 10):
        for n in range(0, 40):
            assert halo.exchanges_per_dispatch(n, depth) == jhalo.exchanges_per_dispatch(n, depth)


def test_indivisible_board_rejected():
    board = random_board(17, 8, seed=1)  # 17 rows do not divide over 8
    with pytest.raises(ValueError):
        jhalo.sharded_step_fn(jmesh.make_mesh((8, 1)))(board)
    with pytest.raises(ValueError):
        halo.sharded_step_fn(port_mesh((8, 1)))(torch.from_numpy(board))


def test_depth_past_the_block_refused_like_the_reference():
    board = random_board(16, 64, seed=3)  # (2, 4) mesh: blocks 8 x 16
    with pytest.raises(ValueError, match="exceeds the local block"):
        port_steps(port_mesh((2, 4)), board, 9, halo_depth=9)
    with pytest.raises(ValueError, match="exceeds the local block"):
        ref_steps((2, 4), board, 9, halo_depth=9)
    with pytest.raises(ValueError, match="halo_depth"):
        halo.sharded_step_n_fn(port_mesh((2, 4)), halo_depth=0)


def test_exchange_wraps_and_pads_like_the_reference():
    """``_exchange``'s k and pad forms on a (2, 4) mesh: every block's
    extended block is the torus window around it, the zero pad outside."""
    board = np.arange(16 * 32, dtype=np.int32).reshape(16, 32)
    mesh = port_mesh((2, 4))
    sharded = ShardedBoard.from_global(mesh, board)
    k, pad = 2, 1
    ext = halo._exchange(sharded.blocks, mesh, 0, pad=pad, k=k)
    ext = halo._exchange(ext, mesh, 1, pad=pad, k=k)
    for (i, j), e in ext.items():
        rows = np.arange(i * 8 - k, (i + 1) * 8 + k) % 16
        cols = np.arange(j * 8 - k, (j + 1) * 8 + k) % 32
        want = np.pad(board[np.ix_(rows, cols)], pad)
        np.testing.assert_array_equal(e.numpy(), want)


def test_engine_runs_sharded(tmp_path):
    """A full session with the mesh as the engine's step function: golden
    end to end, as the JAX package's engine on its mesh."""
    from gol_distributed_final_tpu_torch import FinalTurnComplete, Params, run
    from gol_distributed_final_tpu_torch.engine.controller import CLOSED
    from gol_distributed_final_tpu_torch.engine.engine import EngineConfig

    cfg = EngineConfig(step_n_fn=halo.make_engine_step(port_mesh((4, 2))), device="cpu")
    p = Params(turns=100, image_width=64, image_height=64)
    events = queue.Queue()
    run(p, events, engine_config=cfg, images_dir=REPO_ROOT / "images",
        out_dir=tmp_path / "out", tick_seconds=3600)
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


def test_virtual_cpu_devices_follow_the_variable(monkeypatch):
    """``device="cpu"`` offers GOL_TORCH_CPU_DEVICES slots, one without it;
    the default mesh is process-major over them."""
    from gol_distributed_final_tpu_torch.utils import cpumesh

    monkeypatch.delenv(cpumesh.ENV, raising=False)
    assert len(pmesh.local_devices("cpu")) == 1
    monkeypatch.setenv(cpumesh.ENV, "8")
    mesh = pmesh.make_mesh(device="cpu", height=64, width=64)
    assert mesh.grid == jmesh.make_mesh(height=64, width=64).devices.shape
    assert mesh.is_fully_local and len(mesh.local_slots()) == 8
    assert cpumesh.virtual_cpu_env(4) == {cpumesh.ENV: "4"}
    monkeypatch.setenv(cpumesh.ENV, "0")
    with pytest.raises(ValueError):
        pmesh.local_devices("cpu")


@pytest.mark.parametrize("device,want", [
    ("cuda", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda:2", ["cuda:2"]),
])
def test_a_rank_holds_every_card_or_the_one_it_names(monkeypatch, device, want):
    """On a host of four cards, ``device="cuda"`` gives the rank all four
    (one rank per host) and "cuda:N" that card alone (one rank per card);
    the host's cards are read without touching one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in pmesh.local_devices(device)] == want
