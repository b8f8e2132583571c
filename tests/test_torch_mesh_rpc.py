"""The port broker's mesh path (rpc/broker.py ``DeviceBackend``) against
the JAX package's ``TpuBackend`` on eight devices: virtual CPU devices
for the port (GOL_TORCH_CPU_DEVICES=8), the virtual mesh for the JAX side.
Mirrors tests/test_rpc.py:141-230.
"""

import numpy as np
import pytest

from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.ops import tiled
from gol_distributed_final_tpu_torch.ops.plane import BytePlane
from gol_distributed_final_tpu_torch.parallel.bit_halo import ShardedBitPlane
from gol_distributed_final_tpu_torch.rpc import broker as port_broker
from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker
from gol_distributed_final_tpu_torch.rpc.protocol import Request
from gol_distributed_final_tpu_torch.utils import cpumesh

from helpers import REPO_ROOT
from test_torch_rpc import _Proc


def _golden(size, turns=100):
    return (REPO_ROOT / "check" / "images" / f"{size}x{size}x{turns}.pgm").read_bytes()


def _session(address, size, tmp_path):
    remote = RemoteBroker(address)
    try:
        run(Params(turns=100, threads=8, image_width=size, image_height=size),
            broker=remote, images_dir=REPO_ROOT / "images", out_dir=tmp_path / "out",
            tick_seconds=3600.0)
    finally:
        remote.close()
    return (tmp_path / "out" / f"{size}x{size}x100.pgm").read_bytes()


def test_mesh_broker_with_wide_halos_is_golden(tmp_path, monkeypatch):
    """A port broker that sees eight CPU devices, started with -halo-depth
    2, serves -server sessions golden-exact: 512^2 rides the packed wide
    plane (blocks (8, 128) words over (2, 4)), 64^2 falls back to the byte
    wide plane (its packed blocks, (1, 16) words, are too shallow)."""
    monkeypatch.setenv(cpumesh.ENV, "8")
    proc = _Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker", "-port", "0",
                  "-device", "cpu", "-halo-depth", "2"])
    try:
        line = proc.wait_for("broker listening on :")
        address = f"127.0.0.1:{int(line.rsplit(':', 1)[1].split()[0])}"
        for size in (512, 64):
            assert _session(address, size, tmp_path) == _golden(size), size
    finally:
        proc.stop()


def test_mesh_planes_chosen_like_the_reference(monkeypatch):
    """With eight devices the backend builds the reference's planes: the
    packed mesh plane (its blocks on the tiled kernel's plain version
    here) where a packed layout carries the depth, the byte mesh plane
    where only cells do; the per-request depth overrides the server's."""
    from gol_distributed_final_tpu.rpc.broker import TpuBackend
    from gol_distributed_final_tpu_torch.models import CONWAY
    from gol_distributed_final_tpu.models import CONWAY as J_CONWAY

    monkeypatch.setenv(cpumesh.ENV, "8")
    backend = port_broker.DeviceBackend("cpu", halo_depth=1)
    ref = TpuBackend(halo_depth=1)
    for (h, w, depth) in ((512, 512, 1), (512, 512, 2), (64, 64, 1), (64, 64, 2), (16, 16, 1)):
        got = backend._plane_for(h, w, CONWAY, depth)
        want = ref._plane_for(h, w, J_CONWAY, depth)
        assert type(got).__name__ == type(want).__name__, (h, w, depth)
        if isinstance(got, ShardedBitPlane):
            assert (got.word_axis, got.halo_depth, got.mesh.grid) == (
                want.word_axis, want.halo_depth,
                (want.mesh.shape["rows"], want.mesh.shape["cols"]))
    assert isinstance(backend._plane_for(64, 64, CONWAY, 2), BytePlane)
    board = read_pgm(REPO_ROOT / "images" / "512x512.pgm")
    # chunks of 4 turns, whatever the host's speed: two exchanges a chunk
    backend.engine.config.min_chunk = backend.engine.config.max_chunk = 4
    tiled.reset_counts()
    res = backend.run(Request(world=board, turns=100, image_width=512, image_height=512,
                              halo_depth=2))
    # one call a block an exchange: 50 two-turn ones, half depth 1's 800
    assert tiled.plain_calls == 8 * 50
    np.testing.assert_array_equal(res.world, read_pgm(REPO_ROOT / "check" / "images"
                                                      / "512x512x100.pgm"))
    assert backend.retrieve(include_world=False).alive_count == int(np.count_nonzero(res.world))


def test_request_halo_depth_rides_the_wire(tmp_path, monkeypatch):
    """A depth-1 mesh broker serves a request that asks for depth 2
    (Request.halo_depth; 0 means the server's default) golden-exact."""
    monkeypatch.setenv(cpumesh.ENV, "8")
    server, service = port_broker.serve(port=0, device="cpu")
    try:
        remote = RemoteBroker(f"127.0.0.1:{server.port}")
        try:
            board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
            res = remote.run(Params(turns=100, image_width=64, image_height=64), board,
                             halo_depth=2)
        finally:
            remote.close()
        np.testing.assert_array_equal(
            res.world, read_pgm(REPO_ROOT / "check" / "images" / "64x64x100.pgm"))
        assert (64, 64, "B3/S23", 2) in service.backend._planes
    finally:
        service.shutdown()


def test_halo_depth_vacuous_on_one_device_but_refused_when_too_deep(monkeypatch):
    """No mesh (one device, or a board no factorisation divides): no
    halos, the knob is vacuous. A built mesh that no plane can carry at
    the depth: refused with the reference's message."""
    from gol_distributed_final_tpu.rpc.broker import TpuBackend
    from gol_distributed_final_tpu.rpc.protocol import Request as JRequest

    board = read_pgm(REPO_ROOT / "images" / "16x16.pgm")
    req = Request(world=board, turns=4, image_width=16, image_height=16)
    monkeypatch.delenv(cpumesh.ENV, raising=False)
    assert port_broker.DeviceBackend("cpu", halo_depth=2).run(req).turns_completed == 4
    monkeypatch.setenv(cpumesh.ENV, "8")
    odd = np.zeros((17, 17), np.uint8)
    res = port_broker.DeviceBackend("cpu", halo_depth=2).run(
        Request(world=odd, turns=2, image_width=17, image_height=17))
    assert res.turns_completed == 2
    with pytest.raises(ValueError, match="cannot be honored") as mine:
        port_broker.DeviceBackend("cpu", halo_depth=16).run(req)
    with pytest.raises(ValueError, match="cannot be honored") as theirs:
        TpuBackend(halo_depth=16).run(
            JRequest(world=board, turns=4, image_width=16, image_height=16))
    assert str(mine.value) == str(theirs.value)
