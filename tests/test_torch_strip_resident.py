"""The PyTorch port's resident strip on the CPU, held against the JAX
package's worker: the strip kernel's new outputs in its plain version (the
wire-tile dirty grid and the adler32 sums of the strip before and after a
batch), the fold of such sums into a state digest, a worker whose strip is
resident on its device (here ``device="cpu"``) against the JAX
``WorkerService`` over one script of requests, the sessions that keep a
numpy strip, and the ``worker.strip_corrupt`` fault on a device strip.

Inputs are made from a seed with numpy and fed to both packages.
Equality throughout, tolerance none: Game of Life and the digests are
integer-exact.
"""

import zlib

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.ops import sparse as jax_sparse
from gol_distributed_final_tpu.rpc import broker as jax_broker
from gol_distributed_final_tpu.rpc import integrity as jax_integrity
from gol_distributed_final_tpu.rpc import worker as jax_worker
from gol_distributed_final_tpu_torch.ops import strip_steps
from gol_distributed_final_tpu_torch.rpc import broker as port_broker
from gol_distributed_final_tpu_torch.rpc import faults as port_faults
from gol_distributed_final_tpu_torch.rpc import integrity as port_integrity
from gol_distributed_final_tpu_torch.rpc import worker as port_worker
from gol_distributed_final_tpu_torch.rpc.protocol import Request


def _soup(shape, seed, p=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < p, 255, 0).astype(np.uint8)


def _fold(sums, shape):
    """The digest of a uint8 array of ``shape`` from its two sums."""
    return port_integrity.state_hex(port_integrity.state_add_sums(
        port_integrity.state_new(), shape, np.uint8, *[int(v) for v in sums]))


# -- (a) the plain version's dirty grid and digest sums -----------------------


@pytest.mark.parametrize("attest", [False, True])
@pytest.mark.parametrize("h", ["k", 64, 65, 130])
@pytest.mark.parametrize("w", [64, 100, 256, 300])
@pytest.mark.parametrize("k", [1, 8, 32, 33])
def test_plain_dirty_grid_and_sums_equal_the_reference(k, w, h, attest):
    h = k if h == "k" else h
    padded = _soup((h + 2 * k, w), seed=k * 10000 + w * 10 + h)
    got = strip_steps.strip_steps_plain(torch.from_numpy(padded), k, h, attest)
    before, after = padded[k:k + h], got.strip.numpy()
    want = jax_sparse.dirty_tile_grid(before, after)
    assert got.dirty.dtype == torch.bool and np.array_equal(got.dirty.numpy(), want)
    if not attest:
        assert got.sums is None
        return
    assert _fold(got.sums[:2], before.shape) == jax_integrity.state_digest(before)
    assert _fold(got.sums[2:], after.shape) == jax_integrity.state_digest(after)


def test_plain_outputs_of_an_all_dead_strip_equal_the_reference():
    padded = np.zeros((130 + 16, 300), np.uint8)
    got = strip_steps.strip_steps_plain(torch.from_numpy(padded), 8, 130, True)
    assert not got.dirty.any()
    assert np.array_equal(got.dirty.numpy(),
                          jax_sparse.dirty_tile_grid(padded[8:-8], got.strip.numpy()))
    assert got.sums.tolist() == [0, 0, 0, 0]
    assert _fold(got.sums[2:], (130, 300)) == jax_integrity.state_digest(padded[8:-8])


def test_strip_batch_on_three_parts_equals_one_block():
    """The resident form on the CPU: halos and strip apart, the new strip
    written into the given buffer, equal to the padded block's batch."""
    padded = _soup((90 + 16, 200), seed=7)
    parts = [torch.from_numpy(padded[a:b].copy()) for a, b in ((0, 8), (8, 98), (98, 106))]
    into = strip_steps.batch_outputs(90, 200, 8, True, "cpu")
    before = strip_steps.plain_calls
    got = strip_steps.strip_batch(*parts, 8, True, into=into)
    want = strip_steps.strip_steps_plain(torch.from_numpy(padded), 8, 90, True)
    assert strip_steps.plain_calls == before + 1 and got is into
    for name in ("strip", "counts", "bands", "dirty", "sums", "edges"):
        assert torch.equal(getattr(got, name).long(), getattr(want, name).long()), name
    with pytest.raises(ValueError):  # the new strip over the old
        strip_steps.strip_batch(*parts, 8, True, into=into._replace(strip=parts[1]))
    with pytest.raises(ValueError):  # outputs of another shape
        strip_steps.strip_batch(*parts, 8, False, into=into)
    with pytest.raises(ValueError):
        strip_steps.strip_batch(parts[0], parts[1], parts[2][:4], 8)


def test_batch_counts_hold_under_threads():
    """The wrappers' counts under 16 threads stepping at once with a short
    switch interval: every call counted once."""
    import sys
    import threading

    block = torch.from_numpy(_soup((4 + 8, 64), seed=3))
    calls, threads = 40, 16
    before = strip_steps.plain_calls
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [strip_steps.strip_batch(
            block[:4], block[4:8], block[8:], 4) for _ in range(calls)]) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert strip_steps.plain_calls - before == calls * threads


# -- (b) the fold of byte sums into a state digest ----------------------------


@pytest.mark.parametrize("n", [0, 1, 5551, 5552, 5553, 65521, (1 << 20) + 7])
def test_sums_fold_equals_zlib_adler32(n):
    """Bytes of any value, after a random prior state, under a header of
    the array's shape: the fold of the two sums, reduced or not, is
    zlib.adler32 of the header and the bytes, as ``state_add`` folds
    them."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    prior = zlib.adler32(rng.bytes(int(rng.integers(1, 200))))
    shapes = [(n,)]
    for rows in (3, 7, 13):
        if n and n % rows == 0:
            shapes.append((rows, n // rows))
    for shape in shapes:
        arr = data.reshape(shape)
        sums = strip_steps.adler_sums_plain(torch.from_numpy(arr))
        want = zlib.adler32(arr.tobytes(), zlib.adler32(f"{shape}:|u1:".encode(), prior))
        assert want == jax_integrity.state_add(prior, arr)
        for extra in (0, 1, 97):  # the kernel's sums are only congruent
            s1, s2 = (int(v) + extra * strip_steps.MOD for v in sums)
            got = port_integrity.state_add_sums(prior, shape, np.uint8, s1, s2)
            assert got == want, (shape, extra)


# -- (c) a device-resident session against the JAX worker ---------------------


class _NoServer:
    def stop(self):
        pass


def _both(services, call):
    """``call(service)`` on the port and the reference service: both
    replies, or both error messages, which must agree."""
    out = []
    for svc in services:
        try:
            out.append(("ok", call(svc)))
        except ValueError as exc:
            out.append(("error", str(exc)))
    assert out[0][0] == out[1][0], out
    if out[0][0] == "error":
        assert out[0][1] == out[1][1]
    return out


def _same_reply(a, b):
    assert (a.worker, a.turns_completed) == (b.worker, b.turns_completed)
    assert a.counts == b.counts and a.digests == b.digests
    for name in ("edges", "dirty", "work_slice"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.fixture
def integrity_both(monkeypatch):
    def set_both(on):
        monkeypatch.setattr(port_integrity, "_enabled", on)
        monkeypatch.setattr(jax_integrity, "_enabled", on)
    return set_both


@pytest.mark.parametrize("integrity", [True, False])
def test_device_session_replies_equal_the_reference(monkeypatch, integrity_both, integrity):
    monkeypatch.setenv("GOL_WORKER_FUSED", "auto")
    integrity_both(integrity)
    board = _soup((96, 300), seed=41)
    s, e = 32, 64  # 32 x 300 = 9600 cells, past the gate
    services = (port_worker.WorkerService(_NoServer(), "cpu"),
                jax_worker.WorkerService(_NoServer()))
    port = services[0]

    def step(turn, k, worker=1, halos=None):
        h = np.concatenate([board[s - k:s], board[e:e + k]]) if halos is None else halos
        return lambda svc: svc.strip_step(Request(world=h, worker=worker, turns=k,
                                                  initial_turn=turn))

    def fetch(**kw):
        return lambda svc: svc.strip_fetch(Request(worker=1, **kw))

    def agree(call):
        (_, a), (_, b) = _both(services, call)
        _same_reply(a, b)
        return a

    assert _both(services, fetch())[0][0] == "error"  # before StripStart
    agree(lambda svc: svc.strip_start(Request(world=board[s:e], worker=1, initial_turn=5)))
    assert port._resident is not None and isinstance(port._strip, torch.Tensor)
    agree(step(5, 1))
    agree(step(6, 8))
    delta = agree(fetch(delta_base_turn=5))  # the anchor: a delta frame
    assert delta.dirty is not None and delta.dirty.any()
    agree(step(14, 8))
    agree(step(22, 8))
    agree(fetch())  # a full frame
    agree(fetch(delta_base_turn=3))  # a stale base: a full frame
    agree(step(30, 1))
    agree(fetch(delta_base_turn=30))  # a delta of one batch
    assert _both(services, step(99, 8))[0][0] == "error"  # lockstep
    assert _both(services, step(31, 8, worker=0))[0][0] == "error"  # index
    assert _both(services, step(31, 8, halos=board[:8]))[0][0] == "error"  # shape
    deep = step(31, 40, halos=np.zeros((80, 300), np.uint8))
    assert _both(services, deep)[0][0] == "error"  # deeper than the strip
    # a re-seed replaces the session wholesale, at another shape
    agree(lambda svc: svc.strip_start(Request(world=board[:40, :200], worker=1)))
    assert port._resident is not None and tuple(port._strip.shape) == (40, 200)
    halos = np.concatenate([board[-8:, :200], board[40:48, :200]])
    agree(step(0, 8, halos=halos))
    agree(fetch(delta_base_turn=0))
    assert isinstance(port._strip, torch.Tensor)


# -- (d) the sessions that keep a numpy strip ---------------------------------


@pytest.mark.parametrize("case", ["fused-off", "under-the-gate", "grid-tile"])
def test_sessions_off_the_device_keep_a_numpy_strip(monkeypatch, case):
    monkeypatch.setenv("GOL_WORKER_FUSED", "off" if case == "fused-off" else "auto")
    board = _soup((64, 128), seed=13)
    strip = board[:8, :64] if case == "under-the-gate" else board[16:48]
    assert (strip.size < port_worker.FUSED_STRIP_MIN_CELLS) == (case == "under-the-gate")
    start = Request(world=strip, worker=0, initial_turn=0,
                    **({"grid_rows": 2, "grid_cols": 2} if case == "grid-tile" else {}))
    services = (port_worker.WorkerService(_NoServer(), "cpu"),
                jax_worker.WorkerService(_NoServer()))
    for svc in services:
        svc.strip_start(start)
    assert services[0]._resident is None and isinstance(services[0]._strip, np.ndarray)
    k = 2
    if case == "grid-tile":
        th, tw = strip.shape
        halos = port_worker.pack_tile_blocks(
            [_soup(shape, seed=i) for i, shape in
             enumerate(port_worker.tile_halo_shapes(k, th, tw))])
    else:
        halos = _soup((2 * k, strip.shape[1]), seed=3)
    (_, a), (_, b) = _both(services, lambda svc: svc.strip_step(
        Request(world=halos, worker=0, turns=k, initial_turn=0)))
    _same_reply(a, b)
    assert isinstance(services[0]._strip, np.ndarray)


# -- the strip_corrupt fault on a device strip --------------------------------


def test_corrupt_fault_flips_the_same_byte_of_a_tensor_and_an_array():
    arr = _soup((20, 30), seed=5)
    tensor = torch.from_numpy(arr.copy())
    port_faults.configure("worker.strip_corrupt:corrupt:1:1234")
    try:
        port_faults.fault_point("worker.strip_corrupt", target=arr)
    finally:
        port_faults.configure(None)
    port_faults.configure("worker.strip_corrupt:corrupt:1:1234")
    try:
        port_faults.fault_point("worker.strip_corrupt", target=tensor)
    finally:
        port_faults.configure(None)
    orig = _soup((20, 30), seed=5).reshape(-1)
    assert np.array_equal(tensor.numpy(), arr)
    assert np.flatnonzero(arr.reshape(-1) != orig).tolist() == [1234 % 600]
    assert arr.reshape(-1)[1234 % 600] == orig[1234 % 600] ^ 0xFF


def _run(broker, addrs, board, turns, **kw):
    backend = broker.WorkersBackend(addrs, **kw)
    lost = []
    if hasattr(backend, "_mark_lost"):
        mark = backend._mark_lost
        backend._mark_lost = lambda client, reason: lost.append(reason) or mark(client, reason)
    try:
        res = backend.run(Request(world=board, turns=turns, threads=len(addrs),
                                  image_width=board.shape[1], image_height=board.shape[0]))
    finally:
        backend.close()
    return res, lost


def test_corrupted_device_strip_is_refused_and_rebuilt():
    """A port worker's strip, resident on its device, flipped in place on
    the 12th StripStep: W's pre-batch digest breaks the port broker's
    chain, the worker is quarantined, and the run ends on the board of a
    JAX workers run of the same soup."""
    board = _soup((96, 128), seed=29)  # strips of 32 x 128 cells, past the gate
    turns = 300
    kw = dict(wire="resident", halo_depth=4, sync_interval=32)
    jax_servers = [jax_worker.serve(0) for _ in range(3)]
    try:
        want, _ = _run(jax_broker, [f"127.0.0.1:{s.port}" for s, _ in jax_servers], board,
                       turns, **kw)
    finally:
        for server, _ in jax_servers:
            server.stop()
    servers = [port_worker.serve(0, device="cpu") for _ in range(3)]
    port_faults.configure("worker.strip_corrupt:corrupt:12:777")
    try:
        got, lost = _run(port_broker, [f"127.0.0.1:{s.port}" for s, _ in servers], board,
                         turns, rpc_deadline=2.0, probe_interval=0.2, **kw)
        assert all(isinstance(svc._strip, torch.Tensor) for _, svc in servers)
    finally:
        port_faults.configure(None)
        for server, _ in servers:
            server.stop()
    assert lost, "the corrupted strip was never refused"
    assert got.turns_completed == want.turns_completed == turns
    np.testing.assert_array_equal(got.world, want.world)
