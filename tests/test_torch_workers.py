"""The PyTorch port's resident worker on the CPU, held against the JAX
package's: the integrity digests, the strip batch in each of its modes
(the fused one through ``fused_strip_steps``, the strip kernel's plain
torch version here), the tile batch and its packing, the worker verbs'
lockstep and session errors, the fused routing and its gate, and the
worker's and the broker's CLI errors.

Inputs are made from a seed with numpy and fed to both packages.
Equality throughout, tolerance none: Game of Life is integer-exact.
"""

import numpy as np
import pytest

from gol_distributed_final_tpu.ops import fused as jax_fused
from gol_distributed_final_tpu.rpc import broker as jax_broker
from gol_distributed_final_tpu.rpc import integrity as jax_integrity
from gol_distributed_final_tpu.rpc import worker as jax_worker
from gol_distributed_final_tpu_torch.ops import fused as port_fused
from gol_distributed_final_tpu_torch.ops import strip_steps
from gol_distributed_final_tpu_torch.rpc import broker as port_broker
from gol_distributed_final_tpu_torch.rpc import integrity as port_integrity
from gol_distributed_final_tpu_torch.rpc import worker as port_worker
from gol_distributed_final_tpu_torch.rpc.protocol import Methods, Request

from oracle import vector_step


def _soup(shape, seed, p=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < p, 255, 0).astype(np.uint8)


# -- integrity digests -------------------------------------------------------


@pytest.mark.parametrize("arr", [
    np.zeros((0, 7), np.uint8),
    np.arange(12, dtype=np.uint8).reshape(3, 4),
    np.arange(12, dtype=np.int32).reshape(4, 3),
    _soup((200, 300), seed=1),  # past the 4 KiB fold chunk
    np.arange(10, dtype=np.int64)[::2],  # not contiguous
])
def test_state_and_array_digests_equal_the_reference(arr):
    for fn in ("state_digest", "array_digest"):
        assert getattr(port_integrity, fn)(arr) == getattr(jax_integrity, fn)(arr)
    p = port_integrity.state_add(port_integrity.state_new(), arr)
    j = jax_integrity.state_add(jax_integrity.state_new(), arr)
    assert p == j and port_integrity.state_hex(p) == jax_integrity.state_hex(j)


def test_rolled_state_digest_equals_the_reference():
    bands = [_soup((2 * r, 33), seed=r) for r in (3, 2, 1, 0)]
    p, j = port_integrity.state_new(), jax_integrity.state_new()
    for band in bands:
        p = port_integrity.state_add(p, band)
        j = jax_integrity.state_add(j, band)
    assert port_integrity.state_hex(p) == jax_integrity.state_hex(j)


# -- the fused strip batch: the strip kernel's plain version ------------------


@pytest.mark.parametrize("attest", [False, True])
@pytest.mark.parametrize("h", [1, 7, 64])
@pytest.mark.parametrize("w", [33, 64, 100])
@pytest.mark.parametrize("k", [1, 2, 8, 33])
def test_fused_strip_steps_equals_the_jax_program(k, w, h, attest):
    padded = _soup((h + 2 * k, w), seed=1000 * k + 10 * h + w)
    want = jax_fused.fused_strip_steps(padded, k, h, attest=attest)
    got = port_fused.fused_strip_steps(padded, k, h, attest=attest, device="cpu")
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert len(got[2]) == len(want[2])
    for (gt, gb), (wt, wb) in zip(got[2], want[2]):
        assert gt.shape == wt.shape and np.array_equal(gt, wt)
        assert gb.shape == wb.shape and np.array_equal(gb, wb)


def test_strip_steps_counts_its_cpu_batches_as_plain():
    block = _soup((20, 40), seed=3)
    import torch

    before = strip_steps.plain_calls, strip_steps.launches
    strip_steps.strip_steps(torch.from_numpy(block), 4, 12, attest=True)
    assert (strip_steps.plain_calls, strip_steps.launches) == (before[0] + 1, before[1])


def test_band_offsets_tile_the_flat_output():
    k, w = 5, 7
    offsets = strip_steps.band_offsets(k, w)
    assert [rows for *_, rows in offsets] == [8, 6, 4, 2, 0]
    end = offsets[-1][1] + offsets[-1][2] * w
    assert end == 2 * w * k * (k - 1)
    flat = np.arange(end, dtype=np.int64)
    pieces = [piece for pair in strip_steps.split_bands(flat, k, w) for piece in pair]
    assert np.array_equal(np.concatenate([p.ravel() for p in pieces]), flat)


@pytest.mark.parametrize("shape,k,h", [((10, 8), 4, 1), ((10, 8), 0, 10), ((12, 8), 2, 0)])
def test_strip_steps_refuses_a_block_of_the_wrong_shape(shape, k, h):
    import torch

    with pytest.raises(ValueError):
        strip_steps.strip_steps(torch.zeros(shape, dtype=torch.uint8), k, h)


# -- the strip batch in its three modes ---------------------------------------


def _oracle_strip(board, s, e, k):
    want = board.copy()
    counts = []
    for _ in range(k):
        want = vector_step(want)
        counts.append(int(np.count_nonzero(want[s:e])))
    return want[s:e], counts


def _strip_case(h, w, s, e, k, seed, p=0.4):
    board = _soup((h, w), seed, p)
    rows = np.arange(s - k, e + k) % h
    padded = board[rows]
    return board, padded[k:-k], padded[:k], padded[-k:]


@pytest.mark.parametrize("mode", ["dense", "skip", "fused"])
@pytest.mark.parametrize("k", [1, 4, 9])
@pytest.mark.parametrize("attest", [False, True])
def test_strip_step_batch_modes_equal_the_reference(mode, k, attest):
    board, strip, top, bottom = _strip_case(40, 48, 12, 30, k, seed=k)
    got = port_worker.strip_step_batch(strip, top, bottom, k, attest, mode=mode, device="cpu")
    want = jax_worker.strip_step_batch(strip, top, bottom, k, attest, mode=mode)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[2:] == want[2:]
    oracle, counts = _oracle_strip(board, 12, 30, k)
    assert np.array_equal(got[0], oracle) and got[1] == counts


def test_skip_mode_on_a_sparse_strip_equals_the_reference():
    """A glider in a dead block: the live window is a minority, the case
    the skip exists for (auto routes it there in both packages)."""
    board = np.zeros((64, 40), np.uint8)
    for y, x in ((30, 11), (31, 12), (32, 10), (32, 11), (32, 12)):
        board[y, x] = 255
    k = 6
    padded = board[np.arange(8 - k, 56 + k) % 64]
    args = (padded[k:-k], padded[:k], padded[-k:], k, True)
    auto = port_worker.strip_step_batch(*args, device="cpu")
    skip = port_worker.strip_step_batch(*args, mode="skip")
    want = jax_worker.strip_step_batch(*args)
    for got in (auto, skip):
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


@pytest.mark.parametrize("env,size,want_mode", [
    ("auto", "small", "dense"), ("auto", "big", "fused"), ("on", "small", "fused"),
    ("off", "big", "dense"), ("on", "sparse", "fused"), ("auto", "sparse", "skip"),
])
def test_fused_routing_follows_gol_worker_fused(monkeypatch, env, size, want_mode):
    """GOL_WORKER_FUSED routes as in the reference (here against the
    reference's 1 << 20 gate, which the port's measured value replaces)."""
    monkeypatch.setenv("GOL_WORKER_FUSED", env)
    monkeypatch.setattr(port_worker, "FUSED_STRIP_MIN_CELLS", 1 << 20)
    h, w = {"small": (16, 64), "big": (1024, 1024), "sparse": (64, 64)}[size]
    strip = _soup((h, w), seed=2, p=0.0 if size == "sparse" else 0.4)
    if size == "sparse":
        strip[30, 30:33] = 255
    k = 2
    top, bottom = _soup((k, w), seed=3), _soup((k, w), seed=4)
    if size == "sparse":
        top[:] = 0
        bottom[:] = 0
    seen = []
    for name in ("_strip_batch_skip", "_strip_batch_fused"):
        real = getattr(port_worker, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(port_worker, name, spy)
    got = port_worker.strip_step_batch(strip, top, bottom, k, device="cpu")
    mode = {"_strip_batch_skip": "skip", "_strip_batch_fused": "fused"}.get(
        seen[0] if seen else "", "dense")
    assert mode == want_mode
    want = jax_worker.strip_step_batch(strip, top, bottom, k, mode="dense")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("cells", [1 << 8, 1 << 10, 1 << 16, 1 << 20])
def test_fused_gate_is_the_cards_measured_value(monkeypatch, cells):
    """The port's own FUSED_STRIP_MIN_CELLS, measured on the card
    (chip_smoke.py's gate table): a strip of ``cells`` takes the fused
    path under GOL_WORKER_FUSED=auto exactly when it reaches the gate."""
    monkeypatch.setenv("GOL_WORKER_FUSED", "auto")
    gate = port_worker.FUSED_STRIP_MIN_CELLS
    assert gate == 1 << 10
    calls = []
    monkeypatch.setattr(port_worker, "_strip_batch_fused",
                        lambda *a, **kw: calls.append(1) or (a[0][1:-1], [0]))
    strip = np.full((max(1, cells // 1024), min(1024, cells)), 255, np.uint8)
    halo = np.full((1, strip.shape[1]), 255, np.uint8)
    port_worker.strip_step_batch(strip, halo, halo, 1, device="cpu")
    assert bool(calls) == (strip.size >= gate)


def test_fused_needs_a_card_unless_the_cpu_is_named(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    strip = _soup((8, 32), seed=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_worker.strip_step_batch(strip, strip[:1], strip[-1:], 1, mode="fused")


# -- the tile batch and its wire ----------------------------------------------


def _wrap_halos(board, s, e, x0, x1, k):
    h, w = board.shape

    def rs(a, b):
        return np.arange(a, b) % h

    def cs(a, b):
        return np.arange(a, b) % w

    return (
        board[np.ix_(rs(s - k, s), cs(x0, x1))],
        board[np.ix_(rs(e, e + k), cs(x0, x1))],
        board[np.ix_(rs(s, e), cs(x0 - k, x0))],
        board[np.ix_(rs(s, e), cs(x1, x1 + k))],
        board[np.ix_(rs(s - k, s), cs(x0 - k, x0))],
        board[np.ix_(rs(s - k, s), cs(x1, x1 + k))],
        board[np.ix_(rs(e, e + k), cs(x0 - k, x0))],
        board[np.ix_(rs(e, e + k), cs(x1, x1 + k))],
    )


@pytest.mark.parametrize("mode", ["auto", "dense", "skip"])
@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("attest", [False, True])
def test_tile_step_batch_equals_the_reference(mode, k, attest):
    board = _soup((30, 26), seed=k, p=0.4)
    s, e, x0, x1 = 8, 20, 6, 18
    halos = _wrap_halos(board, s, e, x0, x1, k)
    tile = board[s:e, x0:x1].copy()
    got = port_worker.tile_step_batch(tile, halos, k, attest, mode=mode)
    want = jax_worker.tile_step_batch(tile, halos, k, attest, mode=mode)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[2:] == want[2:]
    oracle = board.copy()
    for _ in range(k):
        oracle = vector_step(oracle)
    assert np.array_equal(got[0], oracle[s:e, x0:x1])


def test_tile_batch_refusals_equal_the_reference():
    tile = _soup((4, 5), seed=1)
    halos = _wrap_halos(_soup((12, 12), seed=2), 4, 8, 3, 8, 2)
    for args, kw in (((tile, halos, 5), {}), ((tile, halos, 2), {"mode": "fused"}),
                     ((tile, halos[:7] + (np.zeros((1, 1), np.uint8),), 2), {}),
                     ((tile, halos, 2), {"mode": "sideways"})):
        msgs = []
        for mod in (port_worker, jax_worker):
            with pytest.raises(ValueError) as exc:
                mod.tile_step_batch(*args, **kw)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("shapes", [[(3, 5)], [(1, 1), (2, 9), (8, 8)], [(4, 0), (7, 3)]])
def test_tile_packing_equals_the_reference(shapes):
    blocks = [_soup(sh, seed=i) for i, sh in enumerate(shapes)]
    buf = port_worker.pack_tile_blocks(blocks)
    assert np.array_equal(buf, jax_worker.pack_tile_blocks(blocks))
    back = port_worker.unpack_tile_blocks(buf, shapes)
    assert all(np.array_equal(a, b) for a, b in zip(back, blocks))
    for bad in (buf[:-1], np.concatenate([buf, np.zeros(1, np.uint8)])):
        if bad.size == buf.size:
            continue
        msgs = []
        for mod in (port_worker, jax_worker):
            with pytest.raises(ValueError) as exc:
                mod.unpack_tile_blocks(bad, shapes)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    assert port_worker.tile_halo_shapes(3, 7, 9) == jax_worker.tile_halo_shapes(3, 7, 9)
    assert port_worker.tile_edge_shapes(3, 7, 9) == jax_worker.tile_edge_shapes(3, 7, 9)


# -- the worker verbs ---------------------------------------------------------


class _NoServer:
    def stop(self):
        pass


def _both(services, call):
    """``call(service)`` on a port and a reference service: both results,
    or both error messages, which must agree."""
    out = []
    for svc in services:
        try:
            out.append(("ok", call(svc)))
        except ValueError as exc:
            out.append(("error", str(exc)))
    assert out[0][0] == out[1][0]
    if out[0][0] == "error":
        assert out[0][1] == out[1][1]
    return out


def test_worker_verbs_enforce_lockstep_and_session_as_the_reference():
    services = (port_worker.WorkerService(_NoServer(), "cpu"),
                jax_worker.WorkerService(_NoServer()))
    board = _soup((16, 24), seed=9)
    k = 2

    def step(turn, worker=0, halos=None, turns=k):
        h = board[np.r_[14:16, 0:2]] if halos is None else halos
        return lambda svc: svc.strip_step(Request(world=h, worker=worker, turns=turns,
                                                  initial_turn=turn))

    assert _both(services, step(0))[0][0] == "error"  # before StripStart
    assert _both(services, lambda svc: svc.strip_fetch(Request()))[0][0] == "error"
    _both(services, lambda svc: svc.strip_start(Request(world=board[0], worker=0)))
    for svc in services:
        svc.strip_start(Request(world=board[2:14], worker=1, initial_turn=5))
    assert _both(services, step(4, worker=1))[0][0] == "error"  # lockstep
    assert _both(services, step(5, worker=0))[0][0] == "error"  # index
    assert _both(services, step(5, worker=1, halos=board[:3]))[0][0] == "error"  # shape
    # deeper than the strip
    deep = step(5, worker=1, halos=np.zeros((26, 24), np.uint8), turns=13)
    assert _both(services, deep)[0][0] == "error"
    ok = _both(services, step(5, worker=1, halos=np.concatenate([board[:2], board[14:16]])))
    (_, p), (_, j) = ok
    assert p.turns_completed == j.turns_completed == 7
    assert np.array_equal(p.edges, j.edges) and p.counts == j.counts
    assert p.digests == j.digests and np.array_equal(p.dirty, j.dirty)
    full = _both(services, lambda svc: svc.strip_fetch(Request(worker=1)))
    assert np.array_equal(full[0][1].work_slice, full[1][1].work_slice)
    delta = _both(services, lambda svc: svc.strip_fetch(Request(worker=1, delta_base_turn=7)))
    assert np.array_equal(delta[0][1].dirty, delta[1][1].dirty)
    # a tile session: packed halos of the wrong length, and no depth
    for svc in services:
        svc.strip_start(Request(world=board[:8, :8], worker=0, grid_rows=2, grid_cols=3))
    for turns in (2, 0):
        bad = _both(services, lambda svc: svc.strip_step(
            Request(world=np.zeros(5, np.uint8), worker=0, turns=turns)))
        assert bad[0][0] == "error"


def test_update_verb_equals_the_reference():
    board = _soup((20, 30), seed=4)
    for req in (Request(world=board, start_y=5, end_y=11),
                Request(world=board[np.arange(4, 12) % 20], start_y=-1)):
        got = port_worker.WorkerService(_NoServer(), "cpu").update(req).work_slice
        want = jax_worker.WorkerService(_NoServer()).update(req).work_slice
        assert np.array_equal(got, want)


def test_worker_serves_every_verb_but_status():
    """Every verb of the reference worker, Status included since this port
    has obs/."""
    server, service = port_worker.serve(0, device="cpu")
    try:
        names = set(server._methods)
    finally:
        server.stop()
    assert names == {Methods.WORKER_UPDATE, Methods.WORKER_QUIT, Methods.STRIP_START,
                     Methods.STRIP_STEP, Methods.STRIP_FETCH, Methods.WORKER_STATUS}
    ref_server, _ = jax_worker.serve(0)
    try:
        assert names == set(ref_server._methods)
    finally:
        ref_server.stop()
    assert service.device.type == "cpu"


# -- CLI errors ----------------------------------------------------------------


def _cli_error(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    err = capsys.readouterr().err
    assert "Traceback" not in err
    return exc.value.code, err[err.index("error: ") + len("error: "):].strip()


@pytest.mark.parametrize("argv", [
    ["-integrity", "maybe"], ["-port", "x"], ["-bogus"], ["-port", "0", "extra"],
])
def test_worker_cli_errors_equal_the_reference(argv, capsys):
    got = _cli_error(port_worker.main, [*argv, "-device", "cpu"], capsys)
    want = _cli_error(jax_worker.main, argv, capsys)
    assert got == want


@pytest.mark.parametrize("flag", ["-metrics", "-timeline", "-trace", "-journal", "-profile"])
def test_worker_cli_refuses_what_is_not_ported(flag, capsys, monkeypatch, tmp_path):
    """The observability flags were refused before this port had obs/;
    now the port worker takes each as the reference worker does: it
    serves, and the flag's layer is on."""
    import importlib
    import threading

    from torch_obs_state import reset_both

    monkeypatch.chdir(tmp_path)  # -journal and -profile write under out/
    enabled = []
    for mod, extra, root in ((port_worker, ["-device", "cpu"], "gol_distributed_final_tpu_torch"),
                             (jax_worker, [], "gol_distributed_final_tpu")):
        def fake_serve(*args, **kwargs):
            service = type("Stopped", (), {"quit_event": threading.Event()})()
            service.quit_event.set()
            return type("Bound", (), {"port": 0})(), service

        monkeypatch.setattr(mod, "serve", fake_serve)
        try:
            mod.main([flag, "-port", "0", *extra])
            obs = {name: importlib.import_module(f"{root}.obs.{name}")
                   for name in ("metrics", "tracing", "timeline", "journal", "profiler")}
            enabled.append({
                "metrics": obs["metrics"].enabled(),
                "trace": obs["tracing"].enabled(),
                "timeline": obs["timeline"].enabled(),
            })
        finally:
            reset_both()
    assert enabled[0] == enabled[1]
    assert "error" not in capsys.readouterr().err


def test_worker_cli_needs_a_card_by_default(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, err = _cli_error(port_worker.main, ["-port", "0"], capsys)
    assert code == 2 and "no CUDA device" in err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_worker.serve(0)


@pytest.mark.parametrize("argv", [
    ["-backend", "workers", "-halo-depth", "2"],
    ["-backend", "workers", "-wire", "full", "-halo-depth", "3"],
    ["-halo-depth", "0"],
    ["-backend", "workers", "-wire", "resident", "-halo-depth", "-1"],
    ["-sync-interval", "8"],
    ["-backend", "workers", "-wire", "resident", "-sync-interval", "-1"],
    ["-sparse-sync", "off"],
    ["-grid", "2x2"],
    ["-backend", "workers", "-wire", "resident", "-grid", "0x2"],
    ["-backend", "workers", "-wire", "resident", "-grid", "wide"],
    ["-backend", "workers", "-rpc-deadline", "-1"],
    ["-rpc-deadline", "2"],
    ["-backend", "workers", "-probe-interval", "0"],
    ["-auto-checkpoint", "1"],
    ["-backend", "workers", "-auto-checkpoint", "1", "a", "b"],
    ["-backend", "workers", "-auto-checkpoint", "soon"],
    ["-backend", "workers", "-auto-checkpoint", "-1"],
    ["-backend", "workers", "-ckpt-keep", "0"],
    ["-ckpt-keep", "3"],
    ["-session-capacity", "0"],
    ["-wire", "sideways"],
    ["-backend", "cluster"],
])
def test_broker_cli_errors_equal_the_reference(argv, capsys):
    got = _cli_error(port_broker.main, [*argv, "-port", "0", "-device", "cpu"], capsys)
    want = _cli_error(jax_broker.main, [*argv, "-port", "0"], capsys)
    assert got == want


def test_workers_broker_needs_no_card(monkeypatch):
    """The workers backend holds no board on a device: a workers broker
    starts on a host without a card, with no -device."""
    import threading

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = {}
    real_serve = port_broker.serve

    def capture(*args, **kwargs):
        server, service = real_serve(*args, **kwargs)
        started["service"] = service
        threading.Timer(0.05, service.shutdown).start()
        return server, service

    monkeypatch.setattr(port_broker, "serve", capture)
    port_broker.main(["-backend", "workers", "-port", "0", "-probe-interval", "5"])
    assert isinstance(started["service"].backend, port_broker.WorkersBackend)


def test_halo_depth_is_a_no_op_on_the_device_backend():
    from gol_distributed_final_tpu_torch import Params
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

    server, service = port_broker.serve(port=0, device="cpu", halo_depth=8)
    remote = RemoteBroker(f"127.0.0.1:{server.port}")
    try:
        board = _soup((64, 64), seed=12)
        res = remote.run(Params(turns=30, image_width=64, image_height=64), board, halo_depth=8)
    finally:
        remote.close()
        service.shutdown()
    want = board
    for _ in range(30):
        want = vector_step(want)
    assert res.turns_completed == 30 and np.array_equal(res.world, want)
    with pytest.raises(ValueError, match="halo_depth must be >= 1"):
        port_broker.DeviceBackend("cpu", halo_depth=0)
