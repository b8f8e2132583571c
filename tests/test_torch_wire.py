"""The PyTorch port's workers backend over RPC on the CPU, held against the
JAX package's: clusters of in-process workers (``device="cpu"``) in the
four pairings of a port or reference broker over port or reference
workers, on every wire (``full``, ``haloed``, ``resident`` with K in
{1, 4}), on 2-D grids (``2x2`` and ``auto``) and with ``-sparse-sync`` on
and off; controller sessions through a workers broker against the golden
fixtures, in process and through the CLIs; a worker killed mid-run;
auto-checkpoints byte-equal to the reference broker's and resumed across
the packages; and the fast chaos scenarios (a wedged worker paid for with
one deadline and readmitted, a flipped sidecar bit caught and rebuilt).

Every board is held against the numpy oracle, every alive sample against
the oracle's count at its turn. Every socket wait, join and subprocess has
a timeout. Equality throughout, tolerance none.
"""

import queue
import threading
import time

import numpy as np
import pytest

from gol_distributed_final_tpu.rpc import broker as jax_broker
from gol_distributed_final_tpu.rpc import worker as jax_worker
from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.engine import checkpoint as port_ckpt
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.rpc import broker as port_broker
from gol_distributed_final_tpu_torch.rpc import worker as port_worker
from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker
from gol_distributed_final_tpu_torch.rpc.faults import ChaosProxy
from gol_distributed_final_tpu_torch.rpc.protocol import Methods, Request

from helpers import REPO_ROOT, read_alive_counts
from oracle import vector_step

TIMEOUT = 120
BROKERS = {"port": port_broker, "ref": jax_broker}


def _soup(shape, seed, p=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < p, 255, 0).astype(np.uint8)


def _oracle(board, turns):
    """The board and its alive count after each of ``turns`` turns."""
    counts = {0: int(np.count_nonzero(board))}
    for t in range(1, turns + 1):
        board = vector_step(board)
        counts[t] = int(np.count_nonzero(board))
    return board, counts


def _serve_workers(kind, n):
    if kind == "port":
        return [port_worker.serve(0, device="cpu") for _ in range(n)]
    return [jax_worker.serve(0) for _ in range(n)]


def _stop(servers):
    for server, _service in servers:
        server.stop()


@pytest.fixture(scope="module")
def clusters():
    """Four port workers and four reference workers, in this process."""
    made = {kind: _serve_workers(kind, 4) for kind in ("port", "ref")}
    yield {kind: [f"127.0.0.1:{s.port}" for s, _ in servers]
           for kind, servers in made.items()}
    for servers in made.values():
        _stop(servers)


def _run(broker, addrs, board, turns, **kw):
    """One run of a workers backend of ``broker`` over ``addrs``: the
    result and every alive sample the backend recorded."""
    backend = broker.WorkersBackend(addrs, **kw)
    samples = []
    record = backend._record_alive

    def spy(turn, count):
        samples.append((turn, count))
        record(turn, count)

    backend._record_alive = spy
    try:
        res = backend.run(Request(world=board, turns=turns, threads=len(addrs),
                                  image_width=board.shape[1], image_height=board.shape[0]))
    finally:
        backend.close()
    return res, samples


_WIRES = {
    "full": dict(wire="full"),
    "haloed": dict(wire="haloed"),
    "resident-k1": dict(wire="resident", halo_depth=1, sync_interval=16),
    "resident-k4": dict(wire="resident", halo_depth=4, sync_interval=16),
    "resident-k4-sparse-off": dict(wire="resident", halo_depth=4, sync_interval=16,
                                   sparse_sync=False),
    "grid-2x2": dict(wire="resident", halo_depth=4, sync_interval=16, grid="2x2"),
    "grid-2x2-sparse-off": dict(wire="resident", halo_depth=3, sync_interval=16,
                                grid="2x2", sparse_sync=False),
    "grid-auto": dict(wire="resident", halo_depth=3, sync_interval=16, grid="auto"),
}


@pytest.mark.parametrize("wire", list(_WIRES))
@pytest.mark.parametrize("broker,workers", [
    ("port", "port"), ("port", "ref"), ("ref", "port"), ("ref", "ref"),
])
def test_cluster_pairings_are_bit_identical(clusters, broker, workers, wire):
    board = _soup((40, 48), seed=len(wire))
    turns = 60
    want, counts = _oracle(board, turns)
    res, samples = _run(BROKERS[broker], clusters[workers], board, turns, **_WIRES[wire])
    assert res.turns_completed == turns
    np.testing.assert_array_equal(res.world, want)
    assert samples and samples[-1][0] == turns
    assert [c for _, c in samples] == [counts[t] for t, _ in samples]


def test_mixed_roster_of_port_and_reference_workers(clusters):
    """One broker over two port and two reference workers at once, on a
    2-D grid: the wire is the same whichever package serves a tile."""
    board = _soup((36, 36), seed=3)
    addrs = [clusters["port"][0], clusters["ref"][0], clusters["port"][1], clusters["ref"][1]]
    want, counts = _oracle(board, 50)
    for broker in BROKERS.values():
        res, samples = _run(broker, addrs, board, 50, wire="resident", halo_depth=4,
                            sync_interval=8, grid="2x2")
        np.testing.assert_array_equal(res.world, want)
        assert [c for _, c in samples] == [counts[t] for t, _ in samples]


def _workers_broker(addrs, **kw):
    kw.setdefault("wire", "resident")
    kw.setdefault("halo_depth", 8)
    server, service = port_broker.serve(port=0, backend="workers", worker_addresses=addrs,
                                        device="cpu", **kw)
    return f"127.0.0.1:{server.port}", service


@pytest.mark.parametrize("controller", ["port", "ref"])
def test_controller_session_through_a_port_workers_broker_is_golden(clusters, controller,
                                                                     tmp_path):
    """The 64^2 x 100 controller session, over a port workers broker on the
    resident wire at K = 8, driven by the port's controller and by the
    reference's: the golden PGM, and every tick equal to check/alive."""
    addr, service = _workers_broker(clusters["port"])
    events = queue.Queue()
    try:
        if controller == "port":
            remote = RemoteBroker(addr)
            try:
                result = run(Params(turns=100, image_width=64, image_height=64), events,
                             broker=remote, images_dir=REPO_ROOT / "images",
                             out_dir=tmp_path, tick_seconds=0.05)
            finally:
                remote.close()
        else:
            import gol_distributed_final_tpu as jax_pkg
            from gol_distributed_final_tpu.rpc.client import RemoteBroker as JaxRemote

            remote = JaxRemote(addr)
            try:
                result = jax_pkg.run(
                    jax_pkg.Params(turns=100, image_width=64, image_height=64), events,
                    broker=remote, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
                    tick_seconds=0.05)
            finally:
                remote.close()
    finally:
        service.shutdown()
    name = "64x64x100.pgm"
    assert result.turns_completed == 100
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()
    golden = read_alive_counts(REPO_ROOT / "check" / "alive" / "64x64.csv")
    ticks = []
    while not events.empty():
        ev = events.get_nowait()
        if type(ev).__name__ == "AliveCellsCount":
            ticks.append((ev.completed_turns, ev.cells_count))
    for turn, count in ticks:
        assert count == (2819 if turn == 0 else golden[turn]), (turn, count)


def test_port_controller_over_a_reference_workers_broker_of_port_workers(clusters, tmp_path):
    server, service = jax_broker.serve(port=0, backend="workers",
                                       worker_addresses=clusters["port"], wire="resident",
                                       halo_depth=8, grid="auto")
    remote = RemoteBroker(f"127.0.0.1:{server.port}")
    try:
        result = run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                     broker=remote, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
                     tick_seconds=3600)
    finally:
        remote.close()
        service.backend.close()
        server.stop()
    name = "64x64x100.pgm"
    assert result.turns_completed == 100
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()


def test_snapshot_pause_and_quit_on_the_resident_wire(clusters):
    """A Retrieve mid-run syncs the resident strips (the board served is
    the oracle at its turn), Pause parks the loop with the board current,
    and Quit ends the run at a committed turn."""
    board = _soup((48, 48), seed=17)
    backend = port_broker.WorkersBackend(clusters["port"], wire="resident", halo_depth=4,
                                         sync_interval=0)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=backend.run(Request(
        world=board, turns=10 ** 6, threads=4, image_width=48, image_height=48))))
    t.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        while backend.retrieve(include_world=False).turns_completed < 40:
            assert time.monotonic() < deadline, "the run never got going"
            time.sleep(0.005)
        snap = backend.retrieve(include_world=True)
        want, counts = _oracle(board, snap.turns_completed)
        np.testing.assert_array_equal(snap.world, want)
        assert snap.alive_count == counts[snap.turns_completed]
        backend.pause()
        parked = backend.retrieve(include_world=True)
        time.sleep(0.05)
        assert backend.retrieve(include_world=False).turns_completed == parked.turns_completed
        np.testing.assert_array_equal(parked.world, _oracle(board, parked.turns_completed)[0])
        backend.pause()
        backend.quit()
        t.join(TIMEOUT)
        assert not t.is_alive()
        np.testing.assert_array_equal(out["r"].world, _oracle(board, out["r"].turns_completed)[0])
    finally:
        if t.is_alive():
            backend.quit()
            t.join(TIMEOUT)
        backend.close()


def test_grid_refusals_equal_the_reference(clusters):
    from gol_distributed_final_tpu_torch.rpc.client import RpcError

    board = _soup((6, 6), seed=2)
    for grid, reason in (("8x1", "grid_unsatisfiable"), ("3x2", "grid_roster")):
        msgs = []
        for broker, err in ((port_broker, RpcError),
                            (jax_broker, jax_broker.RpcError)):
            backend = broker.WorkersBackend(clusters["port"][:4], wire="resident", grid=grid)
            try:
                with pytest.raises(err) as exc:
                    backend.run(Request(world=board if grid == "8x1" else
                                        np.zeros((4, 4), np.uint8),
                                        turns=3, image_width=6, image_height=6))
            finally:
                backend.close()
            msgs.append((str(exc.value), exc.value.reason))
        assert msgs[0] == msgs[1] and msgs[0][1] == reason
    for bad in ("9", "0x0", "ax2"):
        with pytest.raises(ValueError) as p:
            port_broker.parse_grid(bad)
        with pytest.raises(ValueError) as j:
            jax_broker.parse_grid(bad)
        assert str(p.value) == str(j.value)
    for n, h, w in ((4, 64, 64), (6, 10, 40), (8, 4, 100), (3, 1, 1)):
        assert port_broker._auto_grid(n, h, w) == jax_broker._auto_grid(n, h, w)


def test_a_non_conway_rule_and_halo_depth_refuse_as_the_reference(clusters):
    from gol_distributed_final_tpu_torch.rpc.client import RpcError

    board = _soup((8, 8), seed=1)
    for kw, req_kw in ((dict(wire="haloed"), dict(halo_depth=2)),
                       (dict(wire="resident"), dict(rulestring="B36/S23"))):
        msgs = []
        for broker, err in ((port_broker, RpcError), (jax_broker, jax_broker.RpcError)):
            backend = broker.WorkersBackend(clusters["port"][:1], **kw)
            try:
                with pytest.raises(err) as exc:
                    backend.run(Request(world=board, turns=2, image_width=8, image_height=8,
                                        **req_kw))
            finally:
                backend.close()
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


# -- loss, recovery and chaos --------------------------------------------------


@pytest.mark.parametrize("broker,workers", [("port", "port"), ("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("grid", [None, "2x2"])
def test_worker_killed_mid_run_recovers_bit_identical(grid, broker, workers):
    """One worker cut off mid-run (its proxy drops every frame from then
    on, as a killed process would): the broker marks it lost, rebuilds the
    board at the committed turn (survivor fetches and the workers' own
    kernel recomputed locally from the last sync), reseeds over the
    survivors, and the final board is the oracle's, whichever package
    serves the broker and the workers."""
    servers = _serve_workers(workers, 4 if grid else 3)
    proxy = ChaosProxy(f"127.0.0.1:{servers[1][0].port}")
    addrs = [f"127.0.0.1:{s.port}" for s, _ in servers]
    addrs[1] = proxy.address
    board = _soup((48, 48), seed=11)
    turns = 1500
    backend = BROKERS[broker].WorkersBackend(addrs, wire="resident", halo_depth=4,
                                             sync_interval=64, rpc_deadline=2.0,
                                             probe_interval=0.2, grid=grid)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=backend.run(Request(
        world=board, turns=turns, threads=len(addrs), image_width=48, image_height=48))))
    t.start()
    try:
        deadline = time.monotonic() + 60
        while backend.retrieve(include_world=False).turns_completed < 150:
            assert time.monotonic() < deadline, "the run never got going"
            time.sleep(0.002)
        proxy.set_fault(drop_after=0)  # mid-batch loss
        t.join(TIMEOUT)
        assert not t.is_alive(), "the run hung after the loss"
        assert out["r"].turns_completed == turns
        np.testing.assert_array_equal(out["r"].world, _oracle(board, turns)[0])
        with backend._lock:
            assert addrs[1] in backend._lost
    finally:
        if t.is_alive():
            backend.quit()
            t.join(TIMEOUT)
        backend.close()
        proxy.close()
        _stop(servers)


def test_wedged_worker_costs_one_deadline_then_is_readmitted():
    """A worker behind a proxy that stops forwarding (alive but silent) is
    lost after one -rpc-deadline; once the path is clear the probe
    readmits it and the run goes on over the whole roster; the board the
    run ends on (after a Quit) is the oracle's at its turn."""
    servers = _serve_workers("port", 3)
    proxy = ChaosProxy(f"127.0.0.1:{servers[1][0].port}", wedge_after=30)
    addrs = [f"127.0.0.1:{servers[0][0].port}", proxy.address,
             f"127.0.0.1:{servers[2][0].port}"]
    board = _soup((48, 48), seed=5)
    backend = port_broker.WorkersBackend(addrs, wire="resident", halo_depth=4,
                                         sync_interval=32, rpc_deadline=1.0,
                                         probe_interval=0.1)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=backend.run(Request(
        world=board, turns=10 ** 7, threads=3, image_width=48, image_height=48))))
    t.start()

    def wait(cond, what):
        deadline = time.monotonic() + 60
        while not cond():
            assert t.is_alive() and time.monotonic() < deadline, what
            time.sleep(0.01)

    def roster(addr):
        with backend._lock:
            return addr in backend._lost, addr in backend._client_addr.values()

    try:
        wait(lambda: roster(proxy.address)[0], "the wedge was never paid for")
        proxy.set_fault(wedge_after=None)
        wait(lambda: roster(proxy.address)[1], "the worker was never readmitted")
        turn = backend.retrieve(include_world=False).turns_completed
        wait(lambda: backend.retrieve(include_world=False).turns_completed >= turn + 40,
             "the run stopped after the readmission")
        backend.quit()
        t.join(TIMEOUT)
        assert not t.is_alive()
        res = out["r"]
        np.testing.assert_array_equal(res.world, _oracle(board, res.turns_completed)[0])
    finally:
        if t.is_alive():
            backend.quit()
            t.join(TIMEOUT)
        backend.close()
        proxy.close()
        _stop(servers)


@pytest.mark.parametrize("workers", ["port", "ref"])
def test_flipped_sidecar_bit_is_caught_and_rebuilt(workers):
    """One bit flipped inside an out-of-band ndarray sidecar on the
    resident wire: the checked frame refuses to parse, the worker is
    quarantined as lost, the board is rebuilt from the last verified
    sync, and the run ends on the oracle."""
    servers = _serve_workers(workers, 3)
    proxy = ChaosProxy(f"127.0.0.1:{servers[1][0].port}", seed=7, corrupt_sidecar=20)
    addrs = [f"127.0.0.1:{servers[0][0].port}", proxy.address,
             f"127.0.0.1:{servers[2][0].port}"]
    # 128 columns: the halo and edge frames carry 1 KiB sidecars
    board = _soup((96, 128), seed=23)
    turns = 400
    backend = port_broker.WorkersBackend(addrs, wire="resident", halo_depth=4,
                                         sync_interval=64, rpc_deadline=2.0,
                                         probe_interval=0.2)
    lost = []
    mark = backend._mark_lost
    backend._mark_lost = lambda client, reason: lost.append(reason) or mark(client, reason)
    try:
        res = backend.run(Request(world=board, turns=turns, threads=3,
                                  image_width=128, image_height=96))
    finally:
        backend.close()
        proxy.close()
        _stop(servers)
    assert res.turns_completed == turns
    np.testing.assert_array_equal(res.world, _oracle(board, turns)[0])
    assert lost, "the sidecar flip was never caught"


@pytest.mark.parametrize("broker", ["port", "ref"])
def test_corrupted_resident_strip_is_caught_by_the_digest_chain(broker):
    """A port worker's resident strip flipped in place (the
    worker.strip_corrupt fault point): the next StripStep's pre-digest
    breaks the broker's chain, the worker is quarantined, and the run
    ends on the oracle, under a port or a reference broker."""
    from gol_distributed_final_tpu_torch.rpc import faults as port_faults

    servers = _serve_workers("port", 3)
    addrs = [f"127.0.0.1:{s.port}" for s, _ in servers]
    board = _soup((48, 48), seed=29)
    port_faults.configure("worker.strip_corrupt:corrupt:12:777")
    try:
        res, _ = _run(BROKERS[broker], addrs, board, 300, wire="resident", halo_depth=4,
                      sync_interval=32, rpc_deadline=2.0, probe_interval=0.2)
    finally:
        port_faults.configure(None)
        _stop(servers)
    np.testing.assert_array_equal(res.world, _oracle(board, 300)[0])


@pytest.mark.parametrize("spec", [
    "rpc.dispatch:raise:2", "worker.update:sleep:1", "x:explode:1", "a:b:c:d:e", "n:raise:x",
])
def test_fault_specs_and_the_dispatch_site_behave_as_the_reference(spec):
    """A fault spec parses, or refuses, as the reference's does; the
    server's rpc.dispatch site turns exactly the k-th call into an error
    reply and the next one is served."""
    from gol_distributed_final_tpu.rpc import faults as jax_faults
    from gol_distributed_final_tpu_torch.rpc import faults as port_faults
    from gol_distributed_final_tpu_torch.rpc.client import RpcClient, RpcError

    outcomes = []
    for mod in (port_faults, jax_faults):
        try:
            outcomes.append(mod._parse(spec))
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]
    if spec != "rpc.dispatch:raise:2":
        return
    server, _service = port_worker.serve(0, device="cpu")
    client = RpcClient(f"127.0.0.1:{server.port}", timeout=TIMEOUT)
    port_faults.configure(spec)
    try:
        replies = []
        for _ in range(3):
            try:
                client.call(Methods.WORKER_UPDATE,
                            Request(world=np.zeros((3, 4), np.uint8), start_y=-1),
                            timeout=TIMEOUT)
                replies.append("ok")
            except RpcError as exc:
                replies.append(exc.kind)
    finally:
        port_faults.configure(None)
        client.close()
        server.stop()
    assert replies == ["ok", "FaultInjected", "ok"]


# -- auto-checkpoints ----------------------------------------------------------


def _fields(path):
    with np.load(path) as data:
        return {k: (data[k].dtype.str, data[k].shape, data[k].tobytes()) for k in data.files}


def test_auto_checkpoints_equal_the_references_and_resume_across(clusters, tmp_path):
    """-auto-checkpoint 0 (a write after every committed batch: keyframes
    and dirty-tile deltas) from a port broker over port workers and a
    reference broker over reference workers: the same files, field for
    field; and each package resumes the other's to the oracle."""
    board = _soup((64, 64), seed=31)
    turns = 80
    files = {}
    for kind, broker in BROKERS.items():
        path = tmp_path / kind / "ck.npz"
        res, _ = _run(broker, clusters[kind], board, turns, wire="resident", halo_depth=4,
                      sync_interval=16, auto_checkpoint=(0.0, str(path)), ckpt_keep=2)
        np.testing.assert_array_equal(res.world, _oracle(board, turns)[0])
        files[kind] = sorted(p.name for p in path.parent.iterdir())
    assert files["port"] == files["ref"] and len(files["port"]) >= 3
    for name in files["port"]:
        assert _fields(tmp_path / "port" / name) == _fields(tmp_path / "ref" / name), name

    from gol_distributed_final_tpu.engine import checkpoint as jax_ckpt

    for kind, load in (("ref", port_ckpt.load_resume_checkpoint),
                       ("port", jax_ckpt.load_resume_checkpoint)):
        world, turn, rule, gen = load(str(tmp_path / kind / "ck.npz"), keep=2)
        # the newest write holds the last synced board, one batch short of
        # the run's end in both packages
        assert turn == turns - 4 and gen == 0 and rule.rulestring == "B3/S23"
        np.testing.assert_array_equal(world, _oracle(board, turn)[0])

    # each package's workers broker, over the other package's workers,
    # resumes the other's file (-resume's stash) and runs the next fresh
    # Run on to the oracle
    want = _oracle(board, 120)[0]
    for kind, broker, other in (("port", port_broker, "ref"), ("ref", jax_broker, "port")):
        loader = port_ckpt if kind == "port" else jax_ckpt
        stash = loader.load_resume_checkpoint(str(tmp_path / other / "ck.npz"), keep=2)[:3]
        extra = {"device": "cpu"} if kind == "port" else {}
        server, service = broker.serve(port=0, backend="workers",
                                       worker_addresses=clusters[other], wire="resident",
                                       halo_depth=4, resume=stash, **extra)
        remote = RemoteBroker(f"127.0.0.1:{server.port}")
        try:
            res = remote.run(Params(turns=120, image_width=64, image_height=64), board)
        finally:
            remote.close()
            service.backend.close()
            server.stop()
        assert res.turns_completed == 120
        np.testing.assert_array_equal(res.world, want)


def test_workers_broker_resume_consumes_the_checkpoint(clusters, tmp_path):
    """A workers broker started from a reference auto-checkpoint (the
    CLI's -resume path: a verified (world, turn, rule) stash) continues
    the controller's 64^2 session to the golden board."""
    from gol_distributed_final_tpu.engine import checkpoint as jax_ckpt

    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    world40 = _oracle(board, 40)[0]
    jax_ckpt.save_checkpoint(tmp_path / "ck.npz", world40, 40)
    stash = port_ckpt.load_resume_checkpoint(str(tmp_path / "ck.npz"))[:3]
    addr, service = _workers_broker(clusters["port"], resume=stash)
    remote = RemoteBroker(addr)
    try:
        result = run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                     broker=remote, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
                     tick_seconds=3600)
    finally:
        remote.close()
        service.shutdown()
    name = "64x64x100.pgm"
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()
    assert result.turns_completed == 100


# -- the CLIs ------------------------------------------------------------------


def test_cli_cluster_serves_a_golden_session(tmp_path):
    """Four worker processes and a workers broker, each through its CLI on
    the CPU (-wire resident -halo-depth 8), serve the controller CLI's
    64^2 x 100 session: the golden PGM, every printed tick equal to
    check/alive; SuperQuit then takes the cluster down."""
    from test_torch_rpc import _Proc

    workers = [_Proc(["-m", "gol_distributed_final_tpu_torch.rpc.worker", "-port", "0",
                      "-device", "cpu"]) for _ in range(4)]
    procs = list(workers)
    try:
        ports = [int(w.wait_for("worker listening on :").rsplit(":", 1)[1]) for w in workers]
        broker = _Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker", "-port", "0",
                        "-backend", "workers", "-wire", "resident", "-halo-depth", "8",
                        "-workers", ",".join(f"127.0.0.1:{p}" for p in ports)])
        procs.append(broker)
        line = broker.wait_for("broker listening on :")
        assert "(backend=workers)" in line
        addr = f"127.0.0.1:{int(line.rsplit(':', 1)[1].split()[0])}"
        (tmp_path / "images").symlink_to(REPO_ROOT / "images")
        cli = _Proc(["-m", "gol_distributed_final_tpu_torch", "-server", addr, "-w", "64",
                     "-h", "64", "-turns", "100", "-noVis"], cwd=tmp_path)
        procs.append(cli)
        cli.wait_for("Completed Turns 100 Quitting")
        assert cli.proc.wait(timeout=TIMEOUT) == 0
        name = "64x64x100.pgm"
        assert (tmp_path / "out" / name).read_bytes() == \
            (REPO_ROOT / "check" / "images" / name).read_bytes()
        golden = read_alive_counts(REPO_ROOT / "check" / "alive" / "64x64.csv")
        for seen in cli.seen:
            if "Alive Cells" in seen:
                turn, count = int(seen.split()[2]), int(seen.split()[-1])
                assert count == (2819 if turn == 0 else golden[turn]), seen
        remote = RemoteBroker(addr)
        try:
            remote.super_quit()
        finally:
            remote.close()
        for p in [broker, *workers]:
            assert p.proc.wait(timeout=TIMEOUT) == 0
    finally:
        for p in procs:
            p.stop()
