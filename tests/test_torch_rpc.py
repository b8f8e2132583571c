"""The PyTorch port's broker over RPC on the CPU: the port controller's
``-server`` sessions, concurrent ``SessionRun``s with tagged retrieves,
admission refusals as error replies, the broker CLI's refusals, the wire
format, and interoperation with the JAX package in every direction (the
reference controller and ``RemoteBroker.session_run`` driving the port
broker, the port controller driving the reference broker).

Every subprocess, join and reply wait has its own timeout, so no test can
hang the suite. Equality throughout (tolerance 0).
"""

import io
import os
import pickle
import queue
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from gol_distributed_final_tpu_torch import AliveCellsCount, Params, run
from gol_distributed_final_tpu_torch.engine.controller import CLOSED
from gol_distributed_final_tpu_torch.models import HIGHLIFE
from gol_distributed_final_tpu_torch.rpc import broker as port_broker_mod
from gol_distributed_final_tpu_torch.rpc import protocol
from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker, RpcClient, RpcError
from gol_distributed_final_tpu_torch.utils.cell import Cell

from helpers import REPO_ROOT, read_alive_counts
from oracle import vector_step

TIMEOUT = 120


def _seq(board, n, birth=(3,), survive=(2, 3)):
    for _ in range(n):
        board = vector_step(board, birth, survive)
    return board


def _mixed_batch(b=6, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    boards = np.where(rng.random((b, h, w)) < 0.3, 255, 0).astype(np.uint8)
    if b > 1:
        boards[0] = 0
        boards[1] = 0
        for y, x in ((1, 2), (2, 3), (3, 1), (3, 2), (3, 3)):
            boards[1, y, x] = 255
    return boards


class _Proc:
    """A subprocess whose output lines a reader thread queues, so waiting
    for a line has a timeout."""

    def __init__(self, args, cwd=REPO_ROOT):
        env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
        self.proc = subprocess.Popen(
            [sys.executable, *args], cwd=cwd, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self.lines: queue.Queue = queue.Queue()
        self.seen: list = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, text, timeout=TIMEOUT) -> str:
        deadline = time.monotonic() + timeout
        while True:
            line = self.lines.get(timeout=max(0.01, deadline - time.monotonic()))
            if line is None:
                raise RuntimeError(f"process exited: {''.join(self.seen)}")
            self.seen.append(line)
            if text in line:
                return line

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=TIMEOUT)


def _start_port_broker(*flags) -> tuple[_Proc, str]:
    proc = _Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker",
                  "-port", "0", "-device", "cpu", *flags])
    line = proc.wait_for("broker listening on :")
    assert "(backend=tpu)" in line
    return proc, f"127.0.0.1:{int(line.rsplit(':', 1)[1].split()[0])}"


@pytest.fixture(scope="module")
def port_broker():
    proc, addr = _start_port_broker("-session-capacity", "16")
    yield addr
    proc.stop()


@pytest.fixture
def inproc_broker():
    """A port broker served from this process on the CPU: its scheduler
    and table are reachable for deterministic set-ups."""
    server, service = port_broker_mod.serve(port=0, device="cpu", session_capacity=4)
    yield f"127.0.0.1:{server.port}", service
    service.shutdown()


def _drain(events):
    out = []
    while True:
        ev = events.get(timeout=TIMEOUT)
        if ev is CLOSED:
            return out
        out.append(ev)


def _threads(target, n):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)


# -- the port controller over RPC --------------------------------------------


def test_cli_server_session_is_golden(port_broker, tmp_path):
    (tmp_path / "images").symlink_to(REPO_ROOT / "images")
    cli = _Proc(["-m", "gol_distributed_final_tpu_torch", "-server", port_broker,
                 "-w", "64", "-h", "64", "-turns", "100", "-noVis"], cwd=tmp_path)
    try:
        cli.wait_for("Completed Turns 100 Quitting")
        assert cli.proc.wait(timeout=TIMEOUT) == 0
    finally:
        cli.stop()
    name = "64x64x100.pgm"
    assert (tmp_path / "out" / name).read_bytes() == \
        (REPO_ROOT / "check" / "images" / name).read_bytes()


@pytest.mark.parametrize("size", [16, 64, 512])
def test_port_controller_remote_sessions_are_golden(port_broker, size, tmp_path):
    remote = RemoteBroker(port_broker)
    try:
        result = run(Params(turns=100, image_width=size, image_height=size),
                     queue.Queue(), broker=remote, images_dir=REPO_ROOT / "images",
                     out_dir=tmp_path, tick_seconds=3600)
    finally:
        remote.close()
    name = f"{size}x{size}x100.pgm"
    assert result.turns_completed == 100
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()
    assert len(result.alive) == int(np.count_nonzero(result.world))


def test_remote_ticks_are_exact_and_q_quits(port_broker, tmp_path):
    """count_test.go over RPC: every AliveCellsCount is the CSV's count at
    its turn; 'q' after five ticks ends the session."""
    counts = read_alive_counts(REPO_ROOT / "check" / "alive" / "64x64.csv")
    events, keys, collected, errors = queue.Queue(), queue.Queue(), [], []

    def consumer():
        ticks = 0
        try:
            while True:
                ev = events.get(timeout=TIMEOUT)
                if ev is CLOSED:
                    return
                collected.append(ev)
                if isinstance(ev, AliveCellsCount):
                    ticks += 1
                    if ticks == 5:
                        keys.put("q")
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            keys.put("q")

    t = threading.Thread(target=consumer)
    t.start()
    remote = RemoteBroker(port_broker)
    try:
        run(Params(turns=100_000_000, image_width=64, image_height=64), events, keys,
            broker=remote, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
            tick_seconds=0.2)
    finally:
        remote.close()
    t.join(TIMEOUT)
    assert not t.is_alive() and not errors, errors
    ticks = [e for e in collected if isinstance(e, AliveCellsCount)]
    assert len(ticks) >= 5
    for ev in ticks:
        assert ev.cells_count == (2819 if ev.completed_turns == 0
                                  else counts.get(ev.completed_turns, 101)), ev


def test_remote_rule_rides_to_the_broker(port_broker, tmp_path):
    from gol_distributed_final_tpu_torch.engine.engine import EngineConfig

    remote = RemoteBroker(port_broker)
    try:
        with pytest.raises(ValueError, match="in-process engine"):
            run(Params(turns=1, image_width=64, image_height=64), broker=remote,
                engine_config=EngineConfig(device="cpu"))
        result = run(Params(turns=37, image_width=64, image_height=64), queue.Queue(),
                     broker=remote, rule=HIGHLIFE, images_dir=REPO_ROOT / "images",
                     out_dir=tmp_path, tick_seconds=3600)
    finally:
        remote.close()
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    want = _seq(read_pgm(REPO_ROOT / "images" / "64x64.pgm"), 37, (3, 6), (2, 3))
    np.testing.assert_array_equal(result.world, want)


# -- SessionRun --------------------------------------------------------------


def test_concurrent_session_runs_equal_the_oracle(port_broker):
    boards = _mixed_batch(b=6, seed=10)
    budgets = [4, 7, 3, 9, 5, 13]
    results = {}

    def one(i):
        rb = RemoteBroker(port_broker)
        try:
            results[i] = rb.session_run(
                Params(turns=budgets[i], image_width=32, image_height=32), boards[i],
                session_id=100 + i, timeout=TIMEOUT,
            )
        finally:
            rb.close()

    _threads(one, 6)
    for i, budget in enumerate(budgets):
        assert results[i].turns_completed == budget
        assert results[i].world.dtype == np.uint8
        np.testing.assert_array_equal(results[i].world, _seq(boards[i], budget))
        assert len(results[i].alive) == int(np.count_nonzero(results[i].world))


def test_tagged_retrieve_mid_flight_and_after_completion(inproc_broker, monkeypatch):
    from gol_distributed_final_tpu_torch.engine import sessions as sessions_mod

    addr, service = inproc_broker
    with service._sessions_lock:
        # one turn per boundary: a wide window for the mid-flight retrieve
        service._sessions = port_broker_mod.SessionScheduler(4, max_chunk=1, device="cpu")
    board = _mixed_batch(b=3, seed=13)[2]
    turns, done, result = 200, threading.Event(), {}
    snaps, advances = [], []

    class HeldTable(sessions_mod.SessionTable):
        """Holds the batch after its first turn until the watcher has read
        three snapshots: on a loaded host the 200 one-turn boundaries can
        all pass between two of the watcher's polls, and no read would
        land mid-flight."""

        def advance(self):
            if len(advances) == 1:
                deadline = time.monotonic() + TIMEOUT
                while len(snaps) < 3 and time.monotonic() < deadline:
                    time.sleep(0.005)
            advances.append(None)
            return super().advance()

    monkeypatch.setattr(sessions_mod, "SessionTable", HeldTable)

    def session():
        rb = RemoteBroker(addr)
        try:
            result["r"] = rb.session_run(
                Params(turns=turns, image_width=32, image_height=32), board,
                session_id=7, timeout=TIMEOUT)
        finally:
            rb.close()
            done.set()

    watcher = RemoteBroker(addr)
    t = threading.Thread(target=session)
    t.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline and not done.is_set() and len(snaps) < 3:
            try:
                snaps.append(watcher.retrieve(include_world=True, session_id=7))
            except RpcError:
                time.sleep(0.01)  # not admitted yet
        t.join(TIMEOUT)
        assert not t.is_alive()
        final = watcher.retrieve(include_world=True, session_id=7)
        count_only = watcher.retrieve(include_world=False, session_id=7)
        with pytest.raises(RpcError, match="no session"):
            watcher.retrieve(session_id=999)
    finally:
        watcher.close()
    assert snaps and any(s.turns_completed < turns for s in snaps)
    for snap in snaps:
        want = _seq(board, snap.turns_completed)
        np.testing.assert_array_equal(snap.world, want)
        assert snap.alive_count == int(np.count_nonzero(want))
    want = _seq(board, turns)
    np.testing.assert_array_equal(result["r"].world, want)
    assert final.turns_completed == turns and np.array_equal(final.world, want)
    assert count_only.world is None and count_only.alive_count == int(np.count_nonzero(want))


def test_refusals_are_error_replies_with_reasons(inproc_broker):
    from gol_distributed_final_tpu_torch.engine.sessions import SessionTable
    from gol_distributed_final_tpu_torch.models import CONWAY

    addr, service = inproc_broker
    boards = _mixed_batch(b=3, seed=11)
    sched = service._session_scheduler()
    with sched._work:  # fill the table: no driver race
        sched._table = SessionTable(CONWAY, (32, 32), 2, device="cpu")
        sched._table.admit(boards[0], 50)
        sched._table.admit(boards[1], 50)
    rb = RemoteBroker(addr)
    try:
        cases = [
            (Params(turns=5, image_width=32, image_height=32), boards[2], None, "capacity"),
            (Params(turns=5, image_width=16, image_height=16),
             np.zeros((16, 16), np.uint8), None, "geometry"),
            (Params(turns=5, image_width=32, image_height=32), boards[2], HIGHLIFE, "rule"),
        ]
        # the table checks geometry before capacity, the scheduler the rule
        # before the table: each case is refused for its own reason
        for params, board, rule, reason in cases:
            with pytest.raises(RpcError) as exc:
                rb.session_run(params, board, rule=rule, timeout=TIMEOUT)
            assert exc.value.is_reply and exc.value.kind == "SessionRejected"
            assert exc.value.reason == reason, (reason, str(exc.value))
        with pytest.raises(RpcError, match="does not match"):
            rb.session_run(Params(turns=5, image_width=32, image_height=32),
                           np.zeros((8, 8), np.uint8), timeout=TIMEOUT)
    finally:
        rb.close()


# -- interoperation with the JAX package -------------------------------------


@pytest.mark.parametrize("size", [16, 64, 512])
def test_reference_controller_drives_the_port_broker(port_broker, size, tmp_path):
    from gol_distributed_final_tpu import Params as JParams
    from gol_distributed_final_tpu import run as jax_run
    from gol_distributed_final_tpu.rpc.client import RemoteBroker as JaxRemote

    remote = JaxRemote(port_broker)
    try:
        result = jax_run(JParams(turns=100, image_width=size, image_height=size),
                         queue.Queue(), broker=remote, images_dir=REPO_ROOT / "images",
                         out_dir=tmp_path, tick_seconds=3600)
    finally:
        remote.close()
    name = f"{size}x{size}x100.pgm"
    assert result.turns_completed == 100
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()


def test_reference_session_run_drives_the_port_broker(port_broker):
    from gol_distributed_final_tpu import Params as JParams
    from gol_distributed_final_tpu.rpc.client import RemoteBroker as JaxRemote
    from gol_distributed_final_tpu.rpc.client import RpcError as JaxRpcError

    boards = _mixed_batch(b=4, h=64, w=64, seed=21)
    budgets = [6, 11, 2, 17]
    results = {}

    def one(i):
        rb = JaxRemote(port_broker)
        try:
            results[i] = rb.session_run(
                JParams(turns=budgets[i], image_width=64, image_height=64), boards[i],
                session_id=500 + i, timeout=TIMEOUT)
        finally:
            rb.close()

    _threads(one, 4)
    for i, budget in enumerate(budgets):
        np.testing.assert_array_equal(results[i].world, _seq(boards[i], budget))
        assert results[i].turns_completed == budget
    watcher = JaxRemote(port_broker)
    try:
        snap = watcher.retrieve(include_world=True, session_id=503)
        with pytest.raises(JaxRpcError) as exc:
            watcher.session_run(JParams(turns=0, image_width=64, image_height=64),
                                boards[0])
    finally:
        watcher.close()
    assert snap.turns_completed == 17
    np.testing.assert_array_equal(snap.world, _seq(boards[3], 17))
    assert exc.value.reason == "turns"


def test_port_controller_drives_the_reference_broker(tmp_path):
    from gol_distributed_final_tpu.rpc import broker as jax_broker

    server, service = jax_broker.serve(port=0)
    remote = RemoteBroker(f"127.0.0.1:{server.port}")
    try:
        result = run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                     broker=remote, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
                     tick_seconds=3600)
        boards = _mixed_batch(b=2, seed=22)
        session = remote.session_run(Params(turns=9, image_width=32, image_height=32),
                                     boards[1], session_id=3, timeout=TIMEOUT)
    finally:
        remote.close()
        server.stop()
    name = "64x64x100.pgm"
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()
    assert len(result.alive) == int(np.count_nonzero(result.world))
    np.testing.assert_array_equal(session.world, _seq(boards[1], 9))


# -- the wire format ---------------------------------------------------------


def test_port_frames_carry_the_reference_names():
    from gol_distributed_final_tpu.rpc import protocol as jproto
    from gol_distributed_final_tpu.utils.cell import Cell as JaxCell

    world = np.arange(64, dtype=np.uint8).reshape(8, 8)
    req = protocol.Request(world=world, turns=5, session_id=9, rulestring="B36/S23")
    theirs = jproto.loads_restricted(protocol.dumps({"request": req}))["request"]
    assert type(theirs) is jproto.Request
    assert theirs.turns == 5 and theirs.session_id == 9 and theirs.rulestring == "B36/S23"
    np.testing.assert_array_equal(theirs.world, world)
    res = protocol.Response(alive=[Cell(1, 2), Cell(3, 4)], alive_count=2)
    back = jproto.loads_restricted(protocol.dumps(res))
    assert type(back) is jproto.Response and all(type(c) is JaxCell for c in back.alive)
    assert [tuple(c) for c in back.alive] == [(1, 2), (3, 4)]

    # and the reverse: reference pickles load as the port's classes
    frame = pickle.dumps(jproto.Response(alive=[JaxCell(5, 6)], world=world, turns_completed=3),
                         protocol=pickle.HIGHEST_PROTOCOL)
    mine = protocol.loads_restricted(frame)
    assert type(mine) is protocol.Response and type(mine.alive[0]) is Cell
    assert mine.turns_completed == 3 and np.array_equal(mine.world, world)
    assert protocol.WIRE_NAMES[protocol.Request] == (
        "gol_distributed_final_tpu.rpc.protocol", "Request")


def test_port_unpickler_refuses_other_globals():
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        protocol.loads_restricted(pickle.dumps(Evil()))
    # the port's own module path is not on the wire vocabulary either
    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        protocol.loads_restricted(pickle.dumps(protocol.Request()))


@pytest.mark.parametrize("oob", [False, True])
def test_checked_frames_round_trip_and_refuse_a_flipped_bit(oob):
    world = np.random.default_rng(0).integers(0, 2, (64, 64), dtype=np.uint8) * 255
    a, b = socket.socketpair()
    try:
        n = protocol.send_frame(a, {"id": 1, "result": protocol.Response(world=world)},
                                oob=oob, checksum=True)
        msg, got = protocol.recv_frame_sized(b)
        assert got == n and np.array_equal(msg["result"].world, world)

        buf = io.BytesIO()

        class Capture:
            def sendall(self, data):
                buf.write(bytes(data))

        protocol.send_frame(Capture(), {"id": 2, "result": protocol.Response(world=world)},
                            oob=oob, checksum=True)
        raw = bytearray(buf.getvalue())
        raw[-10] ^= 0x01  # a flipped bit deep in the body
        a.sendall(bytes(raw))
        with pytest.raises(ConnectionError, match="checksum mismatch"):
            protocol.recv_frame_sized(b)
    finally:
        a.close()
        b.close()


# -- the broker's verbs and CLI ----------------------------------------------


def test_unported_status_verb_is_an_unknown_method(port_broker):
    """Status was an unknown method before this port had obs/; now the
    broker answers it with the JAX package's payload schema (its registry
    off: the broker runs without -metrics)."""
    client = RpcClient(port_broker)
    try:
        res = client.call("Operations.Status", protocol.Request(), timeout=TIMEOUT)
        assert res.status["schema"] == "gol-status/1"
        assert res.status["role"] == "broker" and res.status["metrics_enabled"] is False
        with pytest.raises(RpcError, match="must be a Request"):
            client.call(protocol.Methods.RETRIEVE, None, timeout=TIMEOUT)
    finally:
        client.close()


@pytest.mark.parametrize("flags", [
    ["-backend", "workers"], ["-workers", "127.0.0.1:1"], ["-wire", "resident"],
    ["-halo-depth", "2"], ["-auto-checkpoint", "1"],
    ["-metrics"], ["-timeline", "0.5"], ["-trace"],
    ["-journal"], ["-profile"], ["-canary"],
    ["-canary", "0.5", "-canary-verb", "run"], ["-canary", "0"],
])
def test_broker_cli_refuses_what_is_not_ported(flags, capsys, monkeypatch, tmp_path):
    """Every flag the port once refused is ported: the workers backend's,
    the observability flags and the canary's. With them the port broker
    does what the reference broker does, serving the same configuration
    or exiting 2 with the same message."""
    from torch_obs_state import reset_both

    assert flags[0] in _NOW_PORTED
    monkeypatch.chdir(tmp_path)  # -journal and -profile write under out/
    from gol_distributed_final_tpu.rpc import broker as jax_broker

    outcomes = []
    for mod, extra in ((port_broker_mod, ["-device", "cpu"]), (jax_broker, [])):
        served = {}

        def fake_serve(*args, **kwargs):
            kwargs.pop("device", None)
            served.update(args=args, kwargs=kwargs)
            service = type("Stopped", (), {"quit_event": threading.Event()})()
            service.quit_event.set()
            return type("Bound", (), {"port": 0})(), service

        monkeypatch.setattr(mod, "serve", fake_serve)
        try:
            mod.main([*flags, "-port", "0", *extra])
            outcomes.append(("served", served))
        except SystemExit as exc:
            err = capsys.readouterr().err
            outcomes.append((exc.code, err[err.index("error: "):].strip()))
        finally:
            reset_both()
    assert outcomes[0] == outcomes[1]


#: the cases above: refused before this port had the workers backend, the
#: observability flags and the canary, held against the reference broker
#: since
_NOW_PORTED = {
    "-backend", "-workers", "-wire", "-halo-depth", "-auto-checkpoint",
    "-metrics", "-timeline", "-trace", "-journal", "-profile", "-canary",
}


@pytest.mark.parametrize("case", [
    ["-resume", "x.npz"], ["-ckpt-keep", "2"], ["-ckpt-keep", "0"],
    ["-resume", "GARBAGE"], ["-resume", "LEGACY"], ["-resume", "GOOD.npz", "-ckpt-keep", "0"],
])
def test_broker_cli_resume_flags_refuse_as_the_reference(case, tmp_path, capsys, monkeypatch):
    """The broker's -resume and -ckpt-keep: each bad use exits 2 with the
    reference broker's own message."""
    from gol_distributed_final_tpu.rpc import broker as jax_broker

    monkeypatch.chdir(tmp_path)
    (tmp_path / "GARBAGE").write_bytes(b"zip? no")
    np.savez(tmp_path / "LEGACY", board=np.zeros((4, 4), np.uint8), turn=np.int64(1),
             rulestring=np.str_("B3/S23"))
    (tmp_path / "LEGACY.npz").rename(tmp_path / "LEGACY")
    errors = []
    for main, extra in ((port_broker_mod.main, ["-device", "cpu"]), (jax_broker.main, [])):
        with pytest.raises(SystemExit) as exc:
            main([*case, "-port", "0", *extra])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "Traceback" not in err
        errors.append(err[err.index("error: ") + len("error: "):].strip())
    assert errors[0] == errors[1]


def test_broker_cli_needs_a_card_by_default(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        port_broker_mod.main(["-port", "0"])
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_broker_mod.serve(port=0)


def test_controller_cli_refuses_a_device_with_server(capsys):
    from gol_distributed_final_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["-server", "127.0.0.1:1", "-device", "cpu", "-noVis"])
    assert exc.value.code == 2 and "-device" in capsys.readouterr().err


def test_remote_quit_then_super_quit_stops_the_broker(tmp_path):
    proc, addr = _start_port_broker()
    try:
        remote = RemoteBroker(addr)
        events, keys = queue.Queue(), queue.Queue()
        keys.put("q")
        result = run(Params(turns=100_000_000, image_width=64, image_height=64), events,
                     keys, broker=remote, images_dir=REPO_ROOT / "images",
                     out_dir=tmp_path, tick_seconds=3600)
        assert result.turns_completed < 100_000_000
        remote.super_quit()
        remote.close()
        assert proc.proc.wait(timeout=TIMEOUT) == 0
    finally:
        proc.stop()


# -- resume over RPC ----------------------------------------------------------


def _checkpoint_at_40(tmp_path, name="ck.npz"):
    from gol_distributed_final_tpu_torch.engine.checkpoint import save_checkpoint
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    return save_checkpoint(tmp_path / name, _seq(board, 40), 40), board


GOLDEN_64_100 = REPO_ROOT / "check" / "images" / "64x64x100.pgm"


def test_remote_resume_from_checkpoint(port_broker, tmp_path):
    """A checkpoint at turn 40 resumed through the port controller on a
    port broker lands on the turn-100 golden."""
    ck, _ = _checkpoint_at_40(tmp_path)
    remote = RemoteBroker(port_broker)
    try:
        result = run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                     broker=remote, out_dir=tmp_path / "out", tick_seconds=3600,
                     resume_from=ck)
    finally:
        remote.close()
    assert result.turns_completed == 100
    assert (tmp_path / "out" / "64x64x100.pgm").read_bytes() == GOLDEN_64_100.read_bytes()


def test_reference_controller_resumes_on_the_port_broker(port_broker, tmp_path):
    from gol_distributed_final_tpu import Params as JParams
    from gol_distributed_final_tpu import run as jax_run
    from gol_distributed_final_tpu.engine.checkpoint import save_checkpoint as jsave
    from gol_distributed_final_tpu.models import HIGHLIFE as J_HIGHLIFE
    from gol_distributed_final_tpu.rpc.client import RemoteBroker as JaxRemote

    rng = np.random.default_rng(23)
    board = np.where(rng.random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
    ck = jsave(tmp_path / "hl.npz", board, 10, J_HIGHLIFE)
    remote = JaxRemote(port_broker)
    try:
        result = jax_run(JParams(turns=40, image_width=64, image_height=64), queue.Queue(),
                         broker=remote, out_dir=tmp_path, tick_seconds=3600, resume_from=ck)
    finally:
        remote.close()
    assert result.turns_completed == 40
    np.testing.assert_array_equal(result.world, _seq(board, 30, (3, 6), (2, 3)))


def test_port_controller_resumes_on_the_reference_broker(tmp_path):
    from gol_distributed_final_tpu.rpc import broker as jax_broker

    ck, _ = _checkpoint_at_40(tmp_path)
    server, service = jax_broker.serve(port=0)
    remote = RemoteBroker(f"127.0.0.1:{server.port}")
    try:
        result = run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                     broker=remote, out_dir=tmp_path, tick_seconds=3600, resume_from=ck)
    finally:
        remote.close()
        server.stop()
    assert result.turns_completed == 100
    assert (tmp_path / "64x64x100.pgm").read_bytes() == GOLDEN_64_100.read_bytes()


def test_device_backend_resumes_under_the_requests_rule():
    """A Run at a nonzero initial_turn, with a non-Conway rule on the wire,
    equals the reference's backend and the oracle."""
    from gol_distributed_final_tpu.rpc.broker import TpuBackend
    from gol_distributed_final_tpu.rpc.protocol import Request as JRequest

    rng = np.random.default_rng(17)
    board = np.where(rng.random((64, 64)) < 0.3, 255, 0).astype(np.uint8)
    fields = dict(world=board, turns=30, image_height=64, image_width=64, initial_turn=10,
                  rulestring="B36/S23")
    mine = port_broker_mod.DeviceBackend("cpu").run(protocol.Request(**fields))
    theirs = TpuBackend(use_mesh=False).run(JRequest(**fields))
    assert mine.turns_completed == theirs.turns_completed == 30
    np.testing.assert_array_equal(mine.world, _seq(board, 20, (3, 6), (2, 3)))
    np.testing.assert_array_equal(mine.world, theirs.world)


def test_broker_service_validates_resume_bounds(inproc_broker):
    addr, _ = inproc_broker
    client = RpcClient(addr)
    board = np.zeros((16, 16), np.uint8)
    try:
        for initial_turn, match in ((-1, "outside"), (11, "outside")):
            with pytest.raises(RpcError, match=match):
                client.call(protocol.Methods.BROKER_RUN, protocol.Request(
                    world=board, turns=10, image_height=16, image_width=16,
                    initial_turn=initial_turn), timeout=TIMEOUT)
        with pytest.raises(RpcError, match="does not match"):
            client.call(protocol.Methods.BROKER_RUN, protocol.Request(
                world=board, turns=10, image_height=32, image_width=16), timeout=TIMEOUT)
    finally:
        client.close()


@pytest.mark.parametrize("case", ["shape", "turns", "rule"])
def test_resume_mismatches_refuse_as_the_reference(case):
    from gol_distributed_final_tpu.models import CONWAY as J_CONWAY
    from gol_distributed_final_tpu.rpc import broker as jax_broker
    from gol_distributed_final_tpu.rpc.protocol import Request as JRequest
    from gol_distributed_final_tpu_torch.models import CONWAY

    board = np.zeros((64, 64), np.uint8)
    fields = {"shape": dict(world=np.zeros((16, 16), np.uint8), turns=100, image_height=16,
                            image_width=16),
              "turns": dict(world=board, turns=40, image_height=64, image_width=64),
              "rule": dict(world=board, turns=100, image_height=64, image_width=64,
                           rulestring="B36/S23")}[case]
    errors = []
    for service_cls, req_cls, rule in ((port_broker_mod.BrokerService, protocol.Request, CONWAY),
                                       (jax_broker.BrokerService, JRequest, J_CONWAY)):
        service = service_cls(None, None, resume=(board, 40, rule))
        with pytest.raises(ValueError) as exc:
            service._apply_resume(req_cls(**fields))
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_resume_is_consumed_once_the_run_progresses(tmp_path):
    """A Run that a buffered Quit ends at the checkpoint's turn keeps the
    stash; the next Run resumes, and the one after starts fresh."""
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm
    from gol_distributed_final_tpu_torch.models import CONWAY

    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    resume = (_seq(board, 40), 40, CONWAY)
    server, service = port_broker_mod.serve(port=0, device="cpu", resume=resume)

    def fresh_run(turns):
        return service.run(protocol.Request(world=board, turns=turns, image_height=64,
                                            image_width=64))
    try:
        service.quit(protocol.Request())
        first = fresh_run(100)
        assert first.turns_completed == 40
        second = fresh_run(100)
        assert second.turns_completed == 100
        assert second.world.tobytes() == read_pgm(GOLDEN_64_100).tobytes()
        third = fresh_run(7)
        np.testing.assert_array_equal(third.world, _seq(board, 7))
    finally:
        service.shutdown()


def test_broker_cli_resume_serves_the_first_run(tmp_path):
    """`rpc.broker -resume CK`: the first fresh Run continues from turn 40
    to the golden; the next starts from turn 0."""
    ck, board = _checkpoint_at_40(tmp_path)
    proc, addr = _start_port_broker("-resume", str(ck))
    try:
        remote = RemoteBroker(addr)
        try:
            first = run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                        broker=remote, images_dir=REPO_ROOT / "images",
                        out_dir=tmp_path / "a", tick_seconds=3600)
            proc.wait_for("Run reattached to -resume checkpoint at turn 40")
            second = remote.run(Params(turns=9, image_width=64, image_height=64), board)
        finally:
            remote.close()
    finally:
        proc.stop()
    assert first.turns_completed == 100
    assert (tmp_path / "a" / "64x64x100.pgm").read_bytes() == GOLDEN_64_100.read_bytes()
    np.testing.assert_array_equal(second.world, _seq(board, 9))


def test_broker_cli_ckpt_keep_falls_back_past_a_corrupt_newest(tmp_path):
    from gol_distributed_final_tpu_torch.engine.checkpoint import (
        generation_path,
        rotate_generations,
    )

    base = tmp_path / "ck.npz"
    ck, _ = _checkpoint_at_40(tmp_path)
    ck.replace(base)
    rotate_generations(base, keep=2)  # the turn-40 file becomes generation 1
    base.write_bytes(b"scribble")
    assert generation_path(base, 1).exists()
    proc, addr = _start_port_broker("-resume", str(base), "-ckpt-keep", "2")
    try:
        assert "fell back to verified generation 1 (turn 40)" in "".join(proc.seen)
        remote = RemoteBroker(addr)
        try:
            result = run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                         broker=remote, images_dir=REPO_ROOT / "images",
                         out_dir=tmp_path / "out", tick_seconds=3600)
        finally:
            remote.close()
    finally:
        proc.stop()
    assert result.turns_completed == 100
    assert (tmp_path / "out" / "64x64x100.pgm").read_bytes() == GOLDEN_64_100.read_bytes()


def test_a_stopped_server_ends_its_accept_thread_and_refuses_connections():
    """``RpcServer.stop`` wakes the thread blocked in ``accept``: after it
    the thread ends and the port takes no connection, so no stopped
    broker or worker lingers in the process that ran it."""
    from gol_distributed_final_tpu_torch.rpc.server import RpcServer

    server = RpcServer("127.0.0.1", 0)
    server.serve_background()
    port = server._sock.getsockname()[1]
    server.stop()
    server._accept_thread.join(timeout=10)
    assert not server._accept_thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
