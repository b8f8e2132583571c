"""The port's pod session (gol_distributed_final_tpu_torch/pod.py) in one
process, against the JAX package's on the 8-device virtual CPU mesh.

Each case runs the same board through both packages' ``pod_session`` on a
(2, 4) or (8, 1) mesh (the JAX one over its virtual devices, the port's
over eight CPU shards) and holds the event sequences, the streamed PGM
bytes, the alive counts and the checkpoint files equal. Process
boundaries are tests/test_torch_multihost.py's. Mirrors tests/test_pod.py.
"""

import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gol_distributed_final_tpu import pod as jpod
from gol_distributed_final_tpu.engine import checkpoint as jck
from gol_distributed_final_tpu.engine.controller import CLOSED as J_CLOSED
from gol_distributed_final_tpu.parallel import bit_halo as jbit
from gol_distributed_final_tpu.parallel import mesh as jmesh
from gol_distributed_final_tpu_torch import pod
from gol_distributed_final_tpu_torch.engine import checkpoint as ck
from gol_distributed_final_tpu_torch.engine.controller import CLOSED
from gol_distributed_final_tpu_torch.events import (
    AliveCellsCount,
    ImageOutputComplete,
    Quitting,
    State,
    StateChange,
)
from gol_distributed_final_tpu_torch.ops import bitpack, tiled
from gol_distributed_final_tpu_torch.parallel import bit_halo
from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard, make_mesh

from oracle import vector_step

SIZE, TURNS = 256, 20


def port_mesh(shape=(2, 4)):
    return make_mesh(shape, devices=[torch.device("cpu")] * 8)


def _random_board(seed=5, size=SIZE):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((size, size)) < 0.3, 255, 0).astype(np.uint8)


def _write_pgm(path, board):
    path.parent.mkdir(parents=True, exist_ok=True)
    h, w = board.shape
    path.write_bytes(b"P5\n%d %d\n255\n" % (w, h) + board.tobytes())


def _oracle(board, turns):
    for _ in range(turns):
        board = vector_step(board)
    return board


def _drain(events, closed):
    seq = []
    while True:
        ev = events.get(timeout=60)
        if ev is closed:
            return seq
        seq.append(ev)


def _shape(ev):
    """An event as comparable plain data across the two packages."""
    out = [type(ev).__name__, ev.completed_turns]
    if hasattr(ev, "cells_count"):
        out.append(ev.cells_count)
    if hasattr(ev, "new_state"):
        out.append(str(ev.new_state))
    if hasattr(ev, "alive"):
        out.append(len(ev.alive))
    if hasattr(ev, "filename"):
        out.append(ev.filename)
    return out


def both_sessions(tmp_path, size, turns, *, shape=(2, 4), keys=(), **kw):
    """The same session through the JAX package's pod and the port's:
    ``(result, events, pgm bytes)`` of each, keys queued before the start."""
    out = {}
    for name, module, mesh, closed in (
        ("ref", jpod, jmesh.make_mesh(shape), J_CLOSED),
        ("port", pod, port_mesh(shape), CLOSED),
    ):
        events, keypresses = queue.Queue(), queue.Queue()
        for k in keys:
            keypresses.put(k)
        res = module.pod_session(size, turns, mesh, events=events, keypresses=keypresses,
                                 out_dir=tmp_path / name, **kw)
        pgm = (tmp_path / name / f"{size}x{size}x{turns}.pgm").read_bytes()
        out[name] = (res, _drain(events, closed), pgm)
    return out["ref"], out["port"]


def test_pod_session_end_to_end(tmp_path):
    """Seed from a streamed PGM, every gate ticking: the same events, the
    same alive count and the same bytes as the JAX pod, and the oracle's
    board in the PGM."""
    board = _random_board()
    in_path = tmp_path / f"{SIZE}x{SIZE}.pgm"
    _write_pgm(in_path, board)
    tiled.reset_counts()
    ref, got = both_sessions(tmp_path, SIZE, TURNS, in_path=in_path, tick_seconds=0,
                             min_chunk=4, max_chunk=4)
    assert tiled.plain_calls == 8 * TURNS  # one tiled call a block a turn
    assert got[0].turns_completed == ref[0].turns_completed == TURNS
    assert [_shape(e) for e in got[1]] == [_shape(e) for e in ref[1]]
    ticks = [e for e in got[1] if isinstance(e, AliveCellsCount)]
    assert [e.completed_turns for e in ticks] == [4, 8, 12, 16, 20]
    assert got[0].alive_count == ref[0].alive_count
    with pytest.raises(NotImplementedError):
        list(got[1][-3].alive)
    assert isinstance(got[1][-2], ImageOutputComplete)
    assert isinstance(got[1][-1], StateChange) and got[1][-1].new_state is Quitting
    want = _oracle(board, TURNS)
    assert got[2] == ref[2] == b"P5\n%d %d\n255\n" % (SIZE, SIZE) + want.tobytes()


@pytest.mark.parametrize("keys", [("s", "k"), ("q",), ("q", "k"), ("p", "p"), ("k",)])
def test_pod_keys_at_the_first_gate_equal_the_reference(tmp_path, keys):
    """Keys drained at the first gate: a snapshot then a kill, a detach
    ('q': the run goes on headless and still writes its PGM), keys behind
    a 'q' never read, a cancelled pause pair, a kill. Events, turns and
    PGM bytes equal the JAX pod's."""
    board = _random_board(7)
    in_path = tmp_path / f"{SIZE}x{SIZE}.pgm"
    _write_pgm(in_path, board)
    turns = TURNS if keys[0] in "qp" else 1_000_000
    ref, got = both_sessions(tmp_path, SIZE, turns, keys=keys, in_path=in_path,
                             tick_seconds=3600, min_chunk=2, max_chunk=2)
    assert got[0].turns_completed == ref[0].turns_completed
    assert [_shape(e) for e in got[1]] == [_shape(e) for e in ref[1]]
    assert got[2] == ref[2]
    done = got[0].turns_completed
    assert got[2] == b"P5\n%d %d\n255\n" % (SIZE, SIZE) + _oracle(board, done).tobytes()


def test_pod_session_pause_snapshot_quit(tmp_path):
    """The keyboard through the gate with real pacing: 's' streams a
    snapshot, 'p'/'p' pause and resume (the resume reports turn - 1, no
    tick while paused), 'k' ends the session."""
    board = _random_board(6)
    in_path = tmp_path / f"{SIZE}x{SIZE}.pgm"
    _write_pgm(in_path, board)
    events, keys = queue.Queue(), queue.Queue()

    def feed():
        keys.put("s")
        time.sleep(0.4)
        keys.put("p")
        time.sleep(0.5)
        keys.put("p")
        time.sleep(0.2)
        keys.put("k")

    feeder = threading.Thread(target=feed)
    feeder.start()
    res = pod.pod_session(SIZE, 1_000_000, port_mesh(), in_path=in_path, events=events,
                          keypresses=keys, tick_seconds=0.05, out_dir=tmp_path / "out",
                          min_chunk=2, max_chunk=2)
    feeder.join(60)
    assert not feeder.is_alive()
    seq = _drain(events, CLOSED)
    assert 0 < res.turns_completed < 1_000_000
    changes = [e for e in seq if isinstance(e, StateChange)]
    paused = [e for e in changes if e.new_state == State.PAUSED]
    executing = [e for e in changes if e.new_state == State.EXECUTING]
    assert len(paused) == 1 and len(executing) == 1
    assert executing[0].completed_turns == paused[0].completed_turns - 1
    i0, i1 = seq.index(paused[0]), seq.index(executing[0])
    assert not any(isinstance(e, AliveCellsCount) for e in seq[i0 + 1:i1])
    assert len([e for e in changes if e.new_state is Quitting]) == 2
    got = (tmp_path / "out" / f"{SIZE}x{SIZE}x1000000.pgm").read_bytes()
    assert got == b"P5\n%d %d\n255\n" % (SIZE, SIZE) + _oracle(
        board, res.turns_completed).tobytes()


def test_pod_pause_pair_order_matches_the_reference(tmp_path):
    from gol_distributed_final_tpu.params import Params as JParams
    from gol_distributed_final_tpu_torch.params import Params

    def pair_events(module, params, paused):
        events = queue.Queue()
        control = module._PodControl(params, events, queue.Queue(), tmp_path / "x.pgm",
                                     0, 64, 3600, True)
        control.paused = paused
        control._pause_pairs = 1
        control._apply(None, None, 3, 0)
        return [_shape(events.get_nowait()) for _ in range(events.qsize())]

    for paused in (False, True):
        got = pair_events(pod, Params(turns=4, image_width=64, image_height=64), paused)
        want = pair_events(jpod, JParams(turns=4, image_width=64, image_height=64), paused)
        assert got == want and len(got) == 2


def test_pod_q_streams_snapshot_at_detach_gate(tmp_path, monkeypatch):
    """'q' streams the CURRENT state at the detach gate, and the closing
    sequence the final one: two streams, the turn-2 and turn-20 boards."""
    board = _random_board(12)
    in_path = tmp_path / f"{SIZE}x{SIZE}.pgm"
    _write_pgm(in_path, board)
    streams = []
    real = pod.stream_packed_to_pgm_sharded

    def spy(path, state, word_axis, row_block):
        streams.append(bitpack.unpack(state.gather(), word_axis).numpy())
        return real(path, state, word_axis, row_block)

    monkeypatch.setattr(pod, "stream_packed_to_pgm_sharded", spy)
    keys = queue.Queue()
    keys.put("q")
    res = pod.pod_session(SIZE, TURNS, port_mesh(), in_path=in_path, events=queue.Queue(),
                          keypresses=keys, tick_seconds=3600, out_dir=tmp_path / "out",
                          min_chunk=2, max_chunk=2)
    assert res.turns_completed == TURNS and len(streams) == 2
    np.testing.assert_array_equal(streams[0], _oracle(board, 2))
    np.testing.assert_array_equal(streams[1], _oracle(board, TURNS))


def test_pod_rejects_depth_too_deep_for_blocks(tmp_path):
    board = _random_board(9, size=64)
    in_path = tmp_path / "64x64.pgm"
    _write_pgm(in_path, board)
    for module, mesh in ((jpod, jmesh.make_mesh((2, 4))), (pod, port_mesh())):
        with pytest.raises(ValueError, match="halo_depth=2"):
            module.pod_session(64, 10, mesh, in_path=in_path, events=queue.Queue(),
                               tick_seconds=3600, out_dir=tmp_path / "out", halo_depth=2)


@pytest.mark.parametrize("depth", [2, 3])
def test_wide_pod_session_equals_depth_one(tmp_path, depth):
    board = _random_board(33)
    in_path = tmp_path / f"{SIZE}x{SIZE}.pgm"
    _write_pgm(in_path, board)
    outs = {}
    for d in (1, depth):
        pod.pod_session(SIZE, TURNS, port_mesh(), in_path=in_path, events=queue.Queue(),
                        tick_seconds=3600, out_dir=tmp_path / f"out{d}", min_chunk=4,
                        max_chunk=4, halo_depth=d)
        outs[d] = (tmp_path / f"out{d}" / f"{SIZE}x{SIZE}x{TURNS}.pgm").read_bytes()
    assert outs[1] == outs[depth]


def test_pod_checkpoint_and_resume(tmp_path):
    """Periodic checkpoints and resume: the turn-16 checkpoint of a 20-turn
    run is byte-equal to the JAX pod's and resumes, in either package, to
    the same final PGM."""
    board = _random_board(7)
    in_path = tmp_path / f"{SIZE}x{SIZE}.pgm"
    _write_pgm(in_path, board)
    kw = dict(in_path=in_path, tick_seconds=3600, checkpoint_every=8, min_chunk=4, max_chunk=4)
    for name, module, mesh in (("ref", jpod, jmesh.make_mesh((2, 4))), ("port", pod, port_mesh())):
        res = module.pod_session(SIZE, TURNS, mesh, events=queue.Queue(),
                                 out_dir=tmp_path / name, checkpoint_path=tmp_path / f"{name}.npz",
                                 **kw)
        assert res.turns_completed == TURNS
    # one process holds every block: the engines wrote the one-host format
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "ref.npz").read_bytes()
    state, turn, rule, word_axis = ck.load_packed_checkpoint_sharded(
        tmp_path / "ref.npz", bit_halo.packed_sharding(port_mesh()))
    assert turn == 16 and rule.rulestring == "B3/S23" and word_axis == 0
    np.testing.assert_array_equal(state.numpy(), bitpack.pack(_oracle(board, 16)).numpy())
    # each package resumes from the other's file
    for name, module, mesh, src in (("ref2", jpod, jmesh.make_mesh((2, 4)), "port"),
                                    ("port2", pod, port_mesh(), "ref")):
        res = module.pod_session(SIZE, TURNS, mesh, resume_from=tmp_path / f"{src}.npz",
                                 events=queue.Queue(), tick_seconds=3600,
                                 out_dir=tmp_path / name, min_chunk=4, max_chunk=4)
        assert res.turns_completed == TURNS
    want = b"P5\n%d %d\n255\n" % (SIZE, SIZE) + _oracle(board, TURNS).tobytes()
    for name in ("ref", "port", "ref2", "port2"):
        assert (tmp_path / name / f"{SIZE}x{SIZE}x{TURNS}.pgm").read_bytes() == want, name


def test_sharded_checkpoint_files_equal_the_reference_both_ways(tmp_path):
    """``save_packed_checkpoint_sharded`` of one board writes the JAX
    package's shard byte for byte, and each package loads the other's."""
    board = _random_board(3)
    mesh, jm = port_mesh(), jmesh.make_mesh((2, 4))
    packed = bitpack.pack(board).numpy()
    state = ShardedBoard.from_global(mesh, packed)
    jstate = jax.device_put(packed, jbit.packed_sharding(jm))
    ck.save_packed_checkpoint_sharded(tmp_path / "p.npz", state, 12)
    jck.save_packed_checkpoint_sharded(tmp_path / "j.npz", jstate, 12)
    p_shard = ck.checkpoint_shard_path(tmp_path / "p.npz", 0, 1)
    j_shard = jck.checkpoint_shard_path(tmp_path / "j.npz", 0, 1)
    assert p_shard.name == "p.rank0of1.npz" and j_shard.name == "j.rank0of1.npz"
    assert p_shard.read_bytes() == j_shard.read_bytes()
    got, turn, rule, axis = ck.load_packed_checkpoint_sharded(
        tmp_path / "j.npz", bit_halo.packed_sharding(mesh))
    np.testing.assert_array_equal(got.numpy(), packed)
    jgot, jturn, _, _ = jck.load_packed_checkpoint_sharded(
        tmp_path / "p.npz", jbit.packed_sharding(jm))
    np.testing.assert_array_equal(np.asarray(jgot), packed)
    assert turn == jturn == 12 and axis == 0
    row0, rows = ck.local_packed_rows(state)
    assert row0 == 0 and rows.shape == packed.shape


def test_pod_session_column_packed_layout(tmp_path):
    """96^2 over (8, 1): only column packing divides; the session runs on
    word_axis 1 (bit_step, as the JAX package runs XLA) and lands equal."""
    size, turns = 96, 12
    board = _random_board(10, size)
    in_path = tmp_path / f"{size}x{size}.pgm"
    _write_pgm(in_path, board)
    assert bit_halo.choose_bit_layout((size, size), (8, 1)) == 1
    tiled.reset_counts()
    ref, got = both_sessions(tmp_path, size, turns, shape=(8, 1), in_path=in_path,
                             tick_seconds=0, min_chunk=4, max_chunk=4)
    assert tiled.plain_calls == 0
    assert [_shape(e) for e in got[1]] == [_shape(e) for e in ref[1]]
    assert len(got[0].alive) == len(ref[0].alive) == int(np.count_nonzero(_oracle(board, turns)))
    assert got[2] == ref[2]


def test_pod_session_rejects_stale_resume(tmp_path):
    from gol_distributed_final_tpu.bigboard import seed_packed as jseed
    from gol_distributed_final_tpu.models import HIGHLIFE as J_HIGHLIFE
    from gol_distributed_final_tpu_torch.bigboard import seed_packed
    from gol_distributed_final_tpu_torch.models import HIGHLIFE

    cells = [(10, 10), (11, 10), (12, 10)]
    ck.save_packed_checkpoint_sharded(
        tmp_path / "p.npz", ShardedBoard.from_global(port_mesh(), seed_packed(SIZE, cells,
                                                                             device="cpu")), 30)
    jck.save_packed_checkpoint_sharded(tmp_path / "j.npz", jseed(SIZE, cells), 30)
    for module, mesh, path, highlife in (
        (pod, port_mesh(), "p.npz", HIGHLIFE), (jpod, jmesh.make_mesh((2, 4)), "j.npz", J_HIGHLIFE)
    ):
        with pytest.raises(ValueError, match="not beyond"):
            module.pod_session(SIZE, 30, mesh, resume_from=tmp_path / path, events=queue.Queue())
        with pytest.raises(ValueError, match="rule"):
            module.pod_session(SIZE, 60, mesh, resume_from=tmp_path / path, rule=highlife,
                               events=queue.Queue())


def test_pgm_roundtrip_and_window_single_host(tmp_path):
    """load_packed_from_pgm_sharded then stream_packed_to_pgm_sharded is
    an identity on the bytes; decode_window_sharded's one-host path equals
    the JAX package's and the board's window."""
    board = _random_board(8)
    in_path = tmp_path / f"{SIZE}x{SIZE}.pgm"
    _write_pgm(in_path, board)
    state = pod.load_packed_from_pgm_sharded(in_path, port_mesh())
    jstate = jpod.load_packed_from_pgm_sharded(in_path, jmesh.make_mesh((2, 4)))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert bitpack.alive_count_packed(state) == int(np.count_nonzero(board))
    out = tmp_path / "round.pgm"
    pod.stream_packed_to_pgm_sharded(out, state, row_block=64)
    assert out.read_bytes() == in_path.read_bytes()
    got = pod.decode_window_sharded(state, 32, 48, 64, 96)
    np.testing.assert_array_equal(got, jpod.decode_window_sharded(jstate, 32, 48, 64, 96))
    np.testing.assert_array_equal(got, board[32:96, 48:144])


def test_load_packed_from_pgm_sharded_rejects_indivisible(tmp_path):
    in_path = tmp_path / "48x48.pgm"
    _write_pgm(in_path, np.zeros((48, 48), np.uint8))
    for module, mesh in ((jpod, jmesh.make_mesh((2, 4))), (pod, port_mesh())):
        with pytest.raises(ValueError, match="not divisible"):
            module.load_packed_from_pgm_sharded(in_path, mesh)


def test_pod_cli_one_process_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``python -m gol_distributed_final_tpu_torch.pod`` in one process
    with four virtual CPU devices: the R-pentomino's count and PGM equal
    the JAX pod's session on its (1, 4) mesh."""
    from gol_distributed_final_tpu.bigboard import r_pentomino
    from gol_distributed_final_tpu_torch.utils import cpumesh

    monkeypatch.setenv(cpumesh.ENV, "4")
    assert pod.main(["-size", "256", "-turns", "40", "-out", str(tmp_path / "port"),
                     "-device", "cpu", "-halo-depth", "2"]) == 0
    out = capsys.readouterr().out
    res = jpod.pod_session(256, 40, jmesh.make_mesh((1, 4), devices=jax.devices()[:4]),
                           cells=r_pentomino(256), events=queue.Queue(), tick_seconds=3600,
                           out_dir=tmp_path / "ref")
    name = "256x256x40.pgm"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    assert f"alive {res.alive_count}\n" in out
    with pytest.raises(SystemExit):
        pod.main(["-resume", "-device", "cpu"])  # -resume without -ck
