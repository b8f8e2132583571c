"""The PyTorch port across processes: real two-rank ``torch.distributed``
jobs on the CPU (gloo), each rank with four virtual CPU devices and one
row of the global (2, 4) mesh, started as the real thing is:

    python -m gol_distributed_final_tpu_torch.pod -coordinator HOST:PORT \\
        -num-processes 2 -process-id {0,1} -device cpu ...

Every rows-axis halo crosses the process boundary as a point-to-point
message, and each rank reads and writes only its own rows of the PGMs and
its own checkpoint shard. Results are held against the golden fixtures,
the single-process port and the JAX package's pod. Mirrors
tests/test_multihost.py. Every child has a timeout of its own: a rank
that misses a collective would otherwise hang its peer.
"""

import os
import queue
import socket
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO_ROOT
from oracle import vector_step

TIMEOUT = 300


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ranks(args_of, n=2):
    """Start ``n`` ranks (``args_of(rank)`` is each one's argument list)
    with four virtual CPU devices each; returns their outputs once all
    exit 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), GOL_TORCH_CPU_DEVICES="4")
    procs = [subprocess.Popen([sys.executable, *args_of(rank)], cwd=REPO_ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs


def _pod(tmp_path, *flags):
    coordinator = f"127.0.0.1:{_free_port()}"
    return _ranks(lambda rank: [
        "-m", "gol_distributed_final_tpu_torch.pod", "-coordinator", coordinator,
        "-num-processes", "2", "-process-id", str(rank), "-device", "cpu", *flags])


def test_two_rank_pod_golden(tmp_path):
    """512^2 x 100 from images/ through the pod CLI on two ranks: the
    streamed PGM equals check/images, and rank 0 prints the count."""
    outs = _pod(tmp_path, "-size", "512", "-turns", "100",
                "-in", str(REPO_ROOT / "images" / "512x512.pgm"), "-out", str(tmp_path / "out"))
    golden = (REPO_ROOT / "check" / "images" / "512x512x100.pgm").read_bytes()
    assert (tmp_path / "out" / "512x512x100.pgm").read_bytes() == golden
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    count = int(np.count_nonzero(read_pgm(REPO_ROOT / "check" / "images" / "512x512x100.pgm")))
    assert f"alive {count}\n" in outs[0] and "alive" not in outs[1]
    assert "Completed Turns 100 Quitting" in outs[0]


def test_two_rank_pod_checkpoint_and_resume(tmp_path):
    """Per-rank checkpoints of a 60-turn two-rank run, each shard byte-
    equal to the JAX package's file of the same rows, resumed on two ranks
    to turn 100: the PGMs equal the golden, the single-process port's run
    and the JAX pod's."""
    import jax
    import torch

    from gol_distributed_final_tpu import pod as jpod
    from gol_distributed_final_tpu.engine import checkpoint as jck
    from gol_distributed_final_tpu.ops import bitpack as jbitpack
    from gol_distributed_final_tpu.parallel import mesh as jmesh
    from gol_distributed_final_tpu_torch import pod
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm
    from gol_distributed_final_tpu_torch.parallel.mesh import make_mesh

    image = REPO_ROOT / "images" / "512x512.pgm"
    ck = tmp_path / "podck.npz"
    _pod(tmp_path, "-size", "512", "-turns", "60", "-in", str(image), "-out",
         str(tmp_path / "out"), "-ck", str(ck), "-ck-every", "40")
    board = read_pgm(image)
    turn = None
    for rank in range(2):
        shard = jck.checkpoint_shard_path(ck, rank, 2)
        with np.load(shard, allow_pickle=False) as data:
            turn = int(data["turn"])
            assert int(data["row0"]) == rank * 8 and int(data["process_index"]) == rank
        assert 40 <= turn < 60
        want = board
        for _ in range(turn):
            want = vector_step(want)
        rows = np.asarray(jbitpack.pack(want, 0))[rank * 8:(rank + 1) * 8]
        ref = jck._save_npz(
            tmp_path / f"ref{rank}.npz", packed=rows, row0=np.int64(rank * 8),
            global_rows=np.int64(16), global_cols=np.int64(512), num_processes=np.int64(2),
            process_index=np.int64(rank), word_axis=np.int64(0), turn=np.int64(turn),
            rulestring=np.str_("B3/S23"))
        assert shard.read_bytes() == ref.read_bytes(), f"shard {rank} differs"
    _pod(tmp_path, "-size", "512", "-turns", "100", "-ck", str(ck), "-resume",
         "-out", str(tmp_path / "out2"))
    golden = (REPO_ROOT / "check" / "images" / "512x512x100.pgm").read_bytes()
    assert (tmp_path / "out2" / "512x512x100.pgm").read_bytes() == golden

    one = pod.pod_session(512, 60, make_mesh((2, 4), devices=[torch.device("cpu")] * 8),
                          in_path=image, events=queue.Queue(), tick_seconds=3600,
                          out_dir=tmp_path / "one")
    ref = jpod.pod_session(512, 60, jmesh.make_mesh((2, 4), devices=jax.devices()[:8]),
                           in_path=image, events=queue.Queue(), tick_seconds=3600,
                           out_dir=tmp_path / "ref")
    assert one.turns_completed == ref.turns_completed == 60
    name = "512x512x60.pgm"
    two = (tmp_path / "out" / name).read_bytes()
    assert two == (tmp_path / "one" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_two_rank_planes_windows_votes_and_chunking(tmp_path):
    """tests/torch_multihost_child.py on two ranks: the byte plane across
    ranks writing one PGM, the global count and a window decoded alike on
    both, a corrupt shard refused on both, agreed chunk growth."""
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = _ranks(lambda rank: [str(REPO_ROOT / "tests" / "torch_multihost_child.py"),
                                coordinator, "2", str(rank), str(tmp_path)])
    assert all(f"rank {rank} done" in out for rank, out in enumerate(outs))
    golden = (REPO_ROOT / "check" / "images" / "64x64x100.pgm").read_bytes()
    assert (tmp_path / "64x64x100.pgm").read_bytes() == golden


def test_initialize_is_a_no_op_for_one_process():
    from gol_distributed_final_tpu_torch.parallel import multihost

    assert multihost.initialize(None, 1, 0, device="cpu") is False
    assert multihost.initialize("127.0.0.1:1", None, None, device="cpu") is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.broadcast_int(5) == 5
    np.testing.assert_array_equal(multihost.allgather(np.array([3, 4])), [[3, 4]])
    with pytest.raises(ValueError):
        multihost.initialize(None, 2, 0, device="cpu")
