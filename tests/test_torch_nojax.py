"""The PyTorch port stands alone: it imports neither jax nor the JAX package
(not even that package's jax-free modules), its entry points compute on
the CUDA card unless asked for the CPU, and no code path of its data
planes catches a kernel failure to reroute it.
"""

import ast
import io
import json
import os
import pathlib
import queue
import socket
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO_ROOT
from oracle import vector_step

PORT = REPO_ROOT / "gol_distributed_final_tpu_torch"
JAX_PACKAGE = "gol_distributed_final_tpu"


def _forbidden(module: str) -> bool:
    """jax, or the JAX package itself — matched exactly or as a dotted
    prefix, since the port's own name starts with the same text."""
    return any(
        module == root or module.startswith(root + ".")
        for root in ("jax", "jaxlib", JAX_PACKAGE)
    )


def test_forbidden_matches_the_prefix_exactly():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden(JAX_PACKAGE) and _forbidden(JAX_PACKAGE + ".ops.bitpack")
    assert not _forbidden(JAX_PACKAGE + "_torch")
    assert not _forbidden(JAX_PACKAGE + "_torch.ops")
    assert not _forbidden("jaxtyping")


_PROBE = """
import json, runpy, sys
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
print("MODULES " + json.dumps(sorted(sys.modules)))
"""


def _probe(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, module, *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.split("MODULES ", 1)[1])
    assert [m for m in modules if _forbidden(m)] == []
    return proc.stdout, modules


def test_cli_session_imports_no_jax(tmp_path):
    """The session CLI and the big-board CLI, each in a process of its
    own on the CPU: neither loads jax or the JAX package."""
    (tmp_path / "images").symlink_to(REPO_ROOT / "images")
    out, modules = _probe(
        "gol_distributed_final_tpu_torch",
        ["-w", "64", "-h", "64", "-turns", "10", "-noVis", "-device", "cpu"], tmp_path)
    assert "Completed Turns 10 Quitting" in out
    assert "gol_distributed_final_tpu_torch.engine.engine" in modules

    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    want = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    for _ in range(10):
        want = vector_step(want)
    np.testing.assert_array_equal(read_pgm(tmp_path / "out" / "64x64x10.pgm"), want)

    out, modules = _probe(
        "gol_distributed_final_tpu_torch.bigboard",
        ["-size", "256", "-turns", "3", "-out", str(tmp_path / "big.pgm"), "-device", "cpu"],
        tmp_path)
    assert "alive 9\n" in out
    assert "gol_distributed_final_tpu_torch.io.sharded" in modules
    assert np.count_nonzero(read_pgm(tmp_path / "big.pgm")) == 9


def test_pod_session_imports_no_jax(tmp_path, monkeypatch):
    """The pod CLI in a process of its own on four virtual CPU devices (a
    (1, 4) mesh, each block on the tiled kernel's plain version): the
    count, the PGM, and no jax or JAX package in sys.modules."""
    monkeypatch.setenv("GOL_TORCH_CPU_DEVICES", "4")
    out, modules = _probe(
        "gol_distributed_final_tpu_torch.pod",
        ["-size", "256", "-turns", "30", "-out", str(tmp_path / "out"), "-device", "cpu"],
        tmp_path)
    for name in ("parallel.mesh", "parallel.halo", "parallel.bit_halo",
                 "parallel.multihost", "utils.cpumesh", "ops.tiled"):
        assert f"gol_distributed_final_tpu_torch.{name}" in modules
    from gol_distributed_final_tpu_torch.bigboard import r_pentomino
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    board = np.zeros((256, 256), np.uint8)
    for x, y in r_pentomino(256):
        board[y, x] = 255
    for _ in range(30):
        board = vector_step(board)
    assert f"alive {int(np.count_nonzero(board))}\n" in out
    np.testing.assert_array_equal(read_pgm(tmp_path / "out" / "256x256x30.pgm"), board)


_SPARSE_PROBE = """
import json, os, sys
os.environ["GOL_SPARSE"] = "on"
from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles
from gol_distributed_final_tpu_torch.io import native
from gol_distributed_final_tpu_torch import viz
from gol_distributed_final_tpu_torch.__main__ import main
assert main(["-w", "256", "-h", "256", "-turns", "20", "-noVis", "-device", "cpu"]) == 0
assert sparse_tiles.plain_calls > 0, "the session missed the sparse plane"
print("MODULES " + json.dumps(sorted(sys.modules)))
"""


def test_sparse_session_and_visualiser_import_no_jax(tmp_path):
    """The sparse plane, its kernel's wrapper, the visualiser and the
    native codec, imported in a process of its own that runs a 256^2
    session on the sparse plane (GOL_SPARSE=on): no jax, no JAX package."""
    (tmp_path / "images").symlink_to(REPO_ROOT / "images")
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    proc = subprocess.run([sys.executable, "-c", _SPARSE_PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.split("MODULES ", 1)[1])
    assert [m for m in modules if _forbidden(m)] == []
    for name in ("ops.sparse", "ops.sparse_tiles", "io.native", "viz", "viz.window"):
        assert f"gol_distributed_final_tpu_torch.{name}" in modules
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm

    want = read_pgm(REPO_ROOT / "images" / "256x256.pgm")
    for _ in range(20):
        want = vector_step(want)
    np.testing.assert_array_equal(read_pgm(tmp_path / "out" / "256x256x20.pgm"), want)


_BROKER_PROBE = """
import json, runpy, sys
sys.argv = ["gol_distributed_final_tpu_torch.rpc.broker"] + sys.argv[1:]
runpy.run_module("gol_distributed_final_tpu_torch.rpc.broker", run_name="__main__")
print("MODULES " + json.dumps(sorted(sys.modules)), flush=True)
"""


def test_broker_reading_reference_frames_imports_no_jax():
    """A port broker unpickles frames that name the JAX package's classes
    (gol_distributed_final_tpu.rpc.protocol.Request) and still never loads
    that package, or jax."""
    from gol_distributed_final_tpu.rpc import protocol as jproto
    from test_torch_rpc import TIMEOUT, _Proc

    proc = _Proc(["-c", _BROKER_PROBE, "-port", "0", "-device", "cpu"])
    try:
        line = proc.wait_for("broker listening on :")
        port = int(line.rsplit(":", 1)[1].split()[0])
        with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as sock:
            sock.settimeout(TIMEOUT)
            frames = []
            for call_id, method, req in (
                (1, jproto.Methods.RETRIEVE, jproto.Request(include_world=True)),
                (2, jproto.Methods.SUPER_QUIT, jproto.Request()),
            ):
                frame = io.BytesIO()

                class Capture:
                    def sendall(self, data):
                        frame.write(bytes(data))

                envelope = {"id": call_id, "method": method, "request": req}
                jproto.send_frame(Capture(), envelope)
                frames.append(frame.getvalue())
                sock.sendall(frames[-1])
                reply = jproto.recv_frame(sock)
                assert reply["id"] == call_id and "error" not in reply, reply
                assert type(reply["result"]) is jproto.Response
        assert b"gol_distributed_final_tpu.rpc.protocol" in frames[0]
        assert b"Request" in frames[0]
        line = proc.wait_for("MODULES ")
        assert proc.proc.wait(timeout=TIMEOUT) == 0, "".join(proc.seen)
    finally:
        proc.stop()
    modules = json.loads(line.split("MODULES ", 1)[1])
    assert "gol_distributed_final_tpu_torch.rpc.protocol" in modules
    assert [m for m in modules if _forbidden(m)] == []


_WORKERS_PROBE = """
import json, sys
from gol_distributed_final_tpu_torch.rpc import broker, worker
from gol_distributed_final_tpu_torch.ops import strip_steps
from gol_distributed_final_tpu_torch.__main__ import main
workers = [worker.serve(0, device="cpu") for _ in range(2)]
server, service = broker.serve(
    port=0, backend="workers", wire="resident", halo_depth=8, device="cpu",
    worker_addresses=[f"127.0.0.1:{w.port}" for w, _ in workers])
assert main(["-w", "64", "-h", "64", "-turns", "100", "-noVis",
             "-server", f"127.0.0.1:{server.port}"]) == 0
assert strip_steps.plain_calls > 0, "no batch took the fused path"
service.shutdown()
for w, _ in workers:
    w.stop()
print("MODULES " + json.dumps(sorted(sys.modules)))
"""


def test_workers_broker_and_workers_import_no_jax(tmp_path):
    """A 64^2 session through a port workers broker over two port workers
    on the resident wire, every batch fused (GOL_WORKER_FUSED=on: the
    strip kernel's plain version on the CPU), in a process of its own: the
    golden PGM, and no jax or JAX package in sys.modules."""
    (tmp_path / "images").symlink_to(REPO_ROOT / "images")
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), GOL_WORKER_FUSED="on")
    proc = subprocess.run([sys.executable, "-c", _WORKERS_PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.split("MODULES ", 1)[1])
    assert [m for m in modules if _forbidden(m)] == []
    for name in ("rpc.broker", "rpc.worker", "rpc.faults", "ops.strip_steps"):
        assert f"gol_distributed_final_tpu_torch.{name}" in modules
    assert (tmp_path / "out" / "64x64x100.pgm").read_bytes() == (
        REPO_ROOT / "check" / "images" / "64x64x100.pgm").read_bytes()


@pytest.mark.parametrize("module, args, says, loads", [
    ("gol_distributed_final_tpu_torch.analysis", [], "analysis ok",
     "gol_distributed_final_tpu_torch.analysis.lockorder"),
    ("gol_distributed_final_tpu_torch.obs.regress",
     [str(REPO_ROOT / "BENCH_r04.json"), str(REPO_ROOT / "BENCH_r05.json")], "bench diff",
     "gol_distributed_final_tpu_torch.obs"),
    ("gol_distributed_final_tpu_torch.obs.canary", ["--selfcheck", "-device", "cpu"],
     "canary selfcheck ok", "gol_distributed_final_tpu_torch.rpc.broker"),
])
def test_operator_tools_import_no_jax(module, args, says, loads, tmp_path):
    """The static analysis, the bench diff and the canary's loopback probe,
    each in a process of its own: none loads jax or the JAX package."""
    out, modules = _probe(module, args, tmp_path)
    assert says in out and loads in modules


def _port_sources():
    files = sorted(PORT.rglob("*.py"))
    assert PORT / "rpc" / "broker.py" in files and PORT / "rpc" / "protocol.py" in files
    for new in ("ops/sparse.py", "ops/sparse_tiles.py", "io/native.py", "viz/window.py",
                "viz/loop.py", "viz/bigview.py", "utils/visualise.py", "rpc/worker.py",
                "rpc/faults.py", "ops/strip_steps.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/halo.py", "parallel/bit_halo.py",
                "parallel/multihost.py", "pod.py", "utils/cpumesh.py",
                *(f"obs/{m}.py" for m in ("canary", "loadgen", "doctor", "watch", "fleet",
                                          "history", "regress", "flame", "lint")),
                *(f"analysis/{m}.py" for m in ("__init__", "__main__", "core", "skew", "locks",
                                               "lockorder", "hygiene", "lints")),
                "ops/whole_board.py", "ops/bitpack.py", "ops/stencil.py", "models/life.py"):
        assert PORT / new in files
    # what the card's host runs beside the package: the smoke, the card's
    # tests and the soaks they share with the CPU tests
    return files + [REPO_ROOT / "chip_smoke.py", REPO_ROOT / "tests" / "test_torch_cuda.py",
                    REPO_ROOT / "tests" / "torch_soak.py"]


def test_native_sources_name_no_jax_or_the_jax_package():
    """The port's C++ (native/, csrc/) includes nothing of the JAX
    package's tree or of jax, and its one build recipe (io/native.py,
    which viz/window.py calls) compiles sources from the port's own
    native/: the include directives are scanned (the sources' comments
    name the JAX functions they replace)."""
    import re

    from gol_distributed_final_tpu_torch.io import native

    files = [f for f in sorted((PORT / "native").rglob("*")) + sorted(
        (PORT / "csrc").rglob("*")) if f.is_file() and f.suffix != ".so"]
    assert PORT / "native" / "pgm_codec.cc" in files
    assert native.NATIVE_DIR == PORT / "native"
    pattern = re.compile(r"\bjax|gol_distributed_final_tpu(?!_torch)|\.\./\.\.")
    found = [f"{f.name}:{i}" for f in files
             for i, line in enumerate(f.read_text().splitlines(), 1)
             if line.lstrip().startswith("#include") and pattern.search(line)]
    assert found == []


def test_no_source_imports_jax_or_the_jax_package():
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert found == []


def test_data_planes_have_no_rerouting_handlers():
    """A failed launch raises: nothing under ops/ or parallel/ or in the
    engine catches an exception (so nothing can send a CUDA tensor to a
    plain version)."""
    handlers = []
    for path in (sorted((PORT / "ops").glob("*.py")) + sorted((PORT / "parallel").glob("*.py"))
                 + [PORT / "engine" / "engine.py"]):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.ExceptHandler):
                handlers.append(f"{path.name}:{node.lineno}")
    assert handlers == []


def test_run_defaults_to_the_card_and_raises_without_one(monkeypatch, tmp_path):
    import torch

    from gol_distributed_final_tpu_torch import Params, run
    from gol_distributed_final_tpu_torch.device import resolve_device
    from gol_distributed_final_tpu_torch.engine.controller import CLOSED

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    events = queue.Queue()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(Params(turns=1, image_width=64, image_height=64), events,
            images_dir=REPO_ROOT / "images", out_dir=tmp_path / "out")
    assert events.get_nowait() is CLOSED  # the stream still terminates
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")

    from gol_distributed_final_tpu_torch.engine import Engine
    from gol_distributed_final_tpu_torch.ops.plane import BitPlane, BytePlane

    for make in (Engine, BitPlane, BytePlane):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_cli_refuses_the_visualiser_and_a_missing_card(monkeypatch, capsys, tmp_path):
    """The visualiser is no longer refused: without -noVis a CPU session
    runs through it and quits. A missing card is refused, with the
    visualiser or without it, before any thread starts."""
    import torch

    from gol_distributed_final_tpu_torch.__main__ import main

    (tmp_path / "images").symlink_to(REPO_ROOT / "images")
    monkeypatch.chdir(tmp_path)
    assert main(["-w", "16", "-h", "16", "-turns", "1", "-device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "-noVis" not in out.err and "Completed Turns 1 Quitting" in out.out
    assert (tmp_path / "out" / "16x16x1.pgm").read_bytes() == (
        REPO_ROOT / "check" / "images" / "16x16x1.pgm").read_bytes()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["-w", "16", "-h", "16", "-turns", "1"])  # -device cuda, the visualiser
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        main(["-w", "16", "-h", "16", "-turns", "1", "-noVis"])  # -device cuda
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_chip_smoke_exits_nonzero_alone(tmp_path):
    """chip_smoke.py without the package beside it (or without a card)
    fails and prints no result line."""
    (tmp_path / "chip_smoke.py").write_bytes((REPO_ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
