"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
``build/cuda/`` at the root of the checkout. The library's file name
carries a digest of its sources and flags, so an edited source never
loads a stale build. Nothing is built when a module is imported: the
first launch of a kernel builds it, or ``build`` builds several at once,
one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from ..obs import device as _device

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "cuda"
SOURCES = ("whole_board", "tiled", "byte_board", "byte_tiled", "sparse_tiles", "strip_steps")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.RLock()  # one build of a source at a time per process
_LIBS: dict = {}


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc, else /usr/local/cuda's, else
    the one on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source that has no current build, one nvcc
    each, all in parallel. Returns {name: ptxas report} for the sources
    compiled now (registers, shared memory and spills per kernel, from
    ``-Xptxas -v``); raises with nvcc's output if any build fails."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if not library_path(n).exists()]
        procs = {}
        t0 = time.monotonic()
        for name in todo:
            # a per-process temporary name, renamed into place: processes
            # building the same source at once never see a partial library
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        reports, failed = {}, []
        for name, (tmp, proc) in procs.items():
            output, _ = proc.communicate()
            reports[name] = output
            # the build's wall up to the collection of its output: at most
            # the slowest build started with it
            _device.note_build(name, time.monotonic() - t0)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{output}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C function to its argtypes; every function
    returns an int (a cudaError_t, 0 on success)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _device.note_build_request(name)
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")
