"""ctypes binding to the port's native PGM codec (native/pgm_codec.cc), and
the g++ build of the port's native libraries.

Each library builds with g++ at first use into ``build/native/`` at the
root of the checkout, under a name that carries a digest of its sources
and flags, so an edited source never loads a stale build. Every codec
entry point returns None (or False) when the library cannot be had: no
g++, a failed build, or ``GOL_TPU_NO_NATIVE`` set. io/pgm.py then takes
the Python codec, as the JAX package does for its host IO. ``used``
counts the raster reads and writes the library served.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXXFLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-shared")

#: raster reads and writes the native codec served
used = 0

_lock = threading.Lock()
_lib = None
_lib_tried = False


def library_path(name: str, sources, flags=()) -> pathlib.Path:
    digest = hashlib.sha256(" ".join((CXX, *CXXFLAGS, *flags)).encode())
    for src in sources:
        digest.update((NATIVE_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, sources, flags=()) -> pathlib.Path | None:
    """The shared library ``lib<name>`` of ``sources`` (paths under
    native/), compiled now unless a current build exists; None if g++ is
    missing or fails. A per-process temporary name renamed into place
    keeps processes that build at once from loading a partial file."""
    path = library_path(name, sources, flags)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXXFLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in sources), *flags]
    try:
        subprocess.run(cmd, cwd=NATIVE_DIR, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)
    return path


def _load():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("GOL_TPU_NO_NATIVE"):
            return None
        path = build("golio", ["pgm_codec.cc"])
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.golio_read_header.argtypes = [ctypes.c_char_p] + [
            ctypes.POINTER(ctypes.c_long)
        ] * 4
        lib.golio_read_header.restype = ctypes.c_int
        lib.golio_read_rows.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.golio_read_rows.restype = ctypes.c_int
        lib.golio_write.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.golio_write.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _count_use() -> None:
    global used
    with _lock:
        used += 1


def read_header(path) -> tuple[int, int, int, int] | None:
    """(width, height, maxval, raster_offset) or None if unavailable/invalid."""
    lib = _load()
    if lib is None:
        return None
    w, h, m, off = (ctypes.c_long() for _ in range(4))
    rc = lib.golio_read_header(str(path).encode(), w, h, m, off)
    if rc != 0:
        return None
    return w.value, h.value, m.value, off.value


def read_rows(path, offset: int, width: int, start: int, stop: int):
    """uint8[stop-start, width] or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(((stop - start), width), np.uint8)
    rc = lib.golio_read_rows(
        str(path).encode(),
        offset,
        width,
        start,
        stop,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0:
        return None
    _count_use()
    return out


def write_board(path, board: np.ndarray) -> bool:
    """Write + fsync a full P5 board; False if unavailable/failed."""
    lib = _load()
    if lib is None:
        return False
    board = np.ascontiguousarray(board, np.uint8)
    rc = lib.golio_write(
        str(path).encode(),
        board.shape[1],
        board.shape[0],
        board.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0:
        return False
    _count_use()
    return True
