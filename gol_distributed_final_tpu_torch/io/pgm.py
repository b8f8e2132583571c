"""PGM (P5) board IO: ``images/<W>x<H>.pgm`` in, ``out/<W>x<H>x<Turns>.pgm``
out, P5 with maxval 255, strict validation (reference: gol/io.go:12-149).

Boards of at least ``_NATIVE_THRESHOLD_BYTES`` are written through the
native C++ codec (io/native.py, built at first use) when it can be had,
smaller ones and every board where it cannot through the numpy codec: the
two write the same bytes and both fsync. Every read is numpy's. On the
host of an H100 machine, over two runs at 1024^2 to 16384^2, the native
write took 0.69-0.97x the numpy write's time, while the native read went
from 1.19x slower to 1.27x faster (chip_smoke.py's "timing PGM codecs").

Validation mirrors gol/io.go:103-120, including the messages:
"Not a pgm file", "Incorrect width", "Incorrect height",
"Incorrect maxval/bit depth".
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from ..obs import tracing as _tracing


class PgmError(Exception):
    """Raised on malformed or mismatching PGM input (gol/io.go panics)."""


# boards at least this large are written through the native C++ codec when
# it is available (io/native.py builds it; small boards are not worth the hop)
_NATIVE_THRESHOLD_BYTES = 1 << 20


_WHITESPACE = b" \t\n\r\x0b\x0c"


def _parse_header(f) -> tuple[str, int, int, int, int]:
    """Parse a PNM header, returning (magic, width, height, maxval, data_offset).

    Handles '#' comments and arbitrary whitespace, per the PGM spec — a
    superset of what the reference accepts (it splits the whole file on
    whitespace, gol/io.go:101).
    """
    tokens: list[bytes] = []
    pos = 0
    f.seek(0)
    data = f.read(4096)  # headers are tiny; 4 KiB is generous
    while len(tokens) < 4:
        if pos >= len(data):
            raise PgmError("Not a pgm file")
        c = data[pos : pos + 1]
        if c in _WHITESPACE:
            pos += 1
        elif c == b"#":
            nl = data.find(b"\n", pos)
            if nl == -1:
                raise PgmError("Not a pgm file")
            pos = nl + 1
        else:
            end = pos
            while end < len(data) and data[end : end + 1] not in _WHITESPACE:
                end += 1
            tokens.append(data[pos:end])
            pos = end
    # exactly one whitespace byte separates the header from the raster
    if pos >= len(data) or data[pos : pos + 1] not in _WHITESPACE:
        raise PgmError("Not a pgm file")
    pos += 1
    magic = tokens[0].decode("ascii", "replace")
    try:
        width, height, maxval = (int(t) for t in tokens[1:4])
    except ValueError as e:
        raise PgmError("Not a pgm file") from e
    return magic, width, height, maxval, pos


class PgmReader:
    """Random-access P5 reader: header up front, rows on demand."""

    def __init__(self, path, *, expect_width=None, expect_height=None):
        self.path = pathlib.Path(path)
        self._f = open(self.path, "rb")
        try:
            magic, w, h, maxval, offset = _parse_header(self._f)
            if magic != "P5":
                raise PgmError("Not a pgm file")
            if expect_width is not None and w != expect_width:
                raise PgmError("Incorrect width")
            if expect_height is not None and h != expect_height:
                raise PgmError("Incorrect height")
            if maxval != 255:
                raise PgmError("Incorrect maxval/bit depth")
        except BaseException:
            self._f.close()
            raise
        self.width, self.height, self._offset = w, h, offset

    def read_rows(self, start: int, stop: int) -> np.ndarray:
        if not 0 <= start <= stop <= self.height:
            raise PgmError(f"row range [{start}, {stop}) outside board height {self.height}")
        n = stop - start
        self._f.seek(self._offset + start * self.width)
        buf = self._f.read(n * self.width)
        if len(buf) != n * self.width:
            raise PgmError("Not a pgm file")
        return np.frombuffer(buf, np.uint8).reshape(n, self.width)

    def read_all(self) -> np.ndarray:
        return self.read_rows(0, self.height)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PgmWriter:
    """Streaming P5 writer: header first, then rows appended top to bottom.

    ``close`` fsyncs, matching the reference's durability behavior
    (gol/io.go:84-85).
    """

    def __init__(self, path, width: int, height: int):
        self.path = pathlib.Path(path)
        self.width, self.height = width, height
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._f.write(b"P5\n%d %d\n255\n" % (width, height))
        self._rows_written = 0

    def write_rows(self, rows: np.ndarray):
        rows = np.ascontiguousarray(rows, np.uint8)
        if rows.ndim != 2 or rows.shape[1] != self.width:
            raise PgmError(f"row block shape {rows.shape} does not match width {self.width}")
        self._rows_written += rows.shape[0]
        if self._rows_written > self.height:
            raise PgmError("more rows written than the declared height")
        self._f.write(rows.tobytes())

    def close(self):
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        if self._rows_written != self.height:
            raise PgmError(
                f"wrote {self._rows_written} rows, declared {self.height}"
            )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._f.close()


def read_pgm(path, *, expect_width=None, expect_height=None) -> np.ndarray:
    """Read a whole P5 board as ``uint8[H, W]`` with reference validation."""
    with PgmReader(path, expect_width=expect_width, expect_height=expect_height) as r:
        return r.read_all()


def write_pgm(path, board: np.ndarray) -> None:
    """Write a whole ``uint8[H, W]`` board as P5 (fsynced)."""
    board = np.asarray(board, np.uint8)
    if board.ndim != 2:
        raise PgmError(f"board must be 2-D, got shape {board.shape}")
    if board.nbytes >= _NATIVE_THRESHOLD_BYTES:
        from . import native

        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        if native.write_board(path, board):
            return
    with PgmWriter(path, board.shape[1], board.shape[0]) as w:
        w.write_rows(board)


def read_board(params, images_dir="images") -> np.ndarray:
    """Load ``images/<W>x<H>.pgm`` per the filename convention
    (gol/distributor.go:144, gol/io.go:95)."""
    path = pathlib.Path(images_dir) / f"{params.input_filename}.pgm"
    span = _tracing.start_span(_tracing.SPAN_IO_PGM_READ)
    try:
        return read_pgm(
            path,
            expect_width=params.image_width,
            expect_height=params.image_height,
        )
    finally:
        _tracing.end_span(span)


def write_board(board, filename: str, out_dir="out") -> pathlib.Path:
    """Write the board to ``out/<filename>.pgm`` (gol/io.go:42-48)."""
    path = pathlib.Path(out_dir) / f"{filename}.pgm"
    span = _tracing.start_span(_tracing.SPAN_IO_PGM_WRITE)
    try:
        write_pgm(path, board)
    finally:
        _tracing.end_span(span)
    print(f"File {filename} output done!")
    return path
