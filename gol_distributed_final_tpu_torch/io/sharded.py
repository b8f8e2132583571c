"""Row-range PGM IO for boards larger than one host's memory.

The reference holds the full board in the controller, the broker and
every worker (SURVEY.md §5). Here a board is read and written in row
ranges of the on-disk PGM, so a 65536^2 board (a 4 GiB raster) never
exists in one piece:

* ``create_pgm`` writes the header and sizes the file;
* ``write_rows_at`` puts rows at their offset (safe from several writers
  at once: their ranges are disjoint);
* ``read_shard`` reads one row range (``PgmReader.read_rows``, io/pgm.py,
  which seeks straight to it).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from .pgm import PgmError, PgmReader


def pgm_raster_offset(width: int, height: int) -> int:
    """Byte offset of the raster in a PGM made by ``create_pgm``: what a
    writer that did not create the file passes to ``write_rows_at``."""
    return len(_pgm_header(width, height))


def _pgm_header(width: int, height: int) -> bytes:
    return b"P5\n%d %d\n255\n" % (width, height)


def create_pgm(path, width: int, height: int) -> int:
    """Write the P5 header and size the raster; returns the raster offset."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = _pgm_header(width, height)
    with open(path, "wb") as f:
        f.write(header)
        f.truncate(len(header) + width * height)
    return len(header)


def write_rows_at(path, raster_offset: int, width: int, start_row: int, rows) -> None:
    """Write ``rows`` (uint8 [n, width]) at their offset in the raster."""
    rows = np.ascontiguousarray(rows, np.uint8)
    if rows.ndim != 2 or rows.shape[1] != width:
        raise PgmError(f"row block shape {rows.shape} does not match width {width}")
    fd = os.open(str(path), os.O_WRONLY)
    try:
        os.pwrite(fd, rows.tobytes(), raster_offset + start_row * width)
        os.fsync(fd)
    finally:
        os.close(fd)


def read_shard(path, start_row: int, stop_row: int) -> np.ndarray:
    """Rows ``[start_row, stop_row)`` of an on-disk board."""
    with PgmReader(path) as r:
        return r.read_rows(start_row, stop_row)


def write_board_sharded(path, width: int, height: int, shards) -> None:
    """One process's form: ``shards`` is an iterable of (start_row, rows)
    pairs; creates the file, then writes each shard."""
    offset = create_pgm(path, width, height)
    for start_row, rows in shards:
        write_rows_at(path, offset, width, start_row, rows)
