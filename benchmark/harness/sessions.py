"""What a driver records of each session."""

from __future__ import annotations

import dataclasses
import pathlib
import time


@dataclasses.dataclass
class Session:
    index: int
    board: tuple | int      # (dy, dx, sym) of an image's or a pattern's board, or a soup's seed
    turns_asked: int
    start_ns: int = 0
    end_ns: int = 0         # its result or its error
    answered: bool = False  # a result holding a final board
    error: str | None = None
    turns: int = -1
    alive: int = -1
    out_path: pathlib.Path | None = None  # the PGM the controller wrote
    #: (y0, x0, uint8[h, w]) blocks of the final board the driver kept, so
    #: that a large PGM can go once they are read
    windows: list = dataclasses.field(default_factory=list)
    #: (ys, xs), int64, of the final board's alive cells as the session
    #: answered them: a board of 2**32 cells judged whole with no raster
    cells: tuple | None = None


def now_ns() -> int:
    """The clock of every record: ns since the epoch, as the profiler's."""
    return time.time_ns()
