"""A configuration's check for a seeded pattern of live cells, judged whole
by the exact sparse reference, on a board of any size.

A configuration names it with ``"check": "cells"`` beside a pattern board
(``"board": {"kind": "cells", "file": "inputs/<name>.cells"}``); each
session's ``Session.board`` is the (dy, dx, sym) that placed its pattern
(``harness/boards.py``), and ``Session.cells`` the final board's alive
cells as the session answered them. For every answered session:

* its turns completed equal the turns asked;
* its alive count equals the reference's;
* its answered cells are exactly the reference's, ``reference.evolve_cells``
  of its placed pattern: no cell moved, missing or extra;
* where the driver kept its final PGM (``Session.out_path``), the live
  cells of that PGM, read in blocks of rows, are the same set; the PGM is
  then deleted.

At least one session, at least one live cell of the reference, and at
least one session whose reference cells lie on both sides of both seams
of the torus (in its first and its last quarter of rows, and of columns)
have to have been compared: a program that does not wrap goes wrong only
where cells meet across a seam, and board 0's placement on the torus's
corner puts them there. Life is exact, so every other limit is 0 wrong.

Each distinct (placement, turns) evolves once, and its result judges
every session of that board. The cost is the reference's: about 1 s per
distinct 10**4-turn R-pentomino (~116 live cells) on one CPU core: at
most 64 s for a pool of 64, about 1 s a session where a window holds fewer
sessions than the pool has boards.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference
from benchmark.harness import boards, manifest

#: the numbers held from below; every other is held from above
AT_LEAST = frozenset({"sessions_checked", "wrap_sessions_checked", "alive_checked"})
#: rows of a PGM read at a time
ROWS = 1024


def pgm_cells(path, shape) -> tuple[np.ndarray, np.ndarray] | None:
    """``(ys, xs)``, int64, of the live cells of the PGM at ``path``, read
    in blocks of ``ROWS`` rows, in row order; None where it is not of
    ``shape`` (height, width)."""
    ys, xs, rows = [], [], 0
    for block in reference.pgm_row_blocks(path, ROWS):
        if block.shape[1] != shape[1]:
            return None
        y, x = np.nonzero(block)
        ys.append(y.astype(np.int64) + rows)
        xs.append(x.astype(np.int64))
        rows += block.shape[0]
    if rows != shape[0]:
        return None
    return np.concatenate(ys), np.concatenate(xs)


def _same(cells, want) -> bool:
    """Whether the ``(ys, xs)`` of ``cells``, in any order, are exactly
    ``want`` (sorted by row, then column), each cell once."""
    ys, xs = (np.asarray(a, np.int64).ravel() for a in cells)
    if ys.shape != xs.shape or ys.shape != want[0].shape:
        return False
    order = np.lexsort((xs, ys))
    return bool(np.array_equal(ys[order], want[0]) and np.array_equal(xs[order], want[1]))


def _both_sides(coords, size: int) -> bool:
    """Live cells in the first and in the last quarter of ``size``."""
    return bool(np.any(coords < size // 4) and np.any(coords >= size - size // 4))


def compare(sessions, ctx) -> dict:
    """``{name: (value, limit, holds)}`` over ``sessions``."""
    config = ctx.config
    height, width, rule = config["height"], config["width"], config["rule"]
    ys, xs = boards.pattern(manifest.BENCH / ctx.board["file"], (height, width))
    finals = {}  # (placement, turns) -> the reference's final cells
    unanswered = wrong_turns = wrong_alive = wrong_cells = wrong_pgm = 0
    checked = wrap_checked = alive_checked = 0
    for s in sessions:
        if not s.answered:
            unanswered += 1
            continue
        key = (s.board, s.turns_asked)
        if key not in finals:
            placed = boards.place(ys, xs, s.board, (height, width))
            finals[key] = reference.evolve_cells(*placed, s.turns_asked, height, width, rule)
        want = finals[key]
        checked += 1
        alive_checked += len(want[0])
        wrap_checked += _both_sides(want[0], height) and _both_sides(want[1], width)
        wrong_turns += s.turns != s.turns_asked
        wrong_alive += s.alive != len(want[0])
        wrong_cells += s.cells is None or not _same(s.cells, want)
        if s.out_path is not None:
            kept = pgm_cells(s.out_path, (height, width))
            s.out_path.unlink()
            wrong_pgm += kept is None or not _same(kept, want)
    return {
        "unanswered": (unanswered, 0, unanswered <= 0),
        "wrong_turns": (wrong_turns, 0, wrong_turns <= 0),
        "wrong_alive": (wrong_alive, 0, wrong_alive <= 0),
        "wrong_cells": (wrong_cells, 0, wrong_cells <= 0),
        "wrong_pgm": (wrong_pgm, 0, wrong_pgm <= 0),
        "sessions_checked": (checked, 1, checked >= 1),
        "wrap_sessions_checked": (wrap_checked, 1, wrap_checked >= 1),
        "alive_checked": (alive_checked, 1, alive_checked >= 1),
    }
