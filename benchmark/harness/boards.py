"""Inputs from the seed: seeded symmetries of a configuration's image or of
its pattern of live cells.

Board ``i`` of a run is the image turned by one of the 8 symmetries of the
square and rolled by (dy, dx) on the torus, all three drawn from a
generator seeded by (seed, i). Conway's rule commutes with both, so every
board of one image does the same work turn for turn (the same alive count
after every turn), and the seed only changes which cells do it.

A pattern (``"board": {"kind": "cells", "file": ...}``) is a file of live
cells in the pattern's own frame, one ``x y`` pair a line, ``#`` comments
allowed. Its board ``i`` is the pattern centred on the torus, its cell
(x, y) at (height // 2 + y, width // 2 + x), as
``gol_distributed_final_tpu_torch.bigboard.r_pentomino`` centres the
R-pentomino, then placed by ``transforms(seed, count, shape)[i]``: the same
(dy, dx, sym) as ``reference.transform`` gives a board, applied to the
coordinates (``place``). Board 0 keeps its symmetry but is rolled instead
so that the pattern's centre, the middle of its bounding box, lies on the
torus's corner (0, 0): every run then has a session whose cells straddle
both seams of the torus from the first turn, where a program that does not
wrap goes wrong (``placements``).
"""

from __future__ import annotations

import pathlib

import numpy as np


def _seed(seed: int) -> int:
    return seed % (1 << 64)


def transforms(seed: int, count: int, shape) -> list[tuple[int, int, int]]:
    """``(dy, dx, sym)`` of boards 0 .. count - 1."""
    out = []
    for i in range(count):
        rng = np.random.default_rng([_seed(seed), i])
        out.append((int(rng.integers(shape[0])), int(rng.integers(shape[1])),
                    int(rng.integers(8))))
    return out


def pattern(path, shape) -> tuple[np.ndarray, np.ndarray]:
    """``(ys, xs)``, int64, of the pattern file at ``path`` centred on a
    torus of ``shape`` (height, width)."""
    pairs = []
    for number, line in enumerate(pathlib.Path(path).read_text().splitlines(), 1):
        words = line.split("#", 1)[0].split()
        if not words:
            continue
        try:
            x, y = map(int, words)
        except ValueError:
            raise ValueError(f"{path}:{number}: not an 'x y' pair: {line!r}") from None
        pairs.append((y, x))
    if not pairs:
        raise ValueError(f"{path}: no live cell")
    ys, xs = np.array(pairs, np.int64).T
    return (ys + shape[0] // 2) % shape[0], (xs + shape[1] // 2) % shape[1]


def place(ys, xs, t, shape) -> tuple[np.ndarray, np.ndarray]:
    """The cells ``(ys, xs)`` of a ``shape`` torus moved as
    ``reference.transform(board, *t)`` moves a board's: bit 2 of ``sym``
    mirrors, bits 0-1 turn by quarters, then the roll by (dy, dx)."""
    dy, dx, sym = t
    height, width = shape
    if sym & 1 and height != width:
        raise ValueError("a quarter turn needs a square board")
    ys, xs = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
    if sym & 4:
        xs = width - 1 - xs
    for _ in range(sym & 3):  # np.rot90: (y, x) -> (width - 1 - x, y)
        ys, xs = width - 1 - xs, ys
    return (ys + dy) % height, (xs + dx) % width


def placements(seed: int, count: int, shape, ys, xs) -> list[tuple[int, int, int]]:
    """``(dy, dx, sym)`` of boards 0 .. count - 1 of the centred pattern
    ``(ys, xs)``: ``transforms``, with board 0 rolled so that the
    pattern's centre lies on (0, 0)."""
    out = transforms(seed, count, shape)
    sym = out[0][2]
    centre = ([(np.min(ys) + np.max(ys)) // 2], [(np.min(xs) + np.max(xs)) // 2])
    cy, cx = place(*centre, (0, 0, sym), shape)
    out[0] = (int(-cy[0] % shape[0]), int(-cx[0] % shape[1]), sym)
    return out
