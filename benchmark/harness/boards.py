"""Inputs from the seed: seeded symmetries of a configuration's image.

Board ``i`` of a run is the image turned by one of the 8 symmetries of the
square and rolled by (dy, dx) on the torus, all three drawn from a
generator seeded by (seed, i). Conway's rule commutes with both, so every
board of one image does the same work turn for turn (the same alive count
after every turn), and the seed only changes which cells do it.
"""

from __future__ import annotations

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
