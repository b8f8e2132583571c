"""The seeded soup: a configuration's board made from the run's seed.

The definition, for the benchmark and for any code that makes the same
board elsewhere (on the card, say) and must equal it cell for cell. Cell
(y, x) of a ``height x width`` torus, 0 <= y < height and 0 <= x < width,
is alive iff

    (splitmix64(((seed mod 2**32) << 32) + y * width + x) >> 32) < density * 2**32

in unsigned 64-bit arithmetic (every sum and product modulo 2**64), where

    splitmix64(v):
        z = v + 0x9E3779B97F4A7C15
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB
        return z ^ (z >> 31)

is the first output of Steele, Lea and Flood's SplitMix64 generator started
at state ``v``. ``density * 2**32`` is a real number (exact in a double for
any double ``density``), so a cell is alive iff its high 32 bits are below
``ceil(density * 2**32)``. The counter ``y * width + x`` needs
``height * width <= 2**32``, which a 65536 x 65536 board meets.

This module is the seeded data that stands in for weights: plain NumPy,
and nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MIX1 = np.uint64(0xBF58476D1CE4E5B9)
MIX2 = np.uint64(0x94D049BB133111EB)


def splitmix64(v: np.ndarray) -> np.ndarray:
    """The definition's ``splitmix64`` on every element of a uint64 array."""
    z = np.asarray(v, np.uint64) + GOLDEN
    z = (z ^ (z >> np.uint64(30))) * MIX1
    z = (z ^ (z >> np.uint64(27))) * MIX2
    return z ^ (z >> np.uint64(31))


def threshold(density: float) -> int:
    """The least high half of a hash that reads dead: ``ceil(density * 2**32)``."""
    if not 0.0 <= density <= 1.0:
        raise ValueError(f"a density is in [0, 1], not {density!r}")
    return math.ceil(density * 2**32)


def region(seed: int, y0: int, x0: int, h: int, w: int, height: int, width: int,
           density: float) -> np.ndarray:
    """The ``uint8[h, w]`` block of the soup whose top-left cell is (y0, x0),
    as a PGM holds it (0 dead, 255 alive). The block wraps around the torus:
    ``y0`` and ``x0`` may be negative, and the block may run past an edge or
    be larger than the board."""
    if height * width > 2**32:
        raise ValueError(f"a {height} x {width} board has more than 2**32 cells")
    ys = np.arange(y0, y0 + h, dtype=np.int64) % height
    xs = np.arange(x0, x0 + w, dtype=np.int64) % width
    base = np.uint64((seed % 2**32) << 32)
    index = (ys[:, None] * width + xs[None, :]).astype(np.uint64)
    alive = (splitmix64(index + base) >> np.uint64(32)) < np.uint64(threshold(density))
    return np.where(alive, 255, 0).astype(np.uint8)
