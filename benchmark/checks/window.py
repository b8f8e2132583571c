"""A configuration's check for a seeded board too large to hold whole:
windows of each session's final board against their light cones.

A configuration names it with ``"check": "window"`` beside a soup board
(``"board": {"kind": "soup", "density": p}``); each session's
``Session.board`` is the seed of its soup (``harness/soup.py``). For every
answered session:

* its turns completed equal the turns asked;
* each window the driver kept of its final board (``Session.windows``)
  equals ``reference.evolve_windows`` on that session's soup;
* where the driver kept its final PGM (``Session.out_path``), the live cells
  of that PGM, counted in blocks of rows, equal its alive count; the PGM is
  then deleted.

At least one alive count, at least one window, and at least one window
that crosses the torus's edges in both its rows and its columns have to
have been compared: a fault at the edges (the control closes them) shows
only in such a window. Life is exact, so every other limit is 0 wrong.

Sessions on the same soup keep the same windows, so each distinct light
cone (soup, corner, turns, shape) evolves once and judges every window
kept of it.

Where the program cuts the board into tiles, a driver should also keep a
window on a point where four tiles meet. For the tiled kernel
(``ops/tiled.py``, tiles of 32 x 128 words, 32 cells a word along either
axis) a ``h x w`` window with (y0, x0) = (-h/2, -w/2) modulo (1024, 4096)
straddles the seams of both layouts.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark import reference
from benchmark.harness import soup

#: the numbers held from below; every other is held from above
AT_LEAST = frozenset({"windows_checked", "wrap_windows_checked", "alive_checked"})
#: light cones evolved in one stack, and rows of a PGM read at a time
STACK = 8
ROWS = 1024


def pgm_alive(path, shape) -> int | None:
    """The live cells of the PGM at ``path``, read in blocks of ``ROWS``
    rows; None where it is not of ``shape`` (height, width)."""
    alive = rows = 0
    for block in reference.pgm_row_blocks(path, ROWS):
        if block.shape[1] != shape[1]:
            return None
        rows += block.shape[0]
        alive += int(np.count_nonzero(block))
    return alive if rows == shape[0] else None


def compare(sessions, ctx) -> dict:
    """``{name: (value, limit, holds)}`` over ``sessions``."""
    config = ctx.config
    height, width, rule = config["height"], config["width"], config["rule"]
    region = functools.partial(soup.region, height=height, width=width,
                               density=ctx.board["density"])
    unanswered = wrong_turns = wrong_alive = alive_checked = 0
    kept = {}  # (soup's seed, y0, x0, turns, h, w) -> the windows kept of that cone
    for s in sessions:
        if not s.answered:
            unanswered += 1
            continue
        wrong_turns += s.turns != s.turns_asked
        if s.out_path is not None:
            counted = pgm_alive(s.out_path, (height, width))
            s.out_path.unlink()
            alive_checked += 1
            wrong_alive += counted != s.alive
        for y0, x0, window in s.windows:
            key = (s.board, y0 % height, x0 % width, s.turns_asked, *window.shape)
            kept.setdefault(key, []).append(window)
    cones = {}  # (turns, h, w) -> the keys of its cones
    for key in kept:
        cones.setdefault(key[3:], []).append(key)
    wrong_windows = windows_checked = wrap_windows_checked = 0
    for (turns, h, w), keys in cones.items():
        for i in range(0, len(keys), STACK):
            part = keys[i:i + STACK]
            expect = reference.evolve_windows(
                [(functools.partial(region, seed), y0, x0) for seed, y0, x0, *_ in part],
                h, w, turns, rule)
            for key, want in zip(part, expect):
                _, y0, x0, *_ = key
                wraps = y0 + h > height and x0 + w > width
                for window in kept[key]:
                    windows_checked += 1
                    wrap_windows_checked += wraps
                    wrong_windows += bool(np.any((window != 0) != (want != 0)))
    return {
        "unanswered": (unanswered, 0, unanswered <= 0),
        "wrong_turns": (wrong_turns, 0, wrong_turns <= 0),
        "wrong_windows": (wrong_windows, 0, wrong_windows <= 0),
        "wrong_alive": (wrong_alive, 0, wrong_alive <= 0),
        "windows_checked": (windows_checked, 1, windows_checked >= 1),
        "wrap_windows_checked": (wrap_windows_checked, 1, wrap_windows_checked >= 1),
        "alive_checked": (alive_checked, 1, alive_checked >= 1),
    }
