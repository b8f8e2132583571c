"""The plain reference: life-like rules on a torus, in NumPy.

It imports nothing of the system under test and takes nothing it made. A
board is ``uint8[H, W]`` with 0 for dead and nonzero for alive, as a PGM
holds it. Boards whose width is a multiple of 64 step as rows of 64-bit
words, one bit a cell, through a bit-sliced neighbour count (about 45
NumPy operations a turn, whatever the size); other widths step one byte a
cell. The tests hold both against the repository's golden files and
against each other.

``wrap=False`` closes the edges (cells outside the board are dead). It
serves the control, which must come out as not correct, and the light
cones of ``evolve_windows``, whose closed edges never reach the windows.
"""

from __future__ import annotations

import pathlib

import numpy as np


def parse_rule(rulestring: str) -> tuple[frozenset, frozenset]:
    """``"B3/S23"`` -> ({3}, {2, 3})."""
    born, survive = None, None
    for part in rulestring.upper().split("/"):
        if part.startswith("B"):
            born = frozenset(int(c) for c in part[1:])
        elif part.startswith("S"):
            survive = frozenset(int(c) for c in part[1:])
    if born is None or survive is None or not (born | survive) <= set(range(9)):
        raise ValueError(f"not a life-like rule: {rulestring!r}")
    return born, survive


def _pgm_header(data: bytes, path) -> tuple[int, int, int]:
    """``(width, height, offset of the first pixel)`` of a binary (P5) PGM
    that ``data`` begins."""
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: no whole PGM header")
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM")
    return int(fields[1]), int(fields[2]), pos + 1


def read_pgm(path) -> np.ndarray:
    """A binary (P5) PGM as ``uint8[H, W]``."""
    data = pathlib.Path(path).read_bytes()
    width, height, offset = _pgm_header(data, path)
    pixels = np.frombuffer(data, np.uint8, width * height, offset)
    return pixels.reshape(height, width).copy()


def pgm_row_blocks(path, rows: int):
    """The ``uint8[r, W]`` blocks of at most ``rows`` rows that a binary PGM
    holds, top to bottom, read one at a time."""
    with open(path, "rb") as f:
        width, height, offset = _pgm_header(f.read(4096), path)
        f.seek(offset)
        for top in range(0, height, rows):
            n = min(rows, height - top)
            data = f.read(n * width)
            if len(data) != n * width:
                raise ValueError(f"{path}: ends at row {top + len(data) // width}")
            yield np.frombuffer(data, np.uint8).reshape(n, width)


def write_pgm(path, board: np.ndarray) -> None:
    height, width = board.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (width, height))
        f.write(np.where(board != 0, 255, 0).astype(np.uint8).tobytes())


def transform(board: np.ndarray, dy: int, dx: int, sym: int) -> np.ndarray:
    """One of the 8 symmetries of the square (bit 2: mirror, bits 0-1:
    quarter turns), then a roll by (dy, dx) on the torus."""
    if sym & 1 and board.shape[0] != board.shape[1]:
        raise ValueError("a quarter turn needs a square board")
    out = np.fliplr(board) if sym & 4 else board
    out = np.rot90(out, sym & 3)
    return np.ascontiguousarray(np.roll(out, (dy, dx), axis=(0, 1)))


def _shift_rows(x: np.ndarray, k: int, wrap: bool) -> np.ndarray:
    """Row r of the result is row r - k of ``x``."""
    if wrap:
        return np.roll(x, k, axis=0)
    out = np.zeros_like(x)
    if k > 0:
        out[k:] = x[:-k]
    else:
        out[:k] = x[-k:]
    return out


def _rule_mask(bits, values, dtype_ones):
    """Where the 4-bit count (bits z0..z3) equals any of ``values``."""
    mask = np.zeros_like(bits[0])
    for v in values:
        m = dtype_ones
        for i, z in enumerate(bits):
            m = m & (z if (v >> i) & 1 else ~z)
        mask |= m
    return mask


def _fa(a, b, c):
    s = a ^ b
    return s ^ c, (a & b) | (c & s)


def _step_words(x: np.ndarray, born, survive, wrap: bool) -> np.ndarray:
    """One turn on rows of little-endian 64-bit words (bit j of word k is
    column 64k + j)."""
    one = np.uint64(1)
    top = np.uint64(63)
    prev_word = np.roll(x, 1, axis=1) if wrap else np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    next_word = np.roll(x, -1, axis=1) if wrap else np.pad(x, ((0, 0), (0, 1)))[:, 1:]
    west = (x << one) | (prev_word >> top)   # the cell at column c - 1
    east = (x >> one) | (next_word << top)   # the cell at column c + 1
    t0, t1 = _fa(west, x, east)              # each row's three cells
    h0, h1 = west ^ east, west & east        # the own row's two neighbours
    u0, u1 = _shift_rows(t0, 1, wrap), _shift_rows(t1, 1, wrap)
    d0, d1 = _shift_rows(t0, -1, wrap), _shift_rows(t1, -1, wrap)
    z0, k1 = _fa(u0, d0, h0)
    y1, k2a = _fa(u1, d1, h1)
    z1, k2b = y1 ^ k1, y1 & k1
    z2, z3 = k2a ^ k2b, k2a & k2b
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    bits = (z0, z1, z2, z3)
    return (_rule_mask(bits, born, ones) & ~x) | (_rule_mask(bits, survive, ones) & x)


def _step_bytes(b: np.ndarray, born, survive, wrap: bool) -> np.ndarray:
    """One turn one byte a cell (0 or 1)."""
    if wrap:
        n = sum(np.roll(b, (dy, dx), axis=(0, 1))
                for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx)
    else:
        p = np.pad(b, 1)
        h, w = b.shape
        n = sum(p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx)
    return (np.where(b != 0, np.isin(n, list(survive)), np.isin(n, list(born)))
            .astype(np.uint8))


def _iterate(state: np.ndarray, turns: int, step) -> np.ndarray:
    """``state`` after ``turns`` applications of ``step``.

    The rule is deterministic, so a board that comes back repeats from then
    on, and the turns left are taken modulo that period: the answer is exact,
    and a board that settles costs its settling, not its turns. Brent's
    search finds the repeat: the state saved at each power of two of turns
    is held against every later one, until the next power of two."""
    saved, since, power = state, 0, 1
    for done in range(1, turns + 1):
        state = step(state)
        since += 1
        if np.array_equal(state, saved):  # the state of turn done - since
            for _ in range((turns - done) % since):
                state = step(state)
            return state
        if since == power:
            saved, since, power = state, 0, power * 2
    return state


def evolve(board: np.ndarray, turns: int, rulestring: str = "B3/S23",
           wrap: bool = True) -> np.ndarray:
    """The board after ``turns`` turns, as ``uint8[H, W]`` of 0 and 255."""
    born, survive = parse_rule(rulestring)
    height, width = board.shape
    if width % 64 == 0:
        words = np.packbits(board != 0, axis=1, bitorder="little").view("<u8")
        words = _iterate(words, turns, lambda x: _step_words(x, born, survive, wrap))
        cells = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    else:
        cells = _iterate((board != 0).astype(np.uint8), turns,
                         lambda b: _step_bytes(b, born, survive, wrap))
    return np.where(cells != 0, 255, 0).astype(np.uint8).reshape(height, width)


def evolve_windows(windows, h: int, w: int, turns: int,
                   rulestring: str = "B3/S23") -> list[np.ndarray]:
    """The ``h x w`` window at (y0, x0) of a torus after ``turns`` turns,
    for each ``(board_region_fn, y0, x0)`` of ``windows``, each
    ``uint8[h, w]`` of 0 and 255. ``board_region_fn(y0, x0, h, w)`` gives
    any block of that window's torus at turn 0, wrapping around its edges.

    A cell after ``turns`` turns depends only on the cells within ``turns``
    of it, so each window's light cone, the ``(h + 2 turns) x (w + 2 turns)``
    block around it, widened to whole 64-column words, evolves with closed
    edges and keeps the right centre: what the closed edges get wrong moves
    in one cell a turn. The cones of all windows are stacked in one array,
    whose blocks cannot reach one another's windows for the same reason. The
    evolution runs in stages of 64 turns, after each of which every block
    drops the margin it no longer needs. A cone higher or wider than the
    board needs nothing else: ``board_region_fn`` repeats the torus, so the
    cone is a block of the board's periodic tiling of the plane."""
    rows = h + 2 * turns
    cols = -(-(w + 2 * turns) // 64) * 64
    blocks = np.stack([fn(y0 - turns, x0 - turns, rows, cols) for fn, y0, x0 in windows])
    left = turns
    while turns > 0:
        stage = min(turns, 64)
        n, rows, cols = blocks.shape
        blocks = evolve(blocks.reshape(n * rows, cols), stage, rulestring, wrap=False)
        blocks = blocks.reshape(n, rows, cols)[:, stage:rows - stage]
        turns -= stage
        if stage == 64 and turns > 0:  # a whole word of margin on each side
            blocks = blocks[:, :, 64:-64]
            left -= 64
    return [np.ascontiguousarray(b[:, left:left + w]) for b in blocks]


def evolve_bytes(board: np.ndarray, turns: int, rulestring: str = "B3/S23") -> np.ndarray:
    """The byte stepping at any width: the tests' cross-check of ``evolve``."""
    born, survive = parse_rule(rulestring)
    cells = (board != 0).astype(np.uint8)
    for _ in range(turns):
        cells = _step_bytes(cells, born, survive, True)
    return np.where(cells != 0, 255, 0).astype(np.uint8)
