"""The plain reference: life-like rules on a torus, in NumPy.

It imports nothing of the system under test and takes nothing it made. A
board is ``uint8[H, W]`` with 0 for dead and nonzero for alive, as a PGM
holds it. Boards whose width is a multiple of 64 step as rows of 64-bit
words, one bit a cell, through a bit-sliced neighbour count (about 45
NumPy operations a turn, whatever the size); other widths step one byte a
cell. The tests hold both against the repository's golden files and
against each other.

``wrap=False`` closes the edges (cells outside the board are dead). It
exists only for the control, which must come out as not correct.
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


def read_pgm(path) -> np.ndarray:
    """A binary (P5) PGM as ``uint8[H, W]``."""
    data = pathlib.Path(path).read_bytes()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM")
    width, height = int(fields[1]), int(fields[2])
    pixels = np.frombuffer(data, np.uint8, width * height, pos + 1)
    return pixels.reshape(height, width).copy()


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


def evolve(board: np.ndarray, turns: int, rulestring: str = "B3/S23",
           wrap: bool = True) -> np.ndarray:
    """The board after ``turns`` turns, as ``uint8[H, W]`` of 0 and 255."""
    born, survive = parse_rule(rulestring)
    height, width = board.shape
    if width % 64 == 0:
        words = np.packbits(board != 0, axis=1, bitorder="little").view("<u8")
        for _ in range(turns):
            words = _step_words(words, born, survive, wrap)
        cells = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    else:
        cells = (board != 0).astype(np.uint8)
        for _ in range(turns):
            cells = _step_bytes(cells, born, survive, wrap)
    return np.where(cells != 0, 255, 0).astype(np.uint8).reshape(height, width)


def evolve_bytes(board: np.ndarray, turns: int, rulestring: str = "B3/S23") -> np.ndarray:
    """The byte stepping at any width: the tests' cross-check of ``evolve``."""
    born, survive = parse_rule(rulestring)
    cells = (board != 0).astype(np.uint8)
    for _ in range(turns):
        cells = _step_bytes(cells, born, survive, True)
    return np.where(cells != 0, 255, 0).astype(np.uint8)
