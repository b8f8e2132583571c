"""Dirty-tile deltas between two byte boards, in numpy.

The tile unit of the JAX package's wire and checkpoint deltas
(``ops/sparse.py``): a fixed ``WIRE_TILE_ROWS x WIRE_TILE_COLS`` grid with
ragged right and bottom edges, so the geometry is a function of the board
shape alone and both ends derive it on their own. A delta is a bool
bitmap of the tiles that changed and the bytes of those tiles as one flat
uint8 buffer in row-major bitmap order. The delta checkpoints
(engine/checkpoint.py) store exactly that, so a delta written by either
package applies in the other.

Only these helpers are ported so far; the activity-sparse data plane of
that module (``SparseBitPlane``) comes in a later slice.
"""

from __future__ import annotations

import numpy as np

WIRE_TILE_ROWS = 64
WIRE_TILE_COLS = 256


def wire_tile_grid(
    shape: tuple[int, int],
    tile_rows: int = WIRE_TILE_ROWS,
    tile_cols: int = WIRE_TILE_COLS,
) -> tuple[int, int]:
    """(tile grid rows, cols) for a board shape, ragged edge tiles
    included."""
    h, w = shape
    return -(-h // tile_rows), -(-w // tile_cols)


def dirty_tile_grid(
    before: np.ndarray,
    after: np.ndarray,
    tile_rows: int = WIRE_TILE_ROWS,
    tile_cols: int = WIRE_TILE_COLS,
) -> np.ndarray:
    """Per-tile change bitmap between two boards of one shape: bool
    ``[grid_rows, grid_cols]``, True where any cell of the tile differs."""
    if before.shape != after.shape:
        raise ValueError(
            f"dirty grid needs same shapes, got {before.shape} vs {after.shape}"
        )
    diff = before != after
    h, w = diff.shape
    rows = np.arange(0, h, tile_rows)
    cols = np.arange(0, w, tile_cols)
    return (
        np.add.reduceat(
            np.add.reduceat(diff.astype(np.int32), rows, axis=0), cols, axis=1
        )
        > 0
    )


def _tile_bounds(shape, idx_r, idx_c, tile_rows, tile_cols):
    h, w = shape
    r0, c0 = idx_r * tile_rows, idx_c * tile_cols
    return r0, min(r0 + tile_rows, h), c0, min(c0 + tile_cols, w)


def extract_dirty_tiles(
    board: np.ndarray,
    dirty: np.ndarray,
    tile_rows: int = WIRE_TILE_ROWS,
    tile_cols: int = WIRE_TILE_COLS,
) -> np.ndarray:
    """The dirty tiles' bytes as one flat uint8 buffer, in row-major
    bitmap order."""
    if dirty.shape != wire_tile_grid(board.shape, tile_rows, tile_cols):
        raise ValueError(
            f"dirty grid {dirty.shape} does not match board "
            f"{board.shape} at tile ({tile_rows}, {tile_cols})"
        )
    parts = []
    for idx_r, idx_c in zip(*np.nonzero(dirty)):
        r0, r1, c0, c1 = _tile_bounds(board.shape, idx_r, idx_c, tile_rows, tile_cols)
        parts.append(np.ascontiguousarray(board[r0:r1, c0:c1]).ravel())
    if not parts:
        return np.zeros(0, np.uint8)
    return np.concatenate(parts).astype(np.uint8, copy=False)


def apply_dirty_tiles(
    base: np.ndarray,
    dirty: np.ndarray,
    flat: np.ndarray,
    tile_rows: int = WIRE_TILE_ROWS,
    tile_cols: int = WIRE_TILE_COLS,
) -> np.ndarray:
    """A copy of ``base`` with a dirty-tile delta applied (``base`` is never
    written). Raises ``ValueError`` on any geometry or length mismatch, so
    a malformed delta never half-applies; a caller holding a digest of the
    intended result checks it after this."""
    if dirty.shape != wire_tile_grid(base.shape, tile_rows, tile_cols):
        raise ValueError(
            f"dirty grid {dirty.shape} does not match base {base.shape} "
            f"at tile ({tile_rows}, {tile_cols})"
        )
    flat = np.asarray(flat, np.uint8).ravel()
    out = np.array(base, np.uint8, copy=True)
    cursor = 0
    for idx_r, idx_c in zip(*np.nonzero(dirty)):
        r0, r1, c0, c1 = _tile_bounds(base.shape, idx_r, idx_c, tile_rows, tile_cols)
        size = (r1 - r0) * (c1 - c0)
        if cursor + size > flat.size:
            raise ValueError(
                f"delta payload truncated: needs >= {cursor + size} bytes, "
                f"got {flat.size}"
            )
        out[r0:r1, c0:c1] = flat[cursor:cursor + size].reshape(r1 - r0, c1 - c0)
        cursor += size
    if cursor != flat.size:
        raise ValueError(
            f"delta payload has {flat.size - cursor} trailing bytes beyond "
            "its dirty bitmap"
        )
    return out
