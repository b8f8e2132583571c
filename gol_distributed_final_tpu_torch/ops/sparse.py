"""Activity-sparse stepping: compute only where the board is alive, and
the dirty-tile deltas between two byte boards.

The invariant (exact for any life-like rule without birth on 0
neighbours): a cell can change at turn t -> t+1 only if a cell of its 3x3
neighbourhood changed at t-1 -> t. Lifted to tiles of at least one cell on
every side, a tile can change in the next block of h turns only if it or
one of its 8 neighbours changed in this one, so the active set evolves as
``active = dilate3x3(changed)`` and everything outside it is skipped
without being read.

``SparseBitPlane`` is a data plane (ops/plane.py interface plus the
early-exit protocol) over the int32 bitboard, word axis 0, and a bool
activity grid ``[rows / tr, cols / tc]`` of tiles of tr x tc words, both
on the device. ``step_n`` keeps the JAX package's host control flow
(``gol_distributed_final_tpu/ops/sparse.py:364-433``) so that the same
tiles give the same ``count`` and ``steady``: a power-of-two gather
capacity from the active-tile count, the dense crossover, the h = 1 tail,
re-dispatch one bucket up on an overflow, ``steady="still"`` when the grid
drains before the budget and a period-2 probe on a small frontier. Each
dispatch runs in ops/sparse_tiles.py: the CUDA kernel on the card, its
plain torch version on the CPU. ``compiled_program_count`` of the JAX
package has no counterpart: nothing is compiled per capacity bucket here.

Run ``python -m gol_distributed_final_tpu_torch.ops.sparse --selfcheck``
for the module's own check, on the card unless ``-device cpu`` is given.

The bottom of the file holds the wire tiles of the JAX package's wire and
checkpoint deltas: a fixed ``WIRE_TILE_ROWS x WIRE_TILE_COLS`` grid with
ragged right and bottom edges, so the geometry is a function of the board
shape alone and both ends derive it on their own. A delta is a bool
bitmap of the tiles that changed and the bytes of those tiles as one flat
uint8 buffer in row-major bitmap order. The delta checkpoints
(engine/checkpoint.py) store exactly that, so a delta written by either
package applies in the other.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import CONWAY, LifeRule
from ..obs import instruments as _ins
from ..obs import metrics as _metrics
from . import sparse_tiles
from .plane import BitPlane

# -- knobs -------------------------------------------------------------------

#: auto_plane routes boards of at least this many cells through
#: SparseBitPlane (ops/auto.py). Only routing reads it: the boards come
#: out the same either way. The JAX package's 4096^2: on the H100 (NVIDIA
#: H100 80GB HBM3 at 700 W) the sparse plane holds the dense plane's wall
#: there since its kernel became one launch a dispatch, the R-pentomino x
#: 1000 at a median 1.13x (1.69x at 8192^2; ``chip_smoke.py
#: --sparse-dense``, seven runs each)
SPARSE_MIN_CELLS = 4096 * 4096
#: active-tile fraction above which step_n takes the rest of the call
#: through the dense plane: the JAX package's value, on the winning side
#: of the H100's crossover (~0.5 active) at 16384^2 and 65536^2
SPARSE_DENSITY_CROSSOVER = 0.25
#: probe the frontier for a period-2 cycle only while it has at most this
#: many tiles: the probe costs two one-turn dispatches and a whole-board
#: comparison a step_n call
P2_PROBE_MAX_TILES = 64
#: byte ceiling of one block's gathered windows: past it the dense path is
#: taken even below the density crossover
_SPARSE_EXT_BUDGET = 256 << 20
#: blocks per dispatch at most: a dispatch is one launch of the sparse
#: kernel (ops/sparse_tiles.py), and this bounds the blocks that launch
#: runs and its counts vector (one int32 a block, read back once); the
#: host loop dispatches the rest
_MAX_BLOCKS_PER_DISPATCH = 8192
#: turns advanced per gathered block, clamped per tile (sparse_block_turns)
SPARSE_TURNS_PER_GATHER = 8

#: the default activity tile: at most this many word rows and columns
_TILE_ROWS_MAX = 8
_TILE_COLS_MAX = 128
#: tiles a side the default tile aims for on small boards
_TILE_MIN_GRID = 8


def _pow2_ceil(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def sparse_capable(rule: LifeRule, shape: tuple[int, int]) -> bool:
    """Whether the sparse plane may serve this rule and board ``(H, W)``:
    rows packable (H % 32), no birth on 0 (a B0 rule births cells in dead
    regions, so the activity invariant fails), and the board at least
    ``SPARSE_MIN_CELLS``. ``GOL_SPARSE=on`` drops the size floor,
    ``GOL_SPARSE=off`` turns the sparse plane off; ``auto`` (the default)
    applies the floor."""
    mode = os.environ.get("GOL_SPARSE", "auto").lower()
    if mode == "off":
        return False
    h, w = shape
    if h % 32 != 0 or rule.birth_mask & 1:
        return False
    if mode == "on":
        return True
    return h * w >= SPARSE_MIN_CELLS


def sparse_tile_shape(packed_shape: tuple[int, int]) -> tuple[int, int]:
    """The default activity tile (word rows, cols) of a packed shape: the
    largest divisors up to 8 rows and 128 columns that leave at least 8
    tiles a side where a divisor allows it, else the largest divisors
    (the JAX package's ``ops/pallas_tiled.py:107``, whose tile sets
    ``count``, the capacity buckets and the period-2 probe alike)."""

    def pick(n: int, cap: int) -> int:
        divisors = [d for d in range(1, cap + 1) if n % d == 0]
        fine = [d for d in divisors if n // d >= _TILE_MIN_GRID]
        return max(fine) if fine else max(divisors)

    rows, width = packed_shape
    return pick(rows, _TILE_ROWS_MAX), pick(width, _TILE_COLS_MAX)


def sparse_block_turns(tr: int, tc: int) -> int:
    """Turns one gathered block may advance for a (word rows, cols) tile:
    ``SPARSE_TURNS_PER_GATHER`` clamped so h turns of influence (h cells)
    stay within one ring of tiles: the dilation by one tile is exact only
    while h <= min(tile cell rows, tile columns, 32)."""
    return max(1, min(SPARSE_TURNS_PER_GATHER, tr * 32, tc, 32))


class SparseState:
    """The sparse plane's state: the packed bitboard, the bool activity
    grid on the same device, the active-tile count on the host, and the
    steady verdict (``None``, ``"still"`` or ``"period2"``, with ``alt``
    the other phase of a period-2 cycle)."""

    __slots__ = ("packed", "grid", "count", "steady", "alt")

    def __init__(self, packed, grid, count: int, steady: Optional[str] = None, alt=None):
        self.packed = packed
        self.grid = grid
        self.count = int(count)
        self.steady = steady
        self.alt = alt


def occupancy_grid(packed: torch.Tensor, tr: int, tc: int) -> torch.Tensor:
    """The dilated per-tile occupancy of a packed board: the conservative
    active set (a tile with no live cell in itself or a neighbour cannot
    change under a rule without birth on 0), at encode and after a dense
    stretch."""
    rows, width = packed.shape
    occ = (packed.view(rows // tr, tr, width // tc, tc) != 0).any(dim=3).any(dim=1)
    return sparse_tiles._dilate(occ)


class SparseBitPlane:
    """The activity-sparse bitboard plane (ops/plane.py interface plus
    ``steady_kind``/``fast_forward``). Its boards are ``BitPlane``'s bit
    for bit: the sparse path, the dense crossover and the steady jumps."""

    def __init__(self, rule: LifeRule = CONWAY, tile: Optional[tuple[int, int]] = None,
                 device=None):
        if rule.birth_mask & 1:
            raise ValueError(
                f"rule {rule.rulestring} births on 0 neighbours: the "
                "activity invariant does not hold; use the dense plane"
            )
        self.rule = rule
        self.word_axis = 0  # rows packed: the activity tiles span word rows
        self.device = resolve_device(device)
        self._tile = tile  # explicit (word rows, cols), else the default
        self._dense = BitPlane(rule, 0, self.device)

    # -- geometry ---------------------------------------------------------

    def _tiles_for(self, packed_shape: tuple[int, int]) -> tuple[int, int]:
        if self._tile is not None:
            tr, tc = self._tile
            if packed_shape[0] % tr or packed_shape[1] % tc:
                raise ValueError(
                    f"tile {self._tile} does not divide packed shape {packed_shape}"
                )
            return tr, tc
        return sparse_tile_shape(packed_shape)

    def _grid_state(self, packed) -> SparseState:
        """The activity grid rebuilt from tile occupancy (encode, and after
        a dense stretch)."""
        tr, tc = self._tiles_for(tuple(packed.shape))
        grid = occupancy_grid(packed, tr, tc)
        return SparseState(packed, grid, int(grid.sum()))

    # -- plane interface --------------------------------------------------

    def encode(self, board) -> SparseState:
        return self._grid_state(self._dense.encode(board))

    def decode(self, state) -> np.ndarray:
        return self._dense.decode(state.packed)

    def alive_count(self, state) -> int:
        return self._dense.alive_count(state.packed)

    def alive_cells(self, state):
        return self._dense.alive_cells(state.packed)

    def step_n(self, state, n: int) -> SparseState:
        n = int(n)
        if n <= 0:
            return state
        st = state
        shape = tuple(st.packed.shape)
        tr, tc = self._tiles_for(shape)
        total = (shape[0] // tr) * (shape[1] // tc)
        h_full = sparse_block_turns(tr, tc)
        birth, survive = self.rule.birth_mask, self.rule.survive_mask
        remaining = n
        while remaining > 0:
            if st.steady is not None:
                return self.fast_forward(st, remaining)
            capacity = min(_pow2_ceil(max(st.count, 8) * 2), _pow2_ceil(total))
            ext_bytes = capacity * (tr + 2) * (tc + 2 * h_full) * 4
            if st.count > SPARSE_DENSITY_CROSSOVER * total or ext_bytes > _SPARSE_EXT_BUDGET:
                # dense crossover: the rest of the call on the dense plane
                # (the JAX package steps it in power-of-two pieces, which
                # only bound its compiles), then the grid from occupancy
                st = self._grid_state(self._dense.step_n(st.packed, remaining))
                break
            # h turns a block; the tail under one full block runs at h = 1
            h_eff = h_full if remaining >= h_full else 1
            n_units = min(remaining // h_eff, _MAX_BLOCKS_PER_DISPATCH)
            run = sparse_tiles.dispatch(
                st.packed, st.grid, n_units, (tr, tc), h_eff, capacity, birth, survive
            )
            turns_done = run.blocks_done * h_eff
            if _metrics.enabled():
                # the JAX package's tile meters: the frontier, and the
                # tile-turns it did not have to step
                _ins.ACTIVE_TILES.set(run.count)
                if turns_done:
                    _ins.TILE_SKIPS_TOTAL.inc(max(0, turns_done * total - run.active_sum * h_eff))
            remaining -= turns_done
            if run.overflow:
                # the frontier outgrew the bucket: the blocks done are
                # committed; the rest goes one bucket up
                st = SparseState(run.packed, run.grid, run.count)
                continue
            if run.blocks_done < n_units:
                # the grid drained before the budget: a still life, whose
                # remaining turns are no-ops, done by definition
                if _metrics.enabled():
                    _ins.EARLY_EXIT_TOTAL.labels("still").inc()
                return SparseState(run.packed, run.grid, run.count, steady="still")
            st = SparseState(run.packed, run.grid, run.count)
        if st.steady is None and 0 < st.count <= P2_PROBE_MAX_TILES:
            st = self._probe_period2(st, (tr, tc), birth, survive)
        return st

    def _probe_period2(self, st, tile, birth, survive) -> SparseState:
        """Two one-turn blocks on a small frontier: if board(t+2) ==
        board(t) != board(t+1), the state is marked period-2 and later
        turns are arithmetic. A failed probe keeps nothing."""
        capacity = _pow2_ceil(max(st.count, 8) * 2)
        one = sparse_tiles.dispatch(st.packed, st.grid, 1, tile, 1, capacity, birth, survive)
        if one.blocks_done != 1 or one.overflow:
            return st
        two = sparse_tiles.dispatch(one.packed, one.grid, 1, tile, 1, capacity, birth, survive)
        if two.blocks_done != 1 or two.overflow:
            return st
        if torch.equal(two.packed, st.packed) and not torch.equal(one.packed, st.packed):
            if _metrics.enabled():
                _ins.EARLY_EXIT_TOTAL.labels("period2").inc()
            return SparseState(st.packed, st.grid, st.count, steady="period2", alt=one.packed)
        return st

    # -- the early-exit protocol (ops/plane.py docstring) -----------------

    def steady_kind(self, state) -> Optional[str]:
        return state.steady

    def fast_forward(self, state, k: int) -> SparseState:
        """``k`` turns of a steady state in O(1): a still life is itself, a
        period-2 cycle lands on phase ``k % 2``."""
        if state.steady == "period2" and int(k) % 2 == 1:
            return SparseState(state.alt, state.grid, state.count,
                               steady="period2", alt=state.packed)
        return state

    def from_packed(self, packed) -> SparseState:
        """Adopt a packed bitboard (a tensor, e.g. ``bigboard.seed_packed``'s,
        or int32/uint32 numpy words, e.g. the JAX plane's
        ``encode(board).packed``) as a state on this plane's device; the
        grid comes from tile occupancy, as ``encode``'s does."""
        if isinstance(packed, torch.Tensor):
            packed = packed.to(self.device)
        else:
            from .bitpack import state_from_numpy

            packed = state_from_numpy(np.asarray(packed), self.device)
        return self._grid_state(packed)

    def active_fraction(self, state) -> float:
        """Active tiles over all tiles."""
        shape = tuple(state.packed.shape)
        tr, tc = self._tiles_for(shape)
        total = (shape[0] // tr) * (shape[1] // tc)
        return state.count / total if total else 0.0


def active_fraction_of(packed: torch.Tensor) -> float:
    """The active-tile fraction of a packed bitboard under the default tile,
    without a plane of the caller's."""
    plane = SparseBitPlane(CONWAY, device=packed.device)
    return plane.active_fraction(plane.from_packed(packed))


# -- wire tiles of the wire and checkpoint deltas (numpy) --------------------

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


def _life_oracle(board: np.ndarray, n: int) -> np.ndarray:
    """n Conway turns of a uint8 board on the torus, in numpy."""
    ones = (board != 0).astype(np.int32)
    for _ in range(n):
        c = sum(
            np.roll(np.roll(ones, dy, 0), dx, 1)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)
        )
        ones = ((c == 3) | ((ones == 1) & (c == 2))).astype(np.int32)
    return (ones * 255).astype(np.uint8)


def _selfcheck(device=None) -> int:
    """Oracle parity and the early exits: an R-pentomino crossing tile
    edges, a still life draining the grid, an all-dead board, and a
    delta round trip."""
    h = w = 128
    board = np.zeros((h, w), np.uint8)
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        board[h // 2 + dy, w // 2 + dx] = 255
    plane = SparseBitPlane(CONWAY, tile=(1, 16), device=device)
    state = plane.step_n(plane.encode(board), 150)
    if not np.array_equal(plane.decode(state), _life_oracle(board, 150)):
        print("sparse selfcheck: R-pentomino parity FAILED")
        return 1
    block = np.zeros((64, 64), np.uint8)
    block[10:12, 10:12] = 255
    still_plane = SparseBitPlane(CONWAY, tile=(1, 2), device=device)
    st = still_plane.step_n(still_plane.encode(block), 50)
    if st.steady != "still":
        print("sparse selfcheck: still-life early exit FAILED")
        return 1
    dead = SparseBitPlane(CONWAY, tile=(1, 8), device=device)
    std = dead.step_n(dead.encode(np.zeros((64, 64), np.uint8)), 10)
    if dead.alive_count(std) != 0 or std.count != 0:
        print("sparse selfcheck: all-dead FAILED")
        return 1
    after = _life_oracle(board, 3)
    dirty = dirty_tile_grid(board, after, 16, 16)
    flat = extract_dirty_tiles(after, dirty, 16, 16)
    if not np.array_equal(apply_dirty_tiles(board, dirty, flat, 16, 16), after):
        print("sparse selfcheck: delta round-trip FAILED")
        return 1
    print(
        f"sparse selfcheck ok on {plane.device}: oracle parity (150 turns), "
        "still-life early exit, all-dead, delta round-trip"
    )
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="activity-sparse stepping utilities")
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="oracle parity + early-exit + delta round-trip smoke",
    )
    parser.add_argument(
        "-device", default=None,
        help="cuda (default; fails without a card) or cpu",
    )
    args = parser.parse_args(argv)
    if not args.selfcheck:
        parser.error("nothing to do (want --selfcheck)")
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass -device cpu to run on the CPU")
    return _selfcheck(device)


if __name__ == "__main__":
    sys.exit(main())
