"""The bitboard on the mesh: packed halo-exchange steps, each block stepped
by the tiled CUDA kernel.

The byte plane (parallel/halo.py) steps cells; here every block is an
int32 bitboard (ops/bitpack.py, 32 cells a word), and the same two-phase
exchange moves words. ``bit_step``'s output word (i, j) depends only on
input words (i±1, j±1), whichever axis is packed (carries cross word
boundaries through the adjacent word), so one word ring of halo is one
turn, and a ``depth``-word ring is ``depth`` turns.

The local step is the JAX package's (its ``parallel/bit_halo.py``):

* ``_local_bit_step`` and ``_local_bit_step_wide`` run ``bit_step`` in
  torch ops on the extended block (XLA in the JAX package);
* ``_local_bit_step_tiled``, the port of ``_local_bit_step_pallas`` (ref
  :115), runs the tiled kernel (csrc/tiled.cu, ops/tiled.py) on it:
  ``depth`` turns in one launch. The JAX package pads the extended block
  to Mosaic's 8-sublane and 128-lane tiles; the port's kernel has no such
  contract (it wraps modulo whatever array it is given), so the extended
  block carries only its ``depth``-word halos. The kernel's wrap of that
  block is wrong data at its outer ring, and each turn carries the damage
  one word ring inward, so after ``depth`` turns it has eaten the halo
  and stops at the block's own edge, which the crop keeps. A launch takes
  at most ``ops/tiled.MAX_TURNS`` (8) turns: deeper halos stay on
  ``bit_step``, as the JAX package keeps them on XLA.

On a CUDA block the tiled route launches the kernel or raises; on a CPU
block ``ops/tiled.step_n`` takes its plain version. Nothing reroutes a
failed launch.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..models import CONWAY, LifeRule
from ..ops import tiled
from ..ops.bitpack import WORD, bit_launch_cost, bit_step, pack, packed_shape, unpack
from .halo import (
    _extend,
    check_halo_depth,
    halo_depth_fits,
    metered_dispatch,
    run_sharded,
    timed_block,
    wide_loop,
)
from .mesh import COLS, ROWS, BlockSharding, Mesh, ShardedBoard


def choose_bit_layout(
    board_shape: tuple[int, int], mesh_shape: tuple[int, int]
) -> Optional[int]:
    """Pick a ``word_axis`` whose packed array divides over the mesh:
    packing rows (word_axis=0, packed [H/32, W]) first, then columns, then
    None (the caller takes the byte plane)."""
    h, w = board_shape
    nrows, ncols = mesh_shape
    if h % (WORD * nrows) == 0 and w % ncols == 0:
        return 0
    if h % nrows == 0 and w % (WORD * ncols) == 0:
        return 1
    return None


def _rule_masks(rule: LifeRule) -> dict:
    return {"birth_mask": rule.birth_mask, "survive_mask": rule.survive_mask}


def _bit_cost(rule: LifeRule):
    return lambda words, turns: bit_launch_cost(words, turns, rule.birth_mask,
                                                rule.survive_mask)


def _local_bit_step(blocks: dict, *, rule: LifeRule, mesh: Mesh, word_axis: int) -> dict:
    """One turn: one-word halos, ``bit_step`` on the extended block, the
    interior kept (the cyclic rolls spoil only the outer ring)."""
    return {
        slot: timed_block(
            "halo.bit", ext, 1, _bit_cost(rule),
            lambda ext=ext: bit_step(ext, word_axis, **_rule_masks(rule))[1:-1, 1:-1],
        )
        for slot, ext in _extend(blocks, mesh).items()
    }


def _local_bit_step_wide(
    blocks: dict, *, rule: LifeRule, mesh: Mesh, word_axis: int, depth: int
) -> dict:
    """``depth`` turns per exchange of ``depth``-word halos, each turn
    slicing away the ring it spoilt, so the last one leaves the block's
    own shape."""
    out = {}
    for slot, ext in _extend(blocks, mesh, k=depth).items():
        def turns(ext=ext):
            for _ in range(depth):
                ext = bit_step(ext, word_axis, **_rule_masks(rule))[1:-1, 1:-1]
            return ext

        out[slot] = timed_block("halo.bit", ext, depth, _bit_cost(rule), turns)
    return out


def _local_bit_step_tiled(blocks: dict, *, rule: LifeRule, mesh: Mesh, depth: int = 1) -> dict:
    """``depth`` turns of every local block (word_axis=0) in one launch of
    the tiled kernel on its extended block, ``depth``-word halos on every
    side, then the interior (see the module's note on the ring creep)."""
    out = {}
    for slot, ext in _extend(blocks, mesh, k=depth).items():
        stepped = tiled.step_n(ext, depth, 0, rule.birth_mask, rule.survive_mask,
                               turns_per_launch=depth, site="halo.bit")
        out[slot] = stepped[depth:-depth, depth:-depth]
    return out


def _auto_use_tiled(halo_depth: int, word_axis: int) -> bool:
    """The ``pallas_local=None`` routing: the tiled kernel takes every row-
    packed block whose halo depth one launch can step; deeper halos and
    column packing stay on ``bit_step``, as the JAX package keeps them on
    XLA. The JAX gate's other half, Mosaic's tile alignment of the block
    (ref ``_pallas_local_aligned`` :194), has no counterpart: the port's
    kernel takes any shape."""
    return halo_depth <= tiled.MAX_TURNS and word_axis == 0


def packed_sharding(mesh: Mesh) -> BlockSharding:
    return BlockSharding(mesh)


def sharded_bit_step_n_fn(
    mesh: Mesh,
    rule: LifeRule = CONWAY,
    word_axis: int = 0,
    *,
    pallas_local: bool | None = None,
    halo_depth: int = 1,
) -> Callable:
    """``(packed, n) -> packed``: ``n`` turns of an int32 bitboard over the
    mesh (a ``ShardedBoard`` stays sharded; a whole tensor comes back
    whole, see ``halo.run_sharded``).

    ``pallas_local`` keeps the JAX package's keyword and means the tiled
    kernel: None routes by ``_auto_use_tiled``, True demands it (row
    packing and a depth one launch can step, else ValueError), False runs
    ``bit_step``. The JAX package's ``interpret`` has no counterpart: a
    CPU block takes the kernel's plain version.

    ``halo_depth=k`` exchanges k-deep halos and runs k turns locally per
    exchange: k-fold fewer messages per turn, the lever where a mesh axis
    crosses processes."""
    if halo_depth < 1:
        raise ValueError(f"halo_depth must be >= 1, got {halo_depth}")
    if halo_depth > tiled.MAX_TURNS and pallas_local:
        raise ValueError(
            f"halo_depth > {tiled.MAX_TURNS} exceeds the tiled kernel's turns per "
            "launch (pallas_local=True routes the local step to it); drop "
            "pallas_local=True for deeper halos"
        )
    if pallas_local and word_axis != 0:
        # the JAX package's kernel route takes row packing only, and the
        # port keeps its routing: column packing runs bit_step
        raise ValueError("pallas_local=True requires word_axis=0")
    use_tiled = _auto_use_tiled(halo_depth, word_axis) if pallas_local is None else bool(pallas_local)

    if use_tiled:
        def local(blocks):
            return _local_bit_step_tiled(blocks, rule=rule, mesh=mesh)

        def wide(blocks):
            return _local_bit_step_tiled(blocks, rule=rule, mesh=mesh, depth=halo_depth)
    else:
        def local(blocks):
            return _local_bit_step(blocks, rule=rule, mesh=mesh, word_axis=word_axis)

        def wide(blocks):
            return _local_bit_step_wide(blocks, rule=rule, mesh=mesh, word_axis=word_axis,
                                        depth=halo_depth)

    plane = "bit_pallas" if use_tiled else "bit_xla"  # the JAX package's labels

    def step_n(packed, n):
        check_halo_depth(halo_depth, BlockSharding(mesh).block_shape(tuple(packed.shape)))
        return metered_dispatch(plane, int(n), halo_depth, lambda: run_sharded(
            mesh, packed, lambda b: wide_loop(b, int(n), halo_depth, local, wide)))

    return step_n


class ShardedBitPlane:
    """Engine data plane (ops/plane.py interface): a mesh-sharded bitboard.
    The state is a ``ShardedBoard`` of int32 blocks; it stays packed and
    sharded across every chunk. ``alive_count`` is a popcount of the local
    blocks, summed over the ranks when the state spans several."""

    def __init__(self, mesh: Mesh, rule: LifeRule = CONWAY, word_axis: int = 0,
                 halo_depth: int = 1):
        self.mesh = mesh
        self.rule = rule
        self.word_axis = word_axis
        self.halo_depth = halo_depth
        self._step_n = sharded_bit_step_n_fn(mesh, rule, word_axis, halo_depth=halo_depth)

    def encode(self, board) -> ShardedBoard:
        """A whole uint8 board (this process holding every slot), each
        block packed on its slot's device."""
        board = np.asarray(board, np.uint8)
        bh, bw = BlockSharding(self.mesh).block_shape(board.shape)
        blocks = {
            (i, j): pack(board[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw], self.word_axis,
                         self.mesh.slot(i, j).device)
            for i, j in self.mesh.local_slots()
        }
        return ShardedBoard(self.mesh, packed_shape(*board.shape, self.word_axis), blocks)

    def step_n(self, state, n: int):
        return self._step_n(state, n)

    def decode(self, state) -> np.ndarray:
        """The whole host board: a fully addressable state only (a rank
        cannot hold rows it does not own; use ``decode_global``)."""
        return self.decode_global(state).numpy()

    def decode_global(self, state) -> ShardedBoard:
        """The unpacked uint8 board, sharded as the state is: each rank
        reads its own rows from its blocks."""
        return state.with_blocks({slot: unpack(b, self.word_axis)
                                  for slot, b in state.blocks.items()})

    def alive_count(self, state) -> int:
        from ..ops.bitpack import alive_count_packed

        return alive_count_packed(state)

    def alive_cells(self, state):
        """The Cell list of a fully addressable state."""
        from ..ops.bitpack import alive_cells_packed

        return alive_cells_packed(state.gather(), self.word_axis)


def make_bit_plane(
    mesh: Mesh,
    board_shape: tuple[int, int],
    rule: LifeRule = CONWAY,
    halo_depth: int = 1,
) -> Optional[ShardedBitPlane]:
    """A ShardedBitPlane for this board and mesh if a packed layout
    divides AND the halo depth fits its local word blocks, else None (the
    caller falls back to the byte halo plane, whose cell blocks are 32x
    deeper on the packed axis)."""
    mesh_shape = (mesh.shape[ROWS], mesh.shape[COLS])
    word_axis = choose_bit_layout(board_shape, mesh_shape)
    if word_axis is None:
        return None
    rows, cols = packed_shape(*board_shape, word_axis)
    if not halo_depth_fits(halo_depth, (rows // mesh_shape[0], cols // mesh_shape[1])):
        return None  # a halo can only come from the adjacent device
    return ShardedBitPlane(mesh, rule, word_axis, halo_depth=halo_depth)
