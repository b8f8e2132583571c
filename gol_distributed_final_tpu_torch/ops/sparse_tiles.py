"""The activity-sparse step: blocks of h <= 8 turns computed only on the
active tiles of a packed int32 board ``[rows, cols]`` (word axis 0), with
the activity grid that says which tiles those are (csrc/sparse_tiles.cu).

It replaces the XLA program of the JAX package's activity-sparse plane,
``gol_distributed_final_tpu/ops/sparse.py:189`` (``_sparse_program``):
one call is one dispatch of that program, at most ``n_blocks`` blocks of
``h`` turns, stopped early on an overflowing block (more active tiles
than ``capacity``, which commits nothing) or an empty grid. On the card a
dispatch is one cooperative launch whose persistent CTAs keep the loop,
its active list and its activity state on the card from the first block
to the last; what bounds the kernel and how its design meets that is
written at the top of the CUDA source.

``dispatch_plain`` is the plain version, a torch mirror of the XLA
program: it gathers the active tiles' windows with ``torch.nonzero``
padded to ``capacity`` (padding entries point at tile 0, as
``jnp.nonzero(fill_value=0)``'s do), runs ``h`` ``bit_step``s over the
batch, ORs each turn's change of a tile's interior into its flag,
scatters the interiors back and dilates the change grid on the torus of
tiles. ``dispatch`` takes it only for tensors on the CPU. For CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import NamedTuple

import torch

from . import _build, _tiles
from .bitpack import bit_step, rule_masks

#: turns one block may take: the halo word row above and below the tile
#: covers fewer than 32, the column halo is h words
MAX_TURNS = 8

#: kernel launches made by ``dispatch``: one per dispatch on the card, the
#: cooperative launch that runs all its blocks; ``plain_calls`` counts the
#: calls that took the plain version (CPU tensors) instead
launches = 0
plain_calls = 0

_SIGNATURES = {
    "gol_sparse_plan": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
    ],
    "gol_sparse_ctas": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.POINTER(ctypes.c_int),
    ],
    "gol_sparse_workspace_bytes": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
    ],
    "gol_sparse_dispatch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ],
}

#: the kernel's workspaces (scratch, change records, stamps, lists), one per
#: (device, stream, board shape, tile, capacity), the most recent few kept.
#: The stream is in the key because a dispatch uses its workspace until its
#: launch ends: two streams would race on one, while launches on one stream
#: run in order. Nothing a dispatch returns lives in a workspace.
_WORKSPACES: OrderedDict = OrderedDict()
_WORKSPACES_KEPT = 4
_WORKSPACE_LOCK = threading.Lock()


class Dispatch(NamedTuple):
    """What one dispatch returns: the board and grid after it, the blocks
    it committed, whether it stopped on an overflowing block, the sum of
    the active tiles its committed blocks started from (exact: a host int)
    and the active tiles of the returned grid."""

    packed: torch.Tensor
    grid: torch.Tensor
    blocks_done: int
    overflow: bool
    active_sum: int
    count: int


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def _check_args(packed, grid, tile, h, capacity, n_blocks) -> None:
    tr, tc = tile
    rows, cols = packed.shape
    if rows % tr or cols % tc:
        raise ValueError(f"tile {tile} does not divide packed shape {tuple(packed.shape)}")
    if tuple(grid.shape) != (rows // tr, cols // tc):
        raise ValueError(
            f"activity grid {tuple(grid.shape)} does not match tile {tile} on "
            f"{tuple(packed.shape)}"
        )
    if not 1 <= h <= MAX_TURNS:
        raise ValueError(f"h must be in 1..{MAX_TURNS}, got {h}")
    if capacity < 1 or n_blocks < 0:
        raise ValueError(f"capacity {capacity} and n_blocks {n_blocks} out of range")


def _dilate(cgrid: torch.Tensor) -> torch.Tensor:
    """A tile and its 8 neighbours on the torus of tiles."""
    out = cgrid
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) != (0, 0):
                out = out | torch.roll(cgrid, (dy, dx), dims=(0, 1))
    return out


def dispatch_plain(packed, grid, n_blocks, tile, h, capacity, birth_mask, survive_mask):
    """The plain version of ``dispatch``: the reference's while loop, block
    by block, in torch. Never writes ``packed`` or ``grid``."""
    _check_args(packed, grid, tile, h, capacity, n_blocks)
    tr, tc = tile
    rows, cols = packed.shape
    gr, gc = grid.shape
    dev = packed.device
    r_off = torch.arange(tr + 2, device=dev)
    c_off = torch.arange(tc + 2 * h, device=dev)
    inner = (slice(None), slice(1, -1), slice(h, -h))
    blocks = active = 0
    overflow = False
    while blocks < n_blocks and bool(grid.any()):
        cnt = int(grid.sum())
        if cnt > capacity:
            # an overflowing block commits nothing: the host re-buckets
            overflow = True
            break
        where = torch.zeros((capacity, 2), dtype=torch.int64, device=dev)
        where[:cnt] = torch.nonzero(grid)
        trow, tcol = where[:, 0], where[:, 1]
        # halo-extended windows: a word row above and below, h columns each
        # side, the torus by the indices modulo the board
        wr = (trow[:, None] * tr - 1 + r_off[None, :]) % rows
        wc = (tcol[:, None] * tc - h + c_off[None, :]) % cols
        cur = packed[wr[:, :, None], wc[:, None, :]]
        changed = torch.zeros(capacity, dtype=torch.bool, device=dev)
        for _ in range(h):
            nxt = bit_step(cur, 0, birth_mask=birth_mask, survive_mask=survive_mask)
            changed |= (nxt[inner] != cur[inner]).flatten(1).any(dim=1)
            cur = nxt
        packed = packed.clone()
        packed[wr[:, 1:-1, None], wc[:, None, h:-h]] = cur[inner]
        cgrid = torch.zeros((gr, gc), dtype=torch.int32, device=dev)
        cgrid.index_put_((trow, tcol), changed.to(torch.int32), accumulate=True)
        grid = _dilate(cgrid > 0)
        blocks += 1
        active += cnt
    return Dispatch(packed, grid, blocks, overflow, active, int(grid.sum()))


def plan(tile, h) -> tuple[int, int]:
    """``(shared memory bytes, threads)`` of the kernel's CTA for a tile
    and h (what csrc/sparse_tiles.cu's make_plans gives)."""
    smem, threads = ctypes.c_longlong(), ctypes.c_int()
    lib = _build.load("sparse_tiles", _SIGNATURES)
    _build.check(lib.gol_sparse_plan(tile[0], tile[1], h, ctypes.byref(smem),
                                     ctypes.byref(threads)), "gol_sparse_plan")
    return smem.value, threads.value


def ctas(tile, h, capacity, birth_mask, survive_mask) -> int:
    """The CTAs a dispatch of this tile, h, capacity and rule launches on
    the current card (csrc/sparse_tiles.cu's resident_ctas)."""
    out = ctypes.c_int()
    lib = _build.load("sparse_tiles", _SIGNATURES)
    _build.check(lib.gol_sparse_ctas(tile[0], tile[1], h, capacity,
                                     *rule_masks(birth_mask, survive_mask), ctypes.byref(out)),
                 "gol_sparse_ctas")
    return out.value


def dispatch(
    packed: torch.Tensor,
    grid: torch.Tensor,
    n_blocks: int,
    tile: tuple[int, int],
    h: int,
    capacity: int,
    birth_mask: int,
    survive_mask: int,
) -> Dispatch:
    """Up to ``n_blocks`` blocks of ``h`` turns of the B/S rule (no birth
    on 0) on the active tiles of ``packed`` (int32 ``[rows, cols]``, word
    axis 0) under the bool activity ``grid`` (``[rows / tr, cols / tc]``
    for ``tile`` = (tr, tc) words), with room for ``capacity`` active
    tiles a block. Neither input is written. One synchronisation: the
    host reads the counts once, at the end."""
    global launches, plain_calls
    n_blocks, h, capacity = int(n_blocks), int(h), int(capacity)
    if packed.device.type == "cpu":
        plain_calls += 1
        return dispatch_plain(packed, grid, n_blocks, tile, h, capacity,
                              birth_mask, survive_mask)
    if packed.device.type != "cuda":
        raise ValueError(f"no sparse kernel for device {packed.device}")
    if packed.dtype != torch.int32 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError(
            "the sparse kernel takes a contiguous 2-D int32 bitboard, got "
            f"{packed.dtype} {tuple(packed.shape)} contiguous={packed.is_contiguous()}"
        )
    if grid.dtype != torch.bool or grid.device != packed.device:
        raise ValueError(f"the activity grid must be bool on {packed.device}, got "
                         f"{grid.dtype} on {grid.device}")
    if birth_mask & 1:
        raise ValueError("the sparse kernel takes no rule that births on 0 neighbours")
    _check_args(packed, grid, tile, h, capacity, n_blocks)
    from .whole_board import smem_limit

    tr, tc = tile
    rows, cols = packed.shape
    smem, _ = plan(tile, h)
    if smem > smem_limit(packed.device):
        raise ValueError(
            f"tile {tile} at h={h} needs {smem} B of shared memory a block, past the "
            f"card's {smem_limit(packed.device)} B"
        )
    common, dead_only, live_only = rule_masks(birth_mask, survive_mask)
    lib = _build.load("sparse_tiles", _SIGNATURES)
    dev = packed.device
    guard, stream = _tiles.on_device(packed)
    workspace = _workspace(lib, dev, stream, rows, cols, tile, capacity)
    # the returned tensors are the dispatch's own: the board copy the
    # kernel writes in place, and the grid it writes every byte of
    board = packed.clone()
    out_grid = torch.empty(grid.shape, dtype=torch.bool, device=dev)
    # the host reads the counts after the launch, so they are the
    # dispatch's own too: another thread may launch on the same stream
    # before this one reads them
    counts = torch.empty(n_blocks + 1, dtype=torch.int32, device=dev)
    in_grid = grid.contiguous()
    with guard:
        err = lib.gol_sparse_dispatch(
            board.data_ptr(), in_grid.data_ptr(), out_grid.data_ptr(), counts.data_ptr(),
            workspace.data_ptr(), rows, cols, tr, tc, h, capacity, n_blocks,
            common, dead_only, live_only, stream,
        )
    _build.check(err, "sparse kernel cooperative launch")
    launches += 1
    return _read_counts(board, out_grid, counts.cpu().tolist(), n_blocks, capacity)


def _workspace(lib, dev, stream, rows, cols, tile, capacity) -> torch.Tensor:
    """The cached workspace of a dispatch (see ``_WORKSPACES``)."""
    key = (dev, stream, rows, cols, tuple(tile), capacity)
    with _WORKSPACE_LOCK:
        ws = _WORKSPACES.get(key)
        if ws is not None:
            _WORKSPACES.move_to_end(key)
            return ws
        size = ctypes.c_longlong()
        _build.check(lib.gol_sparse_workspace_bytes(rows, cols, tile[0], tile[1], capacity,
                                                    ctypes.byref(size)),
                     "gol_sparse_workspace_bytes")
        ws = torch.empty(size.value, dtype=torch.uint8, device=dev)
        _WORKSPACES[key] = ws
        while len(_WORKSPACES) > _WORKSPACES_KEPT:
            _WORKSPACES.popitem(last=False)
        return ws


def _read_counts(board, grid, counts, n_blocks, capacity) -> Dispatch:
    """Where the dispatch stopped, from ``counts[k]``, the active tiles
    block k started from: the first block whose count is not in
    1..capacity did not run (0: the grid was empty; more: overflow)."""
    blocks = 0
    while blocks < n_blocks and 1 <= counts[blocks] <= capacity:
        blocks += 1
    stopped = counts[blocks]
    overflow = blocks < n_blocks and stopped > capacity
    return Dispatch(board, grid, blocks, overflow, sum(counts[:blocks]), stopped)
