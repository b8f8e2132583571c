"""The byte-tile step: uint8 {0, 255} boards of any size, 1..32 turns per
launch over a 2-D grid of tiles with k-cell halos (csrc/byte_tiled.cu).

It replaces the JAX package's Pallas kernel K6,
``gol_distributed_final_tpu/ops/fused.py:342`` (``byte_tiled_pallas_call``,
body ``_fused_byte_tiled_kernel`` :325): full-width row blocks with 32-row
halo strips there, whose strip depth (the uint8 Mosaic sublane tile) and
full width are no part of the contract here. What bounds the kernel and how
the design meets that is written at the top of the CUDA source.

The plain version does the same window-and-interior arithmetic in torch,
with k roll-stencil turns on the batch of windows; the window gather and
the launch loop are the bitboard tiles' (ops/_tiles.py). ``step_n`` takes
the plain version only for a tensor on the CPU. For a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _tiles
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK
from .stencil import step_n as stencil_step_n

#: turns one launch may take: the halo is that many cells deep
MAX_TURNS = 32

#: output tile in cells (rows, cols), fixed at compile time in
#: csrc/byte_tiled.cu (kTileR, kTileC). Its window at k = 32 is 96 x 192
#: bytes, two copies 36,864 B; 512^2 is 16 x 4 tiles
TILE = (32, 128)

#: tile rows one launch's grid holds (gridDim.y)
MAX_GRID_ROWS = 65_535

#: kernel launches made by ``step_n``; ``plain_calls`` counts the calls
#: that took the plain version (CPU tensors) instead
launches = 0
plain_calls = 0

_SIGNATURES = {
    "gol_byte_tiled_step": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ],
}


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def can_tile(shape: tuple[int, ...]) -> bool:
    """Whether the kernel takes a board of ``shape``: any 2-D board whose
    rows of tiles fit one launch's grid. Tiles with halos on all four sides
    and modulo indices need no alignment and set no width limit, so every
    shape the JAX package's ``can_tile_byte`` accepts (H % 32 == 0,
    H / 32 >= 2, W % 128 == 0, W <= 3456), 512^2 among them, passes."""
    return (
        len(shape) == 2
        and shape[0] >= 1
        and shape[1] >= 1
        and -(-shape[0] // TILE[0]) <= MAX_GRID_ROWS
    )


def _launch_sizes(n: int, turns_per_launch: int) -> list[int]:
    return _tiles.launch_sizes(n, turns_per_launch, MAX_TURNS, "a byte-tile launch")


def launch_plain(board, k, birth_mask=CONWAY_BIRTH_MASK, survive_mask=CONWAY_SURVIVE_MASK):
    """What one kernel launch computes, in torch: k turns, tile by tile."""
    _launch_sizes(k, k)  # a launch of k turns: 1..MAX_TURNS
    return _tiles.launch_plain(
        board, k, TILE,
        lambda windows, k: stencil_step_n(windows, k, birth_mask=birth_mask,
                                          survive_mask=survive_mask),
    )


def step_n_plain(board, n, birth_mask=CONWAY_BIRTH_MASK, survive_mask=CONWAY_SURVIVE_MASK,
                 *, turns_per_launch=MAX_TURNS):
    """The plain version of ``step_n``: the same launches, in torch."""
    for k in _launch_sizes(n, turns_per_launch):
        board = launch_plain(board, k, birth_mask, survive_mask)
    return board


def step_n(
    board: torch.Tensor,
    n: int,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    turns_per_launch: int = MAX_TURNS,
) -> torch.Tensor:
    """n turns of a uint8 board ``[H, W]`` (any nonzero cell is alive; the
    result holds 0 and 255) in ceil(n / k) launches of k =
    ``turns_per_launch`` turns (the last takes the rest). The input is
    never written."""
    global plain_calls
    sizes = _launch_sizes(n, turns_per_launch)
    if board.device.type == "cpu":
        plain_calls += 1
        return step_n_plain(board, n, birth_mask, survive_mask,
                            turns_per_launch=turns_per_launch)
    if board.device.type != "cuda":
        raise ValueError(f"no byte-tile kernel for device {board.device}")
    if board.dtype != torch.uint8 or board.dim() != 2 or not board.is_contiguous():
        raise ValueError(
            "the byte-tile kernel takes a contiguous 2-D uint8 board, got "
            f"{board.dtype} {tuple(board.shape)} contiguous={board.is_contiguous()}"
        )
    if not can_tile(tuple(board.shape)):
        raise ValueError(f"byte board {tuple(board.shape)} has more than "
                         f"{MAX_GRID_ROWS} rows of {TILE[0]}-row tiles")
    rows, cols = board.shape
    lib = _build.load("byte_tiled", _SIGNATURES)

    def launch(src, dst, k, stream):
        global launches
        err = lib.gol_byte_tiled_step(
            src.data_ptr(), dst.data_ptr(), rows, cols, k, birth_mask, survive_mask, stream,
        )
        _build.check(err, "byte-tile kernel launch")
        launches += 1

    return _tiles.ping_pong(board, sizes, launch)
