"""The byte-tile step: uint8 {0, 255} boards of any size, 1..32 turns per
launch over a 2-D grid of tiles that step as bitboards on chip
(csrc/byte_tiled.cu).

It replaces the JAX package's Pallas kernel K6,
``gol_distributed_final_tpu/ops/fused.py:342`` (``byte_tiled_pallas_call``,
body ``_fused_byte_tiled_kernel`` :325): full-width row blocks with 32-row
halo strips there, whose strip depth (the uint8 Mosaic sublane tile) and
full width are no part of the contract here. What bounds the kernel and how
the design meets that is written at the top of the CUDA source.

The plain version does the kernel's arithmetic in torch: it gathers every
tile's window in cells with modulo indices (the tile, k rows above and
below, one word of 32 columns left and right: ``halo``), packs the windows
along their columns, runs k turns of ``bitpack.bit_step_n`` on the batch of
packed windows and unpacks the interiors. The window gather and the launch
loop are the bitboard tiles' (ops/_tiles.py). ``step_n`` takes the plain
version only for a tensor on the CPU. For a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import device as _device
from . import _build, _tiles
from .bitpack import WORD, bit_step_n, byte_launch_cost, pack, unpack
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK

#: turns one launch may take: the halo is that many rows deep, and the one
#: word of 32 columns on each side covers as many (``halo``)
MAX_TURNS = 32

#: the wide output tile in cells (rows, cols), fixed at compile time in
#: csrc/byte_tiled.cu (kTileR, kTileC): 8 words across, so the window's two
#: halo words add a quarter, and 64 rows, so 8 turns' halo rows add another.
#: 4096^2 is 64 x 16 of them
TILE = (64, 256)

#: the small output tile (kSmallTileR, kSmallTileC), for a board with fewer
#: than ``MIN_BLOCKS`` wide tiles (a block for each SM of an H100): 512^2
#: is 8 x 2 wide tiles, and 32 x 8 small ones
SMALL_TILE = (16, 64)
MIN_BLOCKS = 132

#: tile rows one launch's grid holds (gridDim.y)
MAX_GRID_ROWS = 65_535

#: kernel launches made; ``plain_calls`` counts the launches that the plain
#: version stood in for (CPU tensors) instead
launches = 0
plain_calls = 0

_SIGNATURES = {
    "gol_byte_tiled_step_tile": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
    ],
}
_entry = None  # the library's gol_byte_tiled_step_tile, resolved at its first launch


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def can_tile(shape: tuple[int, ...]) -> bool:
    """Whether the kernel takes a board of ``shape``: any 2-D board whose
    rows of tiles fit one launch's grid (a board that tall takes the wide
    tile). Windows gathered in cells with modulo indices need no alignment
    and set no width limit, so every shape the JAX package's
    ``can_tile_byte`` accepts (H % 32 == 0, H / 32 >= 2, W % 128 == 0,
    W <= 3456), 512^2 among them, passes."""
    return (
        len(shape) == 2
        and shape[0] >= 1
        and shape[1] >= 1
        and -(-shape[0] // TILE[0]) <= MAX_GRID_ROWS
    )


def tile_for(shape: tuple[int, int]) -> tuple[int, int]:
    """The tile a board of ``shape`` is cut into, the one place it is
    chosen: the wide one unless that leaves fewer than ``MIN_BLOCKS``
    blocks."""
    wide_blocks = -(-shape[0] // TILE[0]) * -(-shape[1] // TILE[1])
    return SMALL_TILE if wide_blocks < MIN_BLOCKS else TILE


def halo(k: int) -> tuple[int, int]:
    """The window's halo (rows, cols) for a launch of k turns: k rows, which
    the shrinking cone uses up, and one word of columns. That word's missing
    outer neighbour spoils one more of its outer bits a turn; after k - 1
    turns its k - 1 outer bits are wrong and the rest right, and turn k reads
    only its innermost bit, so one word serves while k - 1 < 32."""
    if not 1 <= k <= WORD:
        raise ValueError(f"one halo word covers 1..{WORD} turns, got {k}")
    return k, WORD


def _launch_sizes(n: int, turns_per_launch: int) -> list[int]:
    return _tiles.launch_sizes(n, turns_per_launch, MAX_TURNS, "a byte-tile launch")


def launch_plain(board, k, birth_mask=CONWAY_BIRTH_MASK, survive_mask=CONWAY_SURVIVE_MASK,
                 *, tile=None):
    """What one kernel launch computes, in torch: k turns, tile by tile, on
    the packed windows the kernel steps."""
    _launch_sizes(k, k)  # a launch of k turns: 1..MAX_TURNS

    def step_windows(windows, k):
        packed = bit_step_n(pack(windows, 1), k, 1, birth_mask, survive_mask)
        return unpack(packed, 1)

    return _tiles.launch_plain(
        board, k, tile_for(tuple(board.shape)) if tile is None else tile, step_windows,
        halo=halo(k),
    )


def step_n_plain(board, n, birth_mask=CONWAY_BIRTH_MASK, survive_mask=CONWAY_SURVIVE_MASK,
                 *, turns_per_launch=MAX_TURNS, tile=None):
    """The plain version of ``step_n``: the same launches, in torch."""
    for k in _launch_sizes(n, turns_per_launch):
        board = launch_plain(board, k, birth_mask, survive_mask, tile=tile)
    return board


def step_sizes(
    board: torch.Tensor,
    sizes,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    tile=None,
    site: str = "pallas.fused_byte",
) -> torch.Tensor:
    """One launch for each k of ``sizes`` (each 1..MAX_TURNS turns), the
    board of each the result of the one before, with the scratch boards,
    the device and the stream taken once for them all: a whole ladder in one
    call, on ``tile_for``'s tile unless ``tile`` forces ``TILE`` or
    ``SMALL_TILE``. The input is never written. ``site`` is the telemetry
    site each launch is timed under (obs/device.py; the JAX package's byte
    tiles are its fused ladder's)."""
    global plain_calls, _entry
    sizes = [int(k) for k in sizes]
    for k in sizes:
        _launch_sizes(k, k)
    cells = board.numel()
    if board.device.type == "cpu":
        plain_calls += len(sizes)
        for k in sizes:
            started = _device.begin(board.device)
            board = launch_plain(board, k, birth_mask, survive_mask, tile=tile)
            if started is not None:
                _device.end(site, board.device, started,
                            *byte_launch_cost(cells, k, birth_mask, survive_mask))
        return board
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
    if tile not in (None, TILE, SMALL_TILE):
        raise ValueError(f"the byte-tile kernel has tiles {TILE} and {SMALL_TILE}, got {tile}")
    rows, cols = board.shape
    which = 1 if (tile or tile_for((rows, cols))) == TILE else 2
    if _entry is None:
        _entry = _build.load("byte_tiled", _SIGNATURES).gol_byte_tiled_step_tile
    entry = _entry
    timing = _device.timing_stream(board.device)

    def launch(src, dst, k, stream):
        global launches
        started = _device.begin(src.device, timing)
        err = entry(src.data_ptr(), dst.data_ptr(), rows, cols, k, birth_mask, survive_mask,
                    which, stream)
        if err:
            _build.check(err, "byte-tile kernel launch")
        launches += 1
        if started is not None:
            _device.end(site, src.device, started,
                        *byte_launch_cost(cells, k, birth_mask, survive_mask))

    return _tiles.ping_pong(board, sizes, launch)


def step_n(
    board: torch.Tensor,
    n: int,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    turns_per_launch: int = MAX_TURNS,
    tile=None,
) -> torch.Tensor:
    """n turns of a uint8 board ``[H, W]`` (any nonzero cell is alive; the
    result holds 0 and 255) in ceil(n / k) launches of k =
    ``turns_per_launch`` turns (the last takes the rest). The input is
    never written."""
    return step_sizes(board, _launch_sizes(n, turns_per_launch), birth_mask, survive_mask,
                      tile=tile)
