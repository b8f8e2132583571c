"""The engine's whole-board step functions, under the JAX package's names
(``gol_distributed_final_tpu/ops/pallas_stencil.py``) so that a caller's
code moves by changing the package name. This module holds no Pallas:
the kernels behind it are the port's CUDA kernels, the whole-board byte
kernel (K5, ops/byte_board.py) and the bitboard kernels
(ops/whole_board.py, ops/tiled.py).

K5's gate is the port's own: a byte board runs on it while its two copies
fit one block's shared memory (2 * H * W <= 232,448 B on an H100, so up to
340^2). The JAX package's gate admits up to 419,430 cells, and past it the
JAX package hands a board to the rule's roll stencil. So a 512^2 byte
board runs on K5 there and, unless the caller gives a ``fallback``, on the
byte tiles here (K6, ops/byte_tiled.py, 32 turns per launch): on the card
no default route runs torch ops. The boards are equal either way.
"""

from __future__ import annotations

from . import bitpack, byte_board, byte_tiled
from .plane import route_bit_step_n
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK, as_board


def pallas_step_n_fn(rule=None, *, fallback=None, device=None):
    """An engine step function ``(board, n) -> board`` running n turns of
    ``rule`` (Conway by default) in one launch of the whole-board byte
    kernel; a board past its gate goes to ``fallback``, by default the
    byte tiles in ceil(n / 32) launches. A numpy board goes to ``device``,
    the card unless the caller names another; a tensor stays where it
    is."""
    birth = rule.birth_mask if rule else CONWAY_BIRTH_MASK
    survive = rule.survive_mask if rule else CONWAY_SURVIVE_MASK
    if fallback is None:
        def fallback(board, n):
            return byte_tiled.step_n(board, n, birth, survive)

    def step_n(board, n):
        n = int(n)
        board = as_board(board, device)
        if not byte_board.fits(tuple(board.shape), board.device):
            return fallback(board, n)
        return byte_board.step_n(board, n, birth, survive)

    return step_n


def pallas_bit_step_n_fn(*, word_axis: int = 0, rule=None, device=None):
    """An engine step function ``(board_uint8, n) -> board_uint8`` on the
    int32 bitboard: pack, n turns in one launch of the whole-board kernel
    (the tiled kernel past its gate), unpack, all on the board's device.
    A numpy board goes to ``device``, the card unless the caller names
    another."""
    birth = rule.birth_mask if rule else CONWAY_BIRTH_MASK
    survive = rule.survive_mask if rule else CONWAY_SURVIVE_MASK

    def step_n(board, n):
        packed = bitpack.pack(as_board(board, device), word_axis)
        out = route_bit_step_n(packed, n, word_axis, birth, survive)
        return bitpack.unpack(out, word_axis)

    return step_n
