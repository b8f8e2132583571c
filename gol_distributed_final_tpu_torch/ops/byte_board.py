"""The whole-board byte step: n turns of a uint8 {0, 255} board held in one
thread block's shared memory, in one launch (csrc/byte_board.cu).

It replaces the JAX package's Pallas kernel K5,
``gol_distributed_final_tpu/ops/pallas_stencil.py:125``
(``byte_pallas_call``, body ``_kernel`` :115, turn ``byte_turn_fn``
:91-112). What bounds it on the card and how the design meets that is
written at the top of the CUDA source.

The gate is the port's own: the board's two uint8 copies must fit the
block's opt-in shared memory, 2 * H * W <= 232,448 B on an H100, so 256^2
fits and 512^2 does not (340^2 is the largest square). The JAX package's
gate, ``fits_vmem(shape, 4)``, is a v5e working-set estimate that admits
up to 419,430 cells, 512^2 and 640^2 among them. So a 512^2 byte board
reaches K5 in the JAX package but not here: ``ops/fused.fused_step_n``
and ``ops/pallas_stencil.pallas_step_n_fn`` send it to the byte tiles
(ops/byte_tiled.py). The boards are equal either way.

``step_n`` takes the plain version (the roll stencil, ops/stencil.py)
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, whole_board
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK
from .stencil import step_n as stencil_step_n

#: kernel launches made by ``step_n``; ``plain_calls`` counts the times it
#: took the plain version (CPU tensors) instead
launches = 0
plain_calls = 0

_SIGNATURES = {
    "gol_byte_board_step": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ],
}


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def smem_bytes(shape: tuple[int, int]) -> int:
    """Shared memory the kernel needs for a board: two uint8 copies."""
    return 2 * shape[0] * shape[1]


def fits(shape: tuple[int, ...], device) -> bool:
    """Whether a 2-D byte board of ``shape`` fits one block on ``device``
    (the opt-in limit the card reports, the H100's for the CPU)."""
    return len(shape) == 2 and smem_bytes(shape) <= whole_board.smem_limit(device)


def step_n_plain(board, n, birth_mask=CONWAY_BIRTH_MASK, survive_mask=CONWAY_SURVIVE_MASK):
    """The plain version of the kernel: n turns of the roll stencil."""
    return stencil_step_n(board, n, birth_mask=birth_mask, survive_mask=survive_mask)


def step_n(
    board: torch.Tensor,
    n: int,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """n turns of a uint8 board ``[H, W]`` (any nonzero cell is alive; the
    result holds 0 and 255) in one launch. n = 0 returns a copy and
    launches nothing. The input is never written."""
    global launches, plain_calls
    n = int(n)
    if n < 0:
        raise ValueError(f"turn count must be >= 0, got {n}")
    if n == 0:
        return board.clone()
    if board.device.type == "cpu":
        plain_calls += 1
        return step_n_plain(board, n, birth_mask, survive_mask)
    if board.device.type != "cuda":
        raise ValueError(f"no whole-board byte kernel for device {board.device}")
    if board.dtype != torch.uint8 or board.dim() != 2 or not board.is_contiguous():
        raise ValueError(
            "the whole-board byte kernel takes a contiguous 2-D uint8 board, got "
            f"{board.dtype} {tuple(board.shape)} contiguous={board.is_contiguous()}"
        )
    shape = tuple(board.shape)
    if not fits(shape, board.device):
        raise ValueError(
            f"byte board {shape[0]}x{shape[1]} needs {smem_bytes(shape)} B of shared "
            f"memory, past the block's {whole_board.smem_limit(board.device)} B: it "
            "belongs to the byte tiles"
        )
    out = torch.empty_like(board)
    with torch.cuda.device(board.device):
        err = _build.load("byte_board", _SIGNATURES).gol_byte_board_step(
            board.data_ptr(), out.data_ptr(), shape[0], shape[1], n,
            birth_mask, survive_mask, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "whole-board byte kernel launch")
    launches += 1
    return out
