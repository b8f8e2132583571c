"""Alive-cell reductions of a byte board (reference: broker/broker.go:47-58,
``calculateAliveCells``).

* ``alive_count`` — the scalar behind the 2-second ``AliveCellsCount``
  event, reduced on the board's device; ``alive_count_batch`` — one per
  universe of a session batch.
* ``alive_cells`` — the ``[]util.Cell`` payload of ``FinalTurnComplete``,
  produced row-major like the reference's nested loop so orderings agree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cell import Cell


def alive_count(board: torch.Tensor) -> int:
    """Number of alive cells."""
    return int(torch.count_nonzero(board))


def alive_count_batch(boards: torch.Tensor) -> torch.Tensor:
    """Per-universe alive counts of a byte batch ``[B, H, W]`` as an int64
    tensor ``[B]`` on the batch's device: one reduction for the whole
    session batch, from which every session's count demuxes."""
    return torch.count_nonzero(boards, dim=(-2, -1))


def alive_cells(board) -> list[Cell]:
    """Coordinates of alive cells as ``Cell(x, y)``, row-major. Takes a
    tensor on any device or a numpy array."""
    if isinstance(board, torch.Tensor):
        board = board.cpu().numpy()
    ys, xs = np.nonzero(np.asarray(board))
    return [Cell(int(x), int(y)) for x, y in zip(xs, ys)]
