"""The byte-per-cell Game of Life stencil, in torch ops.

One turn is 8 ``torch.roll`` shifts summed into a neighbour-count plane,
then a rule lookup. This is the data plane of boards with no axis
divisible by 32 (the reference's 16x16 fixture): the JAX package runs it
through XLA with no hand-written kernel, so plain torch ops are its
counterpart here.

Cell encoding matches the reference wire format: alive = 255, dead = 0
(reference: README.md:27, worker/worker.go:44). Rules are 9-bit masks over
the neighbour count (bit ``n`` set => the transition applies at count
``n``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

ALIVE = 255
DEAD = 0

# Conway's Life: B3/S23.
CONWAY_BIRTH_MASK = 1 << 3
CONWAY_SURVIVE_MASK = (1 << 2) | (1 << 3)

_NEIGHBOUR_OFFSETS = tuple(
    (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
)


def as_board(board, device=None) -> torch.Tensor:
    """A board handed to a step function as a tensor: a tensor as it is,
    anything else (a numpy array) copied as uint8 onto ``device``, the
    CUDA card unless the caller names another."""
    if isinstance(board, torch.Tensor):
        return board
    return torch.from_numpy(np.array(board, np.uint8)).to(resolve_device(device))


def neighbour_counts(board: torch.Tensor) -> torch.Tensor:
    """Toroidal 8-neighbour count, ``uint8[..., H, W]`` with values in
    0..8; leading axes are a batch of boards, each its own torus."""
    ones = (board != 0).to(torch.uint8)
    total = torch.zeros_like(ones)
    for dy, dx in _NEIGHBOUR_OFFSETS:
        total += torch.roll(ones, (dy, dx), dims=(-2, -1))
    return total


def counts_from_extended(ext: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """8-neighbour counts of the (h, w) centre of an extended block that
    already carries a one-cell border (halos, or local wrap): the mesh
    step's count (parallel/halo.py)."""
    ones = (ext != 0).to(torch.uint8)
    counts = torch.zeros((h, w), dtype=torch.uint8, device=ext.device)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if (dy, dx) != (1, 1):
                counts += ones[dy:dy + h, dx:dx + w]
    return counts


def _table(mask: int, device) -> torch.Tensor:
    return torch.tensor([bool(mask >> c & 1) for c in range(9)], device=device)


def apply_rule(
    board: torch.Tensor,
    counts: torch.Tensor,
    *,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """Life-like transition: next state from current state + neighbour
    count (reference: worker/worker.go:41-46 for the Conway masks)."""
    idx = counts.long()
    born = _table(birth_mask, board.device)[idx]
    survives = _table(survive_mask, board.device)[idx]
    next_alive = torch.where(board != 0, survives, born)
    return next_alive.to(torch.uint8) * ALIVE


def step(
    board: torch.Tensor,
    *,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """One turn (reference: worker/worker.go:15-70)."""
    return apply_rule(
        board,
        neighbour_counts(board),
        birth_mask=birth_mask,
        survive_mask=survive_mask,
    )


def step_n(
    board: torch.Tensor,
    n: int,
    *,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """``n`` turns."""
    for _ in range(int(n)):
        board = step(board, birth_mask=birth_mask, survive_mask=survive_mask)
    return board


def step_n_batch(
    boards: torch.Tensor,
    n: int,
    *,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """``n`` turns over a batch of independent universes ``uint8[B, H,
    W]``, each on its own torus: the byte tier of the sessions batch, for
    geometries with no axis divisible by 32 (the JAX package leaves its
    vmapped counterpart to XLA)."""
    if boards.dim() != 3:
        raise ValueError(f"batch boards must be [B, H, W], got {tuple(boards.shape)}")
    return step_n(boards, n, birth_mask=birth_mask, survive_mask=survive_mask)


def alive_history(
    board: torch.Tensor,
    n: int,
    *,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> np.ndarray:
    """The alive count after each of turns 1..n as ``np.int32[n]`` on the
    byte stencil, counted on the board's device and read back once: the
    sibling of ``bitpack.alive_history`` for boards whose packed axis does
    not divide by 32 (the 16x16 fixture family). The JAX package runs it
    through XLA, and such boards are far too small to need a kernel.
    Padding the torus out to a packable size would change the evolution."""
    board = as_board(board)
    counts = []
    for _ in range(int(n)):
        board = step(board, birth_mask=birth_mask, survive_mask=survive_mask)
        counts.append((board != 0).sum())
    if not counts:
        return np.zeros(0, np.int32)
    return torch.stack(counts).to(torch.int32).cpu().numpy()
