"""Data planes — the engine's board representation on the device.

The engine holds an opaque device-resident *state* and talks to it
through a small interface, so the packed bitboard stays packed across
chunks: encode once at Run start, decode only for Retrieve/final.

Interface (duck-typed; a state is a tensor, or for the activity-sparse
plane a ``SparseState`` whose ``packed`` tensor holds the board):
    encode(board_uint8) -> state      host uint8 [H, W] -> device state
    step_n(state, n) -> state         n turns; never writes ``state``
    decode(state) -> np.uint8 [H, W]  full host board (Retrieve/final only)
    alive_count(state) -> int         reduction on the device, tiny transfer
    alive_cells(state) -> [Cell]      FinalTurnComplete's payload

Optional fused step+count protocol (ops/fused.FusedBitPlane):
    step_n_counted(state, n) -> (state, counts)
                                      n turns AND the alive reduction;
                                      ``counts`` is a device vector whose
                                      int64 host sum (ops/fused.fold_counts)
                                      is the returned state's alive count

Optional early-exit protocol, read through :func:`plane_steady_kind`:
    steady_kind(state) -> None | "still" | "period2"
    fast_forward(state, k) -> state   k turns of a steady state in O(1)

A plane's ``device`` defaults to the CUDA card, as every entry point's
does (device.py). Routing never falls back: a kernel launch that fails
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import CONWAY, LifeRule
from . import bitpack, stencil, tiled, whole_board
from .reduce import alive_cells, alive_count


def plane_steady_kind(plane, state):
    """``None`` unless the plane implements ``steady_kind`` and has marked
    this state steady (the activity-sparse plane, ops/sparse.py, does)."""
    probe = getattr(plane, "steady_kind", None)
    if probe is None or state is None:
        return None
    return probe(state)


class BytePlane:
    """The identity representation: a uint8 {0,255} board on the device,
    stepped by the roll stencil (ops/stencil.py) or by a step function
    ``(board, n) -> board`` (the engine's ``step_n_fn``, e.g.
    ``ops/fused.fused_step_n``). The step function gets the board as a
    tensor on the plane's device and must return one of the same device,
    dtype and shape: anything else raises, so no step function can move
    the board off the card unnoticed."""

    def __init__(self, rule: LifeRule = CONWAY, device=None, step_n_fn=None):
        self.rule = rule
        self.device = resolve_device(device)
        self._step_n_fn = step_n_fn

    def encode(self, board) -> torch.Tensor:
        # a copy: the engine hands out read-only arrays
        return torch.from_numpy(np.array(board, np.uint8)).to(self.device)

    def step_n(self, state, n: int):
        if self._step_n_fn is None:
            return stencil.step_n(
                state, n,
                birth_mask=self.rule.birth_mask, survive_mask=self.rule.survive_mask,
            )
        out = self._step_n_fn(state, n)
        if not (
            isinstance(out, torch.Tensor)
            and out.device == state.device
            and out.dtype == state.dtype
            and out.shape == state.shape
        ):
            got = (
                f"{out.dtype} {tuple(out.shape)} on {out.device}"
                if isinstance(out, torch.Tensor) else type(out).__name__
            )
            raise TypeError(
                f"the step function returned {got}; the engine needs {state.dtype} "
                f"{tuple(state.shape)} on {state.device}"
            )
        return out

    def decode(self, state) -> np.ndarray:
        return state.cpu().numpy()

    def alive_count(self, state) -> int:
        return alive_count(state)

    def alive_cells(self, state):
        return alive_cells(state)


def route_bit_step_n(state, n: int, word_axis: int, birth_mask: int, survive_mask: int):
    """n turns of an int32 bitboard, routed by shape: the whole-board
    kernel under its shared-memory gate (ops/whole_board.py), the tiled
    kernel past it (ops/tiled.py); n <= 0 returns ``state``."""
    n = int(n)
    if n <= 0:
        return state
    args = (state, n, word_axis, birth_mask, survive_mask)
    if whole_board.fits(tuple(state.shape), state.device):
        return whole_board.step_n(*args)
    return tiled.step_n(*args)


class BitPlane:
    """The int32 bitboard: 32 cells per word, packed across chunks.
    ``step_n`` routes by shape: the whole-board kernel under its
    shared-memory gate (ops/whole_board.py), the tiled kernel past it
    (ops/tiled.py). ``alive_count`` is a popcount, no unpack."""

    def __init__(self, rule: LifeRule = CONWAY, word_axis: int = 0, device=None):
        self.rule = rule
        self.word_axis = word_axis
        self.device = resolve_device(device)

    def encode(self, board) -> torch.Tensor:
        return bitpack.pack(board, self.word_axis, self.device)

    def step_n(self, state, n: int):
        return route_bit_step_n(
            state, n, self.word_axis, self.rule.birth_mask, self.rule.survive_mask
        )

    def decode(self, state) -> np.ndarray:
        return bitpack.unpack(state, self.word_axis).cpu().numpy()

    def alive_count(self, state) -> int:
        return bitpack.alive_count_packed(state)

    def alive_cells(self, state):
        return bitpack.alive_cells_packed(state, self.word_axis)
