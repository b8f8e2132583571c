"""Batched data planes — many independent universes in one device tensor.

The serving unit of multi-universe sessions is one universe with its own
turn budget; the device unit is a batch tensor with a leading universe
axis. These planes are the batch-shaped mirror of ops/plane.py, plus the
per-universe operations a session table needs:

    encode(boards_uint8[B, H, W]) -> state      device batch state
    step_n(state, n) -> state                   n turns for ALL universes
    step_n_counts(state, n) -> (state, np.int64[B])
                                                n turns AND every universe's
                                                alive count
    decode(state) -> np.uint8 [B, H, W]         full host batch
    decode_one(state, i) -> np.uint8 [H, W]     one universe
    alive_counts(state) -> np.int64 [B]         one batched reduction
    take(state, rows) -> state                  slot compaction: keep rows,
                                                in order (a device gather)
    append(state, other) -> state               join at a boundary

Tiers (ops/auto.auto_batch_plane picks one by shape):

* ``BatchBitPlane`` — int32 bitboards ``[B, H/32, W]`` or ``[B, H, W/32]``.
  While one universe fits a block's shared memory, ``step_n_counts`` is ONE
  launch of the batched kernel (ops/batch_board.py, the port of K2) with
  the row popcounts fused, the counterpart of the JAX package's
  ``_fused_batch_counted_compiled(use_pallas=True)``. Past that gate each
  universe steps on the tiled kernel in turn, with torch row popcounts, as
  ``FusedBitPlane`` handles such a board. Routing is by shape only: no
  kernel failure is caught and rerouted.
* ``BatchBytePlane`` — uint8 ``[B, H, W]`` through the torch roll stencil:
  every geometry, any life-like rule.

Every tier is bit-identical per universe to its sequential single-board
counterpart; the batch axis changes no arithmetic.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models import CONWAY, LifeRule
from . import batch_board, bitpack, fused, tiled
from .reduce import alive_count_batch
from .stencil import step_n_batch


def _require_batch(boards) -> np.ndarray:
    boards = np.asarray(boards, np.uint8)
    if boards.ndim != 3:
        raise ValueError(f"batch boards must be [B, H, W], got {boards.shape}")
    return boards


class _BatchPlane:
    """The representation-agnostic batch operations: slot compaction and
    join are leading-axis gathers and concatenations, the same for every
    tier."""

    def __init__(self, rule: LifeRule = CONWAY, device=None):
        self.rule = rule
        self.device = resolve_device(device)

    def take(self, state, rows: Sequence[int]):
        index = torch.as_tensor(list(rows), dtype=torch.long, device=state.device)
        return state.index_select(0, index)

    def append(self, state, other):
        if state is None:
            return other
        return torch.cat([state, other], dim=0)


class BatchBytePlane(_BatchPlane):
    """A device uint8 {0,255} ``[B, H, W]`` batch stepped by the roll
    stencil: every geometry and rule."""

    def encode(self, boards):
        return torch.from_numpy(_require_batch(boards).copy()).to(self.device)

    def step_n(self, state, n: int):
        return step_n_batch(
            state, int(n),
            birth_mask=self.rule.birth_mask, survive_mask=self.rule.survive_mask,
        )

    def step_n_counts(self, state, n: int):
        """n turns for every universe and their alive counts, as
        ``(state, np.int64[B])``; the host transfer waits for the device."""
        if int(n) > 0:
            fused._meter_single(int(n))
        out = self.step_n(state, n)
        return out, self.alive_counts(out)

    def decode(self, state) -> np.ndarray:
        return state.cpu().numpy()

    def decode_one(self, state, i: int) -> np.ndarray:
        return state[i].cpu().numpy()

    def alive_counts(self, state) -> np.ndarray:
        return alive_count_batch(state).cpu().numpy().astype(np.int64)


class BatchBitPlane(_BatchPlane):
    """Batched int32 bitboards ``[B, H/32, W]`` (word_axis 0) or ``[B, H,
    W/32]``; the kernel routing is in the module docstring."""

    def __init__(self, rule: LifeRule = CONWAY, word_axis: int = 0, device=None):
        super().__init__(rule, device)
        self.word_axis = word_axis

    def encode(self, boards):
        return bitpack.pack_batch(_require_batch(boards), self.word_axis, self.device)

    def _args(self, n: int):
        return n, self.word_axis, self.rule.birth_mask, self.rule.survive_mask

    def step_n(self, state, n: int):
        n = int(n)
        if n <= 0:
            return state
        if batch_board.fits(tuple(state.shape), state.device):
            return batch_board.step_n(state, *self._args(n), counted=False)
        return torch.stack([tiled.step_n(board, *self._args(n)) for board in state])

    def step_n_counts(self, state, n: int):
        """n turns for every universe and their alive counts, as
        ``(state, np.int64[B])``: one counted launch of the batched kernel
        under the gate. The host fold of the int32 row counts waits for
        the device."""
        n = int(n)
        if n <= 0:
            return state, self.alive_counts(state)
        fused._meter_single(n)
        if batch_board.fits(tuple(state.shape), state.device):
            out, counts = batch_board.step_n(state, *self._args(n), site="pallas.fused_bit_batch")
        else:
            out = self.step_n(state, n)
            counts = bitpack.row_popcounts(out)
        return out, counts.cpu().numpy().sum(axis=1, dtype=np.int64)

    def decode(self, state) -> np.ndarray:
        return bitpack.unpack_batch(state, self.word_axis).cpu().numpy()

    def decode_one(self, state, i: int) -> np.ndarray:
        return bitpack.unpack(state[i], self.word_axis).cpu().numpy()

    def alive_counts(self, state) -> np.ndarray:
        return bitpack.alive_count_packed_batch(state)
