"""Automatic data-plane selection for the engine.

* rows divisible by 32 and ``sparse_capable`` (a rule without birth on 0,
  a board of at least ``SPARSE_MIN_CELLS``, the ``GOL_SPARSE`` knob) ->
  the activity-sparse plane (ops/sparse.py), as the JAX package routes;
* a 32-divisible axis, packed board under the whole-board gate -> the
  fused bitboard plane (one launch per chunk, counts included), unless
  ``GOL_FUSED=off`` (ops/fused.py::fused_enabled);
* a 32-divisible axis past the gate, or ``GOL_FUSED=off`` -> the bitboard
  plane, whose steps run on the whole-board or the tiled kernel by shape;
* indivisible geometry -> None (the caller uses the roll stencil's
  byte plane, which handles every geometry).

``auto_step_n_fn`` gives the same choice as an engine step function
that packs and unpacks on every call.

``auto_batch_plane`` picks the batched plane of a session table the same
way: the bitboard batch when an axis divides by 32, else the byte batch.
"""

from __future__ import annotations

from typing import Optional

from ..device import resolve_device
from .bitpack import packed_shape
from .fused import FusedBitPlane, fused_enabled
from .plane import BitPlane
from .sparse import SparseBitPlane, sparse_capable
from .whole_board import fits


def choose_word_axis(shape: tuple[int, int]) -> Optional[int]:
    """Pack rows when H divides by 32, else columns, else None (only the
    roll stencil applies)."""
    h, w = shape
    if h % 32 == 0:
        return 0
    if w % 32 == 0:
        return 1
    return None


def auto_plane(rule, shape: tuple[int, int], device):
    """The data plane (ops/plane.py interface) for this rule, geometry
    and device, or None if only the roll stencil applies."""
    word_axis = choose_word_axis(shape)
    if word_axis is None:
        return None
    if word_axis == 0 and sparse_capable(rule, shape):
        return SparseBitPlane(rule, device=device)
    if fused_enabled() and fits(packed_shape(*shape, word_axis), device):
        return FusedBitPlane(rule, word_axis, device)
    return BitPlane(rule, word_axis, device)


def auto_step_n_fn(rule, shape: tuple[int, int], device=None):
    """An engine step function ``(board_uint8, n) -> board_uint8`` for this
    rule and geometry, or None if only the roll stencil applies: the
    bitboard kernels' (``pallas_bit_step_n_fn``) on the card, the torch
    bitboard step (``packed_step_n_fn``) on the CPU, as the JAX package
    picks its kernel on a TPU and XLA off one. It packs and unpacks on
    every call; ``auto_plane`` keeps the board packed across chunks."""
    word_axis = choose_word_axis(shape)
    if word_axis is None:
        return None
    if resolve_device(device).type == "cuda":
        from .pallas_stencil import pallas_bit_step_n_fn

        return pallas_bit_step_n_fn(word_axis=word_axis, rule=rule, device=device)
    from .bitpack import packed_step_n_fn

    return packed_step_n_fn(word_axis, rule=rule, device=device)


def auto_batch_plane(rule, shape: tuple[int, int], device):
    """The batched data plane (ops/batched.py interface) for this
    per-universe rule, geometry and device: the bitboard batch for a
    32-divisible axis, the roll-stencil byte batch for every other
    geometry. Always returns a plane."""
    from .batched import BatchBitPlane, BatchBytePlane

    word_axis = choose_word_axis(shape)
    if word_axis is None:
        return BatchBytePlane(rule, device)
    return BatchBitPlane(rule, word_axis, device)
