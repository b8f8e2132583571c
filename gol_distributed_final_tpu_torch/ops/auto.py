"""Automatic data-plane selection for the engine.

* a 32-divisible axis, packed board under the whole-board gate -> the
  fused bitboard plane (one launch per chunk, counts included);
* a 32-divisible axis past the gate -> the bitboard plane, whose steps
  run on the tiled kernel;
* indivisible geometry -> None (the caller uses the roll stencil's
  byte plane, which handles every geometry).

``auto_batch_plane`` picks the batched plane of a session table the same
way: the bitboard batch when an axis divides by 32, else the byte batch.

The JAX package sends packable boards of 4096^2 cells or more to its
activity-sparse plane; the port has no sparse plane yet, so they go to
the dense bitboard plane, with identical results.
"""

from __future__ import annotations

from typing import Optional

from .bitpack import packed_shape
from .fused import FusedBitPlane
from .plane import BitPlane
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
    if fits(packed_shape(*shape, word_axis), device):
        return FusedBitPlane(rule, word_axis, device)
    return BitPlane(rule, word_axis, device)


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
