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
from ..obs import device as _device
from ..obs import instruments as _ins
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


#: (tier, rulestring, shape, device) decisions already noted: a session
#: table or a broker asking per admission counts one routing decision, as
#: the JAX package's per-(rule, shape) cache counts it
_NOTED: set = set()


def _note_selection(tier: str, rule, shape, device) -> None:
    """One selection event, once per decision: an HBM sample at decision
    time and the tier counter a Status snapshot shows routing decisions
    on (the JAX package's labels)."""
    key = (tier, getattr(rule, "rulestring", None), tuple(shape), str(device))
    if key in _NOTED:
        return
    _NOTED.add(key)
    _device.sample_hbm()
    _ins.OPS_PLANE_SELECTED_TOTAL.labels(tier).inc()


def auto_plane(rule, shape: tuple[int, int], device):
    """The data plane (ops/plane.py interface) for this rule, geometry
    and device, or None if only the roll stencil applies."""
    word_axis = choose_word_axis(shape)
    if word_axis is None:
        _note_selection("roll_stencil", rule, shape, device)
        return None
    if word_axis == 0 and sparse_capable(rule, shape):
        _note_selection("sparse_bitplane", rule, shape, device)
        return SparseBitPlane(rule, device=device)
    if fused_enabled() and fits(packed_shape(*shape, word_axis), device):
        _note_selection("fused_bitplane", rule, shape, device)
        return FusedBitPlane(rule, word_axis, device)
    _note_selection("bitplane", rule, shape, device)
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
        _note_selection("roll_stencil", rule, shape, device)
        return None
    if resolve_device(device).type == "cuda":
        from .pallas_stencil import pallas_bit_step_n_fn

        _note_selection("pallas_bit_step", rule, shape, device)
        return pallas_bit_step_n_fn(word_axis=word_axis, rule=rule, device=device)
    from .bitpack import packed_step_n_fn

    _note_selection("packed_xla_step", rule, shape, device)
    return packed_step_n_fn(word_axis, rule=rule, device=device)


def auto_batch_plane(rule, shape: tuple[int, int], device):
    """The batched data plane (ops/batched.py interface) for this
    per-universe rule, geometry and device: the bitboard batch for a
    32-divisible axis, the roll-stencil byte batch for every other
    geometry. Always returns a plane."""
    from .batched import BatchBitPlane, BatchBytePlane

    word_axis = choose_word_axis(shape)
    if word_axis is None:
        _note_selection("batch_roll_stencil", rule, shape, device)
        return BatchBytePlane(rule, device)
    _note_selection("batch_bitplane", rule, shape, device)
    return BatchBitPlane(rule, word_axis, device)
