"""Fused stepping: K turns per kernel launch, and a chunk's turns with its
alive reduction.

**The fused-K ladder.** ``fused_step_n`` (byte boards),
``fused_bit_step_n`` (bitboards) and ``fused_bit_step_n_batch`` (batches
of bitboards) run n turns as ``full`` launches of K turns plus one launch
per set bit of ``n % K`` (``_ladder``), K quantised to a power of two of
at most ``FUSED_MAX_K`` (``quantise_k``), as the JAX package's
``ops/fused.py`` does. Every ladder issues exactly ``full + len(rem_ks)``
kernel launches of the sizes ``_ladder`` gives, and each wrapper call it
makes is one launch (one plain call on the CPU). The kernels take n at run
time, so the JAX package's compile-cache reason for the ladder is gone;
the ladder stays so that the same call makes the same launches in both
packages. Routing is by shape; nothing catches a failed launch:

* ``fused_step_n``: the whole-board byte kernel under its gate
  (ops/byte_board.py, K5), else the byte tiles (ops/byte_tiled.py, K6).
  K5's gate is the port's own (``byte_board.fits``: the board on chip in
  one thread block cluster, up to the measured size where the byte tiles
  overtake it, 192^2), so 512^2 takes the byte tiles here where the JAX
  package takes K5. A whole ladder is one call of the kernel's ``step_sizes``,
  which allocates its two scratch boards and takes the device and the
  stream once for all the rungs. A CPU board the tiles cannot take
  (``can_tile_byte``) gets the roll stencil, as the JAX package's does; on
  the card the byte tiles refuse it, so nothing there runs in torch ops;
* ``fused_bit_step_n``: the whole-board kernel under its gate (K1), else
  the tiled kernel with K turns per launch (K3/K4), which takes any shape.
  The tiled kernel's tile is fixed (ops/tiled.py::TILE): the JAX
  package's ``interpret``, ``block_rows`` and ``block_cols`` are taken and
  ignored, and ``force_tiles`` sends a board under the gate to the tiles;
* ``fused_bit_step_n_batch``: the batched kernel under its per-universe
  gate (K2), else the tiled kernel universe by universe.

**The resident worker's strip batch.** ``fused_strip_steps`` runs a
worker's K-turn StripStep batch (rpc/worker.py) as launches of the strip
kernel (ops/strip_steps.py, csrc/strip_steps.cu): one RPC, one copy of the
padded block to the device, K turns, the strip, its per-turn counts and
the attestation bands back.

**The fused step+count plane.** Under the whole-board gate a chunk's turns
and its alive counts come from ONE launch of the whole-board kernel (its
``counted`` form, the counterpart of the JAX package's
``_fused_bit_counted_compiled``). Past the gate the board steps on the
tiled kernel and the row popcounts are torch ops, as the JAX package
leaves them to XLA there (``_counted_fallback``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..obs import instruments as _ins
from . import batch_board, byte_board, byte_tiled, strip_steps, tiled, whole_board
from .bitpack import row_popcounts
from .byte_tiled import can_tile as can_tile_byte
from .plane import BitPlane
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK, as_board
from .stencil import step_n as stencil_step_n

#: the largest K of a ladder: the tiled bitboard kernel's halo depth
#: (ops/tiled.py::MAX_TURNS), kept for every tier so one quantiser serves
#: them all, as in the JAX package. A power of two.
FUSED_MAX_K = 8
FUSED_K_DEFAULT = 8


def fused_enabled() -> bool:
    """The ``GOL_FUSED`` routing knob (ops/auto.py): ``on``/``auto``
    (default) route bitboards under the whole-board gate to the fused
    plane, ``off`` keeps them on ``BitPlane``."""
    return os.environ.get("GOL_FUSED", "auto").lower() != "off"


def quantise_k(k: int) -> int:
    """The largest power of two <= min(k, FUSED_MAX_K), and at least 1."""
    k = max(1, min(int(k), FUSED_MAX_K))
    return 1 << (k.bit_length() - 1)


def _ladder(n: int, k: int) -> tuple[int, tuple[int, ...]]:
    """``n`` turns as ``full`` launches of K plus a power-of-two remainder
    ladder, one launch per set bit of ``n % k``."""
    full, rem = divmod(n, k)
    rem_ks = tuple(1 << b for b in range(k.bit_length()) if rem >> b & 1)
    return full, rem_ks


def _ladder_sizes(n: int, k: int) -> tuple[int, ...]:
    """The turns of each launch of the ladder of n, k, in order."""
    full, rem_ks = _ladder(n, k)
    return (k,) * full + rem_ks


def _run_ladder(launch, state, n: int, k: int):
    """``launch(state, turns)`` once per launch of the ladder of n, k."""
    sizes = _ladder_sizes(n, k)
    _meter_ladder(sizes)
    for turns in sizes:
        state = launch(state, turns)
    return state


def _meter_ladder(sizes) -> None:
    """The ladder meters: one launch a rung, each observing its turns (the
    full-K rungs in one observation of their count)."""
    _ins.FUSED_LAUNCHES_TOTAL.inc(len(sizes))
    for turns in sorted(set(sizes)):
        _ins.FUSED_TURNS_PER_LAUNCH.observe_n(float(turns), sizes.count(turns))


def _meter_single(n: int) -> None:
    """One launch covering all ``n`` turns (the step+count launches and
    the plain fallbacks: still one fused dispatch, K == n)."""
    _ins.FUSED_LAUNCHES_TOTAL.inc()
    _ins.FUSED_TURNS_PER_LAUNCH.observe(float(n))


def _resolve(rule, birth_mask, survive_mask) -> tuple[int, int]:
    if rule is not None:
        return rule.birth_mask, rule.survive_mask
    return (
        CONWAY_BIRTH_MASK if birth_mask is None else birth_mask,
        CONWAY_SURVIVE_MASK if survive_mask is None else survive_mask,
    )


def fused_step_n(
    board,
    n: int,
    *,
    k: Optional[int] = None,
    rule=None,
    birth_mask: Optional[int] = None,
    survive_mask: Optional[int] = None,
    device=None,
):
    """n turns of a uint8 board, K turns per launch: the whole-board byte
    kernel's ladder under its gate, else the byte tiles' ladder (a CPU
    board they cannot take gets the roll stencil). An engine step function
    ``(board, n) -> board`` (``EngineConfig(step_n_fn=fused_step_n)``);
    equal to the serial stencil. A numpy board goes to ``device``, the card
    unless the caller names another; a tensor stays where it is."""
    n = int(n)
    board = as_board(board, device)
    if n <= 0:
        return board
    birth, survive = _resolve(rule, birth_mask, survive_mask)
    kq = quantise_k(FUSED_K_DEFAULT if k is None else k)
    shape = tuple(board.shape)
    sizes = _ladder_sizes(n, kq)
    if byte_board.fits(shape, board.device):
        _meter_ladder(sizes)
        return byte_board.step_sizes(board, sizes, birth, survive, site="pallas.fused_byte")
    # on the card a board the tiles cannot take raises in byte_tiled.step_sizes
    if can_tile_byte(shape) or board.device.type != "cpu":
        _meter_ladder(sizes)
        return byte_tiled.step_sizes(board, sizes, birth, survive)
    _meter_single(n)
    return stencil_step_n(board, n, birth_mask=birth, survive_mask=survive)


def fused_bit_step_n(
    packed,
    n: int,
    *,
    k: Optional[int] = None,
    word_axis: int = 0,
    rule=None,
    birth_mask: Optional[int] = None,
    survive_mask: Optional[int] = None,
    interpret: Optional[bool] = None,
    block_rows: Optional[int] = None,
    block_cols: Optional[int] = None,
    force_tiles: bool = False,
):
    """n turns of an int32 bitboard, K turns per launch: the whole-board
    kernel's ladder under its gate, else (or with ``force_tiles``) the
    tiled kernel's. Equal to ``bit_step_n``."""
    # the JAX package's keywords; the tiled kernel's tile is fixed at
    # compile time and the kernels have no interpret mode
    del interpret, block_rows, block_cols
    n = int(n)
    if n <= 0:
        return packed
    birth, survive = _resolve(rule, birth_mask, survive_mask)
    kq = quantise_k(FUSED_K_DEFAULT if k is None else k)
    if not force_tiles and whole_board.fits(tuple(packed.shape), packed.device):
        return _run_ladder(
            lambda p, t: whole_board.step_n(p, t, word_axis, birth, survive,
                                            site="pallas.fused_bit"),
            packed, n, kq,
        )
    return _run_ladder(
        lambda p, t: tiled.step_n(p, t, word_axis, birth, survive, turns_per_launch=t,
                                  site="pallas.fused_tiled"),
        packed, n, kq,
    )


def fused_bit_step_n_batch(
    packed,
    n: int,
    *,
    k: Optional[int] = None,
    word_axis: int = 0,
    rule=None,
    birth_mask: Optional[int] = None,
    survive_mask: Optional[int] = None,
):
    """n turns of every universe of an int32 batch ``[B, rows, cols]``, K
    turns per launch: the batched kernel's ladder under its per-universe
    gate (one launch per rung for the whole batch), else the tiled
    kernel's, universe by universe."""
    n = int(n)
    if n <= 0:
        return packed
    birth, survive = _resolve(rule, birth_mask, survive_mask)
    kq = quantise_k(FUSED_K_DEFAULT if k is None else k)
    if batch_board.fits(tuple(packed.shape), packed.device):
        return _run_ladder(
            lambda p, t: batch_board.step_n(p, t, word_axis, birth, survive, counted=False,
                                            site="pallas.fused_bit_batch"),
            packed, n, kq,
        )

    def tiled_each(p, t):
        return torch.stack([
            tiled.step_n(board, t, word_axis, birth, survive, turns_per_launch=t,
                         site="pallas.fused_tiled")
            for board in p
        ])

    return _run_ladder(tiled_each, packed, n, kq)


def fold_counts(counts) -> int:
    """Host int64 fold of a count vector (per-row int32 partials, int64
    total). ``.cpu()`` orders after the kernel that wrote ``counts`` on
    the default stream."""
    return int(counts.cpu().sum(dtype=torch.int64))


class FusedBitPlane(BitPlane):
    """A ``BitPlane`` plus the fused step+count protocol the engine's
    chunk driver consumes:

        step_n_counted(state, n) -> (state, counts)

    ``counts`` is an ``int32[rows]`` device vector whose int64 host sum
    (``fold_counts``) is the alive count of the returned state."""

    def step_n_counted(self, state, n: int):
        n = int(n)
        if n > 0:
            _meter_single(n)
        if whole_board.fits(tuple(state.shape), state.device):
            return whole_board.step_n(
                state, n, self.word_axis,
                self.rule.birth_mask, self.rule.survive_mask, counted=True,
                site="pallas.fused_bit",
            )
        out = self.step_n(state, n)
        return out, row_popcounts(out)


def fused_strip_steps(padded, k: int, strip_rows: int, *, attest: bool = False, device=None):
    """K turns of a resident strip from its depth-K halo block, the JAX
    package's ``fused_strip_steps``: ``padded`` is the (strip_rows + 2K,
    w) uint8 numpy block ([top K; strip; bottom K]); returns ``(strip,
    counts, bands)``, the K-turns-later strip, ``counts[i]`` the strip's
    alive count after step i+1 as ints, and, with ``attest``, each step's
    (top, bottom) attestation bands (an empty list without), all numpy, so
    the caller's digest fold is byte-identical to the numpy path's. The
    block goes to ``device``, the card unless the caller names another; on
    the card the strip kernel runs (ops/strip_steps.py), on the CPU its
    plain version."""
    k, h = int(k), int(strip_rows)
    block = torch.from_numpy(np.ascontiguousarray(padded, np.uint8)).to(resolve_device(device))
    out = strip_steps.strip_steps(block, k, h, attest=attest)
    _meter_single(k)
    bands = []
    if attest:
        bands = strip_steps.split_bands(out.bands.cpu().numpy(), k, block.shape[1])
    return out.strip.cpu().numpy(), [int(c) for c in out.counts.cpu().tolist()], bands
