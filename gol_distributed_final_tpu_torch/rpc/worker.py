"""The worker process — the GameOfLifeOperations service (worker/worker.go:72-112).

The port of the JAX package's ``rpc/worker.py``. It serves ``Update``
(one row strip of the next board, given the strip and its two wrap-around
halo rows, or the whole board and the strip's bounds: the broker's
``haloed`` and ``full`` wires), ``WorkerQuit``, and the resident-strip
verbs of ``-wire resident``: ``StripStart`` seeds a strip (or a 2-D tile
of ``-grid``) that stays here across turns, ``StripStep`` advances it K
turns from depth-K halos and replies with its fresh boundary bands, its
per-turn alive counts, its dirty-tile bitmap and, with integrity on, the
attestation digests, and ``StripFetch`` reads it back (whole, or the
tiles that changed since the broker's last copy).

Where a 1-D strip session lives. ``StripStart`` seeds the strip on the
worker's own device (the card, or the CPU with ``-device cpu``) when
``GOL_WORKER_FUSED`` is ``on``, or ``auto`` (the default) and the strip
has at least ``FUSED_STRIP_MIN_CELLS`` cells: a ``_ResidentStrip``, whose
every batch is one call of the strip kernel W (ops/strip_steps.py,
csrc/strip_steps.cu; its plain torch version on the CPU). The strip never
crosses PCIe on a step: the halos go up, and the edges, counts, dirty grid,
digest sums and bands come down, with one synchronisation a batch. There
is no live-window scan and no dead-band skip on it, a routing difference
with equal results (ROADMAP F8). Otherwise, and for every ``-grid`` tile,
the strip stays a numpy array on the reference-shaped CPU paths, copied:
the per-turn strip stencil (``_strip_step``), the dense, dead-band-skip
and fused strip batches (``strip_step_batch``, routed by
``GOL_WORKER_FUSED=auto|on|off`` as in the reference; fused is one call
of ``ops/fused.fused_strip_steps``) and the tile batches. Nothing catches
a kernel failure to step the strip with numpy instead.

Run it with ``python -m gol_distributed_final_tpu_torch.rpc.worker -port
P [-device cuda|cpu] [-integrity on|off]``. The observability flags and
the ``Status`` verb are not ported yet: the flags are refused by name, and
a broker's readmission probe takes the "unknown method" reply to Status as
proof of life.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from . import faults as _faults
from . import integrity as _integrity
from .protocol import Methods, Request, Response
from .server import RpcServer

#: dead-band skip engages when the live window (the frontier's K-deep
#: dependency cone) covers at most this fraction of the padded block's
#: rows — below it the saved rows dominate the extent scan's cost
_SKIP_MAX_WINDOW_FRAC = 0.75

#: under GOL_WORKER_FUSED=auto, a strip of at least this many cells is
#: seeded on the worker's device (``_ResidentStrip``), and a numpy strip
#: batch this large takes the fused path (ops/fused.fused_strip_steps).
#: Measured on an H100 (chip_smoke.py's "fused gate" table, PERF.md): at
#: K = 8 a batch through the strip kernel, copies and digests included,
#: beats the numpy loop from the smallest strip timed, 2^10 cells; the
#: reference's 2^20 was a TPU figure
FUSED_STRIP_MIN_CELLS = 1 << 10


def _worker_fused_mode() -> str:
    """``GOL_WORKER_FUSED``: ``auto`` (default — fused for strips past
    FUSED_STRIP_MIN_CELLS, dead-band skip preferred when it applies to a
    numpy strip), ``on`` (EVERY batch through the fused path — overrides
    the skip), ``off`` (never the fused path: numpy strips only)."""
    return os.environ.get("GOL_WORKER_FUSED", "auto").lower()


def _strip_step(padded: np.ndarray) -> np.ndarray:
    """(h+2, w) padded strip -> (h, w) next strip, columns wrapping locally.

    Deliberately a vectorized numpy kernel: the reference-shaped CPU worker
    (its kernel is a plain Go loop, worker/worker.go:15-70, Conway
    hard-coded :41-46), called once per strip per turn."""
    ext = np.concatenate([padded[:, -1:], padded, padded[:, :1]], axis=1)
    b = (ext != 0).astype(np.uint8)
    counts = (
        b[:-2, :-2].astype(np.int32) + b[:-2, 1:-1] + b[:-2, 2:]
        + b[1:-1, :-2] + b[1:-1, 2:]
        + b[2:, :-2] + b[2:, 1:-1] + b[2:, 2:]
    )
    alive = b[1:-1, 1:-1] == 1
    next_alive = np.where(alive, (counts == 2) | (counts == 3), counts == 3)
    return np.where(next_alive, 255, 0).astype(np.uint8)


def compute_strip(world: np.ndarray, start_y: int, end_y: int) -> np.ndarray:
    """Next state of rows [start_y, end_y) given the full board —
    the calculateNextState contract (worker/worker.go:15)."""
    h = world.shape[0]
    rows = np.arange(start_y - 1, end_y + 1) % h
    padded = world[rows]
    return _strip_step(padded)


def compute_strip_haloed(padded: np.ndarray) -> np.ndarray:
    """Next state of a strip sent WITH its halo rows (rows 0 and -1)."""
    return _strip_step(padded)


def strip_step_batch(
    strip: np.ndarray,
    top: np.ndarray,
    bottom: np.ndarray,
    k: int,
    attest: bool = False,
    *,
    mode: str = "auto",
    device=None,
):
    """Advance a resident strip K turns from depth-K halo rows, in
    shrinking form: the (h + 2K)-row padded block loses one row per side
    per step, landing exactly on the K-turns-later strip. Returns
    ``(next_strip, per_step_alive_counts)``: the counts are of the STRIP's
    rows only, so summing them across workers gives the whole board's
    count per turn (the AliveCellsCount feed, no gather).

    ``attest=True`` additionally returns two band digests
    ``(..., attest_top, attest_bottom)`` — the halo cross-attestation
    feed (rpc/integrity.py). After step j (1-based) the padded block
    covers rows ``[s-(k-j), e+(k-j))`` of the board at turn ``t+j``; its
    FIRST ``2*(k-j)`` rows are exactly the rows the UPPER neighbour's
    block ends with at the same step. Each side's per-step bands fold into
    ONE rolling state digest per batch, each fold binding the band's
    shape. Worker i's ``attest_top`` must hash-equal worker i-1's
    ``attest_bottom``: the broker cross-checks every batch. The final
    step's band is empty (zero rows — folds only its shape header).

    Three bit-identical execution paths, routed per batch (``mode`` pins
    one for tests; every path yields the same strips, counts, AND band
    digests):

    * ``skip`` — the dead-band skip: when the live rows' K-deep dependency
      cone covers a minority of the block, only that window is stepped —
      rows outside it are provably dead for all K turns (non-B0).
    * ``fused`` — the whole K-turn shrinking batch as one call of
      ops/fused.fused_strip_steps on ``device`` (None: the card), bands
      materialised so the digest fold is byte-identical.
    * ``dense`` — the reference-shaped numpy loop."""
    h = strip.shape[0]
    if k < 1:
        raise ValueError(f"strip batch needs k >= 1, got {k}")
    if top.shape != (k, strip.shape[1]) or bottom.shape != (k, strip.shape[1]):
        raise ValueError(
            f"depth-{k} halos must each be ({k}, {strip.shape[1]}), got "
            f"{top.shape} and {bottom.shape}"
        )
    padded = np.concatenate([top, strip, bottom], axis=0)
    window = None
    if mode == "auto":
        fused = _worker_fused_mode()
        if fused == "on":
            # an explicit operator override: EVERY batch takes the fused
            # path, the dead-band skip included
            mode = "fused"
        else:
            window = _live_window(padded, k)
            if window[1] - window[0] <= _SKIP_MAX_WINDOW_FRAC * padded.shape[0]:
                mode = "skip"
            elif fused == "auto" and strip.size >= FUSED_STRIP_MIN_CELLS:
                mode = "fused"
            else:
                mode = "dense"
    if mode == "skip":
        if window is None:  # pinned mode: the routing scan never ran
            window = _live_window(padded, k)
        return _strip_batch_skip(padded, k, h, *window, attest)
    if mode == "fused":
        return _strip_batch_fused(padded, k, h, attest, device)
    if mode != "dense":
        raise ValueError(f"unknown strip batch mode {mode!r}")
    counts = []
    at = ab = _integrity.state_new()
    for i in range(k):
        padded = _strip_step(padded)  # 2 fewer rows per step
        off = k - (i + 1)
        counts.append(int(np.count_nonzero(padded[off : off + h])))
        if attest:
            # fold the bands now: keeping every step's block until the
            # batch ends would hold ~K full strips live
            band = 2 * off
            at = _integrity.state_add(at, padded[:band])
            ab = _integrity.state_add(ab, padded[padded.shape[0] - band:])
    if attest:
        return (
            padded, counts,
            _integrity.state_hex(at), _integrity.state_hex(ab),
        )
    return padded, counts


def _live_window(padded: np.ndarray, k: int) -> tuple[int, int]:
    """The frontier's K-deep dependency cone as a row window [lo, hi):
    every row outside it is dead at turn t AND at distance > K from any
    live row, so it stays dead through all K steps (Conway is non-B0).
    (0, 0) when the whole block is dead."""
    live = np.flatnonzero(padded.any(axis=1))
    if live.size == 0:
        return 0, 0
    return (
        max(0, int(live[0]) - k),
        min(padded.shape[0], int(live[-1]) + 1 + k),
    )


def _strip_batch_skip(padded, k: int, h: int, a_lo: int, a_hi: int, attest):
    """The dead-band skip: step ONLY the live window, reconstruct every
    full-block artifact (strip, counts, attestation bands) from it.

    Rows outside [a_lo, a_hi) are dead for all K steps, so stepping the
    window between zero pads is exact there; where the window touches the
    block's EDGE, the zero pad stands in for halo data the dense path
    also discards — the resulting garbage cone reaches at most row j-1
    by step j, strictly outside both the strip rows [K, K+h) and that
    step's attestation bands (which start at row j)."""
    H, w = padded.shape
    zero = np.zeros((1, w), np.uint8)
    active = np.array(padded[a_lo:a_hi], np.uint8)

    def materialize(lo: int, hi: int) -> np.ndarray:
        out = np.zeros((max(0, hi - lo), w), np.uint8)
        o_lo, o_hi = max(lo, a_lo), min(hi, a_hi)
        if o_hi > o_lo:
            out[o_lo - lo : o_hi - lo] = active[o_lo - a_lo : o_hi - a_lo]
        return out

    counts = []
    at = ab = _integrity.state_new()
    for i in range(k):
        if active.shape[0]:
            # constant-size: the zero pads replace the rows the dense
            # shrinking form consumes (provably dead, or discarded cone)
            active = _strip_step(np.concatenate([zero, active, zero], axis=0))
        s_lo, s_hi = max(k, a_lo), min(k + h, a_hi)
        counts.append(
            int(np.count_nonzero(active[s_lo - a_lo : s_hi - a_lo]))
            if s_hi > s_lo
            else 0
        )
        if attest:
            band = 2 * (k - (i + 1))
            step = i + 1
            at = _integrity.state_add(at, materialize(step, step + band))
            ab = _integrity.state_add(
                ab, materialize(H - step - band, H - step)
            )
    final = materialize(k, k + h)
    if attest:
        return (
            final, counts,
            _integrity.state_hex(at), _integrity.state_hex(ab),
        )
    return final, counts


def _strip_batch_fused(padded, k: int, h: int, attest, device):
    """The fused path: ops/fused.fused_strip_steps runs the whole
    shrinking K-turn batch on ``device``; the per-step bands come back
    materialised so the rolling digest fold is byte-identical to the
    dense path's (the broker's cross-attestation never sees a routing
    difference)."""
    from ..ops.fused import fused_strip_steps

    strip, counts, bands = fused_strip_steps(padded, k, h, attest=attest, device=device)
    if attest:
        at = ab = _integrity.state_new()
        for band_top, band_bot in bands:
            at = _integrity.state_add(at, band_top)
            ab = _integrity.state_add(ab, band_bot)
        return (
            strip, counts,
            _integrity.state_hex(at), _integrity.state_hex(ab),
        )
    return strip, counts


#: Conway's masks (bit c set = the rule births/survives on c live
#: neighbours), as ops/stencil.py has them
_CONWAY_BIRTH_MASK = 1 << 3
_CONWAY_SURVIVE_MASK = (1 << 2) | (1 << 3)

#: the 2-D attestation digest keys, fixed order — four edges plus the
#: four diagonal corner bands a K-step dependency cone shares with the
#: diagonal neighbours (see tile_step_batch)
_TILE_ATTEST_KEYS = (
    "attest_top", "attest_bottom", "attest_left", "attest_right",
    "attest_tl", "attest_tr", "attest_bl", "attest_br",
)


def _tile_step(
    padded: np.ndarray,
    birth_mask: int = _CONWAY_BIRTH_MASK,
    survive_mask: int = _CONWAY_SURVIVE_MASK,
) -> np.ndarray:
    """(h, w) padded block -> (h-2, w-2) next interior, NO wrap on either
    axis — the 2-D tile kernel (``_strip_step`` minus the local column
    wrap: a tile's column neighbours are other workers' tiles, so its
    left/right context arrives as halo data like its rows). Masked rules
    serve the oracle tests; the resident wire itself stays Conway-only
    (the broker refuses other rules on it)."""
    b = (padded != 0).astype(np.uint8)
    counts = (
        b[:-2, :-2].astype(np.int32) + b[:-2, 1:-1] + b[:-2, 2:]
        + b[1:-1, :-2] + b[1:-1, 2:]
        + b[2:, :-2] + b[2:, 1:-1] + b[2:, 2:]
    )
    alive = b[1:-1, 1:-1] == 1
    if birth_mask == _CONWAY_BIRTH_MASK and survive_mask == _CONWAY_SURVIVE_MASK:
        next_alive = np.where(alive, (counts == 2) | (counts == 3), counts == 3)
    else:
        lut = np.array(
            [[(survive_mask if a else birth_mask) >> c & 1 for c in range(9)]
             for a in (0, 1)],
            bool,
        )
        next_alive = lut[alive.astype(np.intp), counts]
    return np.where(next_alive, 255, 0).astype(np.uint8)


def _packed_len(shape) -> int:
    """Bytes one bit-packed cell block of this shape occupies on the
    tile halo wire."""
    return (int(shape[0]) * int(shape[1]) + 7) // 8


def pack_tile_blocks(blocks) -> np.ndarray:
    """Bit-pack 0/255 cell blocks (1 bit per cell) into one flat uint8
    buffer — the tile halo wire format. Each block packs separately
    (byte-aligned), so section offsets derive from shapes alone
    (``tile_halo_shapes``/``tile_edge_shapes``). Lossless: halo cells only
    feed the nonzero-is-alive kernel, and every block a worker computes
    is already 0/255."""
    if not blocks:
        return np.zeros(0, np.uint8)
    return np.concatenate(
        [np.packbits((np.asarray(b, np.uint8) != 0).ravel()) for b in blocks]
    )


def unpack_tile_blocks(buf, shapes) -> list:
    """Inverse of ``pack_tile_blocks`` given the section shapes. Strict:
    a short buffer or trailing bytes is a protocol violation (raises),
    never a silent truncation."""
    buf = np.asarray(buf, np.uint8).ravel()
    out, off = [], 0
    for sh in shapes:
        n = int(sh[0]) * int(sh[1])
        ln = _packed_len(sh)
        seg = buf[off : off + ln]
        if seg.size != ln:
            raise ValueError(
                f"tile buffer truncated: section {sh} needs {ln} bytes, "
                f"{buf.size - off} left"
            )
        cells = np.unpackbits(seg, count=n).astype(np.uint8) * np.uint8(255)
        out.append(cells.reshape((int(sh[0]), int(sh[1]))))
        off += ln
    if off != buf.size:
        raise ValueError(f"tile buffer has {buf.size - off} trailing bytes")
    return out


def tile_halo_shapes(k: int, th: int, tw: int) -> list:
    """Downlink (StripStep ``world``) section shapes for a depth-K tile
    batch, fixed order: top, bottom (k x tile_w row bands), left, right
    (tile_h x k column bands), then the four K x K corner blocks
    (tl, tr, bl, br) — the full dependency cone of K steps."""
    return [
        (k, tw), (k, tw), (th, k), (th, k),
        (k, k), (k, k), (k, k), (k, k),
    ]


def tile_edge_shapes(k: int, th: int, tw: int) -> list:
    """Uplink (reply ``edges``) section shapes: the stepped tile's fresh
    top, bottom, left, right bands. No corners — the broker derives each
    diagonal corner block from the diagonal neighbour's row bands."""
    return [(k, tw), (k, tw), (th, k), (th, k)]


def tile_step_batch(
    tile: np.ndarray,
    halos,
    k: int,
    attest: bool = False,
    *,
    mode: str = "auto",
    rule=None,
):
    """Advance a resident 2-D TILE K turns from its four depth-K edge
    halos plus four K x K corner blocks — ``strip_step_batch``'s
    checkerboard generalisation, shrinking one cell per SIDE per step.
    ``halos`` is the 8-tuple ``(top, bottom, left, right, tl, tr, bl,
    br)`` in ``tile_halo_shapes`` order. Returns ``(next_tile,
    per_step_alive_counts)`` — counts cover the TILE's cells only.

    ``attest=True`` additionally returns a dict of EIGHT rolling band
    digests (``_TILE_ATTEST_KEYS``): after step j (off = K - j) the
    top/bottom digests fold the block's first/last ``2*off`` rows over
    its full current width, left/right its first/last ``2*off`` columns
    over its full height, and the four corner digests the ``2*off x
    2*off`` corner sub-blocks. The broker cross-checks
    ``(r,c).attest_top == (r-1,c).attest_bottom``, ``.attest_left ==
    (r,c-1).attest_right``, ``.attest_tl == (r-1,c-1).attest_br`` and
    ``.attest_tr == (r-1,c+1).attest_bl`` (toroidal indices).

    Routing mirrors the strip batch minus the fused path: ``skip`` steps
    only the live frontier's K-deep 2-D bounding window between zero
    pads, ``dense`` is the plain loop. There is no fused tile path, as in
    the reference: the strip kernel wraps columns locally, which a tile
    must not, so GOL_WORKER_FUSED=on leaves tile batches on these paths.
    ``rule`` is an optional LifeRule-shaped object (birth_mask/
    survive_mask) for oracle tests; the wire never sets it."""
    th, tw = tile.shape
    if k < 1:
        raise ValueError(f"tile batch needs k >= 1, got {k}")
    if k > min(th, tw):
        raise ValueError(
            f"batch depth {k} exceeds tile minimum dimension {min(th, tw)}"
        )
    top, bottom, left, right, tl, tr, bl, br = halos
    for name, arr, want in (
        ("top", top, (k, tw)), ("bottom", bottom, (k, tw)),
        ("left", left, (th, k)), ("right", right, (th, k)),
        ("tl", tl, (k, k)), ("tr", tr, (k, k)),
        ("bl", bl, (k, k)), ("br", br, (k, k)),
    ):
        if np.asarray(arr).shape != want:
            raise ValueError(
                f"depth-{k} tile halo {name} must be {want}, got "
                f"{np.asarray(arr).shape}"
            )
    birth = rule.birth_mask if rule is not None else _CONWAY_BIRTH_MASK
    survive = rule.survive_mask if rule is not None else _CONWAY_SURVIVE_MASK
    block = np.block([
        [np.asarray(tl, np.uint8), np.asarray(top, np.uint8), np.asarray(tr, np.uint8)],
        [np.asarray(left, np.uint8), np.asarray(tile, np.uint8), np.asarray(right, np.uint8)],
        [np.asarray(bl, np.uint8), np.asarray(bottom, np.uint8), np.asarray(br, np.uint8)],
    ])
    window = None
    if mode == "auto":
        if birth & 1:
            mode = "dense"  # B0: dead cells birth — no dead band exists
        else:
            window = _live_window_2d(block, k)
            area = (window[1] - window[0]) * (window[3] - window[2])
            if area <= _SKIP_MAX_WINDOW_FRAC * block.size:
                mode = "skip"
            else:
                mode = "dense"
    if mode == "fused":
        raise ValueError(
            "tile batches have no fused path: ops/fused's strip kernel "
            "wraps columns locally (a tile's column context is halo "
            "data); use auto/dense/skip"
        )
    if mode == "skip":
        if birth & 1:
            raise ValueError("the dead-band skip is unsound under a B0 rule")
        if window is None:  # pinned mode: the routing scan never ran
            window = _live_window_2d(block, k)
        return _tile_batch_skip(block, k, th, tw, window, attest, birth, survive)
    if mode != "dense":
        raise ValueError(f"unknown tile batch mode {mode!r}")
    counts = []
    states = {key: _integrity.state_new() for key in _TILE_ATTEST_KEYS}
    for i in range(k):
        block = _tile_step(block, birth, survive)  # 2 fewer rows AND cols
        off = k - (i + 1)
        counts.append(int(np.count_nonzero(block[off : off + th, off : off + tw])))
        if attest:
            _fold_tile_bands(states, block, 2 * off)
    if attest:
        return (
            block, counts,
            {key: _integrity.state_hex(st) for key, st in states.items()},
        )
    return block, counts


def _fold_tile_bands(states, block, band: int):
    """Fold one step's eight attestation bands into the rolling digests
    (band = 2*(K-j) cells per side; empty at the final step — the fold
    still binds the shape header, so the step structure is pinned)."""
    H, W = block.shape
    states["attest_top"] = _integrity.state_add(states["attest_top"], block[:band])
    states["attest_bottom"] = _integrity.state_add(
        states["attest_bottom"], block[H - band :]
    )
    states["attest_left"] = _integrity.state_add(
        states["attest_left"], block[:, :band]
    )
    states["attest_right"] = _integrity.state_add(
        states["attest_right"], block[:, W - band :]
    )
    states["attest_tl"] = _integrity.state_add(
        states["attest_tl"], block[:band, :band]
    )
    states["attest_tr"] = _integrity.state_add(
        states["attest_tr"], block[:band, W - band :]
    )
    states["attest_bl"] = _integrity.state_add(
        states["attest_bl"], block[H - band :, :band]
    )
    states["attest_br"] = _integrity.state_add(
        states["attest_br"], block[H - band :, W - band :]
    )


def _live_window_2d(block: np.ndarray, k: int):
    """The live frontier's K-deep dependency cone as a 2-D window
    (r0, r1, c0, c1) — ``_live_window`` per axis. All-zeros when the
    whole block is dead."""
    rows = np.flatnonzero(block.any(axis=1))
    if rows.size == 0:
        return 0, 0, 0, 0
    cols = np.flatnonzero(block.any(axis=0))
    return (
        max(0, int(rows[0]) - k),
        min(block.shape[0], int(rows[-1]) + 1 + k),
        max(0, int(cols[0]) - k),
        min(block.shape[1], int(cols[-1]) + 1 + k),
    )


def _tile_batch_skip(block, k, th, tw, window, attest, birth, survive):
    """The dead-band skip in 2-D: step ONLY the live window between zero
    pads, reconstruct every full-block artifact (tile, counts, all eight
    attestation bands) from it — the strip argument per axis."""
    H, W = block.shape
    r0, r1, c0, c1 = window
    active = np.array(block[r0:r1, c0:c1], np.uint8)

    def materialize(a: int, b: int, c: int, d: int) -> np.ndarray:
        out = np.zeros((max(0, b - a), max(0, d - c)), np.uint8)
        rlo, rhi = max(a, r0), min(b, r1)
        clo, chi = max(c, c0), min(d, c1)
        if rhi > rlo and chi > clo:
            out[rlo - a : rhi - a, clo - c : chi - c] = active[
                rlo - r0 : rhi - r0, clo - c0 : chi - c0
            ]
        return out

    counts = []
    states = {key: _integrity.state_new() for key in _TILE_ATTEST_KEYS}
    for i in range(k):
        if active.size:
            padded = np.zeros((active.shape[0] + 2, active.shape[1] + 2), np.uint8)
            padded[1:-1, 1:-1] = active
            active = _tile_step(padded, birth, survive)
        step = i + 1
        off = k - step
        rlo, rhi = max(k, r0), min(k + th, r1)
        clo, chi = max(k, c0), min(k + tw, c1)
        counts.append(
            int(np.count_nonzero(
                active[rlo - r0 : rhi - r0, clo - c0 : chi - c0]
            ))
            if rhi > rlo and chi > clo
            else 0
        )
        if attest:
            band = 2 * off
            # the shrunk block's bands in original-frame coordinates:
            # at step j the dense block occupies [j, H-j) x [j, W-j)
            shadow = {
                "attest_top": (step, step + band, step, W - step),
                "attest_bottom": (H - step - band, H - step, step, W - step),
                "attest_left": (step, H - step, step, step + band),
                "attest_right": (step, H - step, W - step - band, W - step),
                "attest_tl": (step, step + band, step, step + band),
                "attest_tr": (step, step + band, W - step - band, W - step),
                "attest_bl": (H - step - band, H - step, step, step + band),
                "attest_br": (
                    H - step - band, H - step, W - step - band, W - step,
                ),
            }
            for key, box in shadow.items():
                states[key] = _integrity.state_add(states[key], materialize(*box))
    final = materialize(k, k + th, k, k + tw)
    if attest:
        return (
            final, counts,
            {key: _integrity.state_hex(st) for key, st in states.items()},
        )
    return final, counts


def _device_session(strip: np.ndarray, is_tile: bool) -> bool:
    """Whether StripStart seeds this strip on the worker's device: a 1-D
    strip, not a tile, under GOL_WORKER_FUSED ``on``, or ``auto`` past
    FUSED_STRIP_MIN_CELLS; the fused batch's routing minus the skip."""
    mode = _worker_fused_mode()
    return not is_tile and (
        mode == "on" or (mode == "auto" and strip.size >= FUSED_STRIP_MIN_CELLS)
    )


class _BatchIO:
    """One device buffer for a batch's halos and W's outputs, laid out
    ``[halos | sums, counts, grid][edges | bands]`` with each part
    16-byte aligned, and on the card its two pinned host mirrors: the
    first part goes up each batch (its zero tail resets the sums, counts
    and grid W adds into) and everything after the halos comes down, so
    a batch crosses PCIe in one copy each way."""

    def __init__(self, h: int, w: int, k: int, attest: bool, device):
        from ..ops.strip_steps import StripBatch, output_specs

        def r16(n):
            return -(-n // 16) * 16

        specs = output_specs(h, w, k, attest)
        grid = specs["dirty"][0]
        self.halo_bytes = 2 * k * w
        o_sums = r16(self.halo_bytes)
        o_counts = o_sums + 32
        o_dirty = o_counts + 4 * k
        o_edges = r16(o_dirty + grid[0] * grid[1])
        o_bands = r16(o_edges + 2 * k * w)
        end = o_bands + (specs["bands"][0][0] if attest else 0)
        self.zero_end, self.down_from = o_edges, o_sums
        self.dev = torch.empty(end, dtype=torch.uint8, device=device)

        def views(buf, base):
            def at(a, b):
                return buf[a - base:b - base]

            return StripBatch(
                None,
                at(o_counts, o_dirty).view(torch.int32),
                at(o_bands, end) if attest else None,
                at(o_dirty, o_dirty + grid[0] * grid[1]).view(torch.bool).view(grid),
                at(o_sums, o_counts).view(torch.int64) if attest else None,
                at(o_edges, o_edges + 2 * k * w).view(2 * k, w),
            )

        self.halos = self.dev[:self.halo_bytes].view(2 * k, w)
        self.into = views(self.dev, 0)
        self.up = self.down = None
        self.host = self.into
        if self.dev.is_cuda:
            self.up = torch.zeros(o_edges, dtype=torch.uint8, pin_memory=True)
            self.down = torch.empty(end - o_sums, dtype=torch.uint8, pin_memory=True)
            self.host = views(self.down, o_sums)


class _ResidentStrip:
    """A 1-D strip session's strip on the worker's device, stepped by the
    strip kernel W (ops/strip_steps.py) batch after batch.

    Two buffers ping-pong: a batch reads the current one and W writes the
    new strip into the other. On the card every copy and launch of the
    session runs on its own stream: the request's halos go up with the
    zeroes W's sums, counts and grid start from, W reads halos and strip
    through separate pointers, and its edges, counts, grid, sums and (with
    attestation) bands come down, one copy each way and one
    synchronisation a batch (``_BatchIO``). ``bytes_up``, ``bytes_down``
    and ``bytes_fetched`` count what crossed PCIe."""

    def __init__(self, strip: np.ndarray, device):
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        with self.on_stream():
            first = torch.from_numpy(strip).to(self.device)
            self._buffers = [first, torch.empty_like(first)]
        self._current = 0
        self._io: dict = {}
        self.bytes_up = self.bytes_down = self.bytes_fetched = 0

    @property
    def strip(self) -> torch.Tensor:
        return self._buffers[self._current]

    def on_stream(self):
        """The session's stream as the current one (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def step(self, halos: np.ndarray, k: int, attest: bool):
        """K turns from the (2K, w) halos ``[top K; bottom K]``:
        ``(edges, counts, dirty, sums, bands)`` on the host, ``sums`` the
        four adler32 sums (``StripBatch.sums``) and ``bands`` the flat band
        output (valid until the next step), both None without ``attest``.
        Call it inside ``on_stream``."""
        from ..ops import strip_steps

        h, w = self.strip.shape
        io = self._io.get((k, attest))
        if io is None:
            io = self._io[(k, attest)] = _BatchIO(h, w, k, attest, self.device)
        if io.up is None:
            np.copyto(io.halos.numpy(), halos)
            io.dev[io.down_from:io.zero_end].zero_()
        else:
            np.copyto(io.up[:io.halo_bytes].numpy().reshape(2 * k, w), halos)
            io.dev[:io.zero_end].copy_(io.up, non_blocking=True)
            self.bytes_up += io.zero_end
        strip_steps.strip_batch(io.halos[:k], self.strip, io.halos[k:], k, attest,
                                into=io.into._replace(strip=self._buffers[1 - self._current]))
        self._current = 1 - self._current
        if io.down is not None:
            io.down.copy_(io.dev[io.down_from:], non_blocking=True)
            self.stream.synchronize()
            self.bytes_down += io.down.numel()
        out = io.host
        return (
            out.edges.numpy().copy(),
            out.counts.tolist(),
            out.dirty.numpy().copy(),
            None if out.sums is None else out.sums.tolist(),
            None if out.bands is None else out.bands.numpy(),
        )

    def fetch(self) -> np.ndarray:
        """A host copy of the strip."""
        with self.on_stream():
            out = self.strip.cpu() if self.stream is not None else self.strip.clone()
        if self.stream is not None:
            self.bytes_fetched += out.numel()
        return out.numpy()


class WorkerService:
    """The worker's verbs. ``device`` is where a 1-D strip session at
    least FUSED_STRIP_MIN_CELLS large lives and steps (the card, or the CPU
    for ``-device cpu``), and where a fused numpy batch runs; smaller
    strips, ``GOL_WORKER_FUSED=off`` and tiles stay in host memory, as in
    the reference."""

    def __init__(self, server: RpcServer, device=None):
        self._server = server
        self.device = device
        self.quit_event = threading.Event()
        # the resident-strip session (-wire resident): ONE strip per worker
        # process, held across turns, moved as one unit under this lock.
        # StripStart replaces it wholesale, so a reseed after loss recovery
        # can never leave a stale session behind.
        self._strip_lock = threading.Lock()
        # the strip: a numpy array, or the current buffer of _resident, a
        # session on the device
        self._strip = None
        self._resident: _ResidentStrip | None = None
        self._strip_turn = 0
        self._strip_index = 0
        # dirty-tile accumulator (ops/sparse.py wire tiles): which tiles
        # changed since the broker last held a full copy of this strip,
        # anchored by _strip_clean_turn (the turn it was last reset at); a
        # delta fetch is answered only when the broker's base turn matches
        # the anchor, anything else degrades to a full frame
        self._strip_dirty: np.ndarray | None = None
        self._strip_clean_turn = 0
        # True when the resident block is a 2-D TILE (-grid): StripStep
        # then takes bit-packed four-edge-plus-corner halos instead of the
        # strip plane's 2K raw rows
        self._strip_is_tile = False

    def update(self, req: Request) -> Response:
        # chaos hook (rpc/faults.py): GOL_FAULT_POINTS can wedge, crash, or
        # fail this worker's compute deterministically
        t0 = time.monotonic()
        _faults.fault_point("worker.update")
        world = np.asarray(req.world, np.uint8)
        if req.start_y == -1:  # haloed-strip wire mode
            strip = compute_strip_haloed(world)
        else:
            strip = compute_strip(world, req.start_y, req.end_y)
        return Response(
            work_slice=strip,
            worker=req.worker,
            service_seconds=time.monotonic() - t0,
        )

    # -- resident-strip verbs (-wire resident: the strip stays here) --------

    def strip_start(self, req: Request) -> Response:
        """Seed (or re-seed) this worker's resident strip at a turn. The
        broker calls it at run start, after loss recovery, and at every
        re-split — always with the full strip, so it REPLACES any previous
        session unconditionally."""
        # own it: the request array may be a view of the receive buffer
        strip = np.array(req.world, np.uint8, copy=True)
        if strip.ndim != 2 or strip.shape[0] < 1:
            raise ValueError(f"strip must be a 2-D row block, got {strip.shape}")
        from ..ops.sparse import wire_tile_grid

        grid_cols = getattr(req, "grid_cols", 0)
        # a nonzero column-band count marks a 2-D tile session (read with
        # getattr: an older broker's pickle lacks the field, and this
        # worker keeps serving plain 1-D strips)
        is_tile = isinstance(grid_cols, int) and grid_cols >= 1
        resident = _ResidentStrip(strip, self.device) if _device_session(strip, is_tile) else None
        with self._strip_lock:
            self._resident = resident
            self._strip = strip if resident is None else resident.strip
            turn = self._strip_turn = getattr(req, "initial_turn", 0)
            self._strip_index = req.worker
            self._strip_is_tile = is_tile
            # the broker just sent this full strip, so its copy IS
            # current: a clean dirty accumulator anchored at the seed turn
            self._strip_dirty = np.zeros(wire_tile_grid(strip.shape), bool)
            self._strip_clean_turn = turn
        # reply with the turn captured under the lock: a concurrent
        # StripStep must not make this acknowledgment claim the stepped turn
        return Response(worker=req.worker, turns_completed=turn)

    def strip_step(self, req: Request) -> Response:
        """Advance the resident strip ``req.turns`` turns given depth-K halo
        rows (req.world = [top K; bottom K] stacked). Lockstep-guarded:
        ``req.initial_turn`` must equal the strip's turn — a mismatch means
        the broker and this worker disagree about history and MUST be an
        error reply, never a silently-diverged strip."""
        t0 = time.monotonic()
        _faults.fault_point("worker.strip_step")
        k = req.turns
        with self._strip_lock:
            if self._strip is None:
                raise ValueError("no resident strip: StripStart must precede StripStep")
            if getattr(req, "initial_turn", 0) != self._strip_turn:
                raise ValueError(
                    f"lockstep violation: strip is at turn {self._strip_turn}, "
                    f"broker asked for turn {getattr(req, 'initial_turn', 0)}"
                )
            if req.worker != self._strip_index:
                raise ValueError(
                    f"strip index mismatch: seeded as {self._strip_index}, "
                    f"stepped as {req.worker}"
                )
            halo_blocks = halos = None
            if self._strip_is_tile:
                if k < 1:
                    raise ValueError(f"tile batch needs k >= 1, got {k}")
                th, tw = self._strip.shape
                buf = np.asarray(req.world, np.uint8).ravel()
                shapes = tile_halo_shapes(k, th, tw)
                want = sum(_packed_len(s) for s in shapes)
                if buf.size != want:
                    raise ValueError(
                        f"depth-{k} tile halos for a {th}x{tw} tile must "
                        f"pack to {want} bytes, got {buf.size}"
                    )
                halo_blocks = unpack_tile_blocks(buf, shapes)
            else:
                halos = np.asarray(req.world, np.uint8)
                if halos.shape != (2 * k, self._strip.shape[1]):
                    raise ValueError(
                        f"depth-{k} halos must be ({2 * k}, "
                        f"{self._strip.shape[1]}), got {halos.shape}"
                    )
                if k > self._strip.shape[0]:
                    raise ValueError(
                        f"batch depth {k} exceeds strip height {self._strip.shape[0]}"
                    )
            check = _integrity.enabled()
            if self._resident is not None:
                edges, counts, dirty, digests = self._step_resident(halos, k, check)
            else:
                edges, counts, dirty, digests = self._step_numpy(halo_blocks, halos, k, check)
            if (
                self._strip_dirty is not None
                and self._strip_dirty.shape == dirty.shape
            ):
                self._strip_dirty |= dirty
            else:
                self._strip_dirty = dirty.copy()
            self._strip_turn += k
            turn_done = self._strip_turn
        return Response(
            worker=req.worker,
            turns_completed=turn_done,
            edges=edges,
            counts=counts,
            digests=digests,
            dirty=dirty,
            service_seconds=time.monotonic() - t0,
        )

    def _step_resident(self, halos: np.ndarray, k: int, check: bool):
        """A batch of a device session (strip lock held): W steps the
        strip and yields the dirty grid and the strip digests' sums; the
        host folds the edges' and bands' digests."""
        from ..ops.strip_steps import split_bands

        session = self._resident
        with session.on_stream():
            # chaos site (rpc/faults.py "corrupt" action): flips a byte of
            # the RESIDENT strip in place, on the session's stream, before
            # W sums it, so the broker's chain comparison refuses this reply
            _faults.fault_point("worker.strip_corrupt", target=session.strip)
            edges, counts, dirty, sums, bands = session.step(halos, k, check)
        self._strip = session.strip
        digests = None
        if check:
            shape, w = tuple(session.strip.shape), session.strip.shape[1]
            at = ab = _integrity.state_new()
            for top, bottom in split_bands(bands, k, w):
                at = _integrity.state_add(at, top)
                ab = _integrity.state_add(ab, bottom)
            new = _integrity.state_new()
            digests = {
                "pre": _integrity.state_hex(
                    _integrity.state_add_sums(new, shape, np.uint8, *sums[:2])),
                "strip": _integrity.state_hex(
                    _integrity.state_add_sums(new, shape, np.uint8, *sums[2:])),
                "edges": _integrity.state_digest(edges),
                "attest_top": _integrity.state_hex(at),
                "attest_bottom": _integrity.state_hex(ab),
            }
        return edges, counts, dirty, digests

    def _step_numpy(self, halo_blocks, halos, k: int, check: bool):
        """A batch of a numpy session (strip lock held), as the
        reference's StripStep runs it."""
        # chaos site (rpc/faults.py "corrupt" action): flips a byte of
        # the RESIDENT strip in place, before the pre-digest, so the
        # broker's chain comparison refuses this reply
        _faults.fault_point("worker.strip_corrupt", target=self._strip)
        pre = _integrity.state_digest(self._strip) if check else None
        pre_strip = self._strip
        att = None
        if self._strip_is_tile:
            if check:
                strip, counts, att = tile_step_batch(
                    self._strip, halo_blocks, k, attest=True
                )
            else:
                strip, counts = tile_step_batch(self._strip, halo_blocks, k)
        elif check:
            strip, counts, att_top, att_bottom = strip_step_batch(
                self._strip, halos[:k], halos[k:], k, attest=True,
                device=self.device,
            )
        else:
            strip, counts = strip_step_batch(
                self._strip, halos[:k], halos[k:], k, device=self.device
            )
        # per-tile dirty bitmap over the batch (ops/sparse.py wire
        # tiles): rides the reply and accumulates locally so a later
        # StripFetch can ship only the tiles that changed
        from ..ops.sparse import dirty_tile_grid

        dirty = dirty_tile_grid(pre_strip, strip)
        self._strip = strip
        # the fresh boundary bands: the broker relays them to this
        # block's neighbours as their next batch's halos. A tile ships
        # all four edges bit-packed (corners never ride the uplink).
        if self._strip_is_tile:
            edges = pack_tile_blocks(
                (strip[:k], strip[-k:], strip[:, :k], strip[:, -k:])
            )
        else:
            edges = np.concatenate([strip[:k], strip[-k:]], axis=0)
        digests = None
        if check:
            # "pre"/"strip" anchor the broker's per-strip digest chain,
            # "edges" covers the reply bands as they cross (for a tile,
            # the packed buffer), the attest digests feed the
            # neighbour cross-check (two for a strip, eight for a tile)
            digests = {
                "pre": pre,
                "strip": _integrity.state_digest(strip),
                "edges": _integrity.state_digest(edges),
            }
            if self._strip_is_tile:
                digests.update(att)
            else:
                digests["attest_top"] = att_top
                digests["attest_bottom"] = att_bottom
        return edges, counts, dirty, digests

    def strip_fetch(self, req: Request) -> Response:
        """Read the resident strip + its turn back out (full re-syncs,
        snapshots, loss recovery).

        When the broker passes ``delta_base_turn`` matching this strip's
        dirty-accumulator anchor, the reply is a DELTA frame: the dirty
        bitmap plus only the changed tiles as one flat buffer
        (``ops/sparse.extract_dirty_tiles`` layout). Any mismatch degrades
        to the full frame; either way the accumulator re-anchors at the
        current turn."""
        base_turn = getattr(req, "delta_base_turn", -1)
        with self._strip_lock:
            if self._strip is None:
                raise ValueError("no resident strip to fetch")
            delta_ok = (
                isinstance(base_turn, int)
                and base_turn >= 0
                and self._strip_dirty is not None
                and base_turn == self._strip_clean_turn
            )
            # a device session's strip comes down to the host here: syncs
            # are every -sync-interval turns, not every batch
            strip = self._strip if self._resident is None else self._resident.fetch()
            if delta_ok:
                from ..ops.sparse import extract_dirty_tiles

                dirty = self._strip_dirty
                flat = extract_dirty_tiles(strip, dirty)
                self._strip_dirty = np.zeros_like(dirty)
                self._strip_clean_turn = self._strip_turn
                return Response(
                    worker=self._strip_index,
                    turns_completed=self._strip_turn,
                    work_slice=flat,
                    dirty=dirty,
                )
            # a numpy strip itself is safe to ship: StripStep REPLACES the
            # array (never mutates in place)
            if self._strip_dirty is not None:
                self._strip_dirty = np.zeros_like(self._strip_dirty)
            self._strip_clean_turn = self._strip_turn
            return Response(
                worker=self._strip_index,
                turns_completed=self._strip_turn,
                work_slice=strip,
            )

    def worker_quit(self, req: Request) -> Response:
        # reply first, then shut the listener (worker/worker.go:82-86): a
        # non-daemon timer outlives this handler so the reply flushes
        threading.Timer(0.05, self._shutdown).start()
        return Response()

    def _shutdown(self):
        self._server.stop()
        self.quit_event.set()


def serve(
    port: int = 8030, host: str = "127.0.0.1", device=None
) -> tuple[RpcServer, WorkerService]:
    """Start a worker listening on ``host:port`` (0 picks a free port,
    ``server.port`` says which), serving in background threads. ``device``
    is where its fused strip batches run: None is the CUDA card, and
    raises without one; "cpu" for the tests."""
    dev = resolve_device(device)
    server = RpcServer(host=host, port=port)
    service = WorkerService(server, dev)
    server.register(Methods.WORKER_UPDATE, service.update)
    server.register(Methods.WORKER_QUIT, service.worker_quit)
    server.register(Methods.STRIP_START, service.strip_start)
    server.register(Methods.STRIP_STEP, service.strip_step)
    server.register(Methods.STRIP_FETCH, service.strip_fetch)
    server.serve_background()
    return server, service


#: the reference worker's flags this slice does not carry, each refused by
#: name
_NOT_PORTED = ("-metrics", "-timeline", "-trace", "-journal", "-profile")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="GoL worker node", allow_abbrev=False)
    parser.add_argument("-port", type=int, default=8030)
    parser.add_argument(
        "-host", default="127.0.0.1",
        help="bind address; 0.0.0.0 opts into external exposure",
    )
    parser.add_argument(
        "-integrity", choices=("on", "off"), default="on",
        help="frame checksums + resident-strip attestation digests "
             "(rpc/integrity.py). Default on; off disables both "
             "advertising and computing — an off worker is undefended "
             "against silent corruption",
    )
    parser.add_argument(
        "-device", default="cuda",
        help="where fused strip batches run: cuda (default; fails without "
             "a card) or cpu",
    )
    args, rest = parser.parse_known_args(argv)
    for token in rest:
        flag = token.split("=", 1)[0]
        if flag in _NOT_PORTED:
            parser.error(f"{flag} is not ported yet")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    _integrity.set_enabled(args.integrity == "on")
    server, service = serve(args.port, args.host, device=device)
    print(f"worker listening on :{server.port}", flush=True)
    service.quit_event.wait()


if __name__ == "__main__":
    main()
