"""The resident worker's strip batch: K Conway turns of a strip between its
depth-K halos in shrinking form, its alive count after every turn, on
request every turn's attestation bands, the wire-tile dirty grid of the
batch and the adler32 sums of the strip before and after it
(csrc/strip_steps.cu).

It replaces the XLA program of the JAX package's ``fused_strip_steps``
(``gol_distributed_final_tpu/ops/fused.py:673``, its turn
``_jax_strip_turn`` :640), which a resident worker runs under StripStep
(``rpc/worker.py``), and the two host passes StripStep makes around it:
``ops/sparse.py::dirty_tile_grid`` and the ``state_digest`` of the strip
before and after the batch. The block is ``[top K rows; the strip's h
rows; bottom K rows]`` of width w; columns wrap within w, and each turn
consumes one row at each end, so K turns land on the (h, w) strip K turns
later. After turn i (1-based) ``counts[i - 1]`` is the alive count of the
strip's rows, and the two attestation bands are the block's first and
last 2 (K - i) rows: the rows the neighbouring workers compute as well.

``strip_batch`` takes the three parts where they lie (a worker's resident
strip and its halos) and writes into outputs the caller may hold across
batches (``into``); ``strip_steps`` takes one padded block. Both return a
``StripBatch``: the strip, the counts, the bands as one flat uint8 tensor
(every turn's top band then its bottom band in turn order,
``band_offsets``, which ``split_bands`` cuts into numpy pairs), the dirty
grid (bool, ``ops/sparse.py::wire_tile_grid`` of the strip: True where a
tile's bytes changed), with ``attest`` the sums ``[S1, S2]`` of the strip
before the batch, then of the new strip: ``S1 = sum d_p`` and
``S2 = sum (n - p) d_p`` over its n bytes in row-major order, each
congruent modulo ``MOD`` to what adler32 adds, so that
``rpc/integrity.py::state_add_sums`` folds them into the strip's digest,
and the edges, the new strip's first and last K rows (a StripStep reply's
``edges``; None for a strip of fewer than K rows).

``strip_steps_plain`` computes every output in torch ops; the CPU path and
the tests use it. The wrappers take it only for tensors on the CPU; for
CUDA tensors they launch the kernel, 32 turns at most a launch (one halo
word covers that many), or raise.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..obs import device as _device
from ..models import CONWAY
from . import _build, _tiles
from .byte_tiled import SMALL_TILE, TILE, tile_for
from .bitpack import byte_launch_cost
from .sparse import WIRE_TILE_COLS, WIRE_TILE_ROWS, wire_tile_grid

#: turns one launch may take: one halo word of 32 columns covers as many
MAX_TURNS = 32

#: the kernel's tiles in cells (rows, cols), csrc/strip_steps.cu: the
#: byte-tile kernel's two, chosen for each launch's output as that kernel's
#: are (``tile_for``). Each nests in one wire tile, so a CTA's output is one
#: dirty flag.

#: adler32's modulus
MOD = 65521

#: kernel launches made; ``plain_calls`` counts the batches that the plain
#: version stood in for (CPU tensors) instead
launches = 0
plain_calls = 0
_count_lock = threading.Lock()

_SIGNATURES = {
    "gol_strip_steps": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}
_entry = None  # the library's gol_strip_steps, resolved at its first launch


class StripBatch(NamedTuple):
    """One batch's outputs, on the strip's device."""

    strip: torch.Tensor  # (h, w) uint8, K turns on
    counts: torch.Tensor  # K alive counts of the strip, one after each turn
    bands: Optional[torch.Tensor]  # the flat band output with attest, else None
    dirty: torch.Tensor  # bool wire-tile grid: which tiles changed over the batch
    sums: Optional[torch.Tensor]  # int64 [S1, S2 before; S1, S2 after] with attest
    edges: Optional[torch.Tensor]  # (2K, w) uint8: the new strip's first and last K
    # rows; None for a strip of fewer than K rows


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def band_offsets(k: int, width: int) -> list[tuple[int, int, int]]:
    """``(top, bottom, rows)`` for each of the k turns: the byte offsets of
    its top and bottom bands in the flat band output, and the rows in each
    (2 (k - i) after turn i)."""
    out, off = [], 0
    for i in range(1, k + 1):
        rows = 2 * (k - i)
        out.append((off, off + rows * width, rows))
        off += 2 * rows * width
    return out


def split_bands(flat: np.ndarray, k: int, width: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The flat band output as one (top, bottom) pair of (rows, width)
    arrays a turn, views of ``flat``."""
    return [
        (flat[top:top + rows * width].reshape(rows, width),
         flat[bottom:bottom + rows * width].reshape(rows, width))
        for top, bottom, rows in band_offsets(k, width)
    ]


def _check(padded: torch.Tensor, k: int, h: int) -> None:
    if k < 1:
        raise ValueError(f"strip batch needs k >= 1, got {k}")
    if h < 1:
        raise ValueError(f"strip batch needs h >= 1 strip rows, got {h}")
    if padded.dim() != 2 or padded.shape[0] != h + 2 * k or padded.shape[1] < 1:
        raise ValueError(f"a depth-{k} block of a {h}-row strip is ({h + 2 * k}, w), "
                         f"got {tuple(padded.shape)}")


def strip_turn_plain(x: torch.Tensor) -> torch.Tensor:
    """One shrinking-form turn, the torch mirror of the JAX package's
    ``_jax_strip_turn``: columns wrap, the first and last rows are
    consumed, values stay uint8 {0, 255} (Conway)."""
    ext = torch.cat([x[:, -1:], x, x[:, :1]], dim=1)
    b = (ext != 0).to(torch.uint8)
    counts = (
        b[:-2, :-2] + b[:-2, 1:-1] + b[:-2, 2:]
        + b[1:-1, :-2] + b[1:-1, 2:]
        + b[2:, :-2] + b[2:, 1:-1] + b[2:, 2:]
    )
    alive = b[1:-1, 1:-1] == 1
    nxt = torch.where(alive, (counts == 2) | (counts == 3), counts == 3)
    return nxt.to(torch.uint8) * 255


def dirty_grid_plain(before: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """The wire-tile change grid of two (h, w) strips, as
    ``ops/sparse.py::dirty_tile_grid`` computes it: bool, True where any
    byte of the tile differs."""
    h, w = before.shape
    rows, cols = wire_tile_grid((h, w))
    diff = torch.zeros((rows * WIRE_TILE_ROWS, cols * WIRE_TILE_COLS), dtype=torch.bool,
                       device=before.device)
    diff[:h, :w] = before != after
    return diff.view(rows, WIRE_TILE_ROWS, cols, WIRE_TILE_COLS).any(dim=3).any(dim=1)


def adler_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """``[S1, S2]`` modulo ``MOD`` of the bytes of ``x`` (uint8, rows of
    its last axis in order): ``S1 = sum d_p``, ``S2 = sum (n - p) d_p``
    over the n bytes. Row by row, so no term leaves int64: a row r of w
    bytes adds ``(n - r w) s_r - sum_c c d_rc`` to S2."""
    if x.numel() == 0:
        return torch.zeros(2, dtype=torch.int64, device=x.device)
    d = x.reshape(-1, x.shape[-1] if x.dim() else 1).to(torch.int64)
    h, w = d.shape
    n = h * w
    rows = d.sum(1)
    cols = (d * torch.arange(w, dtype=torch.int64, device=d.device)).sum(1)
    base = (n - torch.arange(h, dtype=torch.int64, device=d.device) * w) % MOD
    return torch.stack([rows.sum() % MOD, (base * (rows % MOD) - cols).sum() % MOD])


def strip_steps_plain(padded: torch.Tensor, k: int, h: int, attest: bool = False) -> StripBatch:
    """The plain version of ``strip_steps``, in torch on the block's
    device: the counts are int64, the sums reduced modulo ``MOD``."""
    _check(padded, k, h)
    cur = padded
    counts, bands = [], []
    for i in range(k):
        cur = strip_turn_plain(cur)
        off = k - (i + 1)
        counts.append((cur[off:off + h] != 0).sum())
        if attest:
            band = 2 * off
            bands.append(cur[:band].reshape(-1))
            bands.append(cur[cur.shape[0] - band:].reshape(-1))
    strip = cur.contiguous()
    before = padded[k:k + h]
    flat = sums = None
    if attest:
        flat = torch.cat(bands) if bands else padded.new_zeros(0)
        sums = torch.cat([adler_sums_plain(before), adler_sums_plain(strip)])
    return StripBatch(strip, torch.stack(counts), flat, dirty_grid_plain(before, strip), sums,
                      torch.cat([strip[:k], strip[h - k:]]) if h >= k else None)


def _check_parts(top, strip, bottom, k: int) -> None:
    if k < 1:
        raise ValueError(f"strip batch needs k >= 1, got {k}")
    if strip.dim() != 2 or strip.shape[0] < 1 or strip.shape[1] < 1:
        raise ValueError(f"a strip is (h >= 1, w >= 1), got {tuple(strip.shape)}")
    want = (k, strip.shape[1])
    if tuple(top.shape) != want or tuple(bottom.shape) != want:
        raise ValueError(f"depth-{k} halos of a {tuple(strip.shape)} strip are each {want}, "
                         f"got {tuple(top.shape)} and {tuple(bottom.shape)}")
    if top.device != strip.device or bottom.device != strip.device:
        raise ValueError("a strip and its halos lie on one device")


def _entry_fn():
    global _entry
    if _entry is None:
        _entry = _build.load("strip_steps", _SIGNATURES).gol_strip_steps
    return _entry


def output_specs(h: int, width: int, k: int, attest: bool) -> dict:
    """Each ``StripBatch`` field's (shape, dtype) for a batch of k turns of
    an (h, width) strip; None for the fields ``attest`` leaves out."""
    return {
        "strip": ((h, width), torch.uint8),
        "counts": ((k,), torch.int32),
        "bands": ((2 * width * k * (k - 1),), torch.uint8) if attest else None,
        "dirty": (wire_tile_grid((h, width)), torch.bool),
        "sums": ((4,), torch.int64) if attest else None,
        "edges": ((2 * k, width), torch.uint8) if h >= k else None,
    }


def batch_outputs(h: int, width: int, k: int, attest: bool, device) -> StripBatch:
    """Fresh outputs for ``strip_batch(..., into=)``: the sums, counts and
    dirty grid zeroed, in one allocation in that order (one memset)."""
    grid = wire_tile_grid((h, width))
    zeroed = torch.zeros(32 + 4 * k + grid[0] * grid[1], dtype=torch.uint8, device=device)
    return StripBatch(
        torch.empty((h, width), dtype=torch.uint8, device=device),
        zeroed[32:32 + 4 * k].view(torch.int32),
        torch.empty(2 * width * k * (k - 1), dtype=torch.uint8, device=device) if attest else None,
        zeroed[32 + 4 * k:].view(torch.bool).view(grid),
        zeroed[:32].view(torch.int64) if attest else None,
        torch.empty((2 * k, width), dtype=torch.uint8, device=device) if h >= k else None,
    )


def _check_into(into: StripBatch, h: int, width: int, k: int, attest: bool, device) -> None:
    for name, spec in output_specs(h, width, k, attest).items():
        got = getattr(into, name)
        if (got is None) != (spec is None) or (got is not None and (
                tuple(got.shape) != tuple(spec[0]) or got.dtype != spec[1]
                or got.device != device or not got.is_contiguous())):
            have = None if got is None else (tuple(got.shape), got.dtype, got.device)
            raise ValueError(f"into.{name} must be {spec} on {device}, got {have}")


#: the telemetry site W's launches are timed under (obs/device.py): the
#: JAX package's fused strip program
SITE = "fused.strip"


def _cost(cells_read: int, turns: int, written: int) -> tuple[float, float]:
    """``(int32 operations, bytes)`` of W's bound for one launch: the byte
    board's operations on every cell it reads (Conway, W's only rule),
    those cells read once and ``written`` bytes written once."""
    ops, _ = byte_launch_cost(cells_read, turns, CONWAY.birth_mask, CONWAY.survive_mask)
    return ops, float(cells_read + written)


def _side_bytes(into: "StripBatch") -> int:
    """Bytes of a batch's outputs beside the strip: counts, bands, dirty
    grid, digest sums and edges, written once each."""
    return sum(t.numel() * t.element_size() for t in into[1:] if t is not None)


def _count(name: str) -> None:
    # the wrappers run on several workers' threads at once
    global launches, plain_calls
    with _count_lock:
        if name == "launches":
            launches += 1
        else:
            plain_calls += 1


def strip_batch(top: torch.Tensor, strip: torch.Tensor, bottom: torch.Tensor, k: int,
                attest: bool = False, *, into: Optional[StripBatch] = None, tile=None,
                ctas: Optional[int] = None) -> StripBatch:
    """K turns of the (h, w) uint8 ``strip`` between its (K, w) halos
    ``top`` and ``bottom`` (any nonzero cell alive), in ceil(K / 32)
    launches. The outputs go into ``into`` (``batch_outputs``' shapes, with
    counts, grid and sums zeroed; fresh ones when None), which is
    returned; none may share memory with the inputs, which are never
    written. On the card the counts are int32 and the sums congruent
    modulo ``MOD`` to the plain version's. Each launch runs on
    ``tile_for``'s tile for its output unless ``tile`` forces ``TILE`` or
    ``SMALL_TILE``; ``ctas`` caps the kernel's persistent grid."""
    k = int(k)
    _check_parts(top, strip, bottom, k)
    h, width = strip.shape
    if into is None:
        into = batch_outputs(h, width, k, attest, strip.device)
    else:
        _check_into(into, h, width, k, attest, strip.device)
    if any(into.strip.data_ptr() == p.data_ptr() for p in (top, strip, bottom)):
        raise ValueError("the new strip must not be written over an input")
    if strip.device.type == "cpu":
        _count("plain_calls")
        started = _device.begin(strip.device)
        res = strip_steps_plain(torch.cat([top, strip, bottom]), k, h, attest)
        for dst, src in zip(into, res):
            if dst is not None:
                dst.copy_(src)
        if started is not None:
            _device.end(SITE, strip.device, started, *_cost(
                (h + 2 * k) * width, k, into.strip.numel() + _side_bytes(into)))
        return into
    if strip.device.type != "cuda":
        raise ValueError(f"no strip kernel for device {strip.device}")
    for name, part in (("top", top), ("strip", strip), ("bottom", bottom)):
        if part.dtype != torch.uint8 or not part.is_contiguous():
            raise ValueError(f"the strip kernel takes contiguous uint8 tensors, got {name} "
                             f"{part.dtype} contiguous={part.is_contiguous()}")
    if tile not in (None, TILE, SMALL_TILE):
        raise ValueError(f"the strip kernel has tiles {TILE} and {SMALL_TILE}, got {tile}")
    if ctas is not None and int(ctas) < 1:
        raise ValueError(f"ctas caps the grid at >= 1 CTAs, got {ctas}")
    dev = strip.device
    entry = _entry_fn()
    bands = into.bands if attest and into.bands.numel() else None
    guard, stream = _tiles.on_device(strip)
    timing = _device.timing_stream(dev)
    parts, done = (top, strip, bottom), 0
    with guard:
        while done < k:
            step = min(MAX_TURNS, k - done)
            rest = k - done - step  # halo lines left after this launch
            dst = into.strip if rest == 0 else torch.empty((h + 2 * rest, width),
                                                           dtype=torch.uint8, device=dev)
            which = 1 if (tile or tile_for((h + 2 * rest, width))) == TILE else 2
            started = _device.begin(dev, timing)
            err = entry(parts[0].data_ptr(), parts[1].data_ptr(), parts[2].data_ptr(),
                        strip.data_ptr(), dst.data_ptr(), width, step, h, k, done,
                        into.counts.data_ptr(), None if bands is None else bands.data_ptr(),
                        into.dirty.data_ptr(), into.sums.data_ptr() if attest else None,
                        None if into.edges is None else into.edges.data_ptr(), which,
                        int(ctas or 0), stream)
            if err:
                _build.check(err, "strip kernel launch")
            _count("launches")
            if started is not None:
                _device.end(SITE, dev, started, *_cost(
                    (h + 2 * (rest + step)) * width, step,
                    dst.numel() + (_side_bytes(into) if rest == 0 else 0)))
            parts = (dst[:rest], dst[rest:rest + h], dst[rest + h:])
            done += step
    return into


def strip_steps(padded: torch.Tensor, k: int, h: int, attest: bool = False, *, tile=None,
                ctas: Optional[int] = None) -> StripBatch:
    """K turns of the (h + 2K, w) uint8 block ``padded`` (any nonzero cell
    alive): ``strip_batch`` on its three parts. The input is never
    written."""
    k, h = int(k), int(h)
    _check(padded, k, h)
    if padded.device.type == "cpu":
        _count("plain_calls")
        started = _device.begin(padded.device)
        res = strip_steps_plain(padded, k, h, attest)
        if started is not None:
            _device.end(SITE, padded.device, started,
                        *_cost(padded.numel(), k, res.strip.numel() + _side_bytes(res)))
        return res
    return strip_batch(padded[:k], padded[k:k + h], padded[k + h:], k, attest, tile=tile,
                       ctas=ctas)
