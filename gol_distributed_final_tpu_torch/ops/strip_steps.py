"""The resident worker's strip batch: K Conway turns of a padded uint8
strip in shrinking form, its alive count after every turn and, on request,
every turn's attestation bands (csrc/strip_steps.cu).

It replaces the XLA program of the JAX package's ``fused_strip_steps``
(``gol_distributed_final_tpu/ops/fused.py:673``, its turn
``_jax_strip_turn`` :640), which a resident worker runs under StripStep
(``rpc/worker.py``). The block is ``[top K rows; the strip's h rows;
bottom K rows]`` of width w; columns wrap within w, and each turn consumes
one row at each end, so K turns land on the (h, w) strip K turns later.
After turn i (1-based) ``counts[i - 1]`` is the alive count of the strip's
rows, and the two attestation bands are the block's first and last
2 (K - i) rows: the rows the neighbouring workers compute as well.

``strip_steps_plain`` is the torch mirror of ``_jax_strip_turn`` looped K
times; the CPU path and the tests use it. ``strip_steps`` takes it only for
a tensor on the CPU; for a CUDA tensor it launches the kernel, 32 turns at
most a launch (one halo word covers that many), or raises. Both return the
bands as one flat uint8 tensor, every turn's top band then its bottom band
in turn order (``band_offsets``), which ``split_bands`` cuts into numpy
pairs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, _tiles

#: turns one launch may take: one halo word of 32 columns covers as many
MAX_TURNS = 32

#: the kernel's tiles in cells (rows, cols), csrc/strip_steps.cu: the
#: byte-tile kernel's two (ops/byte_tiled.py::TILE, SMALL_TILE), the small
#: one for a block with fewer than ``MIN_BLOCKS`` wide tiles
TILE = (64, 256)
SMALL_TILE = (16, 64)
MIN_BLOCKS = 132

#: kernel launches made; ``plain_calls`` counts the batches that the plain
#: version stood in for (CPU tensors) instead
launches = 0
plain_calls = 0

_SIGNATURES = {
    "gol_strip_steps": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ],
}
_entry = None  # the library's gol_strip_steps, resolved at its first launch


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


def strip_steps_plain(padded: torch.Tensor, k: int, h: int, attest: bool = False):
    """The plain version of ``strip_steps``, in torch on the block's
    device: ``(strip, counts, bands)`` with counts an int64 tensor of k
    and bands the flat band output (None without ``attest``)."""
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
    flat = None
    if attest:
        flat = torch.cat(bands) if bands else padded.new_zeros(0)
    return cur.contiguous(), torch.stack(counts), flat


def strip_steps(padded: torch.Tensor, k: int, h: int, attest: bool = False, *, tile=None):
    """K turns of the (h + 2K, w) uint8 block ``padded`` (any nonzero cell
    alive) in ceil(K / 32) launches: ``(strip, counts, bands)``, the (h, w)
    strip K turns on, the int32 counts of its alive cells after each turn,
    and the flat band output when ``attest`` (else None). ``tile`` forces
    ``TILE`` or ``SMALL_TILE``. The input is never written."""
    global plain_calls, launches, _entry
    k, h = int(k), int(h)
    _check(padded, k, h)
    if padded.device.type == "cpu":
        plain_calls += 1
        return strip_steps_plain(padded, k, h, attest)
    if padded.device.type != "cuda":
        raise ValueError(f"no strip kernel for device {padded.device}")
    if padded.dtype != torch.uint8 or not padded.is_contiguous():
        raise ValueError("the strip kernel takes a contiguous uint8 block, got "
                         f"{padded.dtype} contiguous={padded.is_contiguous()}")
    if tile not in (None, TILE, SMALL_TILE):
        raise ValueError(f"the strip kernel has tiles {TILE} and {SMALL_TILE}, got {tile}")
    which = 0 if tile is None else (1 if tile == TILE else 2)
    width = padded.shape[1]
    if _entry is None:
        _entry = _build.load("strip_steps", _SIGNATURES).gol_strip_steps
    counts = torch.zeros(k, dtype=torch.int32, device=padded.device)
    bands = None
    if attest:
        bands = torch.empty(2 * width * k * (k - 1), dtype=torch.uint8, device=padded.device)
    guard, stream = _tiles.on_device(padded)
    src, done = padded, 0
    with guard:
        while done < k:
            step = min(MAX_TURNS, k - done)
            dst = torch.empty((src.shape[0] - 2 * step, width), dtype=torch.uint8,
                              device=padded.device)
            err = _entry(src.data_ptr(), dst.data_ptr(), src.shape[0], width, step, h, k,
                         done, counts.data_ptr(),
                         bands.data_ptr() if bands is not None and bands.numel() else None,
                         which, stream)
            if err:
                _build.check(err, "strip kernel launch")
            launches += 1
            src, done = dst, done + step
    return src, counts, bands
