"""The tiled bitboard step: boards of any size, k <= 8 turns per launch
over a 2-D grid of tiles, each stepped in a window with a one-word halo
on the packed axis and a k-word halo on the other (csrc/tiled.cu).

It replaces both tiled Pallas kernels of the JAX package,
``gol_distributed_final_tpu/ops/pallas_tiled.py:284``
(``tiled_pallas_call``): K3, full-width row blocks (the "rows" mode,
:335), and K4, 2-D blocks (the "grid2d" mode, :349). The Mosaic
8-row/128-lane alignment those modes were shaped by is no part of the
contract here. What bounds the kernel and how the design meets that is
written at the top of the CUDA source.

The plain version does the same window-and-interior arithmetic in torch,
with k ``bit_step``s on the batch of windows; the window gather and the
launch loop are shared with the byte tiles (ops/_tiles.py). ``step_n``
takes the plain version only for a tensor on the CPU. For a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _tiles
from .bitpack import bit_step_n, rule_masks
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK

#: turns one launch may take: the halo on the other axis is that many
#: words deep (on the packed axis one word, 32 cells, covers them)
MAX_TURNS = 8

#: output tile in words (rows, cols), fixed at compile time in
#: csrc/tiled.cu (kTileR, kTileC). With k = 8 its window is 34 x 144 words
#: on word axis 0 (rows padded to 152 words, two copies 41,344 B, five
#: blocks of 288 threads an SM) and 48 x 130 on word axis 1 (49,920 B, four
#: an SM); over k turns it computes ~1.12x and ~1.24x the interior's words
#: (a 32 x 256 tile would halve the blocks per SM and leave half of a
#: 4096^2 board's 132 SMs without a tile); 128 words of a row are 512
#: contiguous bytes per load.
TILE = (32, 128)

#: kernel launches made by ``step_n``; ``plain_calls`` counts the calls
#: that took the plain version (CPU tensors) instead
launches = 0
plain_calls = 0

_SIGNATURES = {
    "gol_tiled_step": [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ],
}


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def _launch_sizes(n: int, turns_per_launch: int) -> list[int]:
    return _tiles.launch_sizes(n, turns_per_launch, MAX_TURNS, "a tiled launch")


def launch_plain(packed, k, word_axis=0, birth_mask=CONWAY_BIRTH_MASK,
                 survive_mask=CONWAY_SURVIVE_MASK):
    """What one kernel launch computes, in torch: k turns, tile by tile,
    each window one word wider than its tile on each side of the packed
    axis and k words on each side of the other."""
    return _tiles.launch_plain(
        packed, k, TILE,
        lambda windows, k: bit_step_n(windows, k, word_axis, birth_mask, survive_mask),
        halo=(1, k) if word_axis == 0 else (k, 1),
    )


def step_n_plain(packed, n, word_axis=0, birth_mask=CONWAY_BIRTH_MASK,
                 survive_mask=CONWAY_SURVIVE_MASK, *, turns_per_launch=MAX_TURNS):
    """The plain version of ``step_n``: the same launches, in torch."""
    for k in _launch_sizes(n, turns_per_launch):
        packed = launch_plain(packed, k, word_axis, birth_mask, survive_mask)
    return packed


def step_n(
    packed: torch.Tensor,
    n: int,
    word_axis: int = 0,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    turns_per_launch: int = MAX_TURNS,
) -> torch.Tensor:
    """n turns of an int32 bitboard ``[rows, cols]`` in ceil(n / k)
    launches of k = ``turns_per_launch`` turns (the last takes the rest).
    The input is never written."""
    global plain_calls
    sizes = _launch_sizes(n, turns_per_launch)
    if packed.device.type == "cpu":
        plain_calls += 1
        return step_n_plain(
            packed, n, word_axis, birth_mask, survive_mask,
            turns_per_launch=turns_per_launch,
        )
    if packed.device.type != "cuda":
        raise ValueError(f"no tiled kernel for device {packed.device}")
    if packed.dtype != torch.int32 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError(
            "the tiled kernel takes a contiguous 2-D int32 bitboard, got "
            f"{packed.dtype} {tuple(packed.shape)} contiguous={packed.is_contiguous()}"
        )
    if word_axis not in (0, 1):
        raise ValueError(f"word_axis must be 0 or 1, got {word_axis}")
    rows, cols = packed.shape
    common, dead_only, live_only = rule_masks(birth_mask, survive_mask)
    lib = _build.load("tiled", _SIGNATURES)

    def launch(src, dst, k, stream):
        global launches
        err = lib.gol_tiled_step(
            src.data_ptr(), dst.data_ptr(), rows, cols, word_axis, k,
            common, dead_only, live_only, stream,
        )
        _build.check(err, "tiled kernel launch")
        launches += 1

    return _tiles.ping_pong(packed, sizes, launch)


def tiled_bit_step_n_fn(*, rule=None, word_axis=0):
    """A ``(packed_int32, n) -> packed`` bitboard evolution for any size:
    one tiled launch per turn, as the JAX package's function of this name
    (``ops/pallas_tiled.py:397``) launches."""
    birth = rule.birth_mask if rule else CONWAY_BIRTH_MASK
    survive = rule.survive_mask if rule else CONWAY_SURVIVE_MASK

    def step_n_fn(packed, n):
        return step_n(packed, n, word_axis, birth, survive, turns_per_launch=1)

    return step_n_fn
