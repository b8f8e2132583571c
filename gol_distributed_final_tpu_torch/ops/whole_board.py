"""The whole-board bitboard step: n turns on a packed board held in one
thread block's shared memory, with the row popcounts of the result, in
one launch (csrc/whole_board.cu).

It replaces the JAX package's Pallas kernel K1,
``gol_distributed_final_tpu/ops/pallas_stencil.py:217``
(``bit_pallas_call``) and, with ``counted=True``, the popcount
``ops/fused.py:523`` (``_fused_bit_counted_compiled``) fuses after it.
What bounds it on the card and how the design meets that is written at
the top of the CUDA source.

The same CUDA kernel also serves the batched bitboard (K2,
ops/batch_board.py): its grid runs over a batch of boards, and this
module launches it with a batch of one. This module owns the library's
binding and the gate both use.

The gate is the port's own: the board's two shared-memory copies must fit
the block's opt-in limit the card reports. The JAX package's
``fits_vmem`` budget does not apply. A board past the gate goes to the
tiled kernel (ops/tiled.py); the planes route, this module only refuses.

A single board (``step_n``) runs on the cluster route where
``cluster_plan`` gives it more than one block: its lines cut into bands
over a thread block cluster, each block on its own SM, with K5's
band-and-halo scheme (csrc/byte_board.cu). Between two meetings of the
cluster a block runs its turns in one of two loops: the register loop,
its band in registers and its neighbours' words by warp shuffles, for a
line of at most 32 words, else the shared-memory loop. ``cluster_plan`` mirrors the kernel
source's plan, the measured choice of blocks, halo depth and loop; a
cluster launch the card refuses runs on one block instead. The batches of
``ops/batch_board.py`` and the history mode stay on one block a board.
The cluster route's launches are timed under their own site,
``CLUSTER_SITE``, and counted apart (``cluster_launches``,
``register_launches``, and ``gol_whole_board_launches_total{route}`` with
metrics on: "block", "cluster" or "cluster_registers").

``step_n`` takes the plain version (``bit_step_n`` plus ``row_popcounts``)
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises.

``history`` is the kernel's history mode: the alive count after every
turn 1..n in one launch that keeps the board on chip (the port of the
JAX package's ``ops/bitpack.py:363`` ``alive_history``, an XLA scan). It
is routed the same way, with its plain version ``history_plain``, and
counted apart (``history_launches``) under its own telemetry site, so
the step launches' counts do not move.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..obs import device as _device
from ..obs import instruments as _ins
from ..obs import metrics as _metrics
from . import _build
from .bitpack import (
    bit_launch_cost, bit_step, bit_step_n, row_popcounts, rule_masks, turn_counts,
)
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK

#: cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100: the gate a CPU
#: tensor is routed by, so that routing on the CPU mirrors the card
H100_SMEM_OPTIN = 232_448

#: kernel launches made by ``step_n``; ``plain_calls`` counts the times it
#: took the plain version (CPU tensors) instead; ``cluster_launches`` the
#: launches among ``launches`` that ran on a cluster, ``register_launches``
#: those among them that ran the register loop
launches = 0
plain_calls = 0
cluster_launches = 0
register_launches = 0

#: the cluster route's plan (csrc/whole_board.cu: kMaxCluster,
#: kMinClusterWords, kMinBand, kHaloDepth; pick_cluster, where the sweep
#: on an H100 that set them is written): one block up to 128^2 (512 words),
#: a cluster from 160^2 (800 words), bands of at least 12 lines; the
#: shared-memory loop's halo depth
MAX_CLUSTER = 16
MIN_CLUSTER_WORDS = 768
MIN_BAND = 12
HALO_DEPTH = 16

#: the register loop's plan (csrc/whole_board.cu: kRegMaxWords, kRegLines,
#: kRegLinesWide, kRegDepth; plan_lines): lines of at most 32 words,
#: REG_LINES lines a thread (REG_LINES_WIDE where that block would pass
#: REG_MAX_THREADS), halo depth REG_DEPTH
REG_MAX_WORDS = 32
REG_LINES = 4
REG_LINES_WIDE = 8
REG_DEPTH = 16
#: the register loop's lines a thread that the kernel compiles in
REG_LINE_CHOICES = (2, 4, 8)
#: the register loop's largest block, which leaves a thread up to 128
#: registers (kRegMaxThreads), and up to 168 with REG_LINES_WIDE lines a
#: thread (kRegMaxThreadsWide)
REG_MAX_THREADS = 512
REG_MAX_THREADS_WIDE = 384

#: the telemetry site of the cluster route's launches, whatever site the
#: caller names for the one-block kernel
CLUSTER_SITE = "pallas.vmem_bit_cluster"

#: history-mode launches made by ``history``, and its plain versions
history_launches = 0
history_plain_calls = 0

#: the telemetry site of the history launches: the JAX function they replace
HISTORY_SITE = "bitpack.alive_history"

_SIGNATURES = {
    "gol_max_smem_optin": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "gol_whole_board_step": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ],
    "gol_whole_board_step_as": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p,
    ],
    "gol_whole_board_history": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ],
}
_SMEM_LIMIT: dict = {}


def _lib():
    return _build.load("whole_board", _SIGNATURES)


def launch(packed, out, counts, n, word_axis, birth_mask, survive_mask, site) -> None:
    """One launch over the boards of a contiguous int32 ``[batch, rows,
    cols]`` tensor (the callers check it): ``out`` gets each board after n
    turns and, unless ``counts`` is None, ``counts[batch, rows]`` its row
    popcounts. Raises on a refused launch. With metrics on the launch is
    timed on the card under ``site`` (obs/device.py)."""
    batch, rows, cols = packed.shape
    common, dead_only, live_only = rule_masks(birth_mask, survive_mask)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream()
        started = _device.begin(packed.device, stream)
        err = _lib().gol_whole_board_step(
            packed.data_ptr(), out.data_ptr(),
            None if counts is None else counts.data_ptr(),
            batch, rows, cols, word_axis, n, common, dead_only, live_only,
            stream.cuda_stream,
        )
        _build.check(err, "whole-board kernel launch")
        if started is not None:
            _device.end(site, packed.device, started, *bit_launch_cost(
                packed.numel(), n, birth_mask, survive_mask,
                0 if counts is None else 4 * batch * rows,
            ))


class Route(NamedTuple):
    """A single board's route: ``blocks`` (1: one block), and on a cluster
    its halo ``depth`` and its loop, ``lines`` a thread in the register
    loop or 0 for the shared-memory loop."""

    blocks: int
    depth: int = 0
    lines: int = 0

    @property
    def name(self) -> str:
        """The label of ``gol_whole_board_launches_total``."""
        if self.blocks == 1:
            return "block"
        return "cluster_registers" if self.lines else "cluster"


def launch_one(packed, out, counts, n, word_axis, birth_mask, survive_mask, site,
               cluster=0, depth=0, lines=-1) -> Route:
    """One launch for one contiguous int32 board ``[rows, cols]`` (the
    callers check it), on the route ``cluster`` gives: 0 the kernel's pick
    (``cluster_plan``), 1 one block, 2, 4, 8 or 16 a cluster of that many
    blocks, with ``depth`` halo lines (0: the loop's) and ``lines`` the loop
    (-1: the plan's for the band, 0 the shared-memory loop, one of
    ``REG_LINE_CHOICES`` the register loop), which is how the routes are
    checked and timed against each other. Returns the route that ran: one
    block where the card refused the cluster. Raises on a refused launch.
    With metrics on the launch is timed under ``site``, or
    ``CLUSTER_SITE`` on a cluster."""
    global launches, cluster_launches, register_launches
    rows, cols = packed.shape
    common, dead_only, live_only = rule_masks(birth_mask, survive_mask)
    ran = (ctypes.c_int * 3)()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream()
        started = _device.begin(packed.device, stream)
        err = _lib().gol_whole_board_step_as(
            packed.data_ptr(), out.data_ptr(), None if counts is None else counts.data_ptr(),
            rows, cols, word_axis, n, common, dead_only, live_only, cluster, depth, lines,
            ran, stream.cuda_stream,
        )
        _build.check(err, "whole-board kernel launch")
        route = Route(*ran)
        if started is not None:
            _device.end(CLUSTER_SITE if route.blocks > 1 else site, packed.device, started,
                        *bit_launch_cost(packed.numel(), n, birth_mask, survive_mask,
                                         0 if counts is None else 4 * rows))
    launches += 1
    cluster_launches += route.blocks > 1
    register_launches += route.name == "cluster_registers"
    if _metrics.enabled():
        _ins.WHOLE_BOARD_LAUNCHES_TOTAL.labels(route.name).inc()
    return route


def reset_counts() -> None:
    global launches, plain_calls, cluster_launches, register_launches
    global history_launches, history_plain_calls
    launches = plain_calls = cluster_launches = register_launches = 0
    history_launches = history_plain_calls = 0


def _lines(shape: tuple[int, int], word_axis: int) -> tuple[int, int]:
    """``(P, Q)`` of a packed board: words per line (the packed axis) and
    lines (the other axis), as the cluster route cuts them."""
    return (shape[0], shape[1]) if word_axis == 0 else (shape[1], shape[0])


def register_warps(words: int, slots: int, lines: int) -> int:
    """Warps of the register loop's block for ``slots`` lines of ``words``
    words: stacks of ``lines`` lines, ``32 // words`` a warp; 0 where the
    line is wider than a warp or the block would pass ``REG_MAX_THREADS``
    (``REG_MAX_THREADS_WIDE`` for ``REG_LINES_WIDE`` lines a thread)."""
    if words > REG_MAX_WORDS or lines < 1:
        return 0
    warps = -(-slots // (32 // words * lines))
    limit = REG_MAX_THREADS if lines < REG_LINES_WIDE else REG_MAX_THREADS_WIDE
    return warps if 32 * warps <= limit else 0


def plan_lines(words: int, band: int, depth: int) -> int:
    """The register loop's lines a thread for bands of ``band`` lines of
    ``words`` words at halo depth ``depth``: ``REG_LINES``, or
    ``REG_LINES_WIDE`` where that block would pass ``REG_MAX_THREADS``; 0,
    the shared-memory loop, where neither fits."""
    for lines in (REG_LINES, REG_LINES_WIDE):
        if register_warps(words, band + 2 * depth, lines):
            return lines
    return 0


def cluster_plan(shape: tuple[int, int], word_axis: int = 0) -> Route:
    """The ``Route`` the kernel picks for one packed board of ``shape``:
    one block under ``MIN_CLUSTER_WORDS`` words, else the largest of
    ``MAX_CLUSTER``, ..., 4, 2 blocks that divides the lines into bands of
    at least ``MIN_BAND`` lines whose copies, halos of ``HALO_DEPTH``
    included, take no more shared memory than the whole board's, else one
    block. On a cluster, the register loop where ``plan_lines`` gives it
    lines, at depth ``REG_DEPTH``, else the shared-memory loop at depth
    ``HALO_DEPTH``; either depth clamped to the band."""
    words, lines = _lines(shape, word_axis)
    if words * lines >= MIN_CLUSTER_WORDS:
        cluster = MAX_CLUSTER
        while cluster > 1:
            band = lines // cluster
            if (lines % cluster == 0 and band >= MIN_BAND
                    and band + 2 * min(HALO_DEPTH, band) <= lines):
                per_thread = plan_lines(words, band, min(REG_DEPTH, band))
                if per_thread:
                    return Route(cluster, min(REG_DEPTH, band), per_thread)
                return Route(cluster, min(HALO_DEPTH, band))
            cluster //= 2
    return Route(1)


def bands(shape: tuple[int, int], word_axis: int, cluster: int) -> list[tuple[int, int]]:
    """``(first line, lines)`` of each block's band on a cluster of
    ``cluster`` blocks: block b holds the lines from ``b * Q / cluster``."""
    lines = _lines(shape, word_axis)[1]
    if lines % cluster:
        raise ValueError(f"{cluster} blocks do not divide {lines} lines")
    band = lines // cluster
    return [(b * band, band) for b in range(cluster)]


def phases(n: int, depth: int) -> list[int]:
    """The turns of each phase between two meetings of the cluster: ``depth``
    each, and a last, shorter one of ``n % depth``; one phase of all n on
    one block (``depth`` 0)."""
    if depth == 0:
        return [n] if n else []
    return [depth] * (n // depth) + ([n % depth] if n % depth else [])


def smem_bytes(shape: tuple[int, int]) -> int:
    """Shared memory the kernel needs for a packed board: two int32 copies."""
    return 2 * 4 * shape[0] * shape[1]


def smem_limit(device) -> int:
    """The opt-in shared memory of one block on ``device``, queried once
    per card; the H100's figure for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMEM_OPTIN
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SMEM_LIMIT:
        value = ctypes.c_int()
        _build.check(
            _lib().gol_max_smem_optin(index, ctypes.byref(value)),
            "cudaDeviceGetAttribute(MaxSharedMemoryPerBlockOptin)",
        )
        _SMEM_LIMIT[index] = value.value
    return _SMEM_LIMIT[index]


def fits(shape: tuple[int, int], device) -> bool:
    """Whether a packed board of ``shape`` fits one block on ``device``."""
    return smem_bytes(shape) <= smem_limit(device)


def check_launchable(packed: torch.Tensor, ndim: int, word_axis: int, what: str) -> None:
    """Raise unless the kernel takes ``packed``: a contiguous int32 CUDA
    tensor of ``ndim`` dimensions whose trailing two (one board) fit one
    block's shared memory."""
    if packed.device.type != "cuda":
        raise ValueError(f"no {what} for device {packed.device}")
    if packed.dtype != torch.int32 or packed.dim() != ndim or not packed.is_contiguous():
        raise ValueError(
            f"the {what} takes a contiguous {ndim}-D int32 bitboard tensor, got "
            f"{packed.dtype} {tuple(packed.shape)} contiguous={packed.is_contiguous()}"
        )
    if word_axis not in (0, 1):
        raise ValueError(f"word_axis must be 0 or 1, got {word_axis}")
    board = tuple(packed.shape[-2:])
    if not fits(board, packed.device):
        raise ValueError(
            f"packed board {board[0]}x{board[1]} needs {smem_bytes(board)} B of "
            f"shared memory, past the block's {smem_limit(packed.device)} B: "
            "it belongs to the tiled kernel"
        )


def step_n_plain(packed, n, word_axis=0, birth_mask=CONWAY_BIRTH_MASK,
                 survive_mask=CONWAY_SURVIVE_MASK):
    """The plain version of the counted kernel: ``(board after n turns,
    int32 row popcounts of it)``."""
    out = bit_step_n(packed, n, word_axis, birth_mask, survive_mask)
    return out, row_popcounts(out)


def step_n(
    packed: torch.Tensor,
    n: int,
    word_axis: int = 0,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    counted: bool = False,
    site: str = "pallas.vmem_bit",
):
    """n turns of an int32 bitboard ``[rows, cols]``; with ``counted`` also
    its ``int32[rows]`` row popcounts, as ``(board, counts)``. The input is
    never written. ``site`` is the telemetry site the one-block launch is
    timed under (obs/device.py); the route is the kernel's pick
    (``launch_one``)."""
    global plain_calls
    n = int(n)
    if n < 0:
        raise ValueError(f"turn count must be >= 0, got {n}")
    if packed.device.type == "cpu":
        plain_calls += 1
        started = _device.begin(packed.device)
        out, counts = step_n_plain(packed, n, word_axis, birth_mask, survive_mask)
        if started is not None:
            _device.end(site, packed.device, started, *bit_launch_cost(
                packed.numel(), n, birth_mask, survive_mask,
                4 * packed.shape[0] if counted else 0,
            ))
        return (out, counts) if counted else out
    check_launchable(packed, 2, word_axis, "whole-board kernel")
    rows = packed.shape[0]
    out = torch.empty_like(packed)
    counts = (
        torch.empty(rows, dtype=torch.int32, device=packed.device) if counted else None
    )
    launch_one(packed, out, counts, n, word_axis, birth_mask, survive_mask, site)
    return (out, counts) if counted else out


def history_plain(packed, n, word_axis=0, birth_mask=CONWAY_BIRTH_MASK,
                  survive_mask=CONWAY_SURVIVE_MASK) -> torch.Tensor:
    """The plain version of the history mode: ``bit_step`` and a popcount
    a turn, the alive counts after turns 1..n as ``int32[n]`` on the
    board's device."""
    return turn_counts(
        lambda p: bit_step(p, word_axis, birth_mask=birth_mask, survive_mask=survive_mask),
        packed, n)


def history(
    packed: torch.Tensor,
    n: int,
    word_axis: int = 0,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """The alive count of an int32 bitboard ``[rows, cols]`` after each of
    turns 1..n, as ``int32[n]`` on the board's device: one launch of the
    kernel's history mode on the card (none for n = 0), the plain version
    on the CPU. The input is never written."""
    global history_launches, history_plain_calls
    n = int(n)
    if n < 0:
        raise ValueError(f"turn count must be >= 0, got {n}")
    cost = history_cost(packed.numel(), n, birth_mask, survive_mask, 4 * n)
    if packed.device.type == "cpu":
        history_plain_calls += 1
        started = _device.begin(packed.device)
        counts = history_plain(packed, n, word_axis, birth_mask, survive_mask)
        if started is not None:
            _device.end(HISTORY_SITE, packed.device, started, *cost)
        return counts
    check_launchable(packed, 2, word_axis, "whole-board history kernel")
    counts = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n == 0:
        return counts
    out = torch.empty_like(packed)
    rows, cols = packed.shape
    common, dead_only, live_only = rule_masks(birth_mask, survive_mask)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream()
        started = _device.begin(packed.device, stream)
        err = _lib().gol_whole_board_history(
            packed.data_ptr(), out.data_ptr(), counts.data_ptr(), 1, rows, cols,
            word_axis, n, common, dead_only, live_only, stream.cuda_stream,
        )
        _build.check(err, "whole-board history kernel launch")
        if started is not None:
            _device.end(HISTORY_SITE, packed.device, started, *cost)
    history_launches += 1
    return counts


def history_cost(words: int, turns: int, birth_mask: int, survive_mask: int,
                 extra_bytes: int = 0) -> tuple[float, float]:
    """``(int32 operations, bytes)`` of the history mode's roofline bound:
    ``bit_launch_cost``'s turns plus one ``__popc`` and one add a word a
    turn, the board read once and written once plus ``extra_bytes`` (the
    counts)."""
    ops, nbytes = bit_launch_cost(words, turns, birth_mask, survive_mask, extra_bytes)
    return ops + 2.0 * words * turns, nbytes
