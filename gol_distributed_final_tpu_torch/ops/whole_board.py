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
line of at most 32 words, else the shared-memory loop. ``cluster_plan``
is the one place the route is chosen: the measured choice of blocks, halo
depth, loop and the register loop's block, which every launch hands the
library whole; the library runs it, and a cluster launch the card refuses
runs on one block instead. The batches of ``ops/batch_board.py`` and the
history mode stay on one block a board, on the library's own block plan.
The cluster route's launches are timed under their own site,
``CLUSTER_SITE``, and counted by route under
``gol_whole_board_launches_total{route}`` with metrics on: "block",
"cluster" or "cluster_registers"; a cluster launch's meetings (``meetings``)
under ``gol_whole_board_meetings_total{route}``.

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
import functools
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
#: took the plain version (CPU tensors) instead
launches = 0
plain_calls = 0

#: the cluster route's plan (``cluster_plan``). Measured on an H100
#: (chip_smoke.py --k1-sweep), a counted 4096-turn launch in ms, one block
#: against the plan's cluster in the shared-memory loop: 512^2 6.39 / 2.02
#: (16 blocks; 8: 2.45, 4: 3.30, 2: 4.43), 960^2 18.90 / 3.57 (16), 256^2
#: 2.37 / 1.42 (16), 224^2 2.75 / 1.37 (16, bands of 14 lines), 192^2 1.41
#: / 1.33 (16, bands of 12; 8: 1.36), 160^2 1.50 / 1.22 (8; 16, bands of
#: 10: 1.35), 128^2 0.95 / 1.14 (8): one block up to 128^2 (512 words), a
#: cluster from 160^2 (800 words), bands of 12 lines or more, at most 16
#: blocks (past the portable 8). Halo depths of 8 and 32 and about 256 or
#: 1024 runs a block were at best 1% faster than 16.
MAX_CLUSTER = 16
MIN_CLUSTER_WORDS = 768
MIN_BAND = 12
HALO_DEPTH = 16

#: the register loop's plan: the same clusters and depth, 4 lines a thread,
#: or 8 where that block would pass ``register_threads(4)``. Measured on an
#: H100 (chip_smoke.py --k1-sweep), a counted 4096-turn launch in ms, the
#: shared-memory loop against the register loop on the plan's cluster:
#: 512^2 2.03 / 1.00 (axis 1: 2.05 / 1.01; 8 lines a thread 0.97-1.02, 2
#: lines 1.19; depth 32 1.03-1.05, depth 8 1.31), 960^2 3.57 / 1.95 (8 lines
#: a thread), 640 x 384 2.19 / 1.29 (axis 1: 2.06 / 1.14), 256^2 1.40 /
#: 0.78, 224^2 1.35 / 0.86, 192^2 1.33 / 0.84, 160^2 1.23 / 0.81 (8 blocks).
#: 2 lines a thread was the better at 160^2 in one sweep and 30% the worse
#: in the next; 4 is the best or within 5% of it on every board. Since each
#: block meets only its two neighbours between phases (pushes into their
#: halo slots, a wait on its own mbarrier): 512^2 0.88 (axis 1: 0.89), 960^2
#: 1.87, 640 x 384 1.17 (axis 1: 1.00), 256^2 0.68, 224^2 0.75, 192^2 0.72,
#: 160^2 0.70 (8 blocks), each 4-15% under the cluster-wide meeting. The
#: depth stays 16 (the band where thinner): depths 8, 10, 12, 20, 24 and 32
#: were slower at 512^2 (12: 0.93), 960^2 and 256^2; 12 was 5% faster at
#: 640 x 384 in both packings and 20 3% at 160^2, which no rule by the band
#: separates from 512^2.
REG_LINES = (4, 8)

#: what the library compiles in (csrc/whole_board.cu), which the plan must
#: respect: a register loop's line on one warp's lanes (kRegMaxWords), its
#: lines a thread (the instantiations of R), and its largest block, which
#: leaves a thread up to 128 registers (kRegMaxThreads) and up to 168 with
#: 8 lines a thread (kRegMaxThreadsWide)
REG_MAX_WORDS = 32
REG_LINE_CHOICES = (2, 4, 8)
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
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.POINTER(ctypes.c_int),
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
    """A single board's route, all the library needs to launch it:
    ``blocks`` (1: one block), and on a cluster its halo ``depth``, its
    loop, ``lines`` a thread in the register loop or 0 for the
    shared-memory loop, and the register loop's ``warps`` a block."""

    blocks: int
    depth: int = 0
    lines: int = 0
    warps: int = 0

    @property
    def name(self) -> str:
        """The label of ``gol_whole_board_launches_total``."""
        if self.blocks == 1:
            return "block"
        return "cluster_registers" if self.lines else "cluster"


def launch_one(packed, out, counts, n, word_axis, birth_mask, survive_mask, site,
               route: Route | None = None) -> Route:
    """One launch for one contiguous int32 board ``[rows, cols]`` (the
    callers check it) on ``route``, ``cluster_plan``'s by default; a route
    given is how the routes are checked and timed against each other.
    Returns the route that ran: one block where the card refused the
    cluster. Raises on a refused launch, and on a route the library cannot
    run. With metrics on the launch is timed under ``site``, or
    ``CLUSTER_SITE`` on a cluster."""
    global launches
    rows, cols = packed.shape
    if route is None:
        route = cluster_plan((rows, cols), word_axis)
    common, dead_only, live_only = rule_masks(birth_mask, survive_mask)
    ran = (ctypes.c_int * 4)(*route)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream()
        started = _device.begin(packed.device, stream)
        err = _lib().gol_whole_board_step_as(
            packed.data_ptr(), out.data_ptr(), None if counts is None else counts.data_ptr(),
            rows, cols, word_axis, n, common, dead_only, live_only, ran, stream.cuda_stream,
        )
        _build.check(err, "whole-board kernel launch")
        route = Route(*ran)
        if started is not None:
            _device.end(CLUSTER_SITE if route.blocks > 1 else site, packed.device, started,
                        *bit_launch_cost(packed.numel(), n, birth_mask, survive_mask,
                                         0 if counts is None else 4 * rows))
    launches += 1
    if _metrics.enabled():
        _ins.WHOLE_BOARD_LAUNCHES_TOTAL.labels(route.name).inc()
        if route.blocks > 1:
            _ins.WHOLE_BOARD_MEETINGS_TOTAL.labels(route.name).inc(meetings(n, route.depth))
    return route


def reset_counts() -> None:
    global launches, plain_calls, history_launches, history_plain_calls
    launches = plain_calls = history_launches = history_plain_calls = 0


def _lines(shape: tuple[int, int], word_axis: int) -> tuple[int, int]:
    """``(P, Q)`` of a packed board: words per line (the packed axis) and
    lines (the other axis), as the cluster route cuts them."""
    return (shape[0], shape[1]) if word_axis == 0 else (shape[1], shape[0])


def register_threads(lines: int) -> int:
    """The register loop's largest block at ``lines`` lines a thread, the
    library's ``__launch_bounds__``."""
    return REG_MAX_THREADS if lines <= 4 else REG_MAX_THREADS_WIDE


def register_warps(words: int, slots: int, lines: int) -> int:
    """Warps of the register loop's block for ``slots`` lines of ``words``
    words: stacks of ``lines`` lines, ``32 // words`` a warp; 0 where the
    line is wider than a warp or the block would pass
    ``register_threads(lines)``."""
    if words > REG_MAX_WORDS or lines < 1:
        return 0
    warps = -(-slots // (32 // words * lines))
    return warps if 32 * warps <= register_threads(lines) else 0


def cluster_route(shape: tuple[int, int], word_axis: int, blocks: int, depth: int,
                  lines: int = 0) -> Route:
    """The route on a cluster of ``blocks`` blocks at halo ``depth``,
    clamped to the band, in the shared-memory loop (``lines`` 0) or the
    register loop at ``lines`` lines a thread, with the register loop's
    block: 0 warps where none holds the band and its halo, a route the
    library refuses."""
    words, total = _lines(shape, word_axis)
    band = total // blocks
    depth = min(depth, band)
    return Route(blocks, depth, lines, register_warps(words, band + 2 * depth, lines))


def loop_route(shape: tuple[int, int], word_axis: int, blocks: int,
               depth: int = HALO_DEPTH) -> Route:
    """The plan's loop on a cluster of ``blocks`` blocks at halo ``depth``:
    the register loop at the first of ``REG_LINES`` lines a thread whose
    block holds the band and its halo, else the shared-memory loop."""
    for lines in REG_LINES:
        route = cluster_route(shape, word_axis, blocks, depth, lines)
        if route.warps:
            return route
    return cluster_route(shape, word_axis, blocks, depth)


@functools.lru_cache(maxsize=None)
def cluster_plan(shape: tuple[int, int], word_axis: int = 0) -> Route:
    """The ``Route`` of one packed board of ``shape``, the only place it is
    chosen: one block under ``MIN_CLUSTER_WORDS`` words, else the largest of
    ``MAX_CLUSTER``, ..., 4, 2 blocks that divides the lines into bands of
    at least ``MIN_BAND`` lines whose copies, halos of ``HALO_DEPTH``
    included, take no more shared memory than the whole board's, in
    ``loop_route``'s loop, else one block. Memoised: a session's launches
    plan once."""
    words, lines = _lines(shape, word_axis)
    if words * lines >= MIN_CLUSTER_WORDS:
        cluster = MAX_CLUSTER
        while cluster > 1:
            band = lines // cluster
            if (lines % cluster == 0 and band >= MIN_BAND
                    and band + 2 * min(HALO_DEPTH, band) <= lines):
                return loop_route(shape, word_axis, cluster)
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


def meetings(n: int, depth: int) -> int:
    """The cluster's meetings in a launch of n turns at halo ``depth``: one
    between each two phases (``gol_whole_board_meetings_total``)."""
    return max(len(phases(n, depth)) - 1, 0)


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
    timed under (obs/device.py); the route is ``cluster_plan``'s
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
