"""The whole-board byte step: n turns of a uint8 {0, 255} board held on
chip, in one launch (csrc/byte_board.cu).

It replaces the JAX package's Pallas kernel K5,
``gol_distributed_final_tpu/ops/pallas_stencil.py:125``
(``byte_pallas_call``, body ``_kernel`` :115, turn ``byte_turn_fn``
:91-112). What bounds it on the card and how the design meets that is
written at the top of the CUDA source.

The kernel has two forms, chosen by shape (``form``): where an axis is a
multiple of 32 the board is packed as it is loaded and steps as a bitboard
in the shared memory of a thread block cluster of 1, 2, 4 or 8 blocks
(``cluster_size``), columns packed if W % 32 == 0, else rows; any other
board (16^2, 24 x 33) steps as bytes in one block. ``launch_plan`` is the
one place a launch's form, cluster and halo depth are chosen; every launch
hands the library all three.

The gate (``fits``) is the port's own: the form's shared memory must fit
the block's opt-in limit, and the board must hold at most ``MAX_CELLS``
cells. That limit is measured (PERF.md has the table): n turns in one
launch of this kernel against the same turns on the byte tiles
(ops/byte_tiled.py) at their better setting, 32 turns a launch, by device
time, which repeats from run to run where the host's share of a call does
not. A cluster is 8 SMs of 132 and meets at a barrier every turn, and the
tiles' launch of 32 turns costs a small board the same 0.011 ms whatever
its size, so the tiles overtake early: at 192^2 the two are level for
n >= 32, at 224^2 the tiles are ahead, at 512^2 by 1.6x. So a 512^2 byte
board runs on the byte tiles here where the JAX package keeps it on K5
(its gate, ``fits_vmem(shape, 4)``, is a v5e working-set estimate of up to
419,430 cells): past the gate ``ops/fused.fused_step_n`` and
``ops/pallas_stencil.pallas_step_n_fn`` send a board to the byte tiles. The
boards are equal either way. The byte form steps bytes, ~13x the bit form's
instructions, and is behind the tiles in device time at every size
measured (1.3x at 16^2, 4.2x at 100^2), so it keeps only boards under
``MAX_BYTE_FORM_CELLS``, where its one launch for all n turns still costs
the caller less than the tiles' several. ``form=`` and ``cluster=`` force
a launch past the size limits, which is how the larger boards are timed
and checked.

``step_n`` takes the plain version (the roll stencil, ops/stencil.py)
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import device as _device
from . import _build, _tiles, whole_board
from .bitpack import WORD, byte_launch_cost
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK
from .stencil import step_n as stencil_step_n

#: the forms of the kernel, by the C entry point's number for each
FORMS = ("bits-cols", "bits-rows", "bytes")

#: the gate's size limit, in cells: the largest board measured on an H100
#: for which one launch of n >= 32 turns here takes no more device time than
#: the byte tiles' launches of 32 turns (level at 192^2, behind at 224^2;
#: PERF.md)
MAX_CELLS = 192 * 192

#: the byte form's own size limit, in cells: 16^2 and 24 x 33 stay on it
#: (measured at 16^2 on an H100: one launch of 100 turns costs a caller
#: 0.057 ms by events against 0.09 for the tiles' four), 100^2 does not
#: (0.174 ms of device time against 0.041; PERF.md)
MAX_BYTE_FORM_CELLS = 32 * 32

#: the largest cluster chosen (the portable limit), and the least words of
#: a board that takes one. Measured on an H100: up to 128^2 (512 words) one
#: block beats every cluster, from 160^2 (800 words) on eight blocks beat
#: one, and at 256^2 and 512^2 also four and two (PERF.md)
MAX_CLUSTER = 8
MIN_CLUSTER_WORDS = 768

#: turns between two exchanges of halo lines in a cluster: each block's band
#: carries that many halo lines on each side, at most the band
HALO_DEPTH = 16

#: kernel launches made; ``plain_calls`` counts the launches that the plain
#: version stood in for (CPU tensors) instead
launches = 0
plain_calls = 0

_SIGNATURES = {
    "gol_byte_board_step_as": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
}
_entry = None  # the library's gol_byte_board_step_as, resolved at its first launch


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def form(shape: tuple[int, int]) -> str:
    """The form a board of ``shape`` steps in: ``bits-cols`` (columns
    packed) where W % 32 == 0, else ``bits-rows`` where H % 32 == 0, else
    ``bytes``. The packed axis must close on itself, hence the multiples."""
    if shape[1] % WORD == 0:
        return "bits-cols"
    return "bits-rows" if shape[0] % WORD == 0 else "bytes"


def _lines(shape, how: str) -> tuple[int, int]:
    """``(P, Q)``: words per line and lines of the packed board."""
    if how == "bits-rows":
        return shape[0] // WORD, shape[1]
    return shape[1] // WORD, shape[0]


def cluster_size(shape: tuple[int, int], how: str | None = None) -> int:
    """Blocks in the cluster a board steps on: 1 for the byte form and for
    a board under ``MIN_CLUSTER_WORDS`` packed words, else the largest of 8,
    4, 2 that divides its lines."""
    how = form(shape) if how is None else how
    if how == "bytes":
        return 1
    words, lines = _lines(shape, how)
    if words * lines < MIN_CLUSTER_WORDS:
        return 1
    cluster = MAX_CLUSTER
    while cluster > 1 and lines % cluster:
        cluster //= 2
    return cluster


def launch_plan(shape: tuple[int, int], how: str | None = None,
                cluster: int | None = None) -> tuple[str, int, int]:
    """``(form, blocks, halo depth)`` of a launch on a board of ``shape``,
    the one plan the gate and the launch read: ``form``'s form and
    ``cluster_size``'s cluster unless ``how`` and ``cluster`` force them, and
    on a cluster ``HALO_DEPTH`` halo lines, at most the band; none on one
    block, which holds the whole torus, or in the byte form."""
    how = form(shape) if how is None else how
    cluster = cluster_size(shape, how) if cluster is None else cluster
    if how == "bytes" or cluster == 1:
        return how, cluster, 0
    return how, cluster, min(HALO_DEPTH, _lines(shape, how)[1] // cluster)


def smem_bytes(shape: tuple[int, int], how: str | None = None, cluster: int | None = None) -> int:
    """Shared memory one block needs on ``launch_plan``'s launch. The bit
    form: two copies of its band of lines and their halo lines. The byte
    form: two uint8 copies of the board."""
    how, cluster, depth = launch_plan(shape, how, cluster)
    if how == "bytes":
        return 2 * shape[0] * shape[1]
    words, lines = _lines(shape, how)
    return 4 * 2 * (lines // cluster + 2 * depth) * words


def fits(shape: tuple[int, ...], device) -> bool:
    """Whether the kernel takes a 2-D byte board of ``shape`` on ``device``:
    at most ``MAX_CELLS`` cells (``MAX_BYTE_FORM_CELLS`` in the byte form),
    in shared memory that fits a block (the opt-in limit the card reports,
    the H100's for the CPU). The single predicate the step functions route
    on."""
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        return False
    most = MAX_BYTE_FORM_CELLS if form(shape) == "bytes" else MAX_CELLS
    return shape[0] * shape[1] <= most and smem_bytes(shape) <= whole_board.smem_limit(device)


def step_n_plain(board, n, birth_mask=CONWAY_BIRTH_MASK, survive_mask=CONWAY_SURVIVE_MASK):
    """The plain version of the kernel: n turns of the roll stencil."""
    return stencil_step_n(board, n, birth_mask=birth_mask, survive_mask=survive_mask)


def step_sizes(
    board: torch.Tensor,
    sizes,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    form: str | None = None,
    cluster: int | None = None,
    site: str = "pallas.vmem_byte",
) -> torch.Tensor:
    """One launch of n turns for each n >= 1 of ``sizes``, the board of each
    the result of the one before, with the scratch boards, the device and
    the stream taken once for them all: a whole ladder in one call, on
    ``launch_plan``'s launch. ``form`` (one of ``FORMS``) and ``cluster``
    force what it otherwise plans by shape; a launch the card refuses
    raises. The input is never written. ``site`` is the telemetry site each
    launch is timed under (obs/device.py)."""
    global plain_calls, _entry
    sizes = [int(n) for n in sizes]
    if any(n < 1 for n in sizes):
        raise ValueError(f"a launch takes >= 1 turns, got {sizes}")
    cells = board.numel()
    if board.device.type == "cpu":
        plain_calls += len(sizes)
        for n in sizes:
            started = _device.begin(board.device)
            board = step_n_plain(board, n, birth_mask, survive_mask)
            if started is not None:
                _device.end(site, board.device, started,
                            *byte_launch_cost(cells, n, birth_mask, survive_mask))
        return board
    if board.device.type != "cuda":
        raise ValueError(f"no whole-board byte kernel for device {board.device}")
    if board.dtype != torch.uint8 or board.dim() != 2 or not board.is_contiguous():
        raise ValueError(
            "the whole-board byte kernel takes a contiguous 2-D uint8 board, got "
            f"{board.dtype} {tuple(board.shape)} contiguous={board.is_contiguous()}"
        )
    shape = tuple(board.shape)
    if form is None and cluster is None and not fits(shape, board.device):
        raise ValueError(
            f"byte board {shape[0]}x{shape[1]} is past the whole-board byte kernel's gate "
            f"({MAX_CELLS} cells, {MAX_BYTE_FORM_CELLS} in the byte form; "
            f"{smem_bytes(shape)} B of the block's "
            f"{whole_board.smem_limit(board.device)} B of shared memory): it belongs to "
            "the byte tiles"
        )
    if form is not None and form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if cluster is not None and int(cluster) < 1:
        raise ValueError(f"a cluster has >= 1 blocks, got {cluster}")
    how, blocks, depth = launch_plan(shape, form, None if cluster is None else int(cluster))
    which = FORMS.index(how)
    if _entry is None:
        _entry = _build.load("byte_board", _SIGNATURES).gol_byte_board_step_as
    entry = _entry
    timing = _device.timing_stream(board.device)

    def launch(src, dst, n, stream):
        global launches
        started = _device.begin(src.device, timing)
        err = entry(src.data_ptr(), dst.data_ptr(), shape[0], shape[1], n, birth_mask,
                    survive_mask, which, blocks, depth, stream)
        if err:
            _build.check(err, "whole-board byte kernel launch")
        launches += 1
        if started is not None:
            _device.end(site, src.device, started,
                        *byte_launch_cost(cells, n, birth_mask, survive_mask))

    return _tiles.ping_pong(board, sizes, launch)


def step_n(
    board: torch.Tensor,
    n: int,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    form: str | None = None,
    cluster: int | None = None,
    site: str = "pallas.vmem_byte",
) -> torch.Tensor:
    """n turns of a uint8 board ``[H, W]`` (any nonzero cell is alive; the
    result holds 0 and 255) in one launch. n = 0 returns a copy and
    launches nothing. The input is never written."""
    n = int(n)
    if n < 0:
        raise ValueError(f"turn count must be >= 0, got {n}")
    if n == 0:
        return board.clone()
    return step_sizes(board, [n], birth_mask, survive_mask, form=form, cluster=cluster,
                      site=site)
