"""The batched bitboard step: n turns of B independent packed boards, each
in one thread block's shared memory, with every board's row popcounts, in
one launch (csrc/whole_board.cu, whose grid runs over the batch).

It replaces the JAX package's Pallas kernel K2,
``gol_distributed_final_tpu/ops/pallas_stencil.py:298``
(``bit_batch_pallas_call``, grid=(B,)) and, with ``counted=True``, the
per-universe popcount ``ops/fused.py:543``
(``_fused_batch_counted_compiled``) adds after it. It is K1's kernel with
``blockIdx.x`` selecting the universe (ops/whole_board.py launches the
same kernel with a batch of one), so K1 and K2 share one kernel body and
one gate, applied per universe. What bounds it on the card and how the
design meets that is written at the top of the CUDA source.

``step_n`` takes the plain version (``bit_step_n_batch`` plus batched row
popcounts) only for a tensor on the CPU. For a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..obs import device as _device
from . import whole_board
from .bitpack import bit_launch_cost, bit_step_n_batch, row_popcounts
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK

#: kernel launches made by ``step_n``; ``plain_calls`` counts the times it
#: took the plain version (CPU tensors) instead
launches = 0
plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def fits(shape: tuple[int, ...], device) -> bool:
    """Whether ONE universe of a packed batch ``[B, rows, cols]`` (or a
    board ``[rows, cols]``) fits a block on ``device``: the whole-board
    gate, per universe."""
    return whole_board.fits(tuple(shape[-2:]), device)


def step_n_plain(packed, n, word_axis=0, birth_mask=CONWAY_BIRTH_MASK,
                 survive_mask=CONWAY_SURVIVE_MASK):
    """The plain version of the counted kernel: ``(batch after n turns,
    int32[B, rows] row popcounts of it)``."""
    out = bit_step_n_batch(packed, n, word_axis, birth_mask, survive_mask)
    return out, row_popcounts(out)


def step_n(
    packed: torch.Tensor,
    n: int,
    word_axis: int = 0,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
    *,
    counted: bool = True,
    site: str = "pallas.vmem_bit_batch",
):
    """n turns of every universe of an int32 batch ``[B, rows, cols]``;
    with ``counted`` (the default) also their ``int32[B, rows]`` row
    popcounts, as ``(batch, counts)``. The input is never written.
    ``site`` is the telemetry site the launch is timed under."""
    global launches, plain_calls
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
                4 * packed.shape[0] * packed.shape[1] if counted else 0,
            ))
        return (out, counts) if counted else out
    whole_board.check_launchable(packed, 3, word_axis, "batched bitboard kernel")
    batch, rows, _ = packed.shape
    out = torch.empty_like(packed)
    counts = (
        torch.empty((batch, rows), dtype=torch.int32, device=packed.device)
        if counted else None
    )
    if batch:
        whole_board.launch(packed, out, counts, n, word_axis, birth_mask, survive_mask, site)
        launches += 1
    return (out, counts) if counted else out
