"""The roofline yardstick: the least time one H100 could take for the
sessions a window completed, whatever kernels the program runs.

A turn of a life-like rule on a bitboard of 32-cell words costs a fixed
count of int32 instructions a word (Conway: 12, one LOP3 for each logic
step of up to three words and one SHF for each cross-word shift, the
count ``ops/bitpack.py::ops_per_word`` gave when this was written). The
count is a yardstick frozen here, not a property of any kernel: the bound
stays the same whatever a later kernel does. A session's board is read
once and written once, packed (H x W / 8 bytes each way).

Peaks of the H100 SXM at its 700 W limit: int32 64 a clock an SM (CUDA C++
Programming Guide, compute capability 9.0) x 132 SMs x 1980 MHz = 1.673e13
a second; HBM3 3.35e12 bytes a second (NVIDIA's data sheet).
"""

from __future__ import annotations

INT32_PER_S = 1.673e13
HBM_BYTES_PER_S = 3.35e12
#: int32 instructions for one 32-cell word and one turn, by rule
OPS_PER_WORD = {"B3/S23": 12}


def bound_s(turns_done, cells: int, rulestring: str) -> float | None:
    """The larger of the operations bound and the bytes bound of sessions
    of ``cells`` cells that did ``turns_done`` turns each, in s; None for a
    rule the table does not hold."""
    per_word = OPS_PER_WORD.get(rulestring.upper())
    if per_word is None:
        return None
    turns_done = list(turns_done)
    ops = sum(turns_done) * cells / 32 * per_word
    data = len(turns_done) * 2 * cells / 8
    return max(ops / INT32_PER_S, data / HBM_BYTES_PER_S)
