"""Bit-packed Game of Life: 32 cells per int32 word, in torch ops.

The layout is the JAX package's, word for word: ``word_axis`` says which
spatial axis is packed into bits. ``word_axis=0`` packs rows (array
``[H/32, W]``), ``word_axis=1`` packs columns (``[H, W/32]``). Bit j of
word w along the packed axis is cell 32*w + j in either packing, so a
bitboard packed by either package loads unchanged into the other
(``state_from_numpy``; ``state.cpu().numpy()`` is the way back).

``bit_step`` is one turn: the three neighbours along the packed axis
collapse into a 2-bit sum (a full adder over bit-shifted words, with the
carry crossing word boundaries through the adjacent word — torus wrap
falls out of ``torch.roll`` being cyclic), then the three 2-bit sums along
the other axis add up to the 4-bitplane total T of the 3x3 neighbourhood
INCLUDING the cell, and the rule is a set of equality tests on T. It is
the plain version of the port's CUDA kernels (ops/whole_board.py,
ops/batch_board.py, ops/tiled.py), which compute the same words. A
leading batch axis steps each board on its own torus.

torch has no unsigned 32-bit shifts on the CPU and no popcount, so:

* right shifts are arithmetic on int32 and are masked back to logical
  ones (``>> 31`` keeps bit 0, ``>> 1`` clears bit 31);
* words are built in int64 and wrapped to int32 explicitly;
* popcounts are a SWAR sum on the words widened to int64, and alive
  totals fold in int64 so boards of 2^31 cells or more cannot overflow.

Reference equivalence: bit-exact with worker/worker.go:15-70 (held
against the JAX package's ``ops/bitpack.py`` in tests/test_torch_bitpack.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import device as _device
from ..utils.cell import Cell
from .stencil import CONWAY_BIRTH_MASK, CONWAY_SURVIVE_MASK, as_board

WORD = 32


def packed_shape(height: int, width: int, word_axis: int = 0) -> tuple[int, int]:
    """The packed-array shape of a ``height x width`` board."""
    if word_axis == 0:
        return height // WORD, width
    return height, width // WORD


def _wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 with the same 32 bits."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)


def pack(board, word_axis: int = 0, device=None) -> torch.Tensor:
    """uint8 {0,255} board ``[..., H, W]`` (numpy array or tensor) ->
    int32 bitboard on ``device`` (default: the board's own); leading axes
    are a batch of boards. The packed spatial axis must be divisible by
    32."""
    if isinstance(board, torch.Tensor):
        b = board
    else:  # a copy: the engine hands out read-only arrays
        b = torch.from_numpy(np.array(board, np.uint8))
    if device is not None:
        b = b.to(device)
    bits = (b != 0).to(torch.int64)
    *lead, h, w = bits.shape
    if word_axis == 1:
        if w % WORD:
            raise ValueError(f"width {w} not divisible by {WORD}")
        words, dim, wshape = bits.reshape(*lead, h, w // WORD, WORD), -1, (WORD,)
    else:
        if h % WORD:
            raise ValueError(f"height {h} not divisible by {WORD}")
        words, dim, wshape = bits.reshape(*lead, h // WORD, WORD, w), -2, (WORD, 1)
    weights = torch.tensor(
        [1 << j for j in range(WORD)], dtype=torch.int64, device=bits.device
    ).reshape(wshape)
    return _wrap_int32((words * weights).sum(dim=dim))


def unpack(packed: torch.Tensor, word_axis: int = 0) -> torch.Tensor:
    """int32 bitboard ``[..., rows, cols]`` -> uint8 {0,255} board on the
    same device. ``>> j`` then ``& 1`` reads bit j whether the shift is
    arithmetic or not."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    *lead, rows, cols = packed.shape
    if word_axis == 1:
        bits = (packed[..., None] >> shifts) & 1
        board = bits.reshape(*lead, rows, cols * WORD)
    else:
        bits = (packed[..., None, :] >> shifts[:, None]) & 1
        board = bits.reshape(*lead, rows * WORD, cols)
    return (board * 255).to(torch.uint8)


def _require_batch(t, what: str):
    if t.ndim != 3:
        raise ValueError(f"{what} must be [B, ...] with 3 axes, got {tuple(t.shape)}")
    return t


def pack_batch(boards, word_axis: int = 0, device=None) -> torch.Tensor:
    """uint8 {0,255} ``[B, H, W]`` (numpy array or tensor) -> int32
    bitboards ``[B, H/32, W]`` (word_axis 0) or ``[B, H, W/32]``: every
    universe of a session batch in one pass (the JAX package's
    ``pack_device_batch``)."""
    if not isinstance(boards, torch.Tensor):
        boards = np.asarray(boards, np.uint8)
    return pack(_require_batch(boards, "batch boards"), word_axis, device)


def unpack_batch(packed: torch.Tensor, word_axis: int = 0) -> torch.Tensor:
    """int32 ``[B, ...]`` bitboards -> uint8 ``[B, H, W]`` on the same
    device (the JAX package's ``unpack_device_batch``)."""
    return unpack(_require_batch(packed, "packed batch"), word_axis)


def state_from_numpy(packed: np.ndarray, device) -> torch.Tensor:
    """A packed bitboard from numpy (int32 or uint32 words, e.g.
    ``np.asarray`` of the JAX package's ``pack``) as a port state on
    ``device``."""
    arr = np.ascontiguousarray(packed)
    if arr.dtype not in (np.int32, np.uint32):
        raise ValueError(f"packed words must be int32 or uint32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count as int64 (a SWAR sum on the 32 bits
    widened to int64, so no intermediate overflows)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def row_popcounts(packed: torch.Tensor) -> torch.Tensor:
    """Alive cells per packed row as ``int32[..., rows]`` (a row covers at
    most 32 * W cells, so int32 holds it); totals fold in int64."""
    return popcount(packed).sum(dim=-1).to(torch.int32)


def alive_count_packed(packed) -> int:
    """Alive cells of a bitboard: a popcount reduction on its device, no
    unpack. A mesh-sharded bitboard (parallel/mesh.ShardedBoard) sums its
    local blocks; one sharded over several processes all-gathers each
    rank's int64 total, so every rank returns the global count."""
    blocks = getattr(packed, "blocks", None)
    if blocks is None:
        return int(popcount(packed).sum())
    local = sum(int(popcount(b).sum()) for b in blocks.values())
    if packed.is_fully_addressable:
        return local
    from ..parallel.multihost import allgather

    return int(allgather(np.array([local], np.int64)).sum(dtype=np.int64))


def alive_cells_packed(packed: torch.Tensor, word_axis: int = 0) -> list[Cell]:
    """``Cell(x, y)`` list straight from a bitboard, row-major like the
    reference's nested loop (broker/broker.go:47-58). Only the packed rows
    with a live cell leave the device and unpack."""
    pc = row_popcounts(packed).cpu().numpy()
    nz = np.nonzero(pc)[0]
    if nz.size == 0:
        return []
    rows = torch.as_tensor(nz, device=packed.device)
    board = unpack(packed.index_select(0, rows), word_axis).cpu().numpy()
    ys, xs = np.nonzero(board)
    if word_axis == 0:
        ys = nz[ys // WORD] * WORD + ys % WORD
    else:
        ys = nz[ys]
    return [Cell(int(x), int(y)) for x, y in zip(xs, ys)]


def _full_adder3(a, b, c):
    """Bitplane sum of three 1-bit values: (parity, carry)."""
    axb = a ^ b
    return axb ^ c, (a & b) | (c & axb)


def _rule_planes(birth_mask: int, survive_mask: int):
    """T-value sets for a B/S rule, where T = 3x3 sum INCLUDING the cell.

    A dead cell has T = neighbours, a live cell T = neighbours + 1, so:
    dead next-alive iff T in birth; live next-alive iff (T-1) in survive.
    """
    dead_ts = [t for t in range(9) if birth_mask >> t & 1]
    live_ts = [t + 1 for t in range(9) if survive_mask >> t & 1]
    return dead_ts, live_ts


def rule_sets(birth_mask: int, survive_mask: int):
    """The rule as (common, dead_only, live_only) sets of T values: next
    alive iff T in common, or T in dead_only for a dead cell, or T in
    live_only for a live one. Shared by ``bit_step`` and the masks the
    CUDA kernels take (bit t of each mask = T value t)."""
    dead_ts, live_ts = _rule_planes(birth_mask, survive_mask)
    common = sorted(set(dead_ts) & set(live_ts))
    dead_only = [t for t in dead_ts if t not in common]
    live_only = [t for t in live_ts if t not in common]
    return common, dead_only, live_only


def rule_masks(birth_mask: int, survive_mask: int) -> tuple[int, int, int]:
    """``rule_sets`` as the (common, dead_only, live_only) bit masks the
    CUDA kernels take (csrc/bit_step.cuh::GolRule)."""
    return tuple(
        sum(1 << t for t in ts) for ts in rule_sets(birth_mask, survive_mask)
    )


#: the rules the bitboard kernels compile in (csrc/bit_step.cuh,
#: GOL_COMPILED_RULES), by name, as ``rule_masks`` triples: the rules of
#: models/life.py. Any other rule runs the kernels' run-time-rule
#: instantiation.
COMPILED_RULES = {
    "conway": (8, 0, 16),
    "highlife": (8, 64, 16),
    "seeds": (0, 4, 0),
    "day-and-night": (384, 72, 560),
}


def is_compiled_rule(birth_mask: int, survive_mask: int) -> bool:
    """Whether the bitboard kernels run this rule with its select fixed at
    compile time."""
    return rule_masks(birth_mask, survive_mask) in COMPILED_RULES.values()


def _skips_p3(value: int) -> bool:
    # the weight-8 plane only separates T in {8, 9} from {0, 1}: for a
    # target in 2..7 the aliasing value (target + 8 > 9) is unreachable
    return 2 <= value <= 7


def bit_step(
    packed: torch.Tensor,
    word_axis: int = 0,
    *,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """One life-like turn on an int32 bitboard ``[..., rows, cols]`` (a
    leading batch of boards steps each one on its own torus)."""
    pdim, edim = (-2, -1) if word_axis == 0 else (-1, -2)
    mid = packed

    # neighbours along the PACKED axis: bit shifts, carries crossing word
    # boundaries through the adjacent word (cyclic => torus wrap); the
    # masks turn torch's arithmetic right shifts into logical ones
    minus = (mid << 1) | ((torch.roll(mid, 1, pdim) >> 31) & 1)
    plus = ((mid >> 1) & 0x7FFFFFFF) | (torch.roll(mid, -1, pdim) << 31)
    v0, v1 = _full_adder3(minus, mid, plus)

    # triple sum along the other axis: T = v(-1) + v + v(+1), 4 bitplanes
    a_s, a_c = _full_adder3(torch.roll(v0, 1, edim), v0, torch.roll(v0, -1, edim))
    b_s, b_c = _full_adder3(torch.roll(v1, 1, edim), v1, torch.roll(v1, -1, edim))
    c_s = a_c ^ b_s  # weight-2 plane of T
    c_c = a_c & b_s  # weight-4 carry
    t2 = b_c ^ c_c  # weight-4 plane
    t3 = b_c & c_c  # weight-8 plane
    planes = (a_s, c_s, t2, t3)  # T = p0 + 2*p1 + 4*p2 + 8*p3, T in 0..9

    def eq(value: int):
        acc = None
        for bit, plane in enumerate(planes):
            if bit == 3 and _skips_p3(value):
                continue
            term = plane if value >> bit & 1 else ~plane
            acc = term if acc is None else acc & term
        return acc

    def any_eq(values):
        acc = None
        for v in values:
            acc = eq(v) if acc is None else acc | eq(v)
        return acc

    # with C = common, D = dead-only, L = live-only T values the select
    # is C | (~mid & D) | (mid & L) — for Conway eq(3) | (mid & eq(4))
    common, dead_only, live_only = rule_sets(birth_mask, survive_mask)
    terms = []
    if common:
        terms.append(any_eq(common))
    if dead_only:
        terms.append(~mid & any_eq(dead_only))
    if live_only:
        terms.append(mid & any_eq(live_only))
    if not terms:
        return torch.zeros_like(packed)
    out = terms[0]
    for t in terms[1:]:
        out = out | t
    return out


def bit_step_n(
    packed: torch.Tensor,
    n: int,
    word_axis: int = 0,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """n turns on the bitboard."""
    for _ in range(int(n)):
        packed = bit_step(
            packed, word_axis, birth_mask=birth_mask, survive_mask=survive_mask
        )
    return packed


def bit_step_n_batch(
    packed: torch.Tensor,
    n: int,
    word_axis: int = 0,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> torch.Tensor:
    """n turns over a batch of independent bitboards ``int32[B, rows,
    cols]``, each on its own torus (``bit_step`` rolls only the trailing
    two axes): the plain version of the batched kernel
    (ops/batch_board.py)."""
    return bit_step_n(
        _require_batch(packed, "packed batch"), n, word_axis, birth_mask, survive_mask
    )


def alive_count_packed_batch(packed: torch.Tensor) -> np.ndarray:
    """Per-universe alive counts of ``int32[B, rows, cols]`` as
    ``np.int64[B]``: one popcount reduction to ``int32[B, rows]`` on the
    device, then a host int64 fold."""
    pc = row_popcounts(_require_batch(packed, "packed batch")).cpu().numpy()
    return pc.sum(axis=1, dtype=np.int64)


def turn_counts(step, packed: torch.Tensor, n: int) -> torch.Tensor:
    """The alive count of a bitboard after each of n ``step(packed)``
    turns, as ``int32[n]`` on its device: the popcounts sum in int64 on the
    device and nothing is read back."""
    counts = []
    for _ in range(int(n)):
        packed = step(packed)
        counts.append(popcount(packed).sum())
    if not counts:
        return torch.zeros(0, dtype=torch.int32, device=packed.device)
    return torch.stack(counts).to(torch.int32)


def alive_history(
    packed: torch.Tensor,
    n: int,
    word_axis: int = 0,
    birth_mask: int = CONWAY_BIRTH_MASK,
    survive_mask: int = CONWAY_SURVIVE_MASK,
) -> np.ndarray:
    """The alive count after each of turns 1..n as ``np.int32[n]``, with
    one read-back: the JAX package's function of this name (a ``lax.scan``
    of ``bit_step`` and a popcount). Under the whole-board gate it is one
    launch of that kernel's history mode (ops/whole_board.py::history).
    Past it, one tiled launch a turn (ops/tiled.py), each turn's popcount
    summed in int64 into a tensor on the board's device. A CPU board takes
    the plain versions of both by the same gate."""
    from . import tiled, whole_board

    n = int(n)
    if n < 0:
        raise ValueError(f"turn count must be >= 0, got {n}")
    if whole_board.fits(tuple(packed.shape), packed.device):
        counts = whole_board.history(packed, n, word_axis, birth_mask, survive_mask)
    else:
        counts = turn_counts(
            lambda p: tiled.step_n(p, 1, word_axis, birth_mask, survive_mask), packed, n)
    return counts.cpu().numpy()


def ops_per_word(birth_mask: int, survive_mask: int) -> int:
    """The int32 instructions ``bit_step``'s chain comes to on a Hopper SM
    for one word and one turn under this rule, each step merged as far as
    the instruction set allows: the operation count of the roofline
    bound. On sm_90 any logic function of three words is one
    LOP3 (inversions included) and a shift that takes its carry from the
    adjacent word is one SHF funnel shift; the rotates are loads of the
    neighbouring words, not arithmetic. So:

    * 2 SHF for the packed-axis neighbours and 2 LOP3 (parity, majority)
      for their full adder, once per word: the other axis reuses them;
    * 4 LOP3 for the two full adders across the other axis;
    * 1 LOP3 for each T plane above the weight-1 one that the rule reads
      (the weight-8 plane only when it tests T = 0, 1, 8 or 9);
    * the select, a function of those planes and, when the rule tells a
      dead cell from a live one, the cell: with i distinct inputs it takes
      at least ceil((i - 1) / 2) three-input LOP3s.

    Conway costs 12: 2 + 2 + 4, 2 planes, and a select of 4 inputs in 2.
    The CUDA kernels add a word's loads, its store and their loop
    (csrc/bit_step.cuh)."""
    common, dead_only, live_only = rule_sets(birth_mask, survive_mask)
    values = common + dead_only + live_only
    if not values:
        return 0  # no T value survives: the next board is empty
    planes = 3 if any(not _skips_p3(v) for v in values) else 2
    inputs = 1 + planes + (1 if dead_only or live_only else 0)
    return 2 + 2 + 4 + planes + inputs // 2  # inputs // 2 == ceil((inputs - 1) / 2)


#: int32 instructions to pack one byte cell into a bitboard word, and as
#: many to unpack it: a mask and a multiply gather a register's four bytes
#: into four bits, and a shift and a merge place them in the word (the
#: reverse likewise), four instructions per four cells each way
PACK_OPS_PER_CELL = 1


def byte_ops_per_cell(birth_mask: int, survive_mask: int, turns: int) -> float:
    """The int32 instructions per cell of ``turns`` turns of a byte board
    that arrives and leaves as bytes, in the function's cheapest form on a
    Hopper SM: pack it once, step the bitboard (``ops_per_word`` per 32
    cells per turn), unpack it once. The operation count of the byte
    kernels' roofline bound (ops/byte_board.py, ops/byte_tiled.py), however
    those kernels compute: their byte arithmetic is not the cheapest form.
    Conway at 100 turns costs 100 * 12 / 32 + 2 = 39.5. A rule that neither
    births nor keeps a cell costs 0: the next board is empty."""
    per_word = ops_per_word(birth_mask, survive_mask)
    if not per_word:
        return 0
    return turns * per_word / WORD + 2 * PACK_OPS_PER_CELL


def bit_launch_cost(words: int, turns: int, birth_mask: int, survive_mask: int,
                    extra_bytes: int = 0) -> tuple[float, float]:
    """``(int32 operations, bytes)`` of the roofline bound of ``turns``
    turns on ``words`` int32 words: ``ops_per_word`` a word a turn, and the
    words read once and written once plus ``extra_bytes`` of other outputs
    (row counts). What obs/device.py adds to a kernel site per launch."""
    return (float(turns * words * ops_per_word(birth_mask, survive_mask)),
            float(2 * 4 * words + extra_bytes))


def byte_launch_cost(cells: int, turns: int, birth_mask: int, survive_mask: int,
                     extra_bytes: int = 0) -> tuple[float, float]:
    """``(int32 operations, bytes)`` of the roofline bound of ``turns``
    turns of a byte board of ``cells`` cells (``byte_ops_per_cell``), its
    bytes read once and written once plus ``extra_bytes``."""
    return (float(cells * byte_ops_per_cell(birth_mask, survive_mask, turns)),
            float(2 * cells + extra_bytes))


def packed_step_n_fn(word_axis: int = 0, rule=None, *, device=None):
    """An engine step function ``(board_uint8, n) -> board_uint8``: pack,
    n turns of ``bit_step_n`` in torch ops, unpack, all on the board's
    device (the JAX package leaves this form to XLA). A numpy board goes
    to ``device``, the card unless the caller names another."""
    birth = rule.birth_mask if rule else CONWAY_BIRTH_MASK
    survive = rule.survive_mask if rule else CONWAY_SURVIVE_MASK

    def step_n(board, n):
        packed = pack(as_board(board, device), word_axis)
        # the torch ops' device time under the JAX package's XLA site
        started = _device.begin(packed.device)
        out = bit_step_n(packed, int(n), word_axis, birth, survive)
        if started is not None:
            _device.end("bitpack.xla_step", packed.device, started,
                        *bit_launch_cost(packed.numel(), int(n), birth, survive))
        return unpack(out, word_axis)

    return step_n
