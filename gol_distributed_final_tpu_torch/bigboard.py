"""Big boards that never exist as bytes: BASELINE config 5, a 65536^2 board
seeded with an R-pentomino (BASELINE.md:33).

As a byte raster that board is 4 GiB, and the reference holds it whole in
the controller, the broker and every worker (SURVEY.md §5). Here it exists
only as the int32 bitboard on the card (512 MiB), is seeded from cell
coordinates, steps on ``ops/plane.BitPlane`` (far past the whole-board
kernel's gate, so on the tiled kernel, csrc/tiled.cu, 8 turns a launch),
and reaches disk as a stream of unpacked row blocks written in place
(io/sharded.py). The byte board never exists on the host or the card:

    state = seed_packed(65536, r_pentomino(65536))   # 512 MiB, on the card
    state = BitPlane().step_n(state, turns)          # the tiled kernel
    stream_packed_to_pgm(path, state, row_block=1024)

Reading streams the same way (``load_packed_from_pgm``): row blocks are
packed on the card one by one. A board of 65536^2 cells has 2^32 of them,
past int32, so every cell index here is int64.

Run it with ``python -m gol_distributed_final_tpu_torch.bigboard -size N
-turns T [-out PATH] [-in PATH] [-row-block R] [-rule B.../S...]
[-session] [-device cpu]``; it computes on the card unless ``-device``
says otherwise, and ``-out ''`` writes no PGM.
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models import CONWAY, LifeRule
from .ops.bitpack import WORD, alive_count_packed, pack, packed_shape, unpack
from .ops.plane import BitPlane

Cells = Iterable[Tuple[int, int]]  # (x, y) pairs


def r_pentomino(size: int) -> list[tuple[int, int]]:
    """The classic methuselah, centred: the BASELINE config-5 seed."""
    cx = cy = size // 2
    offsets = [(1, 0), (2, 0), (0, 1), (1, 1), (1, 2)]
    return [(cx + dx, cy + dy) for dx, dy in offsets]


def seed_packed(
    size: int,
    cells: Cells,
    word_axis: int = 0,
    row_range: tuple[int, int] | None = None,
    device=None,
) -> torch.Tensor:
    """A packed bitboard on ``device`` (the card unless named) with only
    ``cells`` alive.

    Built from the coordinates alone: each live word is ORed together on
    the host (O(len(cells))), and the words are scattered into zeros on the
    device, so neither the byte board nor the packed one exists on the
    host.

    ``row_range=(lo, hi)`` builds only the packed rows covering cell rows
    [lo, hi), for a process that seeds only the rows it owns. Cells outside
    the range are skipped after the board's bounds are checked. For
    ``word_axis=0``, lo and hi must be word-aligned."""
    if size % WORD:
        raise ValueError(f"size {size} not divisible by {WORD}")
    lo, hi = (0, size) if row_range is None else row_range
    if not (0 <= lo < hi <= size):
        raise ValueError(f"row_range {row_range} outside [0, {size})")
    if word_axis == 0 and (lo % WORD or hi % WORD):
        raise ValueError(f"row_range {row_range} must be word-aligned for word_axis=0")
    shape = packed_shape(hi - lo, size, word_axis)
    rows, cols, bits = [], [], []
    for x, y in cells:
        if not (0 <= x < size and 0 <= y < size):
            raise ValueError(f"cell ({x}, {y}) outside {size}x{size}")
        if not (lo <= y < hi):
            continue
        if word_axis == 0:
            rows.append((y - lo) // WORD)
            cols.append(x)
            bits.append(y % WORD)
        else:
            rows.append(y - lo)
            cols.append(x // WORD)
            bits.append(x % WORD)
    state = torch.zeros(shape, dtype=torch.int32, device=resolve_device(device))
    if rows:
        # one word per distinct (row, col), its bits ORed on the host
        flat = np.asarray(rows, np.int64) * shape[1] + np.asarray(cols, np.int64)
        masks = np.uint32(1) << np.asarray(bits, np.uint32)
        order = np.argsort(flat, kind="stable")
        flat, masks = flat[order], masks[order]
        words, starts = np.unique(flat, return_index=True)
        values = np.bitwise_or.reduceat(masks, starts).view(np.int32)
        state.view(-1)[torch.from_numpy(words).to(state.device)] = (
            torch.from_numpy(values).to(state.device)
        )
    return state


def _board_size(packed_shape, word_axis: int) -> tuple[int, int]:
    """(height, width) in cells of a packed board of ``packed_shape``."""
    rows, cols = packed_shape
    return (rows * WORD, cols) if word_axis == 0 else (rows, cols * WORD)


def check_window(packed_shape, y0, x0, h, w, word_axis: int = 0) -> None:
    """Validate a decode window against a packed board's geometry."""
    height, width = _board_size(packed_shape, word_axis)
    if h <= 0 or w <= 0:
        raise ValueError(f"window extent {h}x{w} must be positive")
    if not (0 <= y0 and y0 + h <= height and 0 <= x0 and x0 + w <= width):
        raise ValueError(
            f"window [{y0}:{y0 + h}, {x0}:{x0 + w}] outside {height}x{width}"
        )


def window_word_bounds(y0: int, x0: int, h: int, w: int, word_axis: int) -> tuple[int, int, int]:
    """The covering word range along the packed axis for a cell window:
    ``(a0, a1, off)``, packed indices ``[a0:a1]`` cover the window, which
    starts ``off`` cells into the unpacked block."""
    if word_axis == 0:
        a0, a1 = y0 // WORD, -(-(y0 + h) // WORD)
        return a0, a1, y0 - a0 * WORD
    a0, a1 = x0 // WORD, -(-(x0 + w) // WORD)
    return a0, a1, x0 - a0 * WORD


def decode_window(state, y0: int, x0: int, h: int, w: int, word_axis: int = 0) -> np.ndarray:
    """The uint8 window ``[y0:y0+h, x0:x0+w]`` of a packed board, decoding
    only the words that cover it: the inspection surface of a board whose
    byte raster would take GiB."""
    check_window(tuple(state.shape), y0, x0, h, w, word_axis)
    a0, a1, off = window_word_bounds(y0, x0, h, w, word_axis)
    if word_axis == 0:
        return unpack(state[a0:a1, x0:x0 + w], 0).cpu().numpy()[off:off + h]
    return unpack(state[y0:y0 + h, a0:a1], 1).cpu().numpy()[:, off:off + w]


def stream_packed_to_pgm(path, state, word_axis: int = 0, row_block: int = 1024) -> None:
    """Write the bitboard to a P5 PGM in row blocks: at most ``row_block x
    W`` bytes exist at once, on the card and on the host."""
    from .io.sharded import create_pgm, write_rows_at

    height, width = _board_size(state.shape, word_axis)
    row_block = max(WORD, row_block - row_block % WORD)
    offset = create_pgm(path, width, height)
    for start in range(0, height, row_block):
        stop = min(start + row_block, height)
        if word_axis == 0:
            block = state[start // WORD:stop // WORD]
        else:
            block = state[start:stop]
        write_rows_at(path, offset, width, start, unpack(block, word_axis).cpu().numpy())


def load_packed_from_pgm(path, word_axis: int = 0, row_block: int = 1024, device=None):
    """Stream a P5 PGM into a packed bitboard on ``device`` (the card unless
    named), one row block at a time."""
    from .io.pgm import PgmReader
    from .io.sharded import read_shard

    with PgmReader(path) as r:
        width, height = r.width, r.height
    if height % WORD or width % WORD:
        raise ValueError(f"{width}x{height} not divisible by {WORD}")
    device = resolve_device(device)
    row_block = max(WORD, row_block - row_block % WORD)
    blocks = []
    for start in range(0, height, row_block):
        rows = read_shard(path, start, min(start + row_block, height))
        blocks.append(pack(torch.from_numpy(rows.copy()), word_axis, device))
    return torch.cat(blocks, dim=0)


def run_big_board(
    size: int,
    turns: int,
    out_path,
    *,
    cells: Sequence[tuple[int, int]] | None = None,
    in_path=None,
    rule: LifeRule = CONWAY,
    word_axis: int = 0,
    row_block: int = 1024,
    engine=None,
    device=None,
) -> int:
    """Seed (cells or a streamed PGM), evolve, stream out; returns the
    final alive count (a popcount on the device). The byte board never
    exists; the host holds one row block at most.

    With ``engine`` (an ``Engine`` with ``final_world=False``, checked) the
    turns run through the engine's chunk loop, so pause, quit, the
    count-only retrieve and the 2-second ticker work mid-run; the board
    then lives on the engine's device. Without one it lives on ``device``
    (the card unless named) and steps in one ``BitPlane.step_n``."""
    if engine is not None:
        _check_byte_free_engine(engine)
        device = engine.device
    device = resolve_device(device)
    state = _seed_state(size, cells, in_path, word_axis, row_block, device)
    plane = BitPlane(rule, word_axis, device)
    if engine is not None:
        from .params import Params

        engine.run(
            Params(turns=turns, image_width=size, image_height=size),
            None, plane=plane, initial_state=state,
        )
        state = engine.final_state()
    elif turns:
        state = plane.step_n(state, turns)
    if out_path is not None:
        stream_packed_to_pgm(out_path, state, word_axis, row_block)
    return alive_count_packed(state)


def _seed_state(size, cells, in_path, word_axis, row_block, device):
    if (cells is None) == (in_path is None):
        raise ValueError("exactly one of cells / in_path must be given")
    if cells is not None:
        return seed_packed(size, cells, word_axis, device=device)
    return load_packed_from_pgm(in_path, word_axis, row_block, device)


def _check_byte_free_engine(engine) -> None:
    if engine.config.final_world:
        raise ValueError(
            "big-board runs need an Engine(EngineConfig(final_world="
            "False)): the default run exit decodes the full byte raster "
            "this surface promises never exists"
        )


class _LazyAliveCells:
    """A sequence-shaped ``FinalTurnComplete.alive`` that builds the Cell
    list only when iterated: ``len()`` is a popcount on the device. A dense
    65536^2 board would otherwise build billions of Cell objects."""

    def __init__(self, plane, state):
        self._plane = plane
        self._state = state

    def __len__(self) -> int:
        return int(self._plane.alive_count(self._state))

    def __iter__(self):
        return iter(self._plane.alive_cells(self._state))

    def __eq__(self, other):
        try:
            other_list = list(other)
        except TypeError:
            return NotImplemented
        return list(self) == other_list


class _PackedBroker:
    """The verbs the ticker needs, served by an engine holding a packed
    state. ``retrieve`` is always count-only: the PGM snapshot streams from
    the packed state instead of decoding a world."""

    def __init__(self, engine):
        self.engine = engine

    def retrieve(self, include_world: bool = True):
        return self.engine.retrieve(include_world=False)

    def pause(self):
        return self.engine.pause()

    def quit(self):
        return self.engine.quit()

    def super_quit(self):
        return self.engine.super_quit()


def big_session(
    size: int,
    turns: int,
    *,
    cells: Sequence[tuple[int, int]] | None = None,
    in_path=None,
    rule: LifeRule = CONWAY,
    word_axis: int = 0,
    row_block: int = 1024,
    engine=None,
    events=None,
    keypresses=None,
    tick_seconds: float = 2.0,
    out_dir="out",
    device=None,
):
    """The reference's session surface over a packed big board: the
    2-second ``AliveCellsCount`` ticker, the ``s``/``q``/``k``/``p`` keys
    (gol/distributor.go:61-122), and the closing ``FinalTurnComplete`` →
    PGM → ``ImageOutputComplete`` → ``StateChange{Quitting}`` → CLOSED, on
    a board whose byte raster never exists (snapshots stream row blocks,
    the cells come from the packed rows that hold any). Returns the
    engine's RunResult. ``engine`` (``final_world=False``) or ``device``
    (the card unless named) says where the board lives.

    ``engine.controller.run`` is the byte session; this shares its
    ticker."""
    import pathlib
    import queue as queue_mod

    from .engine.controller import CLOSED, _Ticker
    from .engine.engine import Engine, EngineConfig, Snapshot
    from .events import FinalTurnComplete, ImageOutputComplete, Quitting, StateChange
    from .params import Params

    if events is None:
        events = queue_mod.Queue()
    ticker = None
    try:
        # validation and seeding inside the CLOSED guard: an error must not
        # leave a consumer blocked on the queue
        if engine is None:
            engine = Engine(EngineConfig(final_world=False, device=device))
        else:
            _check_byte_free_engine(engine)
        params = Params(turns=turns, image_width=size, image_height=size)
        state = _seed_state(size, cells, in_path, word_axis, row_block, engine.device)
        plane = BitPlane(rule, word_axis, engine.device)
        out_file = pathlib.Path(out_dir) / f"{params.output_filename}.pgm"

        class _BigTicker(_Ticker):
            def _snapshot_to_pgm(self):
                # state and turn under one lock, so the PGM and the turn
                # it reports cannot straddle a chunk commit
                current, turn = self.broker.engine.state_snapshot()
                if current is not None:
                    stream_packed_to_pgm(out_file, current, word_axis, row_block)
                count = alive_count_packed(current) if current is not None else 0
                return Snapshot(None, turn, count)

        ticker = _BigTicker(
            params, events, keypresses, _PackedBroker(engine), out_dir, tick_seconds,
        )
        ticker.start()
        try:
            result = engine.run(params, None, plane=plane, initial_state=state)
        finally:
            ticker.stop()
        final = engine.final_state()
        events.put(FinalTurnComplete(result.turns_completed, _LazyAliveCells(plane, final)))
        if final is not None:
            stream_packed_to_pgm(out_file, final, word_axis, row_block)
        events.put(ImageOutputComplete(result.turns_completed, params.output_filename))
        events.put(StateChange(result.turns_completed, Quitting))
        return result
    finally:
        events.put(CLOSED)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gol_distributed_final_tpu_torch.bigboard",
        description="sparse big-board run (BASELINE config 5 shape)",
    )
    parser.add_argument("-size", type=int, default=16384)
    parser.add_argument("-turns", type=int, default=1000)
    parser.add_argument(
        "-out", default="out/bigboard.pgm",
        help="the final board's PGM; an empty value writes none (a 65536^2 "
             "board is a 4 GiB raster), which -session refuses",
    )
    parser.add_argument("-in", dest="in_path", default=None,
                        help="seed from a PGM instead of the R-pentomino")
    parser.add_argument("-row-block", type=int, default=1024)
    parser.add_argument(
        "-rule", default=None, metavar="B.../S...",
        help="life-like rulestring (default Conway B3/S23)",
    )
    parser.add_argument(
        "-session", action="store_true", default=False,
        help="run through big_session: 2 s alive-count ticker, s/q/k/p "
             "keys on stdin (tty), events printed like the headless drain",
    )
    parser.add_argument(
        "-device", default=None,
        help="where the board lives: cuda (default; fails without a card) or cpu",
    )
    args = parser.parse_args(argv)
    if args.session and not args.out:
        parser.error("-session ends by writing the final PGM: -out needs a path")
    try:
        rule = LifeRule.from_rulestring(args.rule) if args.rule else CONWAY
    except ValueError as e:
        parser.error(str(e))
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    cells = None if args.in_path else r_pentomino(args.size)
    if args.session:
        import pathlib
        import queue as queue_mod
        import threading

        from .__main__ import drain_events, start_tty_keys

        events: "queue_mod.Queue" = queue_mod.Queue()
        keypresses: "queue_mod.Queue" = queue_mod.Queue()
        restore_tty = start_tty_keys(keypresses)
        consumer = threading.Thread(target=drain_events, args=(events,))
        consumer.start()
        try:
            # a session names its file by the reference's convention inside
            # -out's directory; the rename keeps -out's exact name
            out_path = pathlib.Path(args.out)
            result = big_session(
                args.size, args.turns, cells=cells, in_path=args.in_path,
                rule=rule, row_block=args.row_block, events=events,
                keypresses=keypresses, out_dir=out_path.parent, device=device,
            )
            conventional = out_path.parent / f"{args.size}x{args.size}x{args.turns}.pgm"
            if conventional.exists() and conventional != out_path:
                conventional.replace(out_path)
        finally:
            consumer.join()
            restore_tty()
        # a popcount on the device, not len() of a list of Cells
        print(f"alive {result.alive_count}")
        return 0
    alive = run_big_board(
        args.size, args.turns, args.out or None, cells=cells, in_path=args.in_path,
        rule=rule, row_block=args.row_block, device=device,
    )
    print(f"alive {alive}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
