"""Config 5 at its real topology: the packed big board on a multi-process
mesh.

The reference's whole scaling story is "add machines to the list"
(broker/broker.go:288-300), each machine then holding the full board.
Here, as in the JAX package's ``pod.py``, a ``torch.distributed`` job
shards the packed bitboard over a global ('rows', 'cols') mesh
(parallel/bit_halo.ShardedBitPlane: each block stepped by the tiled
kernel, halos crossing ranks as point-to-point messages), and every
host-side surface touches only the rows its devices own:

* ``stream_packed_to_pgm_sharded`` / ``load_packed_from_pgm_sharded``:
  each rank packs and unpacks ONLY its word rows, writing and reading
  disjoint ranges of one on-disk PGM (io/sharded.py). The byte raster
  never exists anywhere; a rank holds one row block at a time.
* periodic checkpoints: one shard per rank
  (engine/checkpoint.save_packed_checkpoint_sharded), written between
  chunks by every rank at the same turn.
* ``pod_session``: the reference session surface (2-second
  ``AliveCellsCount``, the s/q/k/p keys, the closing
  ``FinalTurnComplete`` -> PGM -> ``ImageOutputComplete`` ->
  ``StateChange{Quitting}`` -> CLOSED sequence; gol/distributor.go:25-129)
  on the pod. Rank 0 drives control: keypresses and the tick timer live
  there, and each decision reaches every rank as a broadcast word at the
  engine's chunk gate (EngineConfig.chunk_hook), so every collective
  (counts, snapshot streams, the pause barrier) comes in the same order on
  every rank. A blocked gate IS the pause.

A state this process holds entirely passes through the one-host paths
(bigboard.py's streams), so the same program serves one card and a pod.
Run it as ``python -m gol_distributed_final_tpu_torch.pod`` on every host
(see ``main``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .models import CONWAY, LifeRule
from .ops.bitpack import WORD, alive_count_packed, packed_shape
from .parallel import multihost

# control word bits broadcast from rank 0 at each chunk gate
_CTL_TICK = 1  # all ranks join the count collective; rank 0 emits the event
_CTL_SNAPSHOT = 2  # all ranks stream their rows to the session PGM
_CTL_PAUSE = 4  # enter/stay in the pause barrier
_CTL_QUIT = 8  # 'k': engine.quit() on every rank, a coordinated shutdown
_CTL_DETACH = 16  # 'q': rank 0's controller surface closes; the run continues


def _packed_dims(shape, word_axis: int) -> tuple[int, int]:
    rows, cols = shape
    return (rows * WORD, cols) if word_axis == 0 else (rows, cols * WORD)


def stream_packed_to_pgm_sharded(
    path, state, word_axis: int = 0, row_block: int = 1024
) -> None:
    """Write a mesh-sharded packed board to ONE on-disk P5 PGM, each rank
    writing only the rows it owns (io/sharded.py's disjoint ranges). A
    fully addressable state takes the one-host streamer. Collective: every
    rank must call it (two barriers inside). No process ever holds more
    than ``row_block`` unpacked rows."""
    from .bigboard import stream_packed_to_pgm
    from .engine.checkpoint import local_packed_rows
    from .io.sharded import create_pgm, pgm_raster_offset, write_rows_at
    from .ops.bitpack import unpack

    if getattr(state, "is_fully_addressable", True):
        stream_packed_to_pgm(path, state.gather() if hasattr(state, "blocks") else state,
                             word_axis, row_block)
        return

    height, width = _packed_dims(state.shape, word_axis)
    row_block = max(WORD, row_block - row_block % WORD)
    if multihost.process_index() == 0:
        offset = create_pgm(path, width, height)
    else:
        offset = pgm_raster_offset(width, height)
    # rank != 0 must not write before the file exists at full size
    multihost.barrier()

    word_row0, local = local_packed_rows(state)
    board_row0 = word_row0 * WORD if word_axis == 0 else word_row0
    step = row_block // WORD if word_axis == 0 else row_block
    for start in range(0, local.shape[0], step):
        rows = unpack(torch.from_numpy(local[start:start + step]), word_axis).numpy()
        write_rows_at(path, offset, width,
                      board_row0 + (start * WORD if word_axis == 0 else start), rows)
    multihost.barrier()


def load_packed_from_pgm_sharded(path, mesh, word_axis: int = 0, row_block: int = 1024):
    """Stream a P5 PGM into a mesh-sharded packed board: each rank reads
    ONLY its own board rows from disk (io/sharded.read_shard), packs them,
    and places them on its blocks. Collective in spirit: every rank
    calls it with the same arguments."""
    from .io.pgm import PgmReader
    from .io.sharded import read_shard
    from .ops.bitpack import pack
    from .parallel.mesh import ShardedBoard
    from .parallel.multihost import host_row_range

    with PgmReader(path) as r:
        width, height = r.width, r.height
    if height % WORD or width % WORD:
        raise ValueError(f"{width}x{height} not divisible by {WORD}")
    lo, hi = host_row_range(mesh, height)
    row_block = max(WORD, row_block - row_block % WORD)
    first = mesh.slot(*mesh.local_slots()[0]).device
    blocks = []
    for start in range(lo, hi, row_block):
        rows = read_shard(path, start, min(start + row_block, hi))
        blocks.append(pack(torch.from_numpy(rows.copy()), word_axis, first))
    return ShardedBoard.from_process_local(
        mesh, torch.cat(blocks, dim=0), packed_shape(height, width, word_axis)
    )


def decode_window_sharded(
    state, y0: int, x0: int, h: int, w: int, word_axis: int = 0
) -> np.ndarray:
    """The uint8 window ``[y0:y0+h, x0:x0+w]`` of a MESH-SHARDED packed
    board, decoded collectively: each rank fills the part of the window's
    covering words it owns, the parts are all-gathered (a window is KiB;
    the raster never forms) and merged, unpacked and sliced, so EVERY rank
    returns the same array. All ranks must call it with the same
    arguments. The one-host sibling is ``bigboard.decode_window``."""
    from .bigboard import check_window, decode_window, window_word_bounds
    from .ops.bitpack import unpack

    if getattr(state, "is_fully_addressable", True):
        whole = state.gather() if hasattr(state, "blocks") else state
        return decode_window(whole, y0, x0, h, w, word_axis)

    check_window(state.shape, y0, x0, h, w, word_axis)
    a0, a1, off = window_word_bounds(y0, x0, h, w, word_axis)
    rows, cols = (slice(a0, a1), slice(x0, x0 + w)) if word_axis == 0 else (
        slice(y0, y0 + h), slice(a0, a1))
    part = np.zeros((rows.stop - rows.start, cols.stop - cols.start), np.int32)
    for (rs, cs), block in state.addressable_shards:
        r0, r1 = max(rows.start, rs.start), min(rows.stop, rs.stop)
        c0, c1 = max(cols.start, cs.start), min(cols.stop, cs.stop)
        if r0 < r1 and c0 < c1:
            part[r0 - rows.start:r1 - rows.start, c0 - cols.start:c1 - cols.start] = (
                block[r0 - rs.start:r1 - rs.start, c0 - cs.start:c1 - cs.start].cpu().numpy())
    # the ranks' parts are disjoint: OR merges them
    gathered = np.bitwise_or.reduce(multihost.allgather(part), axis=0)
    board = unpack(torch.from_numpy(gathered), word_axis).numpy()
    if word_axis == 0:
        return board[off:off + h]
    return board[:, off:off + w]


class _PodControl:
    """The rank-0-driven control gate installed as EngineConfig.chunk_hook.

    Rank 0 turns its local state (tick timer, drained keypresses) into a
    control word; a broadcast fans it to all ranks, which act identically.
    The pause barrier is a loop of further broadcasts, rank 0 re-polling
    its keyboard between them, so parked ranks stay with rank 0 until
    resume or quit.

    Keys follow the reference's controller/broker split: ``q`` detaches
    the controller (rank 0's event and key surface closes with Quitting +
    CLOSED; the run continues headless, as the broker survives a
    controller's quit, gol/distributor.go:64-77), ``k`` is the coordinated
    full shutdown (broker/broker.go:241-249)."""

    def __init__(
        self,
        params,
        events,
        keypresses,
        out_path,
        word_axis: int,
        row_block: int,
        tick_seconds: float,
        is_root: bool,
    ):
        self.params = params
        self.events = events
        self.keypresses = keypresses
        self.out_path = out_path
        self.word_axis = word_axis
        self.row_block = row_block
        self.tick_seconds = tick_seconds
        self.is_root = is_root
        self.paused = False
        self.detached = False  # 'q' pressed: the controller surface closed
        self._pause_pairs = 0  # toggle pairs cancelled within one drain
        self._next_tick = time.monotonic() + tick_seconds

    # -- rank-0 side -------------------------------------------------------

    def _drain_key_word(self) -> int:
        import queue as queue_mod

        word = 0
        if self.keypresses is None or self.detached:
            return word
        while True:
            try:
                key = self.keypresses.get_nowait()
            except queue_mod.Empty:
                return word
            if key == "s":
                word |= _CTL_SNAPSHOT
            elif key == "p":
                # XOR, not OR: two presses drained at one gate cancel out,
                # as two toggles should, but the event stream still shows
                # the Paused/Executing pair, like the reference handling
                # each press as it arrives (gol/distributor.go:108-121)
                if word & _CTL_PAUSE:
                    self._pause_pairs += 1
                word ^= _CTL_PAUSE
            elif key == "q":
                # controller quit (gol/distributor.go:64-77): keys queued
                # behind the 'q' belong to a closed surface and are never
                # consulted, so draining stops here
                word |= _CTL_DETACH
                return word
            elif key == "k":
                word |= _CTL_QUIT

    def _root_word(self) -> int:
        if self.detached:
            return 0  # controller gone: no keys, no ticker
        word = self._drain_key_word()
        if time.monotonic() >= self._next_tick:
            self._next_tick = time.monotonic() + self.tick_seconds
            word |= _CTL_TICK
        return word

    # -- every rank --------------------------------------------------------

    def __call__(self, engine, state, turn: int) -> None:
        word = multihost.broadcast_int(self._root_word() if self.is_root else 0)
        self._apply(engine, state, turn, word)
        while self.paused and not (word & _CTL_QUIT):
            # the pause barrier: the gate does not return, so no rank can
            # dispatch another chunk (broker/broker.go:83-86's blocked
            # loop, pod-wide). Rank 0 paces the rendezvous.
            if self.is_root:
                time.sleep(0.05)
                word = multihost.broadcast_int(self._drain_key_word())
            else:
                word = multihost.broadcast_int(0)
            self._apply(engine, state, turn, word)

    def _apply(self, engine, state, turn: int, word: int) -> None:
        from .events import AliveCellsCount, Quitting, State, StateChange

        if word & _CTL_TICK:
            # EVERY rank joins the count collective; only rank 0 emits,
            # and not while paused (gol/distributor.go:47)
            count = alive_count_packed(state)
            if self.is_root and not self.paused:
                self.events.put(AliveCellsCount(turn, count))
        if word & (_CTL_SNAPSHOT | _CTL_DETACH):
            # 's' streams on demand; 'q' streams the CURRENT state before
            # the controller surface closes (the reference's q handler
            # writes the PGM first, gol/distributor.go:63-77). 'k' needs
            # no write here: the closing sequence's stream IS the
            # killed-at state. One stream even when both bits land.
            stream_packed_to_pgm_sharded(
                self.out_path, state, self.word_axis, self.row_block
            )
            if self.is_root and word & _CTL_SNAPSHOT:
                print(self.params.output_filename)
        if self.is_root and self._pause_pairs:
            # toggle pairs cancelled at this gate: the state never changed,
            # but each press still gets its event, in the order press-at-a-
            # time handling would have emitted them
            for _ in range(self._pause_pairs):
                if self.paused:
                    self.events.put(StateChange(turn - 1, State.EXECUTING))
                    self.events.put(StateChange(turn, State.PAUSED))
                else:
                    self.events.put(StateChange(turn, State.PAUSED))
                    self.events.put(StateChange(turn - 1, State.EXECUTING))
            self._pause_pairs = 0
        if word & _CTL_PAUSE:
            self.paused = not self.paused
            if self.is_root:
                self.events.put(
                    StateChange(
                        turn if self.paused else turn - 1,
                        State.PAUSED if self.paused else State.EXECUTING,
                    )
                )
                print("State paused" if self.paused else "State unpaused")
        if word & _CTL_DETACH:
            # 'q' (gol/distributor.go:64-77, README.md:187): Quitting then
            # CLOSED end rank 0's event stream, keys stop being read, and
            # the run continues headless (a paused board is resumed first:
            # nobody is left to unpause it)
            from .engine.controller import CLOSED

            self.paused = False
            if self.is_root and not self.detached:
                self.events.put(StateChange(turn, Quitting))
                self.events.put(CLOSED)
            self.detached = True
        if word & _CTL_QUIT:
            # 'k' (broker/broker.go:241-249): coordinated full shutdown
            if self.is_root and not self.detached:
                self.events.put(StateChange(turn, Quitting))
            engine.quit()


class _CountOnlyAlive:
    """``FinalTurnComplete.alive`` for a pod run: the global count without
    any rank building cells it does not own. Iteration is refused: a
    pod-scale cell list is what this surface promises never to build."""

    def __init__(self, count: int):
        self._count = count

    def __len__(self) -> int:
        return self._count

    def __iter__(self):
        raise NotImplementedError(
            "a multi-process FinalTurnComplete carries only the count; decode "
            "windows via bigboard.decode_window or stream the PGM instead"
        )


def pod_session(
    size: int,
    turns: int,
    mesh,
    *,
    in_path=None,
    cells=None,
    rule: LifeRule = CONWAY,
    row_block: int = 1024,
    events=None,
    keypresses=None,
    tick_seconds: float = 2.0,
    out_dir="out",
    checkpoint_every: int = 0,
    checkpoint_path=None,
    resume_from=None,
    min_chunk: int = 16,
    max_chunk: int = 256,
    halo_depth: int = 1,
):
    """The full reference session surface over a multi-process packed
    board.

    Collective: every rank calls this with the same arguments;
    ``events``/``keypresses`` are consulted on rank 0 only (the
    controller host). Returns the engine's RunResult (world None;
    ``alive`` count-only on every rank). The board lives on the mesh's
    devices.

    ``resume_from`` continues from a per-rank sharded checkpoint
    (engine/checkpoint.load_packed_checkpoint_sharded); with
    ``checkpoint_every`` it is the pod's crash-recovery loop."""
    import pathlib
    import queue as queue_mod

    from .engine.controller import CLOSED
    from .engine.engine import Engine, EngineConfig
    from .events import FinalTurnComplete, ImageOutputComplete, Quitting, StateChange
    from .params import Params
    from .parallel.bit_halo import make_bit_plane, packed_sharding
    from .parallel.mesh import COLS, ROWS, ShardedBoard

    is_root = multihost.process_index() == 0
    if events is None:
        events = queue_mod.Queue()
    control = None
    try:
        mesh_shape = (mesh.shape[ROWS], mesh.shape[COLS])
        plane = make_bit_plane(mesh, (size, size), rule, halo_depth=halo_depth)
        if plane is None:
            raise ValueError(
                f"no packed layout of {size}x{size} divides over mesh "
                f"{mesh_shape} with halo_depth={halo_depth} (the depth is "
                "bounded by the local word blocks)"
            )
        word_axis = plane.word_axis
        params = Params(turns=turns, image_width=size, image_height=size)
        out_file = pathlib.Path(out_dir) / f"{params.output_filename}.pgm"

        initial_turn = 0
        if resume_from is not None:
            from .engine.checkpoint import load_packed_checkpoint_sharded

            state, initial_turn, ck_rule, ck_axis = load_packed_checkpoint_sharded(
                resume_from, packed_sharding(mesh)
            )
            if ck_axis != word_axis:
                raise ValueError(f"checkpoint word_axis {ck_axis} != layout {word_axis}")
            if ck_rule.rulestring != rule.rulestring:
                raise ValueError(f"checkpoint rule {ck_rule.rulestring} != {rule.rulestring}")
            if turns <= initial_turn:
                raise ValueError(f"turns={turns} not beyond checkpoint turn {initial_turn}")
        elif in_path is not None:
            state = load_packed_from_pgm_sharded(in_path, mesh, word_axis, row_block)
        elif cells is not None:
            from .bigboard import seed_packed
            from .parallel.multihost import host_row_range

            # each rank seeds ONLY its own row range, on its first device:
            # no full-board host allocation anywhere
            lo, hi = host_row_range(mesh, size)
            first = mesh.slot(*mesh.local_slots()[0]).device
            local = seed_packed(size, cells, word_axis, row_range=(lo, hi), device=first)
            state = ShardedBoard.from_process_local(
                mesh, local, packed_shape(size, size, word_axis)
            )
        else:
            raise ValueError("one of resume_from / in_path / cells is required")

        control = _PodControl(
            params, events, keypresses, out_file, word_axis, row_block,
            tick_seconds, is_root,
        )
        engine = Engine(
            EngineConfig(
                rule=rule,
                final_world=False,
                min_chunk=min_chunk,
                max_chunk=max_chunk,
                chunk_hook=control,
                checkpoint_every=checkpoint_every,
                checkpoint_path=str(checkpoint_path) if checkpoint_path else None,
                device=state.device,
            )
        )
        result = engine.run(
            params, None, plane=plane, initial_state=state, initial_turn=initial_turn,
        )
        final = engine.final_state()
        # the closing sequence (gol/distributor.go:161-184), pod-shaped:
        # count collectively, stream the PGM per rank, emit on rank 0
        count = alive_count_packed(final)
        # the agreed count, on EVERY rank: a later rank-local
        # result.alive_count must not fire a collective outside the gates
        result._alive = _CountOnlyAlive(count)
        # after a 'q' detach the controller surface already closed: the
        # run still streams its PGM, but emits no further events
        emit = is_root and not control.detached
        if emit:
            events.put(FinalTurnComplete(result.turns_completed, _CountOnlyAlive(count)))
        stream_packed_to_pgm_sharded(out_file, final, word_axis, row_block)
        if emit:
            events.put(ImageOutputComplete(result.turns_completed, params.output_filename))
            events.put(StateChange(result.turns_completed, Quitting))
        return result
    finally:
        if control is None or not control.detached:
            events.put(CLOSED)


def main(argv=None) -> int:
    """Pod entry point: one invocation per host of the job (the
    reference's 'go run ./worker on every machine', broker/broker.go:
    288-300, except that the board is sharded, not copied):

        python -m gol_distributed_final_tpu_torch.pod [-size 16384] [-turns 1000]
            [-in PGM] [-out DIR] [-row-block R] [-rule B.../S...]
            [-halo-depth K] [-ck PATH [-ck-every N] [-resume]]
            [-coordinator HOST:PORT -num-processes N -process-id I] [-device cuda:N|cpu]

    Rank 0 is the controller host: it owns the tty keys (s/q/k/p) and
    prints the event stream; other ranks run headless. The mesh is
    (processes, devices per process): every card of the host for
    ``-device cuda``, the one card of ``-device cuda:N`` (one rank per
    card), or on the CPU ``GOL_TORCH_CPU_DEVICES`` virtual devices
    (utils/cpumesh.py).
    A process that already belongs to a process group (one started by its
    caller) runs in that group."""
    import argparse
    import queue as queue_mod
    import threading

    from .__main__ import drain_events, start_tty_keys
    from .bigboard import r_pentomino
    from .device import resolve_device
    from .parallel.mesh import global_devices, local_devices, make_mesh

    parser = argparse.ArgumentParser(
        prog="gol_distributed_final_tpu_torch.pod",
        description="multi-process packed big-board session (config 5 topology)",
    )
    parser.add_argument("-size", type=int, default=16384)
    parser.add_argument("-turns", type=int, default=1000)
    parser.add_argument("-in", dest="in_path", default=None,
                        help="seed PGM (default: the R-pentomino)")
    parser.add_argument("-out", default="out", help="output directory")
    parser.add_argument("-row-block", type=int, default=1024)
    parser.add_argument("-coordinator", default=None,
                        help="the process group's address host:port (rank 0 listens)")
    parser.add_argument("-num-processes", type=int, default=1)
    parser.add_argument("-process-id", type=int, default=0)
    parser.add_argument("-ck", default=None, metavar="PATH",
                        help="periodic checkpoint base path (per-rank shards)")
    parser.add_argument("-ck-every", type=int, default=0)
    parser.add_argument("-resume", action="store_true", default=False,
                        help="resume from -ck's per-rank shards")
    parser.add_argument("-rule", default=None, metavar="B.../S...",
                        help="life-like rulestring (default Conway B3/S23)")
    parser.add_argument(
        "-halo-depth", dest="halo_depth", type=int, default=1,
        help="turns per halo exchange (wide halos: k-fold fewer messages per "
             "turn, and one tiled launch of k turns a block; up to 8 on the "
             "kernel, deeper on torch ops)",
    )
    parser.add_argument(
        "-device", default=None,
        help="where the board lives: cuda (default: every card of the host, "
             "NCCL between ranks; fails without a card), cuda:N (that card "
             "alone: one rank per card) or cpu (gloo)",
    )
    args = parser.parse_args(argv)
    # argument mistakes fail before any host joins the group
    if args.resume and not args.ck:
        parser.error("-resume needs -ck (the checkpoint base path)")
    if args.resume and args.in_path:
        parser.error("-resume restores the board from -ck; drop -in")
    rule = CONWAY
    if args.rule:
        try:
            rule = LifeRule.from_rulestring(args.rule)
        except ValueError as e:
            parser.error(str(e))
    if args.halo_depth < 1:
        parser.error(f"-halo-depth must be >= 1, got {args.halo_depth}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))

    joined = multihost.initialize(
        args.coordinator, args.num_processes, args.process_id, device
    )
    try:
        local = len(local_devices(device))
        mesh = make_mesh((multihost.process_count(), local), global_devices(device))
        is_root = multihost.process_index() == 0

        events: "queue_mod.Queue" = queue_mod.Queue()
        keypresses: "queue_mod.Queue | None" = None
        restore_tty = lambda: None  # noqa: E731
        consumer = None
        if is_root:
            keypresses = queue_mod.Queue()
            restore_tty = start_tty_keys(keypresses)
            consumer = threading.Thread(target=drain_events, args=(events,))
            consumer.start()
        try:
            result = pod_session(
                args.size,
                args.turns,
                mesh,
                in_path=args.in_path,
                cells=None if (args.in_path or args.resume) else r_pentomino(args.size),
                rule=rule,
                row_block=args.row_block,
                events=events,
                keypresses=keypresses,
                out_dir=args.out,
                checkpoint_every=args.ck_every,
                checkpoint_path=args.ck,
                resume_from=args.ck if args.resume else None,
                halo_depth=args.halo_depth,
            )
        finally:
            if consumer is not None:
                consumer.join()
            restore_tty()
        if is_root:
            print(f"alive {result.alive_count}")
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
