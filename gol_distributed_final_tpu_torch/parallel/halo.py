"""Halo-exchange stencil steps over a device mesh: the byte plane.

The reference ships the FULL board to every worker every turn and gathers
strips back over TCP (broker/broker.go:135-224). Here each mesh slot owns
one block of the board for good, and per turn it takes only its halo from
its neighbours: a slice and a copy when the neighbour's block is in this
process (``.to(device)`` when the two devices differ), a point-to-point
message when another rank holds it (parallel/multihost.exchange: NCCL
between cards, gloo between CPUs). The JAX package runs the same step in
``shard_map`` with ``lax.ppermute`` halos (its ``parallel/halo.py``); its
local step is XLA there and plain torch ops here.

Corner cells come from the classic two-phase exchange: rows first (blocks
grow to (h+2, w)), then columns of the *extended* block (to (h+2, w+2)):
the column messages carry the row halos' end cells, so corners arrive
without diagonal messages.

Every function takes a Mesh with axes ('rows', 'cols'); either axis may
have size 1. Each dispatch carries the JAX package's halo meters
(``metered_dispatch``: a span, an ``halo.dispatch`` profiler range, the
exchanges and the host wall), and each block's local turns are timed on its
device under the ``halo.byte`` or ``halo.bit`` site (obs/device.py).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..models import CONWAY, LifeRule
from ..obs import device as _device
from ..obs import instruments as _ins
from ..obs import metrics as _metrics
from ..obs import tracing as _tracing
from ..ops.bitpack import byte_launch_cost
from ..ops.stencil import apply_rule, counts_from_extended
from . import multihost
from .mesh import BlockSharding, Mesh, ShardedBoard


def exchanges_per_dispatch(n: int, depth: int) -> int:
    """Halo exchanges (row and column phases) a ``wide_loop`` of ``n``
    turns at ``halo_depth=depth`` makes: one per wide iteration plus one
    per single-turn remainder."""
    if depth > 1:
        return n // depth + n % depth
    return n


def board_sharding(mesh: Mesh) -> BlockSharding:
    """The canonical board sharding: rows over 'rows', cols over 'cols'."""
    return BlockSharding(mesh)


def _exchange(blocks: dict, mesh: Mesh, dim: int, pad: int = 0, k: int = 1) -> dict:
    """Each local block with its wrap-around halos of thickness ``k``
    along ``dim`` prepended and appended, taken from its ring neighbours on
    that mesh axis: ``{slot: extended block}``.

    With a single slot on the axis the halo is the block's own wrap. A
    neighbour in this process gives a slice (copied to this block's device
    when it differs); a neighbour on another rank sends its slices in one
    message per pair of ranks, its slices stacked in (slot, side) order,
    which both ranks compute alike, on each rank's collective device
    (parallel/multihost.py), whichever of its cards they come from or go
    to.

    ``k > 1`` is the WIDE-halo form (temporal blocking): a k-deep halo
    lets the caller run k turns locally before the next exchange, k-fold
    fewer messages at the same volume. ``pad`` adds that many zero slices
    outside each halo."""
    n = mesh.grid[dim]
    for b in blocks.values():
        if k < 1 or k > b.shape[dim]:
            raise ValueError(f"halo thickness {k} outside [1, local dim {b.shape[dim]}]")

    def neighbour(slot, step):
        i, j = slot
        return ((i + step) % n, j) if dim == 0 else (i, (j + step) % n)

    def edge(block, side):
        # side 0: the slice a block's NEXT neighbour puts before itself
        # (this block's last k); side 1: the previous one's after (first k)
        if side == 0:
            return block[-k:] if dim == 0 else block[:, -k:]
        return block[:k] if dim == 0 else block[:, :k]

    me = multihost.process_index()
    halos = {}  # (slot, side) -> tensor
    wanted: dict = {}  # peer rank -> [(slot, side)] this rank receives
    offered: dict = {}  # peer rank -> [(slot, side, source block)] it sends
    for slot, block in blocks.items():
        for side, step in ((0, -1), (1, 1)):
            src = neighbour(slot, step)
            owner = mesh.slot(*src).rank
            if owner == me:
                halos[slot, side] = edge(blocks[src], side).to(block.device)
            else:
                wanted.setdefault(owner, []).append((slot, side))
            # the block this one feeds on this side, and who owns it
            dst = neighbour(slot, -step)
            if mesh.slot(*dst).rank != me:
                offered.setdefault(mesh.slot(*dst).rank, []).append((dst, side, block))
    if wanted or offered:
        # a rank's blocks may sit on several cards; its messages all go
        # through the one card its NCCL group is bound to
        via = multihost.collective_device()
        sends = {peer: torch.stack([edge(b, side).to(via) for _, side, b in sorted(
                     items, key=lambda m: (m[0], m[1]))]).contiguous()
                 for peer, items in offered.items()}
        recvs = {}
        for peer, items in wanted.items():
            items.sort()
            like = blocks[items[0][0]]
            shape = (k, like.shape[1]) if dim == 0 else (like.shape[0], k)
            recvs[peer] = torch.empty((len(items),) + shape, dtype=like.dtype, device=via)
        multihost.exchange(sends, recvs)
        for peer, items in wanted.items():
            for m, (slot, side) in enumerate(items):
                halos[slot, side] = recvs[peer][m].to(blocks[slot].device)
    out = {}
    for slot, block in blocks.items():
        parts = [halos[slot, 0], block, halos[slot, 1]]
        if pad:
            zshape = list(block.shape)
            zshape[dim] = pad
            zeros = torch.zeros(zshape, dtype=block.dtype, device=block.device)
            parts = [zeros, *parts, zeros]
        out[slot] = torch.cat(parts, dim=dim)
    return out


def _extend(blocks: dict, mesh: Mesh, k: int = 1, pad: int = 0) -> dict:
    """Both phases: k-deep halos on all four sides, corners included."""
    ext = _exchange(blocks, mesh, 0, pad=pad, k=k)
    return _exchange(ext, mesh, 1, pad=pad, k=k)


def timed_block(site: str, ext, turns: int, cost, step):
    """``step()``, a block's local turns on its extended block ``ext``,
    timed on the block's device under ``site`` (obs/device.py) with the
    ``(ops, bytes)`` of ``cost(cells_or_words, turns)``; just ``step()``
    with metrics off."""
    started = _device.begin(ext.device)
    out = step()
    if started is not None:
        _device.end(site, ext.device, started, *cost(ext.numel(), turns))
    return out


def metered_dispatch(plane: str, n: int, depth: int, run: Callable):
    """``run()``, one mesh dispatch of ``n`` turns, with the JAX package's
    halo meters: its span and profiler range, the exchanges it makes and
    its host wall (``gol_halo_dispatch_seconds{plane}``). Just ``run()``
    with metrics and tracing off."""
    if not (_metrics.enabled() or _tracing.enabled() or _tracing.device_trace_active()):
        return run()
    span = _tracing.start_span(_tracing.SPAN_HALO_DISPATCH, plane=plane, turns=n)
    if _metrics.enabled():
        _ins.HALO_EXCHANGES_TOTAL.labels(plane).inc(exchanges_per_dispatch(n, depth))
    t0 = time.monotonic()
    with _tracing.annotate("halo.dispatch"):
        out = run()
    if _metrics.enabled():
        _ins.HALO_DISPATCH_SECONDS.labels(plane).observe(time.monotonic() - t0)
    _tracing.end_span(span)
    return out


def _byte_cost(rule: LifeRule):
    return lambda cells, turns: byte_launch_cost(cells, turns, rule.birth_mask,
                                                 rule.survive_mask)


def _local_step(blocks: dict, *, rule: LifeRule, mesh: Mesh) -> dict:
    """One turn on every local block, halos included."""
    out = {}
    for slot, ext in _extend(blocks, mesh).items():
        def turn(ext=ext):
            h, w = ext.shape[0] - 2, ext.shape[1] - 2
            counts = counts_from_extended(ext, h, w)
            return apply_rule(ext[1:-1, 1:-1], counts, birth_mask=rule.birth_mask,
                              survive_mask=rule.survive_mask)

        out[slot] = timed_block("halo.byte", ext, 1, _byte_cost(rule), turn)
    return out


def wide_loop(blocks, n: int, depth: int, step, wide):
    """``n`` turns as ``n // depth`` wide iterations (``depth`` turns per
    halo exchange) plus single-turn remainders: the one chunking both data
    planes share, so the byte and packed evolutions cannot drift."""
    if depth > 1:
        for _ in range(n // depth):
            blocks = wide(blocks)
        for _ in range(n % depth):
            blocks = step(blocks)
        return blocks
    for _ in range(n):
        blocks = step(blocks)
    return blocks


def halo_depth_fits(depth: int, block_shape) -> bool:
    """A halo can only come from the adjacent slot: depth is bounded by
    the local block's smaller dimension. The one copy of the bound, read
    by the step-time checks and by the admission guards (the broker's
    plane routing, ``make_bit_plane``)."""
    return depth <= min(block_shape)


def check_halo_depth(depth: int, block_shape) -> None:
    """Raise-form of ``halo_depth_fits``, naming the knob."""
    if not halo_depth_fits(depth, block_shape):
        raise ValueError(
            f"halo_depth {depth} exceeds the local block "
            f"{tuple(block_shape)}: a halo can only come from the "
            "adjacent device"
        )


def _local_step_wide(blocks: dict, *, rule: LifeRule, mesh: Mesh, depth: int) -> dict:
    """``depth`` turns per halo exchange: one depth-deep exchange, then
    ``depth`` local turns on the extended block, each consuming one halo
    ring (the ext is the (interior + 2) window the count reads), so the
    last turn leaves the block's own shape."""
    out = {}
    for slot, ext in _extend(blocks, mesh, k=depth).items():
        def turns(ext=ext):
            for _ in range(depth):
                h, w = ext.shape[0] - 2, ext.shape[1] - 2
                counts = counts_from_extended(ext, h, w)
                ext = apply_rule(ext[1:-1, 1:-1], counts, birth_mask=rule.birth_mask,
                                 survive_mask=rule.survive_mask)
            return ext

        out[slot] = timed_block("halo.byte", ext, depth, _byte_cost(rule), turns)
    return out


def run_sharded(mesh: Mesh, board, step_blocks: Callable):
    """Run ``step_blocks(blocks) -> blocks`` on a board: a ``ShardedBoard``
    comes back sharded; a whole board (tensor or numpy, every slot in this
    process) is placed on the mesh and comes back as one tensor on its own
    device (a numpy board's: the mesh's first)."""
    if isinstance(board, ShardedBoard):
        return board.with_blocks(step_blocks(board.blocks))
    sharded = ShardedBoard.from_global(mesh, board)
    out = sharded.with_blocks(step_blocks(sharded.blocks)).gather()
    return out.to(board.device) if isinstance(board, torch.Tensor) else out


def sharded_step_fn(mesh: Mesh, rule: LifeRule = CONWAY) -> Callable:
    """``board -> board``: one turn over a uint8 board on the mesh (a
    ``ShardedBoard`` stays sharded)."""
    step_n = sharded_step_n_fn(mesh, rule)
    return lambda board: step_n(board, 1)


def sharded_step_n_fn(
    mesh: Mesh, rule: LifeRule = CONWAY, *, halo_depth: int = 1
) -> Callable:
    """``(board, n) -> board``: ``n`` turns of a uint8 {0,255} board over
    the mesh, every block stepping between its halo exchanges.

    ``halo_depth=k`` exchanges k-deep halos and runs k turns per exchange
    (``_local_step_wide``); turn counts not divisible by k finish with
    single-turn steps."""
    if halo_depth < 1:
        raise ValueError(f"halo_depth must be >= 1, got {halo_depth}")

    def local(blocks):
        return _local_step(blocks, rule=rule, mesh=mesh)

    def wide(blocks):
        return _local_step_wide(blocks, rule=rule, mesh=mesh, depth=halo_depth)

    def step_n(board, n):
        block_shape = BlockSharding(mesh).block_shape(tuple(board.shape))
        check_halo_depth(halo_depth, block_shape)
        return metered_dispatch("byte", int(n), halo_depth, lambda: run_sharded(
            mesh, board, lambda b: wide_loop(b, int(n), halo_depth, local, wide)))

    return step_n


def make_engine_step(
    mesh: Mesh, rule: LifeRule = CONWAY, *, halo_depth: int = 1
) -> Callable:
    """An ``EngineConfig.step_n_fn``: the engine's byte board, handed over
    as a tensor, runs its chunk on the mesh and comes back on its own
    device. ``halo_depth`` rides through to the wide-halo form."""
    return sharded_step_n_fn(mesh, rule, halo_depth=halo_depth)
