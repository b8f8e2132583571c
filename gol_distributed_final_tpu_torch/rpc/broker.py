"""The broker process — the Operations service (broker/broker.go).

The port of the JAX package's ``rpc/broker.py``. Two data-plane backends
behind the same RPC verbs:

* ``tpu`` (the default; the reference's name for it): the board lives on
  one device in an in-process Engine, and the reference's per-turn
  scatter/gather collapses into chunked kernel launches (``DeviceBackend``).
* ``workers``: the reference-shaped distribution over remote worker
  processes (``WorkersBackend``, broker/broker.go:135-224), on the host,
  holding no board on a device. ``-wire haloed`` (default) sends each
  worker its strip and two halo rows a turn, ``-wire full`` the whole
  board (broker/broker.go:144), and ``-wire resident`` keeps each strip
  RESIDENT on its worker and moves only 2·K halo rows per K-turn batch
  (``-halo-depth K``), with full re-syncs every ``-sync-interval`` turns
  (dirty-tile deltas with ``-sparse-sync``), 2-D tiles with ``-grid``,
  attestation digests, loss recovery, readmission, and time-based
  auto-checkpoints (``-auto-checkpoint``, generations with
  ``-ckpt-keep``).

Beside either, ``Operations.SessionRun`` serves many universes of one
geometry in one device batch (``SessionScheduler`` over
engine/sessions.py) on the broker's ``-device``.

Control semantics preserved: Run blocks and resets state; Pause toggles;
Quit breaks the loop but keeps the process alive for a reattaching
controller; SuperQuit quits the workers, then the broker itself
(broker/broker.go:236-277, 312-323).

Run it with ``python -m gol_distributed_final_tpu_torch.rpc.broker -port P
[-backend workers -workers A,B,... [-wire resident -halo-depth K]]
[-resume CKPT [-ckpt-keep N]] [-device cuda|cpu]``. ``-resume`` reattaches
a crashed run: the first fresh Run continues from the checkpoint's board,
turn and rule. The observability flags (``-metrics -timeline -trace
-journal -profile``, obs/cli.py) and the ``Status`` verb are the JAX
package's, and so are the meters, spans, journal and flight records of
both backends and the session scheduler's tenant ledger. ``-canary
[SECS] [-canary-verb session|run]`` runs the blackbox prober
(obs/canary.py) against the broker's own port.
"""

from __future__ import annotations

import argparse
import collections
import logging
import math
import pathlib
import random
import threading
import time

import numpy as np

from ..device import resolve_device
from ..engine.engine import Engine, EngineConfig, RunResult, Snapshot
from ..models import CONWAY, LifeRule
from ..obs import accounting as _acct
from ..obs import cli as _obs_cli
from ..obs import critical as _critical
from ..obs import flight as _flight
from ..obs import instruments as _ins
from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..obs import perf as _perf
from ..obs import profiler as _profiler
from ..obs import tracing as _tracing
from ..utils import locksan as _locksan
from . import faults as _faults
from . import integrity as _integrity
from .client import RpcClient, RpcError
from .protocol import Methods, Request, Response
from .server import RpcServer

logger = logging.getLogger(__name__)

# scatter-deadline policy (WorkersBackend._scatter_deadline): before any
# turn has committed there is no latency estimate, so the first turn gets
# the cold bound (generous: a legitimately slow first turn must not evict
# the whole roster — pre-deadline such runs completed); after that the
# deadline tracks the turn-time EWMA with a generous multiplier, floored
# so scheduler hiccups don't evict healthy workers. Deliberately UNcapped
# above the floor: a wedge then costs ~20x a legitimate turn — always
# proportional, never an abort of a cluster whose honest turns are slow.
# Operators wanting a tight absolute bound pin one with -rpc-deadline.
_DEADLINE_COLD = 300.0
_DEADLINE_FLOOR = 5.0
# the gather additionally bounds each future by deadline + grace: the
# client-side deadline only covers the REPLY wait, so a send stalled by a
# peer that stopped draining its receive buffer (SIGSTOP mid-frame) would
# otherwise hang fut.result() — and the run — forever
_DEADLINE_GRACE = 2.0
# per-address probe pacing: failed probes of a DEAD address back off to a
# short cap (a restarted worker readmits within seconds), while repeat
# LOSSES escalate to a long cap — a flapper (e.g. compute-wedged but still
# answering Status, so every readmission costs the next turn a deadline)
# gets quarantined exponentially instead of taxing every turn forever
_PROBE_BACKOFF_CAP = 5.0
_LOSS_BACKOFF_CAP = 60.0
# dirty-tile delta bounds (ops/sparse.py wire tiles): every Nth resident
# sync forces full frames even when deltas are available (a cheap
# keyframe against accumulated skew), and every Nth auto-checkpoint is a
# full generation the intervening deltas are cut against (each delta is
# depth-1 from its keyframe — never a delta-on-delta chain)
_KEYFRAME_SYNCS = 16
_CKPT_KEYFRAME_EVERY = 8



def _rule_of(req: Request) -> LifeRule:
    """The request's rule; "" (or a skewed pickle without the field) is
    Conway, the server default."""
    rulestring = getattr(req, "rulestring", "")
    return LifeRule.from_rulestring(rulestring) if rulestring else CONWAY


class DeviceBackend:
    """Engine-backed data plane: the counterpart of the JAX package's
    ``TpuBackend`` (rpc/broker.py:88), on one device or on a mesh of all
    the devices it sees (every card, or ``GOL_TORCH_CPU_DEVICES`` virtual
    CPU devices for ``device="cpu"``, utils/cpumesh.py). One persistent
    Engine serves every Run, so control verbs that land before a Run has
    initialised are buffered by the engine's own pending-control semantics
    instead of being dropped. ``halo_depth`` (the ``-halo-depth`` default)
    and a request's ``halo_depth`` are the mesh planes' turns per halo
    exchange; on one device, or a board no mesh divides, there is no halo
    and the knob is vacuous."""

    def __init__(self, device=None, halo_depth: int = 1):
        if halo_depth < 1:
            raise ValueError(f"halo_depth must be >= 1, got {halo_depth}")
        self.engine = Engine(EngineConfig(device=device))
        self.device = self.engine.device
        self._halo_depth = halo_depth  # the -halo-depth server default
        self._planes: dict = {}

    def _plane_for(self, height: int, width: int, rule: LifeRule, halo_depth: int):
        """A mesh data plane if the devices divide the board (the packed
        halo plane when a packed layout divides too, each block on the
        tiled kernel; else the byte halo plane where the depth fits); None
        for one device and the engine's own rule (the engine picks its
        plane); for another rule the plane the engine would pick, handed
        over explicitly (ops/auto.py)."""
        key = (height, width, rule.rulestring, halo_depth)
        if key not in self._planes:
            from ..ops.plane import BytePlane

            from ..parallel import make_engine_step, make_mesh
            from ..parallel.bit_halo import make_bit_plane
            from ..parallel.halo import halo_depth_fits
            from ..parallel.mesh import local_devices

            plane = None
            mesh_built = False
            devices = local_devices(self.device)
            if len(devices) > 1:
                try:
                    mesh = make_mesh(devices=devices, height=height, width=width)
                    mesh_built = True
                    nrows, ncols = mesh.grid
                    plane = make_bit_plane(mesh, (height, width), rule, halo_depth=halo_depth)
                    if plane is None and halo_depth_fits(
                        halo_depth, (height // nrows, width // ncols)
                    ):
                        # cell blocks are 32x deeper than word blocks on
                        # the packed axis: a board too small for the
                        # packed layout at this depth may fit here
                        plane = BytePlane(rule, self.device, make_engine_step(
                            mesh, rule, halo_depth=halo_depth))
                except ValueError:
                    pass  # indivisible board: the one-device engine
            if plane is None and halo_depth > 1 and mesh_built:
                # a mesh was BUILT but no plane carries this depth: refuse
                # rather than run at depth 1. Without a mesh (one device,
                # or an indivisible board) there are no halo exchanges at
                # all, so the knob is vacuous, not dishonoured
                raise ValueError(
                    f"halo_depth {halo_depth} cannot be honored for "
                    f"{width}x{height} on this backend (no mesh plane "
                    "supports it); drop -halo-depth or grow the board"
                )
            if plane is None and rule.rulestring != self.engine.config.rule.rulestring:
                from ..ops.auto import auto_plane

                plane = (auto_plane(rule, (height, width), self.device)
                         or BytePlane(rule, self.device))
            self._planes[key] = plane
        return self._planes[key]

    def run(self, req: Request) -> RunResult:
        from ..params import Params

        params = Params(
            turns=req.turns,
            threads=req.threads,
            image_width=req.image_width,
            image_height=req.image_height,
        )
        # 0 on the wire is the server's default (like rulestring's "")
        depth = getattr(req, "halo_depth", 0) or self._halo_depth
        plane = self._plane_for(req.image_height, req.image_width, _rule_of(req), depth)
        # initial_turn is an extension field: absent from an older
        # client's Request, meaning 0 (a fresh run)
        return self.engine.run(
            params, req.world, plane=plane, initial_turn=getattr(req, "initial_turn", 0)
        )

    def pause(self):
        self.engine.pause()

    def quit(self):
        self.engine.quit()

    def super_quit(self):
        self.engine.super_quit()

    def retrieve(self, include_world: bool) -> Snapshot:
        return self.engine.retrieve(include_world=include_world)


class _ResidentPlan:
    """One seeded resident-strip deployment: which client holds which rows,
    the batch depth K, and each strip's boundary rows at the current turn
    (``edges[i] = (top K rows, bottom K rows)``) — the only state that has
    to move per batch (the broker relays worker i-1's bottom edge and
    worker i+1's top edge down as worker i's next halos).

    ``digests[i]`` is the broker-side digest chain of worker i's resident
    strip at the committed turn (rpc/integrity.py): anchored at seed time
    from the rows the broker itself sent, advanced from each verified
    ``StripStep`` reply's post-batch digest, and compared against the
    reply's PRE-batch digest — so a strip silently mutated between
    batches fails the very next step. ``None`` means "not tracked" (the
    worker never attested: version skew or ``-integrity off``)."""

    __slots__ = ("active", "bounds", "k", "edges", "digests")

    def __init__(self, active, bounds, k, edges, digests=None):
        self.active = active
        self.bounds = bounds
        self.k = k
        self.edges = edges
        self.digests = digests or [None] * len(active)


def parse_grid(spec):
    """The -grid knob: ``None`` (legacy strip plane), ``"auto"`` (squarest
    roster factorization weighted by board aspect — _auto_grid), or
    ``"CxR"`` read width-by-height like the board flags: C tile COLUMNS by
    R tile ROWS, so ``1x4`` is exactly today's four row strips and ``2x4``
    puts eight workers on a four-row board. Returns ``None``, ``"auto"``
    or ``(rows, cols)``; raises ValueError on anything else."""
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if not s:
        return None
    if s == "auto":
        return "auto"
    parts = s.split("x")
    if len(parts) == 2:
        try:
            cols, rows = int(parts[0]), int(parts[1])
        except ValueError:
            cols = rows = 0
        if cols >= 1 and rows >= 1:
            return rows, cols
    raise ValueError(
        f"grid must be 'auto' or CxR (tile columns x tile rows, "
        f"e.g. 2x2), got {spec!r}"
    )


def _auto_grid(n: int, h: int, w: int) -> tuple[int, int]:
    """The (rows, cols) tile layout for ``n`` workers on an ``h x w``
    board: the largest m <= n with a factorization whose tiles fit
    (rows <= h, cols <= w), breaking ties toward the squarest TILE —
    minimal |log((h/rows) / (w/cols))| — so a square board gets a square
    grid and a wide board gets proportionally more columns (the standard
    TPU-torus block decomposition, arXiv:2112.09017)."""
    for m in range(max(1, min(n, h * w)), 0, -1):
        best = None
        for rows in range(1, m + 1):
            if m % rows:
                continue
            cols = m // rows
            if rows > h or cols > w:
                continue
            skew = abs(math.log((h * cols) / (w * rows)))
            if best is None or skew < best[1]:
                best = ((rows, cols), skew)
        if best is not None:
            return best[0]
    return 1, 1


class _TilePlan:
    """One seeded 2-D tile deployment (-grid): _ResidentPlan's
    checkerboard twin. ``bounds[i] = (s, e, x0, x1)`` is the block of
    board rows [s, e) x cols [x0, x1) held by ``active[i]``, laid out
    row-major (flat index ``i = r * cols + c``). ``edges[i] = (top,
    bottom, left, right)`` are the tile's UNPACKED boundary bands at the
    committed turn, each ``k`` deep — enough for the broker to assemble
    any neighbour's next halos INCLUDING the four K x K corner blocks
    (tile (r, c)'s top-left corner is diagonal neighbour (r-1, c-1)'s
    bottom band's last k columns), so corners never ride the uplink.
    ``digests`` is the same per-block chain as _ResidentPlan."""

    __slots__ = ("active", "bounds", "grid", "k", "edges", "digests")

    def __init__(self, active, bounds, grid, k, edges, digests=None):
        self.active = active
        self.bounds = bounds
        self.grid = grid  # (rows, cols)
        self.k = k
        self.edges = edges
        self.digests = digests or [None] * len(active)


class WorkersBackend:
    """Reference-shaped scatter/gather over remote workers
    (broker/broker.go:62-234).

    ``wire`` picks the data plane: ``"haloed"`` (default) sends each
    worker its strip plus the two wrap halo rows — O(strip) bytes per turn;
    ``"full"`` is the reference-EXACT wire behavior, the whole board to
    every worker with [start_y, end_y) bounds (broker/broker.go:144 —
    O(H x W) bytes per worker per turn, the scalability limit
    README.md:204 points at, preserved for contract archaeology);
    ``"resident"`` makes the workers STATEFUL: each strip stays where it is
    computed (StripStart seeds it), only the 2·K boundary rows move per
    K-turn batch (StripStep — O(W·K) bytes and 1/K round-trips per turn),
    and full strips are gathered back (StripFetch) only every
    ``sync_interval`` turns and at snapshot/pause/checkpoint/run-end
    boundaries. ``halo_depth`` is the resident batch depth K — the same
    comms/compute amortisation the mesh planes' wide halos buy on-device
    (parallel/halo.py), honored on this backend for the first time."""

    # the roster maps (who is lost, each address's probe schedule, the
    # client->address index) mutate from the turn loop, the probe thread,
    # and RPC handler threads at once: every touch goes through _lock —
    # entered directly or via the _control Condition wrapping it
    # (machine-enforced: analysis/locks.py)
    _GUARDED_BY = {
        "_lost": ("_lock", "_control"),
        "_probe_backoff": ("_lock", "_control"),
        "_client_addr": ("_lock", "_control"),
    }

    def __init__(
        self,
        worker_addresses: list[str],
        wire: str = "haloed",
        *,
        rpc_deadline: float | None = None,
        auto_checkpoint: tuple[float, str] | None = None,
        probe_interval: float = 1.0,
        halo_depth: int = 1,
        sync_interval: int = 256,
        ckpt_keep: int = 1,
        sparse_sync: bool = True,
        grid: str | tuple[int, int] | None = None,
    ):
        if wire not in ("haloed", "full", "resident"):
            raise ValueError(
                f"wire must be 'haloed', 'full' or 'resident', got {wire!r}"
            )
        if isinstance(grid, str) or grid is None:
            grid = parse_grid(grid)  # ValueError on malformed specs
        elif not (
            isinstance(grid, tuple)
            and len(grid) == 2
            and all(isinstance(v, int) and v >= 1 for v in grid)
        ):
            raise ValueError(f"grid must be 'auto' or (rows, cols), got {grid!r}")
        if grid is not None and wire != "resident":
            # tiles are a property of the stateful strip plane; the
            # scatter/gather wires ship whole boards and have no layout
            raise ValueError("grid tiling requires wire='resident'")
        if probe_interval <= 0:
            # 0 would busy-spin the probe thread and connect-storm every
            # dead address (next-probe times of now+0 forever)
            raise ValueError(f"probe_interval must be > 0, got {probe_interval}")
        if halo_depth < 1:
            raise ValueError(f"halo_depth must be >= 1, got {halo_depth}")
        if sync_interval < 0:
            raise ValueError(
                f"sync_interval must be >= 0 (0: boundary syncs only), "
                f"got {sync_interval}"
            )
        self._wire = wire
        self._halo_depth = halo_depth  # resident batch depth K (server default)
        # -grid: None | "auto" | (rows, cols); resolved per run against the
        # board and roster into _run_grid (the active 2-D layout) or
        # _grid_rows_forced (a one-column grid IS the strip plane — routed
        # through the legacy loop with the row count pinned, byte-identical)
        self._grid = grid
        self._run_grid: tuple[int, int] | None = None  # turn-loop-local
        self._grid_rows_forced: int | None = None  # turn-loop-local
        # resident mode: turns between periodic full re-syncs (bounds the
        # local recompute a loss recovery pays); 0 = only at snapshot/
        # pause/checkpoint/run-end boundaries and losses
        self._sync_interval = sync_interval
        # None: adaptive (EWMA of observed turn time — _scatter_deadline);
        # a float pins every scatter's reply bound (the -rpc-deadline flag)
        if ckpt_keep < 1:
            raise ValueError(f"ckpt_keep must be >= 1, got {ckpt_keep}")
        self._rpc_deadline = rpc_deadline
        self._auto_checkpoint = auto_checkpoint  # (seconds, path) or None
        self._ckpt_keep = ckpt_keep  # auto-checkpoint generations retained
        self._probe_interval = probe_interval
        self._turn_seconds: float | None = None  # EWMA, turn-loop-local
        self._last_ckpt = 0.0
        # dirty-tile delta state, all turn-loop-local (like _turn_seconds):
        # whether delta StripFetch syncs are enabled (-sparse-sync), the
        # sync/checkpoint keyframe counters, the global dirty grid
        # accumulated from StripStep replies since the last FULL
        # auto-checkpoint (None = window unknown — a skewed worker or a
        # fresh run — forcing the next checkpoint to a full keyframe),
        # and that keyframe's (turn, digest) anchor
        self._sparse_sync = sparse_sync
        self._sync_count = 0
        self._ckpt_count = 0
        self._ckpt_dirty: np.ndarray | None = None
        self._last_batch_dirty: np.ndarray | None = None
        self._ckpt_base: tuple[int, str] | None = None
        # guards the roster maps (_GUARDED_BY); GOL_LOCKSAN swaps in the
        # instrumented wrapper (utils/locksan.py), plain Lock otherwise
        self._lock = _locksan.lock("WorkersBackend._lock")
        self._control = _locksan.condition(
            "WorkersBackend._control", self._lock
        )
        # the FULL roster is kept (not just the connected subset): a dead
        # or flapping address stays probe-able, so capacity recovers when
        # the worker comes back instead of only ever degrading
        self.addresses = list(worker_addresses)
        self.clients: list[RpcClient] = []
        self._client_addr: dict[int, str] = {}  # id(client) -> address
        self._lost: dict[str, float] = {}  # address -> next probe (monotonic)
        self._probe_backoff: dict[str, float] = {}
        now = time.monotonic()
        for addr in self.addresses:
            try:
                client = RpcClient(addr, timeout=3.0)
            except OSError:
                # dead at connect: logged and left on the roster for the
                # probe thread, instead of the reference's skip-forever
                # (isConnected, broker/broker.go:39-45, 302-311)
                logger.warning("worker %s unreachable, will keep probing", addr)
                self._lost[addr] = now + probe_interval
                continue
            self.clients.append(client)
            self._client_addr[id(client)] = addr
        logger.info(
            "%d/%d workers connected", len(self.clients), len(self.addresses)
        )
        self._world: np.ndarray | None = None
        self._turn = 0
        # resident-mode bookkeeping: the turn self._world is CURRENT at
        # (== self._turn in the full/haloed modes, which commit a fresh
        # world every turn), the pending snapshot-sync request, and the
        # latest (turn, alive_count) sample every wire mode records through
        # _record_alive — the count-only Retrieve feed
        self._sync_turn = 0
        self._sync_requested = False
        self._alive: tuple[int, int] | None = None
        self._paused = False
        self._parked = False  # turn loop is actually waiting in the gate
        self._quit = False
        self._running = False
        self._probe_stop = threading.Event()
        if self.addresses:
            threading.Thread(target=self._probe_loop, daemon=True).start()

    def run(self, req: Request) -> RunResult:
        if not self.clients:
            raise RpcError("no workers connected")
        # extension fields via getattr: an older client's pickle lacks
        # them, and absent must mean "default", not AttributeError
        if getattr(req, "halo_depth", 0) > 1 and self._wire != "resident":
            # wide halos need stateful strips; the per-turn scatter/gather
            # wires have no equivalent — refuse rather than silently
            # running at depth 1
            raise RpcError(
                "this wire mode has no halo_depth knob; use -wire resident "
                "(or -backend tpu) for wide halos"
            )
        rulestring = getattr(req, "rulestring", "")
        if rulestring:
            # the reference-shaped workers hard-code Conway
            # (worker/worker.go:41-46, mirrored in rpc/worker._strip_step);
            # silently evolving a resumed non-Conway checkpoint would
            # diverge. Canonicalise before comparing so e.g. "b3/s23"
            # is accepted as the Conway it is.
            from ..models import CONWAY, LifeRule

            try:
                canonical = LifeRule.from_rulestring(rulestring).rulestring
            except ValueError as e:
                raise RpcError(str(e)) from e
            if canonical != CONWAY.rulestring:
                raise RpcError(
                    f"workers backend computes Conway only, not {canonical}"
                )
        world = np.array(req.world, np.uint8, copy=True)
        h = world.shape[0]
        initial_turn = getattr(req, "initial_turn", 0)
        # resolve the -grid layout for THIS run before any state changes:
        # an un-layout-able roster is refused loudly (structured
        # error_reason) instead of degenerately split
        self._run_grid = None
        self._grid_rows_forced = None
        if self._wire == "resident" and self._grid is not None:
            rows, cols = self._resolve_grid(req, h, world.shape[1])
            if cols == 1:
                self._grid_rows_forced = rows
            else:
                self._run_grid = (rows, cols)
        with self._lock:
            if self._running:
                raise RpcError("a run is already in progress")
            self._world, self._turn = world, initial_turn
            self._sync_turn = initial_turn
            self._sync_requested = False
            self._record_alive(initial_turn, int(np.count_nonzero(world)))
            self._paused = False
            self._parked = False
            self._running = True

        try:
            self._turn_loop(req, h, initial_turn)
            # capture the result BEFORE clearing _running: once the flag
            # drops, a reattaching Run may overwrite _world/_turn
            with self._lock:
                result = RunResult(self._turn, self._world)
        finally:
            with self._lock:
                self._running = False
                self._quit = False  # consumed: a reattached Run starts fresh
                self._control.notify_all()
        return result

    @staticmethod
    def _split(h: int, n: int) -> list[tuple[int, int]]:
        """Row split: even shares, remainder to the first h % n workers
        (broker/broker.go:135-224)."""
        base, rem = divmod(h, n)
        bounds = []
        y = 0
        for i in range(n):
            size = base + (1 if i < rem else 0)
            bounds.append((y, y + size))
            y += size
        return bounds

    def _turn_loop(self, req: Request, h: int, initial_turn: int = 0) -> None:
        if self._wire == "resident":
            if self._run_grid is not None:
                with self._lock:
                    w = self._world.shape[1]
                self._tile_turn_loop(req, h, w, initial_turn)
            else:
                self._resident_turn_loop(req, h, initial_turn)
        else:
            self._scatter_turn_loop(req, h, initial_turn)

    def _resolve_grid(self, req: Request, h: int, w: int) -> tuple[int, int]:
        """Resolve the configured -grid against this run's board and
        roster. ``auto`` picks _auto_grid over the effective worker count;
        an explicit grid that cannot be laid out is REFUSED with a
        structured ``error_reason`` (grid_unsatisfiable: tiles would be
        empty; grid_roster: not enough workers connected) rather than
        degenerately split — the caller asked for a specific layout."""
        with self._lock:
            n_avail = len(self.clients)
        if self._grid == "auto":
            n = max(1, min(req.threads or n_avail, n_avail, h * w))
            return _auto_grid(n, h, w)
        rows, cols = self._grid
        if rows > h or cols > w:
            raise RpcError(
                f"grid {cols}x{rows} cannot tile a {w}x{h} board: every "
                f"tile needs at least one cell (grid rows <= board height "
                f"and grid cols <= board width)",
                reason="grid_unsatisfiable",
            )
        if rows * cols > n_avail:
            raise RpcError(
                f"grid {cols}x{rows} needs {rows * cols} workers, "
                f"only {n_avail} connected",
                reason="grid_roster",
            )
        return rows, cols

    def _scatter_turn_loop(self, req: Request, h: int, initial_turn: int = 0) -> None:
        """Per-turn scatter/gather with elastic recovery: a worker that dies
        OR exceeds the per-scatter deadline mid-turn is dropped and its rows
        re-split over the survivors (the same turn is recomputed from the
        committed pre-turn world), and a worker readmitted by the probe
        thread re-expands the split at the next turn — the fault-tolerance
        extension the reference leaves unimplemented (README.md:266-270;
        its gather simply hangs on worker death)."""
        import concurrent.futures

        def scatter(client, world, s, e, deadline, trace_parent=None,
                    sink=None, idx=0):
            # _call_worker handles the pool-thread plumbing: deadline
            # bounds the REPLY wait (a wedged worker costs one deadline,
            # never the whole run) and trace_parent rides in explicitly
            # (the turn span's thread-local stack is invisible here).
            if self._wire == "full":
                # reference-exact: ship the whole board, worker slices
                req = Request(world=world, start_y=s, end_y=e)
            else:
                rows = np.arange(s - 1, e + 1) % h
                req = Request(world=world[rows], start_y=-1)
            if sink is not None:
                return self._timed_call(
                    client, Methods.WORKER_UPDATE, req, deadline,
                    trace_parent, sink, idx,
                ).work_slice
            return self._call_worker(
                client, Methods.WORKER_UPDATE, req, deadline, trace_parent
            ).work_slice

        def plan(active):
            n = max(1, min(req.threads or len(active), len(active), h))
            return n, self._split(h, n)

        # one pool per run, not n fresh threads per turn; sized to the full
        # roster so readmitted workers get a thread without a new pool
        pool_size = max(1, len(self.clients), len(self.addresses))
        pool = concurrent.futures.ThreadPoolExecutor(pool_size)
        try:
            for _ in range(req.turns - initial_turn):
                with self._lock:
                    while self._paused and not self._quit:
                        self._parked = True
                        self._control.notify_all()
                        self._control.wait()
                    self._parked = False
                    if self._quit:
                        return
                    world = self._world

                # one span per turn: the scatter/gather barrier the
                # reference implements host-side — exactly the region that
                # wedges when a worker stalls, so it must be on the timeline
                turn_span = (
                    _tracing.start_span(
                        _tracing.SPAN_BROKER_TURN, turn=self._turn
                    )
                    if _tracing.enabled() else None
                )
                tp = turn_span.ctx() if turn_span else None
                t_turn = time.monotonic()
                had_loss = False
                attribution = self._attribution_on()
                try:
                    while True:  # retries the SAME turn after losing workers
                        # re-snapshot each attempt AND each turn: the probe
                        # thread appends readmitted clients concurrently
                        with self._lock:
                            active = list(self.clients)
                        if not active:
                            raise RpcError("all workers lost mid-run")
                        n, bounds = plan(active)
                        deadline = self._scatter_deadline()
                        # a fresh sink per attempt: a retried turn's dead
                        # replies must not pollute the committed batch's
                        # critical-path attribution
                        sink = [] if attribution else None
                        t_attempt = time.monotonic()
                        futures = [
                            pool.submit(
                                scatter, active[i], world, *bounds[i],
                                deadline, tp, sink, i,
                            )
                            for i in range(n)
                        ]
                        t_submitted = time.monotonic()
                        # _bounded_gather time-bounds the gather beyond the
                        # reply deadline (a scatter thread stuck in sendall
                        # must not hang fut.result() — the send allowance
                        # rationale lives on the helper)
                        strips, dead = self._bounded_gather(futures, deadline)
                        t_gathered = time.monotonic()
                        if not dead:
                            break
                        with self._lock:
                            if self._quit:
                                return  # shutdown race, not a failure
                        had_loss = True
                        for i in dead:
                            self._mark_lost(active[i], "scatter failed")
                        _ins.TURN_RETRY_TOTAL.inc()
                        with self._lock:
                            left = len(self.clients)
                        logger.warning(
                            "%d worker(s) lost mid-run at turn %d; "
                            "resplitting over %d",
                            len(dead), self._turn, left,
                        )
                        _journal.record(
                            "recovery.resplit", "scatter", turn=self._turn,
                            lost=len(dead), remaining=left,
                        )

                    new_world = np.concatenate(strips, axis=0)
                    count = int(np.count_nonzero(new_world))  # outside the lock
                    with self._lock:
                        self._world = new_world
                        self._turn += 1
                        self._sync_turn = self._turn  # a fresh full world
                        self._record_alive(self._turn, count)
                        turn_now = self._turn
                    _ins.TURN_BATCH_SIZE.observe(1)
                    if attribution:
                        self._feed_critical(sink, active, turn_now, 1)
                        self._observe_segments(
                            t_submitted - t_attempt,
                            t_gathered - t_submitted,
                            time.monotonic() - t_gathered,
                            sink,
                        )
                finally:
                    # ends on every exit — commit, shutdown race, all-lost
                    # raise — so a wedged NEXT turn is the one left open
                    _tracing.end_span(turn_span)
                # the adaptive-deadline signal: EWMA of CLEAN committed
                # turns only. A loss turn's dt contains the deadline stall
                # itself — feeding it back would let one cold wedge (300 s)
                # seed a ~6000 s deadline for the next turn, breaking the
                # "~20x a legitimate turn" proportionality this policy
                # promises
                if not had_loss:
                    dt = time.monotonic() - t_turn
                    self._turn_seconds = (
                        dt if self._turn_seconds is None
                        else 0.9 * self._turn_seconds + 0.1 * dt
                    )
                _faults.fault_point("broker.turn_commit")
                self._maybe_auto_checkpoint()
        finally:
            # wait=False: a scatter thread stuck past its deadline (its
            # client's close() normally frees it, but the wake is the
            # peer's kernel's business) must not hang the run's return
            pool.shutdown(wait=False)

    # -- the resident-strip data plane (-wire resident) ----------------------

    def _call_worker(self, client, method, req, deadline, trace_parent=None):
        """One bounded worker call on a pool thread (the scatter posture:
        timeout covers the REPLY wait; trace_parent only when tracing set
        it, so duck-typed fakes survive)."""
        kw = {"timeout": deadline}
        if trace_parent is not None:
            kw["trace_parent"] = trace_parent
        return client.call(method, req, **kw)

    @staticmethod
    def _attribution_on() -> bool:
        """Hot-loop guard for the dispatch-wall decomposition + critical-
        path feeds: metrics on AND obs/perf's attribution switch on (the
        bench's ≤2% decomposition-overhead gate A/Bs the switch)."""
        return _metrics.enabled() and _perf.attribution_enabled()

    def _timed_call(self, client, method, req, deadline, tp, sink, idx):
        """``_call_worker`` with per-call attribution: appends
        ``(idx, round_trip_s, service_s | None)`` to ``sink`` (service is
        the worker-reported handler wall — getattr: an older worker's
        reply lacks the field and the split degrades to round trip).
        list.append is atomic, so pool threads share the sink lock-free."""
        t0 = time.monotonic()
        res = self._call_worker(client, method, req, deadline, tp)
        service = getattr(res, "service_seconds", 0.0)
        sink.append((idx, time.monotonic() - t0, service or None))
        return res

    def _feed_critical(self, sink, active, turn, k, strip=False):
        """Commit one batch's per-worker walls: per-addr StripStep
        histogram (resident mode) + the critical-path tracker
        (obs/critical.py), whose snapshot rides the Status payload."""
        if not sink:
            return
        with self._lock:
            addrs = {
                id(c): self._client_addr.get(id(c), "<local>") for c in active
            }
        entries = []
        for idx, rt, service in sink:
            addr = addrs.get(id(active[idx]), "<local>")
            if strip:
                _ins.STRIP_STEP_SECONDS.labels(addr).observe(rt)
            entries.append((addr, rt, service))
        _critical.tracker().record_batch(entries, turn=turn, k=k)

    @staticmethod
    def _observe_segments(host_prep, gather, demux, sink):
        """One batch's dispatch-wall decomposition: the gather wall splits
        into the gating worker's reported service time (device_compute)
        and the residual wire time; a roster of non-reporting workers
        books the whole gather as wire (the honest degradation)."""
        compute = 0.0
        if sink:
            gating = max(sink, key=lambda e: e[1])
            compute = min(gating[2] or 0.0, gather)
        seg = _ins.TURN_SEGMENT_SECONDS
        seg.labels("broker", "host_prep").observe(max(0.0, host_prep))
        seg.labels("broker", "device_compute").observe(compute)
        seg.labels("broker", "wire").observe(max(0.0, gather - compute))
        seg.labels("broker", "demux").observe(max(0.0, demux))

    def _bounded_gather(self, futures, deadline):
        """``(results, dead_indices)`` with the scatter loop's time bound:
        the client deadline covers only the reply wait, so each future is
        additionally bounded by deadline + grace + a send allowance (a
        peer that stopped draining its receive buffer must cost one
        deadline, never hang the run)."""
        import concurrent.futures

        send_allowance = (
            10.0 * self._turn_seconds
            if self._turn_seconds is not None
            else _DEADLINE_COLD
        )
        t_gather = (
            time.monotonic() + deadline + _DEADLINE_GRACE + send_allowance
        )
        results, dead = [None] * len(futures), []
        for i, fut in enumerate(futures):
            try:
                results[i] = fut.result(
                    timeout=max(0.0, t_gather - time.monotonic())
                )
            except (
                RpcError,
                OSError,
                TimeoutError,
                concurrent.futures.TimeoutError,
            ):
                dead.append(i)
        return results, dead

    def _recompute_rows(
        self, world: np.ndarray, s: int, e: int, steps: int
    ) -> np.ndarray:
        """Rows [s, e) at ``steps`` turns past ``world``, by local shrinking
        recompute over the dependency cone (the rows within ``steps`` of
        the target, toroidal row wrap) — the workers' own numpy kernel
        (rpc/worker._strip_step), so the rebuild is bit-identical to what
        a worker would have computed."""
        from .worker import _strip_step, compute_strip

        h = world.shape[0]
        if (e - s) + 2 * steps >= h:
            # the cone covers the whole board: plain full-board stepping
            # is cheaper than a wider-than-the-board block
            for _ in range(steps):
                world = compute_strip(world, 0, h)
            return world[s:e]
        block = world[np.arange(s - steps, e + steps) % h]
        for _ in range(steps):
            block = _strip_step(block)  # 2 fewer rows per step
        return block

    def _resident_seed(self, req, h: int, depth: int, pool, tp=None):
        """Deploy (or re-deploy) the resident plan: split the current full
        board — which the plan-is-None invariant guarantees is at
        ``self._turn`` — over the active clients and ``StripStart`` each.
        Loops over losses (a worker dead at seed time is marked lost and
        the split re-planned); returns None on quit."""
        while True:
            with self._lock:
                if self._quit:
                    return None
                active = list(self.clients)
                world, turn = self._world, self._turn
            if not active:
                raise RpcError("all workers lost mid-run")
            n = self._legacy_plan_n(req, len(active), h)
            active = active[:n]
            bounds = self._split(h, n)
            # the batch depth K: the -halo-depth knob clamped to the
            # thinnest strip (a worker cannot relay more edge rows than
            # its strip holds)
            k = max(1, min(depth, min(e - s for s, e in bounds)))
            deadline = self._scatter_deadline()
            futures = [
                pool.submit(
                    self._call_worker,
                    active[i],
                    Methods.STRIP_START,
                    Request(
                        world=world[bounds[i][0]:bounds[i][1]],
                        worker=i,
                        initial_turn=turn,
                    ),
                    deadline,
                    tp,
                )
                for i in range(n)
            ]
            _, dead = self._bounded_gather(futures, deadline)
            if not dead:
                edges = [
                    (world[s:s + k], world[e - k:e]) for s, e in bounds
                ]
                # anchor the digest chain from the rows the broker itself
                # sent — independent of anything the workers claim
                digests = (
                    [_integrity.state_digest(world[s:e]) for s, e in bounds]
                    if _integrity.enabled()
                    else None
                )
                if _metrics.enabled():
                    # the strip plane IS the n x 1 tile layout
                    _ins.TILE_GRID_ROWS.set(n)
                    _ins.TILE_GRID_COLS.set(1)
                    _ins.TILE_EDGE_CELLS.set(2 * k * world.shape[1])
                return _ResidentPlan(active, bounds, k, edges, digests)
            for i in dead:
                self._mark_lost(active[i], "resident seed failed")

    def _legacy_plan_n(self, req, n_active: int, h: int) -> int:
        """Worker count for a legacy strip plan. A -grid that resolved to
        one column pins the row count (degrading only when the roster
        shrank below it); otherwise today's threads-and-roster rule,
        unchanged — the 1xN grid is byte-identical to the strip plane."""
        want = self._grid_rows_forced or (req.threads or n_active)
        return max(1, min(want, n_active, h))

    def _resident_sync(self, plan, pool, tp=None) -> bool:
        """Gather every resident strip (``StripFetch``) and refresh the
        broker's full board at the committed turn. True on success; False
        after marking failures — or lockstep-diverged strips — lost (the
        caller then recovers and reseeds).

        With ``-sparse-sync`` (the default) the fetch asks each worker
        for a dirty-tile DELTA against the full copy the broker already
        holds from the last sync (``Request.delta_base_turn``): a
        <1%-active board re-syncs in a fraction of the full-strip bytes
        (``gol_sparse_frame_bytes_total``). A worker whose accumulator is
        not anchored at that turn — version skew, a sync the broker
        failed to apply, a reseed — replies with the full strip, and
        every ``_KEYFRAME_SYNCS``-th sync forces full frames anyway. The
        crc/adler machinery makes delta application SAFE: the
        reconstructed strip must hash to the committed digest chain
        exactly like a full fetch, so a wrong delta can only ever be a
        loud loss, never an assembled board."""
        from ..ops import sparse as _sparse

        with self._lock:
            turn = self._turn
            base_world, base_turn = self._world, self._sync_turn
        self._sync_count += 1
        use_delta = (
            self._sparse_sync
            and base_world is not None
            and self._sync_count % _KEYFRAME_SYNCS != 0
        )
        delta_base = base_turn if use_delta else -1
        deadline = self._scatter_deadline()
        futures = [
            pool.submit(
                self._call_worker, c, Methods.STRIP_FETCH,
                Request(worker=i, delta_base_turn=delta_base), deadline, tp,
            )
            for i, c in enumerate(plan.active)
        ]
        results, dead = self._bounded_gather(futures, deadline)
        ok = True
        for i in dead:
            self._mark_lost(plan.active[i], "resident sync failed")
            ok = False
        strips: list[np.ndarray | None] = [None] * len(plan.active)
        for i, res in enumerate(results):
            if res is None:
                continue
            s, e = plan.bounds[i]
            dirty = getattr(res, "dirty", None)
            if isinstance(dirty, np.ndarray):
                # delta frame: reconstruct from the base rows + the flat
                # tile payload; a malformed geometry is a protocol
                # violation, handled like any other corrupt reply
                payload = np.asarray(res.work_slice, np.uint8)
                try:
                    strip = _sparse.apply_dirty_tiles(
                        np.asarray(base_world[s:e], np.uint8),
                        np.asarray(dirty, bool),
                        payload,
                    )
                except (ValueError, IndexError, TypeError):
                    self._mark_lost(
                        plan.active[i], "resident delta malformed"
                    )
                    ok = False
                    continue
                if _metrics.enabled():
                    _ins.SPARSE_FRAME_BYTES_TOTAL.inc(
                        payload.nbytes + dirty.size
                    )
            else:
                strip = np.asarray(res.work_slice, np.uint8)
            if res.turns_completed != turn or strip.shape[0] != e - s:
                # between batches every strip must sit at the committed
                # turn — a divergence means this worker's session is not
                # the one we seeded (never silently assemble it)
                self._mark_lost(plan.active[i], "resident lockstep divergence")
                ok = False
            elif plan.digests[i] is not None and _integrity.enabled():
                # the gathered (or delta-reconstructed) bytes must hash to
                # the committed chain: a strip corrupted since its last
                # verified step — or a wrongly-applied delta — must never
                # be assembled into the broker's board
                _ins.INTEGRITY_CHECKS_TOTAL.inc()
                if _integrity.state_digest(strip) != plan.digests[i]:
                    self._integrity_suspect(
                        plan, i, "fetch",
                        f"fetched strip at turn {turn} does not match "
                        "the committed digest chain",
                    )
                    self._mark_lost(
                        plan.active[i], "resident fetch digest mismatch"
                    )
                    ok = False
                else:
                    strips[i] = strip
            else:
                strips[i] = strip
        if not ok:
            return False
        # concatenate copies out of the receive-buffer views (protocol-5
        # sidecars), so the world outlives the frames it arrived in
        world = np.concatenate(
            [strips[i] for i in range(len(plan.active))], axis=0
        )
        with self._lock:
            self._world = world
            self._sync_turn = turn
        _ins.STRIP_RESYNC_TOTAL.inc()
        return True

    def _resident_recover(self, plan, pool, tp=None) -> None:
        """After a loss: rebuild the full board at the committed turn.
        Survivor strips still AT the committed turn are fetched and
        contribute their rows verbatim; rows held by lost workers — or by
        survivors that already advanced past the commit inside the failed
        batch — are reconstructed locally from the last full sync
        (bit-identical, worker-kernel recompute), so recovery costs
        O(board) work once per loss, bounded by ``-sync-interval``,
        instead of reverting the run."""
        with self._lock:
            base, t0, t1 = self._world, self._sync_turn, self._turn
            alive = {id(c) for c in self.clients}
        if t1 == t0:
            return  # the loss landed at a boundary: world already current
        parts: dict[int, np.ndarray] = {}
        survivors = [
            (i, c) for i, c in enumerate(plan.active) if id(c) in alive
        ]
        if survivors:
            deadline = self._scatter_deadline()
            futures = [
                pool.submit(
                    self._call_worker, c, Methods.STRIP_FETCH,
                    Request(worker=i), deadline, tp,
                )
                for i, c in survivors
            ]
            results, dead = self._bounded_gather(futures, deadline)
            for j in dead:
                self._mark_lost(survivors[j][1], "resident recovery fetch failed")
            for j, res in enumerate(results):
                if res is None:
                    continue
                i = survivors[j][0]
                s, e = plan.bounds[i]
                strip = np.asarray(res.work_slice, np.uint8)
                # only a strip at exactly the committed turn is usable;
                # one that finished the failed batch (t1 + k) is healthy
                # but ahead — its rows are reconstructed instead
                if res.turns_completed == t1 and strip.shape == (e - s, base.shape[1]):
                    if plan.digests[i] is not None and _integrity.enabled():
                        # a survivor's rows enter the rebuilt board
                        # verbatim — verify them against the chain first;
                        # on mismatch fall through to the local recompute
                        # (bit-identical by construction) instead
                        _ins.INTEGRITY_CHECKS_TOTAL.inc()
                        if _integrity.state_digest(strip) != plan.digests[i]:
                            self._integrity_suspect(
                                plan, i, "fetch",
                                f"survivor strip at turn {t1} does not "
                                "match the committed digest chain",
                            )
                            self._mark_lost(
                                plan.active[i],
                                "resident recovery digest mismatch",
                            )
                            continue
                    parts[i] = strip
        world = np.empty_like(base)
        steps = t1 - t0
        for i, (s, e) in enumerate(plan.bounds):
            if i in parts:
                world[s:e] = parts[i]
            else:
                world[s:e] = self._recompute_rows(base, s, e, steps)
        with self._lock:
            self._world = world
            self._sync_turn = t1
        _ins.STRIP_RESYNC_TOTAL.inc()

    def _resident_turn_loop(self, req, h: int, initial_turn: int = 0) -> None:
        """The stateful data plane: strips stay on the workers (seeded by
        ``StripStart``), each K-turn batch moves only the 2·K boundary
        rows per worker (``StripStep`` — O(W·K) bytes, one round-trip per
        K turns), and the full board is gathered back (``StripFetch``)
        only at ``-sync-interval`` expiries and snapshot/pause/checkpoint/
        run-end boundaries. Lockstep contract: between batches every
        seeded strip is at ``self._turn``; a loss costs one recovery
        rebuild + reseed, never the run."""
        import concurrent.futures

        depth = getattr(req, "halo_depth", 0) or self._halo_depth
        pool_size = max(1, len(self.clients), len(self.addresses))
        pool = concurrent.futures.ThreadPoolExecutor(pool_size)
        plan = None
        try:
            while True:
                with self._lock:
                    if self._quit:
                        return
                    paused = self._paused
                    behind = self._sync_turn != self._turn
                    done = self._turn >= req.turns
                    want_sync = behind and (
                        done
                        or paused
                        or self._sync_requested
                        or self._ckpt_due()
                        or (
                            self._sync_interval
                            and self._turn - self._sync_turn
                            >= self._sync_interval
                        )
                    )
                if want_sync:
                    if plan is not None and not self._resident_sync(plan, pool):
                        self._resident_recover(plan, pool)
                        plan = None
                    with self._lock:
                        if self._sync_turn == self._turn:
                            self._sync_requested = False
                            self._control.notify_all()
                    continue
                if done:
                    return
                if paused:
                    # park only with the world synced (the block above ran
                    # first): a retrieve while parked sees the current board
                    with self._lock:
                        while self._paused and not self._quit:
                            self._parked = True
                            self._control.notify_all()
                            self._control.wait()
                        self._parked = False
                        if self._quit:
                            return
                    continue
                if plan is not None:
                    # roster drift (the probe readmitted a worker, or the
                    # thread cap changed the prefix): bring the world
                    # current and reseed so the split RE-EXPANDS
                    with self._lock:
                        active = list(self.clients)
                    n = self._legacy_plan_n(req, len(active), h)
                    if active[:n] != plan.active:
                        if behind and not self._resident_sync(plan, pool):
                            self._resident_recover(plan, pool)
                        plan = None
                if plan is None:
                    plan = self._resident_seed(req, h, depth, pool)
                    if plan is None:
                        return  # quit during seeding
                    continue  # re-evaluate gates with the fresh plan

                # -- one K-turn batch ---------------------------------------
                with self._lock:
                    turn0 = self._turn
                k = min(plan.k, req.turns - turn0)
                n = len(plan.active)
                turn_span = (
                    _tracing.start_span(
                        _tracing.SPAN_BROKER_TURN, turn=turn0, batch=k
                    )
                    if _tracing.enabled() else None
                )
                tp = turn_span.ctx() if turn_span else None
                t_batch = time.monotonic()
                attribution = self._attribution_on()
                sink = [] if attribution else None
                try:
                    deadline = self._scatter_deadline()
                    futures = []
                    halo_bytes = 0  # strip halos are all row-axis traffic
                    for i in range(n):
                        # the worker's next halos are its neighbours'
                        # boundary rows at turn0: the strip above
                        # contributes its LAST k rows, the strip below its
                        # FIRST k (n == 1 wraps onto itself)
                        top = plan.edges[(i - 1) % n][1][-k:]
                        bottom = plan.edges[(i + 1) % n][0][:k]
                        halo_bytes += top.nbytes + bottom.nbytes
                        req_i = Request(
                            world=np.concatenate([top, bottom], axis=0),
                            worker=i,
                            turns=k,
                            initial_turn=turn0,
                        )
                        if sink is not None:
                            futures.append(pool.submit(
                                self._timed_call, plan.active[i],
                                Methods.STRIP_STEP, req_i, deadline, tp,
                                sink, i,
                            ))
                        else:
                            futures.append(pool.submit(
                                self._call_worker, plan.active[i],
                                Methods.STRIP_STEP, req_i, deadline, tp,
                            ))
                    t_submitted = time.monotonic()
                    results, dead = self._bounded_gather(futures, deadline)
                    t_gathered = time.monotonic()
                    check = _integrity.enabled()
                    attests = [None] * n
                    for i, res in enumerate(results):
                        if res is None:
                            continue
                        edges = getattr(res, "edges", None)
                        if (
                            res.turns_completed != turn0 + k
                            or edges is None
                            or edges.shape[0] != 2 * k
                        ):
                            # a malformed success is a protocol violation,
                            # not a committable strip
                            dead.append(i)
                            results[i] = None
                            continue
                        dig = getattr(res, "digests", None) if check else None
                        if not isinstance(dig, dict):
                            # non-attesting peer (version skew, or its
                            # -integrity is off): skew-safe skip — the
                            # chain stops being tracked for this worker
                            continue
                        # digest chain: the strip this worker stepped FROM
                        # must be the strip the broker last committed for
                        # it — an in-place corruption between batches
                        # (bit flip, buggy kernel scribble) fails here,
                        # within one K-turn batch of happening
                        _ins.INTEGRITY_CHECKS_TOTAL.inc()
                        if (
                            plan.digests[i] is not None
                            and dig.get("pre") != plan.digests[i]
                        ):
                            self._integrity_suspect(
                                plan, i, "strip",
                                f"pre-batch strip digest at turn {turn0} "
                                "does not match the committed chain",
                            )
                            dead.append(i)
                            results[i] = None
                            continue
                        # reply-edge digest: covers the worker-side
                        # serialisation of the rows the neighbours will
                        # step from next batch
                        _ins.INTEGRITY_CHECKS_TOTAL.inc()
                        if dig.get("edges") != _integrity.state_digest(edges):
                            self._integrity_suspect(
                                plan, i, "edges",
                                "returned edge rows do not match their "
                                "attested digest",
                            )
                            dead.append(i)
                            results[i] = None
                            continue
                        attests[i] = (
                            dig.get("attest_top"), dig.get("attest_bottom")
                        )
                    # halo cross-attestation: neighbouring strips compute
                    # the boundary band REDUNDANTLY at every intermediate
                    # shrinking step (worker i's block starts where worker
                    # i-1's ends), so their rolled band digests must agree —
                    # a worker computing wrong rows near a boundary is
                    # caught here, in the same batch, instead of poisoning
                    # the board until the next sync. Disagreement cannot
                    # name the liar, so BOTH are suspects: recovery
                    # rebuilds from the verified last sync either way.
                    suspects = set()
                    for i in range(n):
                        up = (i - 1) % n
                        if results[i] is None or results[up] is None:
                            continue
                        a, b = attests[i], attests[up]
                        if not a or not b or not a[0] or not b[1]:
                            continue
                        _ins.INTEGRITY_CHECKS_TOTAL.inc()
                        if a[0] != b[1]:
                            self._integrity_suspect(
                                plan, i, "attest",
                                f"boundary band digests disagree with "
                                f"worker {up} across the batch at turn "
                                f"{turn0}",
                            )
                            suspects.update((i, up))
                    for i in suspects:
                        dead.append(i)
                        results[i] = None
                    if dead:
                        with self._lock:
                            if self._quit:
                                return  # shutdown race, not a failure
                        for i in sorted(set(dead)):
                            self._mark_lost(plan.active[i], "strip step failed")
                        _ins.TURN_RETRY_TOTAL.inc()
                        with self._lock:
                            left = len(self.clients)
                        logger.warning(
                            "%d worker(s) lost mid-batch at turn %d; "
                            "recovering over %d",
                            len(set(dead)), turn0, left,
                        )
                        _journal.record(
                            "recovery.resplit", "resident", turn=turn0,
                            lost=len(set(dead)), remaining=left,
                        )
                        self._resident_recover(plan, pool, tp)
                        plan = None
                        continue
                    # commit: every strip advanced turn0 -> turn0 + k in
                    # lockstep; only the fresh boundary rows came back.
                    # The ticker feed needs the LANDING turn's count only
                    # (each reply's counts[-1] — the intermediate steps
                    # are unobservable between batches)
                    total = 0
                    for res in results:
                        counts = getattr(res, "counts", None) or []
                        if counts:
                            total += int(counts[-1])
                    for i, res in enumerate(results):
                        # shape/None-validated in the reply loop above;
                        # getattr keeps the read skew-safe regardless
                        edges = getattr(res, "edges", None)
                        halo_bytes += edges.nbytes
                        plan.edges[i] = (edges[:k], edges[k:])
                        # advance the digest chain to the committed turn
                        # (None = this worker stopped attesting: the chain
                        # is no longer checkable for it, never guessed)
                        dig = getattr(res, "digests", None)
                        plan.digests[i] = (
                            dig.get("strip")
                            if check and isinstance(dig, dict)
                            else None
                        )
                    with self._lock:
                        self._turn = turn0 + k
                        self._record_alive(turn0 + k, total)
                    # the batch's dirty-tile bitmaps: the cluster-level
                    # frontier gauge + the delta-checkpoint window
                    self._note_batch_dirty(results, plan, h)
                    _ins.TURN_BATCH_SIZE.observe(k)
                    if _metrics.enabled():
                        # committed batches only, both directions: the
                        # strip plane's halos are entirely row traffic
                        _ins.HALO_BYTES_TOTAL.labels("row").inc(halo_bytes)
                    if attribution:
                        # per-addr StripStep walls + critical-path gating
                        # (obs/critical.py) and the K-batch's dispatch-wall
                        # decomposition — committed batches only, so a loss
                        # retry never skews the attribution
                        self._feed_critical(
                            sink, plan.active, turn0 + k, k, strip=True
                        )
                        self._observe_segments(
                            t_submitted - t_batch,
                            t_gathered - t_submitted,
                            time.monotonic() - t_gathered,
                            sink,
                        )
                finally:
                    _tracing.end_span(turn_span)
                # clean batches only, like the scatter loop; the EWMA unit
                # here is one BATCH (what one deadline must cover)
                dt = time.monotonic() - t_batch
                self._turn_seconds = (
                    dt if self._turn_seconds is None
                    else 0.9 * self._turn_seconds + 0.1 * dt
                )
                _faults.fault_point("broker.turn_commit")
                self._maybe_auto_checkpoint()
        finally:
            # every exit ships a current board (the Run/Retrieve contract):
            # best-effort fetch, falling back to the local rebuild
            with self._lock:
                behind = self._sync_turn != self._turn
            if behind:
                if plan is None or not self._resident_sync(plan, pool):
                    if plan is not None:
                        self._resident_recover(plan, pool)
            with self._lock:
                self._control.notify_all()  # wake any sync-waiting retrieve
            pool.shutdown(wait=False)

    # -- the 2-D tile data plane (-grid) -----------------------------------

    def _recompute_block(self, world, s, e, x0, x1, steps):
        """_recompute_rows' 2-D twin: block [s, e) x [x0, x1) at ``steps``
        turns past ``world``, stepped locally over the block's 2-D
        dependency cone (``steps`` extra cells per side, toroidal wrap on
        BOTH axes) with the workers' own non-wrapping tile kernel — so
        the rebuild is bit-identical to what the lost tile's worker would
        have computed."""
        from .worker import _tile_step, compute_strip

        h, w = world.shape
        if (e - s) + 2 * steps >= h or (x1 - x0) + 2 * steps >= w:
            # the cone wraps a full axis: plain full-board stepping is
            # cheaper than a wider-than-the-board block
            for _ in range(steps):
                world = compute_strip(world, 0, h)
            return world[s:e, x0:x1]
        block = world[np.ix_(
            np.arange(s - steps, e + steps) % h,
            np.arange(x0 - steps, x1 + steps) % w,
        )]
        for _ in range(steps):
            block = _tile_step(block)  # 2 fewer rows AND cols per step
        return block

    def _tile_seed(self, req, h: int, w: int, depth: int, pool, tp=None):
        """_resident_seed's checkerboard twin: lay the current full board
        out as the resolved rows x cols grid and ``StripStart`` every
        tile (the grid extension fields mark the session 2-D; the worker
        keeps the block resident). Loops over losses like the strip seed.
        A roster that shrank below the grid mid-run degrades to the
        squarest layout of the survivors — readmission drifts the roster
        and reseeds back up. Returns None on quit."""
        while True:
            with self._lock:
                if self._quit:
                    return None
                active = list(self.clients)
                world, turn = self._world, self._turn
            if not active:
                raise RpcError("all workers lost mid-run")
            rows, cols = self._run_grid
            if rows * cols > len(active):
                rows, cols = _auto_grid(len(active), h, w)
            n = rows * cols
            active = active[:n]
            rbounds = self._split(h, rows)
            cbounds = self._split(w, cols)
            bounds = [
                (s, e, x0, x1) for s, e in rbounds for x0, x1 in cbounds
            ]
            # the batch depth K clamps to the thinnest tile DIMENSION:
            # corner halos are K x K blocks, so a tile cannot relay more
            # edge cells than its shorter side holds
            k = max(1, min(
                depth,
                min(e - s for s, e in rbounds),
                min(x1 - x0 for x0, x1 in cbounds),
            ))
            deadline = self._scatter_deadline()
            futures = [
                pool.submit(
                    self._call_worker,
                    active[i],
                    Methods.STRIP_START,
                    Request(
                        world=world[s:e, x0:x1],
                        worker=i,
                        initial_turn=turn,
                        start_y=s,
                        end_y=e,
                        grid_rows=rows,
                        grid_cols=cols,
                        start_x=x0,
                        end_x=x1,
                    ),
                    deadline,
                    tp,
                )
                for i, (s, e, x0, x1) in enumerate(bounds)
            ]
            _, dead = self._bounded_gather(futures, deadline)
            if not dead:
                edges = [
                    (
                        world[s:s + k, x0:x1],
                        world[e - k:e, x0:x1],
                        world[s:e, x0:x0 + k],
                        world[s:e, x1 - k:x1],
                    )
                    for s, e, x0, x1 in bounds
                ]
                # anchor the digest chain from the cells the broker
                # itself sent — independent of anything the workers claim
                digests = (
                    [
                        _integrity.state_digest(world[s:e, x0:x1])
                        for s, e, x0, x1 in bounds
                    ]
                    if _integrity.enabled()
                    else None
                )
                if _metrics.enabled():
                    _ins.TILE_GRID_ROWS.set(rows)
                    _ins.TILE_GRID_COLS.set(cols)
                    th = max(e - s for s, e in rbounds)
                    tw = max(x1 - x0 for x0, x1 in cbounds)
                    _ins.TILE_EDGE_CELLS.set(2 * k * (th + tw) + 4 * k * k)
                return _TilePlan(
                    active, bounds, (rows, cols), k, edges, digests
                )
            for i in dead:
                self._mark_lost(active[i], "tile seed failed")

    def _tile_sync(self, plan, pool, tp=None) -> bool:
        """_resident_sync for a tile plan: gather every resident tile
        (``StripFetch``, dirty-tile deltas included — the wire-tile codec
        is already 2-D) and reassemble the full board at the committed turn.
        Same contract: True on success, False after marking failures or
        diverged tiles lost."""
        from ..ops import sparse as _sparse

        with self._lock:
            turn = self._turn
            base_world, base_turn = self._world, self._sync_turn
        self._sync_count += 1
        use_delta = (
            self._sparse_sync
            and base_world is not None
            and self._sync_count % _KEYFRAME_SYNCS != 0
        )
        delta_base = base_turn if use_delta else -1
        deadline = self._scatter_deadline()
        futures = [
            pool.submit(
                self._call_worker, c, Methods.STRIP_FETCH,
                Request(worker=i, delta_base_turn=delta_base), deadline, tp,
            )
            for i, c in enumerate(plan.active)
        ]
        results, dead = self._bounded_gather(futures, deadline)
        ok = True
        for i in dead:
            self._mark_lost(plan.active[i], "tile sync failed")
            ok = False
        tiles: list[np.ndarray | None] = [None] * len(plan.active)
        for i, res in enumerate(results):
            if res is None:
                continue
            s, e, x0, x1 = plan.bounds[i]
            dirty = getattr(res, "dirty", None)
            if isinstance(dirty, np.ndarray):
                payload = np.asarray(res.work_slice, np.uint8)
                try:
                    tile = _sparse.apply_dirty_tiles(
                        np.asarray(base_world[s:e, x0:x1], np.uint8),
                        np.asarray(dirty, bool),
                        payload,
                    )
                except (ValueError, IndexError, TypeError):
                    self._mark_lost(plan.active[i], "tile delta malformed")
                    ok = False
                    continue
                if _metrics.enabled():
                    _ins.SPARSE_FRAME_BYTES_TOTAL.inc(
                        payload.nbytes + dirty.size
                    )
            else:
                tile = np.asarray(res.work_slice, np.uint8)
            if res.turns_completed != turn or tile.shape != (e - s, x1 - x0):
                self._mark_lost(plan.active[i], "tile lockstep divergence")
                ok = False
            elif plan.digests[i] is not None and _integrity.enabled():
                _ins.INTEGRITY_CHECKS_TOTAL.inc()
                if _integrity.state_digest(tile) != plan.digests[i]:
                    self._integrity_suspect(
                        plan, i, "fetch",
                        f"fetched tile at turn {turn} does not match "
                        "the committed digest chain",
                    )
                    self._mark_lost(
                        plan.active[i], "tile fetch digest mismatch"
                    )
                    ok = False
                else:
                    tiles[i] = tile
            else:
                tiles[i] = tile
        if not ok:
            return False
        # block assignment copies out of the receive-buffer views
        # (protocol-5 sidecars), so the world outlives its frames; the
        # last tile is the bottom-right block, so its bounds are (h, w)
        world = np.empty((plan.bounds[-1][1], plan.bounds[-1][3]), np.uint8)
        for i, (s, e, x0, x1) in enumerate(plan.bounds):
            world[s:e, x0:x1] = tiles[i]
        with self._lock:
            self._world = world
            self._sync_turn = turn
        _ins.STRIP_RESYNC_TOTAL.inc()
        return True

    def _tile_recover(self, plan, pool, tp=None) -> None:
        """_resident_recover over 2-D blocks: survivor tiles still AT the
        committed turn contribute verbatim (digest-verified); blocks held
        by lost workers — or survivors already past the commit — are
        rebuilt locally through the 2-D dependency cone
        (``_recompute_block``), bit-identical, bounded by
        ``-sync-interval``."""
        with self._lock:
            base, t0, t1 = self._world, self._sync_turn, self._turn
            alive = {id(c) for c in self.clients}
        if t1 == t0:
            return  # the loss landed at a boundary: world already current
        parts: dict[int, np.ndarray] = {}
        survivors = [
            (i, c) for i, c in enumerate(plan.active) if id(c) in alive
        ]
        if survivors:
            deadline = self._scatter_deadline()
            futures = [
                pool.submit(
                    self._call_worker, c, Methods.STRIP_FETCH,
                    Request(worker=i), deadline, tp,
                )
                for i, c in survivors
            ]
            results, dead = self._bounded_gather(futures, deadline)
            for j in dead:
                self._mark_lost(survivors[j][1], "tile recovery fetch failed")
            for j, res in enumerate(results):
                if res is None:
                    continue
                i = survivors[j][0]
                s, e, x0, x1 = plan.bounds[i]
                tile = np.asarray(res.work_slice, np.uint8)
                if res.turns_completed == t1 and tile.shape == (e - s, x1 - x0):
                    if plan.digests[i] is not None and _integrity.enabled():
                        _ins.INTEGRITY_CHECKS_TOTAL.inc()
                        if _integrity.state_digest(tile) != plan.digests[i]:
                            self._integrity_suspect(
                                plan, i, "fetch",
                                f"survivor tile at turn {t1} does not "
                                "match the committed digest chain",
                            )
                            self._mark_lost(
                                plan.active[i],
                                "tile recovery digest mismatch",
                            )
                            continue
                    parts[i] = tile
        world = np.empty_like(base)
        steps = t1 - t0
        for i, (s, e, x0, x1) in enumerate(plan.bounds):
            if i in parts:
                world[s:e, x0:x1] = parts[i]
            else:
                world[s:e, x0:x1] = self._recompute_block(
                    base, s, e, x0, x1, steps
                )
        with self._lock:
            self._world = world
            self._sync_turn = t1
        _ins.STRIP_RESYNC_TOTAL.inc()

    def _tile_turn_loop(
        self, req, h: int, w: int, initial_turn: int = 0
    ) -> None:
        """The resident loop over a 2-D checkerboard (-grid): tiles stay
        on the workers, each K-turn batch moves the depth-K halos of all
        four edges PLUS the four K x K corner blocks down (bit-packed —
        the dependency cone of a K-step batch) and the four fresh edge
        bands back up, so per-worker wire cost is O(K·(tile_h + tile_w))
        instead of the strip plane's O(K·W), and the worker count is no
        longer capped at H. Corners never ride the uplink: the broker
        derives tile (r, c)'s next corner halos from its DIAGONAL
        neighbours' row bands. Lockstep/sync/recovery/attestation
        contracts are the strip loop's, generalized."""
        import concurrent.futures

        from .worker import (
            _packed_len,
            pack_tile_blocks,
            tile_edge_shapes,
            unpack_tile_blocks,
        )

        depth = getattr(req, "halo_depth", 0) or self._halo_depth
        pool_size = max(1, len(self.clients), len(self.addresses))
        pool = concurrent.futures.ThreadPoolExecutor(pool_size)
        plan = None
        try:
            while True:
                with self._lock:
                    if self._quit:
                        return
                    paused = self._paused
                    behind = self._sync_turn != self._turn
                    done = self._turn >= req.turns
                    want_sync = behind and (
                        done
                        or paused
                        or self._sync_requested
                        or self._ckpt_due()
                        or (
                            self._sync_interval
                            and self._turn - self._sync_turn
                            >= self._sync_interval
                        )
                    )
                if want_sync:
                    if plan is not None and not self._tile_sync(plan, pool):
                        self._tile_recover(plan, pool)
                        plan = None
                    with self._lock:
                        if self._sync_turn == self._turn:
                            self._sync_requested = False
                            self._control.notify_all()
                    continue
                if done:
                    return
                if paused:
                    with self._lock:
                        while self._paused and not self._quit:
                            self._parked = True
                            self._control.notify_all()
                            self._control.wait()
                        self._parked = False
                        if self._quit:
                            return
                    continue
                if plan is not None:
                    # roster drift: readmission (or recovery from a
                    # degraded layout) reseeds so the grid RE-EXPANDS
                    with self._lock:
                        active = list(self.clients)
                    rows, cols = self._run_grid
                    if rows * cols > len(active):
                        rows, cols = _auto_grid(len(active), h, w)
                    if (
                        (rows, cols) != plan.grid
                        or active[:rows * cols] != plan.active
                    ):
                        if behind and not self._tile_sync(plan, pool):
                            self._tile_recover(plan, pool)
                        plan = None
                if plan is None:
                    plan = self._tile_seed(req, h, w, depth, pool)
                    if plan is None:
                        return  # quit during seeding
                    continue  # re-evaluate gates with the fresh plan

                # -- one K-turn batch ----------------------------------
                with self._lock:
                    turn0 = self._turn
                k = min(plan.k, req.turns - turn0)
                n = len(plan.active)
                rows, cols = plan.grid
                turn_span = (
                    _tracing.start_span(
                        _tracing.SPAN_BROKER_TURN, turn=turn0, batch=k
                    )
                    if _tracing.enabled() else None
                )
                tp = turn_span.ctx() if turn_span else None
                t_batch = time.monotonic()
                attribution = self._attribution_on()
                sink = [] if attribution else None
                try:
                    deadline = self._scatter_deadline()
                    futures = []
                    halo_row_b = halo_col_b = halo_corner_b = 0
                    edge_shapes = [
                        tile_edge_shapes(k, e - s, x1 - x0)
                        for s, e, x0, x1 in plan.bounds
                    ]
                    for i in range(n):
                        # tile (r, c)'s next halos at turn0: edge bands
                        # from the four adjacent tiles, corner blocks cut
                        # from the DIAGONAL neighbours' row bands (a 1-col
                        # or 1-row grid wraps onto itself, same toroidal
                        # rule as the strip plane's n == 1)
                        r, c = divmod(i, cols)
                        up = plan.edges[((r - 1) % rows) * cols + c]
                        dn = plan.edges[((r + 1) % rows) * cols + c]
                        lf = plan.edges[r * cols + (c - 1) % cols]
                        rt = plan.edges[r * cols + (c + 1) % cols]
                        tl = plan.edges[((r - 1) % rows) * cols + (c - 1) % cols]
                        tr = plan.edges[((r - 1) % rows) * cols + (c + 1) % cols]
                        bl = plan.edges[((r + 1) % rows) * cols + (c - 1) % cols]
                        br = plan.edges[((r + 1) % rows) * cols + (c + 1) % cols]
                        buf = pack_tile_blocks((
                            up[1][-k:],       # top halo rows
                            dn[0][:k],        # bottom halo rows
                            lf[3][:, -k:],    # left halo cols
                            rt[2][:, :k],     # right halo cols
                            tl[1][-k:, -k:],  # top-left corner
                            tr[1][-k:, :k],   # top-right corner
                            bl[0][:k, -k:],   # bottom-left corner
                            br[0][:k, :k],    # bottom-right corner
                        ))
                        sh = edge_shapes[i]
                        halo_row_b += 2 * _packed_len(sh[0])
                        halo_col_b += 2 * _packed_len(sh[2])
                        halo_corner_b += 4 * _packed_len((k, k))
                        req_i = Request(
                            world=buf,
                            worker=i,
                            turns=k,
                            initial_turn=turn0,
                        )
                        if sink is not None:
                            futures.append(pool.submit(
                                self._timed_call, plan.active[i],
                                Methods.STRIP_STEP, req_i, deadline, tp,
                                sink, i,
                            ))
                        else:
                            futures.append(pool.submit(
                                self._call_worker, plan.active[i],
                                Methods.STRIP_STEP, req_i, deadline, tp,
                            ))
                    t_submitted = time.monotonic()
                    results, dead = self._bounded_gather(futures, deadline)
                    t_gathered = time.monotonic()
                    check = _integrity.enabled()
                    attests: list[dict | None] = [None] * n
                    for i, res in enumerate(results):
                        if res is None:
                            continue
                        edges = getattr(res, "edges", None)
                        want = sum(_packed_len(sh) for sh in edge_shapes[i])
                        if (
                            res.turns_completed != turn0 + k
                            or edges is None
                            or getattr(edges, "ndim", 0) != 1
                            or edges.size != want
                        ):
                            # a malformed success is a protocol violation
                            dead.append(i)
                            results[i] = None
                            continue
                        halo_row_b += 2 * _packed_len(edge_shapes[i][0])
                        halo_col_b += 2 * _packed_len(edge_shapes[i][2])
                        dig = getattr(res, "digests", None) if check else None
                        if not isinstance(dig, dict):
                            continue  # non-attesting peer: skew-safe skip
                        _ins.INTEGRITY_CHECKS_TOTAL.inc()
                        if (
                            plan.digests[i] is not None
                            and dig.get("pre") != plan.digests[i]
                        ):
                            self._integrity_suspect(
                                plan, i, "strip",
                                f"pre-batch tile digest at turn {turn0} "
                                "does not match the committed chain",
                            )
                            dead.append(i)
                            results[i] = None
                            continue
                        _ins.INTEGRITY_CHECKS_TOTAL.inc()
                        if dig.get("edges") != _integrity.state_digest(edges):
                            self._integrity_suspect(
                                plan, i, "edges",
                                "returned edge bands do not match their "
                                "attested digest",
                            )
                            dead.append(i)
                            results[i] = None
                            continue
                        attests[i] = dig
                    # 2-D halo cross-attestation: every shared edge AND
                    # corner is computed redundantly by both parties at
                    # each shrinking step; four directed comparisons per
                    # tile (up, left, and the two upward diagonals) cover
                    # all eight adjacency relations grid-wide. A
                    # disagreement cannot name the liar: BOTH parties are
                    # quarantined, recovery rebuilds from the last
                    # verified sync.
                    suspects = set()
                    pairs = (
                        ("attest_top", -1, 0, "attest_bottom"),
                        ("attest_left", 0, -1, "attest_right"),
                        ("attest_tl", -1, -1, "attest_br"),
                        ("attest_tr", -1, 1, "attest_bl"),
                    )
                    for i in range(n):
                        if results[i] is None or attests[i] is None:
                            continue
                        r, c = divmod(i, cols)
                        for mine, dr, dc, theirs in pairs:
                            j = ((r + dr) % rows) * cols + (c + dc) % cols
                            if results[j] is None or attests[j] is None:
                                continue
                            a = attests[i].get(mine)
                            b = attests[j].get(theirs)
                            if not a or not b:
                                continue
                            _ins.INTEGRITY_CHECKS_TOTAL.inc()
                            if a != b:
                                self._integrity_suspect(
                                    plan, i, "attest",
                                    f"{mine} band digests disagree with "
                                    f"tile {j}'s {theirs} across the "
                                    f"batch at turn {turn0}",
                                )
                                suspects.update((i, j))
                    for i in suspects:
                        dead.append(i)
                        results[i] = None
                    if dead:
                        with self._lock:
                            if self._quit:
                                return  # shutdown race, not a failure
                        for i in sorted(set(dead)):
                            self._mark_lost(plan.active[i], "tile step failed")
                        _ins.TURN_RETRY_TOTAL.inc()
                        with self._lock:
                            left = len(self.clients)
                        logger.warning(
                            "%d tile(s) lost mid-batch at turn %d; "
                            "recovering over %d",
                            len(set(dead)), turn0, left,
                        )
                        _journal.record(
                            "recovery.resplit", "tile", turn=turn0,
                            lost=len(set(dead)), remaining=left,
                        )
                        self._tile_recover(plan, pool, tp)
                        plan = None
                        continue
                    # commit: lockstep advance, fresh edge bands only
                    total = 0
                    for res in results:
                        counts = getattr(res, "counts", None) or []
                        if counts:
                            total += int(counts[-1])
                    for i, res in enumerate(results):
                        edges = getattr(res, "edges", None)
                        plan.edges[i] = tuple(
                            unpack_tile_blocks(edges, edge_shapes[i])
                        )
                        dig = getattr(res, "digests", None)
                        plan.digests[i] = (
                            dig.get("strip")
                            if check and isinstance(dig, dict)
                            else None
                        )
                    with self._lock:
                        self._turn = turn0 + k
                        self._record_alive(turn0 + k, total)
                    self._note_batch_dirty(results, plan, h)
                    _ins.TURN_BATCH_SIZE.observe(k)
                    if _metrics.enabled():
                        # committed batches, both directions, split by
                        # axis — the O(K·edge) vs O(K·W) scaling claim is
                        # measured, not asserted
                        _ins.HALO_BYTES_TOTAL.labels("row").inc(halo_row_b)
                        _ins.HALO_BYTES_TOTAL.labels("col").inc(halo_col_b)
                        _ins.HALO_BYTES_TOTAL.labels("corner").inc(
                            halo_corner_b
                        )
                    if attribution:
                        self._feed_critical(
                            sink, plan.active, turn0 + k, k, strip=True
                        )
                        self._observe_segments(
                            t_submitted - t_batch,
                            t_gathered - t_submitted,
                            time.monotonic() - t_gathered,
                            sink,
                        )
                finally:
                    _tracing.end_span(turn_span)
                dt = time.monotonic() - t_batch
                self._turn_seconds = (
                    dt if self._turn_seconds is None
                    else 0.9 * self._turn_seconds + 0.1 * dt
                )
                _faults.fault_point("broker.turn_commit")
                self._maybe_auto_checkpoint()
        finally:
            with self._lock:
                behind = self._sync_turn != self._turn
            if behind:
                if plan is None or not self._tile_sync(plan, pool):
                    if plan is not None:
                        self._tile_recover(plan, pool)
            with self._lock:
                self._control.notify_all()  # wake any sync-waiting retrieve
            pool.shutdown(wait=False)

    def _record_alive(self, turn: int, count: int) -> None:
        """THE alive-count feed for every wire mode: ``retrieve`` serves
        the 2-second AliveCellsCount ticker from this sample instead of
        counting a gathered board — in resident mode there is no per-turn
        board to count, and one shared helper keeps the backends from
        drifting. Caller must hold ``self._lock`` and record in the SAME
        critical section that commits ``self._turn``: a ticker retrieve
        between the two would otherwise pair the new turn with a stale
        count (in resident mode the fallback board is the last sync —
        up to -sync-interval turns old)."""
        self._alive = (turn, count)

    # -- fault tolerance ---------------------------------------------------

    def _integrity_suspect(self, plan, i, kind: str, detail: str) -> None:
        """Record one integrity violation loudly (metric by kind, flight
        event, error log). The caller then routes the suspect through the
        EXISTING loss machinery — recovery rebuilds the committed turn
        from the last verified sync, the probe quarantines/readmits."""
        _ins.INTEGRITY_FAILURES_TOTAL.labels(kind).inc()
        with self._lock:
            addr = self._client_addr.get(id(plan.active[i]), "<local>")
        _flight.record("integrity.fail", addr, check=kind)
        _journal.record("integrity.fail", addr, check=kind, detail=detail[:200])
        logger.error(
            "INTEGRITY violation (%s) from worker %s: %s", kind, addr, detail
        )

    def _note_batch_dirty(self, results, plan, height: int) -> None:
        """Fold one committed K-batch's per-strip dirty bitmaps
        (``StripStep`` replies, ops/sparse.py wire tiles) into the
        cluster frontier gauge and the global dirty grid the delta
        auto-checkpoint cuts tiles from. A reply without the field — a
        version-skewed worker — poisons the window: the next checkpoint
        falls back to a full keyframe rather than trust a partial view.
        Turn-loop-local state only; no lock needed."""
        if not self._auto_checkpoint and not _metrics.enabled():
            return  # nobody consumes the bitmaps: keep the hot loop clean
        from ..ops.sparse import WIRE_TILE_COLS, WIRE_TILE_ROWS, wire_tile_grid

        total_dirty = 0
        known = True
        for res in results:
            d = getattr(res, "dirty", None)
            if isinstance(d, np.ndarray):
                total_dirty += int(np.count_nonzero(d))
            else:
                known = False
        if _metrics.enabled() and known:
            _ins.ACTIVE_TILES.set(total_dirty)
        if not self._auto_checkpoint:
            return
        if not known:
            # window unknown -> the next write is a full keyframe
            self._ckpt_dirty = None
            self._last_batch_dirty = None
            return
        with self._lock:
            world = self._world
        width = world.shape[1] if world is not None else 0
        grid_shape = wire_tile_grid((height, width))
        batch_dirty = np.zeros(grid_shape, bool)
        for i, res in enumerate(results):
            d = getattr(res, "dirty", None)
            b = plan.bounds[i]
            # strip bounds are (s, e); tile bounds carry the column band
            # too, (s, e, x0, x1) — a full-width strip is x0=0, x1=width
            s, e = b[0], b[1]
            x0, x1 = (b[2], b[3]) if len(b) > 2 else (0, width)
            tis, tjs = np.nonzero(d)
            if not tis.size:
                continue
            # block tile rows/cols -> the global bands they overlap. A
            # block tile is exactly WIRE_TILE_ROWS x WIRE_TILE_COLS
            # (ragged at the block edge), so it spans at most TWO global
            # bands per axis — marking the four corner band combinations
            # covers the range, fully vectorized (the per-tile Python
            # loop here measured as a real per-batch stall on big dirty
            # grids). For full-width strips the column offset is zero and
            # tiles align, so gc0 == gc1 == tjs: identical marks to the
            # strip-only version
            r0 = s + tis * WIRE_TILE_ROWS
            r1 = np.minimum(
                s + np.minimum((tis + 1) * WIRE_TILE_ROWS, e - s), e
            ) - 1
            c0 = x0 + tjs * WIRE_TILE_COLS
            c1 = np.minimum(
                x0 + np.minimum((tjs + 1) * WIRE_TILE_COLS, x1 - x0), x1
            ) - 1
            gr0, gr1 = r0 // WIRE_TILE_ROWS, r1 // WIRE_TILE_ROWS
            gc0, gc1 = c0 // WIRE_TILE_COLS, c1 // WIRE_TILE_COLS
            batch_dirty[gr0, gc0] = True
            batch_dirty[gr0, gc1] = True
            batch_dirty[gr1, gc0] = True
            batch_dirty[gr1, gc1] = True
        # the latest batch's own grid is kept separately: a full keyframe
        # captures the world at its SYNC turn, and this batch's changes
        # are already past it — they must seed the next window, not be
        # zeroed with the old one (_maybe_auto_checkpoint)
        self._last_batch_dirty = batch_dirty
        if self._ckpt_dirty is not None and self._ckpt_dirty.shape == grid_shape:
            self._ckpt_dirty |= batch_dirty
        else:
            self._ckpt_dirty = None

    def _ckpt_due(self) -> bool:
        """Whether the time-based auto-checkpoint wants to write — split
        out so the resident loop can sync the world FIRST (the checkpoint
        snapshots the last synced board; without the pre-sync it would
        always trail by up to -sync-interval turns)."""
        return bool(self._auto_checkpoint) and (
            time.monotonic() - self._last_ckpt >= self._auto_checkpoint[0]
        )

    def _scatter_deadline(self) -> float:
        """Reply bound for one scatter call. ``-rpc-deadline`` pins it;
        otherwise it adapts to the observed turn time. Published on the
        ``gol_scatter_deadline_seconds`` gauge so the timeline sampler
        sees the EWMA drift (the 'scatter-deadline-growth' SLO rule:
        a cluster getting slower before anything has failed)."""
        if self._rpc_deadline:
            deadline = self._rpc_deadline
        elif self._turn_seconds is None:
            deadline = _DEADLINE_COLD
        else:
            deadline = max(_DEADLINE_FLOOR, 20.0 * self._turn_seconds + 1.0)
        _ins.SCATTER_DEADLINE_SECONDS.set(deadline)
        return deadline

    def _mark_lost(self, client, reason: str) -> None:
        """Drop a dead/stalled worker: CLOSE its client (a leaked corpse
        costs every later Status poll and super_quit a timeout each),
        remove it from the scatter set, and hand its address to the probe
        thread for readmission."""
        try:
            client.close()
        # gol: allow(hygiene): best-effort close of an already-dead
        # transport — the loss itself is logged + metered just below
        except Exception:
            pass
        backoff = 0.0
        with self._lock:
            if client in self.clients:
                self.clients.remove(client)
            addr = self._client_addr.pop(id(client), None)
            if addr is not None:
                # escalate across REPEAT losses (the entry survives
                # readmission): a flapper — e.g. compute-wedged but still
                # answering the probe's Status — would otherwise be
                # readmitted every probe interval and tax every turn a
                # deadline; doubling to the long cap bounds that tax
                backoff = min(
                    _LOSS_BACKOFF_CAP,
                    self._probe_backoff.get(addr, self._probe_interval) * 2,
                )
                self._probe_backoff[addr] = backoff
                self._lost[addr] = time.monotonic() + backoff
        _ins.WORKER_LOST_TOTAL.inc()
        _flight.record("worker.lost", addr or "<local>", reason=reason)
        _journal.record(
            "worker.lost", addr or "<local>", reason=reason,
            backoff_s=round(backoff, 2),
        )
        if addr is not None and backoff > self._probe_interval:
            # an escalated backoff IS the quarantine decision — journal it
            # as its own lifecycle event so history/doctor can correlate
            # repeat losses with the flap window
            _journal.record(
                "worker.quarantine", addr, backoff_s=round(backoff, 2)
            )
        logger.warning("worker %s lost (%s)", addr or "<local>", reason)

    def _probe_loop(self) -> None:
        """Background readmission: every lost or never-connected roster
        address is re-dialled under per-address capped exponential backoff,
        and must answer a full ``GameOfLifeOperations.Status`` round-trip —
        a TCP accept is not proof of life (a wedged path accepts happily) —
        before its fresh client joins the scatter set. The next turn's
        plan() then re-expands the row split: capacity recovers.

        Due addresses are probed serially (a deliberate simplicity trade:
        with many unreachable-host addresses — SYN blackholes, not
        refusals — one pass can take a few seconds per corpse, delaying a
        recovered worker's readmission by that much)."""
        tick = min(self._probe_interval, 0.25)
        while not self._probe_stop.wait(tick):
            now = time.monotonic()
            with self._lock:
                due = [a for a, t in self._lost.items() if t <= now]
            for addr in due:
                client = None
                try:
                    client = RpcClient(addr, timeout=2.0)
                    try:
                        client.call(
                            Methods.WORKER_STATUS, Request(), timeout=2.0
                        )
                    except RpcError as e:
                        # an error REPLY is a completed round-trip — the
                        # worker is alive (e.g. a version-skewed pre-Status
                        # worker answering "unknown method"); only
                        # transport-level RpcErrors (timeout, closed) mean
                        # the path is still dead
                        if not e.is_reply:
                            raise
                except (OSError, RpcError):
                    if client is not None:
                        client.close()
                    with self._lock:
                        # max(prev, ...): a failed probe of a DEAD address
                        # grows toward the short cap, but must never
                        # COLLAPSE a loss-escalated quarantine (cap 60 s)
                        # back down — that would un-quarantine a flapper
                        prev = self._probe_backoff.get(
                            addr, self._probe_interval
                        )
                        backoff = max(prev, min(_PROBE_BACKOFF_CAP, prev * 2))
                        self._probe_backoff[addr] = backoff
                        self._lost[addr] = (
                            time.monotonic()
                            + backoff * random.uniform(0.5, 1.5)
                        )
                    continue
                with self._lock:
                    if self._probe_stop.is_set():
                        client.close()
                        return
                    self._lost.pop(addr, None)
                    # the backoff entry is KEPT: if this readmission flaps
                    # straight back to lost, the next quarantine doubles
                    # from here instead of resetting to the probe interval
                    self.clients.append(client)
                    self._client_addr[id(client)] = addr
                    connected = len(self.clients)
                _ins.WORKER_READMITTED_TOTAL.inc()
                _flight.record("worker.readmit", addr)
                _journal.record("worker.readmit", addr, connected=connected)
                logger.info(
                    "worker %s readmitted; %d connected", addr, connected
                )

    def _maybe_auto_checkpoint(self) -> None:
        """Time-based crash-recovery snapshot of (world, turn, rule) in the
        engine/checkpoint.py byte-npz format, written tmp-then-rename so a
        crash mid-write leaves the previous checkpoint intact. Failures are
        logged, never fatal (the engine's checkpoint posture): a full disk
        must not abort the run this snapshot exists to protect.

        In resident wire mode, between full keyframes the write is a
        DELTA checkpoint: only the tiles the workers' StripStep dirty
        bitmaps marked since the last full generation
        (engine/checkpoint.save_delta_checkpoint — depth-1 against its
        keyframe, verified end-to-end). Every ``_CKPT_KEYFRAME_EVERY``-th
        write — and any write whose dirty window is unknown (fresh run,
        a skewed worker, the scatter wires) — is a full generation that
        clears the deltas and re-anchors the window."""
        if not self._auto_checkpoint:
            return
        secs, path = self._auto_checkpoint
        now = time.monotonic()
        if now - self._last_ckpt < secs:
            return
        self._last_ckpt = now  # interval pacing even across failures
        with self._lock:
            # the SYNC turn, not the committed turn: in resident mode the
            # broker's board trails the workers between syncs (the loop
            # pre-syncs when _ckpt_due, so this is normally current), and
            # a checkpoint must never pair a stale board with a newer turn
            world, turn = self._world, self._sync_turn
        from ..engine.checkpoint import (
            checkpoint_digest,
            clear_delta_checkpoints,
            npz_path,
            rotate_generations,
            save_checkpoint,
            save_delta_checkpoint,
        )
        from ..models import CONWAY
        from ..ops.sparse import wire_tile_grid

        self._ckpt_count += 1
        delta = (
            self._ckpt_dirty is not None
            and self._ckpt_base is not None
            and self._ckpt_count % _CKPT_KEYFRAME_EVERY != 0
            and world is not None
            and self._ckpt_dirty.shape == wire_tile_grid(world.shape)
            and turn > self._ckpt_base[0]
        )
        try:
            p = pathlib.Path(path)
            # CONWAY unconditionally: run() refused any other rule at entry
            if delta:
                save_delta_checkpoint(
                    p, world, self._ckpt_dirty, turn, CONWAY,
                    self._ckpt_base[0], self._ckpt_base[1],
                )
                # the dirty window stays: it accumulates SINCE THE
                # KEYFRAME, so every delta applies directly onto it
            else:
                tmp = p.with_name(p.name + ".tmp")
                written = save_checkpoint(tmp, world, turn, CONWAY)
                # -ckpt-keep N: shift current -> .g1 -> ... BEFORE the
                # rename, so a later generation that still verifies
                # survives a write (or a run) that corrupts the newest one
                rotate_generations(p, self._ckpt_keep)
                written.replace(npz_path(p))
                # deltas were cut against the PREVIOUS keyframe: their
                # base digest would refuse anyway, this keeps dir honest
                clear_delta_checkpoints(p)
                self._ckpt_base = (
                    turn,
                    checkpoint_digest(world, turn, CONWAY.rulestring),
                )
                # re-seed the window from the LATEST batch's dirty grid:
                # the keyframe captured the world at its sync turn, and
                # that batch's changes are already past it (zeroing here
                # would lose them from the next delta)
                if (
                    self._wire == "resident"
                    and world is not None
                    and self._last_batch_dirty is not None
                    and self._last_batch_dirty.shape
                    == wire_tile_grid(world.shape)
                ):
                    self._ckpt_dirty = self._last_batch_dirty.copy()
                else:
                    # no (or skewed) batch dirty info: the window stays
                    # unknown and the next write is another full keyframe
                    self._ckpt_dirty = None
        except Exception as exc:
            logger.error("auto-checkpoint at turn %d failed: %s", turn, exc)
            return
        _ins.AUTO_CHECKPOINT_TOTAL.inc()
        _flight.record("ckpt.auto", str(p), turn=turn, delta=bool(delta))
        _journal.record(
            "ckpt.write", "broker", turn=turn, delta=bool(delta),
            path=str(p),
        )

    def worker_health(self) -> list[dict]:
        """Per-address roster health for the Status payload (rendered as
        the watch dashboard's WORKERS column): connected clients first,
        then lost/never-connected addresses with their next probe ETA."""
        now = time.monotonic()
        with self._lock:
            health = [
                {
                    "address": self._client_addr.get(id(c), "<local>"),
                    "state": "connected",
                }
                for c in self.clients
            ]
            health += [
                {
                    "address": a,
                    "state": "lost",
                    "retry_in_s": round(max(0.0, t - now), 2),
                }
                for a, t in sorted(self._lost.items())
            ]
        return health

    def pause(self):
        """Toggle pause. On pause, blocks until the turn loop has actually
        parked (the in-flight turn has committed) — the same guarantee as
        ``Engine.pause`` (engine/engine.py), so the two backends give one
        semantics behind the ``Operations.Pause`` verb: a retrieve after
        pause() returns can never observe another turn."""
        with self._lock:
            self._paused = not self._paused
            self._control.notify_all()
            print("State paused" if self._paused else "State unpaused")
            if self._paused:
                # re-check _paused each wake: a concurrent unpause from
                # another handler thread means the loop never parks
                while (
                    self._paused
                    and self._running
                    and not self._parked
                    and not self._quit
                ):
                    self._control.wait(timeout=0.1)

    def quit(self):
        with self._lock:
            self._quit = True
            self._control.notify_all()

    def super_quit(self):
        # stop readmitting first: a worker that reappears during shutdown
        # must not be re-added behind the quit fan-out's back
        self._probe_stop.set()
        self.quit()
        # let the run loop (and its in-flight scatter) finish before taking
        # the workers down (broker/broker.go:241-249 quits loop, then workers)
        with self._lock:
            self._control.wait_for(lambda: not self._running, timeout=30)
            clients = list(self.clients)
        for client in clients:
            try:
                client.call(Methods.WORKER_QUIT, Request(), timeout=5.0)
            except (RpcError, OSError):
                # OSError too: a half-dead socket raising here used to
                # abort the loop and leave the REMAINING workers running
                pass
            try:
                client.close()
            # gol: allow(hygiene): best-effort close during cluster
            # teardown — the quit fan-out above already reported
            except Exception:
                pass
        # lost-but-ALIVE workers (deadline-evicted, quarantined, not yet
        # readmitted) must come down too — SuperQuit takes the whole
        # cluster down (broker/broker.go:241-249), not just the currently
        # connected subset. Best-effort dial per roster address.
        with self._lock:
            lost = sorted(self._lost)
        for addr in lost:
            try:
                client = RpcClient(addr, timeout=2.0)
            except OSError:
                continue  # genuinely dead: nothing to quit
            try:
                client.call(Methods.WORKER_QUIT, Request(), timeout=2.0)
            except (RpcError, OSError):
                pass
            finally:
                client.close()

    def close(self) -> None:
        """Release the broker side only: stop the readmission probe and
        close the worker clients. The workers keep running — SuperQuit is
        the verb that takes THEM down (the broker's shutdown and the tests
        release in-process backends through this without killing the
        cluster)."""
        self._probe_stop.set()
        with self._lock:
            clients, self.clients = list(self.clients), []
            self._client_addr.clear()
            self._lost.clear()
        for client in clients:
            try:
                client.close()
            # gol: allow(hygiene): best-effort broker-side release —
            # workers keep running by contract, nothing to report
            except Exception:
                pass

    def retrieve(self, include_world: bool) -> Snapshot:
        with self._lock:
            if (
                include_world
                and self._wire == "resident"
                and self._running
                and self._sync_turn != self._turn
            ):
                # snapshot boundary: ask the turn loop for a full re-sync
                # (StripFetch) and wait for it — the resident board lives
                # on the workers between syncs
                self._sync_requested = True
                self._control.notify_all()
                self._control.wait_for(
                    lambda: not self._running
                    or self._sync_turn == self._turn,
                    timeout=60.0,
                )
            world = self._world
            turn = self._turn
            alive = self._alive
            if include_world and self._sync_turn != turn:
                # the wait timed out mid-batch (a wedge being paid for):
                # serve a CONSISTENT (board, turn) pair from the last
                # sync rather than a newer turn number on an older board
                turn = self._sync_turn
                alive = None
        if world is None:
            return Snapshot(np.zeros((0, 0), np.uint8), 0, 0)
        if alive is not None and alive[0] == turn:
            count = alive[1]  # the shared per-turn feed (_record_alive)
        else:
            count = int(np.count_nonzero(world))
        return Snapshot(world if include_world else None, turn, count)

    def collect_remote_spans(self) -> list:
        """Each connected worker's finished spans, via its own Status verb
        — so ONE broker Status reply carries the whole fan-out topology and
        the controller's trace export gets a track per worker. Strictly
        best-effort with a short reply bound: a dead or wedged worker must
        cost 2 s, not hang the Status poll (the verb exists to debug
        exactly such runs); pre-Status workers reply without the field.
        Dead clients are CLOSED and dropped at loss time (_mark_lost), so
        this no longer pays a 2 s timeout per corpse."""
        spans: list = []
        with self._lock:
            clients = list(self.clients)
        for client in clients:
            try:
                res = client.call(Methods.WORKER_STATUS, Request(), timeout=2.0)
            except (RpcError, OSError):
                continue
            payload = getattr(res, "status", None) or {}
            spans.extend(payload.get("trace_spans") or [])
        return spans


class SessionScheduler:
    """Multi-universe serving: concurrent ``Operations.SessionRun`` verbs
    packed into ONE device-resident batch (engine/sessions.SessionTable).

    Each SessionRun keeps Run's blocking contract — the handler thread
    parks on its session's completion — while one driver thread advances
    the whole batch: one launch per k-turn chunk for every universe. The
    admission bound (``-session-capacity``) refuses loudly instead of
    queueing; the batch serves one geometry and rule at a time, and the
    first admission after the table drains may claim a new one.

    A nonzero client-chosen ``Request.session_id`` tags the session so a
    concurrent Retrieve with the same tag serves THAT universe. A tag
    whose session completed keeps serving its final snapshot from a cache
    bounded both by entries and by retained board bytes, oldest evicted
    first, so a poller trailing a fast universe gets the final snapshot
    rather than an error."""

    #: completed tagged sessions whose final snapshot stays retrievable
    _FINISHED_CAP = 1024
    _FINISHED_BYTES_CAP = 64 << 20  # 64 MiB of retained final boards

    # scheduler state moves under ONE lock, entered either directly or
    # through the _work Condition wrapping it (analysis/locks.py
    # accepts both context managers as the same guard)
    _GUARDED_BY = {
        "_table": ("_lock", "_work"),
        "_tags": ("_lock", "_work"),
        "_finished": ("_lock", "_work"),
        "_finished_bytes": ("_lock", "_work"),
        "_stop": ("_lock", "_work"),
        "_thread": ("_lock", "_work"),
    }

    def __init__(self, capacity: int = 256, max_chunk: int = 4096, device=None):
        if capacity < 1:
            raise ValueError(f"session capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.max_chunk = max_chunk
        self.device = resolve_device(device)
        # guards _table, _tags, _finished, _finished_bytes, _stop and
        # _thread; _work is the driver's wake-up on the same lock
        self._lock = _locksan.lock("SessionScheduler._lock")
        self._work = _locksan.condition("SessionScheduler._work", self._lock)
        self._table = None  # current SessionTable (one geometry/rule)
        self._tags: dict = {}  # session_id -> Session
        self._finished: collections.OrderedDict = collections.OrderedDict()
        self._finished_bytes = 0  # result bytes the cache pins
        self._thread: threading.Thread | None = None
        self._stop = False

    def submit(self, req: Request) -> RunResult:
        """Blocking: admit this Run into the batch, wait for its universe
        to finish, return its result. Raises ``SessionRejected`` on an
        admission refusal (an error reply to the client). The session's
        tag names its tenant (obs/accounting.tenant_of), whose ledger
        entry records the admission, its wait and any refusal."""
        from ..engine.sessions import SessionRejected, SessionTable, reject

        rule = _rule_of(req)
        shape = (req.image_height, req.image_width)
        world = np.asarray(req.world, np.uint8)
        tag = getattr(req, "session_id", 0)
        tenant = _acct.tenant_of(tag)
        ledger = _acct.ledger()
        # admission latency, entry to joining the table: the
        # 'session-admit-latency' SLO feed
        t_admit = time.monotonic()
        try:
            with self._work:
                if self._stop:
                    raise RpcError("broker is shutting down")
                if self._table is not None and self._table.occupancy == 0 and (
                    self._table.shape != shape
                    or self._table.rule.rulestring != rule.rulestring
                ):
                    self._table = None  # drained: a new geometry may claim it
                if self._table is None:
                    self._table = SessionTable(
                        rule, shape, self.capacity, max_chunk=self.max_chunk,
                        device=self.device,
                    )
                if self._table.rule.rulestring != rule.rulestring:
                    raise reject(
                        "rule",
                        f"this batch serves {self._table.rule.rulestring}, "
                        f"not {rule.rulestring} (one rule per batch)",
                        tenant=tenant,
                    )
                if tag and tag in self._tags:
                    raise reject("tag", f"session tag {tag} already in use", tenant=tenant)
                # geometry/capacity/turns admission happens in the table
                sess = self._table.admit(world, req.turns, tenant=tenant)
                if tag:
                    self._tags[tag] = sess
                    # a reused tag belongs to its NEW session now
                    old = self._finished.pop(tag, None)
                    if old is not None and old.result is not None:
                        self._finished_bytes -= old.result.nbytes
                if self._thread is None:
                    self._thread = threading.Thread(target=self._drive, daemon=True)
                    self._thread.start()
                self._work.notify_all()
                wait = time.monotonic() - t_admit
                _ins.SESSION_ADMIT_WAIT_SECONDS.observe(wait)
                ledger.record_admit(tenant, wait, world.nbytes)
        except SessionRejected as exc:
            # the per-tenant side of gol_sessions_rejected_total (metered
            # inside reject())
            ledger.record_reject(tenant, exc.reason)
            raise
        try:
            sess.done.wait()
        finally:
            with self._lock:
                # re-checked under the lock: a racing re-admission of the
                # tag owns it now and is never clobbered
                if tag and self._tags.get(tag) is sess:
                    del self._tags[tag]
                    if sess.error is None and sess.result is not None:
                        # healthy completions only: a failed or cancelled
                        # session stays a loud retrieve error
                        # gol: allow(atomicity): `sess` IS stale (admitted
                        # under the earlier critical section), but the
                        # check-then-act is re-validated HERE: the write
                        # is gated on _tags still mapping tag -> sess
                        # under this same lock, so a racing re-admission
                        # of the tag can never be clobbered
                        self._finished[tag] = sess
                        # gol: allow(atomicity): same re-validation — the
                        # byte count moves with the entry the line above
                        # just committed under this lock
                        self._finished_bytes += sess.result.nbytes
                        while self._finished and (
                            len(self._finished) > self._FINISHED_CAP
                            or self._finished_bytes > self._FINISHED_BYTES_CAP
                        ):
                            _, old = self._finished.popitem(last=False)
                            if old.result is not None:
                                self._finished_bytes -= old.result.nbytes
        if sess.error is not None:
            raise RpcError(f"session batch failed: {sess.error}")
        return RunResult(sess.turns_done, sess.result)

    def retrieve(self, tag: int, include_world: bool) -> Snapshot:
        """ONE universe's (turn, alive) pair — and optionally its board —
        demuxed from the batch; a completed tag from the finished cache; a
        tag never seen (or evicted) is a loud error, never a silent global
        snapshot."""
        with self._lock:
            sess = self._tags.get(tag)
            table = self._table
            done = self._finished.get(tag)
        if sess is not None and table is not None:
            world, turn, alive = table.snapshot(sess, include_world=include_world)
            return Snapshot(world, turn, alive)
        if done is not None:
            return Snapshot(
                done.result if include_world else None, done.turns_done, done.alive_count
            )
        raise RpcError(f"no session with tag {tag}")

    def _drive(self) -> None:
        """The driver thread: advance the batch whenever it has work; on
        an advance failure, fail every in-flight session loudly (their
        blocked handlers re-raise) rather than hang them."""
        while True:
            with self._work:
                while not self._stop and (
                    self._table is None or self._table.occupancy == 0
                ):
                    self._work.wait()
                if self._stop:
                    return
                table = self._table
            try:
                table.advance()
            except Exception as exc:  # noqa: BLE001 — must not hang waiters
                logger.exception("session batch driver failed")
                table.fail_all(exc)

    def close(self) -> None:
        with self._work:
            self._stop = True
            table, self._table = self._table, None
            self._work.notify_all()
        if table is not None:
            table.fail_all(RpcError("broker is shutting down"))


def _require_request(req) -> Request:
    """Skew tolerance is for Request objects missing newer fields (read
    with getattr), never for arbitrary frames: a missing/None/list request
    stays an error reply."""
    if not isinstance(req, Request):
        raise TypeError(f"request must be a Request, got {type(req).__name__}")
    return req


def _reply(result) -> Response:
    # alive stays empty on the wire: the client derives cells from the
    # world it receives instead of this side pickling O(alive) Cells
    return Response(
        alive=[],
        alive_count=int(np.count_nonzero(result.world)),
        turns_completed=result.turns_completed,
        world=result.world,
    )


class BrokerService:
    """Maps the wire verbs onto a backend; owns process shutdown. Every
    board a reply carries is a numpy uint8 array.

    ``resume`` is the crash-recovery stash of ``-resume``: a ``(world,
    turn, rule)`` checkpoint loaded at broker start. The first fresh Run
    (initial_turn 0) is rewritten to continue from the stashed turn, and
    the stash is consumed once that run has progressed past it; later
    Runs start fresh, the reference's reset-on-Run semantics."""

    def __init__(
        self,
        server: RpcServer,
        backend,
        resume=None,
        session_capacity: int = 256,
        device=None,
    ):
        self._server = server
        self.backend = backend
        # where SessionRun's batch lives: the device backend's own device,
        # else the broker's -device, resolved at the first SessionRun
        self._device = getattr(backend, "device", device)
        self._resume = resume  # (world, turn, rule) | None
        self.quit_event = threading.Event()
        # built lazily: a broker that never serves sessions never starts
        # the driver
        self._session_capacity = session_capacity
        self._sessions: SessionScheduler | None = None
        self._sessions_lock = threading.Lock()

    def _session_scheduler(self) -> SessionScheduler:
        with self._sessions_lock:
            if self._sessions is None:
                self._sessions = SessionScheduler(
                    self._session_capacity, device=self._device
                )
            return self._sessions

    def _apply_resume(self, req: Request) -> None:
        """Rewrite a fresh Run to continue from the ``-resume`` checkpoint.
        A mismatch is an error: an operator who restarted with -resume must
        not silently get a run from turn 0, or a mislabelled board."""
        world, turn, rule = self._resume
        if req.world is None or req.world.shape != world.shape:
            raise ValueError(
                f"-resume checkpoint board is "
                f"{world.shape[1]}x{world.shape[0]} but the Run asks "
                f"{req.image_width}x{req.image_height}"
            )
        if req.turns <= turn:
            raise ValueError(
                f"-resume checkpoint is at turn {turn}, not before "
                f"turns={req.turns}: nothing would run"
            )
        requested = getattr(req, "rulestring", "")
        if requested:
            # canonical before comparing: "b3/s23" is the Conway it spells
            requested = LifeRule.from_rulestring(requested).rulestring
            if requested != rule.rulestring:
                raise ValueError(
                    f"-resume checkpoint rule {rule.rulestring} conflicts "
                    f"with the Run's {requested}"
                )
        req.world = world
        req.initial_turn = turn
        if rule.rulestring != CONWAY.rulestring:
            req.rulestring = rule.rulestring
        logger.info("Run reattached to -resume checkpoint at turn %d", turn)
        _flight.record("ckpt.resume", "broker", turn=turn)
        _journal.record("ckpt.replay", "broker", turn=turn)

    def run(self, req: Request) -> Response:
        req = _require_request(req)
        resumed = False
        if self._resume is not None and not getattr(req, "initial_turn", 0):
            self._apply_resume(req)
            resumed = True
        initial_turn = getattr(req, "initial_turn", 0)
        if not 0 <= initial_turn <= req.turns:
            raise ValueError(f"initial_turn {initial_turn} outside [0, {req.turns}]")
        if req.world is not None and req.world.shape != (req.image_height, req.image_width):
            raise ValueError(
                f"world shape {req.world.shape} does not match params "
                f"{req.image_width}x{req.image_height}"
            )
        _journal.record(
            "run.start", "broker", turns=int(req.turns),
            initial_turn=initial_turn, resumed=resumed,
        )
        result = self.backend.run(req)
        _journal.record("run.end", "broker", turn=int(result.turns_completed))
        if resumed and result.turns_completed > initial_turn:
            # consumed only once the run progressed past the checkpoint: a
            # Run that a buffered Quit ended at once must not burn it, or
            # the retried Run would silently start from turn 0
            self._resume = None
        return _reply(result)

    def session_run(self, req: Request) -> Response:
        """Operations.SessionRun — Run's blocking contract, many at once:
        concurrent handler threads admit into one device-batched session
        table and each parks until ITS universe finishes."""
        req = _require_request(req)
        if req.world is None or req.world.shape != (req.image_height, req.image_width):
            raise ValueError(
                f"world shape {None if req.world is None else req.world.shape} "
                f"does not match params {req.image_width}x{req.image_height}"
            )
        return _reply(self._session_scheduler().submit(req))

    def pause(self, req: Request) -> Response:
        self.backend.pause()
        return Response()

    def quit(self, req: Request) -> Response:
        self.backend.quit()
        return Response()

    def super_quit(self, req: Request) -> Response:
        self.backend.super_quit()
        # reply first and let an in-flight Run return its result, THEN
        # close the listener (broker/broker.go:312-323's goroutine)
        threading.Thread(target=self._shutdown_when_idle, daemon=True).start()
        return Response()

    def _shutdown_when_idle(self):
        # waits until every dispatch, the SuperQuit call included, has
        # fully SENT its reply
        self._server.wait_idle(timeout=60)
        self.shutdown()

    def status(self, req: Request) -> Response:
        """Read-only registry snapshot (obs/): answerable mid-Run without
        touching the engine or the board, and without synchronising the
        card (the kernels' event pairs that have completed are folded in,
        obs/device.py). Ignores every request field but the incremental
        windows' ``*_since`` seqs (getattr: an older client's pickle lacks
        them and gets the full rings).

        With tracing on the payload carries this process's span and
        flight rings, and a workers backend folds in its workers' spans;
        with ``-timeline`` the metric-timeline window and the SLO alert
        states; the tenant ledger, journal tail and profile windows ride
        along when on (obs/report.status_payload)."""
        from ..obs.report import status_payload

        since = getattr(req, "timeline_since", 0)
        asince = getattr(req, "accounting_since", 0)
        jsince = getattr(req, "journal_since", 0)
        psince = getattr(req, "profile_since", 0)
        payload = status_payload(
            role="broker", backend=type(self.backend).__name__,
            timeline_since=since if isinstance(since, int) else 0,
            accounting_since=asince if isinstance(asince, int) else 0,
            journal_since=jsince if isinstance(jsince, int) else 0,
            profile_since=psince if isinstance(psince, int) else 0,
        )
        # the admission bound (-session-capacity)
        payload["session_capacity"] = self._session_capacity
        health = getattr(self.backend, "worker_health", None)
        if callable(health):
            try:
                payload["workers"] = health()
            except Exception as exc:  # health must never break Status
                payload["worker_health_error"] = str(exc)
        collect = getattr(self.backend, "collect_remote_spans", None)
        if callable(collect) and _tracing.enabled():
            try:
                payload.setdefault("trace_spans", []).extend(collect())
            except Exception as exc:  # a trace must never break Status
                payload["trace_collect_error"] = str(exc)
        return Response(status=payload)

    def retrieve(self, req: Request) -> Response:
        req = _require_request(req)
        include_world = getattr(req, "include_world", True)
        tag = getattr(req, "session_id", 0)
        if tag:
            snap = self._session_scheduler().retrieve(tag, include_world)
        else:
            snap = self.backend.retrieve(include_world)
        return Response(
            alive_count=snap.alive_count,
            turns_completed=snap.turns_completed,
            world=snap.world,
            alive=[],
        )

    def shutdown(self):
        """Fail in-flight sessions loudly, release the workers backend's
        side of its workers (they keep running: SuperQuit is what takes
        them down), close the listener, and release ``quit_event``."""
        with self._sessions_lock:
            sessions = self._sessions
        if sessions is not None:
            sessions.close()
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()
        self._server.stop()
        self.quit_event.set()


def serve(
    port: int = 8040,
    backend: str = "tpu",
    worker_addresses: list[str] | None = None,
    host: str = "127.0.0.1",
    wire: str = "haloed",
    halo_depth: int = 1,
    rpc_deadline: float | None = None,
    auto_checkpoint: tuple[float, str] | None = None,
    resume=None,
    probe_interval: float = 1.0,
    sync_interval: int = 256,
    ckpt_keep: int = 1,
    session_capacity: int = 256,
    sparse_sync: bool = True,
    grid: str | tuple[int, int] | None = None,
    device=None,
) -> tuple[RpcServer, BrokerService]:
    """Start a broker listening on ``host:port`` (0 picks a free port,
    ``server.port`` says which), serving in background threads; stop it
    with ``service.shutdown()``. ``backend`` "tpu" runs the board on
    ``device`` (None is the CUDA card, and raises without one; "cpu" for
    the tests); "workers" runs it over ``worker_addresses`` with the
    workers backend's knobs, and ``device`` is then where SessionRun's
    batch goes. ``resume`` is a verified ``(world, turn, rule)``
    checkpoint for the first fresh Run."""
    if backend == "workers":
        impl = WorkersBackend(
            worker_addresses or [],
            wire=wire,
            rpc_deadline=rpc_deadline,
            auto_checkpoint=auto_checkpoint,
            probe_interval=probe_interval,
            halo_depth=halo_depth,
            sync_interval=sync_interval,
            ckpt_keep=ckpt_keep,
            sparse_sync=sparse_sync,
            grid=grid,
        )
    else:
        impl = DeviceBackend(device, halo_depth=halo_depth)
    server = RpcServer(host=host, port=port)
    service = BrokerService(
        server, impl, resume=resume, session_capacity=session_capacity, device=device
    )
    server.register(Methods.BROKER_RUN, service.run)
    server.register(Methods.SESSION_RUN, service.session_run)
    server.register(Methods.PAUSE, service.pause)
    server.register(Methods.QUIT, service.quit)
    server.register(Methods.SUPER_QUIT, service.super_quit)
    server.register(Methods.RETRIEVE, service.retrieve)
    server.register(Methods.STATUS, service.status)
    server.serve_background()
    return server, service


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="GoL broker / engine server", allow_abbrev=False
    )
    parser.add_argument("-port", type=int, default=8040)
    parser.add_argument(
        "-backend", choices=("tpu", "workers"), default="tpu",
        help="tpu: the on-device engine (the reference's name for it; "
             "default); workers: scatter to -workers",
    )
    parser.add_argument(
        "-workers", default="",
        help="comma-separated worker addresses for -backend workers",
    )
    parser.add_argument(
        "-host", default="127.0.0.1",
        help="bind address; 0.0.0.0 opts into external exposure",
    )
    parser.add_argument(
        "-wire", choices=("haloed", "full", "resident"), default="haloed",
        help="workers-backend data plane: haloed strips (O(strip) bytes "
             "per turn, default), the reference-exact full board "
             "(broker/broker.go:144), or resident strips (stateful "
             "workers — only 2*K halo rows move per K-turn batch, K from "
             "-halo-depth; full boards gathered every -sync-interval "
             "turns and at snapshot/pause/checkpoint boundaries)",
    )
    parser.add_argument(
        "-halo-depth", dest="halo_depth", type=int, default=1,
        help="turns per halo exchange: with -wire resident the workers "
             "backend's batch depth K (K turns per StripStep round-trip); "
             "on the tpu backend the mesh planes' turns per halo exchange "
             "when it sees several devices (every card; on the CPU "
             "GOL_TORCH_CPU_DEVICES), vacuous on one device",
    )
    parser.add_argument(
        "-sync-interval", dest="sync_interval", type=int, default=256,
        metavar="TURNS",
        help="-wire resident: turns between periodic full strip "
             "re-syncs (bounds the local recompute a loss recovery pays; "
             "0 = only at snapshot/pause/checkpoint/run-end boundaries "
             "and losses)",
    )
    parser.add_argument(
        "-grid", default=None, metavar="CxR|auto",
        help="-wire resident: 2-D checkerboard worker layout — C tile "
             "columns x R tile rows, width-by-height like the board "
             "flags (1x4 is exactly four row strips), or auto (squarest "
             "factorization of the roster weighted by board aspect)",
    )
    parser.add_argument(
        "-sparse-sync", dest="sparse_sync", choices=("on", "off"),
        default="on",
        help="-wire resident: dirty-tile delta StripFetch syncs "
             "(ops/sparse.py wire tiles), digest-verified against the "
             "committed strip chain; every 16th sync is a full keyframe. "
             "off: always full frames",
    )
    parser.add_argument(
        "-rpc-deadline", dest="rpc_deadline", type=float, default=0.0,
        metavar="SECS",
        help="workers backend: reply bound for each per-turn scatter call "
             "(0, the default: adapt to the observed turn time). A worker "
             "exceeding it is treated as lost for that turn and its rows "
             "re-split over the survivors instead of wedging the run",
    )
    parser.add_argument(
        "-auto-checkpoint", dest="auto_checkpoint", nargs="+", default=None,
        metavar=("SECS", "PATH"),
        help="workers backend: snapshot (world, turn, rule) to PATH "
             "(default out/broker_ck.npz, engine/checkpoint.py npz format) "
             "at most every SECS seconds; restart with -resume PATH to "
             "reattach after a crash",
    )
    parser.add_argument(
        "-resume", default=None, metavar="CKPT",
        help="reattach a crashed run: the first fresh Run continues from "
             "this checkpoint's board and turn instead of turn 0 "
             "(consumed once; later Runs start fresh). The checkpoint "
             "must VERIFY (embedded digest, engine/checkpoint.py); with "
             "-ckpt-keep N an unverifiable newest generation falls back "
             "to the newest one that does verify",
    )
    parser.add_argument(
        "-ckpt-keep", dest="ckpt_keep", type=int, default=1, metavar="N",
        help="checkpoint generations to retain: -auto-checkpoint rotates "
             "current -> .g1 -> ... before each write, and -resume falls "
             "back to the newest generation that verifies (default 1: "
             "current only)",
    )
    parser.add_argument(
        "-integrity", choices=("on", "off"), default="on",
        help="frame checksums + resident-strip attestation digests "
             "(rpc/integrity.py). Default on; off disables both "
             "advertising and checking",
    )
    parser.add_argument(
        "-session-capacity", dest="session_capacity", type=int, default=256,
        metavar="N",
        help="max concurrent SessionRun universes in the device batch; "
             "admissions past it are refused with an error reply",
    )
    parser.add_argument(
        "-probe-interval", dest="probe_interval", type=float, default=1.0,
        metavar="SECS",
        help="workers backend: base cadence of the background readmission "
             "probe for lost/never-connected -workers addresses",
    )
    parser.add_argument(
        "-device", default="cuda",
        help="where the tpu backend's board and SessionRun's batch live: "
             "cuda (default; fails without a card) or cpu. The workers "
             "backend holds no board on a device",
    )
    _obs_cli.add_obs_flags(parser, "broker")
    parser.add_argument(
        "-canary", nargs="?", const=5.0, default=None, type=float,
        metavar="SECS",
        help="run the blackbox canary prober (obs/canary.py) in-process "
             "against this broker's own port at this cadence (default "
             "5 s): a known-oracle universe through the full RPC + "
             "session path every period, bit-exact or metered as a "
             "failure (pair with -timeline so the 'canary-failure' SLO "
             "rule pages); implies -metrics",
    )
    parser.add_argument(
        "-canary-verb", dest="canary_verb", choices=("session", "run"),
        default="session",
        help="-canary probe path: SessionRun + tagged retrieve (default; "
             "safe beside live traffic) or the classic blocking Run — "
             "exercises the backend data plane itself (workers scatter / "
             "resident strips), but collides with real single-board Runs",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    _obs_cli.enable_obs(parser, args, "broker")
    _integrity.set_enabled(args.integrity == "on")
    # the reference broker's checks, in its order and with its messages
    if args.ckpt_keep < 1:
        parser.error(f"-ckpt-keep must be >= 1, got {args.ckpt_keep}")
    if args.ckpt_keep != 1 and args.backend != "workers" and not args.resume:
        parser.error("-ckpt-keep rotates -auto-checkpoint generations "
                     "(workers backend) and widens -resume's fallback "
                     "search; it does nothing here")
    if args.halo_depth < 1:
        parser.error(f"-halo-depth must be >= 1, got {args.halo_depth}")
    if args.session_capacity < 1:
        parser.error(f"-session-capacity must be >= 1, got {args.session_capacity}")
    if args.halo_depth > 1 and args.backend == "workers" and args.wire != "resident":
        parser.error(
            "-halo-depth on the workers backend needs -wire resident "
            "(stateful strips); the per-turn scatter wires have no "
            "batching to honor it"
        )
    if args.sync_interval < 0:
        parser.error(f"-sync-interval must be >= 0, got {args.sync_interval}")
    if args.sync_interval != 256 and args.wire != "resident":
        parser.error("-sync-interval is a -wire resident knob")
    if args.sparse_sync != "on" and args.wire != "resident":
        parser.error("-sparse-sync is a -wire resident knob")
    if args.grid is not None:
        if args.backend != "workers" or args.wire != "resident":
            parser.error(
                "-grid is a workers-backend -wire resident knob "
                "(the tpu backend lays out its own device mesh)"
            )
        try:
            parse_grid(args.grid)
        except ValueError as exc:
            parser.error(str(exc))
    if args.rpc_deadline < 0:
        parser.error(f"-rpc-deadline must be >= 0, got {args.rpc_deadline}")
    if args.probe_interval <= 0:
        parser.error(f"-probe-interval must be > 0, got {args.probe_interval}")
    if args.rpc_deadline and args.backend != "workers":
        parser.error("-rpc-deadline is a workers-backend knob (scatter "
                     "calls); the tpu backend has no per-turn fan-out")
    auto_checkpoint = None
    if args.auto_checkpoint is not None:
        if args.backend != "workers":
            parser.error("-auto-checkpoint is a workers-backend knob; the "
                         "tpu backend checkpoints via the engine")
        if len(args.auto_checkpoint) > 2:
            parser.error("-auto-checkpoint takes SECS [PATH]")
        try:
            secs = float(args.auto_checkpoint[0])
        except ValueError:
            parser.error(
                f"-auto-checkpoint SECS must be a number, got "
                f"{args.auto_checkpoint[0]!r}"
            )
        if secs < 0:
            parser.error(f"-auto-checkpoint SECS must be >= 0, got {secs}")
        path = args.auto_checkpoint[1] if len(args.auto_checkpoint) > 1 else "out/broker_ck.npz"
        auto_checkpoint = (secs, path)
    resume = None
    if args.resume:
        from ..engine.checkpoint import CheckpointError, load_resume_checkpoint

        try:
            board, turn, rule, gen = load_resume_checkpoint(args.resume, keep=args.ckpt_keep)
        except CheckpointError as exc:
            parser.error(f"-resume {args.resume}: {exc}")
        if gen > 0:
            logger.warning(
                "-resume %s: newest generation(s) failed verification; "
                "fell back to verified generation %d (turn %d)",
                args.resume, gen, turn,
            )
        resume = (board, turn, rule)
    if args.canary is not None and args.canary <= 0:
        parser.error(f"-canary SECS must be > 0, got {args.canary}")
    device = args.device
    if args.backend != "workers":
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            parser.error(str(e))
    addresses = [a for a in args.workers.split(",") if a]
    server, service = serve(
        args.port, args.backend, addresses, host=args.host, wire=args.wire,
        halo_depth=args.halo_depth,
        rpc_deadline=args.rpc_deadline or None,
        auto_checkpoint=auto_checkpoint,
        resume=resume,
        probe_interval=args.probe_interval,
        sync_interval=args.sync_interval,
        ckpt_keep=args.ckpt_keep,
        session_capacity=args.session_capacity,
        sparse_sync=args.sparse_sync == "on",
        grid=args.grid,
        device=device,
    )
    print(f"broker listening on :{server.port} (backend={args.backend})", flush=True)
    canary = None
    if args.canary is not None:
        # after serve(): the prober dials the BOUND port over a real
        # socket — the full client path, not an in-process shortcut.
        # Dial the bound interface: a broker on -host 10.0.0.5 does not
        # listen on loopback, and a canary refused every period would
        # page 'canary-failure' on a healthy path forever
        from ..obs import metrics
        from ..obs.canary import CanaryProber

        metrics.enable()  # the probe counters must record
        probe_host = "127.0.0.1" if args.host in ("0.0.0.0", "::") else args.host
        canary = CanaryProber(
            f"{probe_host}:{server.port}", period=args.canary, verb=args.canary_verb,
        )
        canary.start()
    with _obs_cli.ObsLifetime():
        try:
            service.quit_event.wait()
        finally:
            if canary is not None:
                canary.stop()


if __name__ == "__main__":
    main()
