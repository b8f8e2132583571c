"""The device mesh, and the board sharded over it.

The reference's "cluster topology" is a hardcoded list of 8 worker
addresses (broker/broker.go:288-300). The JAX package's is a
``jax.sharding.Mesh`` over ('rows', 'cols'), with one controller driving
every device through ``shard_map``. The port keeps both of its levels:

* one process holds a (rows, cols) grid of shards, each a tensor on its
  own ``torch.device``. Several shards may sit on one device: that is how
  the CPU tests build the JAX tests' 8-device meshes (the virtual CPU
  devices of utils/cpumesh.py), and how one card holds a real
  multi-shard mesh;
* across processes, each mesh slot also names the rank that owns it, and
  the ranks are a ``torch.distributed`` process group
  (parallel/multihost.py). The default device order is process-major, as
  ``jax.devices()`` is, so a (processes, local) mesh gives each rank one
  mesh row. A rank's local devices are every card of its host, or the one
  card it names (``local_devices``).

``ShardedBoard`` is the port's counterpart of a mesh-sharded
``jax.Array``: the global shape, and this process's blocks of the
canonical (rows over 'rows', cols over 'cols') sharding. It is fully
addressable when every block is in this process.

``shard_map_compat`` has no counterpart: the port runs the per-block
program as a Python loop over the local blocks, the halos being tensor
copies inside a process and point-to-point messages between processes
(parallel/halo.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import multihost

ROWS, COLS = "rows", "cols"


class MeshDevice(NamedTuple):
    """One mesh slot: the rank that owns it and the device its block
    lives on (a device of that rank's host)."""

    rank: int
    device: torch.device


def best_mesh_shape(n_devices: int, height: int, width: int) -> tuple[int, int]:
    """Pick a (rows, cols) mesh factorisation of ``n_devices``.

    Prefers the most square factorisation that divides the board evenly:
    a 2-D decomposition halves the per-device halo perimeter against 1-D
    at the same device count. Falls back toward 1-D if the board doesn't
    divide."""
    best = (n_devices, 1)
    best_score = None
    for r in range(1, n_devices + 1):
        if n_devices % r:
            continue
        c = n_devices // r
        if height % r or width % c:
            continue
        # minimise halo perimeter per device: w/c + h/r (two row edges of
        # length w/c, two col edges of length h/r)
        score = width // c + height // r
        if best_score is None or score < best_score:
            best, best_score = (r, c), score
    if best_score is None:
        raise ValueError(
            f"no (rows, cols) factorisation of {n_devices} devices divides "
            f"a {height}x{width} board evenly"
        )
    return best


def local_devices(device=None) -> list[torch.device]:
    """This process's mesh devices: every card for ``device`` "cuda" (the
    default), the one card ``device`` names ("cuda:N", one rank per card),
    or ``utils/cpumesh.cpu_device_count()`` virtual CPU devices for the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        from ..utils.cpumesh import cpu_device_count

        return [torch.device("cpu")] * cpu_device_count()
    return [dev]


def global_devices(device=None) -> list[MeshDevice]:
    """Every rank's mesh devices, process-major (rank 0's first), each
    rank holding as many as this one: the ``jax.devices()`` of the port."""
    local = local_devices(device)
    return [MeshDevice(rank, d) for rank in range(multihost.process_count()) for d in local]


def _as_mesh_device(entry) -> MeshDevice:
    if isinstance(entry, MeshDevice):
        return entry
    return MeshDevice(multihost.process_index(), torch.device(entry))


class Mesh:
    """A (rows, cols) grid of ``MeshDevice`` slots. ``shape`` maps 'rows'
    and 'cols' to the grid's extent, as a ``jax.sharding.Mesh``'s does."""

    axis_names = (ROWS, COLS)

    def __init__(self, devices, shape: tuple[int, int]):
        r, c = shape
        flat = [_as_mesh_device(d) for d in devices]
        if r * c != len(flat):
            raise ValueError(f"mesh shape {shape} does not use all {len(flat)} devices")
        self.devices = tuple(tuple(flat[i * c:(i + 1) * c]) for i in range(r))
        self.shape = {ROWS: r, COLS: c}

    @property
    def grid(self) -> tuple[int, int]:
        return self.shape[ROWS], self.shape[COLS]

    def slot(self, i: int, j: int) -> MeshDevice:
        return self.devices[i][j]

    def local_slots(self) -> list[tuple[int, int]]:
        """The (row, col) slots this process owns, row-major."""
        me = multihost.process_index()
        r, c = self.grid
        return [(i, j) for i in range(r) for j in range(c) if self.devices[i][j].rank == me]

    @property
    def is_fully_local(self) -> bool:
        me = multihost.process_index()
        return all(d.rank == me for row in self.devices for d in row)

    def __repr__(self) -> str:
        return f"Mesh({self.grid}, devices={[d.device for row in self.devices for d in row]})"


def make_mesh(
    shape: tuple[int, int] | None = None,
    devices=None,
    *,
    height: int | None = None,
    width: int | None = None,
    device=None,
) -> Mesh:
    """Build a ('rows', 'cols') mesh over ``devices`` (default: every
    rank's devices of ``device``'s type, the card unless named; entries
    may be ``MeshDevice``s or, for this process, plain devices).

    If ``shape`` is omitted, chooses via ``best_mesh_shape`` (requires
    height/width)."""
    if devices is None:
        devices = global_devices(device)
    devices = list(devices)
    if shape is None:
        if height is None or width is None:
            raise ValueError("either shape or (height, width) is required")
        shape = best_mesh_shape(len(devices), height, width)
    return Mesh(devices, shape)


class BlockSharding:
    """The canonical sharding of a 2-D array over a mesh: rows over
    'rows', cols over 'cols' (the JAX package's ``NamedSharding(mesh,
    P('rows', 'cols'))``). Two are equal when they name the same mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __eq__(self, other):
        return isinstance(other, BlockSharding) and other.mesh is self.mesh

    def __hash__(self):
        return id(self.mesh)

    def block_shape(self, shape) -> tuple[int, int]:
        r, c = self.mesh.grid
        h, w = shape
        if h % r or w % c:
            raise ValueError(
                f"a {h}x{w} array does not divide over the {r}x{c} mesh"
            )
        return h // r, w // c

    def place(self, array) -> "ShardedBoard":
        """A whole array (numpy or tensor; every block local) cut into the
        mesh's blocks, each moved to its slot's device."""
        return ShardedBoard.from_global(self.mesh, array)


class ShardedBoard:
    """A 2-D array sharded over a mesh: ``shape`` is the global shape,
    ``blocks`` maps each of this process's (row, col) slots to its block,
    a tensor on the slot's device. Steps never write a block in place."""

    def __init__(self, mesh: Mesh, shape, blocks: dict):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.blocks = blocks

    # -- construction -------------------------------------------------------

    @classmethod
    def from_global(cls, mesh: Mesh, array) -> "ShardedBoard":
        """Cut a whole array into blocks; every slot must be this
        process's."""
        if not mesh.is_fully_local:
            raise ValueError(
                "a whole array can only be placed on a mesh this process owns "
                "entirely; use from_process_local on each rank"
            )
        t = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.array(array))
        bh, bw = BlockSharding(mesh).block_shape(tuple(t.shape))
        blocks = {
            (i, j): t[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw].to(
                mesh.slot(i, j).device, copy=True
            ).contiguous()
            for i, j in mesh.local_slots()
        }
        return cls(mesh, t.shape, blocks)

    @classmethod
    def from_process_local(cls, mesh: Mesh, local, global_shape) -> "ShardedBoard":
        """This process's contiguous block of whole rows (numpy or tensor,
        the rows of the mesh rows it owns, every column), cut into its
        blocks: the ``jax.make_array_from_process_local_data`` of the
        port. Each rank calls it with its own rows."""
        t = local if isinstance(local, torch.Tensor) else torch.from_numpy(np.array(local))
        bh, bw = BlockSharding(mesh).block_shape(global_shape)
        slots = mesh.local_slots()
        row0 = _whole_row_start(mesh, slots, global_shape[1] // bw)
        if tuple(t.shape) != (len({i for i, _ in slots}) * bh, global_shape[1]):
            raise ValueError(
                f"process-local rows {tuple(t.shape)} do not match this process's "
                f"{len({i for i, _ in slots})} mesh rows of {bh} x {global_shape[1]}"
            )
        blocks = {
            (i, j): t[(i - row0) * bh:(i - row0 + 1) * bh, j * bw:(j + 1) * bw].to(
                mesh.slot(i, j).device, copy=True
            ).contiguous()
            for i, j in slots
        }
        return cls(mesh, global_shape, blocks)

    def with_blocks(self, blocks: dict) -> "ShardedBoard":
        """A board on the same mesh with new blocks of one shape (the
        global shape follows from it)."""
        bh, bw = next(iter(blocks.values())).shape
        r, c = self.mesh.grid
        return ShardedBoard(self.mesh, (bh * r, bw * c), blocks)

    # -- what callers read --------------------------------------------------

    @property
    def sharding(self) -> BlockSharding:
        return BlockSharding(self.mesh)

    @property
    def block_shape(self) -> tuple[int, int]:
        return self.sharding.block_shape(self.shape)

    @property
    def dtype(self):
        return next(iter(self.blocks.values())).dtype

    @property
    def is_fully_addressable(self) -> bool:
        return self.mesh.is_fully_local

    @property
    def device(self) -> torch.device:
        """The device of this process's first block."""
        return next(iter(self.blocks.values())).device

    @property
    def is_cuda(self) -> bool:
        return any(b.is_cuda for b in self.blocks.values())

    @property
    def cuda_devices(self) -> list[torch.device]:
        """The distinct cards this process's blocks live on."""
        return sorted({b.device for b in self.blocks.values() if b.is_cuda},
                      key=lambda d: d.index or 0)

    @property
    def addressable_shards(self) -> list[tuple[tuple[slice, slice], torch.Tensor]]:
        """``(index, block)`` of this process's blocks, the index being the
        block's slices of the global array."""
        bh, bw = self.block_shape
        return [((slice(i * bh, (i + 1) * bh), slice(j * bw, (j + 1) * bw)), b)
                for (i, j), b in sorted(self.blocks.items())]

    def local_rows(self) -> tuple[int, torch.Tensor]:
        """This process's whole rows, assembled from its blocks:
        ``(first global row, rows)`` on the first block's device. Raises
        unless the process owns whole, contiguous mesh rows."""
        bh, bw = self.block_shape
        slots = sorted(self.blocks)
        row0 = _whole_row_start(self.mesh, slots, self.shape[1] // bw)
        dev = self.device
        rows = sorted({i for i, _ in slots})
        out = torch.cat([
            torch.cat([self.blocks[i, j].to(dev) for j in range(self.mesh.grid[1])], dim=1)
            for i in rows
        ], dim=0)
        return row0 * bh, out

    def gather(self) -> torch.Tensor:
        """The whole array as one tensor on the first block's device: a
        fully addressable board only."""
        if not self.is_fully_addressable:
            raise ValueError(
                "a board sharded over several processes cannot be gathered in "
                "one; read this process's rows with local_rows()"
            )
        return self.local_rows()[1]

    def numpy(self) -> np.ndarray:
        return self.gather().cpu().numpy()


def _whole_row_start(mesh: Mesh, slots, n_cols: int) -> int:
    """The first mesh row of ``slots``, which must be whole, contiguous
    mesh rows."""
    if not slots:
        raise ValueError("this process owns no blocks of the mesh")
    rows = sorted({i for i, _ in slots})
    if rows != list(range(rows[0], rows[-1] + 1)) or len(slots) != len(rows) * n_cols:
        raise ValueError(
            "this process's shards do not cover a contiguous whole-row "
            "block; use a process-major ('rows', 'cols') mesh placement"
        )
    return rows[0]
