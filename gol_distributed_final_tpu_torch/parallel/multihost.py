"""Multi-process scaffolding: joining the job, the ranks' collectives, and
the rows a process owns.

The reference scales by adding worker addresses to a hardcoded list
(broker/broker.go:288-300) and ships the whole board to each. The JAX
package joins processes with ``jax.distributed`` into one global mesh
(its ``parallel/multihost.py``). Here the processes join a
``torch.distributed`` process group, NCCL between cards and gloo between
CPUs. A rank holds every card of its host (``device`` "cuda") or the one
card it names ("cuda:N", the usual one rank per card); NCCL binds each
rank to one card, its collective device, which ``initialize`` makes
current. The mesh spans every rank's devices (parallel/mesh.py), halos
cross ranks as point-to-point messages staged on the collective device
(parallel/halo.py), and each process reads and writes only its own row
range of a streamed PGM (``host_row_range`` with io/sharded.py).

The collectives here are the few the session needs outside the halos: a
control word broadcast from rank 0, a barrier, and an all-gather of small
host arrays (counts, votes, times). Every rank must call each of them in
the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Join the job's process group (``torch.distributed.
    init_process_group`` over TCP at ``coordinator_address``,
    ``host:port``, which rank 0 listens on): NCCL when ``device`` is the
    card (the default), gloo for the CPU. On the card the rank's
    collective device, the card ``device`` names (cuda:0 for plain
    "cuda"), is made current first. A no-op returning False for a single
    process, so the same code serves one host and many."""
    if num_processes is None or num_processes <= 1:
        return False
    import torch.distributed as dist

    if not coordinator_address:
        raise ValueError("a multi-process job needs the coordinator's host:port")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev.index or 0)
    address = coordinator_address
    if "://" not in address:
        address = "tcp://" + address
    dist.init_process_group(
        backend, init_method=address, world_size=num_processes, rank=process_id
    )
    return True


def is_initialized() -> bool:
    """Whether this process belongs to a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The job's ranks: the process group's size, 1 without one."""
    if not is_initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    if not is_initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def host_row_range(mesh, height: int) -> tuple[int, int]:
    """The [start, stop) board rows this process's devices own under the
    canonical board sharding: its slice of a streamed PGM read or write."""
    from .mesh import ROWS

    n_rows = mesh.shape[ROWS]
    if height % n_rows:
        raise ValueError(f"height {height} does not divide over {n_rows} row shards")
    block = height // n_rows
    me = process_index()
    mesh_rows = [r for r in range(n_rows) if any(d.rank == me for d in mesh.devices[r])]
    if not mesh_rows:
        raise ValueError("this process owns no devices in the mesh")
    lo, hi = min(mesh_rows), max(mesh_rows)
    if set(range(lo, hi + 1)) != set(mesh_rows):
        raise ValueError(
            "this process's mesh rows are not contiguous; use a process-major "
            "device order when building the mesh"
        )
    return lo * block, (hi + 1) * block


def collective_device() -> torch.device:
    """Where a collective's tensors live: NCCL moves only tensors on the
    rank's current card (``initialize``), gloo CPU tensors."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_int(word: int) -> int:
    """Rank 0's ``word`` on every rank (an int32 broadcast); the value
    itself without a process group."""
    if not is_initialized():
        return int(word)
    import torch.distributed as dist

    t = torch.tensor([int(word)], dtype=torch.int32, device=collective_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def barrier() -> None:
    """Every rank waits here for the others; nothing without a group."""
    if not is_initialized():
        return
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def allgather(values) -> np.ndarray:
    """Every rank's ``values`` (a small numpy array, the same shape and
    dtype on every rank) stacked by rank: ``[process_count(), *shape]``."""
    arr = np.ascontiguousarray(values)
    if not is_initialized():
        return arr[None]
    import torch.distributed as dist

    t = torch.from_numpy(arr.copy()).to(collective_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def exchange(sends: dict, recvs: dict) -> None:
    """Point-to-point messages in one batch: ``sends`` maps a peer rank to
    the tensor sent to it, ``recvs`` a peer rank to the tensor its message
    lands in, all on ``collective_device()``. Every rank posts all of its
    sends and receives together (``batch_isend_irecv``), so two ranks
    sending to each other cannot deadlock; returns when all have
    completed."""
    if not sends and not recvs:
        return
    import torch.distributed as dist

    ops = [dist.P2POp(dist.isend, t, peer) for peer, t in sorted(sends.items())]
    ops += [dist.P2POp(dist.irecv, t, peer) for peer, t in sorted(recvs.items())]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
