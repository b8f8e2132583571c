"""One rank of a two-process job of the PyTorch port on the CPU (gloo), for
tests/test_torch_multihost.py.

Each rank holds four virtual CPU devices (GOL_TORCH_CPU_DEVICES=4) and one
row of the global (2, 4) mesh, so every halo on the rows axis crosses the
process boundary. The rank:

1. steps the 64^2 golden board 100 turns on the byte halo plane from its
   own rows only, and writes them into one shared PGM at its offset
   (io/sharded.py: rank 0 creates it, rank 1 writes at
   ``pgm_raster_offset``);
2. loads the 512^2 board from its PGM rows (packed), checks the global
   alive count and a window across the ranks' boundary that every rank
   decodes alike;
3. writes its checkpoint shard, corrupts rank 1's, and checks that the
   load fails on BOTH ranks (the local reason on rank 1, the agreement on
   rank 0) instead of stranding one inside the collective;
4. runs the engine with a vanishing dispatch target: the ranks agree on
   the slowest wall, so chunk growth stops at one turn everywhere;
5. refuses checkpoint_every on a multi-process state without a packed
   plane, before any collective.

Usage: torch_multihost_child.py <coordinator> <num_procs> <rank> <tmpdir>
"""

import pathlib
import sys

import numpy as np


def main() -> int:
    coordinator, num_procs, rank, tmpdir = sys.argv[1:5]
    num_procs, rank, tmpdir = int(num_procs), int(rank), pathlib.Path(tmpdir)
    repo = pathlib.Path(__file__).resolve().parents[1]

    from gol_distributed_final_tpu_torch.engine.checkpoint import (
        checkpoint_shard_path, load_packed_checkpoint_sharded, save_packed_checkpoint_sharded,
    )
    from gol_distributed_final_tpu_torch.engine.engine import Engine, EngineConfig
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm
    from gol_distributed_final_tpu_torch.io.sharded import (
        create_pgm, pgm_raster_offset, write_rows_at,
    )
    from gol_distributed_final_tpu_torch.ops.bitpack import alive_count_packed
    from gol_distributed_final_tpu_torch.params import Params
    from gol_distributed_final_tpu_torch.parallel import make_bit_plane, make_mesh, multihost
    from gol_distributed_final_tpu_torch.parallel.bit_halo import packed_sharding
    from gol_distributed_final_tpu_torch.parallel.halo import sharded_step_n_fn
    from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard
    from gol_distributed_final_tpu_torch.pod import (
        decode_window_sharded, load_packed_from_pgm_sharded,
    )

    assert multihost.initialize(coordinator, num_procs, rank, device="cpu")
    assert multihost.process_count() == num_procs and multihost.process_index() == rank
    mesh = make_mesh((num_procs, 4), device="cpu")
    assert not mesh.is_fully_local and len(mesh.local_slots()) == 4

    # 1. the byte plane across the ranks, each writing its own rows
    board = read_pgm(repo / "images" / "64x64.pgm")
    lo, hi = multihost.host_row_range(mesh, 64)
    state = ShardedBoard.from_process_local(mesh, board[lo:hi], board.shape)
    assert not state.is_fully_addressable
    out = sharded_step_n_fn(mesh, halo_depth=2)(state, 100)
    row0, rows = out.local_rows()
    assert row0 == lo
    pgm = tmpdir / "64x64x100.pgm"
    offset = create_pgm(pgm, 64, 64) if rank == 0 else pgm_raster_offset(64, 64)
    multihost.barrier()
    write_rows_at(pgm, offset, 64, row0, rows.numpy())
    multihost.barrier()

    # 2. the packed board from each rank's PGM rows: count and window
    big = read_pgm(repo / "images" / "512x512.pgm")
    packed = load_packed_from_pgm_sharded(repo / "images" / "512x512.pgm", mesh)
    assert alive_count_packed(packed) == int(np.count_nonzero(big))
    window = decode_window_sharded(packed, 240, 100, 40, 300)
    np.testing.assert_array_equal(window, big[240:280, 100:400])

    # 3. a corrupt shard fails the load on every rank
    ck = tmpdir / "ck.npz"
    save_packed_checkpoint_sharded(ck, packed, 7)
    multihost.barrier()
    loaded, turn, _, _ = load_packed_checkpoint_sharded(ck, packed_sharding(mesh))
    assert turn == 7 and alive_count_packed(loaded) == int(np.count_nonzero(big))
    shard = checkpoint_shard_path(ck, rank, num_procs)
    if rank == 1:
        with np.load(shard, allow_pickle=False) as data:
            fields = {k: data[k] for k in data.files}
        fields["num_processes"] = np.int64(3)
        np.savez(shard, **fields)
    multihost.barrier()
    try:
        load_packed_checkpoint_sharded(ck, packed_sharding(mesh))
        raise AssertionError("the load of a corrupt shard set must fail")
    except ValueError as exc:
        want = "was written by 3" if rank == 1 else "failed on 1 other rank"
        assert want in str(exc), str(exc)

    # 4. agreed chunk growth: one-turn chunks on every rank
    gates = []
    engine = Engine(EngineConfig(final_world=False, target_dispatch_seconds=1e-9,
                                 chunk_hook=lambda e, s, t: gates.append(t), device="cpu"))
    res = engine.run(Params(turns=6, image_width=512, image_height=512), None,
                     plane=make_bit_plane(mesh, (512, 512)), initial_state=packed)
    assert res.turns_completed == 6 and gates == [1, 2, 3, 4, 5, 6], gates

    # 5. no multi-process checkpoint format without a packed plane
    class BytesOnly:
        def step_n(self, state, n):
            return state

    try:
        Engine(EngineConfig(final_world=False, checkpoint_every=2, device="cpu")).run(
            Params(turns=4, image_width=512, image_height=512), None,
            plane=BytesOnly(), initial_state=packed)
        raise AssertionError("checkpoint_every without a packed plane must be refused")
    except ValueError as exc:
        assert "needs a packed" in str(exc), str(exc)

    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
