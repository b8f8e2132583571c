"""The PyTorch port's CUDA kernels on the card: each kernel against its plain
torch version, and the session on the card against the golden fixtures,
in process and over loopback RPC (sessions and SessionRun).

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a host that has no
jax, without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Game of Life is integer-exact: equality, tolerance none.
"""

import csv
import pathlib

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.models import life
from gol_distributed_final_tpu_torch.ops import batch_board, bitpack, tiled, whole_board

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
RULES = (life.CONWAY, life.HIGHLIFE, life.SEEDS, life.DAY_AND_NIGHT)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def _words(shape, seed, device):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(
        gen.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("word_axis", [0, 1])
def test_whole_board_kernel_matches_plain(cuda_device, word_axis):
    packed = _words(bitpack.packed_shape(512, 512, word_axis), word_axis, cuda_device)
    before = whole_board.launches
    for rule in RULES:
        for n in (0, 1, 7, 100):
            got = whole_board.step_n(
                packed, n, word_axis, rule.birth_mask, rule.survive_mask, counted=True
            )
            want = whole_board.step_n_plain(
                packed, n, word_axis, rule.birth_mask, rule.survive_mask
            )
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert whole_board.launches == before + len(RULES) * 4


@pytest.mark.cuda
def test_whole_board_refuses_a_board_past_its_gate(cuda_device):
    assert whole_board.smem_limit(cuda_device) >= whole_board.smem_bytes((16, 512))
    big = torch.zeros((32, 1024), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="tiled kernel"):
        whole_board.step_n(big, 1)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,word_axis", [((128, 4096), 0), ((4096, 128), 1), ((5, 77), 0)]
)
def test_tiled_kernel_matches_plain(cuda_device, shape, word_axis):
    packed = _words(shape, shape[0], cuda_device)
    for k in (1, 3, 8):
        got = tiled.step_n(packed, 13, word_axis, turns_per_launch=k)
        want = tiled.step_n_plain(packed, 13, word_axis, turns_per_launch=k)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, bitpack.bit_step_n(packed, 13, word_axis))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [16, 64, 512])
def test_golden_session_on_the_card(cuda_device, size, tmp_path):
    whole_board.reset_counts()
    params = Params(turns=100, image_width=size, image_height=size)
    run(params, images_dir=REPO_ROOT / "images", out_dir=tmp_path, tick_seconds=3600)
    name = f"{size}x{size}x100.pgm"
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()
    assert whole_board.plain_calls == 0
    assert whole_board.launches == (0 if size == 16 else 7)  # chunks 1, 2, .., 32, 37


@pytest.mark.cuda
def test_per_turn_counts_on_the_card(cuda_device):
    with open(REPO_ROOT / "check" / "alive" / "512x512.csv") as f:
        want = {int(r["completed_turns"]): int(r["alive_cells"]) for r in csv.DictReader(f)}
    seen = {}

    def hook(engine, state, turn):
        seen[turn] = engine.retrieve(include_world=False).alive_count

    engine = Engine(EngineConfig(max_chunk=1, chunk_hook=hook))
    board = read_pgm(REPO_ROOT / "images" / "512x512.pgm")
    engine.run(Params(turns=300, image_width=512, image_height=512), board)
    assert [seen[t] for t in range(1, 301)] == [want[t] for t in range(1, 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 128, 512])
def test_batched_kernel_matches_plain(cuda_device, size):
    """K2: every universe of the batch equals the plain batched version,
    counts included, for 4 rules and both packings; one launch a call."""
    for word_axis in (0, 1):
        packed = _words((5,) + bitpack.packed_shape(size, size, word_axis),
                        size + word_axis, cuda_device)
        before = batch_board.launches
        for rule in RULES:
            for n in (0, 1, 7, 100):
                got = batch_board.step_n(
                    packed, n, word_axis, rule.birth_mask, rule.survive_mask
                )
                want = batch_board.step_n_plain(
                    packed, n, word_axis, rule.birth_mask, rule.survive_mask
                )
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert batch_board.launches == before + len(RULES) * 4


@pytest.mark.cuda
def test_batched_kernel_refuses_a_universe_past_its_gate(cuda_device):
    big = torch.zeros((2, 32, 1024), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="tiled kernel"):
        batch_board.step_n(big, 1)


@pytest.mark.cuda
def test_sessions_over_loopback_rpc_on_the_card(cuda_device, tmp_path):
    """A broker on the card: a -server session is golden through K1, and
    concurrent SessionRuns equal their sequential whole-board runs through
    K2, with no plain version run."""
    import queue
    import threading

    from gol_distributed_final_tpu_torch.rpc import broker
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

    server, service = broker.serve(port=0, device="cuda")
    addr = f"127.0.0.1:{server.port}"
    try:
        whole_board.reset_counts()
        batch_board.reset_counts()
        remote = RemoteBroker(addr)
        try:
            run(Params(turns=100, image_width=64, image_height=64), queue.Queue(),
                broker=remote, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
                tick_seconds=3600)
        finally:
            remote.close()
        name = "64x64x100.pgm"
        assert (tmp_path / name).read_bytes() == \
            (REPO_ROOT / "check" / "images" / name).read_bytes()
        rng = np.random.default_rng(3)
        boards = np.where(rng.random((8, 128, 128)) < 0.3, 255, 0).astype(np.uint8)
        budgets = [1, 5, 17, 64, 100, 129, 200, 333]
        results = {}

        def one(i):
            rb = RemoteBroker(addr)
            try:
                results[i] = rb.session_run(
                    Params(turns=budgets[i], image_width=128, image_height=128),
                    boards[i], session_id=i + 1, timeout=120)
            finally:
                rb.close()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert batch_board.launches > 0 and batch_board.plain_calls == 0
        assert whole_board.launches > 0 and whole_board.plain_calls == 0
        for i, budget in enumerate(budgets):
            packed = bitpack.pack(boards[i], 0, cuda_device)
            want = bitpack.unpack(whole_board.step_n(packed, budget), 0).cpu().numpy()
            np.testing.assert_array_equal(results[i].world, want)
    finally:
        service.shutdown()
