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
from gol_distributed_final_tpu_torch.ops import (
    batch_board, bitpack, byte_board, byte_tiled, fused, pallas_stencil, tiled, whole_board,
)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
RULES = (life.CONWAY, life.HIGHLIFE, life.SEEDS, life.DAY_AND_NIGHT)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def _traced_kernels(fn, needles):
    """The names of the kernels ``fn()`` launched that hold one of
    ``needles``, from the profiler's trace. A trace sometimes comes back
    without some of a window's kernels, its first launch above all, and
    such records can turn up in a later window. So ``fn`` runs twice in a
    window, a kernel that started before its window's first launch call is
    left out, and windows are taken, up to eight, until every needle has a
    kernel among the names seen so far."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = set()
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        calls = [ev.time_range.start for ev in events
                 if ev.device_type == DeviceType.CPU and ev.name.startswith("cudaLaunchKernel")]
        names |= {ev.name for ev in events
                  if ev.device_type == DeviceType.CUDA and calls
                  and ev.time_range.start >= min(calls)
                  and any(needle in ev.name for needle in needles)}
        if all(any(needle in name for name in names) for needle in needles):
            break
    return sorted(names)


def _words(shape, seed, device):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(
        gen.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,word_axis", [
    ((16, 512), 0), ((512, 16), 1), ((1500, 4), 0), ((4, 1500), 1), ((1, 1), 0),
])
def test_whole_board_kernel_matches_plain(cuda_device, shape, word_axis):
    """512^2 in both packings, a packed axis of more words than the largest
    block has threads (1500: some threads walk two runs), and one word."""
    packed = _words(shape, word_axis, cuda_device)
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
@pytest.mark.parametrize("shape,word_axis", [
    ((128, 4096), 0), ((4096, 128), 1), ((5, 77), 0), ((77, 5), 1), ((45, 300), 0),
    ((300, 45), 1), ((33, 129), 0), ((33, 129), 1), ((1, 1), 0), ((1, 1), 1),
])
def test_tiled_kernel_matches_plain(cuda_device, shape, word_axis):
    """Ragged tiles, boards smaller than a window, both packings: one
    launch per k turns, equal to the plain version and the whole torus."""
    packed = _words(shape, shape[0], cuda_device)
    for k in (1, 3, 8):
        before = _launches()
        got = tiled.step_n(packed, 13, word_axis, turns_per_launch=k)
        torch.cuda.synchronize()
        assert _delta(before) == {"tiled": -(-13 // k)}
        want = tiled.step_n_plain(packed, 13, word_axis, turns_per_launch=k)
        assert torch.equal(got, want)
        assert torch.equal(got, bitpack.bit_step_n(packed, 13, word_axis))


def _other_rules():
    """Rules outside the compiled four: B36/S125 and a random B/S pair."""
    gen = np.random.default_rng(2026)
    rand = life.LifeRule("random", int(gen.integers(1, 512)), int(gen.integers(1, 512)))
    rules = (life.LifeRule.from_rulestring("B36/S125"), rand)
    assert not any(bitpack.is_compiled_rule(r.birth_mask, r.survive_mask) for r in rules)
    return rules


ALL_RULES = RULES + _other_rules()


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ALL_RULES, ids=lambda r: r.name)
@pytest.mark.parametrize("word_axis", [0, 1])
def test_bitboard_kernels_per_rule(cuda_device, rule, word_axis):
    """K1, K2 and the tiled kernel under each compiled rule and two rules
    that run the run-time-rule instantiation: equal to the plain versions,
    one launch per call (per k turns for the tiles), no plain call."""
    masks = (rule.birth_mask, rule.survive_mask)
    one = _words(bitpack.packed_shape(512, 512, word_axis), 11, cuda_device)
    batch = _words((7,) + bitpack.packed_shape(128, 128, word_axis), 12, cuda_device)
    ragged = _words((45, 300) if word_axis == 0 else (300, 45), 13, cuda_device)
    for n in (1, 37):
        before = _launches()
        got1 = whole_board.step_n(one, n, word_axis, *masks, counted=True)
        got2 = batch_board.step_n(batch, n, word_axis, *masks)
        got3 = tiled.step_n(ragged, n, word_axis, *masks)
        torch.cuda.synchronize()
        assert _delta(before) == {"whole_board": 1, "batch_board": 1,
                                  "tiled": -(-n // tiled.MAX_TURNS)}
        for got, want in ((got1, whole_board.step_n_plain(one, n, word_axis, *masks)),
                          (got2, batch_board.step_n_plain(batch, n, word_axis, *masks))):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got3, tiled.step_n_plain(ragged, n, word_axis, *masks))
        assert torch.equal(got3, bitpack.bit_step_n(ragged, n, word_axis, *masks))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 128, 512])
@pytest.mark.parametrize("batch", [1, 7, 256, 1000])
def test_batched_kernel_batch_sizes(cuda_device, size, batch):
    """K2 at the batch sizes that change its block (runs of 1 word a thread
    under a wave, longer odd runs that need not divide a board's lines past
    it), both packings, a compiled and a run-time rule."""
    for word_axis in (0, 1):
        packed = _words((batch,) + bitpack.packed_shape(size, size, word_axis),
                        size + batch + word_axis, cuda_device)
        for rule in (life.CONWAY, ALL_RULES[-2]):
            masks = (rule.birth_mask, rule.survive_mask)
            for n in (1, 37):
                before = _launches()
                got = batch_board.step_n(packed, n, word_axis, *masks)
                torch.cuda.synchronize()
                assert _delta(before) == {"batch_board": 1}
                want = batch_board.step_n_plain(packed, n, word_axis, *masks)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_rule_picks_its_instantiation(cuda_device):
    """A compiled rule launches a StaticRule instantiation, any other rule
    the DynamicRule one (the kernels' names in the profiler's trace)."""
    packed = _words((3,) + bitpack.packed_shape(64, 64, 0), 4, cuda_device)
    other = ALL_RULES[-2]
    for rule, kind in ((life.HIGHLIFE, "StaticRule"), (other, "DynamicRule")):
        masks = (rule.birth_mask, rule.survive_mask)
        names = _traced_kernels(lambda: (batch_board.step_n(packed, 3, 0, *masks),
                                         tiled.step_n(packed[0], 3, 0, *masks)),
                                ("whole_board_kernel", "tiled_kernel"))
        assert len(names) == 2 and all(kind in name for name in names), names


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


def _bytes(shape, seed, device):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(
        np.where(gen.random(shape) < 0.35, 255, 0).astype(np.uint8)
    ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16), (24, 33), (256, 256), (340, 340)])
def test_byte_board_kernel_matches_plain(cuda_device, shape):
    """K5: one launch a call, for 4 rules, in the form the shape picks
    (forced, so a board past the size limit runs too), up to the largest
    byte square a block holds; any nonzero byte is alive."""
    board = _bytes(shape, shape[1], cuda_device)
    board[board == 255] = 7 + shape[0] % 200
    before = byte_board.launches
    for rule in RULES:
        for n in (1, 7, 100):
            got = byte_board.step_n(board, n, rule.birth_mask, rule.survive_mask,
                                    form=byte_board.form(shape))
            want = byte_board.step_n_plain(board, n, rule.birth_mask, rule.survive_mask)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    assert byte_board.launches == before + len(RULES) * 3


def _past_the_gate():
    """The smallest 32-aligned square past the whole-board byte kernel's
    size limit."""
    side = int(byte_board.MAX_CELLS ** 0.5) // 32 * 32 + 32
    assert side * side > byte_board.MAX_CELLS
    return side, side


@pytest.mark.cuda
def test_byte_board_refuses_a_board_past_its_gate(cuda_device):
    limit = whole_board.smem_limit(cuda_device)  # bytes: two copies in a block
    assert byte_board.smem_bytes((340, 340)) <= limit < byte_board.smem_bytes((341, 341))
    assert byte_board.fits((16, 16), cuda_device) and byte_board.fits((64, 64), cuda_device)
    assert not byte_board.fits(_past_the_gate(), cuda_device)
    big = torch.zeros(_past_the_gate(), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="byte tiles"):
        byte_board.step_n(big, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,forms", [
    ((64, 64), ("bits-cols", "bits-rows", "bytes")), ((256, 256), ("bits-cols", "bits-rows")),
    ((512, 512), ("bits-cols", "bits-rows")), ((96, 160), ("bits-cols", "bits-rows")),
    ((64, 48), ("bits-rows", "bytes")), ((40, 64), ("bits-cols", "bytes")),
    ((512, 500), ("bits-rows",)), ((32, 32), ("bits-cols", "bits-rows")),
])
def test_byte_board_forms_and_clusters_match_plain(cuda_device, shape, forms):
    """K5 in each form the shape allows, on the cluster the launcher picks
    and on every cluster of 1, 2, 4, 8 blocks that divides the lines, under
    a compiled rule and a run-time one; cells alive as any byte."""
    assert byte_board.form(shape) == forms[0]
    board = _bytes(shape, shape[0] + shape[1], cuda_device)
    board[board == 255] = 1 + sum(shape) % 250
    limit = whole_board.smem_limit(cuda_device)
    for rule in (life.CONWAY, ALL_RULES[-2]):
        masks = (rule.birth_mask, rule.survive_mask)
        for n in (1, 16, 17, 50):  # one phase of the halo's depth, one turn more, several
            want = byte_board.step_n_plain(board, n, *masks)
            for form in forms:
                clusters = [None]
                if form != "bytes":
                    lines = byte_board._lines(shape, form)[1]
                    clusters += [c for c in (1, 2, 4, 8) if lines % c == 0
                                 and byte_board.smem_bytes(shape, form, c) <= limit]
                for cluster in clusters:
                    before = _launches()
                    got = byte_board.step_n(board, n, *masks, form=form, cluster=cluster)
                    torch.cuda.synchronize()
                    assert _delta(before) == {"byte_board": 1}
                    assert torch.equal(got, want), (rule.name, n, form, cluster)


@pytest.mark.cuda
def test_byte_board_cluster_shows_in_the_kernels_name(cuda_device):
    """512^2 runs the bit form on a cluster of 8 blocks, 24x33 the byte
    form (the kernels' names in the profiler's trace)."""
    assert byte_board.cluster_size((512, 512)) == 8
    big, small = _bytes((512, 512), 1, cuda_device), _bytes((24, 33), 1, cuda_device)
    names = _traced_kernels(lambda: (byte_board.step_n(big, 3, form="bits-cols"),
                                     byte_board.step_n(small, 3)),
                            ("byte_board_bits_kernel", "byte_board_bytes_kernel"))
    assert any("byte_board_bits_kernel<8, StaticRule" in name for name in names), names
    assert any("byte_board_bytes_kernel" in name for name in names), names


@pytest.mark.cuda
def test_a_refused_cluster_launch_raises(cuda_device):
    """A cluster of 16 blocks is past the portable limit: the card refuses
    the launch, the wrapper raises and counts nothing, and the next launch
    runs. A cluster that does not divide the lines, a form the shape
    cannot take and a board too large for a block's shared memory raise
    likewise."""
    board = _bytes((512, 512), 2, cuda_device)
    before = _launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        byte_board.step_n(board, 3, cluster=16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        byte_board.step_n(_bytes((36, 64), 2, cuda_device), 3, cluster=8)  # 36 % 8 != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        byte_board.step_n(_bytes((24, 33), 2, cuda_device), 3, form="bits-cols")
    with pytest.raises(RuntimeError, match="CUDA error"):
        byte_board.step_n(_bytes((1024, 1024), 2, cuda_device), 3, cluster=1)  # 256 KiB
    with pytest.raises(ValueError, match="form must be"):
        byte_board.step_n(board, 3, form="words")
    torch.cuda.synchronize()
    assert _delta(before) == {}
    assert torch.equal(byte_board.step_n(board, 3, form="bits-cols"),
                       byte_board.step_n_plain(board, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (512, 512), (45, 300), (5, 7), (1024, 4096)])
def test_byte_tiled_kernel_matches_plain(cuda_device, shape):
    """K6: launches of 1, 8 and 32 turns, on boards smaller than a window
    and with ragged tiles too, against the plain version and the whole-torus
    stencil."""
    board = _bytes(shape, shape[0], cuda_device)
    for rule in (RULES[0], RULES[3]):
        args = (rule.birth_mask, rule.survive_mask)
        for k in (1, 8, 32):
            before = byte_tiled.launches
            got = byte_tiled.step_n(board, k, *args, turns_per_launch=k)
            want = byte_tiled.step_n_plain(board, k, *args, turns_per_launch=k)
            torch.cuda.synchronize()
            assert byte_tiled.launches == before + 1
            assert torch.equal(got, want)
            assert torch.equal(got, byte_board.step_n_plain(board, k, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ["wide", "small"])
@pytest.mark.parametrize("shape", [(64, 256), (45, 300), (300, 45), (5, 7), (1, 1), (100, 1000)])
def test_byte_tiled_kernel_on_either_tile(cuda_device, shape, tile):
    """K6 with its tile forced, on ragged boards and boards smaller than a
    window, at 1, 8 and 32 turns a launch, under a compiled rule and a
    run-time one; cells alive as any byte; rows that are not 16-byte
    aligned take the narrow loads."""
    tile = byte_tiled.TILE if tile == "wide" else byte_tiled.SMALL_TILE
    board = _bytes(shape, shape[1], cuda_device)
    board[board == 255] = 3 + shape[0] % 250
    for rule in (life.HIGHLIFE, ALL_RULES[-1]):
        args = (rule.birth_mask, rule.survive_mask)
        for k in (1, 8, 32):
            before = _launches()
            got = byte_tiled.step_n(board, k, *args, turns_per_launch=k, tile=tile)
            torch.cuda.synchronize()
            assert _delta(before) == {"byte_tiled": 1}
            assert torch.equal(got, byte_tiled.step_n_plain(board, k, *args,
                                                            turns_per_launch=k, tile=tile))
            assert torch.equal(got, byte_board.step_n_plain(board, k, *args))
            assert set(got.unique().tolist()) <= {0, 255}


@pytest.mark.cuda
def test_byte_tiled_kernel_on_a_misaligned_board(cuda_device):
    """A board that starts off a 16-byte boundary takes the narrow loads and
    stores and stays exact."""
    backing = _bytes((1 + 64 * 128,), 9, cuda_device)
    board = backing[1:].view(64, 128)
    assert board.is_contiguous() and board.data_ptr() % 16 != 0
    for module, args in ((byte_tiled, dict(turns_per_launch=8)), (byte_board, {})):
        got = module.step_n(board, 8, **args)
        torch.cuda.synchronize()
        assert torch.equal(got, byte_board.step_n_plain(board, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("module,shape", [("byte_board", (512, 512)), ("byte_board", (24, 33)),
                                          ("byte_tiled", (512, 512)), ("byte_tiled", (45, 300))])
def test_step_sizes_is_one_launch_a_rung_on_two_scratch_boards(cuda_device, module, shape):
    """A whole ladder in one call: one launch per rung, two scratch boards
    however many the rungs, the input never written. K5's form is forced, so
    the 512^2 board runs on its cluster wherever the gate stands."""
    module = {"byte_board": byte_board, "byte_tiled": byte_tiled}[module]
    forced = {"form": byte_board.form(shape)} if module is byte_board else {}
    board = _bytes(shape, 7, cuda_device)
    kept = board.clone()
    sizes = [8] * 5 + [4, 1]
    module.step_sizes(board, sizes, **forced)  # builds and warms the allocator
    torch.cuda.synchronize()
    before = _launches()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = module.step_sizes(board, sizes, **forced)
    allocations = torch.cuda.memory_stats()["allocation.all.allocated"] - allocated
    torch.cuda.synchronize()
    assert _delta(before) == {module.__name__.rsplit(".", 1)[1]: len(sizes)}
    assert allocations == 2
    assert torch.equal(board, kept)
    assert torch.equal(got, byte_board.step_n_plain(board, sum(sizes)))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [16, 64, 512])
@pytest.mark.parametrize("step", ["fused_step_n", "pallas_step_n_fn"])
def test_golden_session_through_a_step_function_on_the_card(cuda_device, size, step, tmp_path):
    byte_board.reset_counts()
    byte_tiled.reset_counts()
    step_n_fn = fused.fused_step_n if step == "fused_step_n" else \
        pallas_stencil.pallas_step_n_fn(life.CONWAY)
    params = Params(turns=100, image_width=size, image_height=size)
    run(params, images_dir=REPO_ROOT / "images", out_dir=tmp_path, tick_seconds=3600,
        engine_config=EngineConfig(step_n_fn=step_n_fn))
    name = f"{size}x{size}x100.pgm"
    assert (tmp_path / name).read_bytes() == (REPO_ROOT / "check" / "images" / name).read_bytes()
    assert byte_board.plain_calls == byte_tiled.plain_calls == 0
    if byte_board.fits((size, size), cuda_device):
        assert byte_board.launches > 0 and byte_tiled.launches == 0
    else:
        assert byte_board.launches == 0 and byte_tiled.launches > 0


# -- the ladders and step functions on the card: each launch of a rung is
# -- one kernel launch, and no plain version runs


COUNTED = (whole_board, tiled, batch_board, byte_board, byte_tiled)


def _launches():
    return {m.__name__.rsplit(".", 1)[1]: (m.launches, m.plain_calls) for m in COUNTED}


def _delta(before):
    """The kernels launched since ``before``; no plain call may appear."""
    out = {}
    for name, (launched, plain) in _launches().items():
        assert plain == before[name][1], f"{name} ran its plain version on the card"
        if launched != before[name][0]:
            out[name] = launched - before[name][0]
    return out


def _rungs(n, k):
    full, rem_ks = fused._ladder(n, k)
    return full + len(rem_ks)


@pytest.mark.cuda
@pytest.mark.parametrize("size,word_axis,force_tiles", [
    (512, 0, False), (512, 1, False), (512, 0, True), (1024, 0, False),
])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_fused_bit_step_n_ladder_on_the_card(cuda_device, size, word_axis, force_tiles, k):
    """K1's ladder under its gate, the tiled kernel's past it (1024^2) or
    when forced: one launch per rung, equal to the plain turn."""
    packed = _words(bitpack.packed_shape(size, size, word_axis), size + k, cuda_device)
    rule = life.HIGHLIFE
    before = _launches()
    got = fused.fused_bit_step_n(packed, 13, k=k, word_axis=word_axis, rule=rule,
                                 force_tiles=force_tiles)
    torch.cuda.synchronize()
    kernel = "tiled" if force_tiles or size == 1024 else "whole_board"
    assert _delta(before) == {kernel: _rungs(13, k)}
    assert torch.equal(got, bitpack.bit_step_n(packed, 13, word_axis,
                                               rule.birth_mask, rule.survive_mask))


@pytest.mark.cuda
@pytest.mark.parametrize("size,k", [(128, 8), (128, 2), (1024, 4)])
def test_fused_bit_step_n_batch_ladder_on_the_card(cuda_device, size, k):
    """K2's ladder for the whole batch under its gate (one launch per
    rung), the tiled kernel's universe by universe past it."""
    batch = 3
    packed = _words((batch,) + bitpack.packed_shape(size, size, 0), size + k, cuda_device)
    before = _launches()
    got = fused.fused_bit_step_n_batch(packed, 13, k=k)
    torch.cuda.synchronize()
    want = {"batch_board": _rungs(13, k)} if size == 128 else {"tiled": batch * _rungs(13, k)}
    assert _delta(before) == want
    assert torch.equal(got, bitpack.bit_step_n_batch(packed, 13))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((64, 64), 8), ((24, 33), 2), ((192, 192), 8),
                                     ((512, 512), 8), ((512, 512), 4), ((2048, 2048), 8),
                                     ((1056, 1000), 2)])
def test_fused_step_n_ladder_on_the_card(cuda_device, shape, k):
    """K5's ladder under its gate (``byte_board.fits``), K6's past it (2048^2
    and 1056 x 1000 under any gate): one launch per rung."""
    board = _bytes(shape, shape[0] + k, cuda_device)
    rule = life.DAY_AND_NIGHT
    before = _launches()
    got = fused.fused_step_n(board, 13, k=k, rule=rule)
    torch.cuda.synchronize()
    kernel = "byte_board" if byte_board.fits(shape, cuda_device) else "byte_tiled"
    assert kernel == "byte_tiled" or shape[0] <= 512
    assert _delta(before) == {kernel: _rungs(13, k)}
    assert torch.equal(got, byte_board.step_n_plain(board, 13, rule.birth_mask,
                                                    rule.survive_mask))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (192, 192), (512, 512), (2048, 2048)])
def test_pallas_step_n_fn_on_the_card(cuda_device, shape):
    """One K5 launch under its gate; past it the byte tiles, 32 turns a
    launch, never the roll stencil."""
    board = _bytes(shape, 5, cuda_device)
    before = _launches()
    got = pallas_stencil.pallas_step_n_fn(life.SEEDS)(board, 40)
    torch.cuda.synchronize()
    on_k5 = byte_board.fits(shape, cuda_device)
    assert on_k5 == (shape[0] * shape[1] <= byte_board.MAX_CELLS)
    assert _delta(before) == ({"byte_board": 1} if on_k5 else {"byte_tiled": 2})
    seeds = (life.SEEDS.birth_mask, life.SEEDS.survive_mask)
    assert torch.equal(got, byte_board.step_n_plain(board, 40, *seeds))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(64, 64), (40, 64), (1024, 1024)])
def test_bit_step_functions_on_the_card(cuda_device, h, w):
    """pallas_bit_step_n_fn and auto_step_n_fn pack, launch (K1 once, or
    the tiled kernel past its gate, 8 turns a launch) and unpack;
    tiled_bit_step_n_fn launches the tiled kernel once per turn."""
    from gol_distributed_final_tpu_torch.ops import auto

    board = _bytes((h, w), h, cuda_device)
    rule = life.HIGHLIFE
    want = byte_board.step_n_plain(board, 9, rule.birth_mask, rule.survive_mask)
    word_axis = 0 if h % 32 == 0 else 1
    launched = {"tiled": 2} if h == 1024 else {"whole_board": 1}
    for fn in (pallas_stencil.pallas_bit_step_n_fn(word_axis=word_axis, rule=rule),
               auto.auto_step_n_fn(rule, (h, w))):
        before = _launches()
        got = fn(board, 9)
        torch.cuda.synchronize()
        assert _delta(before) == launched
        assert torch.equal(got, want)
    packed = bitpack.pack(board, word_axis)
    before = _launches()
    got = tiled.tiled_bit_step_n_fn(rule=rule, word_axis=word_axis)(packed, 9)
    torch.cuda.synchronize()
    assert _delta(before) == {"tiled": 9}
    assert torch.equal(bitpack.unpack(got, word_axis), want)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [None, "fused_step_n"])
def test_periodic_checkpoints_hold_their_turn_on_the_card(cuda_device, step, tmp_path):
    """Chunks of 64 turns pipelined on CUDA events, a checkpoint every 100
    turns: each file holds the committed board of its turn (packed on the
    auto plane, bytes through the step function), equal to the plain
    torch turn walked on the CPU."""
    from gol_distributed_final_tpu_torch.engine.checkpoint import (
        load_packed_checkpoint, load_verified_checkpoint,
    )

    path = tmp_path / "ck.npz"
    board = read_pgm(REPO_ROOT / "images" / "512x512.pgm")
    read = {}

    def read_back(engine, state, turn):
        if path.exists():
            with np.load(path) as data:
                packed = "packed" in data
            if packed:
                words, turn_ck, _, axis = load_packed_checkpoint(path)
                read[turn_ck] = bitpack.unpack(torch.from_numpy(words), axis).numpy()
            else:
                world, turn_ck, _ = load_verified_checkpoint(path)
                read[turn_ck] = world

    config = EngineConfig(checkpoint_every=100, min_chunk=64, max_chunk=64,
                          checkpoint_path=str(path), chunk_hook=read_back,
                          step_n_fn=fused.fused_step_n if step else None)
    result = Engine(config).run(Params(turns=500, image_width=512, image_height=512), board)
    read_back(None, None, 500)
    assert result.checkpoint_error is None and sorted(read) == [128, 256, 320, 448, 500]
    walk = bitpack.pack(board, 0, "cpu")
    for turn in range(1, 501):
        walk = bitpack.bit_step(walk)
        if turn in read:
            np.testing.assert_array_equal(read[turn], bitpack.unpack(walk, 0).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2048, 4096])
def test_big_board_on_the_card_equals_the_plain_version(cuda_device, size, tmp_path):
    from gol_distributed_final_tpu_torch import bigboard

    cells = bigboard.r_pentomino(size)
    before = tiled.launches
    out = tmp_path / "card.pgm"
    alive = bigboard.run_big_board(size, 64, out, cells=cells, row_block=512)
    assert tiled.launches - before == 8
    plain = tmp_path / "cpu.pgm"
    assert bigboard.run_big_board(size, 64, plain, cells=cells, row_block=512,
                                  device="cpu") == alive
    assert out.read_bytes() == plain.read_bytes()
    state = bigboard.load_packed_from_pgm(out, row_block=512)
    assert state.is_cuda and bitpack.alive_count_packed(state) == alive


# -- the activity-sparse kernel (csrc/sparse_tiles.cu) -------------------------


def _sparse_soup(h, w, p, seed, window):
    rng = np.random.default_rng(seed)
    board = np.zeros((h, w), np.uint8)
    y0, y1, x0, x1 = window
    board[y0:y1, x0:x1] = np.where(rng.random((y1 - y0, x1 - x0)) < p, 255, 0)
    return board


@pytest.mark.cuda
@pytest.mark.parametrize("tile,shape", [((1, 2), (64, 64)), ((1, 8), (64, 128)),
                                        ((1, 16), (256, 256)), ((3, 12), (96, 96)),
                                        ((8, 128), (1024, 2048)), ((2, 16), (128, 128))])
@pytest.mark.parametrize("rule", RULES + (life.LifeRule.from_rulestring("B36/S125"),),
                         ids=lambda r: r.name)
def test_sparse_kernel_matches_plain(cuda_device, tile, shape, rule):
    """Every block depth the tile allows, a capacity that holds the frontier
    and one that overflows: the same board, grid, blocks, overflow, sum
    and count as the plain program."""
    from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

    h, w = shape
    board = _sparse_soup(h, w, 0.35, 3, (h // 3, 2 * h // 3, w // 4, w // 2))
    plane = sparse.SparseBitPlane(rule, tile=tile, device=cuda_device)
    st = plane.encode(board)
    masks = (rule.birth_mask, rule.survive_mask)
    for h_turns in range(1, sparse.sparse_block_turns(*tile) + 1):
        for capacity in (sparse._pow2_ceil(max(st.count, 8) * 2), max(1, st.count // 2)):
            got = sparse_tiles.dispatch(st.packed, st.grid, 6, tile, h_turns, capacity, *masks)
            want = sparse_tiles.dispatch_plain(st.packed.cpu(), st.grid.cpu(), 6, tile,
                                               h_turns, capacity, *masks)
            torch.cuda.synchronize()
            assert (got.blocks_done, got.overflow, got.active_sum, got.count) == (
                want.blocks_done, want.overflow, want.active_sum, want.count)
            assert torch.equal(got.packed.cpu(), want.packed)
            assert torch.equal(got.grid.cpu(), want.grid)


@pytest.mark.cuda
def test_sparse_plane_on_the_card_equals_the_cpu(cuda_device):
    """A 512^2 R-pentomino across tile edges, in calls that overflow, drain
    and take the h = 1 tail: board, count and steady after each call."""
    from gol_distributed_final_tpu_torch.models import CONWAY
    from gol_distributed_final_tpu_torch.ops import sparse

    board = np.zeros((512, 512), np.uint8)
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        board[256 + dy, 256 + dx] = 255
    card = sparse.SparseBitPlane(CONWAY, device=cuda_device)
    cpu = sparse.SparseBitPlane(CONWAY, device="cpu")
    a, b = card.encode(board), cpu.encode(board)
    for n in (1, 300, 7, 700, 5):
        a, b = card.step_n(a, n), cpu.step_n(b, n)
        assert np.array_equal(card.decode(a), cpu.decode(b)), n
        assert (a.count, a.steady) == (b.count, b.steady), n


# -- the resident worker's strip kernel (W) ----------------------------------


def _strip_block(h, w, k, seed, p=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h + 2 * k, w)) < p, 255, 0).astype(np.uint8)


def _assert_batch_equal(got, want, attest):
    """A StripBatch of the kernel against the plain version's: strip,
    edges, per-turn counts, every band byte, the dirty grid and, with
    attest, the four adler32 sums modulo 65521."""
    from gol_distributed_final_tpu_torch.ops import strip_steps

    assert torch.equal(got.strip, want.strip)
    assert (got.edges is None and want.edges is None) or torch.equal(got.edges, want.edges)
    assert got.counts.cpu().tolist() == want.counts.cpu().tolist()
    assert torch.equal(got.dirty.cpu(), want.dirty.cpu())
    if attest:
        assert torch.equal(got.bands, want.bands)
        assert (got.sums % strip_steps.MOD).cpu().tolist() == want.sums.cpu().tolist()
    else:
        assert got.bands is None and got.sums is None


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("h,w", [(1, 100), (16, 512), (7, 33), (1024, 4096)])
@pytest.mark.parametrize("attest", [False, True])
def test_strip_kernel_matches_plain(cuda_device, k, h, w, attest):
    """W against its plain version on the card: strip, per-turn counts,
    every band byte, the dirty grid and the digest sums, over one launch
    (k <= 32) and chained launches."""
    from gol_distributed_final_tpu_torch.ops import strip_steps

    block = torch.from_numpy(_strip_block(h, w, k, seed=k * 1000 + h + w)).to(cuda_device)
    before = strip_steps.launches
    got = strip_steps.strip_steps(block, k, h, attest=attest)
    assert strip_steps.launches - before == -(-k // strip_steps.MAX_TURNS)
    _assert_batch_equal(got, strip_steps.strip_steps_plain(block, k, h, attest), attest)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ["wide", "small"])
def test_strip_kernel_on_both_tiles(cuda_device, tile):
    from gol_distributed_final_tpu_torch.ops import strip_steps

    block = torch.from_numpy(_strip_block(130, 300, 8, seed=5)).to(cuda_device)
    forced = strip_steps.TILE if tile == "wide" else strip_steps.SMALL_TILE
    got = strip_steps.strip_steps(block, 8, 130, attest=True, tile=forced)
    _assert_batch_equal(got, strip_steps.strip_steps_plain(block, 8, 130, attest=True), True)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("ctas", [1, 3, 7, None])
@pytest.mark.parametrize("h,w", [(200, 1024), (64, 256), (130, 300)])
def test_strip_batch_on_three_parts_into_a_second_buffer(cuda_device, k, ctas, h, w):
    """The resident form: halos and strip in separate allocations, the new
    strip written into a given buffer, on a persistent grid capped at a
    few CTAs (each walks several tiles, their count no multiple of the
    CTAs') and uncapped."""
    from gol_distributed_final_tpu_torch.ops import strip_steps

    block = _strip_block(h, w, k, seed=h + w + k)
    top, strip, bottom = (torch.from_numpy(part.copy()).to(cuda_device)
                          for part in (block[:k], block[k:k + h], block[k + h:]))
    into = strip_steps.batch_outputs(h, w, k, True, cuda_device)
    assert strip_steps.strip_batch(top, strip, bottom, k, True, into=into, ctas=ctas) is into
    want = strip_steps.strip_steps_plain(torch.from_numpy(block).to(cuda_device), k, h, True)
    _assert_batch_equal(into, want, True)
    with pytest.raises(ValueError):
        strip_steps.strip_batch(top, strip, bottom, k, True, into=into._replace(strip=strip))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [256, 300])
def test_strip_kernel_dirty_grid_and_sums_read_every_byte(cuda_device, w):
    """A strip of arbitrary bytes (alive is nonzero): the grid marks a
    tile whose bytes change even where its cells stay alive, and the sums
    are those of the bytes; an all-dead strip stays clean."""
    from gol_distributed_final_tpu_torch.ops import strip_steps

    rng = np.random.default_rng(w)
    block = torch.from_numpy(rng.integers(0, 256, (140, w), dtype=np.uint8)).to(cuda_device)
    dead = torch.zeros_like(block)
    for k, data in ((4, block), (40, block), (4, dead), (40, dead)):
        h = data.shape[0] - 2 * k
        got = strip_steps.strip_steps(data, k, h, attest=True)
        _assert_batch_equal(got, strip_steps.strip_steps_plain(data, k, h, attest=True), True)
        assert bool(got.dirty.any()) == (data is block)


@pytest.mark.cuda
@pytest.mark.parametrize("integrity", [True, False])
def test_device_session_replies_equal_a_numpy_session(cuda_device, monkeypatch, integrity):
    """A worker whose strip is resident on the card (GOL_WORKER_FUSED=auto,
    a strip past the gate) against one that keeps a numpy strip
    (GOL_WORKER_FUSED=off): every StripStep reply field, the full and
    delta fetches, with integrity on and off."""
    from gol_distributed_final_tpu_torch.rpc import integrity as port_integrity
    from gol_distributed_final_tpu_torch.rpc import worker as port_worker
    from gol_distributed_final_tpu_torch.rpc.protocol import Request

    class _NoServer:
        def stop(self):
            pass

    rng = np.random.default_rng(11)
    board = np.where(rng.random((512, 1000)) < 0.35, 255, 0).astype(np.uint8)
    s, e = 128, 384
    services = []
    for mode in ("auto", "off"):
        monkeypatch.setenv("GOL_WORKER_FUSED", mode)
        svc = port_worker.WorkerService(_NoServer(), cuda_device)
        svc.strip_start(Request(world=board[s:e], worker=2, initial_turn=16))
        services.append(svc)
    card, host = services
    assert isinstance(card._strip, torch.Tensor) and card._strip.is_cuda
    assert isinstance(host._strip, np.ndarray)
    monkeypatch.setattr(port_integrity, "_enabled", integrity)
    turn = 16
    for k in (8, 1, 8, 40):
        halos = np.concatenate([board[s - k:s], board[e:e + k]])
        replies = [svc.strip_step(Request(world=halos, worker=2, turns=k, initial_turn=turn))
                   for svc in services]
        a, b = replies
        assert a.turns_completed == b.turns_completed == turn + k
        assert np.array_equal(a.edges, b.edges) and a.counts == b.counts
        assert np.array_equal(a.dirty, b.dirty) and a.digests == b.digests
        if turn == 16:
            delta = [svc.strip_fetch(Request(worker=2, delta_base_turn=16)) for svc in services]
            assert np.array_equal(delta[0].dirty, delta[1].dirty)
            assert np.array_equal(delta[0].work_slice, delta[1].work_slice)
        turn += k
    full = [svc.strip_fetch(Request(worker=2)) for svc in services]
    assert np.array_equal(full[0].work_slice, full[1].work_slice)
    assert card._strip.is_cuda
