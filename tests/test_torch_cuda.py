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
    from torch.profiler import ProfilerActivity, profile

    packed = _words((3,) + bitpack.packed_shape(64, 64, 0), 4, cuda_device)
    other = ALL_RULES[-2]
    for rule, kind in ((life.HIGHLIFE, "StaticRule"), (other, "DynamicRule")):
        masks = (rule.birth_mask, rule.survive_mask)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            batch_board.step_n(packed, 3, 0, *masks)
            tiled.step_n(packed[0], 3, 0, *masks)
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 if "whole_board_kernel" in ev.key or "tiled_kernel" in ev.key]
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
    """K5: one launch a call, for 4 rules, up to the largest square under
    its gate; any nonzero byte is alive."""
    board = _bytes(shape, shape[1], cuda_device)
    board[board == 255] = 7 + shape[0] % 200
    before = byte_board.launches
    for rule in RULES:
        for n in (1, 7, 100):
            got = byte_board.step_n(board, n, rule.birth_mask, rule.survive_mask)
            want = byte_board.step_n_plain(board, n, rule.birth_mask, rule.survive_mask)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    assert byte_board.launches == before + len(RULES) * 3


@pytest.mark.cuda
def test_byte_board_refuses_a_board_past_its_gate(cuda_device):
    assert byte_board.fits((340, 340), cuda_device)
    big = torch.zeros((512, 512), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="byte tiles"):
        byte_board.step_n(big, 1)


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
    if size < 512:
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
@pytest.mark.parametrize("shape,k", [((64, 64), 8), ((24, 33), 2), ((512, 512), 8),
                                     ((512, 512), 4)])
def test_fused_step_n_ladder_on_the_card(cuda_device, shape, k):
    """K5's ladder under its gate, K6's past it: one launch per rung."""
    board = _bytes(shape, shape[0] + k, cuda_device)
    rule = life.DAY_AND_NIGHT
    before = _launches()
    got = fused.fused_step_n(board, 13, k=k, rule=rule)
    torch.cuda.synchronize()
    kernel = "byte_tiled" if shape == (512, 512) else "byte_board"
    assert _delta(before) == {kernel: _rungs(13, k)}
    assert torch.equal(got, byte_board.step_n_plain(board, 13, rule.birth_mask,
                                                    rule.survive_mask))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (512, 512)])
def test_pallas_step_n_fn_on_the_card(cuda_device, shape):
    """One K5 launch under its gate; past it the byte tiles, 32 turns a
    launch, never the roll stencil."""
    board = _bytes(shape, 5, cuda_device)
    before = _launches()
    got = pallas_stencil.pallas_step_n_fn(life.SEEDS)(board, 40)
    torch.cuda.synchronize()
    assert _delta(before) == ({"byte_board": 1} if shape == (64, 64) else {"byte_tiled": 2})
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
