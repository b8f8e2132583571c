"""The PyTorch port's CUDA kernels on the card: each kernel against its plain
torch version, and the session on the card against the golden fixtures,
in process and over loopback RPC (sessions and SessionRun).

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a host that has no
jax, without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Game of Life is integer-exact: equality, tolerance none.
"""

import contextlib
import csv
import pathlib
import time

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.models import life
from gol_distributed_final_tpu_torch.ops import (
    _build, batch_board, bitpack, byte_board, byte_tiled, fused, pallas_stencil, tiled,
    whole_board,
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
                 if ev.device_type == DeviceType.CPU
                 and ev.name.startswith(("cudaLaunchKernel", "cudaLaunchCooperativeKernel"))]
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


#: single boards on K1's cluster route: 512^2 in both packings, 256^2,
#: 192^2 and 160^2, and 640 x 384 (under the gate, not square) in both
#: packings, all on the register loop; and 1280 x 640, whose 40-word line
#: is wider than a warp, on the shared-memory loop
CLUSTER_BOARDS = [((16, 512), 0), ((512, 16), 1), ((8, 256), 0), ((6, 192), 0), ((5, 160), 0),
                  ((20, 384), 0), ((640, 12), 1), ((40, 640), 0)]


def _route_turns(depth):
    """Turns across a phase's edges, a short last phase and the engine's
    chunk."""
    return (0, 1, depth - 1, depth, depth + 1, 100, 4096)


def _assert_counted_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _on_one_block(packed, n, word_axis, birth_mask=life.CONWAY.birth_mask,
                  survive_mask=life.CONWAY.survive_mask):
    """K1's counted one-block route, whatever the plan gives."""
    out = torch.empty_like(packed)
    counts = torch.empty(packed.shape[0], dtype=torch.int32, device=packed.device)
    assert whole_board.launch_one(packed, out, counts, n, word_axis, birth_mask, survive_mask,
                                  "pallas.vmem_bit", whole_board.Route(1)).blocks == 1
    return out, counts


@contextlib.contextmanager
def _metrics_on():
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics

    _obs_off()
    obs_metrics.enable()
    try:
        yield
    finally:
        _obs_off()


def _route_counts():
    """K1's single-board launches so far by route, under metrics
    (``gol_whole_board_launches_total{route}``)."""
    from gol_distributed_final_tpu_torch.obs import instruments as ins

    return {route: int(ins.WHOLE_BOARD_LAUNCHES_TOTAL.labels(route).value)
            for route in ("block", "cluster", "cluster_registers")}


def _routes_since(before):
    return {route: count - before[route] for route, count in _route_counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,word_axis", CLUSTER_BOARDS)
def test_whole_board_cluster_route_matches_plain_and_one_block(cuda_device, shape, word_axis):
    """A single board takes the cluster route the plan gives it (the
    register loop wherever a line fits a warp), and equals the plain
    version and the one-block kernel bit for bit, board and row counts,
    counted and not: every compiled rule and two run-time ones, n across a
    phase's edges and the engine's 4096-turn chunk."""
    packed = _words(shape, sum(shape) + word_axis, cuda_device)
    plan = whole_board.cluster_plan(shape, word_axis)
    assert plan.blocks > 1
    assert plan.name == ("cluster" if shape == (40, 640) else "cluster_registers")
    routes = {"block": 1, "cluster": 0, "cluster_registers": 0, plan.name: 2}
    with _metrics_on():
        for rule in ALL_RULES:
            masks = (rule.birth_mask, rule.survive_mask)
            for n in _route_turns(plan.depth):
                before = (whole_board.launches, _route_counts())
                got = whole_board.step_n(packed, n, word_axis, *masks, counted=True)
                uncounted = whole_board.step_n(packed, n, word_axis, *masks)
                block = _on_one_block(packed, n, word_axis, *masks)
                want = whole_board.step_n_plain(packed, n, word_axis, *masks)
                torch.cuda.synchronize()
                assert whole_board.launches == before[0] + 3, (rule.name, n)
                assert _routes_since(before[1]) == routes, (rule.name, n)
                _assert_counted_equal(got, want)
                _assert_counted_equal(block, want)
                assert torch.equal(uncounted, want[0]), (rule.name, n)


@pytest.mark.cuda
@pytest.mark.parametrize("word_axis", [0, 1])
def test_whole_board_cluster_route_on_the_image(cuda_device, word_axis):
    """images/512x512.pgm on the picked route against the plain version,
    the one-block kernel and check/alive's count at each turn."""
    with open(REPO_ROOT / "check" / "alive" / "512x512.csv") as f:
        golden = {int(r["completed_turns"]): int(r["alive_cells"]) for r in csv.DictReader(f)}
    packed = bitpack.pack(read_pgm(REPO_ROOT / "images" / "512x512.pgm"), word_axis,
                          cuda_device)
    plan = whole_board.cluster_plan(tuple(packed.shape), word_axis)
    with _metrics_on():
        for n in _route_turns(plan.depth):
            got = whole_board.step_n(packed, n, word_axis, counted=True)
            block = _on_one_block(packed, n, word_axis)
            want = whole_board.step_n_plain(packed, n, word_axis)
            torch.cuda.synchronize()
            _assert_counted_equal(got, want)
            _assert_counted_equal(block, want)
            if n:
                assert int(got[1].sum()) == golden[n]
        assert _route_counts()[plan.name] == len(_route_turns(plan.depth))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,word_axis", [((16, 512), 0), ((512, 16), 1), ((8, 256), 0)])
@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("depth", [8, 32])
@pytest.mark.parametrize("lines", [0, -1])
def test_whole_board_forced_clusters_match_plain(cuda_device, shape, word_axis, cluster, depth,
                                                 lines):
    """Every cluster size at halo depths the plan does not choose (clamped
    to a band thinner than the depth), on the blocks asked for, in the
    shared-memory loop (lines 0) and in the loop the plan gives the band
    (-1, ``loop_route``: the register loop where a block of 16 warps holds
    it)."""
    packed = _words(shape, cluster + depth, cuda_device)
    if lines:
        route = whole_board.loop_route(shape, word_axis, cluster, depth)
    else:
        route = whole_board.cluster_route(shape, word_axis, cluster, depth)
    out = torch.empty_like(packed)
    counts = torch.empty(shape[0], dtype=torch.int32, device=cuda_device)
    for n in _route_turns(depth):
        ran = whole_board.launch_one(packed, out, counts, n, word_axis,
                                     life.CONWAY.birth_mask, life.CONWAY.survive_mask,
                                     "pallas.vmem_bit", route)
        torch.cuda.synchronize()
        assert ran == route and route.blocks == cluster
        assert route.name == ("cluster_registers" if lines and route.warps else "cluster")
        _assert_counted_equal((out, counts), whole_board.step_n_plain(packed, n, word_axis))


#: the register loop forced off the plan: (blocks, depth, lines a thread)
#: at every compiled lines a thread, the sweep's depths and other clusters;
#: some need more than 16 warps on some boards, and are refused there
FORCED_REGISTER_ROUTES = [(16, 16, 2), (16, 16, 8), (16, 8, 4), (16, 32, 4), (16, 32, 2),
                          (8, 48, 4), (8, 16, 8), (4, 16, 8), (2, 8, 8),
                          (16, 10, 4), (16, 12, 4), (16, 12, 2), (8, 10, 8), (8, 12, 4),
                          (4, 10, 4), (4, 12, 8), (2, 10, 4), (2, 12, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,word_axis", [((16, 512), 0), ((512, 16), 1), ((8, 256), 0),
                                             ((6, 192), 0), ((5, 160), 0)])
@pytest.mark.parametrize("route", FORCED_REGISTER_ROUTES, ids=str)
def test_whole_board_register_loop_forced_routes_match_plain(cuda_device, shape, word_axis,
                                                             route):
    """The register loop at lines a thread, depths and clusters the plan
    does not pick equals the plain version, board and row counts, for n
    across the cluster's phase edges, Conway and a run-time rule; a route
    the board's block cannot hold is refused."""
    blocks, depth, per_thread = route
    lines = shape[1] if word_axis == 0 else shape[0]
    packed = _words(shape, sum(route) + word_axis, cuda_device)
    out = torch.empty_like(packed)
    counts = torch.empty(shape[0], dtype=torch.int32, device=cuda_device)
    forced = whole_board.cluster_route(shape, word_axis, blocks, depth, per_thread)
    depth = forced.depth
    if lines % blocks or not forced.warps:
        with pytest.raises(RuntimeError, match="CUDA error"):
            whole_board.launch_one(packed, out, counts, 5, word_axis, 8, 12, "pallas.vmem_bit",
                                   forced)
        return
    turns = {0, 1, 2, depth - 1, depth, depth + 1, 2 * depth + 3, 100, 4096}
    for rule in (life.CONWAY, ALL_RULES[-1]):
        masks = (rule.birth_mask, rule.survive_mask)
        for n in sorted(turns):
            ran = whole_board.launch_one(packed, out, counts, n, word_axis, *masks,
                                         "pallas.vmem_bit", forced)
            torch.cuda.synchronize()
            assert ran == forced
            _assert_counted_equal((out, counts),
                                  whole_board.step_n_plain(packed, n, word_axis, *masks))


def _plain_chunks(packed, n, word_axis, birth_mask, survive_mask, turns=64):
    """The plain version's boards after each n turns, forever: ``turns``
    of its turns captured once in a CUDA graph and replayed, so a soak of
    hundreds of thousands of turns takes seconds a launch, not minutes."""
    src = packed.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up a capture wants, off the capturing stream
        bitpack.bit_step_n(src, turns, word_axis, birth_mask, survive_mask)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dst = bitpack.bit_step_n(src, turns, word_axis, birth_mask, survive_mask)
    assert n % turns == 0
    while True:
        for _ in range(n // turns):
            graph.replay()
            src.copy_(dst)
        yield src.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,word_axis,rule", [((16, 512), 0, life.CONWAY),
                                                  ((6, 192), 0, life.HIGHLIFE)],
                         ids=["512^2-conway", "192^2-highlife"])
def test_whole_board_register_loop_soak_matches_plain(cuda_device, shape, word_axis, rule):
    """64 chained 4096-turn launches of the plan's register loop on one
    stream, each launch's board and row counts equal to the plain version
    after the same turns: a meeting that read a halo before its push
    landed, or a push that overwrote a halo not yet read, shows over
    hundreds of thousands of turns where one short launch can miss it."""
    masks = (rule.birth_mask, rule.survive_mask)
    packed = _words(shape, 26, cuda_device)
    plan = whole_board.cluster_plan(shape, word_axis)
    assert plan.name == "cluster_registers"
    boards, counts = [], []
    board = packed
    for _ in range(64):
        out = torch.empty_like(board)
        row_counts = torch.empty(shape[0], dtype=torch.int32, device=cuda_device)
        assert whole_board.launch_one(board, out, row_counts, 4096, word_axis, *masks,
                                      "pallas.vmem_bit") == plan
        boards.append(out)
        counts.append(row_counts)
        board = out
    plain = _plain_chunks(packed, 4096, word_axis, *masks)
    for launch, (got, got_counts) in enumerate(zip(boards, counts)):
        want = next(plain)
        assert torch.equal(got, want), f"launch {launch}: board differs"
        assert torch.equal(got_counts, bitpack.row_popcounts(want)), f"launch {launch}: counts"


@pytest.mark.cuda
def test_whole_board_meetings_counted_by_route(cuda_device):
    """With metrics on, each cluster launch of n turns adds its meetings,
    ``len(phases(n, depth)) - 1``, to
    ``gol_whole_board_meetings_total{route}`` under the route that ran;
    a launch on one block adds none."""
    from gol_distributed_final_tpu_torch.obs import instruments as ins

    boards = {(16, 512): _words((16, 512), 12, cuda_device),
              (40, 640): _words((40, 640), 13, cuda_device),
              (4, 128): _words((4, 128), 14, cuda_device)}
    want = {"block": 0, "cluster": 0, "cluster_registers": 0}
    with _metrics_on():
        for shape, packed in boards.items():
            plan = whole_board.cluster_plan(shape)
            for n in (0, 1, plan.depth, plan.depth + 1, 100, 4096):
                whole_board.step_n(packed, n, counted=True)
                want[plan.name] += len(whole_board.phases(n, plan.depth)) - 1 if n else 0
        torch.cuda.synchronize()
        got = {route: int(ins.WHOLE_BOARD_MEETINGS_TOTAL.labels(route).value)
               for route in want}
    assert got == want
    # n = 0, 1 and 16 meet no time, 17 once, 100 six times, 4096 255 times
    assert want["cluster_registers"] == 262
    assert want["cluster"] > 0 and want["block"] == 0


@pytest.mark.cuda
def test_whole_board_register_launches_counted_by_route(cuda_device):
    """With metrics on, every launch of the register loop counts under
    ``gol_whole_board_launches_total{route="cluster_registers"}``, the
    shared-memory loop's under "cluster" and one block's under "block"."""
    from gol_distributed_final_tpu_torch.obs import instruments as ins
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics

    _obs_off()
    obs_metrics.enable()
    try:
        packed = _words((16, 512), 9, cuda_device)
        wide = _words((40, 640), 10, cuda_device)
        small = _words((4, 128), 11, cuda_device)
        for _ in range(3):
            whole_board.step_n(packed, 100, counted=True)
        whole_board.step_n(wide, 10)
        whole_board.step_n(small, 10)
        torch.cuda.synchronize()
        counts = {route: ins.WHOLE_BOARD_LAUNCHES_TOTAL.labels(route).value
                  for route in ("block", "cluster", "cluster_registers")}
        assert counts == {"block": 1.0, "cluster": 1.0, "cluster_registers": 3.0}
    finally:
        _obs_off()


@pytest.mark.cuda
def test_whole_board_refused_cluster_runs_on_one_block(cuda_device):
    """A cluster the card cannot schedule (32 blocks, past the largest any
    card takes) runs on one block instead, right, and counted as one
    block; the next launch takes its cluster again."""
    packed = _words((16, 512), 5, cuda_device)
    out = torch.empty_like(packed)
    counts = torch.empty(16, dtype=torch.int32, device=cuda_device)
    args = (life.CONWAY.birth_mask, life.CONWAY.survive_mask, "pallas.vmem_bit")
    # the register loop and the shared-memory loop
    refused = (whole_board.loop_route((16, 512), 0, 32), whole_board.cluster_route(
        (16, 512), 0, 32, whole_board.HALO_DEPTH))
    assert refused[0].name == "cluster_registers" and refused[1].name == "cluster"
    with _metrics_on():
        for route in refused:
            assert whole_board.launch_one(packed, out, counts, 37, 0, *args, route) == \
                whole_board.Route(1)
            torch.cuda.synchronize()
            _assert_counted_equal((out, counts), whole_board.step_n_plain(packed, 37, 0))
        assert _route_counts() == {"block": 2, "cluster": 0, "cluster_registers": 0}
    assert whole_board.launch_one(packed, out, counts, 37, 0, *args) == \
        whole_board.cluster_plan((16, 512))
    torch.cuda.synchronize()
    _assert_counted_equal((out, counts), whole_board.step_n_plain(packed, 37, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,word_axis", [
    ((16, 512), 0), ((512, 16), 1), ((8, 256), 0), ((4, 128), 0), ((5, 160), 0),
    ((6, 192), 0), ((20, 384), 0), ((640, 12), 1), ((29, 1000), 0), ((1500, 4), 0),
    ((100, 24), 0), ((1, 1), 0), ((30, 960), 0), ((40, 640), 0), ((640, 40), 1),
])
def test_whole_board_kernel_picks_the_plan(cuda_device, shape, word_axis):
    """A launch runs the plan's route and reports it, on the card: blocks,
    depth, loop and warps, whether the plan is left to the launch or handed
    to it, and the board equals the plain version."""
    packed = _words(shape, 3, cuda_device)
    plan = whole_board.cluster_plan(shape, word_axis)
    want = whole_board.step_n_plain(packed, 3, word_axis)[0]
    for route in (None, plan):
        out = torch.empty_like(packed)
        ran = whole_board.launch_one(packed, out, None, 3, word_axis, life.CONWAY.birth_mask,
                                     life.CONWAY.survive_mask, "pallas.vmem_bit", route)
        torch.cuda.synchronize()
        assert ran == plan
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_whole_board_route_shows_in_the_kernels_name(cuda_device):
    """A single 512^2 board runs whole_board_cluster_registers_kernel at
    the plan's lines a thread; a batch of two such boards runs the
    one-block whole_board_kernel, and counts no single-board launch."""
    one = _words((16, 512), 6, cuda_device)
    two = _words((2, 16, 512), 7, cuda_device)
    lines = whole_board.cluster_plan((16, 512)).lines
    names = _traced_kernels(lambda: whole_board.step_n(one, 3, counted=True),
                            ("whole_board_cluster_registers_kernel",))
    assert names and all(f"whole_board_cluster_registers_kernel<0, {lines}, StaticRule" in n
                         for n in names), names
    before = whole_board.launches
    names = _traced_kernels(lambda: batch_board.step_n(two, 3), ("whole_board_kernel",))
    assert names and all("whole_board_kernel<0" in n for n in names), names
    assert whole_board.launches == before


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
    cannot take, a board too large for a block's shared memory and a halo
    depth the kernel cannot run are refused likewise."""
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
    # the library runs the halo depth it is handed and refuses one it
    # cannot: a halo on one block, none on a cluster, one past the band
    entry = _build.load("byte_board", byte_board._SIGNATURES).gol_byte_board_step_as
    out, stream = torch.empty_like(board), torch.cuda.current_stream().cuda_stream
    for cluster, depth in ((1, 16), (8, 0), (8, 65)):
        assert entry(board.data_ptr(), out.data_ptr(), 512, 512, 3, 8, 12, 0, cluster, depth,
                     stream) == 1  # cudaErrorInvalidValue
    assert byte_board.launch_plan((512, 512)) == ("bits-cols", 8, 16)
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


def _settling_soup(seed):
    """A 16 x 16 soup at 40% on a 128^2 torus; seed 53's settles into still
    lifes alone at turn 320 (no oscillator keeps a tile active)."""
    rng = np.random.default_rng(seed)
    board = np.zeros((128, 128), np.uint8)
    board[50:66, 50:66] = np.where(rng.random((16, 16)) < 0.4, 255, 0)
    return board


def _r_pentomino_board(h, w):
    board = np.zeros((h, w), np.uint8)
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        board[h // 2 + dy, w // 2 + dx] = 255
    return board


def _sparse_against_plain(st, n_blocks, tile, h, capacity, rule=life.CONWAY):
    """One dispatch on the card against the plain program on the CPU, every
    field equal; the card's result."""
    from gol_distributed_final_tpu_torch.ops import sparse_tiles

    masks = (rule.birth_mask, rule.survive_mask)
    got = sparse_tiles.dispatch(st.packed, st.grid, n_blocks, tile, h, capacity, *masks)
    want = sparse_tiles.dispatch_plain(st.packed.cpu(), st.grid.cpu(), n_blocks, tile, h,
                                       capacity, *masks)
    torch.cuda.synchronize()
    assert (got.blocks_done, got.overflow, got.active_sum, got.count) == (
        want.blocks_done, want.overflow, want.active_sum, want.count)
    assert torch.equal(got.packed.cpu(), want.packed)
    assert torch.equal(got.grid.cpu(), want.grid)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,h", [(64, 8), (512, 1)])
@pytest.mark.parametrize("kind", ["overflow", "drain"])
def test_sparse_long_dispatch_matches_plain(cuda_device, n_blocks, h, kind):
    """One launch of 64 or 512 blocks that stops midway: the R-pentomino
    outgrowing a capacity of 32 tiles, or a soup draining to still lifes."""
    from gol_distributed_final_tpu_torch.ops import sparse

    if kind == "overflow":
        board, tile, capacity = _r_pentomino_board(256, 256), (1, 16), 32
    else:
        board, tile, capacity = _settling_soup(53), (1, 8), 64
    st = sparse.SparseBitPlane(life.CONWAY, tile=tile, device=cuda_device).encode(board)
    got = _sparse_against_plain(st, n_blocks, tile, h, capacity)
    assert 0 < got.blocks_done < n_blocks
    assert got.overflow if kind == "overflow" else (got.count == 0 and not got.overflow)


def _tile_soup(shape, tile, frac, seed, device):
    """Random words in random tiles, about ``frac`` of the tiles active once
    the occupancy grid is dilated (1 - (1 - q)^9 = frac)."""
    rng = np.random.default_rng(seed)
    tr, tc = tile
    grid_shape = (shape[0] // tr, shape[1] // tc)
    q = 1 - (1 - frac) ** (1 / 9)
    chosen = rng.random(grid_shape) < q
    mask = np.repeat(np.repeat(chosen, tr, 0), tc, 1)
    words = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(np.where(mask, words, 0).astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [0.05, 0.5])
def test_sparse_frontier_past_the_resident_grid(cuda_device, frac):
    """16384^2 soups with 5% and 50% of the default tiles active and a
    capacity of every tile (8192): at 50% the frontier is past the CTAs the
    card holds at once, so each CTA walks several tiles a block."""
    from gol_distributed_final_tpu_torch.ops import bitpack, sparse, sparse_tiles

    shape = bitpack.packed_shape(16384, 16384)
    tile = sparse.sparse_tile_shape(shape)
    packed = _tile_soup(shape, tile, frac, 16384 + int(100 * frac), cuda_device)
    st = sparse.SparseBitPlane(life.CONWAY, device=cuda_device).from_packed(packed)
    capacity = (shape[0] // tile[0]) * (shape[1] // tile[1])
    ctas = sparse_tiles.ctas(tile, 8, capacity, life.CONWAY.birth_mask,
                             life.CONWAY.survive_mask)
    assert 0 < ctas
    if frac == 0.5:
        assert st.count > 2 * ctas, (st.count, ctas)
    got = _sparse_against_plain(st, 3, tile, 8, capacity)
    assert got.blocks_done == 3


@pytest.mark.cuda
def test_sparse_dispatch_repeats_bitwise(cuda_device):
    """The same dispatch 20 times, with lists whose order the atomics vary:
    every result bitwise equal to the first, and the first to the plain
    program's. A race between the phases would show as a difference."""
    from gol_distributed_final_tpu_torch.ops import bitpack, sparse, sparse_tiles

    shape = bitpack.packed_shape(4096, 4096)
    tile = sparse.sparse_tile_shape(shape)
    st = sparse.SparseBitPlane(life.CONWAY, device=cuda_device).from_packed(
        _tile_soup(shape, tile, 0.2, 20, cuda_device))
    capacity = sparse._pow2_ceil(st.count * 4)
    first = _sparse_against_plain(st, 16, tile, 8, capacity)
    for _ in range(19):
        again = sparse_tiles.dispatch(st.packed, st.grid, 16, tile, 8, capacity, 8, 12)
        assert torch.equal(again.packed, first.packed) and torch.equal(again.grid, first.grid)
        assert again[2:] == first[2:]


@pytest.mark.cuda
def test_sparse_held_result_survives_later_dispatches(cuda_device):
    """A dispatch's board and grid are its own: later dispatches of the
    same geometry, which share the cached workspace, leave them as they
    were (the period-2 probe holds two results across dispatches)."""
    from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

    st = sparse.SparseBitPlane(life.CONWAY, tile=(1, 16), device=cuda_device).encode(
        _r_pentomino_board(256, 256))
    held = sparse_tiles.dispatch(st.packed, st.grid, 5, (1, 16), 8, 64, 8, 12)
    kept = (held.packed.clone(), held.grid.clone())
    nxt = sparse_tiles.dispatch(held.packed, held.grid, 5, (1, 16), 8, 64, 8, 12)
    again = sparse_tiles.dispatch(st.packed, st.grid, 1, (1, 16), 8, 64, 8, 12)
    torch.cuda.synchronize()
    assert torch.equal(held.packed, kept[0]) and torch.equal(held.grid, kept[1])
    assert not torch.equal(nxt.packed, held.packed) and again.blocks_done == 1


_ONE_LAUNCH_TRACE = """
import json, sys
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from gol_distributed_final_tpu_torch.models import CONWAY
from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

board = np.zeros((256, 256), np.uint8)
for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
    board[128 + dy, 128 + dx] = 255
st = sparse.SparseBitPlane(CONWAY, tile=(1, 16), device="cuda").encode(board)

def call():
    return sparse_tiles.dispatch(st.packed, st.grid, 64, (1, 16), 8, 128, 8, 12)

call()
activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
windows = []
for _ in range(16):
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        call()
        call()
        torch.cuda.synchronize()
    with profile(activities=activities):
        torch.cuda.synchronize()
    events = prof.events()
    starts = [ev.time_range.start for ev in events if ev.device_type == DeviceType.CPU
              and ev.name.startswith(("cudaLaunchKernel", "cudaLaunchCooperativeKernel"))]
    windows.append([ev.name for ev in events if ev.device_type == DeviceType.CUDA and starts
                    and ev.time_range.start >= min(starts) and "sparse_" in ev.name])
    if len(windows[-1]) == 2:
        break
print(json.dumps(windows))
"""


@pytest.mark.cuda
def test_sparse_dispatch_is_one_launch(cuda_device):
    """A dispatch of 64 blocks is one launch of the sparse kernel: one in
    ``sparse_tiles.launches``, and in the profiler's trace of two dispatches
    two launches of it and no other sparse kernel. The profiler loses
    records, or delivers them in a later window, more often the longer a
    process has traced (see _traced_kernels), so the trace is taken in a
    fresh process: windows of two dispatches, each followed by an empty
    one that takes what comes late, until one holds two launches."""
    import json
    import subprocess
    import sys

    from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

    st = sparse.SparseBitPlane(life.CONWAY, tile=(1, 16), device=cuda_device).encode(
        _r_pentomino_board(256, 256))
    assert sparse_tiles.dispatch(st.packed, st.grid, 64, (1, 16), 8, 128, 8, 12).blocks_done == 64
    sparse_tiles.reset_counts()
    sparse_tiles.dispatch(st.packed, st.grid, 64, (1, 16), 8, 128, 8, 12)
    assert sparse_tiles.launches == 1 and sparse_tiles.plain_calls == 0
    out = subprocess.run([sys.executable, "-c", _ONE_LAUNCH_TRACE], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    windows = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(len(names) <= 2 and all("sparse_blocks_kernel" in name for name in names)
               for names in windows), windows
    assert len(windows[-1]) == 2, [len(names) for names in windows]


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


# -- the mesh planes on one card (parallel/) ------------------------------------


def _mesh24(device):
    from gol_distributed_final_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((2, 4), devices=[device] * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3, 8])
@pytest.mark.parametrize("shape", [(32, 1024), (128, 4096), (45, 296)])
def test_mesh_on_one_card_equals_the_single_board_kernel(cuda_device, depth, shape):
    """A (2, 4) mesh of eight shards on one card, every block on the tiled
    kernel over its exchanged halos: equal to the single-board tiled
    step_n, one launch a block an exchange, the blocks never off the card."""
    from gol_distributed_final_tpu_torch.parallel import sharded_bit_step_n_fn
    from gol_distributed_final_tpu_torch.parallel.halo import exchanges_per_dispatch
    from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard

    mesh = _mesh24(cuda_device)
    rows, cols = shape[0] - shape[0] % 2, shape[1] - shape[1] % 4
    packed = _words((rows, cols), depth + rows, cuda_device)
    if min(rows // 2, cols // 4) < depth:
        pytest.skip("the block is shallower than the halo")
    want = tiled.step_n(packed, 37)
    torch.cuda.synchronize()
    tiled.reset_counts()
    step = sharded_bit_step_n_fn(mesh, halo_depth=depth)
    got = step(ShardedBoard.from_global(mesh, packed), 37)
    assert all(b.is_cuda for b in got.blocks.values())
    assert torch.equal(got.gather(), want)
    assert tiled.launches == 8 * exchanges_per_dispatch(37, depth) and tiled.plain_calls == 0


@pytest.mark.cuda
def test_mesh_column_packing_and_deep_halos_run_bit_step_on_the_card(cuda_device):
    """word_axis 1 and a halo past one launch's 8 turns keep the JAX
    package's routing: bit_step in torch ops on the card, no tiled launch."""
    from gol_distributed_final_tpu_torch.parallel import sharded_bit_step_n_fn
    from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard

    mesh = _mesh24(cuda_device)
    for word_axis, depth, shape in ((1, 1, (256, 64)), (0, 9, (32, 1024))):
        packed = _words(shape, depth, cuda_device)
        tiled.reset_counts()
        got = sharded_bit_step_n_fn(mesh, word_axis=word_axis, halo_depth=depth)(
            ShardedBoard.from_global(mesh, packed), 19)
        assert tiled.launches == 0 and tiled.plain_calls == 0
        assert torch.equal(got.gather(), bitpack.bit_step_n(packed, 19, word_axis))


@pytest.mark.cuda
def test_mesh_planes_serve_golden_sessions_on_the_card(cuda_device, tmp_path):
    """512^2 x 100 on ShardedBitPlane through the engine, and 64^2 x 100
    on the byte mesh plane as the engine's step function: the goldens."""
    from gol_distributed_final_tpu_torch.parallel import make_bit_plane, make_engine_step

    mesh = _mesh24(cuda_device)
    board = read_pgm(REPO_ROOT / "images" / "512x512.pgm")
    tiled.reset_counts()
    res = Engine(EngineConfig(plane=make_bit_plane(mesh, (512, 512)))).run(
        Params(turns=100, image_width=512, image_height=512), board)
    assert tiled.launches > 0 and tiled.plain_calls == 0
    assert np.array_equal(res.world, read_pgm(REPO_ROOT / "check" / "images" / "512x512x100.pgm"))
    run(Params(turns=100, image_width=64, image_height=64), images_dir=REPO_ROOT / "images",
        out_dir=tmp_path, tick_seconds=3600,
        engine_config=EngineConfig(step_n_fn=make_engine_step(mesh)))
    assert ((tmp_path / "64x64x100.pgm").read_bytes()
            == (REPO_ROOT / "check" / "images" / "64x64x100.pgm").read_bytes())


def _obs_off():
    from gol_distributed_final_tpu_torch.obs import device as obs_device
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.enable(False)
    obs_metrics.registry().reset()
    obs_device.reset_dispatch()


@pytest.mark.cuda
@pytest.mark.parametrize("site_call", ["whole_board", "whole_board_block", "batch_board",
                                       "tiled", "byte_board", "byte_tiled", "strip_steps"])
def test_each_wrapper_times_its_launches_by_events(cuda_device, site_call):
    """With metrics on, every launch of a wrapper is one event pair under
    its site, resolved without a synchronisation of the card: the site's
    count is the wrapper's launches and its device time is positive; the
    rates stay under the card's ceilings."""
    from gol_distributed_final_tpu_torch.obs import device as obs_device
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics
    from gol_distributed_final_tpu_torch.ops import strip_steps

    calls = {
        "whole_board": (whole_board, whole_board.CLUSTER_SITE,
                        lambda: whole_board.step_n(_words((16, 512), 1, cuda_device), 64)),
        "whole_board_block": (whole_board, "pallas.vmem_bit",
                              lambda: _on_one_block(_words((16, 512), 1, cuda_device), 64, 0)),
        "batch_board": (batch_board, "pallas.vmem_bit_batch",
                        lambda: batch_board.step_n(_words((8, 4, 128), 2, cuda_device), 16)),
        "tiled": (tiled, "pallas.tiled",
                  lambda: tiled.step_n(_words((128, 4096), 3, cuda_device), 20)),
        "byte_board": (byte_board, "pallas.vmem_byte",
                       lambda: byte_board.step_n(_bytes((64, 64), 4, cuda_device), 8)),
        "byte_tiled": (byte_tiled, "pallas.fused_byte",
                       lambda: byte_tiled.step_n(_bytes((512, 512), 5, cuda_device), 40)),
        "strip_steps": (strip_steps, "fused.strip",
                        lambda: strip_steps.strip_steps(_bytes((1040, 4096), 6, cuda_device),
                                                        8, 1024, attest=True)),
    }
    module, site, fn = calls[site_call]
    _obs_off()
    try:
        obs_metrics.enable()
        module.reset_counts()
        fn()
        torch.cuda.synchronize()
        stats = obs_device.dispatch_stats()
        assert set(stats) == {site}
        assert stats[site]["calls"] == module.launches > 0
        assert stats[site]["wall_s"] > 0
        assert stats[site]["flops"] / stats[site]["wall_s"] <= 1.673e13
        assert stats[site]["bytes_accessed"] / stats[site]["wall_s"] <= 3.35e12
        assert obs_device.pending_launches() == 0
    finally:
        _obs_off()


@pytest.mark.cuda
def test_metrics_off_creates_no_event_on_the_card(cuda_device, monkeypatch):
    from gol_distributed_final_tpu_torch.obs import device as obs_device

    made = []
    real = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1) or real(*a, **k))
    _obs_off()
    whole_board.step_n(_words((16, 512), 7, cuda_device), 64)
    byte_tiled.step_n(_bytes((512, 512), 8, cuda_device), 16)
    torch.cuda.synchronize()
    assert made == [] and obs_device.dispatch_stats() == {}


@pytest.mark.cuda
def test_sample_hbm_reads_the_card(cuda_device):
    from gol_distributed_final_tpu_torch.obs import device as obs_device

    obs_device.reset_hbm()
    keep = torch.empty(1 << 20, dtype=torch.uint8, device=cuda_device)
    got = obs_device.sample_hbm()["0"]
    assert 0 < got["bytes_in_use"] <= got["peak_bytes_in_use"] <= got["bytes_limit"]
    assert got["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    del keep


@pytest.mark.cuda
@pytest.mark.parametrize("verb, size, module", [
    ("session", 128, batch_board), ("run", 512, whole_board),
])
def test_canary_probe_on_a_card_broker(cuda_device, verb, size, module):
    """The canary's two verbs against a broker on the card: SessionRun
    batches onto K2, Run onto K1; each probe bit-exact against the numpy
    oracle and metered ok."""
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics
    from gol_distributed_final_tpu_torch.obs.canary import CanaryProber
    from gol_distributed_final_tpu_torch.obs.status import series_map
    from gol_distributed_final_tpu_torch.rpc import broker

    server, service = broker.serve(port=0, device="cuda")
    prober = CanaryProber(f"127.0.0.1:{server.port}", size=size, turns=16, verb=verb)
    try:
        obs_metrics.registry().reset()
        obs_metrics.enable()
        module.reset_counts()
        results = [prober.probe_once()["result"] for _ in range(3)]
        assert results == ["ok"] * 3
        assert module.launches > 0 and module.plain_calls == 0
        probes = series_map(obs_metrics.registry().snapshot(), "gol_canary_probes_total")
        assert probes[("ok",)]["value"] == 3
    finally:
        prober.stop()
        service.shutdown()
        _obs_off()


# -- the history mode (K1's alive count after every turn, one launch) ---------

#: a packed board at K1's gate: 227 x 128 words = 232,448 B in two copies
GATE_SHAPE = (227, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,word_axis", [
    ((2, 64), 0), ((64, 2), 1), ((3, 128), 0), ((96, 4), 1), ((16, 512), 0), ((512, 16), 1),
    ((1500, 4), 0), ((4, 1500), 1), (GATE_SHAPE, 0), (GATE_SHAPE, 1),
])
def test_history_kernel_matches_plain(cuda_device, shape, word_axis):
    """64^2, 96x128 and 512^2 in both packings, a packed axis of more words
    than a block has threads, and a board at the gate: every rule, one
    history launch a call, equal to ``history_plain``; the step launches'
    count does not move."""
    assert whole_board.smem_bytes(GATE_SHAPE) == whole_board.smem_limit(cuda_device)
    packed = _words(shape, word_axis, cuda_device)
    before, steps = whole_board.history_launches, whole_board.launches
    for rule in ALL_RULES:
        for n in (1, 300):
            got = whole_board.history(packed, n, word_axis, rule.birth_mask, rule.survive_mask)
            want = whole_board.history_plain(packed, n, word_axis, rule.birth_mask,
                                             rule.survive_mask)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), (rule.name, n)
    assert whole_board.history_launches == before + 2 * len(ALL_RULES)
    assert whole_board.launches == steps


@pytest.mark.cuda
def test_history_kernel_over_a_batch(cuda_device):
    """The history mode's C entry point over a batch, one block a
    universe: ``[B, n]`` counts, each row a universe's plain history."""
    import ctypes

    packed = _words((5, 4, 128), 9, cuda_device)
    n = 50
    out = torch.empty_like(packed)
    counts = torch.full((5, n), -1, dtype=torch.int32, device=cuda_device)
    common, dead_only, live_only = bitpack.rule_masks(life.HIGHLIFE.birth_mask,
                                                      life.HIGHLIFE.survive_mask)
    err = whole_board._lib().gol_whole_board_history(
        packed.data_ptr(), out.data_ptr(), counts.data_ptr(), 5, 4, 128, 0, n,
        common, dead_only, live_only, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    torch.cuda.synchronize()
    for b in range(5):
        want = whole_board.history_plain(packed[b], n, 0, life.HIGHLIFE.birth_mask,
                                         life.HIGHLIFE.survive_mask)
        assert torch.equal(counts[b], want)
        assert torch.equal(out[b], bitpack.bit_step_n(packed[b], n, 0, life.HIGHLIFE.birth_mask,
                                                      life.HIGHLIFE.survive_mask))


@pytest.mark.cuda
def test_alive_history_past_the_gate_equals_plain(cuda_device):
    """1024^2 is past K1's gate: one tiled launch a turn, the counts
    summed on the card and read back once, equal to the plain history."""
    rng = np.random.default_rng(14)
    board = np.where(rng.random((1024, 1024)) < 0.3, 255, 0).astype(np.uint8)
    packed = bitpack.pack(board, 0, cuda_device)
    assert not whole_board.fits(tuple(packed.shape), cuda_device)
    before = (tiled.launches, whole_board.history_launches)
    got = bitpack.alive_history(packed, 200)
    assert (tiled.launches - before[0], whole_board.history_launches - before[1]) == (200, 0)
    want = whole_board.history_plain(packed, 200).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [16, 64, 512])
def test_golden_sweep_through_alive_history(cuda_device, size):
    """Every turn 1..10000 of check/alive: 64^2 and 512^2 in ONE history
    launch each, 16^2 on the byte stencil in torch ops on the card."""
    from gol_distributed_final_tpu_torch.ops import stencil

    with open(REPO_ROOT / "check" / "alive" / f"{size}x{size}.csv") as f:
        golden = {int(r["completed_turns"]): int(r["alive_cells"]) for r in csv.DictReader(f)}
    want = np.array([golden[t] for t in range(1, 10_001)], np.int32)
    board = read_pgm(REPO_ROOT / "images" / f"{size}x{size}.pgm")
    before = whole_board.history_launches
    if size % 32:
        got = stencil.alive_history(torch.from_numpy(board.copy()).to(cuda_device), 10_000)
        assert whole_board.history_launches == before
    else:
        got = bitpack.alive_history(bitpack.pack(board, 0, cuda_device), 10_000)
        assert whole_board.history_launches == before + 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_control_plane_soak_on_the_card(cuda_device, tmp_path):
    """The JAX package's control-plane soak on the card (tests/
    torch_soak.py): the session on K1, the oracle one history launch."""
    from torch_soak import CARD_TURNS, control_plane_soak

    before = whole_board.history_launches
    seen = control_plane_soak(tmp_path / "out", "cuda", turns=CARD_TURNS)
    assert whole_board.history_launches == before + 1
    assert 0 < seen["done"] < CARD_TURNS, "'q' ends the card's session"


@pytest.mark.cuda
def test_session_soak_one_minute(cuda_device, tmp_path):
    """The counterpart of tests_tpu/test_session_soak_tpu.py: a one-minute
    4096^2 ``big_session`` of the R-pentomino under the 2-second ticker, a
    mid-run 's', a 'p'/'p' pause and a checkpoint every 50,000 turns, ended
    by 'q', with that test's timeline, sizes and assertions; then the run
    resumed from its last checkpoint writes the same PGM. The engine keeps
    its own chunk schedule (the JAX test's pinned 4096-turn chunks avoided
    Mosaic recompiles; the port compiles nothing at run time)."""
    from torch_soak import session_soak

    seen = session_soak(tmp_path, "cuda", size=4096, seconds=60.0, checkpoint_every=50_000)
    print(f"session soak: {seen}")
    # big_session steps a BitPlane (the tiled kernel at 4096^2); the
    # engine's own route for this board would be the sparse plane
    assert seen["auto_plane"] == "SparseBitPlane"


#: what the profiler's device clock may stray from the host's and still
#: count as one clock: far below a 1024-turn K1 launch (~1.6 ms at 512^2)
CLOCK_SLACK_NS = 50_000


@pytest.mark.cuda
def test_spans_and_the_profilers_device_records_share_a_clock(cuda_device):
    """Under torch.profiler, the K1 record of each synchronised growth
    chunk of at least 1024 turns starts after its ``engine.chunk`` span
    began and ends inside the ``engine.sync`` span that waited for it: the
    host spans and the device trace read one clock. With metrics on, each
    chunk's ``device_compute`` is device time: the 14 chunks of a 10000-turn
    run observe at least their K1 records' time and at most the run's
    wall. A trace can lose records; the run is taken again, up to four
    times, until one holds a K1 record of such a chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gol_distributed_final_tpu_torch.obs import device as obs_device
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics
    from gol_distributed_final_tpu_torch.obs import tracing

    board = np.asarray(read_pgm(REPO_ROOT / "images" / "512x512.pgm"))
    engine = Engine(EngineConfig())
    engine.run(Params(turns=100, image_width=512, image_height=512), board)  # warm
    params = Params(turns=10_000, image_width=512, image_height=512)
    tracing.enable()
    obs_metrics.enable()
    try:
        for _ in range(4):
            tracing.tracer().reset()
            obs_metrics.registry().reset()
            obs_device.reset_dispatch()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                engine.run(params, board)
                wall = time.perf_counter() - t0
            obs_device.resolve()
            spans = tracing.tracer().snapshot()
            # a record a trace delivers late belongs to an earlier window
            first = min(s["start_ns"] for s in spans)
            k1 = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() == DeviceType.CUDA and "whole_board" in ev.name()
                  and ev.start_ns() >= first]
            chunks = [s for s in spans if s["name"] == "engine.chunk"]
            syncs = [s for s in spans if s["name"] == "engine.sync"]
            matched, margins = 0, []
            for chunk in chunks:
                if not chunk["args"]["sync"] or chunk["args"]["turns"] < 1024:
                    continue
                sync = min((s for s in syncs if s["start_ns"] >= chunk["end_ns"]),
                           key=lambda s: s["start_ns"])
                for start, end in k1:
                    if chunk["start_ns"] - CLOCK_SLACK_NS <= start <= sync["end_ns"]:
                        assert start >= chunk["start_ns"] - CLOCK_SLACK_NS, (chunk, start)
                        assert sync["start_ns"] - CLOCK_SLACK_NS <= end \
                            <= sync["end_ns"] + CLOCK_SLACK_NS, (sync, start, end)
                        margins.append((start - chunk["start_ns"], end - sync["start_ns"],
                                        sync["end_ns"] - end))
                        matched += 1
            if matched:
                break
        assert matched, f"no K1 record of a growth chunk in {len(k1)} records"
        print(f"clock check: {matched} K1 records of growth chunks; (record start - chunk "
              f"start, record end - sync start, sync end - record end) in ns: {margins}")
        seg = {tuple(s["labels"]): s for fam in obs_metrics.registry().snapshot()["families"]
               if fam["name"] == "gol_turn_segment_seconds" for s in fam["series"]}
        compute = seg[("engine", "device_compute")]
        k1_s = sum(end - start for start, end in k1) / 1e9
        assert compute["count"] == len(chunks) == 14
        assert k1_s - 1e-4 <= compute["sum"] <= wall, (k1_s, compute["sum"], wall)
        print(f"device_compute: {compute['sum']:.6f} s over {compute['count']} chunks; K1 "
              f"records {k1_s:.6f} s; the run's wall {wall:.6f} s")
    finally:
        tracing.enable(False)
        tracing.tracer().reset()
        obs_metrics.enable(False)
        obs_metrics.registry().reset()
        obs_device.reset_dispatch()
