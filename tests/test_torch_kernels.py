"""The PyTorch port's kernel modules (ops/whole_board.py, ops/tiled.py) and
plane routing (ops/auto.py) against the JAX package's Pallas kernels, run
in interpret mode on the CPU as the JAX package's own tests run them.

On the CPU each wrapper takes its kernel's plain torch version; the
kernels themselves are held against those plain versions on the card by
tests/test_torch_cuda.py (skipped here) and by chip_smoke.py.
Game of Life is integer-exact: equality, tolerance none.
"""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.models import life as jlife
from gol_distributed_final_tpu.ops import auto as jauto
from gol_distributed_final_tpu.ops import bitpack as jbit
from gol_distributed_final_tpu.ops import pallas_stencil, pallas_tiled
from gol_distributed_final_tpu.ops.fused import _fused_bit_counted_compiled
from gol_distributed_final_tpu_torch.models import life as tlife
from gol_distributed_final_tpu_torch.ops import auto as tauto
from gol_distributed_final_tpu_torch.ops import bitpack as tbit
from gol_distributed_final_tpu_torch.ops import tiled, whole_board


def _board(h, w, seed, density=0.35):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < density, 255, 0).astype(np.uint8)


# -- the whole-board kernel (K1) ----------------------------------------------


@pytest.mark.parametrize("rule", ["CONWAY", "HIGHLIFE"])
@pytest.mark.parametrize("h,w,word_axis", [(64, 96, 0), (48, 64, 1)])
@pytest.mark.parametrize("n", [1, 5])
def test_whole_board_counted_matches_pallas(rule, h, w, word_axis, n):
    jrule, trule = getattr(jlife, rule), getattr(tlife, rule)
    packed = np.asarray(jbit.pack(_board(h, w, seed=h * n), word_axis))
    want = np.asarray(jax.jit(pallas_stencil.bit_pallas_call(
        n, word_axis, True, jrule.birth_mask, jrule.survive_mask
    ))(packed))
    _, want_counts = _fused_bit_counted_compiled(
        n, word_axis, True, jrule.birth_mask, jrule.survive_mask
    )(packed)
    state = tbit.state_from_numpy(packed, "cpu")
    before = (whole_board.launches, whole_board.plain_calls)
    got, counts = whole_board.step_n(
        state, n, word_axis, trule.birth_mask, trule.survive_mask, counted=True
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert counts.dtype == torch.int32
    # a CPU tensor takes the plain version: no launch is counted
    assert (whole_board.launches, whole_board.plain_calls) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(state.numpy(), packed)  # input untouched


def test_whole_board_gate_is_the_cards_shared_memory():
    assert whole_board.smem_limit("cpu") == whole_board.H100_SMEM_OPTIN == 232_448
    assert whole_board.smem_bytes((16, 512)) == 65_536
    assert whole_board.fits((16, 512), "cpu")  # 512^2 board
    assert whole_board.fits((29, 1000), "cpu")  # 928 x 1000: 232,000 B
    assert not whole_board.fits((32, 1024), "cpu")  # 1024^2 board: 262,144 B


# -- K1's cluster route: the plan and the route choice ------------------------


#: packed shape, word axis, and the route the plan gives: (blocks, halo
#: depth, lines a thread in the register loop or 0 for the shared-memory
#: loop, the register loop's warps a block)
CLUSTER_PLANS = [
    ((16, 512), 0, (16, 16, 4, 8)), ((512, 16), 1, (16, 16, 4, 8)),  # 512^2: bands of 32 lines
    ((8, 256), 0, (16, 16, 4, 3)), ((256, 8), 1, (16, 16, 4, 3)),    # 256^2: bands of 16 lines
    ((4, 128), 0, (1, 0, 0, 0)), ((128, 4), 1, (1, 0, 0, 0)),        # 128^2: 512 words, one block
    ((20, 384), 0, (16, 16, 4, 14)), ((640, 12), 1, (16, 16, 4, 9)),  # 640 x 384 in both packings
    ((5, 160), 0, (8, 16, 4, 3)),                 # 160 lines: 16 bands of 10 too thin
    ((6, 192), 0, (16, 12, 4, 2)), ((7, 224), 0, (16, 14, 4, 3)),  # bands thinner than the depth
    ((30, 960), 0, (16, 16, 8, 12)),              # 960^2: one line column a warp; 4 lines: 23 warps
    ((29, 1000), 0, (8, 16, 0, 0)),               # 1000 lines: 8 divides; 157 slots: 20 warps
    ((40, 640), 0, (16, 16, 0, 0)), ((640, 40), 1, (16, 16, 0, 0)),  # 40 words: past a warp
    ((1500, 4), 0, (1, 0, 0, 0)), ((4, 1500), 1, (1, 0, 0, 0)),  # 4 lines: no band holds a halo
    ((100, 24), 0, (1, 0, 0, 0)),                 # 2 bands of 12 and halos: past the board
    ((1, 1), 0, (1, 0, 0, 0)),
]


@pytest.mark.parametrize("shape,word_axis,plan", CLUSTER_PLANS)
def test_cluster_plan_bands_and_phases(shape, word_axis, plan):
    """The plan, the one place a single board's route is chosen: the
    blocks, halo depth, loop and the register loop's block, bands that
    split the lines evenly, each with room for its halo, every band's two
    copies with halos within one block's shared memory, and the register
    loop wherever a line fits a warp and a block of at most 16 warps holds
    the band and its halo. Memoised: the same route for every launch."""
    route = whole_board.cluster_plan(shape, word_axis)
    assert route == plan
    assert whole_board.cluster_plan(shape, word_axis) is route
    blocks, depth, lines_a_thread, warps = plan
    words, lines = (shape if word_axis == 0 else shape[::-1])
    bands = whole_board.bands(shape, word_axis, blocks)
    assert [first for first, _ in bands] == [b * lines // blocks for b in range(blocks)]
    assert {size for _, size in bands} == {lines // blocks}
    if blocks == 1:
        assert route.name == "block"
        return
    band = lines // blocks
    assert words * lines >= whole_board.MIN_CLUSTER_WORDS
    assert band >= whole_board.MIN_BAND
    assert depth == min(whole_board.HALO_DEPTH, band)
    assert 2 * 4 * (band + 2 * depth) * words <= whole_board.smem_bytes(shape)
    assert route == whole_board.loop_route(shape, word_axis, blocks)
    if lines_a_thread == 0:
        # the shared-memory loop: the line is wider than a warp, or no block
        # of the register loop holds the band and its halo
        assert route.name == "cluster"
        assert warps == 0
        assert words > whole_board.REG_MAX_WORDS or not any(
            whole_board.register_warps(words, band + 2 * depth, n)
            for n in whole_board.REG_LINE_CHOICES)
        return
    assert route.name == "cluster_registers"
    assert lines_a_thread in whole_board.REG_LINE_CHOICES
    assert warps == whole_board.register_warps(words, band + 2 * depth, lines_a_thread)
    assert 0 < 32 * warps <= whole_board.register_threads(lines_a_thread)
    assert warps * 32 // words * lines_a_thread >= band + 2 * depth


@pytest.mark.parametrize("words,slots,lines,warps", [
    (16, 64, 4, 8), (16, 64, 8, 4), (16, 64, 2, 16),  # 512^2 at depth 16
    (16, 96, 2, 0), (16, 96, 4, 12),                  # depth 32: 24 warps of 2 lines, past 512
    (5, 52, 4, 3), (6, 36, 4, 2), (6, 36, 2, 4),      # 160^2, 192^2
    (30, 92, 4, 0), (30, 92, 8, 12),                  # 960^2: one line column a warp
    (30, 100, 8, 0), (29, 157, 8, 0),                 # 8 lines a thread: at most 12 warps
    (33, 64, 4, 0), (32, 64, 4, 16), (16, 64, 0, 0),
])
def test_register_loop_block(words, slots, lines, warps):
    """The register loop's block: stacks of ``lines`` lines, 32 // words
    a warp; none past 512 threads (16 warps), 384 with 8 lines a thread, or
    for a line past a warp."""
    assert whole_board.register_warps(words, slots, lines) == warps


@pytest.mark.parametrize("shape,word_axis,name", [
    ((16, 512), 0, "cluster_registers"), ((40, 640), 0, "cluster"), ((4, 128), 0, "block"),
])
def test_route_names_the_loop(shape, word_axis, name):
    """The route's label of ``gol_whole_board_launches_total``."""
    assert whole_board.cluster_plan(shape, word_axis).name == name


@pytest.mark.parametrize("n,depth,want", [
    (0, 16, []), (1, 16, [1]), (15, 16, [15]), (16, 16, [16]), (17, 16, [16, 1]),
    (100, 16, [16] * 6 + [4]), (4096, 16, [16] * 256), (100, 0, [100]), (0, 0, []),
])
def test_cluster_phases_end_with_the_short_one(n, depth, want):
    """Phases of ``depth`` turns between the cluster's meetings, the last
    one n % depth; one phase of all n on one block. The meetings
    (``gol_whole_board_meetings_total``) lie between the phases."""
    assert whole_board.phases(n, depth) == want
    assert sum(want) == n
    assert whole_board.meetings(n, depth) == max(len(want) - 1, 0)


def test_cluster_plan_matches_the_kernel_source():
    """The plan respects what csrc/whole_board.cu compiles in: the register
    loop's lines a thread are its instantiations of R, a line lies on one
    warp's lanes, and each R's block stays within the thread limits its
    ``__launch_bounds__`` take."""
    src = (pathlib.Path(whole_board.__file__).parents[1] / "csrc" / "whole_board.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kRegMaxWords|kRegMaxThreads|kRegMaxThreadsWide) = (\d+);", src)}
    assert consts == {"kRegMaxWords": whole_board.REG_MAX_WORDS,
                      "kRegMaxThreads": whole_board.REG_MAX_THREADS,
                      "kRegMaxThreadsWide": whole_board.REG_MAX_THREADS_WIDE}
    compiled = {int(v) for v in re.findall(
        r"launch_cluster_registers<WORD_AXIS, (\d+)>", src)}
    assert compiled == set(whole_board.REG_LINE_CHOICES)
    assert set(whole_board.REG_LINES) <= compiled
    limits = {r: whole_board.register_threads(r) for r in whole_board.REG_LINE_CHOICES}
    assert limits == {2: whole_board.REG_MAX_THREADS, 4: whole_board.REG_MAX_THREADS,
                      8: whole_board.REG_MAX_THREADS_WIDE}


# -- K1's register loop, emulated: the kernel's schedule in numpy ------------


def _line_sums(x):
    """gol_line_sum along the last axis (the packed axis, wrapped): the
    weight-1 and weight-2 planes of each word and its two neighbours."""
    prev, nxt = np.roll(x, 1, axis=-1), np.roll(x, -1, axis=-1)
    minus = (x << np.uint32(1)) | (prev >> np.uint32(31))
    plus = (x >> np.uint32(1)) | (nxt << np.uint32(31))
    return minus ^ x ^ plus, (minus & x) | (plus & (minus ^ x))


def _finish(masks, a, b, c, mid):
    """gol_finish: the T planes of three line sums, then the rule's select."""
    a_s, a_c = a[0] ^ b[0] ^ c[0], (a[0] & b[0]) | (c[0] & (a[0] ^ b[0]))
    b_s, b_c = a[1] ^ b[1] ^ c[1], (a[1] & b[1]) | (c[1] & (a[1] ^ b[1]))
    c_c = a_c & b_s
    planes = (a_s, a_c ^ b_s, b_c ^ c_c, b_c & c_c)
    full = np.uint32(0xFFFFFFFF)

    def any_eq(mask):
        acc = np.zeros_like(mid)
        for value in range(10):
            if mask >> value & 1:
                eq = np.full_like(mid, full)
                for bit, plane in enumerate(planes):
                    eq &= plane if value >> bit & 1 else ~plane
                acc |= eq
        return acc

    common, dead_only, live_only = masks
    return any_eq(common) | (~mid & any_eq(dead_only)) | (mid & any_eq(live_only))


def _register_loop(packed, n, word_axis, masks, route):
    """The register loop's schedule as csrc/whole_board.cu runs it, on
    numpy: the band and halo of each of the cluster's blocks cut into
    stacks of ``route.lines`` lines, ``32 // P`` line columns a warp (the
    block holds ``route.warps`` warps); a turn makes every stack's line
    sums, takes the lines above and below it from the warp's neighbouring
    column, or at a warp's end from the neighbouring warp's edge sums, or
    at the block's ends from its own stack (garbage the halo absorbs); a
    warp outside the phase's cone is idle, its words junk here; every
    ``depth`` turns each block meets its two neighbours: every block
    pushes its band's first ``depth`` lines into the bottom halo slots of
    the block above and its last into the top halo slots of the block
    below, into the slots of the meeting's parity (one block takes both
    pushes on a cluster of 2), and then loads its halo from its own slots
    of that parity, which start as junk. Lines past the slots hold zeros.
    Returns the board, packed as it came."""
    blocks, depth, per_thread, warps = route
    lines_np = np.asarray(packed).astype(np.uint32)
    lines_np = lines_np.T.copy() if word_axis == 0 else lines_np.copy()
    Q, P = lines_np.shape
    band, cols = Q // blocks, 32 // P
    slots = band + 2 * depth
    assert warps > 0 and warps * cols * per_thread >= slots
    span = cols * per_thread
    # the slot of line r of the stack at (warp, column)
    first = np.arange(warps)[:, None] * span + np.arange(cols)[None, :] * per_thread
    slot = first[:, :, None] + np.arange(per_thread)[None, None, :]
    inside = slot < slots
    loaded = np.stack([lines_np[(b * band - depth + np.arange(slots)) % Q]
                       for b in range(blocks)])
    x = np.where(inside[None, :, :, :, None],
                 loaded[:, np.minimum(slot, slots - 1)], np.uint32(0))
    # each block's halo slots: [parity, top or bottom, line, word]
    halos = np.full((blocks, 2, 2, depth, P), np.uint32(0x5A5A5A5A))
    # the slots of each warp's first and last lines: a warp whose lines all
    # lie two slots or more outside those a turn needs is idle for it, and
    # its words turn to junk here, which no needed line may read
    warp_first = np.arange(warps) * span
    warp_last = warp_first + span - 1
    meeting, left = 0, n
    while left > 0:
        r = min(depth, left)
        left -= r
        for s in range(1, r + 1):
            lo = depth - r + s
            idle = (warp_last <= lo - 2) | (warp_first >= slots - lo + 1)
            v0, v1 = _line_sums(x)  # [block, warp, column, line, word]
            ext0 = np.concatenate([v0[:, :, :, -1:], v0, v0[:, :, :, :1]], axis=3)
            ext1 = np.concatenate([v1[:, :, :, -1:], v1, v1[:, :, :, :1]], axis=3)
            for ext, v in ((ext0, v0), (ext1, v1)):
                ext[:, :, 1:, 0] = v[:, :, :-1, -1]   # the column above's last line
                ext[:, :, :-1, -1] = v[:, :, 1:, 0]   # the column below's first line
                ext[:, 1:, 0, 0] = v[:, :-1, -1, -1]  # the warp above's last line
                ext[:, :-1, -1, -1] = v[:, 1:, 0, 0]  # the warp below's first line
            x = _finish(masks, (ext0[..., :-2, :], ext1[..., :-2, :]),
                        (ext0[..., 1:-1, :], ext1[..., 1:-1, :]),
                        (ext0[..., 2:, :], ext1[..., 2:, :]), x)
            x[:, idle] = np.uint32(0xA5A5A5A5) ^ (x[:, idle] << np.uint32(1))
        if left > 0:
            parity = meeting & 1
            first = (slot >= depth) & (slot < 2 * depth)
            last = (slot >= band) & (slot < band + depth)
            for b in range(blocks):
                halos[(b - 1) % blocks, parity, 1, slot[first] - depth] = x[b][first]
                halos[(b + 1) % blocks, parity, 0, slot[last] - band] = x[b][last]
            top = slot < depth
            bottom = inside & (slot >= depth + band)
            x[:, top] = halos[:, parity, 0, slot[top]]
            x[:, bottom] = halos[:, parity, 1, slot[bottom] - depth - band]
            meeting += 1
    result = np.zeros_like(lines_np)
    in_band = inside & (slot >= depth) & (slot < depth + band)
    for b in range(blocks):
        result[b * band + slot[in_band] - depth] = x[b][in_band]
    result = result.T if word_axis == 0 else result
    return np.ascontiguousarray(result).view(np.int32)


#: the sweep's boards (chip_smoke.py --k1-sweep) that take the register
#: loop, and the rules: Conway, compiled, and B36/S125, a run-time one
REGISTER_BOARDS = [((16, 512), 0), ((512, 16), 1), ((8, 256), 0), ((256, 8), 1),
                   ((20, 384), 0), ((640, 12), 1), ((5, 160), 0), ((6, 192), 0),
                   ((7, 224), 0), ((30, 960), 0)]


def _register_routes(shape, word_axis, depth):
    """The register loop's routes on the plan's cluster at halo ``depth``
    (clamped to the band; None: the plan's own depth, and the plan's route
    with them): every compiled lines a thread, where the block holds
    them."""
    plan = whole_board.cluster_plan(shape, word_axis)
    routes = {plan} if depth is None else set()
    for per_thread in whole_board.REG_LINE_CHOICES:
        route = whole_board.cluster_route(shape, word_axis, plan.blocks,
                                          plan.depth if depth is None else depth, per_thread)
        if route.warps:
            routes.add(route)
    return sorted(routes)


@pytest.mark.parametrize("depth", [None, 8, 10, 12, 32])
@pytest.mark.parametrize("rule", ["B3/S23", "B36/S125"])
@pytest.mark.parametrize("shape,word_axis", REGISTER_BOARDS)
def test_register_loop_schedule_matches_plain(shape, word_axis, rule, depth):
    """The register loop's schedule, emulated, equals the plain version
    for n across the cluster's phase edges, at every route it may take on
    the plan's cluster at the plan's halo depth (None) and at the sweep's
    other depths."""
    trule = tlife.LifeRule.from_rulestring(rule)
    masks = tbit.rule_masks(trule.birth_mask, trule.survive_mask)
    rng = np.random.default_rng(sum(shape) + word_axis)
    packed = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    state = torch.from_numpy(packed)
    plain = {}
    for route in _register_routes(shape, word_axis, depth):
        assert route.lines in whole_board.REG_LINE_CHOICES
        d = route.depth
        for n in sorted({0, 1, 2, d - 1, d, d + 1, 2 * d + 3, 100}):
            if n not in plain:
                plain[n] = whole_board.step_n_plain(state, n, word_axis, trule.birth_mask,
                                                    trule.survive_mask)[0].numpy()
            got = _register_loop(packed, n, word_axis, masks, route)
            np.testing.assert_array_equal(got, plain[n], err_msg=f"{route} n={n}")


class _StubLibrary:
    """The kernel library's entry points, recording their calls: the
    single-board entry records the route it is handed and runs the board
    on it, or on one block where ``refuse`` says the card refused the
    cluster."""

    def __init__(self, refuse=False):
        self.refuse = refuse
        self.calls = []

    def gol_whole_board_step_as(self, src, dst, counts, rows, cols, word_axis, n, common,
                                dead_only, live_only, route, stream):
        self.calls.append(("one", rows, cols, word_axis, n, *route))
        if self.refuse:
            route[:] = (1, 0, 0, 0)
        return 0

    def gol_whole_board_step(self, src, dst, counts, batch, rows, cols, word_axis, n, common,
                             dead_only, live_only, stream):
        self.calls.append(("batch", batch, rows, cols, word_axis, n))
        return 0


@pytest.fixture
def stub_library(monkeypatch):
    """A stub in place of the built library and of the card's stream, with
    metrics on, so a CPU tensor can stand in for a board on the card."""
    import contextlib
    import types

    from gol_distributed_final_tpu_torch.obs import device as obs_device
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics

    def install(refuse=False):
        stub = _StubLibrary(refuse)
        monkeypatch.setattr(whole_board, "_lib", lambda: stub)
        return stub

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    obs_metrics.registry().reset()
    obs_device.reset_dispatch()
    obs_metrics.enable(True)
    yield install
    obs_metrics.enable(False)
    obs_metrics.registry().reset()
    obs_device.reset_dispatch()


def _routes(meetings=False):
    """K1's single-board launches by route, or with ``meetings`` their
    meetings (``gol_whole_board_meetings_total{route}``)."""
    from gol_distributed_final_tpu_torch.obs import instruments as ins

    counter = ins.WHOLE_BOARD_MEETINGS_TOTAL if meetings else ins.WHOLE_BOARD_LAUNCHES_TOTAL
    return {route: counter.labels(route).value
            for route in ("block", "cluster", "cluster_registers")}


@pytest.mark.parametrize("shape,word_axis,refuse", [
    ((16, 512), 0, False), ((512, 16), 1, False), ((8, 256), 0, False),
    ((4, 128), 0, False), ((16, 512), 0, True), ((40, 640), 0, False),
])
def test_single_board_route_with_the_library_stubbed(stub_library, shape, word_axis, refuse):
    """A batch of one under the gate hands the library the plan's route
    whole (blocks, depth, loop and warps) and takes the cluster route where
    the plan gives more than one block: counted under route
    "cluster_registers" for the register loop, under "cluster" for the
    shared-memory loop, timed under ``CLUSTER_SITE``, its meetings counted
    under the same route. A board the plan keeps on one block, and a
    cluster the card refuses, take one block, timed under the caller's
    site, with no meeting; the launch returns the route that ran."""
    from gol_distributed_final_tpu_torch.obs import device as obs_device

    stub = stub_library(refuse)
    board = torch.zeros(shape, dtype=torch.int32)
    counts = torch.zeros(shape[0], dtype=torch.int32)
    whole_board.reset_counts()
    route = whole_board.launch_one(board, torch.empty_like(board), counts, 100, word_axis,
                                   8, 12, "pallas.fused_bit")
    plan = whole_board.cluster_plan(shape, word_axis)
    assert stub.calls == [("one", *shape, word_axis, 100, *plan)]
    want = whole_board.Route(1) if refuse else plan
    assert route == want
    on_cluster = want.blocks > 1
    registers = want.name == "cluster_registers"
    assert whole_board.launches == 1
    assert _routes() == {"block": float(not on_cluster),
                         "cluster": float(on_cluster and not registers),
                         "cluster_registers": float(registers)}
    met = whole_board.meetings(100, want.depth)
    assert met == (len(whole_board.phases(100, plan.depth)) - 1 if on_cluster else 0)
    assert _routes(meetings=True) == {
        "block": 0.0, "cluster": float(met if on_cluster and not registers else 0),
        "cluster_registers": float(met if registers else 0)}
    site = whole_board.CLUSTER_SITE if on_cluster else "pallas.fused_bit"
    assert set(obs_device.dispatch_stats()) == {site}


def test_a_batch_above_one_takes_one_block_with_the_library_stubbed(stub_library):
    """K2's launches (ops/batch_board.py) go through ``launch``, the
    one-block entry over the batch, whatever the plan gives one board of
    it; the single-board route counters do not move."""
    from gol_distributed_final_tpu_torch.obs import device as obs_device

    stub = stub_library()
    boards = torch.zeros((4, 16, 512), dtype=torch.int32)
    whole_board.reset_counts()
    whole_board.launch(boards, torch.empty_like(boards), None, 64, 0, 8, 12,
                       "pallas.fused_bit_batch")
    assert whole_board.cluster_plan((16, 512), 0).blocks > 1
    assert stub.calls == [("batch", 4, 16, 512, 0, 64)]
    assert whole_board.launches == 0
    assert _routes() == {"block": 0.0, "cluster": 0.0, "cluster_registers": 0.0}
    assert _routes(meetings=True) == _routes()
    assert set(obs_device.dispatch_stats()) == {"pallas.fused_bit_batch"}


# -- the tiled kernel (K3 / K4) -----------------------------------------------


def _packed_16x256(word_axis, seed):
    """A packed (16, 256) board in either packing: one ragged tile of
    TILE, its window wider than the board on both axes."""
    board = _board(512, 256, seed) if word_axis == 0 else _board(16, 8192, seed)
    packed = np.asarray(jbit.pack(board, word_axis))
    assert packed.shape == (16, 256)
    return packed


@pytest.mark.parametrize("word_axis", [0, 1])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("rule", ["CONWAY", "HIGHLIFE"])
def test_tiled_matches_pallas_rows_mode(k, rule, word_axis):
    """One launch of the plain version (a one-word halo on the packed
    axis, k words on the other) equals the rows-mode Pallas kernel."""
    jrule, trule = getattr(jlife, rule), getattr(tlife, rule)
    packed = _packed_16x256(word_axis, seed=k)
    want = np.asarray(jax.jit(pallas_tiled.tiled_pallas_call(
        k, (16, 256), True, jrule.birth_mask, jrule.survive_mask, word_axis=word_axis
    ))(packed))
    got = tiled.step_n(
        tbit.state_from_numpy(packed, "cpu"), k, word_axis,
        trule.birth_mask, trule.survive_mask, turns_per_launch=k,
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("word_axis", [0, 1])
@pytest.mark.parametrize("k", [2, 8])
def test_tiled_matches_pallas_grid2d_mode(k, word_axis):
    shape = (16, 256)
    mode, _, _ = pallas_tiled._plan(*shape, 8, 128)
    assert mode == "grid2d"
    packed = _packed_16x256(word_axis, seed=10 + k)
    want = np.asarray(jax.jit(pallas_tiled.tiled_pallas_call(
        k, shape, True, block_rows=8, block_cols=128, word_axis=word_axis
    ))(packed))
    got = tiled.step_n(tbit.state_from_numpy(packed, "cpu"), k, word_axis,
                       turns_per_launch=k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("word_axis,h,w,packed_shape", [
    (0, 1280, 160, (40, 160)), (1, 40, 5120, (40, 160)),
    (0, 160, 77, (5, 77)), (1, 77, 160, (77, 5)),
])
@pytest.mark.parametrize("turns_per_launch", [3, 8])
def test_tiled_n_past_one_launch_matches_jax_bit_step_n(word_axis, h, w, packed_shape,
                                                        turns_per_launch):
    """n = 13 turns in launches of k (the last takes the rest) equal the
    JAX package's whole-torus bit_step_n. 40 x 160 words are 2 x 2 tiles
    of TILE, the last row and column of them ragged; 5 x 77 and 77 x 5 are
    smaller than a window on the packed axis, the other, or both."""
    assert tbit.packed_shape(h, w, word_axis) == packed_shape
    assert tiled.TILE == (32, 128)
    rule = jlife.HIGHLIFE
    packed = np.asarray(jbit.pack(_board(h, w, seed=3), word_axis))
    want = np.asarray(
        jbit.bit_step_n(packed, 13, word_axis, rule.birth_mask, rule.survive_mask)
    )
    before = tiled.plain_calls
    got = tiled.step_n(
        tbit.state_from_numpy(packed, "cpu"), 13, word_axis,
        rule.birth_mask, rule.survive_mask,
        turns_per_launch=turns_per_launch,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert tiled.plain_calls == before + 1


def test_tiled_constants_match_the_kernel_source():
    """The plain version tiles the board as the kernel does: TILE and
    MAX_TURNS mirror the compile-time constants of csrc/tiled.cu."""
    src = (pathlib.Path(tiled.__file__).parents[1] / "csrc" / "tiled.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kTileR|kTileC|kMaxTurns) = (\d+);", src
    )}
    assert (consts["kTileR"], consts["kTileC"]) == tiled.TILE
    assert consts["kMaxTurns"] == tiled.MAX_TURNS


def test_compiled_rules_match_the_kernel_source():
    """ops/bitpack.py::COMPILED_RULES mirrors the rule instantiations of
    csrc/bit_step.cuh, and every rule models/life.py names is one of them."""
    src = (pathlib.Path(tiled.__file__).parents[1] / "csrc" / "bit_step.cuh").read_text()
    block = re.search(r"#define GOL_COMPILED_RULES\(X\)(.*?)\n\n", src, re.S).group(1)
    triples = [tuple(int(v) for v in m)
               for m in re.findall(r"X\((\d+)u, (\d+)u, (\d+)u\)", block)]
    assert len(triples) == len(set(triples)) == 4
    assert set(triples) == set(tbit.COMPILED_RULES.values())
    named = [v for v in vars(tlife).values() if isinstance(v, tlife.LifeRule)]
    assert {r.name for r in named} == set(tbit.COMPILED_RULES)
    for rule in named:
        masks = tbit.rule_masks(rule.birth_mask, rule.survive_mask)
        assert tbit.COMPILED_RULES[rule.name] == masks
        assert tbit.is_compiled_rule(rule.birth_mask, rule.survive_mask)
    other = tlife.LifeRule.from_rulestring("B36/S125")
    assert not tbit.is_compiled_rule(other.birth_mask, other.survive_mask)


def test_tiled_rejects_turns_past_the_halo():
    state = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="1..8 turns"):
        tiled.step_n(state, 9, turns_per_launch=9)


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((4, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no whole-board kernel"):
        whole_board.step_n(meta, 1)
    with pytest.raises(ValueError, match="no tiled kernel"):
        tiled.step_n(meta, 1)


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("size", [16, 64, 512])
def test_auto_plane_picks_the_counterpart_class(size):
    jplane = jauto.auto_plane(jlife.CONWAY, (size, size))
    tplane = tauto.auto_plane(tlife.CONWAY, (size, size), "cpu")
    assert type(jplane).__name__ == type(tplane).__name__
    if tplane is not None:
        assert tplane.word_axis == jplane.word_axis


def test_auto_plane_past_the_gate():
    # past both packages' whole-board gates, under the JAX sparse floor
    shape = (4096, 3584)
    jplane = jauto.auto_plane(jlife.CONWAY, shape)
    tplane = tauto.auto_plane(tlife.CONWAY, shape, "cpu")
    assert type(jplane).__name__ == type(tplane).__name__ == "BitPlane"
    # the port's own gate is the card's shared memory: 1024^2 is past it,
    # though the JAX package's VMEM gate keeps it on the fused plane
    assert type(tauto.auto_plane(tlife.CONWAY, (1024, 1024), "cpu")).__name__ == "BitPlane"
    assert tauto.choose_word_axis((48, 64)) == jauto.choose_word_axis((48, 64)) == 1
    assert tauto.choose_word_axis((16, 16)) is None


def test_bitplane_steps_past_the_gate_on_the_tiled_path():
    from gol_distributed_final_tpu_torch.ops.fused import FusedBitPlane, fold_counts

    board = _board(1024, 64, seed=2)  # packed (32, 64): 16 KiB, fits
    plane = FusedBitPlane(tlife.CONWAY, 0, "cpu")
    state = plane.encode(board)
    before = (whole_board.plain_calls, tiled.plain_calls)
    out, counts = plane.step_n_counted(state, 9)
    assert (whole_board.plain_calls, tiled.plain_calls) == (before[0] + 1, before[1])
    want = np.asarray(jbit.bit_step_n(np.asarray(jbit.pack(board, 0)), 9, 0))
    np.testing.assert_array_equal(out.numpy(), want)
    assert fold_counts(counts) == int(np.count_nonzero(jbit.unpack(want, 0)))

    big = _board(1024, 1024, seed=4)  # packed (32, 1024): past the gate
    plane = FusedBitPlane(tlife.CONWAY, 0, "cpu")
    state = plane.encode(big)
    before = (whole_board.plain_calls, tiled.plain_calls)
    out, counts = plane.step_n_counted(state, 2)
    assert (whole_board.plain_calls, tiled.plain_calls) == (before[0], before[1] + 1)
    want = np.asarray(jbit.bit_step_n(np.asarray(jbit.pack(big, 0)), 2, 0))
    np.testing.assert_array_equal(out.numpy(), want)
    assert fold_counts(counts) == int(jbit.alive_count_packed(want))

