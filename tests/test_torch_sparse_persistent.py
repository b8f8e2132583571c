"""The phase order of the port's persistent sparse kernel
(csrc/sparse_tiles.cu), emulated in numpy and held equal to the JAX
package's ``_sparse_program`` (jitted on the CPU) and to the port's plain
program, ``ops/sparse_tiles.py::dispatch_plain``.

The kernel cannot run here, so this file replays what its CTAs do, in the
order they do it: per-tile stamps set from the input grid and raised with
atomicMax for each next list, a tile appended to list k + 1 the first time
it is marked and slots past the capacity not written, the run-or-stop
decision read from ``counts[k]``, and block k stepped while block k - 1's
changed tiles are still being scattered into the board. The emulation
fills those tiles of the board with noise before block k steps, so a
window that read them from the board instead of from block k - 1's scratch
would differ. A small frontier's tiles are stepped in 2 or 4 parts of
their columns, as many as the grid of CTAs holds in one wave; each part
writes its columns, and a part that changed sets the tile's flag (three
buffers of flags, reset when a slot is appended, start as noise). The CTAs'
order comes from a seed: the lists' order differs from seed to seed and
the results must not. Game of Life is integer-exact: every comparison is
equality (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_distributed_final_tpu.models import LifeRule as JLifeRule
from gol_distributed_final_tpu.ops import sparse as jsparse
from gol_distributed_final_tpu_torch.models import LifeRule
from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

#: (order seed, CTAs) of the emulated runs: the grid's size sets how many
#: parts of its columns a tile is stepped in (4, 2 or 1 on these boards)
RUNS = ((0, 132), (1, 12), (2, 4096))


def _unpack(words):
    """int32 words [R, Q] (word axis 0) -> cells uint8 [32 R, Q]."""
    bits = (words.view(np.uint32)[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    return bits.reshape(-1, words.shape[1]).astype(np.uint8)


def _pack(cells):
    rows = cells.shape[0] // 32
    shifted = cells.reshape(rows, 32, -1).astype(np.uint64) << np.arange(32, dtype=np.uint64)[
        None, :, None]
    return shifted.sum(axis=1).astype(np.uint32).view(np.int32)


def _window_turn(cells, birth, survive):
    """One turn of a B/S rule on a window, cyclic within it: the roll
    spoils only the window's border, which the tile never sees."""
    n = sum(np.roll(cells, (dy, dx), axis=(0, 1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0))
    return np.where(cells == 1, (survive >> n) & 1, (birth >> n) & 1).astype(np.uint8)


def emulate(packed, grid, n_blocks, tile, h, capacity, birth, survive, seed, ctas=132):
    """The kernel's dispatch on numpy arrays, its CTAs in an order drawn
    from ``seed``, on a grid of ``ctas`` (which sets how many parts of its
    columns a tile is stepped in); returns what the wrapper returns
    (``_read_counts`` of the board, the grid and the counts)."""
    rng = np.random.default_rng(seed)
    tr, tc = tile
    rows, cols = packed.shape
    gr, gc = grid.shape
    tiles = gr * gc
    reach = -(-h // tc)
    width3 = 2 * reach + 1
    board = packed.copy()
    counts = [0] * (n_blocks + 1)
    scratch = rng.integers(-2**31, 2**31, (2, capacity, tr, tc)).astype(np.int32)
    changed = np.zeros((2, tiles, 2), np.int64)  # {k + 1, slot}, by block parity
    lists = np.full((2, capacity), -1, np.int64)
    # by block modulo 3: a slot's tile if any part of it changed, else -1
    # (garbage until a slot is appended, which sets -1)
    done = rng.integers(-5, 5, (3, capacity))
    # the window's rows: which tile of the 3 around the stepped one each
    # lies in, and where in it
    row_of = np.array([0] + [1] * tr + [2])
    rin = np.array([tr - 1] + list(range(tr)) + [0])

    # phase 1: stamps and list 0 from the grid, appended in any order
    stamp = grid.ravel().astype(np.int64)
    first = np.flatnonzero(stamp)
    rng.shuffle(first)
    counts[0] = len(first)
    lists[0, :min(len(first), capacity)] = first[:capacity]
    done[0, :min(len(first), capacity)] = -1

    def tile_of(t):
        r, c = divmod(int(t), gc)
        return slice(r * tr, (r + 1) * tr), slice(c * tc, (c + 1) * tc)

    def neighbour(t, dr, dc):
        r, c = divmod(int(t), gc)
        return ((r + dr) % gr) * gc + (c + dc) % gc

    def step(k, slot, part, width):
        parity = k & 1
        t = lists[parity, slot]
        r, c = divmod(int(t), gc)
        # the part's window columns, relative to the tile: which tile of
        # the 3 x width3 around it each lies in, and where in it
        off = part * width + np.arange(width + 2 * h) - h
        col_of = (off + reach * tc) // tc
        cin = off - (col_of - reach) * tc
        table = np.full((3, width3), -1)
        if k > 0:
            for dr in (-1, 0, 1):
                for dc in range(-reach, reach + 1):
                    rec = changed[parity ^ 1, neighbour(t, dr, dc)]
                    if rec[0] == k:
                        table[dr + 1, dc + reach] = rec[1]
        src = table[row_of[:, None], col_of[None, :]]
        br = (r * tr - 1 + np.arange(tr + 2)) % rows
        bc = (c * tc + off) % cols
        from_board = board[br[:, None], bc[None, :]]
        from_scratch = scratch[parity ^ 1, src.clip(0), rin[:, None], cin[None, :]]
        cur = _unpack(np.where(src >= 0, from_scratch, from_board))
        inner = (slice(32, 32 * (tr + 1)), slice(h, h + width))
        flag = False
        for _ in range(h):
            nxt = _window_turn(cur, birth, survive)
            flag |= bool((nxt[inner] != cur[inner]).any())
            cur = nxt
        # every part writes its columns; a changed one the tile's flag,
        # record and marks
        scratch[parity, slot, :, part * width:(part + 1) * width] = _pack(cur[inner])
        if not flag:
            return
        done[k % 3, slot] = t
        changed[parity, t] = (k + 1, slot)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                n = neighbour(t, dr, dc)
                if stamp[n] < k + 2:  # atomicMax's old value: the first mark
                    stamp[n] = k + 2
                    at = counts[k + 1]
                    counts[k + 1] += 1
                    if at < capacity:
                        lists[parity ^ 1, at] = n
                        done[(k + 1) % 3, at] = -1

    k = 0
    while True:
        count = counts[k]
        runs = k < n_blocks and 1 <= count <= capacity
        scattered = []
        if k > 0:
            # block k - 1's changed tiles: being written while block k
            # steps, so noise until the phase ends
            for slot in range(counts[k - 1]):
                if done[(k - 1) % 3, slot] >= 0:
                    t = done[(k - 1) % 3, slot]
                    board[tile_of(t)] = rng.integers(-2**31, 2**31, (tr, tc)).astype(np.int32)
                    scattered.append((slot, t))
        if runs:
            # as many parts of its columns a tile as keep them in one wave
            parts = 4
            while parts > 1 and (tc % parts or count * parts > ctas):
                parts //= 2
            for item in rng.permutation(count * parts):
                step(k, item % count, item // count, tc // parts)
        for slot, t in scattered:
            board[tile_of(t)] = scratch[(k - 1) & 1, slot]
        if not runs:
            grid_out = torch.from_numpy((stamp == k + 1).reshape(gr, gc))
            return sparse_tiles._read_counts(torch.from_numpy(board), grid_out, counts,
                                             n_blocks, capacity)
        k += 1


def _r_pentomino(h, w):
    board = np.zeros((h, w), np.uint8)
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        board[h // 2 + dy, w // 2 + dx] = 255
    return board


def _glider(h, w, y=1, x=1):
    board = np.zeros((h, w), np.uint8)
    for dy, dx in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        board[(y + dy) % h, (x + dx) % w] = 255
    return board


def _gosper_gun(h, w):
    cells = [
        (5, 1), (5, 2), (6, 1), (6, 2), (5, 11), (6, 11), (7, 11),
        (4, 12), (8, 12), (3, 13), (9, 13), (3, 14), (9, 14), (6, 15),
        (4, 16), (8, 16), (5, 17), (6, 17), (7, 17), (6, 18), (3, 21),
        (4, 21), (5, 21), (3, 22), (4, 22), (5, 22), (2, 23), (6, 23),
        (1, 25), (2, 25), (6, 25), (7, 25), (3, 35), (4, 35), (3, 36),
        (4, 36),
    ]
    board = np.zeros((h, w), np.uint8)
    for y, x in cells:
        board[y, x] = 255
    return board


def _soup(h, w, p, seed, window):
    rng = np.random.default_rng(seed)
    board = np.zeros((h, w), np.uint8)
    y0, y1, x0, x1 = window
    board[y0:y1, x0:x1] = np.where(rng.random((y1 - y0, x1 - x0)) < p, 255, 0)
    return board


def _blinker_one_tile(h, w):
    board = np.zeros((h, w), np.uint8)
    board[3:6, 4] = 255
    return board


# board, rule, tile, h, capacity, n_blocks, what the dispatch must show
CASES = {
    "r_pentomino_overflows_midway": (lambda: _r_pentomino(128, 128), "B3/S23", (1, 16), 8,
                                     16, 40, "overflow"),
    "gosper_gun": (lambda: _gosper_gun(128, 128), "B3/S23", (1, 16), 8, 32, 20, "all"),
    "glider_torus_corner": (lambda: _glider(64, 64, y=60, x=60), "B3/S23", (1, 8), 8, 16,
                            30, "all"),
    "drained_still_life": (lambda: _soup(64, 64, 0.5, 1, (10, 14, 10, 14)), "B3/S23",
                           (1, 8), 8, 16, 12, "drain"),
    "all_dead": (lambda: np.zeros((64, 64), np.uint8), "B3/S23", (1, 8), 8, 16, 5, "drain"),
    "capacity_1_one_tile_torus": (lambda: _blinker_one_tile(32, 8), "B3/S23", (1, 8), 8, 1,
                                  6, "all"),
    "capacity_below_first_count": (lambda: _glider(64, 64, y=30, x=30), "B3/S23", (1, 8), 8,
                                   1, 5, "overflow"),
    "b36_s125": (lambda: _soup(128, 128, 0.3, 19, (50, 80, 40, 90)), "B36/S125", (1, 8), 8,
                 64, 10, None),
    "highlife_ragged_tile_3x12": (lambda: _soup(96, 96, 0.3, 7, (40, 60, 30, 70)),
                                  "B36/S23", (3, 12), 8, 32, 9, None),
    # h past the tile's width: a window reaches 4 tile columns each side
    "reach_4_tile_1x2": (lambda: _soup(64, 64, 0.5, 9, (20, 26, 20, 26)), "B3/S23", (1, 2),
                         8, 64, 10, None),
}
for _h in range(1, 9):
    CASES[f"r_pentomino_h{_h}"] = (lambda: _r_pentomino(128, 128), "B3/S23", (1, 16), _h,
                                   32, 12, None)


def _three_ways(board, rulestring, tile, h, capacity, n_blocks):
    """(the JAX program's result, the plain program's, the emulation's
    for each order seed), from one board."""
    rule = LifeRule.from_rulestring(rulestring)
    pplane = sparse.SparseBitPlane(rule, tile=tile, device="cpu")
    jplane = jsparse.SparseBitPlane(JLifeRule.from_rulestring(rulestring), tile=tile)
    st, jst = pplane.encode(board), jplane.encode(board)
    masks = (rule.birth_mask, rule.survive_mask)
    program = jsparse._sparse_program(tuple(st.packed.shape), *tile, *masks, capacity, h)
    jp, jg, t, over, act = program(jst.packed, jst.grid, jnp.int32(n_blocks))
    jax_out = (np.asarray(jp), np.asarray(jg), int(t), bool(over), int(act),
               int(np.asarray(jg).sum()))
    plain = sparse_tiles.dispatch_plain(st.packed, st.grid, n_blocks, tile, h, capacity,
                                        *masks)
    emulated = [emulate(st.packed.numpy(), st.grid.numpy(), n_blocks, tile, h, capacity,
                        *masks, seed, ctas) for seed, ctas in RUNS]
    return st, jax_out, plain, emulated


def _as_tuple(d):
    return (d.packed.numpy(), d.grid.numpy(), d.blocks_done, d.overflow, d.active_sum, d.count)


def _assert_equal(got, want, where):
    assert np.array_equal(got[0], want[0]), f"{where}: board"
    assert np.array_equal(got[1], want[1]), f"{where}: grid"
    assert got[2:] == want[2:], f"{where}: (blocks, overflow, active sum, count)"


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_phases_equal_the_reference_and_the_plain_program(name):
    make, rulestring, tile, h, capacity, n_blocks, expect = CASES[name]
    _, jax_out, plain, emulated = _three_ways(make(), rulestring, tile, h, capacity, n_blocks)
    _assert_equal(_as_tuple(plain), jax_out, f"{name}: plain against JAX")
    for run, got in zip(RUNS, emulated):
        _assert_equal(_as_tuple(got), jax_out, f"{name}: emulation {run} against JAX")
    if expect == "overflow":
        assert plain.overflow and plain.blocks_done < n_blocks
    elif expect == "drain":
        assert not plain.overflow and plain.blocks_done < n_blocks and plain.count == 0
        assert not plain.grid.any()
    elif expect == "all":
        assert plain.blocks_done == n_blocks


def test_an_overflowed_dispatch_regrows_one_bucket_up():
    """The R-pentomino overflows a bucket of 16 midway; the next dispatch,
    from the grid the overflowing block started from, at 32, runs on."""
    board = _r_pentomino(128, 128)
    rule = LifeRule.from_rulestring("B3/S23")
    masks = (rule.birth_mask, rule.survive_mask)
    st = sparse.SparseBitPlane(rule, tile=(1, 16), device="cpu").encode(board)
    first = sparse_tiles.dispatch_plain(st.packed, st.grid, 40, (1, 16), 8, 16, *masks)
    assert first.overflow and first.count > 16
    program = jsparse._sparse_program(tuple(st.packed.shape), 1, 16, *masks, 32, 8)
    jp, jg, t, over, act = program(jnp.asarray(first.packed.numpy()),
                                   jnp.asarray(first.grid.numpy()), jnp.int32(20))
    want = (np.asarray(jp), np.asarray(jg), int(t), bool(over), int(act), int(np.asarray(jg).sum()))
    assert want[2] > 0
    _assert_equal(_as_tuple(sparse_tiles.dispatch_plain(first.packed, first.grid, 20, (1, 16),
                                                        8, 32, *masks)), want, "plain regrow")
    for seed, ctas in RUNS:
        got = emulate(first.packed.numpy(), first.grid.numpy(), 20, (1, 16), 8, 32, *masks,
                      seed, ctas)
        _assert_equal(_as_tuple(got), want, f"emulated regrow {(seed, ctas)}")


@pytest.mark.parametrize("seed", range(4))
def test_the_lists_order_varies_and_the_result_does_not(seed):
    """A frontier of many tiles in lists whose order differs from run to
    run (as the kernel's atomics make it): the same board, grid and counts
    from every order, equal to the plain program's."""
    board = _soup(128, 128, 0.4, 100 + seed, (20, 100, 16, 112))
    rule = LifeRule.from_rulestring("B3/S23")
    masks = (rule.birth_mask, rule.survive_mask)
    st = sparse.SparseBitPlane(rule, tile=(1, 8), device="cpu").encode(board)
    want = _as_tuple(sparse_tiles.dispatch_plain(st.packed, st.grid, 6, (1, 8), 8, 256, *masks))
    for order, ctas in enumerate((64, 256, 1024)):
        got = emulate(st.packed.numpy(), st.grid.numpy(), 6, (1, 8), 8, 256, *masks,
                      1000 * seed + order, ctas)
        _assert_equal(_as_tuple(got), want, f"soup {seed}, order {order}, {ctas} CTAs")
