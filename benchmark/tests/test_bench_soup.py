"""The seeded soup (``harness/soup.py``) and the light-cone reference
(``reference.evolve_windows``) against the whole torus."""

import functools

import numpy as np
import pytest

from benchmark import reference
from benchmark.harness import soup


def test_splitmix64_gives_the_published_first_output():
    # SplitMix64 started at state 0 first gives 0xE220A8397B1DCDAF
    assert int(soup.splitmix64(np.array([0], np.uint64))[0]) == 0xE220A8397B1DCDAF


def test_a_cell_follows_the_definition_written_out():
    seed, height, width, density = 2**32 + 77, 300, 200, 0.3
    board = soup.region(seed, 0, 0, height, width, height, width, density)
    mask = 2**64 - 1
    for y, x in ((0, 0), (5, 199), (299, 0), (123, 45)):
        z = ((((seed % 2**32) << 32) + y * width + x) + 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        z ^= z >> 31
        assert bool(board[y, x]) == ((z >> 32) < density * 2**32), (y, x)
        assert board[y, x] in (0, 255)


@pytest.mark.parametrize("y0,x0", [(-5, -7), (250, 3), (-3, 250), (254, 254), (-256, 512)])
def test_a_region_agrees_with_itself_across_edges_and_corners(y0, x0):
    height = width = 256
    whole = soup.region(9, 0, 0, height, width, height, width, 0.5)
    block = soup.region(9, y0, x0, 20, 30, height, width, 0.5)
    expect = whole.take(range(y0, y0 + 20), 0, mode="wrap").take(range(x0, x0 + 30), 1,
                                                                  mode="wrap")
    assert np.array_equal(block, expect)


def test_a_region_larger_than_the_board_repeats_it():
    whole = soup.region(4, 0, 0, 16, 24, 16, 24, 0.5)
    assert np.array_equal(soup.region(4, -16, -24, 48, 72, 16, 24, 0.5), np.tile(whole, (3, 3)))


def test_density_and_seeds():
    board = soup.region(2**31 + 11, 0, 0, 1024, 1024, 1024, 1024, 0.5)
    assert abs(np.count_nonzero(board) / board.size - 0.5) <= 0.01
    assert not np.array_equal(board, soup.region(2**31 + 12, 0, 0, 1024, 1024, 1024, 1024, 0.5))
    # the seed counts modulo 2**32
    assert np.array_equal(board, soup.region(2**31 + 11 + 2**32, 0, 0, 1024, 1024, 1024, 1024,
                                             0.5))
    assert np.count_nonzero(soup.region(1, 0, 0, 64, 64, 64, 64, 1.0)) == 64 * 64
    assert np.count_nonzero(soup.region(1, 0, 0, 64, 64, 64, 64, 0.0)) == 0
    with pytest.raises(ValueError):
        soup.region(1, 0, 0, 1, 1, 2**17, 2**16, 0.5)


def _soup(seed, size):
    return functools.partial(soup.region, seed, height=size, width=size, density=0.5)


@pytest.mark.parametrize("size", [128, 256])
@pytest.mark.parametrize("turns", [0, 1, 17, 60, 70])  # 70: a stage of 64, then 6
def test_windows_equal_the_whole_torus(size, turns):
    fns = [_soup(31, size), _soup(2**32 - 1, size)]
    finals = [reference.evolve(fn(0, 0, size, size), turns) for fn in fns]
    # windows straddling the top and left edges, the bottom-right corner,
    # one inside, and the same place on a second soup in the same stack
    corners = [(0, -10, -12), (0, size - 9, size - 20), (0, 40, 33), (1, 40, 33), (1, -4, 50)]
    for h, w in ((16, 24), (5, 64)):
        got = reference.evolve_windows([(fns[k], y0, x0) for k, y0, x0 in corners], h, w, turns)
        for (k, y0, x0), window in zip(corners, got):
            expect = finals[k].take(range(y0, y0 + h), 0, mode="wrap").take(
                range(x0, x0 + w), 1, mode="wrap")
            assert np.array_equal(window, expect), (size, turns, h, w, k, y0, x0)


@pytest.mark.parametrize("turns", [60, 70])
def test_a_cone_larger_than_the_board_evolves_the_torus(turns):
    """The cone of a window is a block of the board's periodic tiling, also
    where it is larger than the board: 16 + 2 x 60 > 128 rows, and on a
    128-row, 256-column torus 2 + 2 x 60 fits and 8 + 2 x 70 does not."""
    size = 128
    fn = _soup(5, size)
    final = reference.evolve(fn(0, 0, size, size), turns)
    [got] = reference.evolve_windows([(fn, -8, 100)], 16, 40, turns)
    assert np.array_equal(got, final.take(range(-8, 8), 0, mode="wrap").take(
        range(100, 140), 1, mode="wrap"))
    wide = functools.partial(soup.region, 5, height=size, width=256, density=0.5)
    final = reference.evolve(wide(0, 0, size, 256), turns)
    [got] = reference.evolve_windows([(wide, 127, 250)], 2, 8, turns)
    assert np.array_equal(got, final.take([127, 0], 0).take(range(250, 258), 1, mode="wrap"))

