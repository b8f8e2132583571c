"""The plain reference against the repository's golden files."""

import numpy as np
import pytest

from benchmark import reference
from benchmark.harness import boards


def _alive_csv(root, size):
    return np.loadtxt(root / "check" / "alive" / f"{size}x{size}.csv", delimiter=",",
                      skiprows=1, dtype=np.int64)


@pytest.mark.parametrize("size", [16, 64])
def test_every_turns_alive_count_on_seeded_transforms(root, size):
    image = reference.read_pgm(root / "images" / f"{size}x{size}.pgm")
    rows = _alive_csv(root, size)
    for seed in (0, 3_000_000_019):
        board = reference.transform(image, *boards.transforms(seed, 1, image.shape)[0])
        for turn, alive in rows[:2000]:
            board = reference.evolve(board, 1)
            assert np.count_nonzero(board) == alive, (seed, turn)


def test_512_alive_counts_up_to_10000_turns_on_a_seeded_transform(root):
    image = reference.read_pgm(root / "benchmark" / "inputs" / "512x512.pgm")
    rows = dict(map(tuple, _alive_csv(root, 512)))
    board = reference.transform(image, *boards.transforms(2**31 + 5, 1, image.shape)[0])
    done = 0
    for turn in (1, 2, 3, 10, 100, 1000, 4321, 10000):
        board = reference.evolve(board, turn - done)
        done = turn
        assert np.count_nonzero(board) == rows[turn], turn


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("size", [16, 64])
def test_turns_past_a_repeat_are_taken_modulo_its_period(root, size, wrap):
    """The 16x16 image is a glider, which comes back every 64 turns on its
    torus; the 64x64 one settles into period 2 (by turn 1575 on the torus,
    241 with closed edges). ``evolve`` equals turn-by-turn byte stepping
    around the search's powers of two, and after 10^9 turns the state that
    the period gives."""
    image = reference.read_pgm(root / "images" / f"{size}x{size}.pgm")
    born, survive = reference.parse_rule("B3/S23")
    states, seen = [(image != 0).astype(np.uint8)], {}
    while states[-1].tobytes() not in seen:
        seen[states[-1].tobytes()] = len(states) - 1
        states.append(reference._step_bytes(states[-1], born, survive, wrap))
    first = seen[states[-1].tobytes()]
    period = len(states) - 1 - first
    while len(states) <= 2100:
        states.append(reference._step_bytes(states[-1], born, survive, wrap))
    for turns in (1, 63, 64, 65, 241, 1024, 1577, 2100):
        assert np.array_equal(reference.evolve(image, turns, wrap=wrap) != 0, states[turns] != 0)
    far = 10**9 + 1
    assert np.array_equal(reference.evolve(image, far, wrap=wrap) != 0,
                          states[first + (far - first) % period] != 0)


@pytest.mark.parametrize("size", [16, 64, 512])
@pytest.mark.parametrize("turns", [0, 1, 100])
def test_golden_images(root, size, turns):
    image = reference.read_pgm(root / "images" / f"{size}x{size}.pgm")
    golden = reference.read_pgm(root / "check" / "images" / f"{size}x{size}x{turns}.pgm")
    assert np.array_equal(reference.evolve(image, turns), golden)
    assert np.array_equal(reference.evolve_bytes(image, turns), golden)


def test_the_input_is_the_repository_image(root):
    assert (root / "benchmark" / "inputs" / "512x512.pgm").read_bytes() == \
        (root / "images" / "512x512.pgm").read_bytes()


@pytest.mark.parametrize("sym", range(8))
def test_evolution_commutes_with_the_seeded_transforms(root, sym):
    """What the check relies on: evolving a transformed board equals
    transforming the evolved one."""
    image = reference.read_pgm(root / "images" / "64x64.pgm")
    t = (37, 11, sym)
    assert np.array_equal(reference.evolve(reference.transform(image, *t), 60),
                          reference.transform(reference.evolve(image, 60), *t))


def test_word_and_byte_stepping_agree_on_random_boards():
    rng = np.random.default_rng(1)
    for shape in ((64, 64), (32, 128), (128, 192)):
        board = (rng.random(shape) < 0.35).astype(np.uint8) * 255
        for rule in ("B3/S23", "B36/S23", "B2/S"):
            assert np.array_equal(reference.evolve(board, 13, rule),
                                  reference.evolve_bytes(board, 13, rule))


def test_closed_edges_differ_from_the_torus(root):
    image = reference.read_pgm(root / "images" / "64x64.pgm")
    assert not np.array_equal(reference.evolve(image, 100, wrap=False),
                              reference.evolve(image, 100))


def test_seeded_boards_repeat_and_differ(root):
    shape = (512, 512)
    assert boards.transforms(11, 4, shape) == boards.transforms(11, 4, shape)
    assert boards.transforms(11, 4, shape) != boards.transforms(12, 4, shape)
    assert len(set(boards.transforms(2**31 + 1, 64, shape))) == 64


def test_reference_imports_nothing_of_the_port(root):
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference, "
            "benchmark.harness.soup, benchmark.harness.boards; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    tops = eval(out)
    assert "gol_distributed_final_tpu_torch" not in tops
    assert not {"jax", "jaxlib", "flax", "gol_distributed_final_tpu", "torch"} & set(tops)
