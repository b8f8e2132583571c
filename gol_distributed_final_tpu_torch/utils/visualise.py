"""Board pretty-printers for test-failure output (reference: util/visualise.go:8-108).

Renders a board (or a given-vs-expected pair, side by side) in box-drawing
characters so small-board golden-test failures are diagnosable at a glance.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .cell import Cell

_ALIVE_CH = "█"
_DEAD_CH = " "


def _cells_to_grid(cells: Iterable[Cell], width: int, height: int):
    grid = [[False] * width for _ in range(height)]
    for c in cells:
        x, y = c
        if 0 <= y < height and 0 <= x < width:
            grid[y][x] = True
    return grid


def _render(grid: Sequence[Sequence[bool]], width: int) -> list[str]:
    top = "┌" + "─" * width + "┐"
    bottom = "└" + "─" * width + "┘"
    rows = ["│" + "".join(_ALIVE_CH if v else _DEAD_CH for v in row) + "│" for row in grid]
    return [top, *rows, bottom]


def visualise_matrix(matrix, width: int, height: int) -> str:
    """Render a 2-D 0/255 (or truthy) matrix as a framed board string."""
    grid = [[bool(matrix[y][x]) for x in range(width)] for y in range(height)]
    return "\n".join(_render(grid, width))


def alive_cells_to_string(
    given: Iterable[Cell],
    expected: Iterable[Cell],
    width: int,
    height: int,
) -> str:
    """Draw given-vs-expected boards side by side (util/visualise.go:8)."""
    g = _render(_cells_to_grid(given, width, height), width)
    e = _render(_cells_to_grid(expected, width, height), width)
    gap = "   "
    header = (
        "GIVEN".center(width + 2) + gap + "EXPECTED".center(width + 2)
    )
    return "\n".join([header] + [a + gap + b for a, b in zip(g, e)])
