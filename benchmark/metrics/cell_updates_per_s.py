"""Cell-updates a second: every turn of every session in the window, times the
board's cells, over the window."""

from benchmark.harness.readers import cell_updates_per_s as read  # noqa: F401
