"""Share of the traced window with no kernel, copy or set on the card (ref512 cells)."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
