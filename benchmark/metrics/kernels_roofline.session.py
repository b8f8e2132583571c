"""The window's roofline bound as a share of all device time in it (ref512 cells)."""

from benchmark.harness.readers import kernels_roofline as read  # noqa: F401
