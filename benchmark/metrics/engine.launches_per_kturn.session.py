"""Kernel launches in the traced window per 1000 turns completed."""

from benchmark.harness.readers import launches_per_kturn as read  # noqa: F401
