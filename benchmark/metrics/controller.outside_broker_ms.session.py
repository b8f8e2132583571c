"""A controller session's mean wall less the broker's mean Run time."""

from benchmark.harness.readers import outside_broker_ms as read  # noqa: F401
