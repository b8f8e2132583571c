"""The broker's mean handler time of Operations.Run over the window, from its RPC metering."""

from benchmark.harness.readers import run_ms as read  # noqa: F401
