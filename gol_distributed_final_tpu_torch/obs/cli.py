"""The observability flags of the broker's and the worker's CLIs
(``-metrics -timeline -trace -journal -profile``), with the JAX package's
meanings and defaults, and the crash and run-end hooks around a server's
wait. The controller's CLI (``__main__.py``) keeps its own, which add
``-report`` and ``-trace-device``.
"""

from __future__ import annotations

import os

from . import flight, journal, metrics, profiler, timeline, tracing


def add_obs_flags(parser, role: str) -> None:
    """The observability flags a broker and a worker share, with the JAX
    package's meanings and defaults."""
    parser.add_argument(
        "-metrics", action="store_true", default=False,
        help="enable the metrics registry (obs/): per-verb RPC, engine and "
             "kernel timings, served live by the read-only Status verb",
    )
    parser.add_argument(
        "-timeline", nargs="?", const=1.0, default=None, type=float,
        metavar="SECS",
        help="enable the server-side metric timeline (obs/timeline.py): a "
             "background sampler snapshots every series at this cadence "
             "(default 1 s) into bounded rings, computes rates/p99s, "
             "evaluates the SLO rulebook (obs/slo.py), and ships "
             "incremental windows + alert states in Status replies; "
             "implies -metrics",
    )
    parser.add_argument(
        "-trace", action="store_true", default=False,
        help="enable the span tracer + flight recorder (obs/tracing.py, "
             "obs/flight.py): spans join the calling controller's trace "
             "via Request.trace_ctx and ship back in Status replies",
    )
    parser.add_argument(
        "-journal", nargs="?", const="out", default=None, metavar="DIR",
        help="enable the durable lifecycle journal (obs/journal.py): "
             "HLC-stamped lifecycle events append to "
             f"DIR/journal_{role}_<pid>.jsonl (default out/), crc-framed "
             "and size-rotated",
    )
    parser.add_argument(
        "-profile", nargs="?", const=10.0, default=None, type=float,
        metavar="MS",
        help="enable the continuous sampling profiler (obs/profiler.py) at "
             "this cadence (default 10 ms, adaptive backoff): incremental "
             "windows in Status replies, collapsed-stack + speedscope "
             "artifacts at run end and on crash; implies -metrics",
    )


def enable_obs(parser, args, role: str) -> None:
    """Turn on what ``add_obs_flags``' flags ask for, before anything
    instrumented runs."""
    if args.metrics:
        metrics.enable()
    if args.timeline is not None:
        if args.timeline <= 0:
            parser.error(f"-timeline SECS must be > 0, got {args.timeline}")
        timeline.enable(period=args.timeline)  # implies metrics.enable()
    if args.trace:
        tracing.enable()
        tracing.set_process_name(role)
        flight.enable()
    if args.journal is not None:
        journal.enable(out_dir=args.journal, role=role)
    if args.profile is not None:
        if args.profile <= 0:
            parser.error(f"-profile MS must be > 0, got {args.profile}")
        profiler.enable(period_ms=args.profile, tag=f"{role}_{os.getpid()}")


class ObsLifetime:
    """Around a server's wait: on an unhandled exception or interrupt the
    flight ring, the journal tail and the profile are left on disk before
    it propagates; at the end the journal segment is closed and the
    profiler's run-end artifacts written."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            flight.dump_on_crash(exc)
            journal.flush_on_crash(exc)
            profiler.flush_on_crash(exc)
        journal.disable()  # flush + close the segment cleanly
        profiler.shutdown()  # run-end collapsed/speedscope artifacts
        return False
