"""Observability — the metrics/report layer the perf work attributes to.

The reference's only runtime signals are the 2-second ``AliveCellsCount``
tick and a ``runtime/trace`` test wrapper (count_test.go, trace_test.go);
this package adds the ``torch.profiler`` shim in ``utils/trace.py``. Neither says
*where* a run's wall clock goes — dispatch vs. halo exchange vs. host
transfer vs. RPC — which is the first question every perf round asks
(BENCH_r*.json measures only end-to-end time).

This package is the answer, in these parts:

* ``metrics``     — a dependency-free registry (counters, gauges,
                    fixed-bucket histograms) with JSON and Prometheus-text
                    exposition and EXACT cross-host merge;
* ``instruments`` — the single declaration site for every metric the
                    codebase records (engine, controller, RPC, ops,
                    parallel) — the stable-name contract the README
                    documents and ``lint`` enforces;
* ``report``      — the ``RunReport`` writer (registry + device inventory
                    + memory stats -> ``out/report_<W>x<H>x<Turns>.json``)
                    and the ``Status`` RPC payload builder;
* ``tracing``     — the cross-process span tracer (trace_id propagated
                    over ``Request.trace_ctx``) with Chrome trace-event
                    export (``out/trace_<W>x<H>x<Turns>.json``, Perfetto-
                    loadable) and the ``torch.profiler`` device-trace
                    fold-in (``-trace-device`` routes ``utils/trace.py``'s
                    profiler shim into the same out dir, span names pushed
                    as ``record_function`` ranges);
* ``flight``      — the hang flight-recorder: a bounded per-process ring
                    of the last structured events (span open/close, RPC
                    send/recv, checkpoint votes), shipped in ``Status``
                    replies and dumped to ``out/flight_<host>.jsonl`` on
                    unhandled engine exceptions;
* ``device``      — the card's telemetry: each kernel launch timed by a
                    pair of CUDA events with its int32-operation and byte
                    counts, the nvcc build time of each kernel source, and
                    per-device ``memory_stats`` HBM gauges sampled per
                    turn-chunk (empty on the CPU) with a process-local
                    peak high-water mark;
* ``perf``        — the roofline classes of those sites against the
                    card's ceilings;
* ``status``      — the ``Status`` poll, the reader the JAX package's
                    ``watch`` and ``doctor`` dashboards share.

Everything is process-local and OFF by default: with metrics and tracing
disabled each instrument call is a flag check, so the hot paths cost
nothing until an operator passes ``-metrics``/``-report``/``-trace`` (or
calls ``metrics.enable()`` / ``tracing.enable()``).
"""

from . import metrics  # noqa: F401
