"""The arithmetic behind the metric files in ``benchmark/metrics/``.

Each reader takes the run's records (``runner.py``) and returns a number,
or None where the records hold nothing for it to read. The records: the
window (``window_ns``), every session of it (``sessions``), the
configuration's rule and board size, with ``--trace 1`` the reduced device
trace (``trace``, ``devtrace.reduce``) and the broker's handler seconds by
verb over the window (``server``).
"""

from __future__ import annotations

from benchmark.harness import roofline


def _window_s(r) -> float:
    t0, t1 = r["window_ns"]
    return (t1 - t0) / 1e9


def _done(r):
    return [s for s in r["sessions"] if s.answered]


def cell_updates_per_s(r):
    done = _done(r)
    if not done:
        return None
    return sum(s.turns for s in done) * r["cells_per_board"] / _window_s(r)


def kernels_roofline(r):
    """The least time the card could take for the window's sessions (the
    yardstick in ``roofline.py``) as a share of the device time of every
    kernel, copy and set in the window."""
    trace = r["trace"]
    if trace is None or trace["device_s"] <= 0:
        return None
    bound = roofline.bound_s((s.turns for s in _done(r)), r["cells_per_board"], r["rule"])
    return None if bound is None else 100.0 * bound / trace["device_s"]


def idle_pct(r):
    trace = r["trace"]
    if trace is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def launches_per_kturn(r):
    trace = r["trace"]
    turns = sum(s.turns for s in _done(r))
    if trace is None or not trace["launches"] or not turns:
        return None
    return trace["launches"] / (turns / 1000.0)


def _server_ms(r, verb):
    calls = (r["server"] or {}).get(verb)
    if not calls or calls["calls"] <= 0:
        return None
    return 1000.0 * calls["seconds"] / calls["calls"]


def run_ms(r):
    return _server_ms(r, "Operations.Run")


def outside_broker_ms(r):
    """A controller session's mean wall (the benchmark's span around
    ``run``) less the broker's mean time in ``Run``: the controller, its PGM
    input and output, and the RPC client and wire."""
    done = _done(r)
    inside = run_ms(r)
    if not done or inside is None:
        return None
    return sum(s.end_ns - s.start_ns for s in done) / len(done) / 1e6 - inside
