"""The yardstick's arithmetic on known windows."""

import pytest

from benchmark.harness import devtrace, readers, roofline
from benchmark.harness.sessions import Session


def _done(n, turns, t0=0, each=10**7):
    out = []
    for i in range(n):
        s = Session(i, (0, 0, 0), turns, start_ns=t0 + i * each,
                    end_ns=t0 + (i + 1) * each, answered=True, turns=turns, alive=1)
        out.append(s)
    return out


def test_the_frozen_count_gives_the_operations_bound():
    # 512 x 512 x 10000 turns: 8192 words x 12 int32 instructions a turn
    assert roofline.bound_s([10000], 512 * 512, "B3/S23") == pytest.approx(
        8192 * 12 * 10000 / 1.673e13, rel=1e-12)
    # one turn of a huge board is bound by its bytes, read once, written once
    cells = 65536 * 65536
    assert roofline.bound_s([1], cells, "b3/s23") == pytest.approx(
        max(cells / 32 * 12 / 1.673e13, 2 * cells / 8 / 3.35e12))
    assert roofline.bound_s([1], 64, "B36/S23") is None


def _records(sessions, device, calls=()):
    t0, t1 = sessions[0].start_ns, sessions[-1].end_ns
    return {"rule": "B3/S23", "cells_per_board": 512 * 512, "window_ns": (t0, t1),
            "sessions": sessions, "server": {"Operations.Run": {"seconds": 0.5, "calls": 20}},
            "trace": devtrace.reduce({"device": device, "launch_calls": list(calls)}, t0, t1)}


def test_readers_on_a_known_window():
    sessions = _done(20, 10000)          # 20 sessions in 0.2 s
    # one kernel of 5 ms in each session, plus a copy before the window
    device = [("void (anonymous namespace)::k1<StaticRule<3,12>>(int*)",
               s.start_ns + 1000, s.start_ns + 1000 + 5 * 10**6) for s in sessions]
    device.append(("Memcpy HtoD (Pageable -> Device)", -5000, 10))
    r = _records(sessions, device, calls=[s.start_ns + 500 for s in sessions])
    device_s = 20 * 0.005 + 10e-9
    bound = 20 * 8192 * 12 * 10000 / 1.673e13
    assert readers.kernels_roofline(r) == pytest.approx(100 * bound / device_s)
    assert readers.idle_pct(r) == pytest.approx(100 * (1 - device_s / 0.2))
    assert readers.launches_per_kturn(r) == pytest.approx(20 / 200)
    assert readers.cell_updates_per_s(r) == pytest.approx(20 * 10000 * 512 * 512 / 0.2)
    assert readers.run_ms(r) == pytest.approx(25)
    assert readers.outside_broker_ms(r) == pytest.approx(10 - 25)
    assert r["trace"]["by_op_s"]["k1"] == pytest.approx(0.1)


def test_a_trace_without_device_records_reads_nothing():
    r = _records(_done(3, 100), [])
    assert readers.kernels_roofline(r) is None
    assert readers.idle_pct(r) is None
    assert readers.launches_per_kturn(r) is None


def test_union_and_gaps():
    spans = devtrace.union([("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 40, 41)])
    assert spans == [(0, 20), (30, 41)]
    assert devtrace.gaps(spans, -5, 50) == [(-5, 0), (20, 30), (41, 50)]

