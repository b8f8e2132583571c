"""The span arithmetic (``harness/spans.py``) on synthetic records."""

import pytest

from benchmark.harness import spans

MS = 1_000_000


def sp(name, role, trace, start_ms, end_ms, **args):
    return {"name": name, "role": role, "trace_id": trace, "span_id": f"{name}{start_ms}",
            "parent_id": "", "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS),
            "args": args}


def session(trace, t):
    """One session starting at ``t`` ms: 40 ms long, every host phase in it."""
    return [
        sp("controller.session", "controller", trace, t, t + 40),
        sp("io.pgm.read", "controller", trace, t + 1, t + 2),
        sp("rpc.client.call", "controller", trace, t + 2, t + 30, method="Operations.Run"),
        sp("rpc.encode", "controller", trace, t + 2, t + 2.5, method="Operations.Run"),
        sp("rpc.server.dispatch", "broker", trace, t + 3, t + 28, method="Operations.Run"),
        sp("rpc.decode", "broker", trace, t + 2.5, t + 3, method="Operations.Run"),
        sp("engine.encode", "broker", trace, t + 3, t + 4),
        sp("engine.chunk", "broker", trace, t + 4, t + 5, turns=1, sync=True),
        sp("engine.sync", "broker", trace, t + 5, t + 20),
        sp("engine.decode", "broker", trace, t + 26, t + 27),
        sp("rpc.encode", "broker", trace, t + 28, t + 29, method="Operations.Run"),
        sp("rpc.decode", "controller", trace, t + 29, t + 30, method="Operations.Run"),
        sp("controller.ticker_stop", "controller", trace, t + 30, t + 35),
        sp("controller.final_cells", "controller", trace, t + 35, t + 38),
        sp("io.pgm.write", "controller", trace, t + 38, t + 40),
        # a Retrieve's codec is not Run's
        sp("rpc.encode", "controller", trace, t + 10, t + 11, method="Operations.Retrieve"),
    ]


def records(dropped=0, extra=()):
    recs = session("a", 10) + session("b", 50) + list(extra)
    return {
        "window_ns": (10 * MS, 90 * MS),
        "spans": {"records": recs, "dropped": dropped},
        # the card's idle time: outside these gaps it was busy
        "trace": {"gaps": [(10 * MS, 15 * MS), (30 * MS, 55 * MS), (70 * MS, 90 * MS)]},
    }


READERS = [spans.final_cells_ms, spans.ticker_join_ms, spans.pgm_ms, spans.gc_ms,
           spans.codec_ms, spans.sync_ms, spans.board_io_ms, spans.idle_unspanned_pct]


def test_the_per_session_readings_sum_each_sessions_spans():
    r = records(extra=[
        # a collection inside final_cells, one between sessions, one of the broker's
        sp("runtime.gc", "controller", "a", 46, 47, generation=0, collected=3),
        sp("runtime.gc", "controller", "x", 49, 51, generation=2, collected=900),
        sp("runtime.gc", "broker", "y", 60, 61, generation=0, collected=0),
    ])
    assert spans.final_cells_ms(r) == pytest.approx(3.0)
    assert spans.ticker_join_ms(r) == pytest.approx(5.0)
    assert spans.pgm_ms(r) == pytest.approx(3.0)
    assert spans.codec_ms(r) == pytest.approx(0.5 + 0.5 + 1.0 + 1.0)
    assert spans.sync_ms(r) == pytest.approx(15.0)
    assert spans.board_io_ms(r) == pytest.approx(2.0)
    # the client's collections over the window, over its two sessions
    assert spans.gc_ms(r) == pytest.approx((1.0 + 2.0) / 2)


def test_a_session_outside_the_window_and_its_spans_do_not_count():
    r = records(extra=session("late", 85))  # ends after the window
    assert spans.sessions(r["spans"]["records"], *r["window_ns"]) == {"a", "b"}
    assert spans.final_cells_ms(r) == pytest.approx(3.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda f: f.__name__)
def test_every_reader_reads_nothing_where_a_ring_dropped_spans(reader):
    assert reader(records()) is not None
    assert reader(records(dropped=1)) is None
    assert reader({"window_ns": (0, 1), "trace": None}) is None
    assert reader({"window_ns": (0, 1), "spans": {"records": [], "dropped": 0},
                   "trace": None}) is None


def test_clip_cuts_spans_to_the_window_and_drops_the_empty():
    recs = [sp("a", "broker", "t", 0, 5), sp("b", "broker", "t", 4, 12),
            sp("c", "broker", "t", 12, 13)]
    got = [(s["name"], start / MS, end / MS) for s, start, end in spans.clip(recs, 2 * MS, 10 * MS)]
    assert got == [("a", 2, 5), ("b", 4, 10)]


def test_innermost_is_the_span_that_opened_last_on_that_process():
    recs = session("a", 10)
    assert spans.innermost(recs, "broker", 16 * MS)["name"] == "engine.sync"
    assert spans.innermost(recs, "controller", 16 * MS)["name"] == "rpc.client.call"
    assert spans.innermost(recs, "controller", 20.5 * MS)["name"] == "rpc.encode"
    assert spans.innermost(recs, "broker", 1 * MS) is None


def test_idle_unspanned_counts_idle_time_outside_every_host_phase():
    # the host phases (no wrappers) of a session at t cover [t+1, t+20],
    # [t+26, t+27] and [t+28, t+40]; of the 50 ms idle (gaps 10-15, 30-55,
    # 70-90) they cover 4 + (1 + 12 + 4) + (1 + 12) = 34 ms
    assert spans.idle_unspanned_pct(records()) == pytest.approx(100.0 * 16 / 50)


def test_describe_gaps_names_the_innermost_spans_and_a_lost_record():
    r = records()
    r["trace"]["gaps"].append((16 * MS, 19 * MS))  # inside session a's sync wait
    lines = spans.describe_gaps(r, n=4)
    assert len(lines) == 4
    assert lines[0].startswith("idle gap 25.000 ms")
    assert "controller.ticker_stop 5.000 ms" in lines[0]
    sync_line = next(line for line in lines if line.startswith("idle gap 3.000 ms"))
    assert "engine.sync 3.000 ms" in sync_line and "profiler lost" in sync_line
    assert not any("profiler lost" in line for line in lines if line is not sync_line)
    assert spans.describe_gaps(records(dropped=2)) == []


def test_gap_spans_splits_a_gap_between_its_innermost_spans():
    recs = session("a", 10)
    got = spans.gap_spans(recs, "controller", 44 * MS, 52 * MS)
    assert got == {"controller.ticker_stop": 1 * MS, "controller.final_cells": 3 * MS,
                   "io.pgm.write": 2 * MS, None: 2 * MS}
