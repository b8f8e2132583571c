"""The port's span tracer (gol_distributed_final_tpu_torch/obs/tracing.py)
on the CPU: spans on the profiler's clock, the ring's size and its count
of evictions, collections as spans, the RPC codec spans under the call
that owns them, and what a session pays with the tracer off or without an
export.
"""

import gc
import threading
import time

import pytest

from gol_distributed_final_tpu_torch import Params
from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
from gol_distributed_final_tpu_torch.engine.controller import InProcessBroker
from gol_distributed_final_tpu_torch.engine.controller import run as port_run
from gol_distributed_final_tpu_torch.obs import report as port_report
from gol_distributed_final_tpu_torch.obs import tracing
from gol_distributed_final_tpu_torch.rpc.client import RpcClient
from gol_distributed_final_tpu_torch.rpc.protocol import Request, Response
from gol_distributed_final_tpu_torch.rpc.server import RpcServer

from torch_obs_state import reset_both

TIMEOUT = 60


@pytest.fixture(autouse=True)
def clean_obs():
    reset_both()
    yield
    reset_both()
    tracing.tracer().set_capacity(tracing.DEFAULT_CAPACITY)


def _hooks(tracer):
    return [cb for cb in gc.callbacks if getattr(cb, "__self__", None) is tracer]


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_span_ends_lie_between_clock_readings_around_it():
    """A span's ends are ``time.time_ns()`` readings (the profiler's
    clock), and the Chrome fields derive from them."""
    tracing.enable()
    before = time.time_ns()
    span = tracing.start_span("controller.session")
    time.sleep(0.002)
    tracing.end_span(span)
    after = time.time_ns()
    (rec,) = _by_name(tracing.tracer().snapshot(), "controller.session")
    assert before <= rec["start_ns"] <= rec["end_ns"] <= after
    assert rec["end_ns"] - rec["start_ns"] >= 2_000_000
    assert rec["ts_us"] == rec["start_ns"] // 1000
    assert rec["dur_us"] == (rec["end_ns"] - rec["start_ns"]) // 1000


def test_add_span_keeps_its_times_and_parents_on_the_context_given():
    tracing.enable()
    with tracing.span("rpc.client.call") as call:
        with tracing.span("io.pgm.read"):
            # the thread's innermost span is not the parent: the context is
            tracing.add_span("rpc.decode", 10, 25, parent_ctx=call.ctx(), method="m")
    (rec,) = _by_name(tracing.tracer().snapshot(), "rpc.decode")
    assert (rec["start_ns"], rec["end_ns"], rec["dur_us"]) == (10, 25, 0)
    assert rec["trace_id"] == call.trace_id and rec["parent_id"] == call.span_id
    assert rec["args"] == {"method": "m"}
    tracing.add_span("rpc.decode", 30, 40)  # no context: a trace of its own
    root = _by_name(tracing.tracer().snapshot(), "rpc.decode")[-1]
    assert root["parent_id"] == "" and root["trace_id"] != call.trace_id


@pytest.mark.parametrize("capacity, spans", [(1, 1), (3, 10), (8, 5), (64, 200)])
def test_dropped_counts_what_the_ring_evicted(capacity, spans):
    tracer = tracing.Tracer(enabled=True, capacity=capacity)
    for i in range(spans):
        tracer.end_span(tracer.start_span("engine.chunk", turns=i))
    kept = tracer.snapshot()
    assert len(kept) == min(capacity, spans)
    assert tracer.dropped == max(0, spans - capacity)
    assert [r["args"]["turns"] for r in kept] == list(range(spans))[-capacity:]
    tracer.reset()
    assert tracer.dropped == 0 and tracer.snapshot() == []


def test_enable_sizes_the_ring_and_status_carries_dropped():
    gc.disable()  # a collection would be a span of its own
    try:
        tracing.enable(capacity=2)
        for _ in range(5):
            tracing.end_span(tracing.start_span("engine.sync"))
        assert len(tracing.tracer().snapshot()) == 2 and tracing.tracer().dropped == 3
        payload = port_report.status_payload(role="broker")
        assert len(payload["trace_spans"]) == 2 and payload["trace_dropped"] == 3
        tracing.enable(capacity=16)  # a new, empty ring
        assert tracing.tracer().dropped == 0 and tracing.tracer().snapshot() == []
    finally:
        gc.enable()
    with pytest.raises(ValueError):
        tracing.enable(capacity=0)


def test_the_gc_hook_is_registered_exactly_while_tracing_is_on():
    tracer = tracing.tracer()
    assert _hooks(tracer) == []
    tracing.enable()
    tracing.enable()
    assert len(_hooks(tracer)) == 1
    tracing.enable(False)
    assert _hooks(tracer) == []


def test_a_collection_is_a_span_under_the_collecting_threads_innermost_span():
    tracing.enable()
    with tracing.span("controller.session"):
        with tracing.span("controller.final_cells") as cells:
            gc.collect()
    spans = tracing.tracer().snapshot()
    (outer,) = _by_name(spans, "controller.final_cells")
    full = [s for s in _by_name(spans, "runtime.gc") if s["args"]["generation"] == 2]
    assert full, spans
    for rec in full:
        assert rec["parent_id"] == cells.span_id and rec["trace_id"] == cells.trace_id
        assert outer["start_ns"] <= rec["start_ns"] <= rec["end_ns"] <= outer["end_ns"]
        assert isinstance(rec["args"]["collected"], int)


def test_the_rpc_codec_spans_parent_on_the_call_that_owns_them():
    """Over a loopback server in this process: each side's encode and
    decode of one call, under the client's call span or the server's
    dispatch span, the reader thread's decode included."""
    server = RpcServer()
    server.register("Test.Echo", lambda req: Response(turns_completed=req.turns))
    server.serve_background()
    client = RpcClient(f"127.0.0.1:{server.port}")
    try:
        tracing.enable()
        with tracing.span("controller.session"):
            assert client.call("Test.Echo", Request(turns=7), timeout=TIMEOUT) \
                .turns_completed == 7
        deadline = time.monotonic() + TIMEOUT
        while len(_by_name(tracing.tracer().snapshot(), "rpc.encode")) < 2:
            assert time.monotonic() < deadline  # the server's reply span lands late
            time.sleep(0.01)
    finally:
        client.close()
        server.stop()
    spans = tracing.tracer().snapshot()
    (call,) = _by_name(spans, "rpc.client.call")
    (dispatch,) = _by_name(spans, "rpc.server.dispatch")
    encodes, decodes = _by_name(spans, "rpc.encode"), _by_name(spans, "rpc.decode")
    assert len(encodes) == len(decodes) == 2
    assert {s["trace_id"] for s in encodes + decodes} == {call["trace_id"]}
    assert {s["args"]["method"] for s in encodes + decodes} == {"Test.Echo"}
    assert sorted(s["parent_id"] for s in encodes) == sorted(
        [call["span_id"], dispatch["span_id"]])
    # both decodes parent on the client's call: the request's carries its
    # context, the reply's is the pending call's, read by the reader thread
    assert [s["parent_id"] for s in decodes] == [call["span_id"]] * 2
    assert len({s["tid"] for s in decodes}) == 2
    reply_decode = max(decodes, key=lambda s: s["start_ns"])
    assert reply_decode["tid"] != call["tid"]
    assert call["start_ns"] <= reply_decode["start_ns"] <= reply_decode["end_ns"] <= call["end_ns"]


class _CountingSpan(tracing.Span):
    __slots__ = ()
    made = 0

    def __init__(self, *args):
        type(self).made += 1
        super().__init__(*args)


class _SpyBroker(InProcessBroker):
    def __init__(self):
        super().__init__(Engine(EngineConfig(device="cpu")))
        self.status_calls = 0

    def status(self):
        self.status_calls += 1
        return {}


def _session(tmp_path, images_dir, **kwargs):
    return port_run(Params(turns=100, image_width=64, image_height=64),
                    images_dir=str(images_dir), out_dir=str(tmp_path), **kwargs)


def test_tracing_off_a_session_makes_no_span_and_registers_no_hook(
        tmp_path, images_dir, monkeypatch):
    monkeypatch.setattr(tracing, "Span", _CountingSpan)
    _CountingSpan.made = 0
    callbacks = list(gc.callbacks)
    broker = _SpyBroker()
    result = _session(tmp_path, images_dir, broker=broker)
    assert result.turns_completed == 100
    assert _CountingSpan.made == 0
    assert gc.callbacks == callbacks and tracing.tracer().snapshot() == []
    assert broker.status_calls == 0
    # the counter counts: the same session with the tracer on makes spans
    tracing.enable()
    _session(tmp_path, images_dir, broker=_SpyBroker())
    assert _CountingSpan.made > 0


def test_a_session_exports_and_calls_status_only_when_asked(tmp_path, images_dir):
    tracing.enable()
    trace = tmp_path / "trace_64x64x100.json"
    quiet = _SpyBroker()
    _session(tmp_path, images_dir, broker=quiet)
    assert quiet.status_calls == 0 and not trace.exists()
    names = {s["name"] for s in tracing.tracer().snapshot()}
    assert {"controller.session", "io.pgm.read", "io.pgm.write", "controller.final_cells",
            "controller.ticker_stop", "engine.encode", "engine.chunk",
            "engine.decode"} <= names
    loud = _SpyBroker()
    _session(tmp_path, images_dir, broker=loud, trace_export=True)
    assert loud.status_calls == 1 and trace.exists()


def test_spans_of_a_session_share_its_trace_across_threads(tmp_path, images_dir):
    """The engine's and the controller's spans of one in-process session
    are one trace, and each parents on the session span or on one of its
    descendants."""
    tracing.enable()
    _session(tmp_path, images_dir, broker=_SpyBroker())
    spans = [s for s in tracing.tracer().snapshot() if s["name"] != "runtime.gc"]
    (session,) = _by_name(spans, "controller.session")
    assert {s["trace_id"] for s in spans} == {session["trace_id"]}
    ids = {s["span_id"] for s in spans}
    assert all(s["parent_id"] in ids for s in spans if s is not session)
    assert threading.get_ident() in {s["tid"] for s in spans}
    assert all(s["start_ns"] <= s["end_ns"] for s in spans)
