"""The port's observability layer (gol_distributed_final_tpu_torch/obs/)
held against the JAX package's on the CPU: the series catalog, a 64^2 x
100 session with -metrics -report -trace through both CLIs, the device
telemetry's pure functions (CUDA events through a test double), the
roofline classifier, and what metrics off leaves behind.
"""

import json
import os

import numpy as np
import pytest
import torch

from gol_distributed_final_tpu import __main__ as jax_main
from gol_distributed_final_tpu.obs import instruments as jax_ins
from gol_distributed_final_tpu.obs import journal as jax_journal
from gol_distributed_final_tpu.obs import metrics as jax_metrics
from gol_distributed_final_tpu.obs import perf as jax_perf
from gol_distributed_final_tpu_torch import __main__ as port_main
from gol_distributed_final_tpu_torch.obs import device as port_device
from gol_distributed_final_tpu_torch.obs import instruments as port_ins
from gol_distributed_final_tpu_torch.obs import journal as port_journal
from gol_distributed_final_tpu_torch.obs import metrics as port_metrics
from gol_distributed_final_tpu_torch.obs import perf as port_perf
from gol_distributed_final_tpu_torch.ops import whole_board

from torch_obs_state import reset_both

SEED = 20261017


@pytest.fixture(autouse=True)
def clean_obs():
    reset_both()
    yield
    reset_both()


# -- the series catalog -------------------------------------------------------


def _catalog(instruments):
    """The series an ``obs/instruments.py`` declares, its fleet
    collector's too (registered on that module's first import, which an
    earlier test in this process may or may not have made)."""
    instruments.register_fleet_instruments()
    return {
        fam.name: (fam.kind, fam.help, tuple(fam.labelnames), fam.edges)
        for fam in vars(instruments).values()
        if type(fam).__name__ == "_Family"
    }


#: series the port declares and the JAX package does not: the ticker's
#: wake-ups, since its thread waits on stop instead of polling
_PORT_SERIES = {"gol_controller_ticker_wakeups_total"}


def test_series_catalog_equals_the_reference():
    """Every series the JAX package declares is the port's: name, type,
    help text, label names and buckets — the contract its watch, doctor
    and lint read. The port's own are ``_PORT_SERIES``."""
    port = _catalog(port_ins)
    ref = _catalog(jax_ins)
    assert len(port) > 80
    assert set(port) - set(ref) == _PORT_SERIES
    assert {name: fam for name, fam in port.items() if name in ref} == ref
    registered = {fam.name for fam in port_metrics.registry().families()}
    assert set(port) <= registered


# -- a 64^2 x 100 session through both CLIs ------------------------------------


def _session(main, root, tmp_path, images_dir, flags, journal_mod=None):
    """Run the 64^2 x 100 controller CLI in ``tmp_path/root``; returns
    (PGM bytes, report or None, trace spans or None, journal kinds)."""
    work = tmp_path / root
    work.mkdir()
    (work / "images").symlink_to(images_dir)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        if journal_mod is not None:
            journal_mod.enable(out_dir=str(work / "journal"), role="controller")
        main(["-w", "64", "-h", "64", "-turns", "100", "-noVis", *flags])
        kinds = []
        if journal_mod is not None:
            journal_mod.disable()
            records, problems = journal_mod.read_segments(work / "journal")
            assert problems == []
            kinds = [r["kind"] for r in records]
    finally:
        os.chdir(cwd)
        reset_both()
    out = work / "out"
    report = out / "report_64x64x100.json"
    trace = out / "trace_64x64x100.json"
    return (
        (out / "64x64x100.pgm").read_bytes(),
        json.loads(report.read_text()) if report.exists() else None,
        json.loads(trace.read_text()) if trace.exists() else None,
        kinds,
    )


def _series(report, name):
    for fam in report["metrics"]["families"]:
        if fam["name"] == name:
            return {tuple(s["labels"]): s for s in fam["series"]}
    return {}


#: spans whose presence depends on the clock: the 2 s tick's
_CLOCK_SPANS = {"controller.tick"}

#: the port's host-phase spans of an in-process session on the CPU, which
#: the JAX package does not have (no engine.sync: the CPU runs in step)
_HOST_PHASE_SPANS = {"io.pgm.read", "io.pgm.write", "controller.final_cells",
                     "controller.ticker_stop", "engine.encode", "engine.decode"}


def _span_shape(trace):
    """The set of span names and of (parent name, child name) edges in a
    Chrome trace written by obs/tracing.write_chrome_trace, the clock's
    spans left out."""
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"] not in _CLOCK_SPANS]
    by_id = {e["args"]["span_id"]: e["name"] for e in spans}
    names = {e["name"] for e in spans}
    edges = {
        (by_id[e["args"]["parent_id"]], e["name"])
        for e in spans if e["args"].get("parent_id") in by_id
    }
    return names, edges


def test_session_with_metrics_report_trace_matches_the_reference(tmp_path, images_dir,
                                                                 check_dir):
    """-metrics -report -trace on both CLIs: the report's keys, the turns
    the engine counted, the clock-independent event counts, the span names
    and their parent edges, and the journal's record kinds in order are
    the JAX package's; the PGM is byte-equal to the run without flags and
    to the golden file."""
    flags = ["-metrics", "-report", "-trace"]
    plain, _, _, _ = _session(port_main.main, "plain", tmp_path, images_dir,
                              ["-device", "cpu"])
    port_pgm, port_rep, port_trace, port_kinds = _session(
        port_main.main, "port", tmp_path, images_dir, ["-device", "cpu", *flags],
        port_journal)
    ref_pgm, ref_rep, ref_trace, ref_kinds = _session(
        jax_main.main, "ref", tmp_path, images_dir, flags, jax_journal)

    golden = (check_dir / "images" / "64x64x100.pgm").read_bytes()
    assert port_pgm == plain == golden == ref_pgm

    assert sorted(port_rep) == sorted(ref_rep)
    assert port_rep["devices"]["local_devices"][0]["platform"] == "cpu"
    turns = _series(port_rep, "gol_engine_turns_total")[()]["value"]
    assert turns == _series(ref_rep, "gol_engine_turns_total")[()]["value"] == 100
    steps = _series(port_rep, "gol_engine_step_seconds")[()]["count"]
    assert steps == _series(ref_rep, "gol_engine_step_seconds")[()]["count"] == 100

    def events(rep):
        # AliveCellsCount rides the 2 s tick: its count depends on the clock
        return {k: s["value"] for k, s in _series(rep, "gol_controller_events_total").items()
                if k != ("AliveCellsCount",)}

    assert events(port_rep) == events(ref_rep)
    assert events(port_rep)[("FinalTurnComplete",)] == 1

    # the reference's spans and edges are the port's; the port's extra
    # names are its host-phase spans on this path (a collection's span
    # appears only where a collection ran)
    port_names, port_edges = _span_shape(port_trace)
    ref_names, ref_edges = _span_shape(ref_trace)
    assert ref_names <= port_names
    assert ref_edges <= port_edges
    assert port_names - ref_names - {"runtime.gc"} == _HOST_PHASE_SPANS
    assert ("controller.session", "engine.chunk") in port_edges
    assert {("controller.session", "io.pgm.read"), ("controller.session", "io.pgm.write"),
            ("controller.session", "controller.final_cells"),
            ("controller.session", "controller.ticker_stop"),
            ("controller.session", "engine.encode"),
            ("controller.session", "engine.decode")} <= port_edges

    # how many chunks the engine cut 100 turns into depends on the clock
    # (growth stops at the first chunk slower than its target, a JAX
    # compile among them): repeats collapse to one
    def runs(kinds):
        return [k for i, k in enumerate(kinds) if i == 0 or kinds[i - 1] != k]

    assert runs(port_kinds) == runs(ref_kinds) == ["run.start", "chunk.commit", "run.end"]

    # the kernel site the 64^2 auto plane (FusedBitPlane, K1's plain
    # version here) reports under, with the bound's counts
    sites = _series(port_rep, "gol_kernel_dispatch_seconds")
    assert ("pallas.fused_bit",) in sites


# -- device telemetry: the pure functions --------------------------------------


class _FakeEvent:
    """A CUDA event double: records nothing, completes when the test says,
    and reports the elapsed time the test chose. Counts creations,
    queries, waits and elapsed_time calls."""

    made = 0
    synchronized = 0
    elapsed_calls = 0
    queries = 0
    done = True
    times = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.ms = None

    def record(self, stream=None):
        if type(self).times:
            self.ms = type(self).times.pop(0)

    def query(self):
        type(self).queries += 1
        return type(self).done

    def synchronize(self):
        type(self).synchronized += 1

    def elapsed_time(self, end):
        assert type(self).done, "elapsed_time on an event not complete"
        type(self).elapsed_calls += 1
        return end.ms - self.ms


@pytest.fixture
def fake_cuda(monkeypatch):
    class Event(_FakeEvent):
        made = synchronized = elapsed_calls = queries = 0
        done = True
        times = []

    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    stream = type("Stream", (), {"device_index": 0})()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    Event.syncs = syncs
    return Event


def test_sample_hbm_is_empty_on_the_cpu_and_caches_it(monkeypatch):
    calls = []
    real = torch.cuda.is_available
    monkeypatch.setattr(torch.cuda, "is_available", lambda: calls.append(1) or real())
    assert port_device.sample_hbm() == {}
    assert port_device.sample_hbm() == {}
    assert len(calls) == 1  # discovered once, then a cached early return
    assert port_device.hbm_peak_observed() == {}


def test_sample_hbm_sets_the_gauges_from_device_stats():
    port_metrics.enable()

    class Dev:
        def __init__(self, i, used, peak):
            self.id, self.stats = i, {"bytes_in_use": used, "peak_bytes_in_use": peak,
                                      "bytes_limit": 80 << 30}

        def memory_stats(self):
            return self.stats

    out = port_device.sample_hbm([Dev(0, 100, 300), Dev(1, 50, 60)])
    assert out["0"] == {"bytes_in_use": 100, "peak_bytes_in_use": 300,
                        "bytes_limit": 80 << 30}
    assert port_device.hbm_peak_observed() == {"0": 300, "1": 60}


def test_dispatch_stats_add_up_exactly_from_event_pairs(fake_cuda):
    """Known device times through the CUDA path of the hook: the sums are
    exact, every pair is resolved only once complete, and nothing waits
    on the card."""
    port_metrics.enable()
    dev = torch.device("cuda", 0)
    times_ms = [(0.0, 1.5), (2.0, 2.25), (3.0, 3.125)]
    for start, end in times_ms:
        fake_cuda.times = [start, end]
        t = port_device.begin(dev)
        port_device.end("pallas.fused_bit", dev, t, 1000.0, 64.0)
    stats = port_device.dispatch_stats()["pallas.fused_bit"]
    assert stats == {"flops": 3000.0, "bytes_accessed": 192.0,
                     "wall_s": (1.5 + 0.25 + 0.125) / 1e3, "calls": 3}
    assert fake_cuda.made == 6 and fake_cuda.synchronized == 0
    assert fake_cuda.syncs == []
    # one stream runs in order: the newest pair's completion vouches for
    # the older ones, so the fold queried one event, not three
    assert fake_cuda.queries == 1 and fake_cuda.elapsed_calls == 3
    hist = port_metrics.registry().snapshot()
    fam = next(f for f in hist["families"] if f["name"] == "gol_kernel_dispatch_seconds")
    assert fam["series"][0]["count"] == 3


def test_pending_pairs_wait_for_their_end_event(fake_cuda):
    """A pair whose end event has not completed is neither timed nor
    waited for: a Status poll's resolve() only queries."""
    port_metrics.enable()
    dev = torch.device("cuda", 0)
    fake_cuda.done = False
    fake_cuda.times = [0.0, 4.0]
    port_device.end("pallas.tiled", dev, port_device.begin(dev), 10.0, 8.0)
    assert port_device.resolve() == 0
    assert port_device.pending_launches() == 1
    assert fake_cuda.elapsed_calls == 0 and fake_cuda.synchronized == 0
    fake_cuda.done = True
    assert port_device.resolve() == 1
    assert port_device.dispatch_stats()["pallas.tiled"]["wall_s"] == 4.0 / 1e3


def test_engine_chunks_fold_device_time_once_every_card_is_done(fake_cuda):
    """A chunk's device_compute is its slowest card's time between the
    event before its launches and the fence after them, observed by
    resolve() once both fences completed, oldest chunk first, and never
    waited for."""
    port_metrics.enable()
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]

    def chunk(times):
        fake_cuda.times = [t for t, _ in times]
        starts = port_device.chunk_begin(cards)
        fake_cuda.times = [t for _, t in times]
        stops = []
        for _ in cards:
            stops.append(torch.cuda.Event(enable_timing=True))
            stops[-1].record()
        port_device.chunk_end(starts, stops)

    fake_cuda.done = False
    chunk([(0.0, 2.0), (0.0, 3.5)])
    chunk([(4.0, 4.5), (4.0, 4.25)])
    def device_compute():
        snap = {"metrics": port_metrics.registry().snapshot()}
        return _series(snap, "gol_turn_segment_seconds").get(
            ("engine", "device_compute"), {"count": 0, "sum": 0.0})

    assert port_device.resolve() == 0
    assert device_compute()["count"] == 0
    fake_cuda.done = True
    port_device.resolve()
    assert device_compute()["count"] == 2
    assert device_compute()["sum"] == pytest.approx((3.5 + 0.5) / 1e3)
    assert fake_cuda.synchronized == 0 and fake_cuda.syncs == []
    port_device.resolve()  # folded once
    assert device_compute()["count"] == 2


def test_metrics_off_creates_no_event(fake_cuda, tmp_path, images_dir):
    """With metrics off a launch pays one flag check: no event, no
    series, no dispatch stats — here through the hook and a whole CPU
    session."""
    assert port_device.begin(torch.device("cuda", 0)) is None
    assert fake_cuda.made == 0
    rng = np.random.default_rng(SEED)
    board = torch.from_numpy(rng.integers(0, 2**31, (4, 64), dtype=np.int64).astype(np.int32))
    whole_board.step_n(board, 5, counted=True)
    pgm, _, _, _ = _session(port_main.main, "off", tmp_path, images_dir, ["-device", "cpu"])
    assert pgm
    assert fake_cuda.made == 0
    assert port_device.dispatch_stats() == {}
    snap = port_metrics.registry().snapshot()
    for fam in snap["families"]:
        for s in fam["series"]:
            assert not s.get("value") and not s.get("count"), fam["name"]


# -- the roofline classifier ---------------------------------------------------


def test_h100_known_ceilings_are_perf_md_figures():
    ceil = port_perf.calibrate("NVIDIA H100 80GB HBM3")
    assert (ceil.flops_per_s, ceil.bytes_per_s, ceil.source) == (1.673e13, 3.35e12, "known")
    assert port_perf.calibrate("nvidia h100 80gb hbm3") is ceil


@pytest.mark.parametrize("kind", ["TPU v5 lite", "tpu v4"])
def test_tpu_kinds_keep_the_reference_table(kind):
    a, b = port_perf.calibrate(kind), jax_perf.calibrate(kind)
    assert (a.flops_per_s, a.bytes_per_s, a.source) == (b.flops_per_s, b.bytes_per_s, b.source)


@pytest.mark.parametrize("flops,nbytes", [(1.6e13, 1e9), (1e9, 3e12), (1e8, 1e8), (0.0, 0.0)])
def test_classify_equals_the_reference(flops, nbytes):
    kw = dict(device_kind="x", flops_per_s=1.673e13, bytes_per_s=3.35e12,
              launch_seconds=1e-5, source="known")
    assert port_perf.classify(flops, nbytes, port_perf.Ceilings(**kw)) == \
        jax_perf.classify(flops, nbytes, jax_perf.Ceilings(**kw))


def _segment_snapshot(metrics_mod):
    from importlib import import_module

    ins = import_module(metrics_mod.__name__.replace(".metrics", ".instruments"))
    metrics_mod.enable()
    rng = np.random.default_rng(SEED)
    for comp in ("engine", "sessions", "broker"):
        for seg in ("host_prep", "device_compute", "wire", "demux"):
            for v in rng.random(5):
                ins.TURN_SEGMENT_SECONDS.labels(comp, seg).observe(float(v))
    return metrics_mod.registry().snapshot()


def test_decomposition_summary_equals_the_reference():
    port_snap = _segment_snapshot(port_metrics)
    ref_snap = _segment_snapshot(jax_metrics)
    assert port_perf.decomposition_summary(port_snap) == jax_perf.decomposition_summary(ref_snap)
    assert port_perf.decomposition_summary(ref_snap) == jax_perf.decomposition_summary(ref_snap)


def test_refresh_metrics_equals_the_reference():
    """The same per-site totals and ceilings classify alike, and the
    achieved and bound gauges land the same."""
    kw = dict(device_kind="nvidia h100", flops_per_s=1.673e13, bytes_per_s=3.35e12,
              launch_seconds=1e-5, source="known")
    totals = {"pallas.fused_bit": (5.0e10, 2.0e7, 0.01, 14),
              "pallas.fused_byte": (2.0e8, 4.0e9, 0.004, 1253)}
    port_metrics.enable()
    jax_metrics.enable()
    for site, (f, b, s, n) in totals.items():
        port_device._DISPATCH_STATS[site] = [f, b, s, n]
    from gol_distributed_final_tpu.obs import device as jax_device

    for site, (f, b, s, n) in totals.items():
        jax_device._DISPATCH_STATS[site] = [f, b, s, n]
    port_rows = port_perf.refresh_metrics(port_perf.Ceilings(**kw))
    ref_rows = jax_perf.refresh_metrics(jax_perf.Ceilings(**kw))
    assert port_rows == ref_rows
    assert {r["site"] for r in port_rows} == set(totals)

    def gauges(metrics_mod):
        snap = metrics_mod.registry().snapshot()
        return {f["name"]: f["series"] for f in snap["families"]
                if f["name"].startswith(("gol_kernel_achieved", "gol_kernel_bound"))}

    assert gauges(port_metrics) == gauges(jax_metrics)


def test_perf_selfcheck_classifies_the_cpu_sites(capsys):
    assert port_perf.main(["--selfcheck"]) == 0
    assert "perf selfcheck ok" in capsys.readouterr().out


def test_device_trace_writes_a_chrome_trace_with_the_span_ranges(tmp_path):
    """utils/trace.trace is torch.profiler's trace into ``log_dir``; under
    obs/tracing.device_trace, annotate() pushes record_function ranges
    that land in it by name, and outside it annotate() is one shared
    no-op context."""
    from gol_distributed_final_tpu_torch.obs import tracing

    assert tracing.annotate("engine.chunk") is tracing.annotate("other")
    with tracing.device_trace(tmp_path / "dev") as log_dir:
        assert tracing.device_trace_active()
        with tracing.annotate("engine.chunk"):
            whole_board.step_n(torch.zeros((4, 64), dtype=torch.int32), 3)
    assert not tracing.device_trace_active()
    files = list(log_dir.glob("torch_trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "engine.chunk" in names


def test_trace_stops_the_profiler_when_the_body_raises(tmp_path):
    from gol_distributed_final_tpu_torch.utils.trace import trace

    with pytest.raises(ZeroDivisionError):
        with trace(tmp_path / "a"):
            1 / 0
    with trace(tmp_path / "b"):  # a second trace starts: the first stopped
        torch.ones(3).sum()
    assert list((tmp_path / "b").glob("torch_trace_*.json"))
