"""The port's operator tools (gol_distributed_final_tpu_torch/obs/: regress,
perf's bench-file mode, history, flame, watch, doctor, fleet, canary,
loadgen, lint) against the JAX package's, on the CPU.

Each tool of the port is held against the JAX package's on the same
seeded inputs, with equality as the tolerance: the same bench rounds, the
same journals, the same profile dumps, the same Status payloads (from a
port broker and from a JAX broker), the same arrival schedules. The
canary and loadgen also run against port brokers on the CPU
(``device="cpu"``; their default is the card, and they raise without one).
"""

import io
import itertools
import json
import os
import queue
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from gol_distributed_final_tpu.obs import doctor as jax_doctor
from gol_distributed_final_tpu.obs import flame as jax_flame
from gol_distributed_final_tpu.obs import history as jax_history
from gol_distributed_final_tpu.obs import journal as jax_journal
from gol_distributed_final_tpu.obs import loadgen as jax_loadgen
from gol_distributed_final_tpu.obs import metrics as jax_metrics
from gol_distributed_final_tpu.obs import perf as jax_perf
from gol_distributed_final_tpu.obs import regress as jax_regress
from gol_distributed_final_tpu.obs import watch as jax_watch
from gol_distributed_final_tpu.obs.canary import _oracle_evolve as jax_oracle
from gol_distributed_final_tpu.obs.canary import canary_board as jax_canary_board
from gol_distributed_final_tpu_torch.obs import canary as port_canary
from gol_distributed_final_tpu_torch.obs import doctor as port_doctor
from gol_distributed_final_tpu_torch.obs import fleet as port_fleet
from gol_distributed_final_tpu_torch.obs import flame as port_flame
from gol_distributed_final_tpu_torch.obs import history as port_history
from gol_distributed_final_tpu_torch.obs import journal as port_journal
from gol_distributed_final_tpu_torch.obs import lint as port_lint
from gol_distributed_final_tpu_torch.obs import loadgen as port_loadgen
from gol_distributed_final_tpu_torch.obs import metrics as port_metrics
from gol_distributed_final_tpu_torch.obs import perf as port_perf
from gol_distributed_final_tpu_torch.obs import regress as port_regress
from gol_distributed_final_tpu_torch.obs import watch as port_watch
from gol_distributed_final_tpu_torch.obs.status import fetch_status, series_map
from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

from helpers import REPO_ROOT
from oracle import vector_step
from torch_obs_state import reset_both

SEED = 20261017
TIMEOUT = 120
BENCHES = sorted(REPO_ROOT.glob("BENCH_r0*.json"))


@pytest.fixture(autouse=True)
def clean_obs():
    reset_both()
    yield
    reset_both()


# -- regress and perf's bench-file mode ----------------------------------------


def test_every_bench_round_loads_alike():
    assert len(BENCHES) == 5
    for path in BENCHES:
        try:
            ref = jax_regress.load_bench(path)
        except jax_regress.BenchLoadError as exc:
            with pytest.raises(port_regress.BenchLoadError, match="no bench cases"):
                port_regress.load_bench(path)
            assert "no bench cases" in str(exc)
            continue
        assert port_regress.load_bench(path) == ref


@pytest.mark.parametrize("old, new", list(itertools.combinations(BENCHES[1:], 2)),
                         ids=lambda p: p.stem)
def test_regress_diffs_a_pair_of_rounds_verdict_for_verdict(old, new):
    port = port_regress.compare(port_regress.load_bench(old), port_regress.load_bench(new))
    ref = jax_regress.compare(jax_regress.load_bench(old), jax_regress.load_bench(new))
    assert port == ref
    assert port_regress.render_table(port) == jax_regress.render_table(ref)


@pytest.mark.parametrize("pair", [["BENCH_r04.json", "BENCH_r05.json"],
                                  ["BENCH_r02.json", "BENCH_r05.json"],
                                  ["BENCH_r01.json", "BENCH_r02.json"],
                                  ["--latest"]])
def test_regress_cli_prints_what_the_reference_prints(pair, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    outs = []
    for main in (port_regress.main, jax_regress.main):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            code = main(pair)
        outs.append((code, out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]


def _ceilings(module, source):
    return module.Ceilings(device_kind="tpu v5 lite", flops_per_s=1.5e13, bytes_per_s=8e11,
                           launch_seconds=5e-6, source=source)


@pytest.mark.parametrize("path", BENCHES[1:], ids=lambda p: p.stem)
@pytest.mark.parametrize("source", ["known", "fitted"])
def test_perf_bench_rows_equal_the_reference(path, source):
    port = port_perf.rows_from_bench(path, _ceilings(port_perf, source))
    ref = jax_perf.rows_from_bench(path, _ceilings(jax_perf, source))
    assert port == ref and port


def test_perf_bench_cli_refuses_an_unreadable_round_as_the_reference(capsys):
    codes = [main([str(BENCHES[0]), "--device-kind", "tpu v5 lite"])
             for main in (port_perf.main, jax_perf.main)]
    assert codes == [2, 2]
    err = capsys.readouterr().err
    assert err.count("no bench cases found") == 2


def test_perf_bench_cli_classifies_a_round(capsys):
    assert port_perf.main([str(BENCHES[-1]), "--device-kind", "tpu v5 lite", "-json"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    ref = jax_perf.rows_from_bench(BENCHES[-1], jax_perf.calibrate("tpu v5 lite"))
    assert rows == json.loads(json.dumps(ref)) and rows


# -- history --------------------------------------------------------------------


def _write_journals(root):
    """Two processes' segments: the port's journal as a broker, the JAX
    package's as a worker (each with a clock of its own node), their
    clocks crossing as RPC stamps cross, and a torn tail on the worker's
    segment. Both clocks read one fake wall clock."""
    rng = np.random.default_rng(SEED)
    wall = itertools.count(1_792_000_000.0, 0.002).__next__  # 2 ms a reading
    broker_clock = port_journal.HLC(node="broker-1", now=wall)
    worker_clock = jax_journal.HLC(node="w-2", now=wall)
    broker = port_journal.Journal(out_dir=root, role="broker", clock=broker_clock)
    worker = jax_journal.Journal(out_dir=root, role="worker", clock=worker_clock)
    try:
        for i in range(40):
            tenant = int(rng.integers(1, 5))
            broker.record("session.admit", str(i), turns=int(rng.integers(1, 99)),
                          tenant=tenant)
            if i % 3 == 0:
                worker_clock.merge(broker_clock.tick())
                worker.record("chunk.commit", f"127.0.0.1:{8030 + i % 2}",
                              turn=i, alive=int(rng.integers(0, 999)))
                broker_clock.merge(worker_clock.tick())
            if i % 7 == 0:
                broker.record("worker.lost", f"127.0.0.1:{8030 + i % 2}", error="eof")
            broker.record("session.final", str(i), tenant=tenant, turn=i)
    finally:
        broker.close()
        worker.close()
    with open(next(root.glob("journal_worker_*.jsonl")), "ab") as f:
        f.write(b'{"torn": ')


@pytest.mark.parametrize("filters", [
    {}, {"tenant": "2"}, {"address": "127.0.0.1:8031"}, {"tenant": "9"},
])
def test_history_merges_and_queries_the_same_journals(tmp_path, filters):
    _write_journals(tmp_path)
    port = port_history.build_history("t", out_dir=str(tmp_path), **filters)
    ref = jax_history.build_history("t", out_dir=str(tmp_path), **filters)
    port.pop("time_unix")
    ref.pop("time_unix")
    assert port == ref
    assert port_history.render(port, show=0) == jax_history.render(ref, show=0)
    if not filters:
        assert len(port["nodes"]) == 2 and port["problems"]
        assert port["by_kind"]["session.admit"] == 40


def test_history_window_bounds_and_live_duplicates(tmp_path):
    _write_journals(tmp_path)
    events, _ = port_journal.read_segments(tmp_path)
    mid = port_journal.hlc_key(events[len(events) // 2])[0]
    port = port_history.build_history("t", out_dir=str(tmp_path), since_ms=mid)
    ref = jax_history.build_history("t", out_dir=str(tmp_path), since_ms=mid)
    assert port["events"] == ref["events"] and 0 < port["events_total"] < len(events)
    assert port_history.merge_events(events, events[::-1]) == jax_history.merge_events(
        events, events[::-1])
    assert len(port_history.merge_events(events, events)) == len(events)


# -- flame ------------------------------------------------------------------------


def _dump(path, seed, frames):
    """A seeded collapsed-stack dump: threads, stacks of named frames, an
    idle wait among them, and a line no parser takes."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(60):
        depth = int(rng.integers(1, 6))
        stack = [frames[int(i)] for i in rng.integers(0, len(frames), depth)]
        lines.append(f"Thread-{int(rng.integers(0, 3))};" + ";".join(stack)
                     + f" {int(rng.integers(1, 50))}")
    lines.append("not a stack line")
    path.write_text("\n".join(lines) + "\n")
    return path


FRAMES = [
    "advance (gol_distributed_final_tpu_torch/engine/sessions.py:301)",
    "step_n (gol_distributed_final_tpu_torch/ops/batch_board.py:88)",
    "call (gol_distributed_final_tpu_torch/rpc/client.py:240)",
    "wait (threading.py:355)",
    "_drive (gol_distributed_final_tpu_torch/rpc/broker.py:2700)",
    "foreign frame",
]


@pytest.mark.parametrize("seeds", [(1, 2), (3, 4), (5, 5)])
def test_flame_folds_and_diffs_the_same_dumps(tmp_path, seeds):
    old = _dump(tmp_path / "old.collapsed", seeds[0], FRAMES)
    new = _dump(tmp_path / "new.collapsed", seeds[1], FRAMES[::-1])
    for active in (False, True):
        profiles = []
        for flame in (port_flame, jax_flame):
            a = flame.load_collapsed(old, source="old")
            b = flame.load_collapsed(new, source="new")
            merged = flame.merge_profiles([a, b])
            movers = flame.diff_profiles(a, b, noise_pp=0.5, active_only=active)
            profiles.append((a, b, merged, flame.hot_rows(merged, top=50, active_only=active),
                             movers, flame.render_table(merged, active_only=active),
                             flame.render_diff(movers, a, b)))
        assert profiles[0] == profiles[1]


def _speedscope(path, seed):
    """A seeded speedscope document: shared frames, two threads' profiles
    of sampled stacks with weights."""
    rng = np.random.default_rng(seed)
    frames = [{"name": f"f{i}", "file": f"mod{i % 3}.py", "line": 10 * i} for i in range(8)]
    frames.append({"name": "wait", "file": "threading.py", "line": 355})
    profiles = []
    for _ in range(2):
        samples = [[int(i) for i in rng.integers(0, len(frames), int(rng.integers(0, 5)))]
                   for _ in range(40)]
        profiles.append({"type": "sampled", "samples": samples,
                         "weights": [int(w) for w in rng.integers(1, 9, len(samples))]})
    path.write_text(json.dumps({"shared": {"frames": frames}, "profiles": profiles}))
    return path


@pytest.mark.parametrize("seed", [1, 2])
def test_flame_reads_the_same_speedscope_dump(tmp_path, seed):
    path = _speedscope(tmp_path / "p.speedscope.json", seed)
    port = port_flame.load_speedscope(path, source="s")
    assert port == jax_flame.load_speedscope(path, source="s") and port["total"] > 0
    assert port_flame.render_table(port, active_only=True) == jax_flame.render_table(
        port, active_only=True)


def test_flame_folds_a_dump_of_the_ports_profiler(tmp_path):
    from gol_distributed_final_tpu_torch.obs import profiler

    p = profiler.enable(period_ms=2.0, out_dir=str(tmp_path), tag="t")
    try:
        deadline = time.perf_counter() + 0.3
        while time.perf_counter() < deadline:
            sum(range(1000))
        p.stop()
        collapsed = p.write_artifacts(str(tmp_path), "t")[0]
    finally:
        profiler.disable()
    port = port_flame.load_collapsed(collapsed, source="s")
    assert port == jax_flame.load_collapsed(collapsed, source="s") and port["total"] > 0


def test_flame_selfcheck_samples_the_ports_profiler_in_a_child(capsys):
    assert "gol_distributed_final_tpu_torch.obs import profiler" in port_flame._SELFCHECK_CODE
    assert port_flame.selfcheck() == 0
    assert "flame selfcheck ok" in capsys.readouterr().out


# -- watch, doctor, fleet over live brokers --------------------------------------


class _Proc:
    def __init__(self, args, cwd):
        self.proc = subprocess.Popen(
            [sys.executable, *args], cwd=cwd, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def address(self) -> str:
        deadline = time.monotonic() + TIMEOUT
        seen = []
        while True:
            line = self.lines.get(timeout=max(0.01, deadline - time.monotonic()))
            if line is None:
                raise RuntimeError("".join(seen))
            seen.append(line)
            if "broker listening on :" in line:
                return f"127.0.0.1:{int(line.rsplit(':', 1)[1].split()[0])}"

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=TIMEOUT)


def _sessions(addr, n=4, size=32):
    rng = np.random.default_rng(SEED)
    boards = [np.where(rng.random((size, size)) < 0.3, 255, 0).astype(np.uint8)
              for _ in range(n)]
    from gol_distributed_final_tpu_torch import Params

    for i, board in enumerate(boards):
        rb = RemoteBroker(addr)
        try:
            res = rb.session_run(Params(turns=5 + i, image_width=size, image_height=size),
                                 board, session_id=(7 << 32) | (i + 1))
        finally:
            rb.close()
        want = board
        for _ in range(5 + i):
            want = vector_step(want)
        assert np.array_equal(res.world != 0, want != 0)


@pytest.fixture(scope="module")
def brokers(tmp_path_factory):
    """A port broker on the CPU with every flag, and a JAX broker, each
    in a process of its own, each after a few tagged SessionRuns."""
    work = tmp_path_factory.mktemp("brokers")
    port = _Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker", "-port", "0",
                  "-device", "cpu", "-metrics", "-timeline", "0.2", "-trace", "-journal",
                  str(work / "journal"), "-profile", "-session-capacity", "16"], work)
    ref = _Proc(["-m", "gol_distributed_final_tpu.rpc.broker", "-port", "0", "-metrics",
                 "-timeline", "0.2", "-session-capacity", "16"], work)
    addrs = {}
    try:
        addrs.update(port=port.address(), jax=ref.address())
        for addr in addrs.values():
            _sessions(addr)
        time.sleep(0.5)  # two sampler ticks after the traffic
        yield addrs
    finally:
        for addr in addrs.values():
            RemoteBroker(addr).super_quit()
        for proc in (port, ref):
            proc.stop()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_watch_renders_a_status_payload_as_the_reference(brokers, which, monkeypatch):
    payload = fetch_status(brokers[which], timeout=30)
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    port = port_watch.render_status(f"{which} broker", payload, turns_rate=12.5)
    assert port == jax_watch.render_status(f"{which} broker", payload, turns_rate=12.5)
    assert "SESSIONS (multi-universe)" in port and "DISABLED" not in port


@pytest.mark.parametrize("which", ["port", "jax"])
def test_doctor_diagnoses_a_status_payload_as_the_reference(brokers, which, monkeypatch):
    statuses = port_doctor.collect(brokers[which], [], timeout=30)
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-10-17 00:00:00")
    findings = port_doctor.diagnose(statuses)
    # the hotspot hint names each package's own flame CLI
    ref = json.loads(json.dumps(jax_doctor.diagnose(statuses)).replace(
        "gol_distributed_final_tpu.obs.flame", "gol_distributed_final_tpu_torch.obs.flame"))
    assert findings == ref and findings
    assert port_doctor.render(findings, statuses) == jax_doctor.render(findings, statuses)


def test_watcher_frame_at_a_port_broker(brokers, monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-10-17 00:00:00")
    frame, ok = port_watch.Watcher(brokers["port"], [], timeout=30).frame()
    assert ok and "SESSIONS (multi-universe)" in frame and "TENANTS" in frame


def test_fleet_composite_is_the_exact_merge_of_its_targets(brokers):
    """The port's collector over both brokers: its composite's data-plane
    families are the JAX package's exact merge of the scraped payloads,
    and the JAX collector merges the same payloads to the same snapshot."""
    port_metrics.enable()
    collector = port_fleet.FleetCollector([brokers["port"], brokers["jax"]], interval=0.5,
                                          timeout=30.0)
    collector.sweep()
    scraped = collector.status_payload()["fleet"]["broker_status"]
    assert set(scraped) == set(brokers.values())
    want = {"schema": "gol-metrics/1", "families": []}
    for addr in sorted(scraped):
        want = jax_metrics.merge_snapshots(want, scraped[addr]["metrics"])
    data = [f for f in collector.composite_snapshot()["families"]
            if not f["name"].startswith("gol_fleet_")]
    assert data == [f for f in want["families"] if not f["name"].startswith("gol_fleet_")]
    from gol_distributed_final_tpu.obs import fleet as jax_fleet

    ref = jax_fleet.FleetCollector(list(scraped), interval=0.5, timeout=30.0)
    ref._merge(scraped)
    collector._merge(scraped)
    assert collector._merged == ref._merged
    admitted = series_map(collector._merged, "gol_sessions_admitted_total")[()]["value"]
    assert admitted == sum(series_map(p["metrics"], "gol_sessions_admitted_total")[()]["value"]
                           for p in scraped.values())


def test_fleet_selfcheck_on_the_cpu(capsys):
    assert port_fleet._selfcheck("cpu") == 0
    assert "fleet selfcheck ok" in capsys.readouterr().out


def test_doctor_selfcheck_on_the_cpu(tmp_path, capsys):
    assert port_doctor.main(["--selfcheck", "-device", "cpu", "-out", str(tmp_path)]) == 0
    assert "doctor selfcheck ok" in capsys.readouterr().out


# -- canary -------------------------------------------------------------------------


@pytest.mark.parametrize("size, seed, round_no", [(16, 0, 1), (32, 7, 3), (64, 123, 9)])
def test_canary_board_and_oracle_equal_the_reference(size, seed, round_no):
    board = port_canary.canary_board(size, seed, round_no)
    assert np.array_equal(board, jax_canary_board(size, seed, round_no))
    port, ref = port_canary._oracle_evolve(board, 16), jax_oracle(board, 16)
    assert np.array_equal(port[0], ref[0]) and port[1] == ref[1]
    want = board
    for _ in range(16):
        want = vector_step(want)
    assert np.array_equal(port[0] != 0, want != 0)


@pytest.mark.parametrize("verb", ["session", "run"])
def test_canary_probe_of_each_verb_on_a_cpu_broker(verb):
    from gol_distributed_final_tpu_torch.rpc.broker import serve

    port_metrics.enable()
    server, service = serve(port=0, device="cpu")
    prober = port_canary.CanaryProber(f"127.0.0.1:{server.port}", size=32, turns=16,
                                      verb=verb)
    try:
        outs = [prober.probe_once() for _ in range(3)]
    finally:
        prober.stop()
        service.shutdown()
    assert [o["result"] for o in outs] == ["ok"] * 3, outs
    snap = port_metrics.registry().snapshot()
    assert series_map(snap, "gol_canary_probes_total")[("ok",)]["value"] == 3
    assert series_map(snap, "gol_canary_latency_seconds")[()]["count"] == 3


def test_canary_reports_an_injected_wrong_board(monkeypatch):
    """A worker's strip corrupted in place with integrity off: the Run
    verb's board diverges from the oracle, the probe is corrupt, and the
    canary-failure rule fires on the next tick (the JAX package's
    scenario, on the port's roles)."""
    from gol_distributed_final_tpu_torch.obs import slo, timeline
    from gol_distributed_final_tpu_torch.rpc import faults, integrity
    from gol_distributed_final_tpu_torch.rpc import worker as rpc_worker
    from gol_distributed_final_tpu_torch.rpc.broker import serve

    board = port_canary.canary_board(16, 0, 1)
    want, _ = port_canary._oracle_evolve(board, 16)

    def flip_matters(i):
        flipped = board.copy()
        flipped.reshape(-1)[i] ^= 0xFF
        return not np.array_equal(port_canary._oracle_evolve(flipped, 16)[0], want)

    idx = next(i for i in range(board.size) if flip_matters(i))
    port_metrics.enable()
    wserver, _ = rpc_worker.serve(port=0, device="cpu")
    server, service = serve(port=0, backend="workers", wire="resident", device="cpu",
                            worker_addresses=[f"127.0.0.1:{wserver.port}"])
    integrity.set_enabled(False)
    faults.configure(f"worker.strip_corrupt:corrupt:1:{idx}")
    tl = timeline.enable(period=60.0, start_thread=False, rules=[])
    prober = port_canary.CanaryProber(f"127.0.0.1:{server.port}", size=16, turns=16,
                                      verb="run")
    try:
        tl.sample_once()
        out = prober.probe_once()
        tl.sample_once()
        rule = next(r for r in slo.default_rules() if r.name == "canary-failure")
        firing, value, detail = rule.evaluate(tl)
    finally:
        timeline.disable()
        faults.configure(None)
        integrity.set_enabled(True)
        prober.stop()
        service.shutdown()
        wserver.stop()
    assert out["result"] == "corrupt" and "diverges from the oracle" in out["detail"], out
    assert firing and value == 1, detail
    probes = series_map(port_metrics.registry().snapshot(), "gol_canary_probes_total")
    assert probes[("corrupt",)]["value"] == 1


def test_canary_selfcheck_on_the_cpu_and_the_card_by_default(monkeypatch, capsys):
    import torch

    assert port_canary.main(["--selfcheck", "-device", "cpu"]) == 0
    assert "canary selfcheck ok" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_canary.main(["--selfcheck"])


def test_broker_canary_flag_probes_its_own_port(tmp_path):
    """``-canary 0.3 -timeline 0.2 -metrics``: the broker probes itself,
    the ok count grows and canary-failure stays ok."""
    proc = _Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker", "-port", "0",
                  "-device", "cpu", "-canary", "0.3", "-canary-verb", "session",
                  "-timeline", "0.2", "-metrics"], tmp_path)
    try:
        addr = proc.address()
        deadline = time.monotonic() + TIMEOUT
        while True:
            payload = fetch_status(addr, timeout=30)
            probes = series_map(payload["metrics"], "gol_canary_probes_total")
            if (probes.get(("ok",)) or {}).get("value", 0) >= 3:
                break
            assert time.monotonic() < deadline, probes
            time.sleep(0.2)
        assert {k for k, v in probes.items() if v["value"]} == {("ok",)}
        rule = {a["rule"]: a for a in payload["alerts"]}["canary-failure"]
        assert rule["state"] == "ok"
        RemoteBroker(addr).super_quit()
        assert proc.proc.wait(timeout=TIMEOUT) == 0
    finally:
        proc.stop()


# -- loadgen ------------------------------------------------------------------------


@pytest.mark.parametrize("arrival", ["poisson", "burst"])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("seed", [0, 3, 977])
def test_loadgen_schedule_equals_the_reference(arrival, dist, seed):
    kw = dict(rate=200.0, sessions=300, arrival=arrival, burst=32, tenants=30,
              tenant_dist=dist, size=16, turns=8, seed=seed)
    port = port_loadgen.LoadGenerator(":1", port_loadgen.LoadConfig(**kw))
    ref = jax_loadgen.LoadGenerator(":1", jax_loadgen.LoadConfig(**kw))
    assert port._schedule() == ref._schedule()
    assert port._tenants_for() == ref._tenants_for()
    for i in (0, 1, 299):
        assert np.array_equal(port.board_for(i), ref._board_for(i))


def test_loadgen_boards_reach_the_oracle_through_on_reply():
    from gol_distributed_final_tpu_torch.rpc.broker import serve

    port_metrics.enable()
    server, service = serve(port=0, session_capacity=64, device="cpu")
    finals = {}
    cfg = port_loadgen.LoadConfig(rate=400.0, sessions=24, arrival="burst", burst=8,
                                  tenants=5, tenant_dist="zipf", size=16, turns=9, seed=5)
    gen = port_loadgen.LoadGenerator(f"127.0.0.1:{server.port}", cfg,
                                     on_reply=lambda i, res: finals.__setitem__(i, res.world))
    try:
        summary = gen.run()
    finally:
        service.shutdown()
    assert summary["completed"] == 24 == len(finals) and not summary["errors"]
    for i, world in finals.items():
        want = gen.board_for(i)
        for _ in range(9):
            want = vector_step(want)
        assert np.array_equal(world != 0, want != 0)


def test_loadgen_selfcheck_reconciles_on_a_cpu_broker(capsys):
    assert port_loadgen.main(["--selfcheck", "-device", "cpu"]) == 0
    assert "ledger reconciles" in capsys.readouterr().out


# -- lint ------------------------------------------------------------------------------


@pytest.mark.parametrize("check_id", [c[0] for c in port_lint.CHECKS])
def test_lint_passes_on_the_repo_readme(check_id):
    check = {c[0]: c[1] for c in port_lint.CHECKS}[check_id]
    assert check() == []


def test_lint_cli_passes(capsys):
    assert port_lint.main() == 0
    assert capsys.readouterr().err == ""
