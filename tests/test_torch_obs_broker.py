"""A port broker's ``Status`` verb read by the JAX package's tools, and the
reverse: a broker process of each package with its observability flags
on, polled by the other package's ``obs.status``; the JAX package's
``watch`` and ``doctor`` render and diagnose the port broker's payload;
and a traced port session over a port broker is one trace across both
processes.
"""

import json
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from gol_distributed_final_tpu.obs import doctor as jax_doctor
from gol_distributed_final_tpu.obs import status as jax_status
from gol_distributed_final_tpu.obs import watch as jax_watch
from gol_distributed_final_tpu_torch import Params
from gol_distributed_final_tpu_torch.engine.controller import run as port_run
from gol_distributed_final_tpu_torch.obs import flight as port_flight
from gol_distributed_final_tpu_torch.obs.metrics import snapshot_to_prometheus
from gol_distributed_final_tpu_torch.obs import status as port_status
from gol_distributed_final_tpu_torch.obs import tracing as port_tracing
from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

from oracle import vector_step
from torch_obs_state import reset_both

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
SEED = 20261017


class _Proc:
    """A subprocess whose output lines a reader thread queues, so waiting
    for a line has a timeout."""

    def __init__(self, args, cwd):
        env = dict(os.environ, PYTHONPATH=REPO_ROOT)
        self.proc = subprocess.Popen(
            [sys.executable, *args], cwd=cwd, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self.lines: queue.Queue = queue.Queue()
        self.seen: list = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, text, timeout=TIMEOUT) -> str:
        deadline = time.monotonic() + timeout
        while True:
            line = self.lines.get(timeout=max(0.01, deadline - time.monotonic()))
            if line is None:
                raise RuntimeError(f"process exited: {''.join(self.seen)}")
            self.seen.append(line)
            if text in line:
                return line

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=TIMEOUT)


def _start_broker(module, tmp_path, *flags):
    proc = _Proc(["-m", module, "-port", "0", *flags], cwd=tmp_path)
    line = proc.wait_for("broker listening on :")
    return proc, f"127.0.0.1:{int(line.rsplit(':', 1)[1].split()[0])}"


@pytest.fixture(autouse=True)
def clean_obs():
    reset_both()
    yield
    reset_both()


@pytest.fixture(scope="module")
def port_broker(tmp_path_factory):
    work = tmp_path_factory.mktemp("port_broker")
    (work / "images").symlink_to(os.path.join(REPO_ROOT, "images"))
    proc, addr = _start_broker(
        "gol_distributed_final_tpu_torch.rpc.broker", work, "-device", "cpu",
        "-metrics", "-timeline", "0.2", "-trace", "-journal", str(work / "journal"),
        "-profile", "-session-capacity", "16",
    )
    yield addr, work
    try:
        RemoteBroker(addr).super_quit()
        proc.proc.wait(timeout=TIMEOUT)
    finally:
        proc.stop()


def _session_runs(addr, n=4, size=32):
    """n concurrent tagged SessionRuns with different budgets; each reply
    equals its numpy oracle."""
    rng = np.random.default_rng(SEED)
    boards = [np.where(rng.random((size, size)) < 0.3, 255, 0).astype(np.uint8)
              for _ in range(n)]
    budgets = [10 + 7 * i for i in range(n)]
    results = [None] * n

    def one(i):
        broker = RemoteBroker(addr)
        try:
            results[i] = broker.session_run(
                Params(turns=budgets[i], image_width=size, image_height=size),
                boards[i], session_id=i + 1)
        finally:
            broker.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    for i, res in enumerate(results):
        want = boards[i]
        for _ in range(budgets[i]):
            want = vector_step(want)
        assert np.array_equal(res.world != 0, want != 0)
    return sum(budgets)


def _series(payload, name):
    for fam in payload["metrics"]["families"]:
        if fam["name"] == name:
            return {tuple(s["labels"]): s for s in fam["series"]}
    return {}


def test_traced_port_session_is_one_trace_across_both_processes(port_broker, tmp_path,
                                                                 images_dir, check_dir):
    addr, _ = port_broker
    port_tracing.enable()
    port_tracing.set_process_name("controller")
    port_flight.enable()
    broker = RemoteBroker(addr)
    try:
        port_run(Params(turns=100, image_width=64, image_height=64), broker=broker,
                 images_dir=str(images_dir), out_dir=str(tmp_path))
    finally:
        broker.close()
    assert (tmp_path / "64x64x100.pgm").read_bytes() == \
        (check_dir / "images" / "64x64x100.pgm").read_bytes()
    trace = json.loads((tmp_path / "trace_64x64x100.json").read_text())
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    pids = {e["pid"] for e in spans}
    trace_ids = {e["args"]["trace_id"] for e in spans}
    names = {e["name"] for e in spans}
    assert len(pids) == 2, pids  # the controller's and the broker's tracks
    assert len(trace_ids) == 1, trace_ids
    assert {"controller.session", "rpc.client.call Operations.Run",
            "rpc.server.dispatch Operations.Run", "engine.chunk"} <= names


def test_reference_tools_read_a_port_broker_status(port_broker):
    """ROADMAP 5a's "done when": the JAX package's fetch_status, watch and
    doctor read a port broker's Status, and the panels show the sessions'
    counters."""
    addr, work = port_broker
    before = jax_status.fetch_status(addr, timeout=10)
    turns = _session_runs(addr)
    payload = jax_status.fetch_status(addr, timeout=10)
    assert payload["role"] == "broker" and payload["metrics_enabled"]
    admitted = _series(payload, "gol_sessions_admitted_total")[()]["value"]
    done = _series(payload, "gol_session_turns_total")[()]["value"]
    assert admitted - _series(before, "gol_sessions_admitted_total").get(
        (), {"value": 0})["value"] == 4
    assert done - _series(before, "gol_session_turns_total").get(
        (), {"value": 0})["value"] == turns
    assert payload["timeline"]["series"] and payload["alerts"]
    assert payload["accounting"]["tenants"]
    assert payload["profile"] and payload["journal"]
    panel = jax_watch.render_status("port broker", payload)
    assert "SESSIONS" in panel and "DISABLED" not in panel
    findings = jax_doctor.diagnose({addr: payload})
    assert findings and all("failed" not in f["title"] for f in findings)
    # the journal segments on disk read back whole
    from gol_distributed_final_tpu.obs.journal import read_segments

    records, problems = read_segments(work / "journal")
    kinds = {r["kind"] for r in records}
    assert problems == [] and {"session.admit", "session.final"} <= kinds


def test_port_status_reads_a_reference_broker(tmp_path):
    proc, addr = _start_broker("gol_distributed_final_tpu.rpc.broker", tmp_path,
                               "-metrics", "-session-capacity", "8")
    try:
        turns = _session_runs(addr, n=2)
        payload = port_status.fetch_status(addr, timeout=10)
        assert payload["role"] == "broker"
        assert _series(payload, "gol_session_turns_total")[()]["value"] == turns
        prom = snapshot_to_prometheus(payload["metrics"])
        assert 'gol_rpc_server_requests_total{method="Operations.SessionRun"} 2' in prom
    finally:
        try:
            RemoteBroker(addr).super_quit()
            proc.proc.wait(timeout=TIMEOUT)
        finally:
            proc.stop()


def test_port_status_cli_prints_prometheus_text(port_broker, capsys):
    addr, _ = port_broker
    assert port_status.main([addr, "-format", "prom"]) == 0
    out = capsys.readouterr().out
    assert 'gol_rpc_server_requests_total{method="Operations.Status"}' in out
