"""One run of one cell: set-up, the measured window, the check, the line.

The broker runs in a child process (``broker_child.py``), the one process
on the card; this process is the client side (the controller, run as
deployed) and never computes on the card. With ``--trace 1`` the
broker meters its RPC verbs (``-metrics``) and profiles the card over the
window, and the line carries the cell's per-layer metrics; with
``--trace 0`` its end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

from benchmark import reference
from benchmark.harness import check, devtrace, manifest, nojax
from benchmark.harness.brokerproc import BrokerProcess

#: exit codes: an unknown name, no card, JAX loaded
EXIT_NAME, EXIT_NO_CARD, EXIT_JAX = 2, 3, 4


class Context:
    """What a traffic driver and a configuration's check get: the cell, the
    seed, the window's length, a directory of its own, the configuration's
    image (None for a seeded board) and ``board`` (its ``board`` entry, None
    for an image), the broker's address, and ``state`` to keep between
    ``setup`` and ``window``."""

    def __init__(self, cell, seed: int, seconds: float, workdir: pathlib.Path, image):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.workdir = workdir
        self.image = image
        self.board = cell.config.get("board")
        self.address = None
        self.state: dict = {}


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _server_seconds(address: str) -> dict:
    """``{verb: [seconds, calls]}`` of the broker's handlers so far."""
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

    remote = RemoteBroker(address)
    try:
        payload = remote.status()
    finally:
        remote.close()
    for fam in payload.get("metrics", {}).get("families", []):
        if fam["name"] == "gol_rpc_server_request_seconds":
            return {s["labels"][0]: [s["sum"], s["count"]] for s in fam["series"]}
    return {}


def _delta(before: dict, after: dict) -> dict:
    return {verb: {"seconds": s - before.get(verb, [0, 0])[0],
                   "calls": n - before.get(verb, [0, 0])[1]}
            for verb, (s, n) in after.items()}


def main(argv=None, *, t_start: float, device: str | None = None,
         fault: str | None = None) -> int:
    """A measurement run on the card; the tests pass ``device="cpu"`` (and
    a ``fault``) to drive the rest of a run without one."""
    args = parse(argv)
    try:
        cell = manifest.cell(args.workload)
    except manifest.UnknownName as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return EXIT_NAME
    with _broker(args, cell, device, fault) as (workdir, broker):
        if device is None:
            # after the broker's start, so that its imports overlap this one's
            import torch

            if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
                print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); torch "
                      f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                      file=sys.stderr)
                return EXIT_NO_CARD
        line, _ = _run(args, cell, t_start, device, workdir, broker)
    if line is None:
        return EXIT_JAX
    at_least = _check(cell).AT_LEAST
    for name, c in line["checks"].items():
        bound = "at least" if name in at_least else "at most"
        print(f"check {name} {c['value']} ({bound} {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


def measure(args, cell, t_start: float, *, device=None, fault=None):
    """``(line, records)`` of one run of ``cell``; ``(None, None)`` if the
    run loaded JAX."""
    with _broker(args, cell, device, fault) as (workdir, broker):
        return _run(args, cell, t_start, device, workdir, broker)


@contextlib.contextmanager
def _broker(args, cell, device, fault):
    """A directory of the run's own and the broker child, both gone after."""
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="gol-bench-"))
    broker = None
    try:
        broker = BrokerProcess(workdir / "broker.log", metrics=bool(args.trace), device=device,
                               fault=fault, args=cell.config.get("broker_args", ()))
        yield workdir, broker
    finally:
        if broker is not None:
            broker.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _image(config: dict):
    """The configuration's image, of its ``height x width``; None where its
    board is a seeded soup (``harness/soup.py``)."""
    if "image" not in config:
        if (config.get("board") or {}).get("kind") != "soup":
            raise ValueError(f"configuration {config['name']!r} has neither an image "
                             f"nor a soup board")
        return None
    image = reference.read_pgm(manifest.BENCH / config["image"])
    if image.shape != (config["height"], config["width"]):
        raise ValueError(f"{config['image']} is {image.shape[1]} x {image.shape[0]}, "
                         f"configuration {config['name']!r} {config['width']} x "
                         f"{config['height']}")
    return image


def _check(cell):
    """The module that decides ``correct``: the configuration's named check
    (``benchmark/checks/<check>.py``), else ``harness/check.py``. Its
    ``compare(sessions, ctx)`` gives ``{name: (value, limit, holds)}``, and
    its ``AT_LEAST`` names the numbers held from below."""
    return manifest.check(cell.config["check"]) if "check" in cell.config else check


def _run(args, cell, t_start, device, workdir, broker):
    image = _image(cell.config)
    judge = _check(cell)
    drv = manifest.driver(cell.traffic["driver"])
    ctx = Context(cell, args.seed, args.seconds, workdir, image)
    raw = server = None
    try:
        ctx.address = broker.address()
        print(f"broker listening at {time.monotonic() - t_start} s", file=sys.stderr)
        # the program's own prints (a controller's "File ... output done!")
        # stay off this process's standard output, whose last line is the result
        with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
            drv.setup(ctx)
            setup_s = time.monotonic() - t_start
            print(f"set-up {setup_s} s", file=sys.stderr)
            if args.trace:
                before = _server_seconds(ctx.address)
                broker.command("trace-start")
            cpu0 = (time.process_time(), broker.cpu_seconds())
            result = drv.window(ctx)
            cpu1 = (time.process_time(), broker.cpu_seconds())
            if args.trace:
                raw = broker.command(f"trace-stop {workdir / 'trace.json'}")
                server = _delta(before, _server_seconds(ctx.address))
            stats = broker.command(f"stats {workdir / 'stats.json'}")
    finally:
        close = getattr(drv, "close", None)
        if close is not None:
            close(ctx)
        broker.close()
    # this process (the client side) and the broker child, which runs the port
    # on the card, each once the window has closed
    found = {"this process": nojax.loaded(), "the broker": stats["forbidden"]}
    if any(found.values()):
        for where, names in found.items():
            if names:
                print(f"benchmark: {where} loaded {', '.join(names)}", file=sys.stderr)
        return None, None

    sessions = result["sessions"]
    t0, t1 = result["window_ns"]
    print(f"host CPU over the window of {(t1 - t0) / 1e9} s: this process "
          f"{cpu1[0] - cpu0[0]} s, the broker {cpu1[1] - cpu0[1]} s", file=sys.stderr)
    records = {
        "cell": cell.name, "rule": cell.config["rule"], "seconds": args.seconds,
        "cells_per_board": cell.config["width"] * cell.config["height"],
        "window_ns": (t0, t1), "sessions": sessions,
        "server": server,
        "trace": devtrace.reduce(_expand(raw), t0, t1) if raw is not None else None,
    }
    metrics = {}
    if args.trace:
        wanted = cell.per_layer
    else:
        metrics[manifest.SETUP] = {"value": setup_s, "unit": "s"}
        wanted = [m for m in cell.end_to_end if m["name"] != manifest.SETUP]
    for m in wanted:
        value = manifest.reader(m["name"])(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": None,
        "attempted": len(sessions),
        "failed": sum(1 for s in sessions if not s.answered),
        "metrics": metrics,
        "device": {"platform": "gpu" if device is None else device, "kind": stats["kind"],
                   "count": cell.chips, "memory_peak_bytes": stats["memory_peak_bytes"]},
    }
    trace = records["trace"]
    if trace is not None:
        line["device"].update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = _breakdown(trace, sessions)
    # the reference runs now: the window is closed and the broker is gone
    checks = judge.compare(sessions, ctx)
    line["correct"] = all(holds for _, _, holds in checks.values())
    line["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit, _) in checks.items()}
    return line, records


def _expand(raw: dict) -> dict:
    names = raw["names"]
    return {"device": [(names[k], start, end) for k, start, end in raw["device"]],
            "launch_calls": raw["launch_calls"]}


def _breakdown(trace: dict, sessions) -> dict:
    ops = sorted(trace["by_op_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["gaps"], key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[devtrace.name_gap(g, sessions), (g[1] - g[0]) / 1e9] for g in gaps]}
