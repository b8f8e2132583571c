"""Everything the harness runs, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. A cell's traffic parameters are ``benchmark/workloads/<cell>.json``
(its ``driver`` names ``benchmark/traffic/<driver>.py``), its
configuration is ``benchmark/configs/<config>.json`` (an ``image`` under
``benchmark/``, or a seeded ``board``: ``{"kind": "soup", "density": p}``
or ``{"kind": "cells", "file": "inputs/<name>.cells"}``, a pattern of live
cells; its optional ``check`` names ``benchmark/checks/<check>.py``), and
each metric but ``setup_s`` is read by ``benchmark/metrics/<metric>.py``. A
new cell, configuration or metric is new files and new entries; no file
here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
#: the one metric the harness takes itself: process start to the first timed
#: session
SETUP = "setup_s"


class UnknownName(LookupError):
    """A cell, configuration, driver or metric that has no entry or file."""


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple


def manifest() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise UnknownName(f"no BENCHMARK.json at {ROOT}")
    return json.loads(path.read_text())


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise UnknownName(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    listed = metric.get("workloads")
    if listed is not None:
        return cell in listed
    # an end-to-end metric without a list goes to every cell, a per-layer one
    # wherever the end-to-end metric it moves goes
    return metric["moves"] in e2e_names if "moves" in metric else True


def cell(name: str, data: dict | None = None) -> Cell:
    """The cell called ``name`` with its configuration, traffic and metrics."""
    data = manifest() if data is None else data
    entry = next((w for w in data["workloads"] if w["name"] == name), None)
    if entry is None:
        raise UnknownName(f"no workload {name!r} in BENCHMARK.json")
    e2e = tuple(m for m in data["end_to_end"] if _reports(m, name, ()))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in data["per_layer"] if _reports(m, name, names))
    traffic = _json("workloads", name)
    if traffic.get("config") != entry["config"]:
        raise UnknownName(f"workloads/{name}.json names config {traffic.get('config')!r}, "
                          f"BENCHMARK.json {entry['config']!r}")
    return Cell(name, int(entry["chips"]), _json("configs", entry["config"]), traffic,
                e2e, per_layer)


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise UnknownName(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    """``benchmark/traffic/<name>.py``: ``setup(ctx)`` then ``window(ctx)``."""
    return _module("traffic", name)


def check(name: str):
    """``benchmark/checks/<name>.py``, with the interface of
    ``harness/check.py``: ``compare(sessions, ctx)`` gives
    ``{name: (value, limit, holds)}``, and ``AT_LEAST`` names the numbers
    held from below."""
    return _module("checks", name)


def reader(metric: str):
    """``benchmark/metrics/<metric>.py``'s ``read(records)``: the metric's
    value, or None where the records hold nothing to read."""
    return _module("metrics", metric).read
