"""Everything found by name, and BENCHMARK.json within its contract."""

import json
import re

import pytest

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def data(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_config_driver_and_metrics(data):
    for w in data["workloads"]:
        cell = manifest.cell(w["name"], data)
        config = cell.config
        assert config["rule"] and config["width"] >= 1 and config["height"] >= 1
        # an image, or a seeded soup (harness/soup.py)
        if "image" in config:
            assert (manifest.BENCH / config["image"]).is_file()
        else:
            assert config["board"]["kind"] == "soup" and 0 < config["board"]["density"] < 1
        if "check" in config:
            assert callable(manifest.check(config["check"]).compare)
        assert all(isinstance(a, str) for a in config.get("broker_args", []))
        assert hasattr(manifest.driver(cell.traffic["driver"]), "window")
        names = {m["name"] for m in cell.end_to_end}
        assert manifest.SETUP in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names
        for m in list(cell.end_to_end) + list(cell.per_layer):
            if m["name"] != manifest.SETUP:
                assert callable(manifest.reader(m["name"]))


def test_ref512_keeps_its_image(data, cpu_cell):
    assert manifest.cell(cpu_cell, data).config["image"] == "inputs/512x512.pgm"


@pytest.mark.parametrize("kind,call", [
    ("cell", lambda: manifest.cell("no.such_cell")),
    ("check", lambda: manifest.check("no_such_check")),
    ("driver", lambda: manifest.driver("no_such_driver")),
    ("metric", lambda: manifest.reader("no_such_metric")),
])
def test_unknown_names_are_refused(kind, call):
    with pytest.raises(manifest.UnknownName):
        call()


def test_a_cell_whose_file_names_another_config_is_refused(data):
    bad = json.loads(json.dumps(data))
    bad["workloads"][0]["config"] = "no_such_config"
    with pytest.raises(manifest.UnknownName):
        manifest.cell(bad["workloads"][0]["name"], bad)


def test_manifest_keys_names_and_limits(data, root):
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert data["paths"] == ["benchmark"] and data["command"][1] == "benchmark/run.py"
    assert 1 <= data["run_seconds"] <= 51
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in data["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        layers.add(m["layer"])
        for cell in m["workloads"]:
            e2e = [e for e in data["end_to_end"] if e["name"] == m["moves"]][0]
            assert cell in e2e.get("workloads", [cell])
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(data)) < 64 * 1024


@pytest.mark.parametrize("turns,warm_turns,expect", [(10**7, 2 * 10**6, 2 * 10**6),
                                                      (10**4, 2 * 10**6, 10**4),
                                                      (10**4, None, 10**4)])
def test_the_warm_up_session_takes_warm_turns_and_at_most_turns(
        monkeypatch, tmp_path, turns, warm_turns, expect):
    import numpy as np

    from gol_distributed_final_tpu_torch.rpc import client

    drv = manifest.driver("sessions_closed")
    asked = []

    def session(ctx, s, images_dir, out_dir):
        asked.append(s.turns_asked)
        s.answered = True

    monkeypatch.setattr(drv, "_session", session)
    monkeypatch.setattr(client, "RemoteBroker", lambda address: None)
    traffic = {"turns": turns, "pool": 2}
    if warm_turns is not None:
        traffic["warm_turns"] = warm_turns

    class Ctx:
        seed, workdir, address, state = 5, tmp_path, "localhost:1", {}
        image = np.zeros((64, 64), np.uint8)

    Ctx.traffic = traffic
    drv.setup(Ctx)
    assert asked == [expect]
