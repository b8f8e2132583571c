"""A configuration with a seeded soup board and its own check
(``benchmark/checks/window.py``): the check on planted faults, and whole
runs on the CPU of a toy configuration from a manifest the test builds."""

import json
import shutil
import time
import types

import numpy as np
import pytest

from benchmark import reference
from benchmark.harness import brokerproc, manifest, runner, soup
from benchmark.harness.sessions import Session

WINDOW = manifest.check("window")
SIZE, TURNS, DENSITY = 128, 17, 0.5
CONFIG = {"name": "toy128", "board": {"kind": "soup", "density": DENSITY}, "width": SIZE,
          "height": SIZE, "rule": "B3/S23", "check": "window"}


def _sessions(tmp_path, seeds=(7, 2**32 - 3)):
    """Sound sessions: each keeps three windows, the first its final PGM."""
    out = []
    for i, seed in enumerate(seeds):
        final = reference.evolve(soup.region(seed, 0, 0, SIZE, SIZE, SIZE, SIZE, DENSITY), TURNS)
        s = Session(i, seed, TURNS, answered=True, turns=TURNS,
                    alive=int(np.count_nonzero(final)))
        s.windows = [(y0, x0, final.take(range(y0, y0 + 16), 0, mode="wrap")
                      .take(range(x0, x0 + 24), 1, mode="wrap"))
                     for y0, x0 in ((-8, -12), (40, 100), (127, 3))]
        if i == 0:
            s.out_path = tmp_path / f"{i}.pgm"
            reference.write_pgm(s.out_path, final)
        out.append(s)
    return out


def _compare(sessions):
    checks = WINDOW.compare(sessions, types.SimpleNamespace(config=CONFIG, board=CONFIG["board"]))
    return all(holds for _, _, holds in checks.values()), checks


def _flip(s):
    y0, x0, kept = s.windows[1]
    kept = kept.copy()
    kept[3, 5] = 255 - kept[3, 5]
    s.windows[1] = (y0, x0, kept)


def _short(s):
    s.turns -= 1


def _alive(s):
    s.alive += 1


FAULTS = {"flipped_cell": (_flip, "wrong_windows"), "turns_short": (_short, "wrong_turns"),
          "alive_off_by_one": (_alive, "wrong_alive")}


def test_sound_sessions_hold(tmp_path, monkeypatch):
    """Two sessions on one soup keep the same windows: each cone evolves once."""
    cones = []
    evolve_windows = reference.evolve_windows

    def counted(windows, *args):
        cones.extend(windows)
        return evolve_windows(windows, *args)

    monkeypatch.setattr(reference, "evolve_windows", counted)
    sessions = _sessions(tmp_path, seeds=(7, 2**32 - 3, 7))
    ok, checks = _compare(sessions)
    assert ok, checks
    assert checks["windows_checked"][0] == 9 and checks["alive_checked"][0] == 1
    assert checks["wrap_windows_checked"][0] == 3
    assert len(cones) == 6
    assert not sessions[0].out_path.exists()


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_check(tmp_path, fault):
    plant, name = FAULTS[fault]
    sessions = _sessions(tmp_path)
    plant(sessions[0])
    ok, checks = _compare(sessions)
    assert not ok and checks[name][0] == 1 and not checks[name][2], checks


def test_no_window_kept_fails_the_check(tmp_path):
    sessions = _sessions(tmp_path)
    for s in sessions:
        s.windows = []
    ok, checks = _compare(sessions)
    assert not ok and checks["windows_checked"] == (0, 1, False)


def test_no_window_across_both_edges_fails_the_check(tmp_path):
    """The window at (-8, -12) crosses both edges, the one at (127, 3) only
    the bottom one: without the first, the edges go unchecked."""
    sessions = _sessions(tmp_path)
    for s in sessions:
        del s.windows[0]
    ok, checks = _compare(sessions)
    assert not ok and checks["wrap_windows_checked"] == (0, 1, False)
    assert checks["windows_checked"] == (4, 1, True)


def test_no_pgm_kept_and_a_pgm_of_another_size_fail_the_check(tmp_path):
    sessions = _sessions(tmp_path)
    sessions[0].out_path.unlink()
    sessions[0].out_path = None
    assert _compare(sessions)[1]["alive_checked"] == (0, 1, False)
    sessions = _sessions(tmp_path)
    reference.write_pgm(sessions[0].out_path, np.zeros((SIZE - 1, SIZE), np.uint8))
    sessions[0].alive = 0
    assert _compare(sessions)[1]["wrong_alive"] == (1, 0, False)


def test_the_alive_count_reads_the_pgm_in_blocks(tmp_path, monkeypatch):
    board = soup.region(3, 0, 0, 300, 64, 300, 64, 0.5)
    reference.write_pgm(tmp_path / "b.pgm", board)
    monkeypatch.setattr(WINDOW, "ROWS", 7)
    assert WINDOW.pgm_alive(tmp_path / "b.pgm", (300, 64)) == np.count_nonzero(board)
    assert WINDOW.pgm_alive(tmp_path / "b.pgm", (301, 64)) is None


def test_the_configurations_broker_args_end_the_brokers_command_line(monkeypatch, tmp_path):
    seen = []

    class Proc:
        def __init__(self, argv, **kwargs):
            seen.append(argv)
            self.stdout = iter(())

        def poll(self):
            return 0

    monkeypatch.setattr(brokerproc.subprocess, "Popen", Proc)
    brokerproc.BrokerProcess(tmp_path / "log", device="cpu", args=["-wire", "resident"]).close()
    brokerproc.BrokerProcess(tmp_path / "log", device="cpu").close()
    assert seen[0][-4:] == ["-device", "cpu", "-wire", "resident"]
    assert seen[1][-2:] == ["-device", "cpu"]


@pytest.fixture
def toy(root, tmp_path, monkeypatch, tmpdir_env):
    """A checkout whose BENCHMARK.json holds a 256 x 256 soup configuration
    and its one cell, run by the test's driver (``soup_sessions.py``) and
    checked by ``checks/window.py``; the metrics are the repository's."""
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"] = [{"name": "toy256", "source": "https://example.org/toy",
                        "file": "benchmark/configs/toy256.json", "reduced": [], "why": "a test"}]
    data["workloads"] = [{"name": "toy256.windows", "config": "toy256", "traffic": "windows",
                          "chips": 1, "why": "a test"}]
    bench = tmp_path / "checkout" / "benchmark"
    for kind in ("configs", "workloads", "traffic"):
        (bench / kind).mkdir(parents=True)
    for kind in ("metrics", "checks"):
        (bench / kind).symlink_to(manifest.BENCH / kind)
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(data))
    (bench / "configs" / "toy256.json").write_text(json.dumps(
        dict(CONFIG, name="toy256", width=256, height=256, broker_args=["-session-capacity", "8"],
             reduced=[])))
    (bench / "workloads" / "toy256.windows.json").write_text(json.dumps(
        {"config": "toy256", "driver": "soup_sessions", "turns": 60, "pool": 4, "windows": 3,
         "window": 64}))
    shutil.copy(manifest.BENCH / "tests" / "soup_sessions.py", bench / "traffic")
    monkeypatch.setattr(manifest, "ROOT", bench.parent)
    monkeypatch.setattr(manifest, "BENCH", bench)
    return "toy256.windows"


def test_a_soup_configuration_runs_end_to_end_and_holds(toy, capsys):
    rc = runner.main(["--workload", toy, "--seed", "3000000011", "--seconds", "1"],
                     t_start=time.monotonic(), device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "cell_updates_per_s"}
    assert list(line["checks"]) == ["unanswered", "wrong_turns", "wrong_windows", "wrong_alive",
                                    "windows_checked", "wrap_windows_checked", "alive_checked"]
    assert line["checks"]["windows_checked"]["value"] == 3 * line["attempted"]
    wrapped = line["checks"]["wrap_windows_checked"]["value"]
    assert wrapped >= line["attempted"]  # the driver's first window crosses both edges
    tail = err.strip().splitlines()[-7:]
    assert tail[0] == "check unanswered 0 (at most 0)"
    assert tail[-2:] == [f"check wrap_windows_checked {wrapped} (at least 1)",
                         "check alive_checked 1 (at least 1)"]


@pytest.mark.parametrize("fault", ["unchanged", "control"])
def test_a_planted_broker_fault_fails_the_soup_configuration(toy, fault):
    """A step that returns its state unchanged, and the control (closed
    edges): the window that straddles both edges sees the second."""
    args = runner.parse(["--workload", toy, "--seed", "3000000013", "--seconds", "1"])
    line, records = runner.measure(args, manifest.cell(toy), time.monotonic(), device="cpu",
                                   fault=fault)
    assert line["correct"] is False
    wrong = line["checks"]["wrong_windows"]["value"]
    assert wrong >= line["attempted"] - line["failed"] >= 1
    assert records["cells_per_board"] == 256 * 256
