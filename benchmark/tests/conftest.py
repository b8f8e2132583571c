"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
reference, the harness's arithmetic and plumbing on the CPU, and the check
failing under each planted fault. A test that needs the card carries the
``cuda`` marker and skips inside itself where torch sees none."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped where torch sees none")


@pytest.fixture(scope="session")
def root() -> pathlib.Path:
    return ROOT


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    """Runs write under a temporary directory of their own."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


#: the benchmark's cell, and the turns of its sessions in the tests' runs on
#: the CPU, which would take days over its ten million
CELL = "ref512.turns10000000"
CPU_TURNS = 10000


@pytest.fixture
def cpu_cell(monkeypatch):
    """``CELL``, whose sessions have ``CPU_TURNS`` turns wherever the
    harness looks the cell up (``manifest.cell``)."""
    import dataclasses

    from benchmark.harness import manifest

    real = manifest.cell

    def cell(name, data=None):
        found = real(name, data)
        if name != CELL:
            return found
        return dataclasses.replace(found, traffic=dict(found.traffic, turns=CPU_TURNS))

    monkeypatch.setattr(manifest, "cell", cell)
    return CELL
