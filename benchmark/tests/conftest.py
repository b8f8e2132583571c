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
