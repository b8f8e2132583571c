"""The port's static analysis (gol_distributed_final_tpu_torch/analysis/)
against the JAX package's.

Every source snippet the JAX package's own analysis tests feed its
checkers (tests/test_analysis.py, tests/test_lockorder.py) goes through
both analyzers, as one file and as a one-file tree, and the findings and
suppressions must be equal, those of ``jit-cache`` aside: the port has no
such checker (no XLA compile cache to grow, no traced Python). The port's
analyzer over the port's tree is clean, and the JAX analyzer over it finds
nothing but ``jit-cache``.
"""

import ast
import subprocess
import sys
import textwrap

import pytest

from gol_distributed_final_tpu import analysis as jax_analysis
from gol_distributed_final_tpu.analysis import core as jax_core
from gol_distributed_final_tpu_torch import analysis as port_analysis
from gol_distributed_final_tpu_torch.analysis import core as port_core
from gol_distributed_final_tpu_torch.analysis.__main__ import PACKAGE_ROOT, main

from helpers import REPO_ROOT

JIT = "jit-cache"


def _snippets():
    """Every string literal of the two JAX test files that parses as a
    module defining a function or a class, in file order, deduplicated."""
    seen, out = set(), []
    for name in ("test_analysis.py", "test_lockorder.py"):
        tree = ast.parse((REPO_ROOT / "tests" / name).read_text())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
                continue
            src = textwrap.dedent(node.value)
            if ("def " not in src and "class " not in src) or src in seen:
                continue
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            seen.add(src)
            out.append(pytest.param(src, id=f"{name[5:-3]}:{node.lineno}"))
    return out


SNIPPETS = _snippets()


def _rows(findings):
    """Comparable rows, without the jit checker's findings and without
    the suppression findings that name it (the port knows no such id)."""
    return sorted(
        (f.check, f.path, f.line, f.message) for f in findings
        if f.check != JIT and JIT not in f.message
    )


def test_the_snippet_corpus_is_the_reference_tests():
    assert len(SNIPPETS) >= 70


def test_the_port_has_every_checker_but_jit_cache():
    jax_ids = [c.id for c in jax_analysis.all_checkers()]
    port_ids = [c.id for c in port_analysis.all_checkers()]
    assert JIT in jax_ids and JIT not in port_ids
    assert port_ids == [i for i in jax_ids if i != JIT]


@pytest.mark.parametrize("relpath", ["rpc/mod.py", "obs/mod.py", "engine/mod.py"])
@pytest.mark.parametrize("src", SNIPPETS)
def test_a_snippet_gives_the_reference_findings(src, relpath):
    port = port_core.analyze_source(src, relpath, port_analysis.ast_checkers())
    ref = jax_core.analyze_source(src, relpath, jax_analysis.ast_checkers())
    assert _rows(port[0]) == _rows(ref[0])
    assert _rows(port[1]) == _rows(ref[1])


@pytest.mark.parametrize("src", SNIPPETS)
def test_a_snippet_tree_gives_the_reference_concurrency_findings(src, tmp_path):
    (tmp_path / "mod.py").write_text(src)
    port = [f for c in port_analysis.concurrency_checkers() for f in c.check_tree(tmp_path)]
    ref = [f for c in jax_analysis.concurrency_checkers() for f in c.check_tree(tmp_path)]
    assert _rows(port) == _rows(ref)


def test_the_ports_tree_is_clean_under_its_analyzer(capsys):
    assert PACKAGE_ROOT == REPO_ROOT / "gol_distributed_final_tpu_torch"
    assert main([]) == 0
    out = capsys.readouterr().out
    assert out.startswith("analysis ok:") and "jit-cache" not in out


def test_the_reference_analyzer_finds_only_jit_cache_in_the_port():
    report = jax_core.run(REPO_ROOT / "gol_distributed_final_tpu_torch")
    assert report.findings and {f.check for f in report.findings} == {JIT}
    assert all(f.path.startswith("gol_distributed_final_tpu_torch/") for f in report.findings)


def test_the_cli_runs_alone_and_exits_clean():
    proc = subprocess.run([sys.executable, "-m", "gol_distributed_final_tpu_torch.analysis"],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
