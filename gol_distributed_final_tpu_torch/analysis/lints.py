"""The README name-drift lints, re-seated on the analysis framework.

``obs/lint.py`` has owned the name contracts since PR 1: every metric /
span / SLO-rule name registered in code must appear in its README
section of record. Those checks keep their home (tests and the
``scripts/check --lint`` alias still call ``obs.lint`` directly — the
functions and their behavior are unchanged); this module wraps each
entry of ``obs.lint.CHECKS`` as a repo-level :class:`~.core.Checker`,
so the default ``scripts/check`` run reports doc drift and AST
violations through ONE runner, one finding format, one exit contract.

It also owns the analyzer's own doc contract: ``lint-analysis-docs``
requires the README "Static analysis" section to name every AST checker
id and the suppression syntax — the same add-a-name-document-it loop the
metric tables enforce.
"""

from __future__ import annotations

import pathlib
from typing import Iterable, List

from .core import Checker, Finding, rel_base


def _readme_line(readme_path: pathlib.Path, needle: str) -> int:
    """Best-effort anchor line for a README finding (1 when absent)."""
    try:
        lines = readme_path.read_text().splitlines()
    except OSError:
        return 1
    for i, line in enumerate(lines, 1):
        if needle in line:
            return i
    return 1


#: check id -> the README heading its findings anchor to, so a missing
#: name reports a clickable line at the section it belongs in
_SECTION_ANCHORS = {
    "lint-metrics": "## Observability",
    "lint-spans": "## Tracing",
    "lint-device-metrics": "Device telemetry",
    "lint-wire-metrics": "## Wire modes",
    "lint-integrity-metrics": "## Integrity",
    "lint-session-metrics": "## Sessions",
    "lint-slo-metrics": "## SLOs & alerting",
    "lint-slo-rules": "## SLOs & alerting",
    "lint-canary-metrics": "## Canary & load harness",
    "lint-accounting-docs": "## Accounting & capacity",
    "lint-perf-metrics": "## Performance attribution",
    "lint-sparse-metrics": "## Sparse stepping",
    "lint-fused-metrics": "## Fused stepping",
    "lint-journal-metrics": "## Journal & history",
    # lint-journal-kinds anchors on the journal section too: a drifted
    # kind means the README's event-kind table is stale alongside the
    # EVENT_KINDS dict
    "lint-journal-kinds": "## Journal & history",
}


class ReadmeLintChecker(Checker):
    """One ``obs.lint.CHECKS`` entry under the analysis runner."""

    bug_class = (
        "doc drift: an operator-facing name registered in code but "
        "absent from its README section of record"
    )

    def __init__(self, check_id: str, func, fail_msg: str):
        self.id = check_id
        self._func = func
        self.description = fail_msg.rstrip(":")
        self._anchor = _SECTION_ANCHORS.get(check_id)

    def check_tree(self, root) -> Iterable[Finding]:
        readme = rel_base(pathlib.Path(root)) / "README.md"
        try:
            missing = self._func(readme_path=readme)
        except OSError as e:
            return [Finding(self.id, "README.md", 1, f"cannot lint: {e}")]
        line = _readme_line(readme, self._anchor) if self._anchor else 1
        return [
            Finding(
                self.id, "README.md", line,
                f"{self.description}: {name}",
            )
            for name in missing
        ]


class AnalysisDocsChecker(Checker):
    """The analyzer's own README contract: the "Static analysis" section
    documents every invariant checker id (AST and lock-composition), the
    suppression syntax, and the lock sanitizer's ``GOL_LOCKSAN`` knob."""

    id = "lint-analysis-docs"
    description = (
        "README 'Static analysis' section names every invariant checker "
        "id, the '# gol: allow' suppression syntax, and the GOL_LOCKSAN "
        "sanitizer knob"
    )
    bug_class = (
        "doc drift: an undocumented checker id, allow syntax, or "
        "sanitizer knob"
    )

    def check_tree(self, root) -> Iterable[Finding]:
        from ..obs.lint import _readme_section
        from . import ast_checkers, concurrency_checkers

        readme = rel_base(pathlib.Path(root)) / "README.md"
        try:
            section = _readme_section(readme, "## Static analysis")
        except OSError as e:
            return [Finding(self.id, "README.md", 1, f"cannot lint: {e}")]
        findings: List[Finding] = []
        line = _readme_line(readme, "## Static analysis")
        for checker in ast_checkers() + concurrency_checkers():
            if checker.id not in section:
                findings.append(Finding(
                    self.id, "README.md", line,
                    f"checker id '{checker.id}' missing from the "
                    f"'Static analysis' section's checker table",
                ))
        if "gol: allow" not in section:
            findings.append(Finding(
                self.id, "README.md", line,
                "suppression syntax ('# gol: allow(<check>): <why>') "
                "missing from the 'Static analysis' section",
            ))
        if "GOL_LOCKSAN" not in section:
            findings.append(Finding(
                self.id, "README.md", line,
                "the lock sanitizer's 'GOL_LOCKSAN' knob (utils/"
                "locksan.py: env switch, watchdog deadline, artifact "
                "path) is missing from the 'Static analysis' section",
            ))
        return findings


def readme_checkers() -> List[Checker]:
    from ..obs.lint import CHECKS

    checkers: List[Checker] = [
        ReadmeLintChecker(check_id, func, fail_msg)
        for check_id, func, fail_msg, _ok_msg in CHECKS
    ]
    checkers.append(AnalysisDocsChecker())
    return checkers
