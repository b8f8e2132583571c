"""The static-analysis framework: findings, checkers, suppressions, runner.

Dependency-free (``ast`` + stdlib only): the analyzer must run before any
jax import, in CI and as a pre-test gate (``scripts/check``), on a machine
with nothing but the repo checked out.

Contracts this module owns:

* **Finding** — one violation: ``(check id, repo-relative path, 1-based
  line, message)``. The text renderer prints ``path:line: [check] msg``;
  ``-json`` ships the same tuple as an artifact (the obs/doctor.py
  posture: machine output mirrors the terminal report).
* **Suppression** — ``# gol: allow(<check>[, <check>...]): <justification>``
  as a trailing comment on the flagged line, or on its own comment line
  immediately above it. The justification is MANDATORY: an allow comment
  without one (or naming an unknown check id) is itself a
  ``suppression-format`` finding, so the allow-list can never silently
  rot into an unexplained mute button. And it must stay LIVE: an allow
  that hid nothing across a full-registry run is a
  ``suppression-stale`` finding — when the code it excused (or the
  checker it named) changes, the audit trail shrinks instead of
  fossilising.
* **Walker** — every ``*.py`` under the root, skipping ``native/`` and
  other non-source trees (``SKIP_DIR_NAMES``) and files that declare
  themselves generated. A file that cannot be PARSED is a loud
  ``parse-failure`` finding, never a silent skip: an analyzer that skips
  what it cannot read reports "clean" on exactly the files most likely
  to be broken.
* **Exit code** — 0: clean (suppressed findings don't count, format
  problems do). 1: any unsuppressed finding. 2: usage/internal error
  (the CLI's argparse contract).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import pathlib
import re
import tokenize
from typing import Iterable, List, Optional, Sequence, Tuple

#: framework-owned check ids (not suppressible via themselves)
CHECK_PARSE = "parse-failure"
CHECK_SUPPRESSION = "suppression-format"
CHECK_STALE = "suppression-stale"

#: directory names the walker never descends into: native build trees,
#: caches, artifact dirs — nothing in them is first-party Python source
SKIP_DIR_NAMES = frozenset({
    "__pycache__", "native", "sdl2_stub", "build", "dist", "out",
    ".git", ".venv", "node_modules",
})

#: a file whose first lines carry one of these is a generated artifact —
#: not reviewed source, not held to source contracts
GENERATED_MARKERS = ("@generated", "do not edit")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation at ``path:line``."""

    check: str
    path: str
    line: int
    message: str

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_json(self) -> dict:
        return {
            "check": self.check,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


class Checker:
    """Base checker. File checkers override ``check_file`` (called once
    per parsed source file); repo checkers override ``check_tree``
    (called once per run, for whole-tree contracts like the README name
    lints). ``id`` is the stable suppression/README handle,
    ``description`` the one-line invariant, ``bug_class`` the failure it
    guards against (both feed the README checker table)."""

    id: str = ""
    description: str = ""
    bug_class: str = ""

    def check_file(
        self, tree: ast.AST, source: str, relpath: str
    ) -> Iterable[Finding]:
        return ()

    def check_tree(self, root: pathlib.Path) -> Iterable[Finding]:
        return ()


_ALLOW_RE = re.compile(
    r"#\s*gol:\s*allow\(\s*([^)]*?)\s*\)\s*(?::\s*(.*\S))?\s*$"
)


class Suppressions:
    """The per-file ``# gol: allow(...)`` map.

    A trailing allow comment suppresses its whole STATEMENT — every
    physical line of the (simple) statement it ends, so a multi-line
    call's findings (anchored at the statement's first line) are covered
    by an allow on its closing line; a standalone comment line
    suppresses the next statement that holds code (so a long flagged
    line can carry its justification above itself). Format problems —
    no justification, no/unknown check id — surface as
    ``suppression-format`` findings in ``problems``.

    Every well-formed allow additionally tracks whether it HID anything:
    one that matched no finding across a full-registry run is reported
    as ``suppression-stale`` (:meth:`stale_findings`), so the allow-list
    cannot rot as checkers and code evolve — a suppression for a bug
    long since fixed (or a checker long since changed) is itself a
    finding, not a silent permanent mute."""

    def __init__(self, source: str, relpath: str, known_ids, tree=None):
        self.relpath = relpath
        self.by_line: dict = {}
        self.problems: List[Finding] = []
        #: each well-formed allow: {"line", "ids", "used", "malformed"}
        self.allows: List[dict] = []
        known = frozenset(known_ids)
        lines = source.splitlines()
        spans = self._statement_spans(tree)
        for i, raw in self._allow_comments(source):
            m = _ALLOW_RE.search(raw)
            if m is None:
                continue
            ids = [s.strip() for s in m.group(1).split(",") if s.strip()]
            justification = (m.group(2) or "").strip()
            target = i
            if i <= len(lines) and lines[i - 1].lstrip().startswith("#"):
                # standalone comment: applies to the next code line
                j = i + 1
                while j <= len(lines) and (
                    not lines[j - 1].strip()
                    or lines[j - 1].lstrip().startswith("#")
                ):
                    j += 1
                target = j
            malformed = False
            if not ids:
                malformed = True
                self.problems.append(Finding(
                    CHECK_SUPPRESSION, relpath, i,
                    "allow() names no check id",
                ))
            for unknown in (x for x in ids if x not in known):
                malformed = True
                self.problems.append(Finding(
                    CHECK_SUPPRESSION, relpath, i,
                    f"allow() names unknown check id {unknown!r}",
                ))
            if not justification:
                malformed = True
                self.problems.append(Finding(
                    CHECK_SUPPRESSION, relpath, i,
                    "suppression carries no justification — write "
                    "'# gol: allow(<check>): <why this is safe>'",
                ))
            allow = {
                "line": i, "ids": tuple(ids), "used": set(),
                "malformed": malformed,
            }
            self.allows.append(allow)
            index = len(self.allows) - 1
            # record the suppression even when malformed: the format
            # finding above already fails the run, and double-reporting
            # the underlying finding would bury it — and expand it over
            # the containing simple statement's whole span, so findings
            # anchored at a multi-line statement's FIRST line are hidden
            # by an allow on its LAST
            for line in spans.get(target, (target,)):
                slot = self.by_line.setdefault(line, {})
                for check_id in ids:
                    slot.setdefault(check_id, index)

    @staticmethod
    def _statement_spans(tree) -> dict:
        """line -> every line of the innermost SIMPLE statement covering
        it. Compound statements (if/with/for/def) are excluded: an allow
        on their header must not mute their whole body."""
        spans: dict = {}
        if tree is None:
            return spans
        # walk outermost-first so inner statements overwrite (a lambda
        # body's expression statement inside an assign, etc.)
        for node in ast.walk(tree):
            if not isinstance(node, ast.stmt) or isinstance(
                node,
                (
                    ast.If, ast.For, ast.AsyncFor, ast.While, ast.With,
                    ast.AsyncWith, ast.Try, ast.FunctionDef,
                    ast.AsyncFunctionDef, ast.ClassDef,
                ),
            ):
                continue
            end = node.end_lineno or node.lineno
            if end == node.lineno:
                continue
            covered = tuple(range(node.lineno, end + 1))
            for line in covered:
                spans[line] = covered
        return spans

    @staticmethod
    def _allow_comments(source: str):
        """``(line, comment text)`` for every real COMMENT token — the
        tokenizer keeps allow syntax quoted in docstrings/messages (this
        framework's own documentation!) from registering as live
        suppressions."""
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            return [
                (tok.start[0], tok.string)
                for tok in tokens
                if tok.type == tokenize.COMMENT and "gol:" in tok.string
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # unparsable source never reaches here (ast.parse gates it),
            # but stay defensive: no comments beats a crash
            return []

    def hides(self, finding: Finding) -> bool:
        slot = self.by_line.get(finding.line, {})
        index = slot.get(finding.check)
        if index is None:
            return False
        self.allows[index]["used"].add(finding.check)
        return True

    def stale_findings(self) -> List[Finding]:
        """One ``suppression-stale`` finding per well-formed allow whose
        named check(s) hid NOTHING. Malformed allows are exempt — their
        format finding already fails the run; double-reporting would
        bury it. Callers run this only after EVERY checker in the full
        registry has reported (a filtered ``--checks`` run proves
        nothing about the other checkers' suppressions)."""
        stale = []
        for allow in self.allows:
            if allow["malformed"]:
                continue
            unmatched = [c for c in allow["ids"] if c not in allow["used"]]
            if unmatched:
                stale.append(Finding(
                    CHECK_STALE, self.relpath, allow["line"],
                    f"allow({', '.join(unmatched)}) matched no finding in "
                    f"a full-registry run — the code it excused has "
                    f"changed (or the checker has); delete the "
                    f"suppression or re-justify what it covers",
                ))
        return stale


@dataclasses.dataclass
class Report:
    """One analyzer run: what fired, what was suppressed, what was seen."""

    findings: List[Finding]
    suppressed: List[Finding]
    files: int
    checkers: List[Checker]

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "clean": self.clean,
            "files": self.files,
            "checks": {
                c.id: {
                    "description": c.description,
                    "bug_class": c.bug_class,
                }
                for c in self.checkers
            },
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
        }

    def render(self) -> str:
        lines = []
        for f in sorted(
            self.findings, key=lambda f: (f.path, f.line, f.check)
        ):
            lines.append(f"{f.location}: [{f.check}] {f.message}")
        checks = ", ".join(c.id for c in self.checkers)
        if self.clean:
            lines.append(
                f"analysis ok: {self.files} file(s) clean under "
                f"[{checks}] ({len(self.suppressed)} justified "
                f"suppression(s))"
            )
        else:
            lines.append(
                f"analysis: {len(self.findings)} finding(s) across "
                f"{self.files} file(s) "
                f"({len(self.suppressed)} suppressed)"
            )
        return "\n".join(lines)


def is_generated(source: str) -> bool:
    head = "\n".join(source.splitlines()[:3]).lower()
    return any(marker in head for marker in GENERATED_MARKERS)


def iter_python_files(root) -> Iterable[pathlib.Path]:
    """Every analyzable ``*.py`` under ``root``, deterministic order,
    never descending into ``SKIP_DIR_NAMES`` (native build trees,
    artifact dirs — see module docstring)."""
    root = pathlib.Path(root)
    if root.is_file():
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIR_NAMES)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield pathlib.Path(dirpath) / fn


def rel_base(root: pathlib.Path) -> pathlib.Path:
    """Findings are reported relative to this directory: the first
    non-package ancestor (so paths read
    ``gol_distributed_final_tpu_torch/rpc/broker.py``, clickable from the repo
    root, whether the target is the package, a subpackage, or a single
    file inside one — the path-scoped rules key on the ``rpc``/``obs``
    segments, which this keeps intact). A plain fixture tree with no
    ``__init__.py`` is its own base."""
    root = pathlib.Path(root)
    base = root.parent if root.is_file() else root
    while (base / "__init__.py").exists() and base.parent != base:
        base = base.parent
    return base


def analyze_source(
    source: str,
    relpath: str,
    checkers: Sequence[Checker],
    known_ids: Optional[Iterable[str]] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Run the file checkers over one source blob —
    ``(findings, suppressed)``. The test fixture corpus drives each
    checker through exactly this entry point."""
    findings, suppressed, _sup = _analyze_file(
        source, relpath, checkers, known_ids
    )
    return findings, suppressed


def _analyze_file(
    source: str,
    relpath: str,
    checkers: Sequence[Checker],
    known_ids: Optional[Iterable[str]] = None,
) -> Tuple[List[Finding], List[Finding], Optional[Suppressions]]:
    """:func:`analyze_source` plus the file's :class:`Suppressions` (for
    the runner: repo-checker findings route through it, and the stale
    pass interrogates it after every checker has reported)."""
    if known_ids is None:
        known_ids = [c.id for c in checkers]
    try:
        tree = ast.parse(source)
    except (SyntaxError, ValueError) as e:
        line = getattr(e, "lineno", None) or 1
        return [Finding(
            CHECK_PARSE, relpath, line,
            f"cannot parse: {getattr(e, 'msg', e)} — the analyzer refuses "
            "to silently skip unreadable source",
        )], [], None
    sup = Suppressions(source, relpath, known_ids, tree=tree)
    findings: List[Finding] = list(sup.problems)
    suppressed: List[Finding] = []
    seen = set(findings)
    for checker in checkers:
        for f in checker.check_file(tree, source, relpath):
            if f in seen:
                continue  # e.g. two reads of one field on one line
            seen.add(f)
            (suppressed if sup.hides(f) else findings).append(f)
    return findings, suppressed, sup


def run(
    root,
    checkers: Optional[Sequence[Checker]] = None,
    with_repo: bool = True,
) -> Report:
    """Analyze every source file under ``root`` (a package directory or
    any tree), then the repo-level checkers. See module docstring for
    the walker, suppression, and exit-code contracts."""
    from . import all_checkers

    root = pathlib.Path(root).resolve()
    if checkers is None:
        checkers = all_checkers()
    file_checkers = [
        c for c in checkers
        if type(c).check_file is not Checker.check_file
    ]
    repo = [
        c for c in checkers
        if type(c).check_tree is not Checker.check_tree
    ]
    # suppressions validate against the FULL registry, not just this
    # run's (possibly --checks-filtered) subset: an in-tree
    # 'gol: allow(hygiene): ...' comment must stay a known id during a
    # --checks jit-cache run, not become a spurious format finding
    known_ids = {c.id for c in checkers} | {c.id for c in all_checkers()}
    base = rel_base(root)
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    sups: dict = {}  # relpath -> Suppressions, for the passes below
    files = 0
    for path in iter_python_files(root):
        try:
            # tokenize.open honors PEP 263 coding declarations, so a
            # legal latin-1 source file decodes instead of crashing the
            # whole run; anything unreadable is still a LOUD finding
            with tokenize.open(path) as f:
                source = f.read()
        except (OSError, SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                CHECK_PARSE, path.relative_to(base).as_posix(), 1,
                f"cannot read: {e}",
            ))
            continue
        if is_generated(source):
            continue
        files += 1
        relpath = path.relative_to(base).as_posix()
        got, hidden, sup = _analyze_file(
            source, relpath, file_checkers, known_ids
        )
        findings.extend(got)
        suppressed.extend(hidden)
        if sup is not None:
            sups[relpath] = sup
    if with_repo:
        for checker in repo:
            for f in checker.check_tree(root):
                # repo-level findings anchored in a source file (the
                # lock-composition checkers) honor that file's inline
                # allows like any per-file finding; README-anchored doc
                # lints have no suppression surface, as before
                sup = sups.get(f.path)
                if sup is not None and sup.hides(f):
                    suppressed.append(f)
                else:
                    findings.append(f)
    # the stale pass LAST, and only when this run exercised the full
    # registry (plus the repo checkers): a filtered run proves nothing
    # about the other checkers' suppressions and must not flag them
    full = {c.id for c in all_checkers()} <= {c.id for c in checkers}
    if full and with_repo:
        for relpath in sorted(sups):
            findings.extend(sups[relpath].stale_findings())
    return Report(findings, suppressed, files, list(checkers))
