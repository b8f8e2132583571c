"""``lock-discipline`` — declared guarded fields touched only under lock.

The PR 8 review class this mechanises: a timeline ring iterated while a
sampler tick appended (``deque mutated during iteration``), an SLO
transition metered twice because two sites raced the rulebook. The
contract is declared IN the class, two equivalent ways:

* a class-level ``_GUARDED_BY = {"_ring": "_lock"}`` mapping (values may
  be a tuple when several context managers share the underlying lock —
  e.g. a ``threading.Condition`` wrapping it:
  ``{"_table": ("_lock", "_work")}``);
* a ``# guarded-by: _lock`` trailing comment on the field's assignment.

Any method that reads OR writes a guarded ``self.<field>`` outside a
``with self.<lock>`` block is flagged. ``__init__``/``__new__`` are
exempt (the object is not yet shared); a method whose ``def`` line
carries ``# gol: holds(_lock)`` — or a multi-lock contract like
``# gol: holds(_lock, _cond)`` — declares a caller-holds-the-lock(s)
contract and is treated as locked throughout (the Clang
``REQUIRES()`` idiom). A holds marker the checker cannot parse, or one
naming a lock the class never declares, is itself a LOUD finding: a
typo'd contract silently disabling enforcement is exactly the rot the
suppression-format rule exists to prevent. Nested functions and
lambdas — thread targets, callbacks — run later, so they start with NO
locks held even when defined inside a ``with`` block.

``guard_map`` and ``parse_holds`` are shared with ``lockorder.py`` (the
whole-program lock-composition checkers): one parser, one contract
syntax, no drift between the per-access and the cross-lock layers.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from .core import Checker, Finding

_COMMENT_GUARD_RE = re.compile(
    r"self\.(\w+)\s*[:=][^=].*#\s*guarded-by:\s*(\w+)"
)
#: loose probe: the marker is PRESENT (possibly malformed) on this line
_HOLDS_PROBE_RE = re.compile(r"#\s*gol:\s*holds\b")
#: strict form: '# gol: holds(_lock[, _cond...])'
_HOLDS_RE = re.compile(r"#\s*gol:\s*holds\(\s*([^)]*?)\s*\)")


def parse_holds(line: str) -> Tuple[Optional[FrozenSet[str]], Optional[str]]:
    """``(held lock names | None, parse problem | None)`` for one source
    line. ``(None, None)``: no marker. A marker that is present but
    unreadable — missing parens, empty list — returns a problem string
    so callers can report it loudly instead of silently holding nothing."""
    if not _HOLDS_PROBE_RE.search(line):
        return None, None
    m = _HOLDS_RE.search(line)
    if m is None:
        return None, (
            "unparsable holds marker — write "
            "'# gol: holds(<lock>[, <lock>...])'"
        )
    names = frozenset(s.strip() for s in m.group(1).split(",") if s.strip())
    if not names:
        return None, "holds() names no lock"
    bad = sorted(n for n in names if not n.isidentifier())
    if bad:
        return None, (
            f"holds() names {bad[0]!r}, which is not a plain lock "
            f"attribute name (write the attribute, e.g. holds(_lock))"
        )
    return names, None


def _literal_names(node) -> List[str]:
    """String / tuple-of-strings literal -> lock names."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [
            e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        ]
    return []


def guard_map(
    cls: ast.ClassDef, lines: List[str], relpath: str, check_id: str
) -> Tuple[Dict[str, FrozenSet[str]], List[Finding]]:
    """``(field -> lock names, declaration problems)`` for one class: the
    ``_GUARDED_BY`` mapping plus ``# guarded-by:`` trailing comments. A
    binding the parser cannot read is a loud finding, never a
    silently-disabled contract. Shared by the per-access checker below
    and the whole-program composition checkers (lockorder.py)."""
    guards: Dict[str, FrozenSet[str]] = {}
    problems: List[Finding] = []
    for stmt in cls.body:
        # plain or annotated (`_GUARDED_BY: ClassVar[dict] = {...}`)
        # declaration — an annotation must not silently disable the
        # whole contract
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        else:
            continue
        if not (
            len(targets) == 1
            and isinstance(targets[0], ast.Name)
            and targets[0].id == "_GUARDED_BY"
        ):
            continue
        if not isinstance(stmt.value, ast.Dict):
            problems.append(Finding(
                check_id, relpath, stmt.lineno,
                f"_GUARDED_BY on class '{cls.name}' is not a literal "
                f"{{'field': 'lock'}} dict — the checker cannot read "
                f"it, so the whole lock contract would be silently "
                f"ignored",
            ))
            continue
        for key, value in zip(stmt.value.keys, stmt.value.values):
            names = _literal_names(value)
            if (
                isinstance(key, ast.Constant)
                and isinstance(key.value, str)
                and names
            ):
                guards[key.value] = frozenset(names)
            else:
                problems.append(Finding(
                    check_id, relpath, stmt.lineno,
                    f"_GUARDED_BY entry on class '{cls.name}' is not "
                    f"a string field mapped to a string (or tuple of "
                    f"strings) lock name — entry ignored",
                ))
    end = cls.end_lineno or cls.lineno
    for lineno in range(cls.lineno, min(end, len(lines)) + 1):
        m = _COMMENT_GUARD_RE.search(lines[lineno - 1])
        if m:
            guards[m.group(1)] = guards.get(
                m.group(1), frozenset()
            ) | {m.group(2)}
    return guards, problems


class LockDisciplineChecker(Checker):
    id = "lock-discipline"
    description = (
        "fields declared in _GUARDED_BY (or '# guarded-by: <lock>') are "
        "touched only inside 'with self.<lock>'"
    )
    bug_class = (
        "shared-state races: collections mutated during iteration, "
        "double-counted transitions, torn read/write pairs"
    )

    def check_file(self, tree, source, relpath) -> Iterable[Finding]:
        findings: List[Finding] = []
        lines = source.splitlines()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, lines, relpath))
        return findings

    # -- per-class ----------------------------------------------------------

    def _check_class(
        self, cls: ast.ClassDef, lines: List[str], relpath: str
    ) -> Iterable[Finding]:
        guards, problems = guard_map(cls, lines, relpath, self.id)
        yield from problems
        if not guards:
            return
        lock_names = frozenset().union(*guards.values())
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in ("__init__", "__new__"):
                continue
            if not stmt.args.args or stmt.args.args[0].arg != "self":
                continue
            held: FrozenSet[str] = frozenset()
            if stmt.lineno <= len(lines):
                names, problem = parse_holds(lines[stmt.lineno - 1])
                if problem is not None:
                    # a holds contract the checker cannot read would
                    # otherwise silently hold NOTHING — every guarded
                    # access below it then flags, burying the real
                    # mistake; report the marker itself and exempt the
                    # body (the loud finding already fails the run)
                    yield Finding(
                        self.id, relpath, stmt.lineno,
                        f"'{stmt.name}' carries a {problem}",
                    )
                    held = lock_names
                elif names is not None:
                    unknown = sorted(names - lock_names)
                    if unknown:
                        yield Finding(
                            self.id, relpath, stmt.lineno,
                            f"'{stmt.name}' declares holds({unknown[0]}) "
                            f"but class '{cls.name}' guards nothing with "
                            f"'{unknown[0]}' (known locks: "
                            f"{', '.join(sorted(lock_names))}) — a typo'd "
                            f"contract would silently hold nothing",
                        )
                        held = names | lock_names
                    else:
                        held = names
            for body_stmt in stmt.body:
                yield from self._scan(
                    body_stmt, held, guards, lock_names, relpath, stmt.name
                )

    def _scan(
        self, node, held, guards, lock_names, relpath, method
    ) -> Iterable[Finding]:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set(held)
            for item in node.items:
                ce = item.context_expr
                # the lock expression itself is evaluated un-held
                yield from self._scan(
                    ce, held, guards, lock_names, relpath, method
                )
                if (
                    isinstance(ce, ast.Attribute)
                    and isinstance(ce.value, ast.Name)
                    and ce.value.id == "self"
                    and ce.attr in lock_names
                ):
                    acquired.add(ce.attr)
            for child in node.body:
                yield from self._scan(
                    child, frozenset(acquired), guards, lock_names,
                    relpath, method,
                )
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested function runs LATER (thread target, callback):
            # whatever lock the definition site holds is long released
            for child in node.body:
                yield from self._scan(
                    child, frozenset(), guards, lock_names, relpath,
                    f"{method}.{node.name}",
                )
            return
        if isinstance(node, ast.Lambda):
            yield from self._scan(
                node.body, frozenset(), guards, lock_names, relpath,
                f"{method}.<lambda>",
            )
            return
        if isinstance(node, ast.ClassDef):
            return
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in guards
            and not (guards[node.attr] & held)
        ):
            locks = " / ".join(sorted(guards[node.attr]))
            yield Finding(
                self.id, relpath, node.lineno,
                f"'{method}' touches guarded field 'self.{node.attr}' "
                f"outside 'with self.{locks}' (declared guarded-by "
                f"{locks})",
            )
        for child in ast.iter_child_nodes(node):
            yield from self._scan(
                child, held, guards, lock_names, relpath, method
            )
