"""Whole-program lock composition: order cycles, TOCTOU, blocking holds.

``locks.py`` proves each individual access is guarded; nothing there
proves the locks COMPOSE. A dozen cooperating threads per process
(probe/readmission, the SessionScheduler driver, the timeline sampler,
canary/loadgen daemons, RPC reader threads) interact through nested
acquisitions, and the two worst historical bug classes here were
concurrency bugs (PR 8's deque-mutated-during-iteration Status race,
PR 9's unlocked ``_strip_turn`` read). This module machine-checks the
composition, three ways:

* ``lock-order`` — the repo-wide lock-acquisition graph: every
  ``with self.<lock>`` block, ``Condition`` aliases folded onto their
  underlying lock, ``# gol: holds(..)`` caller contracts seeding the
  held-set, and intra-repo call edges traversed (a helper called under
  lock A that takes lock B contributes the A→B edge, including through
  a typed attribute like ``self._table.admit(...)``). A cycle in that
  graph is a deadlock waiting for its interleaving; the finding carries
  the full witness path, file:line per edge. Re-entering a
  NON-reentrant lock (directly or through a call chain) is the
  one-node cycle and is reported the same way.
* ``atomicity`` — the TOCTOU shape behind the PR 9 bug: a guarded field
  read under its lock, the lock released, then the SAME field written
  under a later acquisition of that lock in the same method, with the
  write depending on a local carrying the stale read. Check-then-act
  must happen in ONE critical section (or be justified: the
  single-driver-thread contract is the legitimate exception, and it is
  a suppression with a reason, not silence). Per-file, intraprocedural.
* ``blocking-under-lock`` — a blocking call (``sendall``/``recv``,
  ``Event.wait``, RPC ``call``, ``sleep``, ``join``, future
  ``result``...) made while holding a lock that a HOT PATH also takes
  (the engine turn loop, ``SessionTable.advance``, the worker's
  ``strip_step``/``update`` handlers — ``HOT_METHODS``). One stalled
  socket then wedges the serving loop for every tenant. Waiting on a
  ``Condition`` that wraps the held lock is exempt — that wait
  RELEASES it.

Resolution is deliberately bounded: ``self.method()``, typed attributes
(``self._x = ClassName(...)`` / ``self._x: ClassName``), locals assigned
from either, and repo-unique class names. Module-attribute objects
(``_ins.FOO.inc()``) and untyped parameters don't resolve — the checkers
under-approximate rather than guess, and the runtime sanitizer
(``utils/locksan.py``) covers the dynamically-dispatched remainder.

``lock-order`` and ``blocking-under-lock`` are repo-level checkers (the
graph spans modules); ``atomicity`` is a per-file checker. All three
respect the standard ``# gol: allow(<check>): <why>`` suppressions at
the finding's anchor line.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from .core import (
    Checker, Finding, iter_python_files, is_generated, rel_base,
)
from .locks import guard_map, parse_holds

#: methods whose transitive lock set defines the HOT locks: the engine
#: turn loop (`Engine.run`, the broker backends' `run`/turn loops reached
#: from it), the session batch driver, the worker compute handlers, the
#: sampler tick, and the flight recorder's per-event append
HOT_METHODS = frozenset({
    "advance", "update", "strip_step", "run", "sample_once", "record",
})

#: attribute calls that park the calling thread (socket/IPC, thread
#: joins, future results, sleeps, RPC round-trips)
BLOCKING_ATTRS = frozenset({
    "sendall", "sendto", "recv", "recv_into", "recvfrom", "accept",
    "connect", "wait", "join", "sleep", "result", "call",
})

#: bare-name calls that block (the rpc/protocol.py frame helpers)
BLOCKING_NAMES = frozenset({
    "send_frame", "recv_frame", "recv_frame_sized", "sleep",
})

#: traversal bound: deeper call chains than this stop contributing edges
#: (the repo's real chains are <= 4 deep; the cap guards fixture cycles)
MAX_DEPTH = 10


# -- the per-tree model -------------------------------------------------------


class _ClassModel:
    """One class's lock surface: which attributes ARE locks (with
    ``Condition`` wrappers folded onto the lock they wrap), which are
    reentrant, the ``_GUARDED_BY`` field map, attribute types, and the
    method table with ``holds(..)`` seeds."""

    def __init__(self, name: str, relpath: str):
        self.name = name
        self.relpath = relpath
        self.canon: Dict[str, str] = {}        # lock attr -> canonical attr
        self.reentrant: set = set()            # canonical attrs that re-enter
        self.guards: Dict[str, FrozenSet[str]] = {}
        self.attr_types: Dict[str, str] = {}   # self.<attr> -> class name
        self.methods: Dict[str, Tuple[ast.AST, FrozenSet[str]]] = {}

    def lock_key(self, attr: str) -> Optional[str]:
        base = self.canon.get(attr)
        if base is None:
            return None
        return f"{self.relpath}:{self.name}.{base}"

    def display(self, attr: str) -> str:
        return f"{self.name}.{self.canon.get(attr, attr)}"


def _call_name(call: ast.Call) -> Tuple[str, str]:
    """``(receiver name, callee name)`` — receiver '' for bare names."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name):
            return f.value.id, f.attr
        return "?", f.attr
    if isinstance(f, ast.Name):
        return "", f.id
    return "?", ""


def _self_attr_arg(call: ast.Call, index: int) -> Optional[str]:
    """The attr name when positional arg ``index`` is ``self.<attr>``."""
    if len(call.args) > index:
        a = call.args[index]
        if (
            isinstance(a, ast.Attribute)
            and isinstance(a.value, ast.Name)
            and a.value.id == "self"
        ):
            return a.attr
    return None


def _lock_creation(call: ast.Call) -> Optional[Tuple[str, Optional[str]]]:
    """Classify a lock-constructing call: ``("lock"|"rlock", None)`` or
    ``("cond", wrapped self-attr | None)``. Recognizes both the raw
    ``threading`` constructors and the ``utils/locksan`` factories that
    replace them under ``GOL_LOCKSAN=1`` — the static model must not go
    blind the moment the dynamic sanitizer is wired in."""
    base, name = _call_name(call)
    if base in ("threading", ""):
        if name == "Lock":
            return ("lock", None)
        if name == "RLock":
            return ("rlock", None)
        if name == "Condition":
            return ("cond", _self_attr_arg(call, 0))
    if base.lstrip("_") == "locksan":
        if name == "lock":
            return ("lock", None)
        if name == "rlock":
            return ("rlock", None)
        if name == "condition":
            return ("cond", _self_attr_arg(call, 1))
    return None


def _build_class(cls: ast.ClassDef, lines: List[str],
                 relpath: str) -> _ClassModel:
    model = _ClassModel(cls.name, relpath)
    own: Dict[str, Tuple[str, Optional[str]]] = {}
    for node in ast.walk(cls):
        target = None
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            continue
        if isinstance(value, ast.Call):
            kind = _lock_creation(value)
            if kind is not None:
                own[target.attr] = kind
                continue
            base, name = _call_name(value)
            if name and name[0].isupper():
                model.attr_types[target.attr] = name
        # `self._x: ClassName` / `self._x: "ClassName"` (the quoted form
        # is how a back-reference to a later class annotates)
        if isinstance(node, ast.AnnAssign):
            ann = None
            if isinstance(node.annotation, ast.Name):
                ann = node.annotation.id
            elif isinstance(node.annotation, ast.Constant) and isinstance(
                node.annotation.value, str
            ):
                ann = node.annotation.value
            if ann and ann[:1].isupper() and ann.isidentifier():
                model.attr_types.setdefault(target.attr, ann)
    # canonicalize: a Condition aliases the lock it wraps; a Condition
    # over its own implicit lock is its own (reentrant) node
    for attr, (kind, wrapped) in own.items():
        if kind == "cond" and wrapped is not None and wrapped in own:
            model.canon[attr] = wrapped
        else:
            model.canon[attr] = attr
            if kind in ("rlock", "cond"):
                model.reentrant.add(attr)
    model.guards, _problems = guard_map(cls, lines, relpath, "lock-order")
    # guard declarations may name locks constructed in ways the scan
    # above cannot see (injected, inherited): register them as plain
    # non-reentrant locks so guarded-field regions still resolve
    for names in model.guards.values():
        for n in names:
            model.canon.setdefault(n, n)
    # fold guard aliases: a field guarded by ('_lock', '_cond') where
    # _cond wraps _lock collapses to the canonical lock
    model.guards = {
        f: frozenset(model.canon.get(n, n) for n in names)
        for f, names in model.guards.items()
    }
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            held: FrozenSet[str] = frozenset()
            if stmt.lineno <= len(lines):
                names, _problem = parse_holds(lines[stmt.lineno - 1])
                if names:
                    held = frozenset(
                        model.canon.get(n, n) for n in names
                    )
            model.methods[stmt.name] = (stmt, held)
    return model


class _TreeModel:
    """Every class in the tree, plus a by-name index for resolving
    constructor calls (``SessionTable(...)``) and typed attributes
    across modules. Ambiguous names (two classes, one name) resolve to
    nothing — under-approximate, never guess."""

    def __init__(self):
        self.classes: Dict[Tuple[str, str], _ClassModel] = {}
        self.by_name: Dict[str, Optional[_ClassModel]] = {}

    def add(self, model: _ClassModel) -> None:
        self.classes[(model.relpath, model.name)] = model
        if model.name in self.by_name:
            self.by_name[model.name] = None  # ambiguous
        else:
            self.by_name[model.name] = model

    def resolve(self, name: str) -> Optional[_ClassModel]:
        return self.by_name.get(name)


_MODEL_CACHE: Dict[Tuple, _TreeModel] = {}


def build_model(root) -> _TreeModel:
    """Parse the tree once per (content) state; both repo checkers and
    repeated runs share the result."""
    root = pathlib.Path(root).resolve()
    base = rel_base(root)
    files = []
    for path in iter_python_files(root):
        try:
            stat = path.stat()
        except OSError:
            continue
        files.append((path, stat.st_mtime_ns, stat.st_size))
    key = (str(root), tuple(
        (str(p), m, s) for p, m, s in files
    ))
    cached = _MODEL_CACHE.get(key)
    if cached is not None:
        return cached
    model = _TreeModel()
    for path, _m, _s in files:
        try:
            source = path.read_text(encoding="utf-8", errors="replace")
            tree = ast.parse(source)
        except (OSError, SyntaxError, ValueError):
            continue  # the walker already reports parse failures loudly
        if is_generated(source):
            continue
        relpath = path.relative_to(base).as_posix()
        lines = source.splitlines()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                model.add(_build_class(node, lines, relpath))
    _MODEL_CACHE.clear()  # one live tree at a time: tests churn tmp dirs
    _MODEL_CACHE[key] = model
    return model


# -- the traversal ------------------------------------------------------------


class _Edge:
    __slots__ = ("src", "dst", "relpath", "line", "context")

    def __init__(self, src, dst, relpath, line, context):
        self.src, self.dst = src, dst
        self.relpath, self.line, self.context = relpath, line, context

    @property
    def site(self) -> str:
        return f"{self.relpath}:{self.line}"


class _Block:
    """One blocking call observed with locks held."""

    __slots__ = ("desc", "relpath", "line", "context", "held")

    def __init__(self, desc, relpath, line, context, held):
        self.desc, self.relpath, self.line = desc, relpath, line
        self.context, self.held = context, held


class _Walker:
    """Simulates every method with a held-lock list, emitting acquisition
    edges, reentry findings, and blocking events. Call edges resolve via
    the tree model; a (class, method, held-set) state is visited once."""

    def __init__(self, model: _TreeModel, follow_unheld: bool = False):
        self.model = model
        self.follow_unheld = follow_unheld
        self.edges: Dict[Tuple[str, str], _Edge] = {}
        self.reentries: List[Finding] = []
        self.blocks: List[_Block] = []
        self.acquired: set = set()
        self._seen: set = set()

    # held: ordered tuple of (lock key, display, reentrant)
    def run_method(self, cls: _ClassModel, meth: str, held=()):
        node, holds = cls.methods.get(meth, (None, frozenset()))
        if node is None:
            return
        for attr in sorted(holds):
            key = cls.lock_key(attr)
            if key is not None and key not in {h[0] for h in held}:
                held = held + ((key, cls.display(attr),
                                attr in cls.reentrant),)
        state = (cls.relpath, cls.name, meth,
                 frozenset(h[0] for h in held))
        if state in self._seen or len(held) > MAX_DEPTH:
            return
        self._seen.add(state)
        env: Dict[str, str] = {}  # local name -> class name
        self._walk(node.body, cls, f"{cls.name}.{meth}", held, env)

    def _walk(self, stmts, cls, context, held, env):
        for stmt in stmts:
            self._stmt(stmt, cls, context, held, env)

    def _stmt(self, node, cls, context, held, env):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs run later, with nothing held
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                ce = item.context_expr
                self._expr(ce, cls, context, new_held, env)
                attr = self._self_lock(ce, cls)
                if attr is None:
                    continue
                key = cls.lock_key(attr)
                held_keys = {h[0] for h in new_held}
                if key in held_keys:
                    if cls.canon.get(attr, attr) not in cls.reentrant:
                        self.reentries.append(Finding(
                            "lock-order", cls.relpath, ce.lineno,
                            f"'{context}' re-acquires non-reentrant lock "
                            f"'{cls.display(attr)}' while already holding "
                            f"it — with threading.Lock this deadlocks the "
                            f"thread against itself (use RLock or "
                            f"restructure)",
                        ))
                    continue
                for h_key, h_disp, _re in new_held:
                    self.edges.setdefault(
                        (h_key, key),
                        _Edge(h_key, key, cls.relpath, ce.lineno, context),
                    )
                self.acquired.add(key)
                new_held = new_held + (
                    (key, cls.display(attr),
                     cls.canon.get(attr, attr) in cls.reentrant),
                )
            self._walk(node.body, cls, context, new_held, env)
            return
        # track trivially-typed locals: v = self.attr / v = ClassName(...)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
            isinstance(node.targets[0], ast.Name)
        ):
            t = self._expr_type(node.value, cls, env)
            if t is not None:
                env[node.targets[0].id] = t
            else:
                env.pop(node.targets[0].id, None)
            self._expr(node.value, cls, context, held, env)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, cls, context, held, env)
            elif isinstance(child, ast.stmt):
                self._stmt(child, cls, context, held, env)
            else:
                # handlers/withitems/comprehension innards: recurse for
                # nested statements and expressions
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.expr):
                        self._expr(sub, cls, context, held, env)
                    elif isinstance(sub, ast.stmt):
                        self._stmt(sub, cls, context, held, env)

    def _expr(self, node, cls, context, held, env):
        # hand-rolled walk: a lambda body (thread target, callback) runs
        # LATER with nothing held — ast.walk would descend into it and
        # charge its calls against the definition site's held set
        todo = [node]
        while todo:
            n = todo.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                self._call(n, cls, context, held, env)
            todo.extend(ast.iter_child_nodes(n))

    def _call(self, call, cls, context, held, env):
        target = self._resolve(call, cls, env)
        if target is not None:
            callee_cls, callee_meth = target
            if held or self.follow_unheld:
                self.run_method(callee_cls, callee_meth, held)
            return
        if not held:
            return
        base, name = _call_name(call)
        blocking = (
            (base == "" and name in BLOCKING_NAMES)
            or (base != "" and name in BLOCKING_ATTRS)
        )
        if not blocking:
            return
        # str.join / " ".join(...) noise: only flag attribute calls on
        # names/attributes, never on literals or call results
        if isinstance(call.func, ast.Attribute) and not isinstance(
            call.func.value, (ast.Name, ast.Attribute)
        ):
            return
        if name == "wait" and self._waits_on_held(call, cls, held, env):
            return  # Condition.wait releases the lock it wraps
        recv = f"{base}." if base and base != "?" else ""
        self.blocks.append(_Block(
            f"{recv}{name}()", cls.relpath, call.lineno, context, held,
        ))

    def _waits_on_held(self, call, cls, held, env) -> bool:
        f = call.func
        if not (isinstance(f, ast.Attribute) and f.attr == "wait"):
            return False
        v = f.value
        attr = None
        if (
            isinstance(v, ast.Attribute)
            and isinstance(v.value, ast.Name)
            and v.value.id == "self"
        ):
            attr = v.attr
        elif isinstance(v, ast.Name):
            # a local alias of a self lock: `cond = self._work`
            t = env.get(v.id)
            if t and t.startswith("lockattr:"):
                attr = t[len("lockattr:"):]
        if attr is None:
            return False
        key = cls.lock_key(attr)
        return key is not None and key in {h[0] for h in held}

    def _self_lock(self, expr, cls) -> Optional[str]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in cls.canon
        ):
            return expr.attr
        return None

    def _expr_type(self, value, cls, env) -> Optional[str]:
        if (
            isinstance(value, ast.Attribute)
            and isinstance(value.value, ast.Name)
            and value.value.id == "self"
        ):
            if value.attr in cls.canon:
                return f"lockattr:{value.attr}"
            return cls.attr_types.get(value.attr)
        if isinstance(value, ast.Call):
            base, name = _call_name(value)
            if name and name[0].isupper() and self.model.resolve(name):
                return name
        if isinstance(value, ast.Name):
            return env.get(value.id)
        return None

    def _resolve(self, call, cls, env):
        """``(class model, method name)`` for calls the model can type."""
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        v = f.value
        if isinstance(v, ast.Name):
            if v.id == "self":
                if f.attr in cls.methods:
                    return cls, f.attr
                return None
            t = env.get(v.id)
            if t and not t.startswith("lockattr:"):
                m = self.model.resolve(t)
                if m is not None and f.attr in m.methods:
                    return m, f.attr
            return None
        if (
            isinstance(v, ast.Attribute)
            and isinstance(v.value, ast.Name)
            and v.value.id == "self"
        ):
            t = cls.attr_types.get(v.attr)
            if t:
                m = self.model.resolve(t)
                if m is not None and f.attr in m.methods:
                    return m, f.attr
        return None


def _walk_tree(model: _TreeModel, follow_unheld: bool = False,
               entries=None) -> _Walker:
    walker = _Walker(model, follow_unheld=follow_unheld)
    for (relpath, name) in sorted(model.classes):
        cls = model.classes[(relpath, name)]
        for meth in cls.methods:
            if entries is not None and meth not in entries:
                continue
            walker.run_method(cls, meth)
    return walker


# -- checkers -----------------------------------------------------------------


class LockOrderChecker(Checker):
    id = "lock-order"
    description = (
        "the repo-wide lock-acquisition graph (with-blocks, Condition "
        "aliases, holds(..) contracts, intra-repo call edges) is acyclic "
        "and no non-reentrant lock is re-entered"
    )
    bug_class = (
        "ABBA deadlocks between cooperating threads; self-deadlock on "
        "a re-entered threading.Lock"
    )

    def check_tree(self, root) -> Iterable[Finding]:
        model = build_model(root)
        walker = _walk_tree(model)
        findings: List[Finding] = list(walker.reentries)
        findings.extend(self._cycles(walker.edges))
        return findings

    def _cycles(self, edges: Dict[Tuple[str, str], _Edge]):
        adj: Dict[str, List[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        for dsts in adj.values():
            dsts.sort()
        reported: set = set()
        for start in sorted(adj):
            if start in reported:
                continue
            cycle = self._shortest_cycle(start, adj)
            if cycle is None:
                continue
            if any(n in reported for n in cycle):
                continue
            reported.update(cycle)
            witness = []
            for a, b in zip(cycle, cycle[1:] + cycle[:1]):
                e = edges[(a, b)]
                witness.append(
                    f"{_disp(a)} -> {_disp(b)} at {e.site} "
                    f"(in {e.context})"
                )
            first = edges[(cycle[0], cycle[1] if len(cycle) > 1
                           else cycle[0])]
            yield Finding(
                self.id, first.relpath, first.line,
                "lock-order cycle (deadlock under the wrong "
                "interleaving): " + "; ".join(witness),
            )

    @staticmethod
    def _shortest_cycle(start: str, adj) -> Optional[List[str]]:
        # path-carrying BFS from start back to start (the graph is a
        # handful of lock nodes; clarity beats parent-pointer surgery)
        from collections import deque

        q = deque([(n, [start, n]) for n in adj.get(start, ())])
        seen = set()
        while q:
            node, path = q.popleft()
            if node == start:
                return path[:-1]  # [start, ..., predecessor-of-start]
            if node in seen:
                continue
            seen.add(node)
            for nxt in adj.get(node, ()):
                q.append((nxt, path + [nxt]))
        return None


def _disp(key: str) -> str:
    # 'rpc/broker.py:SessionScheduler._lock' -> 'SessionScheduler._lock'
    return key.split(":", 1)[1] if ":" in key else key


class BlockingUnderLockChecker(Checker):
    id = "blocking-under-lock"
    description = (
        "no blocking call (socket send/recv, Event.wait, RPC call, "
        "sleep, join, future result) runs while holding a lock a hot "
        "path (engine turn loop, SessionTable.advance, worker "
        "update/strip_step) also takes"
    )
    bug_class = (
        "one stalled peer wedging the serving hot loop for every "
        "session behind a shared lock"
    )

    def check_tree(self, root) -> Iterable[Finding]:
        model = build_model(root)
        # pass 1: the hot-lock set — every lock reachable from a hot
        # entry method (call edges followed even with nothing held),
        # remembering WHICH hot entry reaches it for the message
        hot: Dict[str, str] = {}
        for (relpath, name) in sorted(model.classes):
            cls = model.classes[(relpath, name)]
            for meth in sorted(set(cls.methods) & HOT_METHODS):
                w = _Walker(model, follow_unheld=True)
                w.run_method(cls, meth)
                for key in w.acquired:
                    hot.setdefault(key, f"{name}.{meth}")
        # pass 2: blocking events anywhere in the tree
        walker = _walk_tree(model)
        for b in walker.blocks:
            held_hot = [
                (key, disp) for key, disp, _re in b.held if key in hot
            ]
            if not held_hot:
                continue
            key, disp = held_hot[-1]
            yield Finding(
                self.id, b.relpath, b.line,
                f"'{b.context}' calls blocking '{b.desc}' while holding "
                f"'{disp}', which the hot path '{hot[key]}' also takes — "
                f"one stalled call wedges that loop",
            )


class AtomicityChecker(Checker):
    """Per-file: the read-release-write TOCTOU on ``_GUARDED_BY`` fields
    (module docstring). Intra-method, dataflow-gated: the later locked
    write must LOAD a local assigned from a guarded read in an earlier
    region of the same lock, and the written field must have been read
    in an earlier region — three conditions, so single-region code and
    independent writes stay quiet."""

    id = "atomicity"
    description = (
        "a _GUARDED_BY field read under its lock is not re-written "
        "under a LATER acquisition in the same method from a local "
        "carrying the stale read (check-then-act spans a lock release)"
    )
    bug_class = (
        "TOCTOU on guarded state: the PR 9 unlocked _strip_turn shape — "
        "decide under the lock, act after it, another thread moved first"
    )

    def check_file(self, tree, source, relpath) -> Iterable[Finding]:
        lines = source.splitlines()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(node, lines, relpath)

    def _check_class(self, cls, lines, relpath):
        model = _build_class(cls, lines, relpath)
        if not model.guards:
            return
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in ("__init__", "__new__"):
                continue
            yield from self._check_method(stmt, model, relpath)

    def _check_method(self, fn, model, relpath):
        # linear walk; state threads through nested/compound statements
        st = {
            "closed_reads": {},   # canonical lock -> set of fields read
            "stale": {},          # local -> (field, read_line)
            "findings": [],
        }
        self._walk(fn.body, model, fn.name, (), st, relpath)
        return st["findings"]

    def _walk(self, stmts, model, meth, held, st, relpath):
        for s in stmts:
            self._stmt(s, model, meth, held, st, relpath)

    def _stmt(self, node, model, meth, held, st, relpath):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                ce = item.context_expr
                if (
                    isinstance(ce, ast.Attribute)
                    and isinstance(ce.value, ast.Name)
                    and ce.value.id == "self"
                    and ce.attr in model.canon
                ):
                    canon = model.canon[ce.attr]
                    if canon not in held:
                        acquired.append(canon)
            region = {"reads": set(), "stale": {}}
            regions = st.setdefault("open", [])
            if acquired:
                regions.append((frozenset(acquired), region))
            self._walk(node.body, model, meth,
                       held + tuple(acquired), st, relpath)
            if acquired:
                regions.pop()
                for lock in acquired:
                    st["closed_reads"].setdefault(lock, set()).update(
                        region["reads"]
                    )
                st["stale"].update(region["stale"])
            return
        if isinstance(node, ast.stmt) and not isinstance(
            node, (ast.If, ast.For, ast.AsyncFor, ast.While, ast.Try,
                   ast.With, ast.AsyncWith)
        ):
            self._simple(node, model, meth, held, st, relpath)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, model, meth, held, st, relpath)
            elif isinstance(child, (ast.ExceptHandler,)):
                self._walk(child.body, model, meth, held, st, relpath)

    # -- one simple statement ------------------------------------------------

    _MUTATORS = frozenset({
        "append", "appendleft", "extend", "insert", "add", "discard",
        "remove", "pop", "popleft", "popitem", "clear", "update",
        "setdefault",
    })

    def _simple(self, node, model, meth, held, st, relpath):
        guards = model.guards
        open_regions = st.get("open", [])
        # loads of stale locals in this statement
        loaded = {
            n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
        }
        stale_used = sorted(set(st["stale"]) & loaded)
        # guarded-field reads and writes in this statement
        reads, writes = self._field_touches(node, guards)
        held_set = frozenset(held)
        for field, line in writes:
            locks = guards[field] & held_set
            if not locks:
                continue  # unlocked writes are locks.py's finding
            prior = [
                lock for lock in guards[field]
                if field in st["closed_reads"].get(lock, ())
            ]
            if prior and stale_used:
                local, (rfield, rline) = (
                    stale_used[0], st["stale"][stale_used[0]]
                )
                st["findings"].append(Finding(
                    "atomicity", relpath, line,
                    f"'{meth}' reads guarded 'self.{field}' under its "
                    f"lock, releases it, then writes 'self.{field}' "
                    f"under a LATER acquisition using stale local "
                    f"'{local}' (read from 'self.{rfield}' at line "
                    f"{rline}) — another thread can interleave between "
                    f"the regions; do the check and the act in one "
                    f"critical section or justify the driver contract",
                ))
        # record reads + stale-local candidates into the open regions
        for _locks, region in open_regions:
            for field, _line in reads:
                if guards[field] & _locks:
                    region["reads"].add(field)
        # assignment targets: rebinding kills staleness; a guarded-read
        # assign inside a region creates new stale candidates at close
        targets = self._name_targets(node)
        for t in targets:
            st["stale"].pop(t, None)
        if targets and reads and open_regions:
            _locks, region = open_regions[-1]
            field, line = reads[0]
            if guards[field] & _locks:
                for t in targets:
                    region["stale"][t] = (field, line)

    @staticmethod
    def _name_targets(node) -> List[str]:
        targets = []
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and isinstance(
                        n.ctx, ast.Store
                    ):
                        targets.append(n.id)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(node.target, ast.Name):
                targets.append(node.target.id)
        return targets

    def _field_touches(self, node, guards):
        """``(reads, writes)`` of guarded ``self.<field>`` in one simple
        statement: plain loads are reads; Store/Del contexts, augmented
        assigns, subscript stores, and mutator-method calls are writes
        (pop/popitem also read — they return guarded state)."""
        reads: List[Tuple[str, int]] = []
        writes: List[Tuple[str, int]] = []

        def field_of(expr):
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in guards
            ):
                return expr.attr
            return None

        for n in ast.walk(node):
            f = field_of(n)
            if f is None:
                continue
            ctx = getattr(n, "ctx", None)
            if isinstance(ctx, (ast.Store, ast.Del)):
                writes.append((f, n.lineno))
            else:
                reads.append((f, n.lineno))
        for n in ast.walk(node):
            # self.F[...] = x / del self.F[...]
            if isinstance(n, ast.Subscript) and isinstance(
                n.ctx, (ast.Store, ast.Del)
            ):
                f = field_of(n.value)
                if f is not None:
                    writes.append((f, n.lineno))
            # self.F.append(x) etc.
            if isinstance(n, ast.Call) and isinstance(
                n.func, ast.Attribute
            ) and n.func.attr in self._MUTATORS:
                f = field_of(n.func.value)
                if f is not None:
                    writes.append((f, n.lineno))
        if isinstance(node, ast.AugAssign):
            f = field_of(node.target)
            if f is not None:
                reads.append((f, node.target.lineno))
                writes.append((f, node.target.lineno))
        return reads, writes


def concurrency_repo_checkers() -> List[Checker]:
    """The repo-level composition checkers (the per-file
    :class:`AtomicityChecker` registers with the AST checkers)."""
    return [LockOrderChecker(), BlockingUnderLockChecker()]
