"""``hygiene`` — daemonised/joined threads, no silently-swallowed excepts.

Two resource-lifecycle contracts:

1. **Threads.** A ``threading.Thread``/``Timer`` must either be created
   ``daemon=True`` (it may never outlive the process) or be provably
   joined: bound to a name on which ``.join(`` is called somewhere in
   the same file. An un-daemonised, un-joined thread wedges interpreter
   shutdown — the broker/worker processes are long-lived servers where
   one leaked thread turns SIGTERM into SIGKILL.

2. **Excepts.** A broad handler (bare ``except:``, ``except Exception``,
   ``except BaseException``) whose body performs NO call, NO raise and
   NO return swallows the failure without leaving evidence — no log
   line, no flight-recorder event, no propagation. The chaos/integrity
   layers exist precisely because silent failure is the worst failure
   mode; a handler that narrows the type, logs, flight-records,
   re-raises, or returns a sentinel all pass.

3. **Executors.** A ``ThreadPoolExecutor``/``ProcessPoolExecutor`` must
   be context-managed (``with ...Executor(...) as pool``) or have a
   provable in-file ``shutdown`` call on its bound name, same
   owning-scope rule as the thread join proof. A leaked pool is the
   thread leak multiplied by its worker count — the RpcClient-pool
   class of bug: the broker's scatter pool outliving its run wedges
   shutdown exactly like one un-joined thread, times ``pool_size``.

4. **GC callbacks.** A file that registers a collector hook
   (``gc.callbacks.append(...)``) must also unregister one
   (``gc.callbacks.remove(...)``) somewhere in the same file. The
   process-global ``gc.callbacks`` list outlives every object: an
   append with no paired remove keeps the callback — and everything
   its closure holds — alive for the life of the interpreter, and
   fires it on collections long after the owner was "closed" (the
   profiler's GC pause meter is exactly this shape; obs/profiler.py
   pairs install_gc with remove_gc).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from .core import Checker, Finding

_THREAD_FACTORIES = frozenset({"Thread", "Timer"})
_EXECUTOR_FACTORIES = frozenset({"ThreadPoolExecutor", "ProcessPoolExecutor"})
_BROAD = frozenset({"Exception", "BaseException"})


def _is_thread_call(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute):
        return (
            func.attr in _THREAD_FACTORIES
            and isinstance(func.value, ast.Name)
            and func.value.id == "threading"
        )
    return isinstance(func, ast.Name) and func.id in _THREAD_FACTORIES


def _is_executor_call(node: ast.Call) -> bool:
    # bare name, or any dotted form ending in the factory
    # (concurrent.futures.ThreadPoolExecutor, futures.ThreadPoolExecutor)
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr in _EXECUTOR_FACTORIES
    return isinstance(func, ast.Name) and func.id in _EXECUTOR_FACTORIES


def _target_name(target) -> str:
    if isinstance(target, ast.Name):
        return target.id
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return f"self.{target.attr}"
    return ""


def _broad_type(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id in _BROAD for e in t.elts
        )
    return False


class HygieneChecker(Checker):
    id = "hygiene"
    description = (
        "threads are daemon=True or joined in-file; executors are "
        "context-managed or shut down in-file; gc.callbacks.append is "
        "paired with a remove in-file; broad except handlers "
        "log/flight-record/raise/return instead of silently swallowing"
    )
    bug_class = (
        "leaked threads/pools wedging process shutdown; gc callbacks "
        "registered forever; failures vanishing with no log, flight "
        "event, or propagation"
    )

    def check_file(self, tree, source, relpath) -> Iterable[Finding]:
        findings: List[Finding] = []
        self._check_threads(tree, relpath, findings)
        self._check_executors(tree, relpath, findings)
        self._check_gc_callbacks(tree, relpath, findings)
        self._check_excepts(tree, relpath, findings)
        return findings

    # -- threads -------------------------------------------------------------

    def _check_threads(self, tree, relpath, findings) -> None:
        parents = {
            child: parent
            for parent in ast.walk(tree)
            for child in ast.iter_child_nodes(parent)
        }
        bound: dict = {}  # id(call node) -> bound name
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = getattr(node, "value", None)
                if isinstance(value, ast.Call) and _is_thread_call(value):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        name = _target_name(t)
                        if name:
                            bound[id(value)] = name

        def enclosing(node, kinds):
            cur = parents.get(node)
            while cur is not None and not isinstance(cur, kinds):
                cur = parents.get(cur)
            return cur if cur is not None else tree

        joins_cache: dict = {}

        def joins_in(scope) -> Set[str]:
            cached = joins_cache.get(id(scope))
            if cached is None:
                cached = joins_cache[id(scope)] = {
                    name
                    for sub in ast.walk(scope)
                    if isinstance(sub, ast.Attribute) and sub.attr == "join"
                    for name in (_target_name(sub.value),)
                    if name
                }
            return cached

        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and _is_thread_call(node)):
                continue
            daemon = next(
                (kw for kw in node.keywords if kw.arg == "daemon"), None
            )
            if daemon is not None:
                if (
                    isinstance(daemon.value, ast.Constant)
                    and daemon.value.value is False
                ):
                    pass  # explicit daemon=False: fall through to join proof
                else:
                    continue
            name = bound.get(id(node))
            if name:
                # the join must live in the scope that OWNS the binding:
                # the enclosing class for self.X (created in one method,
                # joined in another), the enclosing function for locals —
                # a same-named '_thread' joined in a DIFFERENT class is
                # no proof for this one
                scope = enclosing(
                    node,
                    ast.ClassDef
                    if name.startswith("self.")
                    else (ast.FunctionDef, ast.AsyncFunctionDef),
                )
                if name in joins_in(scope):
                    continue
            factory = _func_name(node)
            findings.append(Finding(
                self.id, relpath, node.lineno,
                f"{factory} created without daemon=True and never joined "
                f"in its owning scope — a leaked non-daemon thread wedges "
                f"process shutdown",
            ))

    # -- executors -----------------------------------------------------------

    def _check_executors(self, tree, relpath, findings) -> None:
        """Executor discipline mirrors the thread rule: context-managed
        (``with`` owns the shutdown) or a ``shutdown`` call on the bound
        name in its owning scope — class scope for ``self.X``, function
        scope for locals."""
        parents = {
            child: parent
            for parent in ast.walk(tree)
            for child in ast.iter_child_nodes(parent)
        }

        def enclosing(node, kinds):
            cur = parents.get(node)
            while cur is not None and not isinstance(cur, kinds):
                cur = parents.get(cur)
            return cur if cur is not None else tree

        bound: dict = {}  # id(call node) -> bound name
        managed: set = set()  # id(call node) of with-managed executors
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = getattr(node, "value", None)
                if isinstance(value, ast.Call) and _is_executor_call(value):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        name = _target_name(t)
                        if name:
                            bound[id(value)] = name
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call) and (
                        _is_executor_call(item.context_expr)
                    ):
                        managed.add(id(item.context_expr))

        def shutdowns_in(scope):
            return {
                name
                for sub in ast.walk(scope)
                if isinstance(sub, ast.Attribute) and sub.attr == "shutdown"
                for name in (_target_name(sub.value),)
                if name
            }

        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and _is_executor_call(node)):
                continue
            if id(node) in managed:
                continue
            name = bound.get(id(node))
            if name:
                scope = enclosing(
                    node,
                    ast.ClassDef
                    if name.startswith("self.")
                    else (ast.FunctionDef, ast.AsyncFunctionDef),
                )
                if name in shutdowns_in(scope):
                    continue
            factory = _func_name(node)
            findings.append(Finding(
                self.id, relpath, node.lineno,
                f"{factory} is neither context-managed nor shut down in "
                f"its owning scope — a leaked pool is pool_size un-joined "
                f"threads wedging process shutdown",
            ))

    # -- gc callbacks --------------------------------------------------------

    def _check_gc_callbacks(self, tree, relpath, findings) -> None:
        """Registration pairing on the process-global collector-hook
        list: every ``gc.callbacks.append(...)`` needs SOME
        ``gc.callbacks.remove(...)`` in the same file. File-level (not
        owning-scope) on purpose: install/uninstall conventionally live
        in different functions of one module (install_gc/remove_gc), and
        the global list means a remove anywhere genuinely discharges the
        leak — unlike a thread join, which must name its thread."""
        appends: List[ast.Call] = []
        has_remove = False
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _gc_callbacks_op(node)
            if kind == "append":
                appends.append(node)
            elif kind == "remove":
                has_remove = True
        if has_remove:
            return
        for node in appends:
            findings.append(Finding(
                self.id, relpath, node.lineno,
                "gc.callbacks.append without any gc.callbacks.remove in "
                "this file — the process-global hook list keeps the "
                "callback (and its closure) alive and firing on every "
                "collection after the owner is closed",
            ))

    # -- excepts -------------------------------------------------------------

    def _check_excepts(self, tree, relpath, findings) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _broad_type(node):
                continue
            # handled = the failure leaves evidence or control flow:
            # a call (log/flight-record/metric), a raise, a return — or
            # the bound exception VALUE is read (captured into state the
            # caller inspects: the checkpoint agreement-vote pattern)
            handled = any(
                isinstance(sub, (ast.Call, ast.Raise, ast.Return))
                or (
                    node.name is not None
                    and isinstance(sub, ast.Name)
                    and sub.id == node.name
                    and isinstance(sub.ctx, ast.Load)
                )
                for stmt in node.body
                for sub in ast.walk(stmt)
            )
            if not handled:
                what = (
                    "bare except:" if node.type is None
                    else "broad except"
                )
                findings.append(Finding(
                    self.id, relpath, node.lineno,
                    f"{what} swallows the failure silently (no call, "
                    f"raise, or return in the handler) — log it, "
                    f"flight-record it, narrow the type, or justify the "
                    f"suppression",
                ))


def _gc_callbacks_op(node: ast.Call) -> str:
    """'append' / 'remove' when the call is ``gc.callbacks.append(...)``
    or ``gc.callbacks.remove(...)``; '' otherwise."""
    func = node.func
    if (
        isinstance(func, ast.Attribute)
        and func.attr in ("append", "remove")
        and isinstance(func.value, ast.Attribute)
        and func.value.attr == "callbacks"
        and isinstance(func.value.value, ast.Name)
        and func.value.value.id == "gc"
    ):
        return func.attr
    return ""


def _func_name(node: ast.Call) -> str:
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in _THREAD_FACTORIES:
            return f"threading.{func.attr}"
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return "Thread"
