"""``skew-safety`` — getattr/.get discipline on wire-crossing objects.

The wire contract (rpc/protocol.py, informal since PR 1): the
``Request``/``Response`` dataclasses grow EXTENSION fields over time, and
a version-skewed peer's pickle simply lacks the new ones — so any read of
an extension field must be a **defaulted** ``getattr`` (absent must mean
"default", never ``AttributeError``), and reads of the negotiated
envelope / Status payload dicts in ``rpc/`` and ``obs/`` must use
``.get`` (an old peer's envelope simply lacks the key). Writes are
exempt: mutating a locally constructed dataclass before sending it is
the send path, and our own class always has the field.

Detection is name-keyed, matching the codebase convention: objects named
``req``/``request`` are Requests, ``res``/``resp``/``response`` are
Responses, and ``envelope``/``reply``/``status``/``payload`` are wire
dicts. The extension-field sets are parsed out of ``rpc/protocol.py``'s
own AST (fields beyond the frozen Go-mirror base set), so adding a wire
field automatically extends the checker — no second registry to drift.

A ``["key"]`` read is accepted when the enclosing function guards the key
with ``"key" in <dict>`` — the membership test is the loud, deliberate
form of the same skew awareness.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Iterable, List

from .core import Checker, Finding

#: the frozen base fields — the stubs.go mirror (rpc/protocol.py): these
#: predate every peer version, so raw attribute reads are safe
REQUEST_BASE = frozenset({
    "world", "turns", "image_height", "image_width", "threads",
    "start_y", "end_y", "worker",
})
RESPONSE_BASE = frozenset({
    "alive", "alive_count", "turns_completed", "world", "work_slice",
    "worker",
})

#: fallback extension sets, used only when rpc/protocol.py is not
#: readable next to this package (fixture trees); the live set is parsed
#: from the dataclasses themselves
_FALLBACK_REQUEST_EXT = frozenset({
    "include_world", "initial_turn", "rulestring", "halo_depth",
    "trace_ctx", "session_id", "timeline_since",
})
_FALLBACK_RESPONSE_EXT = frozenset({
    "status", "trace_ctx", "edges", "counts", "digests",
})

REQUEST_NAMES = frozenset({"req", "request"})
RESPONSE_NAMES = frozenset({"res", "resp", "response"})
#: conventional names of dicts that crossed (or will cross) the wire
DICT_NAMES = frozenset({"envelope", "reply", "status", "payload"})
#: the dict rule applies where wire dicts live (the ISSUE contract:
#: envelope/Status dict reads in rpc/obs must use .get)
DICT_PATH_PARTS = frozenset({"rpc", "obs"})


def _dataclass_fields(tree: ast.Module, class_name: str) -> List[str]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            return [
                stmt.target.id
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ]
    return []


def wire_extension_fields():
    """``(request_ext, response_ext)`` parsed from rpc/protocol.py's own
    AST — every declared field beyond the frozen base sets."""
    proto = (
        pathlib.Path(__file__).resolve().parent.parent / "rpc" / "protocol.py"
    )
    try:
        tree = ast.parse(proto.read_text())
    except (OSError, SyntaxError):
        return _FALLBACK_REQUEST_EXT, _FALLBACK_RESPONSE_EXT
    req = frozenset(_dataclass_fields(tree, "Request")) - REQUEST_BASE
    res = frozenset(_dataclass_fields(tree, "Response")) - RESPONSE_BASE
    return (req or _FALLBACK_REQUEST_EXT), (res or _FALLBACK_RESPONSE_EXT)


class SkewSafetyChecker(Checker):
    id = "skew-safety"
    description = (
        "extension fields on Request/Response read via defaulted getattr; "
        "wire-dict keys in rpc/obs read via .get (or an explicit 'in' "
        "guard)"
    )
    bug_class = (
        "version-skew AttributeError/KeyError when an older peer's pickle "
        "lacks a field the reader assumes"
    )

    def __init__(self, request_ext=None, response_ext=None):
        if request_ext is None or response_ext is None:
            parsed_req, parsed_res = wire_extension_fields()
            request_ext = parsed_req if request_ext is None else request_ext
            response_ext = (
                parsed_res if response_ext is None else response_ext
            )
        self.request_ext = frozenset(request_ext)
        self.response_ext = frozenset(response_ext)

    # -- helpers ------------------------------------------------------------

    def _ext_fields_for(self, name: str):
        if name in REQUEST_NAMES:
            return self.request_ext
        if name in RESPONSE_NAMES:
            return self.response_ext
        return None

    @staticmethod
    def _in_guards(func_node) -> set:
        """Every ``("key", "name")`` membership test in the function —
        a read of a guarded key is deliberate, not skew-blind."""
        guards = set()
        for node in ast.walk(func_node):
            if not isinstance(node, ast.Compare):
                continue
            for op, comparator in zip(node.ops, node.comparators):
                if (
                    isinstance(op, (ast.In, ast.NotIn))
                    and isinstance(node.left, ast.Constant)
                    and isinstance(node.left.value, str)
                    and isinstance(comparator, ast.Name)
                ):
                    guards.add((node.left.value, comparator.id))
        return guards

    # -- the checker --------------------------------------------------------

    def check_file(self, tree, source, relpath) -> Iterable[Finding]:
        findings: List[Finding] = []
        dict_rule = bool(
            DICT_PATH_PARTS & set(pathlib.PurePosixPath(relpath).parts)
        )

        def check_node(node, guards):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
            ):
                ext = self._ext_fields_for(node.value.id)
                if ext is not None and node.attr in ext:
                    findings.append(Finding(
                        self.id, relpath, node.lineno,
                        f"raw read of extension field "
                        f"'{node.value.id}.{node.attr}' — use "
                        f"getattr({node.value.id}, {node.attr!r}, "
                        f"<default>): a version-skewed peer's pickle "
                        f"lacks the field",
                    ))
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Name)
                    and func.id == "getattr"
                    and len(node.args) == 2
                    and isinstance(node.args[0], ast.Name)
                    and isinstance(node.args[1], ast.Constant)
                ):
                    ext = self._ext_fields_for(node.args[0].id)
                    if ext is not None and node.args[1].value in ext:
                        findings.append(Finding(
                            self.id, relpath, node.lineno,
                            f"getattr({node.args[0].id}, "
                            f"{node.args[1].value!r}) has no default — "
                            f"it still raises on a version-skewed peer",
                        ))
            elif (
                dict_rule
                and isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id in DICT_NAMES
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)
            ):
                key, name = node.slice.value, node.value.id
                if (key, name) not in guards:
                    findings.append(Finding(
                        self.id, relpath, node.lineno,
                        f"unguarded {name}[{key!r}] read — use "
                        f"{name}.get({key!r}) or guard with "
                        f"'{key!r} in {name}' (skew-safe envelope "
                        f"contract)",
                    ))

        def visit(node, guards):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a function's membership guards cover its whole body
                # (closures inherit the enclosing function's guards)
                guards = guards | self._in_guards(node)
            check_node(node, guards)
            for child in ast.iter_child_nodes(node):
                visit(child, guards)

        visit(tree, frozenset())
        return findings
