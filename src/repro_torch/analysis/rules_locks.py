"""T4: lock and thread discipline of the serving plane (the port's copy
of R4).

The port's serving plane has the reference's split: an asyncio event loop
(submit, cancel, health) and a worker thread that owns the scheduler
(``runtime/server.py``), replicas behind a router (``runtime/router.py``),
and a process-wide capture lock (``runtime/graphs.py::_CAPTURE_LOCK``).
Two static checks keep it honest:

**T4a (guarded attributes).**  Any ``self.X`` *mutated* inside a ``with
self._lock:`` block is lock-guarded; every other access to it (read or
write, in any method but ``__init__``) must hold the lock too.

**T4b (worker ownership).**  A class that spawns
``threading.Thread(target=self._run)`` gives the worker sole ownership of
``self.scheduler`` / ``self.engine``: only methods reachable from the
worker entry (plus ``__init__`` and the spawning method, which run before
the thread exists) may touch them, and a module that uses such a class
(the router) never reaches through ``.scheduler`` of another object.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.core import Finding, Project, register_rule

_MUTATORS = {"append", "appendleft", "extend", "add", "remove", "discard",
             "pop", "popleft", "popitem", "clear", "update", "insert",
             "put", "put_nowait", "setdefault", "sort", "reverse"}
_OWNED_ATTRS = {"scheduler", "engine"}


def _lockish(attr: str) -> bool:
    return "lock" in attr or attr in ("_mu", "_cv", "_cond", "_mutex")


def _with_locks(node) -> bool:
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and _lockish(expr.attr):
            return True
    return False


class _Access:
    __slots__ = ("attr", "write", "locked", "line", "method")

    def __init__(self, attr, write, locked, line, method):
        self.attr, self.write = attr, write
        self.locked, self.line, self.method = locked, line, method


def _collect_accesses(cls_node) -> List[_Access]:
    out: List[_Access] = []

    def visit(node, locked: bool, method: str):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = locked or _with_locks(node)
            for item in node.items:
                visit(item.context_expr, locked, method)
            for child in node.body:
                visit(child, inner, method)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                base = t
                if isinstance(base, ast.Subscript):
                    base = base.value
                if isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id == "self" and not _lockish(base.attr):
                    out.append(_Access(base.attr, True, locked,
                                       base.lineno, method))
            visit(node.value, locked, method)
            if isinstance(node, ast.AugAssign):
                return
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    visit(t.slice, locked, method)
            return
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            base = node.func.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and not _lockish(base.attr):
                out.append(_Access(base.attr, True, locked,
                                   base.lineno, method))
                for a in node.args:
                    visit(a, locked, method)
                for k in node.keywords:
                    visit(k.value, locked, method)
                return
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and not _lockish(node.attr):
            out.append(_Access(node.attr, False, locked,
                               node.lineno, method))
            return
        for child in ast.iter_child_nodes(node):
            visit(child, locked, method)

    for m in cls_node.body:
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for stmt in m.body:
                visit(stmt, False, m.name)
    return out


def _thread_entries(cls_node) -> Set[str]:
    """Names of methods handed to threading.Thread(target=self.X)."""
    entries: Set[str] = set()
    for node in ast.walk(cls_node):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is not None and d.split(".")[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target" and \
                            isinstance(kw.value, ast.Attribute) and \
                            isinstance(kw.value.value, ast.Name) and \
                            kw.value.value.id == "self":
                        entries.add(kw.value.attr)
    return entries


def _spawning_methods(cls_node) -> Set[str]:
    out: Set[str] = set()
    for m in cls_node.body:
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _thread_entries_in(m):
                out.add(m.name)
    return out


def _thread_entries_in(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = dotted(sub.func)
            if d is not None and d.split(".")[-1] == "Thread":
                return True
    return False


def _worker_closure(cls_node, entries: Set[str]) -> Set[str]:
    """entries + every self-method transitively called from them."""
    methods = {m.name: m for m in cls_node.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    reached = set()
    work = [e for e in entries if e in methods]
    while work:
        name = work.pop()
        if name in reached:
            continue
        reached.add(name)
        for sub in ast.walk(methods[name]):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id == "self" and \
                    sub.func.attr in methods:
                work.append(sub.func.attr)
    return reached


@register_rule(
    "T4",
    "lock discipline: lock-guarded attributes never touched off-lock; "
    "worker-owned scheduler never reached from the event loop")
def rule_locks(project: Project) -> List[Finding]:
    out: List[Finding] = []
    seen = set()

    def add(rel, line, msg):
        if (rel, line, msg) not in seen:
            seen.add((rel, line, msg))
            out.append(Finding(path=rel, line=line, rule="T4", message=msg))

    threaded_classes: Set[str] = set()
    class_nodes = []            # (file, cls_node)
    for f in project.files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                class_nodes.append((f, node))
                if _thread_entries(node):
                    threaded_classes.add(node.name)

    for f, cls_node in class_nodes:
        accesses = _collect_accesses(cls_node)
        # T4a: guarded = mutated under lock anywhere in the class
        guarded = {a.attr for a in accesses if a.write and a.locked}
        for a in accesses:
            if a.attr in guarded and not a.locked and \
                    a.method != "__init__":
                verb = "written" if a.write else "read"
                add(f.rel, a.line,
                    f"`self.{a.attr}` is lock-guarded (mutated under "
                    f"`self._lock`) but {verb} off-lock in "
                    f"`{cls_node.name}.{a.method}`")
        # T4b: worker-owned attrs only from the worker closure
        entries = _thread_entries(cls_node)
        if entries:
            allowed = _worker_closure(cls_node, entries) | {"__init__"} \
                | _spawning_methods(cls_node)
            for a in accesses:
                if a.attr in _OWNED_ATTRS and a.method not in allowed:
                    add(f.rel, a.line,
                        f"worker-owned `self.{a.attr}` reached from "
                        f"`{cls_node.name}.{a.method}` (event-loop side; "
                        f"only the worker thread may touch it — publish "
                        f"a snapshot instead)")

    # T4b cross-object: modules that use a thread-owning class must not
    # reach through `.scheduler` of another object at all
    for f in project.files:
        uses_threaded = False
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ImportFrom):
                if any(a.name in threaded_classes for a in node.names):
                    uses_threaded = True
        if not uses_threaded:
            continue
        for f2, cls_node in class_nodes:
            if f2 is not f or cls_node.name in threaded_classes:
                continue
            for m in cls_node.body:
                if not isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    continue
                for sub in ast.walk(m):
                    if isinstance(sub, ast.Attribute) and \
                            sub.attr == "scheduler" and \
                            not (isinstance(sub.value, ast.Name)
                                 and sub.value.id == "self"):
                        add(f.rel, sub.lineno,
                            f"`{cls_node.name}.{m.name}` reaches through "
                            f"`.scheduler` of a worker-owned replica — "
                            f"cross-thread audits must use the server's "
                            f"published snapshot")
    return out
