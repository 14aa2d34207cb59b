"""T2: in-place state, the captured step's carry lives in static buffers.

A captured step (``runtime/graphs.py``) reads its carry from static input
tensors and must leave the next carry in the same tensors: a replay runs
the recorded kernels on the recorded addresses, and the Python of the step
never runs again.  The reference gets the same from ``donate_argnums``
(R2).  Four checks:

* **T2a** a capture root that is a method (``StepGraph.step``) rebinds no
  ``self.<attr>``: the rebinding happens once, at capture, and every
  replay keeps writing the tensor it replaced;
* **T2b** every carry a capture root binds from the step it calls
  (``state``, ``done``, ``rem``, ``cur_token``, ``hidden``, ``*_state``,
  ``*_cache``, ...) is read after it: a carry dropped there is never
  copied back into its static buffer, and the next replay starts from the
  stale one (``graphs.py``: the step "ends by copying each new value back
  into its static input");
* **T2c** nothing reachable from a capture root assigns a field of a
  carry (``cache.k = ...``): a carry's tensors are written in place
  (``copy_``, ``index_copy_``, ``x[...] = ...``) or a new carry is returned
  (``dataclasses.replace``);
* **T2d** a name handed to ``<graphs>.release(name)`` is not read after it
  in the same function: its graphs, and the K/V they adopted, are gone.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import callgraph
from repro_torch.analysis.core import Finding, Project, register_rule

_STATE_EXACT = {"state", "st", "cache", "carry", "pool", "kv", "kv_cache",
                "mem", "memory", "buf"}
_CARRY_EXTRA = {"done", "rem", "cur_token", "hidden"}


def statelike(name: str) -> bool:
    return name in _STATE_EXACT or \
        name.endswith(("_state", "_cache", "_pool", "_carry"))


def _names(target) -> List[ast.Name]:
    if isinstance(target, ast.Name):
        return [target]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _names(e)]
    if isinstance(target, ast.Starred):
        return _names(target.value)
    return []


def _loads_after(fn_node, name, line) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name and
               isinstance(n.ctx, ast.Load) and n.lineno > line
               for n in ast.walk(fn_node))


def _release_reads(f, fn_node, add) -> None:
    """T2d over one function."""
    calls = [n for n in ast.walk(fn_node) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == "release" and n.args
             and isinstance(n.args[0], ast.Name)]
    for call in calls:
        name = call.args[0].id
        end = getattr(call, "end_lineno", call.lineno)
        stores = [n.lineno for n in ast.walk(fn_node)
                  if isinstance(n, ast.Name) and n.id == name
                  and isinstance(n.ctx, ast.Store)]
        for n in sorted((n for n in ast.walk(fn_node)
                         if isinstance(n, ast.Name) and n.id == name
                         and isinstance(n.ctx, ast.Load)
                         and n.lineno > end), key=lambda n: n.lineno):
            if any(end < s <= n.lineno for s in stores):
                break
            add(f.rel, n.lineno,
                f"`{name}` is read after `release({name})` dropped its "
                f"graphs and the K/V they adopted")
            break


@register_rule(
    "T2",
    "in-place state: a captured step rebinds no attribute of its own, "
    "uses every carry it produces, assigns no field of a carry, and no "
    "state is read after its graphs were released")
def rule_inplace(project: Project) -> List[Finding]:
    idx = callgraph.get_index(project)
    out = {}

    def add(rel, line, msg):
        out[(rel, line, msg)] = Finding(path=rel, line=line, rule="T2",
                                        message=msg)

    for root in idx.roots:
        if root.cls is None or isinstance(root.node, ast.Lambda):
            continue
        qual = root.qualname
        for node in ast.walk(root.node):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Attribute) and \
                                isinstance(sub.value, ast.Name) and \
                                sub.value.id == "self" and \
                                isinstance(sub.ctx, ast.Store):
                            add(root.file.rel, sub.lineno,
                                f"captured `{qual}` rebinds `self."
                                f"{sub.attr}`: the capture runs it once, "
                                f"every replay keeps the old tensor")
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    for t in node.targets:
                        for n in _names(t):
                            if (statelike(n.id) or n.id in _CARRY_EXTRA) \
                                    and not _loads_after(root.node, n.id,
                                                         node.lineno):
                                add(root.file.rel, n.lineno,
                                    f"captured `{qual}` drops the carry "
                                    f"`{n.id}`: it is never copied back "
                                    f"into its static buffer")

    for fi in idx.reached_from_capture():
        for stmt in fi.body():
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                statelike(t.value.id):
                            add(fi.file.rel, t.lineno,
                                f"`{fi.qualname}` assigns field `{t.attr}` "
                                f"of the carry `{t.value.id}` inside a "
                                f"captured step: write its tensor in place "
                                f"or return a new carry")
                if isinstance(node, ast.Call) and \
                        (callgraph.dotted(node.func) or "") == "setattr" and \
                        node.args and isinstance(node.args[0], ast.Name) \
                        and statelike(node.args[0].id):
                    add(fi.file.rel, node.lineno,
                        f"`{fi.qualname}` sets a field of the carry "
                        f"`{node.args[0].id}` inside a captured step")

    for f in project.files:
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _release_reads(f, node, add)
    return list(out.values())
