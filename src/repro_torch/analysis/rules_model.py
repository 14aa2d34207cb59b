"""T9: the boundary protocol of the port's scheduler (the port's copy of
R9).

Two layers:

1. **Static protocol order** of ``runtime/continuous.py``'s
   ``ContinuousScheduler`` (a class with ``boundary``/``fail_all``/
   ``submit``/``abort``): ``boundary()`` runs the abort sweep
   (``self._apply_aborts``) BEFORE any admission (``policy.pick``), so the
   pages it frees can fund a same-boundary admission, never the reverse;
   and ``fail_all()`` drains ``self._pending``, or a boundary after the
   crash would admit onto a dead replica.

2. **Bounded exhaustive model check** (``repro_torch.analysis.
   modelcheck``): the host model of the protocol explored over every
   interleaving of ``submit``/``abort``/``boundary``/crash for the default
   bound.  Any invariant violation becomes a finding carrying its
   counterexample trace.  The exploration runs once per process, and only
   when the project holds exactly one implementation of the protocol.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import modelcheck
from repro_torch.analysis.core import Finding, Project, register_rule

_PROTOCOL_METHODS = {"boundary", "fail_all", "submit", "abort"}
SCHEDULER_FILE = "continuous.py"

# the exploration is project-independent (it checks the protocol model
# against its invariants), so one run per process serves every caller
_EXPLORED: Optional[modelcheck.ExploreResult] = None


def _protocol_class(tree) -> Optional[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) \
                and node.name == "ContinuousScheduler":
            methods = {n.name for n in node.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            if _PROTOCOL_METHODS <= methods:
                return node
    return None


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}


def _self_calls(fn: ast.FunctionDef, attr: str) -> List[ast.Call]:
    """Document-ordered ``self.<attr>(...)`` / ``<x>.<attr>(...)`` calls."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == attr:
            out.append(node)
    return sorted(out, key=lambda n: (n.lineno, n.col_offset))


def _drains_pending(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "_pending" \
                        and isinstance(node.value, (ast.List, ast.Tuple)) \
                        and not node.value.elts:
                    return True
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "clear" \
                and isinstance(node.func.value, ast.Attribute) \
                and node.func.value.attr == "_pending":
            return True
    return False


def _static_findings(rel: str, cls: ast.ClassDef) -> List[Finding]:
    out: List[Finding] = []
    m = _methods(cls)
    boundary, fail_all = m["boundary"], m["fail_all"]
    sweeps = _self_calls(boundary, "_apply_aborts")
    picks = _self_calls(boundary, "pick")
    if not sweeps:
        out.append(Finding(
            path=rel, line=boundary.lineno, rule="T9",
            message="boundary() never runs the abort sweep "
                    "(no _apply_aborts call) — cancellations and "
                    "deadline expiries can never take effect"))
    elif picks and (picks[0].lineno, picks[0].col_offset) < \
            (sweeps[0].lineno, sweeps[0].col_offset):
        out.append(Finding(
            path=rel, line=boundary.lineno, rule="T9",
            message="boundary() admits (policy.pick) BEFORE the abort "
                    "sweep — an aborted row's pages are released too "
                    "late for a same-boundary admission to reuse them "
                    "(release-before-admission protocol order)"))
    if not _drains_pending(fail_all):
        out.append(Finding(
            path=rel, line=fail_all.lineno, rule="T9",
            message="fail_all() does not drain self._pending — a "
                    "boundary after the crash would admit queued "
                    "requests onto a dead replica"))
    return out


def _model_findings(rel: str, cls: ast.ClassDef) -> List[Finding]:
    global _EXPLORED
    if _EXPLORED is None:
        _EXPLORED = modelcheck.explore(
            modelcheck.DEFAULT_REQUESTS, modelcheck.DEFAULT_CONFIG,
            max_seconds=60.0)
    m = _methods(cls)
    anchor = m["boundary"].lineno
    out: List[Finding] = []
    if not _EXPLORED.complete:
        out.append(Finding(
            path=rel, line=anchor, rule="T9",
            message="model check did not finish inside its wall-clock "
                    "cap — the documented interleaving bound is "
                    "unverified"))
    for path, msg in _EXPLORED.violations[:10]:
        out.append(Finding(
            path=rel, line=anchor, rule="T9",
            message=f"model check: {msg} "
                    f"[trace: {modelcheck.render_trace(path)}]"))
    return out


@register_rule(
    "T9",
    "boundary-protocol model checker: static release-before-admission / "
    "queue-drain conformance on the scheduler, plus bounded exhaustive "
    "interleaving exploration of the protocol model (pages, terminals, "
    "ordering, crash safety)")
def rule_model(project: Project) -> List[Finding]:
    out: List[Finding] = []
    hits: List[Tuple[str, ast.ClassDef]] = []
    for f in project.files:
        if not f.rel.endswith(SCHEDULER_FILE):
            continue
        cls = _protocol_class(f.tree)
        if cls is not None:
            hits.append((f.rel, cls))
    for rel, cls in hits:
        out.extend(_static_findings(rel, cls))
    # the exploration is about the protocol itself: run it once, anchored
    # at the (unique) implementation when the project carries one
    if len(hits) == 1:
        out.extend(_model_findings(*hits[0]))
    return out
