"""T6: slot-protocol conformance between the engines and the scheduler
(the port's copy of R6).

``runtime/continuous.py`` drives engines purely through ``sched_*``
methods.  The required set is scraped from that module's own call sites (a
direct ``eng.sched_x(...)`` call is a hard requirement; a
``getattr(eng, "sched_x", default)`` / ``hasattr`` probe marks an optional
extension); with no ``continuous.py`` in the project, from every file.  It
is then held against the declared ``SchedulableEngine`` Protocol
(``runtime/engine.py``):

* every public class exposing *any* ``sched_*`` method (directly or by
  inheritance) implements the full required set: a partial engine passes
  construction and dies at the first boundary that calls the missing slot;
* the Protocol declares every scraped-required method, so the typed
  contract never lags the scheduler's actual use.

Private mix-ins (``_Foo``) and Protocol classes themselves are exempt.
"""
from __future__ import annotations

import ast
from typing import List, Set, Tuple

from repro_torch.analysis import callgraph
from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.core import Finding, Project, register_rule


SCHEDULER_FILE = "continuous.py"


def _scrape(files) -> Tuple[Set[str], Set[str]]:
    required: Set[str] = set()
    optional: Set[str] = set()
    for f in files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr.startswith("sched_"):
                required.add(node.func.attr)
            d = dotted(node.func)
            if d in ("getattr", "hasattr") and len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Constant) and \
                    isinstance(node.args[1].value, str) and \
                    node.args[1].value.startswith("sched_"):
                optional.add(node.args[1].value)
    required -= optional
    return required, optional


@register_rule(
    "T6",
    "slot-protocol conformance: engines exposing sched_* implement the "
    "full set the scheduler calls, matching the SchedulableEngine "
    "Protocol")
def rule_protocol(project: Project) -> List[Finding]:
    idx = callgraph.get_index(project)
    out: List[Finding] = []

    def add(rel, line, msg):
        out.append(Finding(path=rel, line=line, rule="T6", message=msg))

    sched_files = [f for f in project.files
                   if f.rel.endswith(SCHEDULER_FILE)]
    scrape_from = sched_files or project.files
    required, optional = _scrape(scrape_from)
    if not required:
        return out

    protocols = []              # (ClassInfo, member-name set)
    engines = []                # (ClassInfo, all-method set, own sched_*)
    for mod in idx.modules.values():
        for ci in mod.classes.values():
            is_protocol = any(b.split(".")[-1] == "Protocol"
                              for b in ci.base_names)
            methods = set(idx.class_methods(ci))
            sched = {m for m in methods if m.startswith("sched_")}
            if is_protocol:
                if sched:
                    protocols.append((ci, methods))
                continue
            if ci.name.startswith("_"):
                continue
            if sched:
                engines.append((ci, methods))

    for ci, methods in engines:
        missing = sorted(required - methods)
        if missing:
            add(ci.file.rel, ci.node.lineno,
                f"engine `{ci.name}` exposes sched_* but is missing "
                f"{missing} — required by runtime/continuous.py call "
                f"sites (optional extensions: {sorted(optional)})")

    for ci, members in protocols:
        undeclared = sorted(required - members)
        if undeclared:
            add(ci.file.rel, ci.node.lineno,
                f"scheduler call sites require {undeclared} but Protocol "
                f"`{ci.name}` does not declare them — the typed contract "
                f"lags the scheduler's actual usage")
    return out
