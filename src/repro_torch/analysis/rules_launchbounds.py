"""T8: launch bounds of the CUDA grids, and each kernel wrapper's signature
against its plain version (the counterpart of R8).

The heavy lifting lives in ``repro_torch.analysis.launchbounds``: every
kernel of B1-B5 is modelled from the launch plans and evaluated, block by
block, over a matrix of shapes and cards, with the grids and launch
constants read from ``kernels/csrc``.  This rule surfaces each violation,
anchored at the kernel's wrapper, and holds each ``@Counted`` wrapper in
``kernels/`` to the plain version it runs on the CPU (``kernels/plain.py``,
``*_plain``): the same positional parameters in the same order, or every
kernel-against-plain comparison compares the wrong operands.  A plain
version no wrapper runs is a finding too.
"""
from __future__ import annotations

import ast
import hashlib
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis import launchbounds
from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.core import Finding, Project, register_rule

# the model's kernels -> (wrapper module, wrapper)
WRAPPERS = {"B1": ("kernels/verify_attention.py", "verify_attention"),
            "B2": ("kernels/paged_attention.py", "paged_tree_attention"),
            "B3": ("kernels/paged_attention.py", "paged_cache_attention"),
            "B4": ("kernels/tree_partial.py",
                   "sparse_tree_attention_partial"),
            "B5": ("kernels/tree_partial.py", "sparse_tree_attention")}

_VERIFIED: Dict[str, List[str]] = {}


def _verified(kernels: Path) -> List[str]:
    """``launchbounds.verify`` once per content of the sources it reads."""
    h = hashlib.sha256()
    for p in sorted((kernels / "csrc").glob("*.cu*")) + \
            [kernels / "plan.py"]:
        h.update(p.read_bytes())
    key = h.hexdigest()
    if key not in _VERIFIED:
        _VERIFIED[key] = launchbounds.verify(csrc=kernels / "csrc",
                                             kernels=kernels)
    return _VERIFIED[key]


def _pos_params(node) -> List[str]:
    a = node.args
    return [p.arg for p in a.posonlyargs + a.args]


def _counted(tree) -> List[ast.FunctionDef]:
    return [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and any((dotted(d) or "").split(".")[-1] == "Counted"
                    for d in n.decorator_list)]


def _anchor(project: Project, msg: str) -> Tuple[str, int]:
    for b, (module, name) in WRAPPERS.items():
        if msg.startswith(f"`{b} "):
            f = project.find(module)
            if f is not None:
                for n in f.tree.body:
                    if isinstance(n, ast.FunctionDef) and n.name == name:
                        return f.rel, n.lineno
                return f.rel, 1
    f = project.find("kernels/plan.py")
    return f.rel, 1


@register_rule(
    "T8",
    "launch bounds: the B1-B5 grids modelled from the launch plans and the "
    "CUDA sources' own grid expressions keep every block in bounds, tile "
    "every output once and walk only the row's pages; the launch "
    "constants match; each kernel wrapper's signature equals its plain "
    "version's")
def rule_launchbounds(project: Project) -> List[Finding]:
    out: List[Finding] = []
    plan = project.find("kernels/plan.py")
    if plan is not None and (plan.path.parent / "csrc").is_dir():
        for msg in _verified(plan.path.parent):
            rel, line = _anchor(project, msg)
            out.append(Finding(path=rel, line=line, rule="T8", message=msg))

    plain = project.find("kernels/plain.py")
    if plain is None:
        return out
    plains = {n.name: n for n in plain.tree.body
              if isinstance(n, ast.FunctionDef)
              and not n.name.startswith("_")}
    used = set()
    for f in project.files:
        if "kernels" not in Path(f.rel).parts:
            continue
        for fn in _counted(f.tree):
            calls = {dotted(c.func) for c in ast.walk(fn)
                     if isinstance(c, ast.Call)}
            mine = sorted(c for c in calls if c in plains)
            if not mine:
                out.append(Finding(
                    path=f.rel, line=fn.lineno, rule="T8",
                    message=f"kernel wrapper `{fn.name}` runs no plain "
                            f"version of kernels/plain.py on the CPU"))
                continue
            for name in mine:
                used.add(name)
                wp, pp = _pos_params(fn), _pos_params(plains[name])
                if wp != pp:
                    out.append(Finding(
                        path=f.rel, line=fn.lineno, rule="T8",
                        message=f"kernel wrapper `{fn.name}` takes {wp}, its "
                                f"plain version `{name}` {pp}: every "
                                f"comparison of the two compares other "
                                f"operands"))
    for name, node in plains.items():
        if name not in used:
            out.append(Finding(
                path=plain.rel, line=node.lineno, rule="T8",
                message=f"plain version `{name}` belongs to no kernel "
                        f"wrapper"))
    return out
