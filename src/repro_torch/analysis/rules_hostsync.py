"""T3: the host-sync budget of the decode hot path (the port's copy of R3).

The port's performance contract is the reference's: ONE host sync per
chunk boundary, one ``torch.cat([...]).cpu()`` of the chunk's tokens,
counts, done mask and budgets.  Any other sync inside the runtime's hot
functions (``generate``, ``boundary``, ``sched_step``, ``sched_emitted``,
``step_chunk`` under a ``runtime/`` directory) serializes host and device:

* ``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()`` on a tensor,
  ``torch.cuda.synchronize()``;
* numpy's copying constructors on a device value (``np.asarray``, ...);
* an ``if``/``while`` whose test calls ``torch.*`` or ``.any()``/``.all()``
  (an implicit ``Tensor.__bool__``).

Wall-clock ``time.time()`` is flagged everywhere (it is not monotonic):
measured intervals use ``time.perf_counter()``.  Benchmark and test files
are allowlisted for the sync checks (there the sync is the measurement).
The budgeted boundary syncs carry ``# torchlint: disable=T3`` markers with
their reason, which keeps them grep-able.
"""
from __future__ import annotations

import ast
from pathlib import PurePath
from typing import List

from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.core import Finding, Project, SourceFile, \
    register_rule

HOT_FUNCS = {"generate", "boundary", "sched_step", "sched_emitted",
             "step_chunk"}
_NP_SYNC = {"asarray", "array", "copyto", "ascontiguousarray", "copy"}
_TORCH_SYNC = {"cpu", "item", "tolist", "numpy"}


def allowlisted(rel: str) -> bool:
    parts = PurePath(rel).parts
    name = parts[-1] if parts else rel
    return bool(set(parts[:-1]) & {"tests", "benchmarks"}) or \
        name.startswith(("test_", "bench_")) or name.endswith("_bench.py")


def _numpy_alias(f: SourceFile) -> set:
    out = set()
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "numpy":
                    out.add(a.asname or "numpy")
    return out


def _tensor_bool(test, np_names) -> bool:
    for t in ast.walk(test):
        if isinstance(t, ast.Call):
            d = dotted(t.func) or ""
            if d.split(".")[0] in np_names:
                continue
            if d.startswith("torch.") or (isinstance(t.func, ast.Attribute)
                                          and t.func.attr in ("any", "all")):
                return True
    return False


@register_rule(
    "T3",
    "host-sync budget: one .cpu() sync per chunk in the runtime's hot "
    "functions (no other .cpu/.item/.tolist/.numpy/np.asarray/"
    "torch.cuda.synchronize/tensor bool there); time.perf_counter for "
    "measured intervals")
def rule_hostsync(project: Project) -> List[Finding]:
    out: List[Finding] = []

    def add(rel, line, msg):
        out.append(Finding(path=rel, line=line, rule="T3", message=msg))

    for f in project.files:
        allow = allowlisted(f.rel)
        np_names = _numpy_alias(f)
        in_runtime = "runtime" in PurePath(f.rel).parts
        if not allow:
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Call) and \
                        dotted(node.func) == "time.time":
                    add(f.rel, node.lineno,
                        "wall-clock time.time() feeds a measured interval "
                        "— use time.perf_counter() (suppress if an "
                        "absolute timestamp is intended)")
        if allow or not in_runtime:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name not in HOT_FUNCS:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    d = dotted(sub.func)
                    if d and d.split(".")[0] in np_names and \
                            d.split(".")[-1] in _NP_SYNC and sub.args and \
                            not isinstance(sub.args[0],
                                           (ast.List, ast.Tuple,
                                            ast.Constant, ast.ListComp,
                                            ast.GeneratorExp)):
                        add(f.rel, sub.lineno,
                            f"host sync `{d}(...)` in hot path "
                            f"`{node.name}` — one sync per chunk boundary "
                            f"is the budget (suppress if this IS the "
                            f"boundary sync)")
                    elif d == "torch.cuda.synchronize" or (
                            isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in _TORCH_SYNC and not sub.args
                            and not (d or "").split(".")[0] in np_names):
                        what = d if d == "torch.cuda.synchronize" else \
                            f".{sub.func.attr}()"
                        add(f.rel, sub.lineno,
                            f"host sync `{what}` in hot path `{node.name}` "
                            f"— one sync per chunk boundary is the budget "
                            f"(suppress if this IS the boundary sync)")
                if isinstance(sub, (ast.If, ast.While)) and \
                        _tensor_bool(sub.test, np_names):
                    add(f.rel, sub.lineno,
                        f"implicit tensor __bool__ in hot path "
                        f"`{node.name}` blocks on the device")
    return out
