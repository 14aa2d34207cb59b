"""T7: capture hygiene, graphs and plans are built once and keyed by host
data (the counterpart of R7, the retrace and compile-cache audit).

The port's compile cache is ``ChunkGraphs``: one captured step per key,
a capture at a key's second chunk and replays after it.  A graph, a graph
cache, a launch-plan cache (``launch.Plans``) or a ``torch.compile`` built
in a loop or in a hot method starts from empty on every call, so every
chunk pays a capture (or a compile) again; and a key that holds a tensor,
a fresh lambda or a dict hashes by identity (or not at all), so no key
ever repeats.  Checks:

* **T7a** no ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
  ``ChunkGraphs(...)``, ``Plans(...)`` or ``torch.compile(...)`` inside a
  ``for``/``while`` body or inside a hot method (``generate``,
  ``sched_step``, ``run_chunk``, ``_run_chunk``, ``boundary``,
  ``step_chunk``);
* **T7b** a graph key (a function named ``key`` or ``*_key`` that returns
  a tuple) holds only hashable host data: no lambda, no dict, list or set
  (literal, comprehension or call), no parameter passed as it is unless it
  has a constant default or a host annotation (``str``, ``int``, ...), and
  no attribute that names a tensor field of the project's dataclasses.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.core import Finding, Project, register_rule
from repro_torch.analysis.rules_walker import dataclasses_of

HOT = {"generate", "sched_step", "run_chunk", "_run_chunk", "boundary",
       "step_chunk"}
_BUILDERS = {"torch.cuda.CUDAGraph", "torch.cuda.graph", "torch.compile",
             "ChunkGraphs", "Plans"}
_HOST_ANN = {"str", "int", "bool", "float", "tuple", "bytes"}
_FRESH = (ast.Lambda, ast.Dict, ast.List, ast.Set, ast.DictComp,
          ast.ListComp, ast.SetComp)


def _builder(call: ast.Call) -> str:
    d = dotted(call.func) or ""
    for b in _BUILDERS:
        if d == b or d.endswith("." + b):
            return b
    return ""


def _walk_builds(node, in_loop, hot, fn_name, rel, add):
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _walk_builds(child, False, child.name in HOT, child.name, rel,
                         add)
            continue
        if isinstance(child, ast.Lambda):
            continue
        loop = in_loop or isinstance(child, (ast.For, ast.While,
                                             ast.AsyncFor))
        if isinstance(child, ast.Call):
            b = _builder(child)
            if b and (in_loop or hot):
                where = "a loop" if in_loop else f"hot method `{fn_name}`"
                add(rel, child.lineno,
                    f"`{b}` built inside {where}: every call starts an "
                    f"empty cache and pays the capture again (build it "
                    f"once, outside)")
        _walk_builds(child, loop, hot, fn_name, rel, add)


def _key_functions(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                (node.name == "key" or node.name.endswith("_key")):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and \
                        isinstance(sub.value, ast.Tuple):
                    yield node, sub.value


def _host_params(fn) -> set:
    a = fn.args
    pos = a.posonlyargs + a.args
    out = set()
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if isinstance(d, ast.Constant):
            out.add(p.arg)
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if isinstance(d, ast.Constant):
            out.add(p.arg)
    for p in pos + a.kwonlyargs:
        if p.annotation is not None and \
                ast.unparse(p.annotation) in _HOST_ANN:
            out.add(p.arg)
    return out


@register_rule(
    "T7",
    "capture hygiene: no CUDA graph, ChunkGraphs, Plans or torch.compile "
    "built in a loop or a hot method; a graph key holds hashable host "
    "data only (no tensor, lambda, dict/list/set or bare object)")
def rule_capture_hygiene(project: Project) -> List[Finding]:
    out = {}

    def add(rel, line, msg):
        out[(rel, line, msg)] = Finding(path=rel, line=line, rule="T7",
                                        message=msg)

    classes = dataclasses_of(project)
    tensor_attrs = {f for dc in classes.values() for f in dc.tensor_fields}
    host_attrs = {f for dc in classes.values()
                  for f in set(dc.fields) - dc.tensor_fields}
    tensor_attrs -= host_attrs
    for f in project.files:
        _walk_builds(f.tree, False, False, "", f.rel, add)
        for fn, tup in _key_functions(f.tree):
            params = {p.arg for p in fn.args.posonlyargs + fn.args.args
                      + fn.args.kwonlyargs} - {"self", "cls"}
            host = _host_params(fn)
            for el in tup.elts:
                what = None
                if isinstance(el, _FRESH):
                    what = f"a fresh `{type(el).__name__.lower()}`"
                elif isinstance(el, ast.Call) and \
                        dotted(el.func) in ("dict", "list", "set"):
                    what = f"a fresh `{dotted(el.func)}`"
                elif isinstance(el, ast.Name) and el.id in params and \
                        el.id not in host:
                    what = f"the argument `{el.id}` as it is"
                elif isinstance(el, ast.Attribute) and \
                        el.attr in tensor_attrs:
                    what = f"the tensor field `{el.attr}`"
                if what:
                    add(f.rel, el.lineno,
                        f"graph key `{fn.name}` holds {what}: a key must be "
                        f"hashable host data (a shape, a dtype, a name)")
    return list(out.values())
