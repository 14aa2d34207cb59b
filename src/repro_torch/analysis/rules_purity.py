"""T1: capture purity, no host work inside a captured CUDA-graph step.

A CUDA graph records the device work of one call of the step
(``runtime/graphs.py``); every replay runs that work again and the Python
around it never again.  So inside everything reachable from a capture root
(see ``callgraph``):

* a host sync (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``np.asarray``/``np.array`` and other numpy calls on a tensor,
  ``torch.cuda.synchronize``) is illegal while capturing, and where it is
  not it reads a value frozen at capture;
* ``bool()``/``int()``/``float()`` on a tensor parameter, and an ``if`` or
  ``while`` whose test calls ``torch.*`` or ``.any()``/``.all()``, branch
  once, at capture, on that call's values;
* ``print``, a host clock (``time.*``) and host RNG (``random``,
  ``np.random``) fire once, at capture;
* a mutable default argument is shared by every call.

This is the counterpart of R1 (jit purity) for a captured step.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import callgraph
from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.core import Finding, Project, register_rule

# numpy names legal in captured code: dtypes and constants
_NP_OK = {
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "bool_", "dtype",
    "ndarray", "generic", "number", "inf", "nan", "newaxis", "pi", "e",
    "iinfo", "finfo",
}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_TENSOR_BOOL = {"any", "all", "item"}
# torch calls that read host metadata, not tensor values
_TORCH_HOST = {"is_tensor", "is_floating_point", "is_available",
               "get_default_dtype", "is_grad_enabled", "device",
               "current_stream", "current_device", "_cuda_getDevice"}


def _branches_on_tensor(test) -> bool:
    for t in ast.walk(test):
        if not isinstance(t, ast.Call):
            continue
        d = dotted(t.func) or ""
        last = d.split(".")[-1]
        if d.startswith("torch.") and last not in _TORCH_HOST:
            return True
        if isinstance(t.func, ast.Attribute) and \
                t.func.attr in _TENSOR_BOOL and \
                not d.startswith(("np.", "numpy.")):
            return True
    return False


@register_rule(
    "T1",
    "capture purity: no host sync (.item/.cpu/.tolist/.numpy/np.*/"
    "torch.cuda.synchronize), print, time.*, host random, scalar "
    "coercion of a tensor parameter, branch on a tensor or mutable "
    "default inside functions reachable from a captured step")
def rule_capture_purity(project: Project) -> List[Finding]:
    idx = callgraph.get_index(project)
    out = {}

    def add(fi, line, msg):
        out[(fi.file.rel, line, msg)] = Finding(
            path=fi.file.rel, line=line, rule="T1", message=msg)

    for fi in idx.reached_from_capture():
        mod = idx.module_of(fi)
        imports = mod.imports if mod is not None else {}
        qual = fi.qualname
        args = fi.node.args
        for dflt in list(args.defaults) + \
                [d for d in args.kw_defaults if d is not None]:
            if isinstance(dflt, (ast.List, ast.Dict, ast.Set)):
                add(fi, dflt.lineno,
                    f"mutable default argument in captured `{qual}` is "
                    f"shared by every call")
        params = set(fi.params)
        for stmt in fi.body():
            for node in ast.walk(stmt):
                if isinstance(node, (ast.If, ast.While, ast.IfExp)) and \
                        _branches_on_tensor(node.test):
                    add(fi, node.lineno,
                        f"branch on a tensor value in captured `{qual}`: "
                        f"the capture records one side, every replay "
                        f"takes it (use torch.where)")
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if d is not None:
                    base = d.split(".")[0]
                    target = imports.get(base, base)
                    full = target + d[len(base):]
                    if d == "print":
                        add(fi, node.lineno,
                            f"print() inside captured `{qual}` fires at "
                            f"capture only")
                    elif target == "time" or target.startswith("time."):
                        add(fi, node.lineno,
                            f"host clock `{d}` inside captured `{qual}` "
                            f"reads capture time, not step time")
                    elif target == "random" or target.startswith("random.") \
                            or (target.startswith("numpy")
                                and ".random" in full):
                        add(fi, node.lineno,
                            f"host RNG `{d}` inside captured `{qual}` "
                            f"freezes one sample into the graph (use a "
                            f"torch generator on the device)")
                    elif target.startswith("numpy"):
                        if d.split(".")[-1] not in _NP_OK:
                            add(fi, node.lineno,
                                f"numpy host op `{d}` inside captured "
                                f"`{qual}` syncs with the host (use torch)")
                    elif full == "torch.cuda.synchronize":
                        add(fi, node.lineno,
                            f"torch.cuda.synchronize() inside captured "
                            f"`{qual}` is illegal while capturing")
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SYNC_METHODS and \
                        not (d or "").startswith(("np.", "numpy.")):
                    add(fi, node.lineno,
                        f"`.{node.func.attr}()` inside captured `{qual}` "
                        f"reads a device value on the host")
                if isinstance(node.func, ast.Name) and \
                        node.func.id in ("int", "float", "bool") and \
                        len(node.args) == 1 and \
                        isinstance(node.args[0], ast.Name) and \
                        node.args[0].id in params:
                    add(fi, node.lineno,
                        f"`{node.func.id}({node.args[0].id})` coerces an "
                        f"argument of captured `{qual}` to a host scalar")
    return list(out.values())
