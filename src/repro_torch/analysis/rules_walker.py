"""T5: walker completeness, the graphs' state walker names every field.

The reference registers its state classes as pytrees and R5 checks that a
registration lists every field.  The port has no pytrees: the captured
step's carry is walked by name (``runtime/graphs.py``: ``_tensors`` and
``_with`` over the tables ``_SMALL``/``_BIG`` keyed by the cache classes,
and the field tuples ``_TREE``, ``_MAMBA``, ``_CROSS``), and every other
walk goes through ``repro_torch/tree.py::named_map`` (``dataclasses.
fields``).  A field the walker does not name is silently dropped from the
graph's static buffers, so the replays run on a stale or a missing tensor.
Checks, over the project's dataclasses and their annotated fields:

* **T5a** a table keyed by dataclass names (``{KVCache: ("key_pos", ...),
  ...}``) names, over all such tables of its module, every tensor field
  of each class it keys, and nothing that is not a field;
* **T5b** in a walker module (one with such tables), every construction
  of a dataclass names every field: by keyword, by position, or through
  ``**{f: ... for f in TABLE}`` over field tuples; a field left out takes
  its default and the walk drops it;
* **T5c** a dataclass built inside a captured step is one the walker
  handles (a key of its tables, or built in a walker module);
* **T5d** a field of a handled dataclass is of a kind ``named_map`` walks
  (a tensor, dict, tuple, dataclass or host scalar; not a list or set).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import callgraph
from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.core import Finding, Project, register_rule

_UNWALKED = ("list", "List", "Sequence", "set", "Set", "FrozenSet",
             "frozenset", "Iterable")


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        d = dotted(dec.func if isinstance(dec, ast.Call) else dec) or ""
        if d.split(".")[-1] == "dataclass":
            return True
    return False


class DataclassInfo:
    def __init__(self, node: ast.ClassDef, rel: str):
        self.node, self.rel, self.name = node, rel, node.name
        self.fields: Dict[str, str] = {}       # name -> annotation text
        for st in node.body:
            if isinstance(st, ast.AnnAssign) and \
                    isinstance(st.target, ast.Name):
                ann = ast.unparse(st.annotation)
                if "ClassVar" not in ann:
                    self.fields[st.target.id] = ann

    @property
    def tensor_fields(self) -> Set[str]:
        return {f for f, a in self.fields.items() if "Tensor" in a}


def dataclasses_of(project: Project) -> Dict[str, DataclassInfo]:
    out: Dict[str, DataclassInfo] = {}
    for f in project.files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef) and _is_dataclass(node):
                out[node.name] = DataclassInfo(node, f.rel)
    return out


def _strings(node) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return tuple(e.value for e in node.elts)
    return None


def _tables(tree, classes) -> Tuple[Dict[str, Dict[str, Tuple[str, ...]]],
                                     Dict[str, Tuple[str, ...]], Dict]:
    """Module-level field tables: dict tables keyed by dataclass names
    (table -> class -> fields), field tuples (name -> fields), and each
    dict table's line."""
    dicts, tuples, lines = {}, {}, {}
    for st in tree.body:
        if not (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)):
            continue
        name = st.targets[0].id
        if isinstance(st.value, ast.Dict):
            entry = {}
            for k, v in zip(st.value.keys, st.value.values):
                if isinstance(k, ast.Name) and k.id in classes and \
                        _strings(v) is not None:
                    entry[k.id] = _strings(v)
            if entry:
                dicts[name] = entry
                lines[name] = st.lineno
        elif _strings(st.value) is not None:
            tuples[name] = _strings(st.value)
    return dicts, tuples, lines


def _table_names(expr, tuples, dicts) -> Optional[Set[str]]:
    """The fields an iterable of field names stands for: a tuple table, a
    sum of them, or a subscripted dict table (every class's entry)."""
    if isinstance(expr, ast.Name) and expr.id in tuples:
        return set(tuples[expr.id])
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        a = _table_names(expr.left, tuples, dicts)
        b = _table_names(expr.right, tuples, dicts)
        return None if a is None or b is None else a | b
    if isinstance(expr, ast.Subscript) and isinstance(expr.value, ast.Name) \
            and expr.value.id in dicts:
        return {f for v in dicts[expr.value.id].values() for f in v}
    return None


def _constructed(call: ast.Call, dc: DataclassInfo, tuples, dicts
                 ) -> Optional[Set[str]]:
    """The fields a construction names, or None if it cannot be told."""
    names = set(list(dc.fields)[:len(call.args)])
    for kw in call.keywords:
        if kw.arg is not None:
            names.add(kw.arg)
            continue
        v = kw.value
        if isinstance(v, ast.DictComp) and len(v.generators) == 1:
            got = _table_names(v.generators[0].iter, tuples, dicts)
            if got is None:
                return None
            names |= got
        else:
            return None
    return names


@register_rule(
    "T5",
    "walker completeness: the graphs' field tables and constructions name "
    "every field of the dataclasses they walk; a dataclass built in a "
    "captured step is one the walker handles; named_map walks every field")
def rule_walker(project: Project) -> List[Finding]:
    classes = dataclasses_of(project)
    out = {}

    def add(rel, line, msg):
        out[(rel, line, msg)] = Finding(path=rel, line=line, rule="T5",
                                        message=msg)

    handled: Set[str] = set()
    for f in project.files:
        dicts, tuples, lines = _tables(f.tree, classes)
        builds = []
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in classes:
                builds.append(node)
        walker = bool(dicts) or any(
            kw.arg is None and isinstance(kw.value, ast.DictComp)
            and len(kw.value.generators) == 1
            and _table_names(kw.value.generators[0].iter, tuples, dicts)
            is not None for c in builds for kw in c.keywords)
        if not walker:
            continue
        # T5a: dict tables
        per_class: Dict[str, Set[str]] = {}
        first_line: Dict[str, int] = {}
        for tname, entry in dicts.items():
            for cname, fields in entry.items():
                per_class.setdefault(cname, set()).update(fields)
                first_line.setdefault(cname, lines[tname])
        for cname, named in per_class.items():
            dc = classes[cname]
            handled.add(cname)
            for miss in sorted(dc.tensor_fields - named):
                add(f.rel, first_line[cname],
                    f"the field tables of this module miss tensor field "
                    f"`{miss}` of `{cname}`: the captured step's walk drops "
                    f"it")
            for extra in sorted(named - set(dc.fields)):
                add(f.rel, first_line[cname],
                    f"the field tables name `{extra}`, which is no field "
                    f"of `{cname}`")
        # T5b: constructions in a walker module
        for call in builds:
            dc = classes[call.func.id]
            handled.add(dc.name)
            named = _constructed(call, dc, tuples, dicts)
            if named is None:
                continue
            for miss in sorted(set(dc.fields) - named):
                add(f.rel, call.lineno,
                    f"`{dc.name}(...)` in a walker module leaves field "
                    f"`{miss}` to its default: the walk drops it")
            for extra in sorted(named - set(dc.fields)):
                add(f.rel, call.lineno,
                    f"`{dc.name}(...)` names `{extra}`, which is no field "
                    f"of `{dc.name}`")

    # T5c: dataclasses built inside a captured step
    idx = callgraph.get_index(project)
    for fi in idx.reached_from_capture():
        for stmt in fi.body():
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name) and \
                        node.func.id in classes and \
                        node.func.id not in handled:
                    add(fi.file.rel, node.lineno,
                        f"`{fi.qualname}` builds `{node.func.id}` inside a "
                        f"captured step, and the graphs' walker does not "
                        f"handle it")
    # T5d: fields named_map cannot walk
    for cname in sorted(handled):
        dc = classes[cname]
        for st in dc.node.body:
            if isinstance(st, ast.AnnAssign) and \
                    isinstance(st.target, ast.Name):
                ann = ast.unparse(st.annotation)
                if any(ann == u or ann.startswith(u + "[")
                       or f"[{u}" in ann for u in _UNWALKED):
                    add(dc.rel, st.lineno,
                        f"field `{st.target.id}` of `{cname}` is a "
                        f"`{ann}`, which tree.named_map does not walk")
    return list(out.values())
