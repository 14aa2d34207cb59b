"""Project index and the captured-step call graph for torchlint (the
port's counterpart of ``repro/analysis/callgraph.py``).

Builds, from the parsed ``Project``:

* a per-module symbol table (module-level functions, classes and their
  methods, nested functions, import aliases);
* the **capture roots**, the functions a CUDA graph records
  (``runtime/graphs.py``): every function called inside a function that
  calls ``.capture_begin(...)`` (``StepGraph.step``); the step function
  handed to ``ChunkGraphs(step_fn, ...)`` and the overlap step handed to
  ``.run(..., overlap=(step_fn, tree_tokens))``, seen through
  ``functools.partial(f, ...)`` and through a method that returns one
  (``HcmpOverlapRunner.step_fn`` -> ``overlap_step``);
* a conservative reachability walk from those roots: a bare-name call
  resolves through the lexical scopes (enclosing defs, the module, its
  imports, across modules), ``self.method()`` through the enclosing class
  and its statically known bases, ``module.fn()`` through import aliases,
  and a call on a dynamic object (``model.verify(...)``) through the
  callable fields of project classes: every function handed as that
  keyword to a project class's constructor (``Model(verify=verify, ...)``
  in ``models/api.py``, one per family).  Other dynamic calls stay
  unresolved.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set

from repro_torch.analysis.core import Project, SourceFile

# constructors and calls that take a step function to capture: callee name
# (last segment) -> positional index of the step function
CAPTURE_TAKERS = {"ChunkGraphs": 0}
# keyword arguments that hand a (step_fn, ...) tuple to a graph runner
CAPTURE_KEYWORDS = {"overlap"}


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST                       # FunctionDef/AsyncFunctionDef/Lambda
    file: SourceFile
    qualname: str
    parent: object                      # FuncInfo | ClassInfo | ModuleInfo
    cls: Optional["ClassInfo"] = None   # enclosing class (for self.x())
    locals: Dict[str, "FuncInfo"] = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]

    @property
    def line(self) -> int:
        return self.node.lineno

    def body(self) -> list:
        return [self.node.body] if isinstance(self.node, ast.Lambda) \
            else list(self.node.body)


@dataclasses.dataclass
class ClassInfo:
    node: ast.ClassDef
    file: SourceFile
    name: str
    module: "ModuleInfo"
    methods: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    base_names: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModuleInfo:
    file: SourceFile
    name: str                                        # dotted module path
    funcs: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)


def _module_name(rel: str) -> str:
    name = rel[:-3] if rel.endswith(".py") else rel
    return name.replace("/", ".").replace("\\", ".")


class Index:
    """Symbol tables, capture roots and reachability for one Project."""

    def __init__(self, project: Project):
        self.project = project
        self.modules: Dict[str, ModuleInfo] = {}
        self._scopes: List[tuple] = []          # (FuncInfo, ast node)
        for f in project.files:
            self._index_file(f)
        self.fields: Dict[str, List[FuncInfo]] = self._find_fields()
        self.roots: List[FuncInfo] = self._find_roots()

    # ---- indexing --------------------------------------------------------
    def _index_file(self, f: SourceFile) -> None:
        mod = ModuleInfo(file=f, name=_module_name(f.rel))
        self.modules[mod.name] = mod
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    mod.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        self._index_body(f.tree.body, mod, mod, None, f)

    def _index_body(self, body, scope, mod: ModuleInfo,
                    cls: Optional[ClassInfo], f: SourceFile) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = node.name if scope is mod else \
                    f"{getattr(scope, 'qualname', getattr(scope, 'name', ''))}" \
                    f".{node.name}"
                fi = FuncInfo(node=node, file=f, qualname=qual, parent=scope,
                              cls=cls)
                if isinstance(scope, ModuleInfo):
                    mod.funcs[node.name] = fi
                elif isinstance(scope, ClassInfo):
                    scope.methods[node.name] = fi
                    fi.cls = scope
                else:
                    scope.locals[node.name] = fi
                self._scopes.append(fi)
                self._index_body(node.body, fi, mod, fi.cls, f)
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(node=node, file=f, name=node.name, module=mod)
                ci.base_names = [dotted(b) or "" for b in node.bases]
                mod.classes[node.name] = ci
                self._index_body(node.body, ci, mod, ci, f)
            else:
                # defs nested in if/for/with/try blocks
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        self._index_body([child], scope, mod, cls, f)
                    elif isinstance(child, ast.stmt):
                        self._index_body([child], scope, mod, cls, f)

    # ---- resolution ------------------------------------------------------
    def module_of(self, scope) -> Optional[ModuleInfo]:
        while scope is not None and not isinstance(scope, ModuleInfo):
            scope = getattr(scope, "parent", None) or \
                getattr(scope, "module", None)
        return scope

    def module_by_dotted(self, target: str) -> Optional[ModuleInfo]:
        """Match 'repro_torch.runtime.cache' whether the files were rooted
        at src/, at the package or at the repo root."""
        if target in self.modules:
            return self.modules[target]
        for name, mod in self.modules.items():
            if name.endswith("." + target) or target.endswith("." + name):
                return mod
        return None

    def resolve_import(self, mod: ModuleInfo, name: str
                       ) -> Optional[FuncInfo]:
        target = mod.imports.get(name)
        if not target or "." not in target:
            return None
        head, tail = target.rsplit(".", 1)
        m = self.module_by_dotted(head)
        if m is not None and tail in m.funcs:
            return m.funcs[tail]
        return None

    def resolve_class(self, mod: ModuleInfo, name: str
                      ) -> Optional[ClassInfo]:
        if name in mod.classes:
            return mod.classes[name]
        target = mod.imports.get(name)
        if target and "." in target:
            head, tail = target.rsplit(".", 1)
            m = self.module_by_dotted(head)
            if m is not None and tail in m.classes:
                return m.classes[tail]
        return None

    def class_methods(self, ci: ClassInfo, *, seen=None
                      ) -> Dict[str, FuncInfo]:
        """Own and inherited methods (statically resolved bases)."""
        seen = seen if seen is not None else set()
        if ci.name in seen:
            return {}
        seen.add(ci.name)
        out: Dict[str, FuncInfo] = {}
        for base in ci.base_names:
            bci = self.resolve_class(ci.module, base.split(".")[-1])
            if bci is not None:
                out.update(self.class_methods(bci, seen=seen))
        out.update(ci.methods)
        return out

    def resolve_ref(self, fn: ast.AST, scope) -> Optional[FuncInfo]:
        """The project function an expression names (a callee or a
        function passed as a value), or None."""
        if isinstance(fn, ast.Name):
            s = scope
            while isinstance(s, FuncInfo):
                if fn.id in s.locals:
                    return s.locals[fn.id]
                s = s.parent
            mod = self.module_of(scope)
            if mod is None:
                return None
            if fn.id in mod.funcs:
                return mod.funcs[fn.id]
            return self.resolve_import(mod, fn.id)
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                cls = getattr(scope, "cls", None)
                if cls is not None:
                    return self.class_methods(cls).get(fn.attr)
                return None
            d = dotted(base)
            mod = self.module_of(scope)
            if d is not None and mod is not None:
                target = mod.imports.get(d)
                if target:
                    m = self.module_by_dotted(target)
                    if m is not None and fn.attr in m.funcs:
                        return m.funcs[fn.attr]
                ci = self.resolve_class(mod, d.split(".")[-1])
                if ci is not None:
                    return self.class_methods(ci).get(fn.attr)
        return None

    def resolve_call(self, call: ast.Call, scope) -> Optional[FuncInfo]:
        return self.resolve_ref(call.func, scope)

    # ---- callable fields -------------------------------------------------
    def _find_fields(self) -> Dict[str, List[FuncInfo]]:
        """Keyword name -> the project functions handed as that keyword
        to a project class's constructor (the functions a dynamic
        ``obj.<name>(...)`` may stand for)."""
        out: Dict[str, List[FuncInfo]] = {}
        scopes = list(self._scopes) + list(self.modules.values())
        for scope in scopes:
            node = scope.node if isinstance(scope, FuncInfo) \
                else scope.file.tree
            mod = self.module_of(scope)
            for call in ast.walk(node):
                if not isinstance(call, ast.Call) or not call.keywords:
                    continue
                name = (dotted(call.func) or "").split(".")[-1]
                if mod is None or self.resolve_class(mod, name) is None:
                    continue
                for kw in call.keywords:
                    hit = self.resolve_ref(kw.value, scope) \
                        if kw.arg else None
                    if hit is not None and hit not in out.get(kw.arg, []):
                        out.setdefault(kw.arg, []).append(hit)
        return out

    def resolve_targets(self, call: ast.Call, scope) -> List[FuncInfo]:
        """Every project function a call may reach: its static callee,
        else, for ``obj.name(...)`` on a dynamic object, the functions
        bound to the callable field ``name``."""
        hit = self.resolve_call(call, scope)
        if hit is not None:
            return [hit]
        fn = call.func
        if isinstance(fn, ast.Attribute) and not (
                isinstance(fn.value, ast.Name)
                and fn.value.id in ("self", "cls")):
            return list(self.fields.get(fn.attr, ()))
        return []

    # ---- capture roots ---------------------------------------------------
    def _step_targets(self, expr, scope) -> List[FuncInfo]:
        """The functions a step-function expression stands for: a named
        function, ``functools.partial(f, ...)``'s ``f``, a lambda, or a
        call of a method that returns ``functools.partial(f, ...)`` (the
        method and ``f``)."""
        if isinstance(expr, ast.Lambda):
            return [FuncInfo(node=expr, file=self._file_of(scope),
                             qualname=f"<lambda L{expr.lineno}>",
                             parent=scope, cls=getattr(scope, "cls", None))]
        if isinstance(expr, (ast.Name, ast.Attribute)):
            hit = self.resolve_ref(expr, scope)
            return [hit] if hit is not None else []
        if isinstance(expr, ast.Call):
            d = dotted(expr.func) or ""
            if d.split(".")[-1] == "partial" and expr.args:
                return self._step_targets(expr.args[0], scope)
            maker = self.resolve_call(expr, scope)
            if maker is None or isinstance(maker.node, ast.Lambda):
                return []
            out = [maker]
            for node in ast.walk(maker.node):
                if isinstance(node, ast.Return) and node.value is not None \
                        and isinstance(node.value, ast.Call):
                    out += self._step_targets(node.value, maker)
            return out
        return []

    def _file_of(self, scope) -> SourceFile:
        mod = self.module_of(scope)
        return mod.file

    def _find_roots(self) -> List[FuncInfo]:
        roots: List[FuncInfo] = []
        scopes = [(fi, fi.body()) for fi in self._scopes] + [
            (mod, [st for st in mod.file.tree.body if not isinstance(
                st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))])
            for mod in self.modules.values()]
        for fi, body in scopes:
            calls = [n for stmt in body for n in ast.walk(stmt)
                     if isinstance(n, ast.Call)]
            captures = any(isinstance(c.func, ast.Attribute)
                           and c.func.attr == "capture_begin" for c in calls)
            for c in calls:
                name = (dotted(c.func) or "").split(".")[-1]
                if captures and name not in ("capture_begin", "capture_end"):
                    hit = self.resolve_call(c, fi)
                    if hit is not None:
                        roots.append(hit)
                if name in CAPTURE_TAKERS and \
                        len(c.args) > CAPTURE_TAKERS[name]:
                    roots += self._step_targets(
                        c.args[CAPTURE_TAKERS[name]], fi)
                for kw in c.keywords:
                    if kw.arg in CAPTURE_KEYWORDS and \
                            isinstance(kw.value, ast.Tuple) and \
                            kw.value.elts:
                        roots += self._step_targets(kw.value.elts[0], fi)
        uniq, seen = [], set()
        for r in roots:
            if id(r.node) not in seen:
                seen.add(id(r.node))
                uniq.append(r)
        return uniq

    # ---- reachability ----------------------------------------------------
    def reached_from_capture(self) -> List[FuncInfo]:
        """Every project function reachable from a capture root."""
        seen: Set[int] = set()
        out: List[FuncInfo] = []
        work = list(self.roots)
        while work:
            fi = work.pop()
            if id(fi.node) in seen:
                continue
            seen.add(id(fi.node))
            out.append(fi)
            for stmt in fi.body():
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        work += self.resolve_targets(node, fi)
        return out


def get_index(project: Project) -> Index:
    """One shared Index per Project (rules run over the same parse)."""
    idx = getattr(project, "_torchlint_index", None)
    if idx is None:
        idx = Index(project)
        project._torchlint_index = idx
    return idx
