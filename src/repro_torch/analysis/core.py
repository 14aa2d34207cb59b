"""torchlint core: findings, suppressions, baseline, file walking, registry
(the port's own copy of ``repro/analysis/core.py``).

Everything here is plain stdlib: the linter runs wherever the source tree
parses, torch installed or not.

A rule is a callable ``rule(project) -> list[Finding]`` registered with
``@register_rule``.  ``Project`` owns the parsed ASTs (one ``SourceFile``
per module) so every rule shares one parse; rules that resolve calls
across modules use ``repro_torch.analysis.callgraph`` on top of it.

Suppressions
------------
``# torchlint: disable=T1`` (or ``disable=T1,T4``) on the flagged line, or
on the line directly above it for a statement whose flagged node starts on
a wrapped line, silences those rules for that line.
``# torchlint: disable-file=T3`` in a file's first 20 lines silences a rule
for the whole file.  The marker is the port's own: a ``# reprolint:``
marker (the reference's lint, which walks this tree too) silences nothing
here, and a ``torchlint`` marker silences nothing there.

Baseline
--------
Grandfathered findings live in a committed baseline file (one canonical
key per line: ``relpath::RULE::message``; no line numbers, so unrelated
edits keep it valid).  ``lint.py --write-baseline`` regenerates it; the
lint exits non-zero only for findings neither suppressed nor baselined.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

_RULE_LIST = r"([A-Z][A-Z0-9]*(?:\s*,\s*[A-Z][A-Z0-9]*)*)"
_SUPPRESS_RE = re.compile(r"#\s*torchlint:\s*disable=" + _RULE_LIST)
_SUPPRESS_FILE_RE = re.compile(r"#\s*torchlint:\s*disable-file=" + _RULE_LIST)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str                  # repo-relative (or as-given) file path
    line: int                  # 1-based line of the offending node
    rule: str                  # "T1".."T9"
    message: str               # human-readable, symbol-anchored

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    @property
    def key(self) -> str:
        """Line-number-free identity used by the baseline file."""
        return f"{self.path}::{self.rule}::{self.message}"


class SourceFile:
    """One parsed module: source text, AST, and per-line suppressions."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        self.suppressed: Dict[int, set] = {}
        self.file_suppressed: set = set()
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppressed[i] = {r.strip() for r in m.group(1).split(",")
                                      if r.strip()}
            if i <= 20:
                m = _SUPPRESS_FILE_RE.search(line)
                if m:
                    self.file_suppressed |= {
                        r.strip() for r in m.group(1).split(",") if r.strip()}

    def is_suppressed(self, line: int, rule: str) -> bool:
        if rule in self.file_suppressed:
            return True
        return any(rule in self.suppressed.get(ln, ())
                   for ln in (line, line - 1))


class Project:
    """The file set under analysis, parsed once and shared by all rules."""

    def __init__(self, files: Sequence[SourceFile]):
        self.files = list(files)
        self.by_rel: Dict[str, SourceFile] = {f.rel: f for f in self.files}

    def find(self, suffix: str) -> Optional[SourceFile]:
        """The unique file whose relative path ends with ``suffix``."""
        hits = [f for f in self.files if f.rel.endswith(suffix)]
        return hits[0] if len(hits) == 1 else None


def project_from_sources(sources: Dict[str, str]) -> Project:
    """A project of in-memory modules ``{relpath: source}`` (fixtures)."""
    return Project([SourceFile(Path(rel), rel, text)
                    for rel, text in sorted(sources.items())])


# --------------------------------------------------------------------------
# rule registry
# --------------------------------------------------------------------------
RULES: Dict[str, Callable[[Project], List[Finding]]] = {}
RULE_DOC: Dict[str, str] = {}


def register_rule(rule_id: str, doc: str):
    def deco(fn):
        RULES[rule_id] = fn
        RULE_DOC[rule_id] = doc
        return fn
    return deco


def _ensure_rules_loaded() -> None:
    # imported lazily so `import repro_torch.analysis.core` has no rule deps
    from repro_torch.analysis import (rules_capture, rules_hostsync,  # noqa
                                      rules_inplace, rules_launchbounds,
                                      rules_locks, rules_model,
                                      rules_protocol, rules_purity,
                                      rules_walker)


# --------------------------------------------------------------------------
# file collection + entry point
# --------------------------------------------------------------------------
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules",
              "_build"}


def collect_files(paths: Sequence, *, root: Optional[Path] = None
                  ) -> List[SourceFile]:
    """Parse every ``.py`` under ``paths`` (files or directories).  ``root``
    anchors the relative paths used in findings and the baseline (default:
    each given path's directory)."""
    out: List[SourceFile] = []
    for p in paths:
        p = Path(p)
        base = root or (p if p.is_dir() else p.parent)
        targets = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for t in targets:
            if any(part in _SKIP_DIRS for part in t.parts):
                continue
            try:
                rel = str(t.relative_to(base))
            except ValueError:
                rel = str(t)
            try:
                out.append(SourceFile(t, rel, t.read_text()))
            except SyntaxError as e:
                raise SystemExit(f"torchlint: cannot parse {t}: {e}")
    return out


def run_rules(project: Project, rules: Optional[Sequence[str]] = None
              ) -> List[Finding]:
    """The (selected) rules over ``project``: UNSUPPRESSED findings sorted
    by (path, line, rule)."""
    _ensure_rules_loaded()
    selected = list(rules) if rules else sorted(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise SystemExit(f"torchlint: unknown rule(s) {unknown} "
                         f"(have: {sorted(RULES)})")
    findings: List[Finding] = []
    for rid in selected:
        for f in RULES[rid](project):
            sf = project.by_rel.get(f.path)
            if sf is not None and sf.is_suppressed(f.line, f.rule):
                continue
            findings.append(f)
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule,
                                                 f.message))


def lint_paths(paths: Sequence, *, rules: Optional[Sequence[str]] = None,
               root: Optional[Path] = None) -> List[Finding]:
    """``run_rules`` over the files under ``paths``.  Baseline filtering is
    the caller's job (``lint.py``)."""
    return run_rules(Project(collect_files(paths, root=root)), rules)


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------
def load_baseline(path) -> set:
    p = Path(path)
    if not p.exists():
        return set()
    return {line.strip() for line in p.read_text().splitlines()
            if line.strip() and not line.strip().startswith("#")}


def write_baseline(path, findings: Sequence[Finding]) -> None:
    header = ("# torchlint baseline: grandfathered findings "
              "(regenerate with --write-baseline).\n"
              "# One `relpath::RULE::message` per line; delete a line once "
              "its finding is fixed.\n")
    Path(path).write_text(header + "".join(f.key + "\n" for f in findings))
