"""bngcheck core: findings, the scanned project, and the pass driver
(the port's copy of `bng_tpu/analysis/core.py`, scanning the port).

The analyzer enforces the disciplines this codebase encodes only as
convention: fenced device time, the fixed span vocabulary,
registered fault points, single-writer device-mirror updates, donation
of the jitted step's table buffers, and Yuan-style error-handler
hygiene (OSDI'14: 92% of catastrophic failures hide in
already-signaled-but-mishandled errors — a statically checkable class).

Design constraints, in order:

1. **stdlib only.** `ast` + `json` + `pathlib`; importing the analyzer
   never imports torch or jax (so `bng check` runs in milliseconds
   anywhere, including CI boxes with no accelerator stack).
2. **Stable, baselinable findings.** A Finding's identity is
   (code, path, scope, detail) — deliberately NOT the line number, so
   an unrelated edit above an accepted finding doesn't churn the
   baseline. file:line still rides along for humans.
3. **Passes are data + a visitor.** Each pass declares the codes it can
   emit; the driver owns discovery, fact extraction and baseline
   matching. A pass that cannot find its fact source (e.g. the span
   vocabulary moved) emits BNG990 instead of silently passing — the
   analyzer must fail loud when the repo drifts out from under it.
"""

from __future__ import annotations

import ast
import time
from dataclasses import dataclass, field
from pathlib import Path

ANALYZER_VERSION = 1

# self-check codes (any pass may emit these)
CODE_CONFIG = "BNG990"  # a pass's fact source is missing/unparseable


@dataclass(frozen=True)
class Finding:
    """One rule violation at a location.

    `scope` is the enclosing def/class qualname ("Engine._dispatch_step")
    and `detail` a short stable discriminator (the offending symbol) —
    together with code+path they form the baseline identity."""

    code: str
    path: str  # repo-relative posix path
    line: int
    message: str
    scope: str = ""
    detail: str = ""

    def key(self) -> tuple:
        return (self.code, self.path, self.scope, self.detail)

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "scope": self.scope, "detail": self.detail,
                "message": self.message}


@dataclass
class SourceFile:
    path: str  # repo-relative posix
    abspath: Path
    text: str
    tree: ast.Module

    @staticmethod
    def load(root: Path, abspath: Path) -> "SourceFile | None":
        try:
            text = abspath.read_text(encoding="utf-8")
            tree = ast.parse(text, filename=str(abspath))
        except (OSError, SyntaxError, ValueError):
            return None
        rel = abspath.relative_to(root).as_posix()
        return SourceFile(path=rel, abspath=abspath, text=text, tree=tree)


# default scan set: the package (the port has no bench driver yet, so the
# reference's `bench.py` entry has no counterpart). tests/ is excluded —
# it plants violations deliberately (this file's own test fixtures) and
# exercises private surfaces the production rules don't govern.
SCAN_GLOBS = ("bng_tpu_torch/**/*.py",)


class Project:
    """Parsed view of the scan set + parent links for scope resolution."""

    def __init__(self, root: Path, files: list[SourceFile]):
        self.root = root
        self.files = files
        self._by_path = {f.path: f for f in files}
        for f in files:
            _link_parents(f.tree)

    @staticmethod
    def load(root: Path, paths: list[Path] | None = None) -> "Project":
        root = Path(root).resolve()
        if paths:
            abspaths: list[Path] = []
            for p in paths:
                p = Path(p)
                p = p if p.is_absolute() else root / p
                abspaths.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
        else:
            abspaths = []
            for g in SCAN_GLOBS:
                abspaths.extend(sorted(root.glob(g)))
        files = []
        seen = set()
        for ap in abspaths:
            ap = ap.resolve()
            if ap in seen or "__pycache__" in ap.parts:
                continue
            seen.add(ap)
            sf = SourceFile.load(root, ap)
            if sf is not None:
                files.append(sf)
        return Project(root, files)

    def file(self, rel_path: str) -> SourceFile | None:
        return self._by_path.get(rel_path)

    def find_file(self, suffix: str) -> SourceFile | None:
        """Locate a fact source by path suffix (survives fixture trees
        that mirror only the tail of the real layout)."""
        sf = self._by_path.get(suffix)
        if sf is not None:
            return sf
        for f in self.files:
            if f.path.endswith(suffix):
                return f
        return None


def _link_parents(tree: ast.Module) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._bng_parent = node  # type: ignore[attr-defined]


def scope_of(node: ast.AST) -> str:
    """Qualname of the enclosing def/class chain ("Engine.process")."""
    parts: list[str] = []
    cur = getattr(node, "_bng_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            parts.append(cur.name)
        cur = getattr(cur, "_bng_parent", None)
    return ".".join(reversed(parts))


def enclosing_function(node: ast.AST):
    cur = getattr(node, "_bng_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "_bng_parent", None)
    return None


def call_name(node: ast.Call) -> str:
    """Trailing name of the called thing: f() -> "f", a.b.c() -> "c"."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def dotted(node: ast.AST) -> str:
    """Best-effort dotted form of a Name/Attribute chain ("torch.cuda.graph")."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class Pass:
    """Base pass: subclasses set name/description/codes and implement
    run(project) -> list[Finding]."""

    name = "base"
    description = ""
    codes: dict[str, str] = {}

    def run(self, project: Project) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def config_finding(self, detail: str, message: str) -> Finding:
        return Finding(code=CODE_CONFIG, path="<analyzer>", line=0,
                       scope=self.name, detail=detail, message=message)


@dataclass
class Report:
    """One analyzer run: everything the CLI and the tests consume."""

    findings: list[Finding]
    files_scanned: int
    passes_run: list[str]
    elapsed_s: float
    baselined: list[Finding] = field(default_factory=list)

    @property
    def new_findings(self) -> list[Finding]:
        return self.findings

    def to_dict(self) -> dict:
        return {
            "analyzer_version": ANALYZER_VERSION,
            "files_scanned": self.files_scanned,
            "passes": self.passes_run,
            "elapsed_s": round(self.elapsed_s, 3),
            "findings": [f.to_dict() for f in self.findings],
            "baselined": len(self.baselined),
        }


def run_passes(project: Project, passes: list[Pass]) -> Report:
    t0 = time.perf_counter()
    findings: list[Finding] = []
    for p in passes:
        findings.extend(p.run(project))
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.detail))
    return Report(findings=findings, files_scanned=len(project.files),
                  passes_run=[p.name for p in passes],
                  elapsed_s=time.perf_counter() - t0)
