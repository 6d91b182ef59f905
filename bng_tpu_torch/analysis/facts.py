"""Fact extraction: the repo's registries, read back out of its AST.

The registry-consistency passes check call sites against the *declared*
vocabularies — the span stage constants in telemetry/spans.py, the
fault-point registry in chaos/faults.py, the metric families in
control/metrics.py, the flight-recorder trigger reasons in
telemetry/recorder.py, and the checkpoint component keys in
runtime/checkpoint.py. All of these are parsed from source (never
imported), so the analyzer stays in lockstep with the code it checks:
renaming a stage constant updates the vocabulary and the check in the
same commit, and a fixture tree carrying miniature fact files gets a
consistent miniature vocabulary.

Every extractor returns None when its source file or declaration shape
is missing — the dependent pass turns that into a loud BNG990 config
finding instead of silently checking nothing.

The second half of this module is the **concurrency fact
layer**: thread entry points discovered from the repo's own AST
(`threading.Thread(target=...)`, HTTP handler classes, multiprocessing
targets, metrics scrape sources, the OpsController queue drain), a
module-level call graph with best-effort type resolution (parameter
annotations, `self.x = ClassName(...)` attribute types, the BNGApp
components-dict idiom, unique-method-name fallback), and a fixpoint
propagation that classifies every function by its reachable context
set and the lock set it is guaranteed to hold. The per-file extraction
is cached on disk keyed by (mtime, size) so `make verify-static`
stays inside its budget on warm runs.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path

from bng_tpu_torch.analysis.core import Project, str_const

SPANS_FILE = "bng_tpu_torch/telemetry/spans.py"
FAULTS_FILE = "bng_tpu_torch/chaos/faults.py"
RECORDER_FILE = "bng_tpu_torch/telemetry/recorder.py"
CHECKPOINT_FILE = "bng_tpu_torch/runtime/checkpoint.py"


def stage_vocabulary(project: Project) -> tuple[set[str], set[str]] | None:
    """(stage constant names, lane constant names) from spans.py — the
    tuple-unpacking assignments `(RING, ...) = range(N)` whose names are
    kept in lockstep with STAGE_NAMES/LANE_NAMES."""
    sf = project.find_file(SPANS_FILE)
    if sf is None:
        return None
    stages: set[str] = set()
    lanes: set[str] = set()
    for node in sf.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Tuple):
            continue
        names = [e.id for e in tgt.elts if isinstance(e, ast.Name)]
        if not names:
            continue
        if all(n.startswith("LANE_") for n in names):
            lanes.update(names)
        elif any(n in ("RING", "DISPATCH", "TOTAL") for n in names):
            stages.update(names)
    if not stages:
        return None
    return stages, lanes


def fault_registry(project: Project) -> set[str] | None:
    """Keys of POINT_KINDS in chaos/faults.py — the fault-point IDs the
    soak generator may draw and the call sites may reference."""
    sf = project.find_file(FAULTS_FILE)
    if sf is None:
        return None
    for node in sf.tree.body:
        targets = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for tgt in targets:
            if (isinstance(tgt, ast.Name) and tgt.id == "POINT_KINDS"
                    and isinstance(value, ast.Dict)):
                keys = {str_const(k) for k in value.keys}
                keys.discard(None)
                return keys  # type: ignore[return-value]
    return None


def trigger_reasons(project: Project) -> set[str] | None:
    """Flight-recorder anomaly reasons: the TRIG_* string constants in
    telemetry/recorder.py."""
    sf = project.find_file(RECORDER_FILE)
    if sf is None:
        return None
    reasons: set[str] = set()
    for node in sf.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("TRIG_")):
            v = str_const(node.value)
            if v:
                reasons.add(v)
    return reasons or None


def checkpoint_components(project: Project) -> dict | None:
    """Checkpoint component-key symmetry facts from runtime/checkpoint.py:

      save     — keys assigned via  meta["components"]["X"] = ...
      restore  — keys of the `targets = {...}` dict literal in the
                 restore path, plus keys tested with  "X" in comps
      payload  — the _PAYLOAD_JSON_COMPONENTS tuple

    Returns {"save": set, "restore": set, "payload": set, "line": int}.
    """
    sf = project.find_file(CHECKPOINT_FILE)
    if sf is None:
        return None
    save: set[str] = set()
    restore: set[str] = set()
    payload: set[str] = set()
    line = 1
    for node in ast.walk(sf.tree):
        # meta["components"]["X"] = ...
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if (isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Subscript)
                    and str_const(tgt.value.slice) == "components"):
                key = str_const(tgt.slice)
                if key:
                    save.add(key)
            # targets = {...}
            if (isinstance(tgt, ast.Name) and tgt.id == "targets"
                    and isinstance(node.value, ast.Dict)):
                for k in node.value.keys:
                    key = str_const(k)
                    if key:
                        restore.add(key)
                line = node.lineno
            # _PAYLOAD_JSON_COMPONENTS = (...)
            if (isinstance(tgt, ast.Name)
                    and tgt.id == "_PAYLOAD_JSON_COMPONENTS"
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                for e in node.value.elts:
                    key = str_const(e)
                    if key:
                        payload.add(key)
        # "X" in comps  (restore-side consumption)
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            if (isinstance(node.ops[0], ast.In)
                    and isinstance(node.comparators[0], ast.Name)
                    and node.comparators[0].id == "comps"):
                key = str_const(node.left)
                if key:
                    restore.add(key)
    if not save and not restore:
        return None
    # the statestore also declares payload components; fold them in
    ss = project.find_file("bng_tpu_torch/control/statestore.py")
    if ss is not None:
        for node in ast.walk(ss.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "_PAYLOAD_JSON_COMPONENTS"
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                for e in node.value.elts:
                    key = str_const(e)
                    if key:
                        payload.add(key)
    return {"save": save, "restore": restore, "payload": payload,
            "line": line}


# ===========================================================================
# Concurrency facts: contexts, call graph, locks
# ===========================================================================
#
# Model limits, stated once (the pass docstrings reference them):
#
# * Resolution is deliberately UNDER-approximate: an edge is added only
#   when the receiver's type is known (annotation, constructor
#   assignment, components-dict idiom) or the method name is unique
#   across the project. A missed edge means a function classified in
#   fewer contexts — fewer findings, never false ones.
# * Lock identity is the attribute name ("_ctl", "_lock"), qualified
#   by nothing: two different objects' "_lock" compare equal. That
#   bias SUPPRESSES findings (a fake common lock) rather than
#   inventing them — the right direction for a lint.
# * The "worker" context runs in a separate *process* (inline mode
#   runs on the caller's own thread): it never shares an address space
#   with the thread contexts, so the race rules exclude it.

FACTS_VERSION = 3  # bump to invalidate the on-disk extraction cache
# the port's own cache file: the reference analyzer keeps the same shape
# of cache at the same root, and the two must not evict each other
CACHE_NAME = ".bngcheck_torch_cache.json"

CLI_FILE = "bng_tpu_torch/cli.py"
OPSCTL_FILE = "bng_tpu_torch/control/opsctl.py"

# canonical execution contexts; unlisted thread modules get thread:<stem>
CONTEXT_MODULE_MAP = {
    "bng_tpu_torch/control/ha.py": "ha-sync",
    "bng_tpu_torch/control/cluster_http.py": "ha-sync",
    "bng_tpu_torch/control/opsctl.py": "ctl",
    "bng_tpu_torch/control/metrics.py": "scrape",
}
CONTEXT_LOOP = "loop"
CONTEXT_WORKER = "worker"
CONTEXT_SCRAPE = "scrape"

# process isolation: "worker" never shares memory with the thread
# contexts (inline mode runs on the calling thread = already counted)
NON_RACY_CONTEXTS = {CONTEXT_WORKER}

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}
# mutating container methods: self.X.append(...) mutates attribute X
MUTATING_METHODS = {"append", "appendleft", "add", "remove", "discard",
                    "clear", "pop", "popleft", "update", "extend",
                    "insert", "put", "put_nowait", "setdefault",
                    "remove_subscriber"}
# calls that block the calling thread (BNG063 inside a held lock)
BLOCKING_CALLS = {"sleep", "join", "recv", "recv_bytes", "accept",
                  "select", "wait"}
# a class with any of these methods is considered to have a thread
# stop/join path (BNG064)
STOP_METHODS = {"stop", "close", "shutdown", "disconnect", "cancel",
                "stop_all", "terminate"}


def _is_lock_name(attr: str, cls_locks: set[str] | None = None) -> bool:
    if cls_locks and attr in cls_locks:
        return True
    return attr == "_ctl" or "lock" in attr.lower()


def _trailing(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


@dataclass
class FnFact:
    """Extraction summary of one function (JSON-serializable)."""

    fid: str
    path: str
    qual: str
    cls: str | None
    line: int
    calls: list = field(default_factory=list)
    writes: list = field(default_factory=list)   # [attr, line, locks, kind]
    test_reads: list = field(default_factory=list)  # [attr, line, locks]
    blocking: list = field(default_factory=list)    # [name, line, locks]
    acquires: list = field(default_factory=list)    # [token, line]
    releases_final: list = field(default_factory=list)  # [token]

    def to_dict(self) -> dict:
        return {"fid": self.fid, "path": self.path, "qual": self.qual,
                "cls": self.cls, "line": self.line, "calls": self.calls,
                "writes": self.writes, "test_reads": self.test_reads,
                "blocking": self.blocking, "acquires": self.acquires,
                "releases_final": self.releases_final}

    @classmethod
    def from_dict(cls, d: dict) -> "FnFact":
        return cls(**d)


@dataclass
class ClassFact:
    name: str
    path: str
    line: int
    bases: list = field(default_factory=list)
    methods: dict = field(default_factory=dict)      # name -> fid
    lock_attrs: list = field(default_factory=list)
    attr_types: dict = field(default_factory=dict)   # attr -> [ClassName]
    subscript_types: dict = field(default_factory=dict)  # key -> [ClassName]
    has_stop: bool = False

    def to_dict(self) -> dict:
        return self.__dict__

    @classmethod
    def from_dict(cls, d: dict) -> "ClassFact":
        return cls(**d)


@dataclass
class FileSummary:
    path: str
    functions: dict = field(default_factory=dict)  # fid -> FnFact
    classes: dict = field(default_factory=dict)    # name -> ClassFact
    moddefs: dict = field(default_factory=dict)    # name -> fid
    localdefs: dict = field(default_factory=dict)  # parent fid -> {name: fid}
    imports: dict = field(default_factory=dict)    # alias -> dotted module
    from_imports: dict = field(default_factory=dict)  # name -> module
    spawns: list = field(default_factory=list)
    bindings: list = field(default_factory=list)   # [Cls, attr, TgtCls, meth]

    def to_dict(self) -> dict:
        return {"path": self.path,
                "functions": {k: v.to_dict()
                              for k, v in self.functions.items()},
                "classes": {k: v.to_dict() for k, v in self.classes.items()},
                "moddefs": self.moddefs, "localdefs": self.localdefs,
                "imports": self.imports, "from_imports": self.from_imports,
                "spawns": self.spawns, "bindings": self.bindings}

    @classmethod
    def from_dict(cls, d: dict) -> "FileSummary":
        out = cls(path=d["path"], moddefs=d["moddefs"],
                  localdefs=d["localdefs"], imports=d["imports"],
                  from_imports=d["from_imports"], spawns=d["spawns"],
                  bindings=d["bindings"])
        out.functions = {k: FnFact.from_dict(v)
                         for k, v in d["functions"].items()}
        out.classes = {k: ClassFact.from_dict(v)
                       for k, v in d["classes"].items()}
        return out


class _FileExtractor:
    """One pass over a file's AST producing its FileSummary."""

    def __init__(self, sf):
        self.sf = sf
        self.out = FileSummary(path=sf.path)

    def run(self) -> FileSummary:
        tree = self.sf.tree
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._imports(node)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._class(node, prefix="")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fid = self._fid(node.name)
                self.out.moddefs[node.name] = fid
                self._function(node, qual=node.name, cls=None, env={})
        return self.out

    # -- helpers ---------------------------------------------------------

    def _fid(self, qual: str) -> str:
        return f"{self.sf.path}::{qual}"

    def _imports(self, node) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                self.out.imports[a.asname or a.name.split(".")[0]] = a.name
        else:
            mod = node.module or ""
            for a in node.names:
                self.out.from_imports[a.asname or a.name] = mod

    # -- classes ---------------------------------------------------------

    def _class(self, node: ast.ClassDef, prefix: str,
               env: dict | None = None) -> None:
        qual = f"{prefix}{node.name}" if not prefix else f"{prefix}.{node.name}"
        cf = ClassFact(name=node.name, path=self.sf.path, line=node.lineno,
                       bases=[_trailing(b) for b in node.bases])
        # one shallow pre-scan of every method for lock attrs/attr types
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mqual = f"{qual}.{item.name}"
                cf.methods[item.name] = self._fid(mqual)
                if item.name in STOP_METHODS:
                    cf.has_stop = True
                self._scan_self_attrs(item, cf)
        self.out.classes.setdefault(node.name, cf)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # closure vars of the enclosing function (the nested
                # HTTP-handler-class idiom: `ctl = controller` above the
                # class body) stay visible to the methods
                menv = dict(env or {})
                menv.update(self._param_env(item))
                self._function(item, qual=f"{qual}.{item.name}",
                               cls=node.name, env=menv)
            elif isinstance(item, ast.ClassDef):
                self._class(item, prefix=qual, env=env)

    def _param_env(self, fn) -> dict:
        env = {}
        args = list(fn.args.posonlyargs) + list(fn.args.args) + \
            list(fn.args.kwonlyargs)
        for a in args:
            if a.annotation is not None:
                t = _trailing(a.annotation)
                if t and t[:1].isupper():
                    env[a.arg] = ["cls", t]
        return env

    def _scan_self_attrs(self, fn, cf: ClassFact) -> None:
        """self.X = threading.Lock() / ClassName(...) / annotated param,
        plus components-dict constructor keys (c["k"] = ClassName(...)).
        Chained targets (`a = c["k"] = ClassName()`) register each, and
        repeated keys accumulate candidates (the ha component is an
        ActiveSyncer OR a StandbySyncer depending on role)."""
        ann = self._param_env(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    if isinstance(val, ast.Call):
                        t = _trailing(val.func)
                        if t in LOCK_FACTORIES:
                            if tgt.attr not in cf.lock_attrs:
                                cf.lock_attrs.append(tgt.attr)
                        elif t and t[:1].isupper():
                            got = cf.attr_types.setdefault(tgt.attr, [])
                            if t not in got:
                                got.append(t)
                    elif isinstance(val, ast.Name) and val.id in ann:
                        got = cf.attr_types.setdefault(tgt.attr, [])
                        if ann[val.id][1] not in got:
                            got.append(ann[val.id][1])
                elif isinstance(tgt, ast.Subscript):
                    key = str_const(tgt.slice)
                    if key and isinstance(val, ast.Call):
                        t = _trailing(val.func)
                        if t and t[:1].isupper() and t not in LOCK_FACTORIES:
                            got = cf.subscript_types.setdefault(key, [])
                            if t not in got:
                                got.append(t)

    # -- functions -------------------------------------------------------

    def _function(self, fn, qual: str, cls: str | None, env: dict) -> None:
        fid = self._fid(qual)
        fact = FnFact(fid=fid, path=self.sf.path, qual=qual, cls=cls,
                      line=fn.lineno)
        self.out.functions[fid] = fact
        walker = _BodyWalker(self, fact, cls, dict(env), qual)
        walker.walk(fn.body, frozenset())
        # BNG061 bookkeeping: acquire without a finally-release
        fact.releases_final = sorted(set(fact.releases_final))

    def resolve_type(self, expr, env, cls) -> list | None:
        """Symbolic type of an expression (resolved later at build):
        ["cls", Name] | ["attrof", <Cls|sym>, attr] | ["keyof", Cls, key].
        The attrof base may itself be symbolic (ctl.app -> ["attrof",
        ["cls", "OpsController"], "app"]) — resolution recurses."""
        if isinstance(expr, ast.Name):
            return env.get(expr.id)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and cls:
                return ["attrof", cls, expr.attr]
            base = self.resolve_type(expr.value, env, cls)
            if base is not None:
                return ["attrof", base, expr.attr]
            return None
        if isinstance(expr, ast.Subscript):
            key = str_const(expr.slice)
            base_t = self.resolve_type(expr.value, env, cls)
            owner = self._dict_owner(expr.value, env, cls)
            if key and owner:
                return ["keyof", owner, key]
            _ = base_t
            return None
        if isinstance(expr, ast.Call):
            t = _trailing(expr.func)
            if t == "get":
                # c.get("fleet") / self.components.get("fleet")
                recv = expr.func.value if isinstance(expr.func,
                                                    ast.Attribute) else None
                key = str_const(expr.args[0]) if expr.args else None
                owner = self._dict_owner(recv, env, cls) if recv is not None \
                    else None
                if key and owner:
                    return ["keyof", owner, key]
                return None
            if t and t[:1].isupper() and t not in LOCK_FACTORIES:
                return ["cls", t]
        return None

    def _dict_owner(self, expr, env, cls) -> str | None:
        """Which class's subscript_types govern this dict expression?
        Covers `self.components[...]`, and locals aliased to a self
        attribute (`c = self.components`)."""
        if expr is None:
            return None
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return cls
        if isinstance(expr, ast.Name):
            t = env.get(expr.id)
            if t and t[0] == "attrof":
                return t[1]
        return None


class _BodyWalker:
    """Statement walker carrying the lexical lock set + local type env."""

    def __init__(self, ex: _FileExtractor, fact: FnFact, cls, env, qual):
        self.ex = ex
        self.fact = fact
        self.cls = cls
        self.env = env
        self.qual = qual
        cf = ex.out.classes.get(cls) if cls else None
        self.cls_locks = set(cf.lock_attrs) if cf else set()

    # -- lock tokens -----------------------------------------------------

    def _lock_token(self, expr) -> str | None:
        t = _trailing(expr)
        if t and _is_lock_name(t, self.cls_locks):
            return t
        return None

    # -- the walk --------------------------------------------------------

    def walk(self, stmts, locks: frozenset) -> None:
        for s in stmts:
            self._stmt(s, locks)

    def _stmt(self, s, locks) -> None:
        if isinstance(s, ast.With):
            inner = set(locks)
            for item in s.items:
                self._expr(item.context_expr, locks)
                tok = self._lock_token(item.context_expr)
                if tok:
                    inner.add(tok)
            self.walk(s.body, frozenset(inner))
        elif isinstance(s, (ast.If, ast.While)):
            self._expr(s.test, locks, is_test=True)
            self.walk(s.body, locks)
            self.walk(s.orelse, locks)
        elif isinstance(s, ast.For):
            self._expr(s.iter, locks)
            self._write_target(s.target, locks, kind="for")
            self.walk(s.body, locks)
            self.walk(s.orelse, locks)
        elif isinstance(s, ast.Try):
            self.walk(s.body, locks)
            for h in s.handlers:
                self.walk(h.body, locks)
            self.walk(s.orelse, locks)
            # record finally-side releases for the acquire check
            for node in s.finalbody:
                for call in ast.walk(node):
                    if isinstance(call, ast.Call) and \
                            _trailing(call.func) == "release":
                        tok = self._lock_token(call.func.value) \
                            if isinstance(call.func, ast.Attribute) else None
                        if tok:
                            self.fact.releases_final.append(tok)
            self.walk(s.finalbody, locks)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested_qual = f"{self.qual}.{s.name}"
            self.ex.out.localdefs.setdefault(self.fact.fid, {})[s.name] = \
                self.ex._fid(nested_qual)
            self.ex._function(s, qual=nested_qual, cls=self.cls,
                              env=dict(self.env))
        elif isinstance(s, ast.ClassDef):
            self.ex._class(s, prefix=self.qual, env=dict(self.env))
        elif isinstance(s, ast.Assign):
            self._expr(s.value, locks)
            for tgt in s.targets:
                self._write_target(tgt, locks, kind="assign")
            t = self.ex.resolve_type(s.value, self.env, self.cls)
            if t:
                for tgt in s.targets:
                    if isinstance(tgt, ast.Name):
                        self.env[tgt.id] = t
            # callable-attr binding: engine.slow_path_batch = fleet.meth
            if len(s.targets) == 1 and isinstance(s.targets[0],
                                                  ast.Attribute) \
                    and isinstance(s.value, ast.Attribute):
                tt = self.ex.resolve_type(s.targets[0].value, self.env,
                                          self.cls)
                vt = self.ex.resolve_type(s.value.value, self.env, self.cls)
                if tt and vt:
                    self.ex.out.bindings.append(
                        [tt, s.targets[0].attr, vt, s.value.attr])
        elif isinstance(s, ast.AugAssign):
            self._expr(s.value, locks)
            self._write_target(s.target, locks, kind="augassign")
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._expr(s.value, locks)
                self._write_target(s.target, locks, kind="assign")
        elif isinstance(s, ast.Expr):
            self._expr(s.value, locks)
        elif isinstance(s, ast.Return) and s.value is not None:
            self._expr(s.value, locks)
        elif isinstance(s, (ast.Raise,)):
            if s.exc is not None:
                self._expr(s.exc, locks)
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self._expr(child, locks)
                elif isinstance(child, ast.stmt):
                    self._stmt(child, locks)

    # -- writes ----------------------------------------------------------

    def _self_attr_chain(self, expr) -> str | None:
        """First attribute off `self` in a chain: self.X.Y -> X."""
        chain = []
        cur = expr
        while isinstance(cur, (ast.Attribute, ast.Subscript)):
            if isinstance(cur, ast.Attribute):
                chain.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name) and cur.id == "self" and chain:
            return chain[-1]
        return None

    def _write_target(self, tgt, locks, kind: str) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._write_target(e, locks, kind)
            return
        if isinstance(tgt, ast.Subscript):
            attr = self._self_attr_chain(tgt.value)
            if attr is not None:
                self.fact.writes.append([attr, tgt.lineno, sorted(locks),
                                         "subscript"])
            self._expr(tgt.value, locks)
            return
        if isinstance(tgt, ast.Attribute):
            attr = self._self_attr_chain(tgt)
            if attr is not None and kind != "for":
                self.fact.writes.append([attr, tgt.lineno, sorted(locks),
                                         kind])
            self._expr(tgt.value, locks)

    # -- expressions: calls, blocking, reads -----------------------------

    def _expr(self, expr, locks, is_test: bool = False) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._call(node, locks)
            elif isinstance(node, ast.Attribute) and is_test:
                attr = self._self_attr_chain(node)
                if attr is not None and isinstance(node.ctx, ast.Load):
                    self.fact.test_reads.append([attr, node.lineno,
                                                 sorted(locks)])

    def _call(self, node: ast.Call, locks) -> None:
        name = _trailing(node.func)
        lk = sorted(locks)
        if name in BLOCKING_CALLS and not (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, (ast.Constant,
                                                 ast.JoinedStr))):
            # `"sep".join(...)` / b"".join(...) is string assembly, not
            # a thread join
            self.fact.blocking.append([name, node.lineno, lk])
        if name == "acquire" and isinstance(node.func, ast.Attribute):
            tok = self._lock_token(node.func.value)
            if tok:
                self.fact.acquires.append([tok, node.lineno])
        # spawn records -------------------------------------------------
        if name in ("Thread", "Process"):
            self._spawn(node, kind="thread" if name == "Thread"
                        else "process")
        if name == "add_source":
            self._scrape_source(node)
        if name == "subscribe":
            # callback registration: the delivery thread (not the
            # registering one) invokes the handed-over method — treat
            # `x.subscribe(self._on_change)` as an entry point in the
            # registering module's context
            for arg in node.args:
                if isinstance(arg, ast.Attribute) and \
                        isinstance(arg.value, ast.Name) and \
                        arg.value.id == "self":
                    self.ex.out.spawns.append(
                        {"kind": "callback", "line": node.lineno,
                         "qual": self.qual, "cls": self.cls,
                         "fid": self.fact.fid, "has_stop": True,
                         "target": {"k": "self", "m": arg.attr}})
        # mutating container method on a self attribute -----------------
        if name in MUTATING_METHODS and isinstance(node.func, ast.Attribute):
            attr = self._self_attr_chain(node.func.value)
            if attr is not None:
                self.fact.writes.append([attr, node.lineno, lk, "mutcall"])
        # the call edge itself ------------------------------------------
        desc = self._call_desc(node, name)
        if desc is not None:
            desc["locks"] = lk
            desc["line"] = node.lineno
            self.fact.calls.append(desc)

    def _call_desc(self, node: ast.Call, name: str) -> dict | None:
        f = node.func
        if isinstance(f, ast.Name):
            if name and name[:1].isupper():
                return {"k": "ctor", "n": name}
            return {"k": "name", "n": name} if name else None
        if isinstance(f, ast.Attribute):
            v = f.value
            if isinstance(v, ast.Name) and v.id == "self":
                return {"k": "self", "m": name}
            t = self.ex.resolve_type(v, self.env, self.cls)
            if t is not None:
                return {"k": "sym", "t": t, "m": name}
            if isinstance(v, ast.Name) and v.id in self.ex.out.imports:
                return {"k": "mod", "mod": self.ex.out.imports[v.id],
                        "m": name}
            return {"k": "meth", "m": name}
        return None

    # -- spawn/source records -------------------------------------------

    def _spawn(self, node: ast.Call, kind: str) -> None:
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        rec = {"kind": kind, "line": node.lineno, "qual": self.qual,
               "cls": self.cls, "target": None}
        if target is None:
            rec["target"] = {"k": "none"}
        elif isinstance(target, ast.Attribute):
            if _trailing(target) == "serve_forever":
                rec["target"] = {"k": "serve_forever"}
            elif isinstance(target.value, ast.Name) and \
                    target.value.id == "self":
                rec["target"] = {"k": "self", "m": target.attr}
            else:
                t = self.ex.resolve_type(target.value, self.env, self.cls)
                rec["target"] = ({"k": "sym", "t": t, "m": target.attr}
                                 if t else {"k": "unresolved",
                                            "repr": ast.dump(target)[:80]})
        elif isinstance(target, ast.Name):
            rec["target"] = {"k": "name", "n": target.id}
        else:
            rec["target"] = {"k": "unresolved",
                             "repr": ast.dump(target)[:80]}
        # stop-path evidence for BNG064: the enclosing class has a stop
        # method, or the enclosing function builds a cancel closure
        cf = self.ex.out.classes.get(self.cls) if self.cls else None
        rec["has_stop"] = bool(cf and cf.has_stop)
        rec["fid"] = self.fact.fid
        self.ex.out.spawns.append(rec)

    def _scrape_source(self, node: ast.Call) -> None:
        if not node.args:
            return
        arg = node.args[0]
        rec = {"kind": "source", "line": node.lineno, "qual": self.qual,
               "cls": self.cls, "fid": self.fact.fid}
        if isinstance(arg, ast.Lambda):
            # synthesize a function for the lambda body's calls
            lqual = f"{self.qual}.<scrape:{node.lineno}>"
            lfid = self.ex._fid(lqual)
            lfact = FnFact(fid=lfid, path=self.ex.sf.path, qual=lqual,
                           cls=self.cls, line=node.lineno)
            self.ex.out.functions[lfid] = lfact
            lw = _BodyWalker(self.ex, lfact, self.cls, dict(self.env),
                             lqual)
            lw._expr(arg.body, frozenset())
            rec["target"] = {"k": "fid", "fid": lfid}
        elif isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name) and arg.value.id == "self":
            rec["target"] = {"k": "self", "m": arg.attr}
        elif isinstance(arg, ast.Name):
            rec["target"] = {"k": "name", "n": arg.n
                             if hasattr(arg, "n") else arg.id}
        else:
            rec["target"] = {"k": "unresolved", "repr": ast.dump(arg)[:80]}
        self.ex.out.spawns.append(rec)


# ---------------------------------------------------------------------------
# extraction cache
# ---------------------------------------------------------------------------

def _extract_all(project: Project,
                 cache_path: Path | None) -> tuple[dict, bool]:
    """{path -> FileSummary} for the whole scan set, reusing the on-disk
    cache for files whose (mtime_ns, size) is unchanged. Returns
    (summaries, cache_hit_any)."""
    cache: dict = {}
    hit_any = False
    if cache_path is not None and cache_path.exists():
        try:
            raw = json.loads(cache_path.read_text(encoding="utf-8"))
            if raw.get("version") == FACTS_VERSION:
                cache = raw.get("files", {})
        except (OSError, ValueError):
            cache = {}
    summaries: dict[str, FileSummary] = {}
    # seed with the existing entries: a path-narrowed run must not
    # evict the rest of the repo's summaries (mtime keys already guard
    # staleness; entries for edited/deleted files refresh or go unused)
    out_cache: dict = dict(cache)
    missed = False
    for sf in project.files:
        try:
            st = sf.abspath.stat()
            key = [st.st_mtime_ns, st.st_size]
        except OSError:
            key = None
        ent = cache.get(sf.path)
        if key is not None and ent is not None and ent.get("key") == key:
            try:
                summaries[sf.path] = FileSummary.from_dict(ent["summary"])
                hit_any = True
                continue
            except (KeyError, TypeError):
                pass
        summary = _FileExtractor(sf).run()
        summaries[sf.path] = summary
        if key is not None:
            out_cache[sf.path] = {"key": key, "summary": summary.to_dict()}
            missed = True
    # a fully-warm run re-writes nothing: the multi-MB serialization is
    # the dominant warm-run cost
    if cache_path is not None and missed:
        try:
            cache_path.write_text(json.dumps(
                {"version": FACTS_VERSION, "files": out_cache}),
                encoding="utf-8")
        except OSError:
            pass
    return summaries, hit_any


# ---------------------------------------------------------------------------
# the model: entries, call graph, context + lock propagation
# ---------------------------------------------------------------------------

class ConcurrencyModel:
    """Resolved call graph + per-function context/lock classification."""

    def __init__(self):
        self.functions: dict[str, FnFact] = {}
        self.classes: dict[str, list] = {}        # name -> [ClassFact]
        self.entries: list[dict] = []             # {context, fid, via, line}
        self.unresolved: list[dict] = []          # spawn records w/o target
        self.contexts: dict[str, set] = {}        # fid -> context set
        self.held: dict[str, frozenset] = {}      # fid -> guaranteed locks
        self.edges: dict[str, list] = {}          # fid -> [(callee, locks)]
        self.spawns: list[dict] = []
        self.missing_facts: list[str] = []        # BNG990 details
        self.resolved_lines: dict[str, set] = {}  # fid -> call lines that
        self.cache_hit = False                    # resolved to a function

    # -- json ------------------------------------------------------------

    def contexts_report(self, prefixes=("bng_tpu_torch/control/",
                                        "bng_tpu_torch/runtime/")) -> dict:
        fns = {}
        for fid, ctxs in sorted(self.contexts.items()):
            if not ctxs:
                continue
            if prefixes and not fid.startswith(prefixes):
                continue
            fns[fid] = {"contexts": sorted(ctxs),
                        "locks_held": sorted(self.held.get(fid) or ())}
        return {
            "entries": sorted(
                ({"context": e["context"], "function": e["fid"],
                  "via": e["via"]} for e in self.entries),
                key=lambda e: (e["context"], e["function"])),
            "unresolved_entry_points": [
                {"path": u.get("path", ""), "line": u.get("line", 0),
                 "scope": u.get("qual", "")} for u in self.unresolved],
            "functions": fns,
        }


def _resolve_symbolic(model: ConcurrencyModel, t,
                      near_path: str | None = None) -> list[ClassFact]:
    """Resolve a symbolic type descriptor to candidate ClassFacts."""
    if t is None:
        return []
    kind = t[0]
    if kind == "cls":
        cands = model.classes.get(t[1], [])
        if near_path is not None:
            same = [c for c in cands if c.path == near_path]
            if same:
                return same
        return cands if len(cands) == 1 else []
    if kind == "attrof":
        bases = ([b for b in _resolve_symbolic(model, t[1], near_path)]
                 if isinstance(t[1], list)
                 else _resolve_symbolic(model, ["cls", t[1]], near_path))
        out: list[ClassFact] = []
        for cf in bases:
            for name in cf.attr_types.get(t[2], ()):
                out.extend(_resolve_symbolic(model, ["cls", name],
                                             cf.path))
        return out
    if kind == "keyof":
        bases = _resolve_symbolic(model, ["cls", t[1]], near_path)
        out = []
        for cf in bases:
            for name in cf.subscript_types.get(t[2], ()):
                out.extend(_resolve_symbolic(model, ["cls", name],
                                             cf.path))
        return out
    return []


def build_concurrency_model(project: Project,
                            cache_path: Path | str | None = "auto",
                            ) -> ConcurrencyModel:
    """Assemble the model. Memoized per Project instance (the pass and
    the CLI `--json contexts` dump share one build)."""
    memo = getattr(project, "_bng_concurrency_model", None)
    if memo is not None:
        return memo
    if cache_path == "auto":
        cache_path = project.root / CACHE_NAME
    cache_path = Path(cache_path) if cache_path is not None else None

    model = ConcurrencyModel()
    summaries, model.cache_hit = _extract_all(project, cache_path)

    # global indexes ------------------------------------------------------
    method_index: dict[str, list] = {}   # method name -> [fid]
    for summ in summaries.values():
        for cname, cf in summ.classes.items():
            model.classes.setdefault(cname, []).append(cf)
            for mname, fid in cf.methods.items():
                method_index.setdefault(mname, []).append(fid)
        model.functions.update(summ.functions)

    def _method_of(cf: ClassFact, m: str) -> str | None:
        """Method lookup including single-inheritance base walk."""
        seen = set()
        while cf is not None and id(cf) not in seen:
            seen.add(id(cf))
            if m in cf.methods:
                return cf.methods[m]
            nxt = None
            for bn in cf.bases:
                got = _resolve_symbolic(model, ["cls", bn], cf.path)
                if got:
                    nxt = got[0]
                    break
            cf = nxt
        return None

    bindings: dict[tuple, str] = {}      # (ClsName, attr) -> bound fid
    for summ in summaries.values():
        for tt, attr, vt, meth in summ.bindings:
            tcands = _resolve_symbolic(model, tt, summ.path)
            vcands = _resolve_symbolic(model, vt, summ.path)
            for tcf in tcands:
                for vcf in vcands:
                    got = _method_of(vcf, meth)
                    if got:
                        bindings[(tcf.name, attr)] = got

    def resolve_call(summ: FileSummary, fact: FnFact, desc) -> list[str]:
        k = desc["k"]
        if k == "self" or (k == "sym" and desc.get("t")):
            if k == "self":
                cands = _resolve_symbolic(model, ["cls", fact.cls],
                                          fact.path)
            else:
                cands = _resolve_symbolic(model, desc["t"], fact.path)
            m = desc["m"]
            out: list[str] = []
            for cf in cands:
                b = bindings.get((cf.name, m))
                if b:  # bound-callable attr (engine.slow_path_batch = ..)
                    out.append(b)
                    continue
                got = _method_of(cf, m)
                if got:
                    out.append(got)
            if out:
                return out
            if k == "self":
                return []
            k, desc = "meth", {"m": m}  # fall through to unique-name
        if k == "name":
            n = desc["n"]
            local = summ.localdefs.get(fact.fid, {})
            if n in local:
                return [local[n]]
            # nested def of an enclosing function (one level is enough)
            for parent, defs in summ.localdefs.items():
                if fact.fid.startswith(parent) and n in defs:
                    return [defs[n]]
            if n in summ.moddefs:
                return [summ.moddefs[n]]
            mod = summ.from_imports.get(n)
            if mod and mod.startswith("bng_tpu_torch"):
                target = project.find_file(mod.replace(".", "/") + ".py")
                if target and target.path in summaries:
                    td = summaries[target.path].moddefs
                    if n in td:
                        return [td[n]]
            return []
        if k == "ctor":
            cands = _resolve_symbolic(model, ["cls", desc["n"]], fact.path)
            return [cf.methods["__init__"] for cf in cands
                    if "__init__" in cf.methods]
        if k == "mod":
            mod = desc["mod"]
            if mod.startswith("bng_tpu_torch"):
                target = project.find_file(mod.replace(".", "/") + ".py")
                if target and target.path in summaries:
                    td = summaries[target.path].moddefs
                    if desc["m"] in td:
                        return [td[desc["m"]]]
            return []
        if k == "meth":
            cands = method_index.get(desc["m"], ())
            if len(cands) == 1 and not desc["m"].startswith("__"):
                return list(cands)
            return []
        return []

    # edges ---------------------------------------------------------------
    for summ in summaries.values():
        for fid, fact in summ.functions.items():
            outs = model.edges.setdefault(fid, [])
            for desc in fact.calls:
                resolved = resolve_call(summ, fact, desc)
                for callee in resolved:
                    outs.append((callee, frozenset(desc["locks"])))
                if resolved:
                    # a mutating-method call that resolved INTO a
                    # project function is analyzed there (with the
                    # callee's own locks) — remember the line so the
                    # pass doesn't double-count it as a raw container
                    # mutation of the receiver attribute
                    model.resolved_lines.setdefault(fid, set()).add(
                        desc["line"])
        model.spawns.extend(
            dict(s, path=summ.path) for s in summ.spawns)

    # entry points --------------------------------------------------------
    def add_entry(context: str, fid: str, via: str, line: int = 0):
        model.entries.append({"context": context, "fid": fid, "via": via,
                              "line": line})

    # 1. the run loop roots (the dataplane's own context)
    cli_sf = project.find_file(CLI_FILE)
    loop_found = False
    if cli_sf is not None and cli_sf.path in summaries:
        app = summaries[cli_sf.path].classes.get("BNGApp")
        if app is not None:
            for root in ("drive_once", "tick"):
                if root in app.methods:
                    add_entry(CONTEXT_LOOP, app.methods[root], "run-loop")
                    loop_found = True
    if not loop_found:
        model.missing_facts.append("loop-roots")

    # 2. the OpsController queue drain: run_pending executes the OPS
    # verbs on the loop thread (the getattr dispatch resolved from the
    # OPS dict literal, the queue-drain fact the pass depends on)
    ops_sf = project.find_file(OPSCTL_FILE)
    if ops_sf is not None and ops_sf.path in summaries:
        summ = summaries[ops_sf.path]
        ctl = summ.classes.get("OpsController")
        verbs: list[str] = []
        for node in ast.walk(ops_sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "OPS" \
                    and isinstance(node.value, ast.Dict):
                verbs = [str_const(v) for v in node.value.values
                         if str_const(v)]
        if ctl is not None and "run_pending" in ctl.methods:
            rp = ctl.methods["run_pending"]
            add_entry(CONTEXT_LOOP, rp, "ops-queue-drain")
            for verb in verbs:
                cands = method_index.get(verb, ())
                if len(cands) == 1:
                    model.edges.setdefault(rp, []).append(
                        (cands[0], frozenset()))
        elif ctl is not None:
            model.missing_facts.append("ops-queue-drain")

    # 3. spawn records: threads, processes, handlers, scrape sources
    for rec in model.spawns:
        path = rec["path"]
        summ = summaries[path]
        stem = Path(path).stem
        if rec["kind"] == "process":
            context = CONTEXT_WORKER
        elif rec["kind"] == "source":
            context = CONTEXT_SCRAPE
        else:
            context = CONTEXT_MODULE_MAP.get(path, f"thread:{stem}")
        tgt = rec["target"]
        fids: list[str] = []
        if tgt["k"] == "fid":
            fids = [tgt["fid"]]
        elif tgt["k"] == "self" and rec["cls"]:
            cf = summ.classes.get(rec["cls"])
            if cf and tgt["m"] in cf.methods:
                fids = [cf.methods[tgt["m"]]]
        elif tgt["k"] == "sym":
            for cf in _resolve_symbolic(model, tgt.get("t"), path):
                got = cf.methods.get(tgt["m"])
                if got:
                    fids.append(got)
        elif tgt["k"] == "name":
            local = summ.localdefs.get(rec["fid"], {})
            n = tgt["n"]
            if n in local:
                fids = [local[n]]
            elif n in summ.moddefs:
                fids = [summ.moddefs[n]]
        elif tgt["k"] == "serve_forever":
            # the server's worker threads run the module's handler
            # classes: every do_* method is an entry
            for cf in summ.classes.values():
                if any("BaseHTTPRequestHandler" in b for b in cf.bases):
                    fids.extend(fid for mname, fid in cf.methods.items()
                                if mname.startswith("do_"))
        if fids:
            for fid in fids:
                add_entry(context, fid, f"{rec['kind']}:{rec['qual']}",
                          rec["line"])
        elif rec["kind"] in ("thread", "process"):
            model.unresolved.append(rec)

    # HTTP handler classes whose server is started elsewhere (the
    # handler class IS the entry even if serve_forever is indirect)
    claimed = {e["fid"] for e in model.entries}
    for path, summ in summaries.items():
        context = CONTEXT_MODULE_MAP.get(path,
                                         f"thread:{Path(path).stem}")
        for cf in summ.classes.values():
            if any("BaseHTTPRequestHandler" in b for b in cf.bases):
                for mname, fid in cf.methods.items():
                    if mname.startswith("do_") and fid not in claimed:
                        add_entry(context, fid, "http-handler", cf.line)

    # propagation ---------------------------------------------------------
    contexts: dict[str, set] = {f: set() for f in model.functions}
    held: dict[str, frozenset | None] = {f: None for f in model.functions}
    work: list[str] = []
    for e in model.entries:
        fid = e["fid"]
        if fid not in contexts:
            continue
        contexts[fid].add(e["context"])
        held[fid] = frozenset() if held[fid] is None else held[fid]
        work.append(fid)
    seen_rounds = 0
    while work and seen_rounds < 200_000:
        seen_rounds += 1
        fid = work.pop()
        ctx = contexts[fid]
        h = held[fid] if held[fid] is not None else frozenset()
        for callee, locks in model.edges.get(fid, ()):
            if callee not in contexts:
                continue
            changed = False
            if not ctx <= contexts[callee]:
                contexts[callee] |= ctx
                changed = True
            cand = h | locks
            if held[callee] is None:
                held[callee] = cand
                changed = True
            elif not held[callee] <= cand:
                held[callee] = held[callee] & cand
                changed = True
            if changed:
                work.append(callee)
    if work:
        # the round cap is a runaway backstop far above any real graph;
        # hitting it means the classification is INCOMPLETE — say so
        # loudly (BNG990 via missing_facts), never under-report quietly
        model.missing_facts.append("propagation-truncated")
    model.contexts = contexts
    model.held = {f: (h if h is not None else frozenset())
                  for f, h in held.items()}
    project._bng_concurrency_model = model  # type: ignore[attr-defined]
    return model
