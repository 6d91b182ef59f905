"""Hot-path sync lint (BNG001) + disarmed-hook hygiene (BNG002/BNG003)
+ batch-native serving-path lint (BNG004): the port's copy of
`bng_tpu/analysis/passes/hotpath.py`, with BNG001 read for torch.

The dataplane's latency discipline has two halves:

* **Dispatch scope never forces.** The submit/dispatch side of the
  engine, scheduler, lanes and fleet scatter must not synchronize with
  the card. A CUDA launch returns at once; the host waits only where it
  asks for a device value: `.item()`, `.cpu()`, `.tolist()`, `.numpy()`,
  a synchronize (`torch.cuda.synchronize`, `Event.synchronize`,
  `Stream.synchronize`), `np.asarray`/`np.array` of a tensor, and
  `float()`/`int()`/`bool()` or truthiness on a value tainted by a
  step result. Forces belong in the retire path (the completion ring
  is the single block point — lanes.py). BNG001 flags any force inside
  the dispatch-scoped functions. (The reference's reading names
  `jax.device_get` and `copy_to_host`; the port has neither.)

* **Disarmed hooks never allocate.** The telemetry/chaos hook APIs are
  cheap disarmed (tens of ns a call in the reference's measurements) because the
  disarmed path is one global load + `is None` compare. BNG003 flags a
  hook whose first effective statement is not that guard; BNG002 flags
  an allocation (literal, comprehension, f-string, lambda) reachable
  before the guard. Hooks are discovered: any module-level function in
  spans.py/faults.py that delegates to `_ACTIVE.<attr>`, and the stage
  hook `region` by name (it hands back a span object instead).

* **The serving path is batch-native.** A new `for frame in batch` loop
  in a per-batch ring->dispatch->reply function silently re-caps host
  throughput at per-frame-Python speed. BNG004 flags any `for`/`while`
  statement in the BATCH_SCOPE functions, EXCEPT
  `for ... in range(<int literal>)` (bounded iteration — the 2-tag VLAN
  walk, the 64-step TLV scan — iterates a constant, never the batch).
  Comprehensions are deliberately NOT flagged: a list comprehension
  feeding one stacked NumPy assignment is the batch-native staging
  idiom, and the per-frame handler boundaries (worker scatter, fallback
  demux) live behind them. The per-frame loops that remain (the PyRing
  and the ctypes bindings of the native ring, the fleet's per-frame
  admission) are baselined with justifications.

Taint for BNG001 is function-local and deliberately simple: a name
assigned from a dispatch call (`self._step(...)`, `_run_dhcp_batch`,
`pipeline_step`, ...) is device-tainted; attributes of a tainted name
(`res.verdict`) are tainted; a force call (`np.asarray`/`device_get`)
both *flags* and launders. Parameters named `res` (and `entry.res`
chains) are treated as device results — the retire-path convention.
"""

from __future__ import annotations

import ast

from bng_tpu_torch.analysis.core import (Finding, Pass, Project, call_name,
                                         dotted, scope_of)

# dispatch-scoped functions: file suffix -> function (simple) names.
# The retire-side siblings (_retire*, _apply_ring_verdicts, process*)
# force deliberately and are NOT listed. Renamed in the port: the
# reference's `_make_bulk_updates` and `_empty_updates` are one function,
# `_update_batch` (real or empty delta per table), and the scheduler's
# `_copy_to_bulk` is inlined in `_ensure_bulk_replica`, which is listed.
DISPATCH_SCOPE: dict[str, set[str]] = {
    "bng_tpu_torch/runtime/engine.py": {
        "_dispatch_step", "_run_dhcp_batch", "dispatch_scheduled_bulk",
        "_drain_step", "_drain_dhcp", "_drain_updates", "_update_batch",
        "_pack_frames", "_dispatch_fault", "_staging",
        "_ring_program", "_replay", "_pick_ring_program", "_dispatch_ring",
        "_ring_umem",
    },
    # a ring program's dispatch: the staged batch (or the descriptors and
    # the gather) into its static inputs, the tape's replay and the
    # zero-copy loop's scatter (its build, off the per-batch path, may wait)
    "bng_tpu_torch/runtime/ringprog.py": {"upload", "upload_desc", "replay", "scatter"},
    "bng_tpu_torch/runtime/scheduler.py": {
        "submit", "classify", "_dispatch_express", "_dispatch_bulk",
        "_ensure_bulk_replica", "_entry_ready",
    },
    "bng_tpu_torch/runtime/lanes.py": {
        "push", "close_reason", "close_batch", "oldest_age_us",
        "pop_oldest", "pop_ready",
    },
    # (the reference's entry also names `shard_of`, which neither fleet.py
    # defines: the steering hash is runtime/ring.py's)
    "bng_tpu_torch/control/fleet.py": {
        "_scatter_fault", "shard_for_mac", "shard_for_frame",
    },
    "bng_tpu_torch/telemetry/spans.py": set(),  # hooks handled by BNG002/003
    "bng_tpu_torch/chaos/faults.py": set(),
}

# method calls that make the host wait on the card: a tensor copied out
# (`.item()`, `.cpu()`, `.tolist()`, `.numpy()`) or a stream, event or
# device synchronized
FORCE_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# numpy constructors that copy a tensor to the host when given one
NUMPY_FORCES = {"asarray", "array"}
# calls whose *result* is a device-step future (taint sources)
DISPATCH_CALLS = {"_step", "_dhcp_step", "_dispatch_step",
                  "_run_dhcp_batch", "_run_step", "dispatch_scheduled_bulk",
                  "pipeline_step", "dhcp_fastpath"}
SCALAR_FORCES = {"float", "int", "bool"}

# hooks held to the disarmed-path rule by name: `spans.region` hands back
# a span object rather than delegating to `_ACTIVE.<attr>`, so discovery
# alone would not find it
NAMED_HOOKS = {"region"}

ALLOC_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
               ast.SetComp, ast.GeneratorExp, ast.Lambda, ast.JoinedStr)
ALLOC_CALLS = {"list", "dict", "set", "zeros", "empty", "ones", "full",
               "deque", "defaultdict"}

# batch-native scope (BNG004): the per-BATCH serving-path functions that
# must not loop per frame. file suffix -> function (simple) names; the
# per-frame loops they hold today are baselined — a NEW loop shows up.
BATCH_SCOPE: dict[str, set[str]] = {
    "bng_tpu_torch/runtime/ring.py": {
        "rx_push_batch", "assemble", "assemble_sharded", "complete",
        "tx_pop_batch",
    },
    "bng_tpu_torch/runtime/engine.py": {"_pack_frames"},
    "bng_tpu_torch/runtime/scheduler.py": {"_dispatch_express"},
    "bng_tpu_torch/control/fleet.py": {"handle_batch"},
}


def _is_force_call(node: ast.Call) -> bool:
    name = call_name(node)
    if name in FORCE_METHODS:
        # x.item() / t.cpu() / ev.synchronize() / torch.cuda.synchronize()
        return isinstance(node.func, ast.Attribute)
    if name not in NUMPY_FORCES:
        return False
    # np.asarray / np.array / numpy.* — NOT torch.as_tensor (host->device
    # staging is the dispatch path's job)
    base = dotted(node.func)
    return base.startswith(("np.", "numpy.")) or base in NUMPY_FORCES


class _Taint(ast.NodeVisitor):
    """Function-local device-result taint."""

    def __init__(self):
        self.tainted: set[str] = {"res"}

    def visit_Assign(self, node: ast.Assign):
        if self._taints(node.value):
            for tgt in node.targets:
                for e in (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]):
                    if isinstance(e, ast.Name):
                        self.tainted.add(e.id)
        self.generic_visit(node)

    def _taints(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call) and call_name(expr) in DISPATCH_CALLS:
            return True
        if isinstance(expr, ast.Tuple):
            return any(self._taints(e) for e in expr.elts)
        return self.is_tainted(expr)

    def is_tainted(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr == "res":  # entry.res — the inflight convention
                return True
            return self.is_tainted(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.is_tainted(expr.value)
        if isinstance(expr, (ast.BinOp,)):
            return self.is_tainted(expr.left) or self.is_tainted(expr.right)
        if isinstance(expr, ast.Compare):
            return (self.is_tainted(expr.left)
                    or any(self.is_tainted(c) for c in expr.comparators))
        if isinstance(expr, ast.Call):
            # method on a tainted value keeps the taint (.all(), ._replace)
            if isinstance(expr.func, ast.Attribute):
                return self.is_tainted(expr.func.value)
        return False


class HotPathPass(Pass):
    name = "hotpath"
    description = ("no device sync in dispatch scope; disarmed hooks "
                   "guard-first and allocation-free")
    codes = {
        "BNG001": "device sync (force/transfer) in a dispatch-scoped "
                  "hot function",
        "BNG002": "allocation on the disarmed path of a telemetry/chaos "
                  "hook",
        "BNG003": "hook delegates to _ACTIVE without a disarmed "
                  "fast-path guard",
        "BNG004": "per-frame Python loop in a batch-native serving-path "
                  "function",
    }

    def run(self, project: Project) -> list[Finding]:
        out: list[Finding] = []
        for suffix, fn_names in DISPATCH_SCOPE.items():
            sf = project.find_file(suffix)
            if sf is None:
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.FunctionDef)
                        and node.name in fn_names):
                    out.extend(self._check_dispatch_fn(sf.path, node))
            if suffix.endswith(("spans.py", "faults.py")):
                out.extend(self._check_hooks(sf.path, sf.tree))
        for suffix, fn_names in BATCH_SCOPE.items():
            sf = project.find_file(suffix)
            if sf is None:
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.FunctionDef)
                        and node.name in fn_names):
                    out.extend(self._check_batch_fn(sf.path, node))
        return out

    # -- BNG004 ----------------------------------------------------------

    @staticmethod
    def _const_range(it: ast.AST) -> bool:
        """`range(<int literal>...)` — bounded vectorized iteration (the
        2-tag VLAN walk, the 64-step TLV scan), never the batch."""
        return (isinstance(it, ast.Call)
                and isinstance(it.func, ast.Name)
                and it.func.id == "range"
                and len(it.args) >= 1
                and all(isinstance(a, ast.Constant)
                        and isinstance(a.value, int) for a in it.args))

    def _check_batch_fn(self, path: str, fn: ast.FunctionDef):
        scope = (scope_of(fn) + "." + fn.name).lstrip(".")
        for node in ast.walk(fn):
            if isinstance(node, ast.While):
                yield Finding(
                    "BNG004", path, node.lineno,
                    f"`while` loop in batch-native serving function "
                    f"`{fn.name}` — a per-batch serving function must "
                    f"not iterate per frame; express the work as "
                    f"a NumPy pass or baseline the loop",
                    scope=scope, detail="while")
            elif isinstance(node, ast.For):
                if self._const_range(node.iter):
                    continue
                yield Finding(
                    "BNG004", path, node.lineno,
                    f"`for` loop in batch-native serving function "
                    f"`{fn.name}` — a per-batch serving function must "
                    f"not iterate per frame; express the work as "
                    f"a NumPy pass or baseline the loop",
                    scope=scope,
                    detail=f"for:{ast.unparse(node.target)}")

    # -- BNG001 ----------------------------------------------------------

    def _check_dispatch_fn(self, path: str, fn: ast.FunctionDef):
        taint = _Taint()
        taint.visit(fn)
        scope = (scope_of(fn) + "." + fn.name).lstrip(".")
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if _is_force_call(node):
                    yield Finding(
                        "BNG001", path, node.lineno,
                        f"`{dotted(node.func)}()` forces a device value "
                        f"inside dispatch-scoped `{fn.name}` — forces "
                        f"belong in the retire path (completion ring)",
                        scope=scope, detail=dotted(node.func))
                elif (isinstance(node.func, ast.Name)
                      and node.func.id in SCALAR_FORCES and node.args
                      and taint.is_tainted(node.args[0])):
                    yield Finding(
                        "BNG001", path, node.lineno,
                        f"`{node.func.id}()` on a device-step result in "
                        f"dispatch-scoped `{fn.name}` blocks the host on "
                        f"the device",
                        scope=scope, detail=f"{node.func.id}()")
            elif isinstance(node, (ast.If, ast.While)):
                if taint.is_tainted(node.test):
                    yield Finding(
                        "BNG001", path, node.lineno,
                        f"truthiness on a device-step result in "
                        f"dispatch-scoped `{fn.name}` is an implicit "
                        f"blocking transfer",
                        scope=scope, detail="truthiness")

    # -- BNG002 / BNG003 -------------------------------------------------

    def _hooks(self, tree: ast.Module):
        """Module-level functions that delegate to `_ACTIVE.<attr>`
        without declaring `global _ACTIVE` (arm/disarm mutate it and are
        not hot), and the NAMED_HOOKS."""
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            has_global = any(isinstance(s, ast.Global) and
                             "_ACTIVE" in s.names for s in node.body)
            if has_global:
                continue
            delegates = node.name in NAMED_HOOKS or any(
                isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "_ACTIVE"
                for n in ast.walk(node))
            if delegates:
                yield node

    @staticmethod
    def _is_guard_test(test: ast.AST) -> bool:
        """Does `test` contain `_ACTIVE is None` / `is not None`?"""
        for n in ast.walk(test):
            if (isinstance(n, ast.Compare)
                    and isinstance(n.left, ast.Name)
                    and n.left.id == "_ACTIVE"
                    and any(isinstance(op, (ast.Is, ast.IsNot))
                            for op in n.ops)):
                return True
        return False

    def _check_hooks(self, path: str, tree: ast.Module):
        for fn in self._hooks(tree):
            body = fn.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                body = body[1:]  # docstring
            guard_idx = None
            for i, stmt in enumerate(body):
                if (isinstance(stmt, ast.If)
                        and self._is_guard_test(stmt.test)
                        and stmt.body
                        and isinstance(stmt.body[0], ast.Return)):
                    guard_idx = i
                    break
                if (isinstance(stmt, ast.Return) and stmt.value is not None
                        and self._is_guard_test(stmt.value)):
                    guard_idx = i  # `return _ACTIVE is not None` style
                    break
            if guard_idx is None:
                yield Finding(
                    "BNG003", path, fn.lineno,
                    f"hook `{fn.name}` delegates to _ACTIVE without an "
                    f"`if _ACTIVE is None: return` fast path — the "
                    f"disarmed cost contract requires "
                    f"guard-first",
                    scope=fn.name, detail=fn.name)
                continue
            # disarmed path = statements up to the guard, plus the
            # guard's own test and early-return body (a `return []`
            # there would still allocate per disarmed call)
            for stmt in body[: guard_idx + 1]:
                if stmt is body[guard_idx] and isinstance(stmt, ast.If):
                    nodes = [n for sub in ([stmt.test] + stmt.body)
                             for n in ast.walk(sub)]
                else:
                    nodes = ast.walk(stmt)
                for n in nodes:
                    bad = isinstance(n, ALLOC_NODES) or (
                        isinstance(n, ast.Call)
                        and call_name(n) in ALLOC_CALLS)
                    if bad:
                        yield Finding(
                            "BNG002", path, n.lineno,
                            f"allocation on the DISARMED path of hook "
                            f"`{fn.name}` — disarmed cost must stay one "
                            f"global load + is-None compare",
                            scope=fn.name,
                            detail=type(n).__name__)
                        break
