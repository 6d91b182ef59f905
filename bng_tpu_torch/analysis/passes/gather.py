"""Narrow-gather lint (BNG014) — table rows must be gather-wide: the
port's copy of `bng_tpu/analysis/passes/gather.py`, its in-function
check read for torch.

The reference measured composed narrow gathers (<8-word rows,
1-word-per-index in the limit) as serialized loops on its accelerator,
while >=8-word row gathers ran at full speed, and widened every table's
value rows to 8 words; the port keeps the same row layout (its tables
are converted word for word), and on the card a narrow-row gather is
the uncoalesced shape too (one 4-byte load per 32-byte sector). This
pass keeps that discipline machine-checked instead of folklore:

- **BNG014 / table construction**: any `HostTable(...)` whose resolved
  `val_words` is < 8 — its device `vals[slot]` gather is exactly the
  serialization shape. Widths resolve from int literals or from
  module-level integer constants anywhere in the scanned project (the
  registry-pass fact discipline: the repo's own AST is the source of
  truth). Probe-row width needs no check — `way_stride` rounds key
  rows up to 8 words by construction.
- **BNG014 / in-function gather**: inside ops/ device code, a
  subscript gather `arr[idx]` whose base was assigned in the same
  function from `torch.zeros`/`ones`/`full`/`empty` with a LITERAL
  last dim < 8 (or a 1-D literal shape) and a non-trivial index
  expression. Torch arrays are mutable, so the torch reading also
  leaves out what is no gather: a subscript written to (`stats[ST_X] +=
  n`) and an index that is a module constant (an ALL-CAPS name).
  Dynamic widths are out of scope — the table check above covers the
  real fleet, this one catches fresh narrow scratch arrays before they
  ship.

A narrow table a change genuinely needs (host-only lookup tables never
gathered on device) is baselined with a justification like every other
pass's accepted debt.
"""

from __future__ import annotations

import ast

from bng_tpu_torch.analysis.core import (Finding, Pass, Project, call_name,
                                         dotted, enclosing_function, scope_of)

MIN_ROW_WORDS = 8

# device-array constructors only (torch.*; the reference reads jnp.*):
# host-side numpy index ops in the same files (HostTable.bulk_insert's
# boolean masks) never reach a device gather and are out of scope
_ARRAY_CTORS = {"torch.zeros", "torch.ones", "torch.full", "torch.empty"}


def _int_const(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


_AMBIGUOUS = object()  # same name, different values across modules


def _module_int_constants(project: Project):
    """(per_file {path: {NAME: value}}, global {NAME: value|_AMBIGUOUS})
    over every module-level `NAME = <int>` assignment in the scan set.
    Resolution is same-file first, then the global table — where a name
    defined with CONFLICTING values in two modules is poisoned rather
    than first-wins (the PR-9 class-name-collision lesson: a shadowed
    constant must make the width UNRESOLVED, never silently wrong)."""
    per_file: dict[str, dict[str, int]] = {}
    global_c: dict = {}
    for sf in project.files:
        mine = per_file.setdefault(sf.path, {})
        for stmt in sf.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                v = _int_const(stmt.value)
                if v is None:
                    continue
                name = stmt.targets[0].id
                mine.setdefault(name, v)
                if name in global_c and global_c[name] != v:
                    global_c[name] = _AMBIGUOUS
                else:
                    global_c.setdefault(name, v)
    return per_file, global_c


class NarrowGatherPass(Pass):
    name = "gather"
    description = ("<8-word table/value rows are the narrow-gather "
                   "serialization shape")
    codes = {
        "BNG014": "narrow gather: table value rows (or a gathered array's "
                  "rows) are < 8 words — the measured serialization shape",
    }

    def run(self, project: Project) -> list[Finding]:
        out: list[Finding] = []
        per_file, global_c = _module_int_constants(project)
        saw_table_ctor = False
        for sf in project.files:
            consts = dict(global_c)
            consts.update(per_file.get(sf.path, {}))  # same-file wins
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call) \
                        and call_name(node) == "HostTable":
                    saw_table_ctor = True
                    out.extend(self._check_ctor(sf, node, consts))
            if sf.path.startswith("bng_tpu_torch/ops/"):
                out.extend(self._check_local_gathers(sf))
        if not saw_table_ctor and project.find_file("ops/table.py"):
            # the fact source moved out from under the width check
            out.append(self.config_finding(
                "no-hosttable-ctors",
                "gather pass found ops/table.py but no HostTable "
                "construction anywhere in the scan set — width facts "
                "unextractable (BNG990: fail loud, not silently pass)"))
        return out

    # -- table constructions ------------------------------------------------

    def _check_ctor(self, sf, call: ast.Call, consts: dict[str, int]):
        width = None
        src = None
        args = list(call.args)
        # HostTable(nbuckets, key_words, val_words, ...) — positional 3rd
        if len(args) >= 3:
            width, src = self._resolve(args[2], consts)
        for kw in call.keywords:
            if kw.arg == "val_words":
                width, src = self._resolve(kw.value, consts)
        if width is None or width >= MIN_ROW_WORDS:
            return
        name = ""
        for kw in call.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name = str(kw.value.value)
        yield Finding(
            "BNG014", sf.path, call.lineno,
            f"HostTable {name or '<unnamed>'} has val_words={width} "
            f"(< {MIN_ROW_WORDS}): its device vals[slot] gather is the "
            f"narrow-row serialization shape — pad the "
            f"value rows to {MIN_ROW_WORDS} words (free HBM, the narrow "
            f"gather is not) or baseline with a justification",
            scope=scope_of(call), detail=f"{name or 'table'}-val_words-{width}"
            + (f"-{src}" if src else ""))

    @staticmethod
    def _resolve(node: ast.AST, consts: dict):
        v = _int_const(node)
        if v is not None:
            return v, None
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):  # module.CONST
            name = node.attr
        if name is None:
            return None, None
        got = consts.get(name)
        if got is _AMBIGUOUS:  # conflicting cross-module definitions
            return None, name
        return got, name

    # -- fresh narrow arrays gathered in ops/ device code -------------------

    def _check_local_gathers(self, sf):
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            narrow: dict[str, tuple[int, int]] = {}  # var -> (width, line)
            for stmt in ast.walk(fn):
                if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Call)
                        and dotted(stmt.value.func) in _ARRAY_CTORS):
                    w = self._literal_row_width(stmt.value)
                    if w is not None and w < MIN_ROW_WORDS:
                        narrow[stmt.targets[0].id] = (w, stmt.lineno)
            if not narrow:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Subscript):
                    continue
                base = node.value
                if not (isinstance(base, ast.Name) and base.id in narrow):
                    continue
                if isinstance(node.ctx, ast.Store):
                    continue  # a write into the array, not a gather
                if enclosing_function(node) is not fn:
                    continue
                if self._trivial_index(node.slice):
                    continue
                w, line = narrow[base.id]
                yield Finding(
                    "BNG014", sf.path, node.lineno,
                    f"gather of `{base.id}` (built line {line} with "
                    f"{w}-word rows, < {MIN_ROW_WORDS}) by a computed "
                    f"index — the narrow-row serialization shape; "
                    f"pad the rows to {MIN_ROW_WORDS} words",
                    scope=f"{scope_of(node)}" or fn.name,
                    detail=f"{base.id}-rows-{w}")

    @staticmethod
    def _literal_row_width(call: ast.Call) -> int | None:
        """Last-dim width of a zeros/ones/full literal shape; a 1-D
        shape is width 1 (the worst case). Non-literal dims -> None."""
        if not call.args:
            return None
        shape = call.args[0]
        if isinstance(shape, ast.Tuple):
            if not shape.elts:
                return None
            last = _int_const(shape.elts[-1])
            return last if len(shape.elts) > 1 else 1
        if _int_const(shape) is not None:
            return 1
        return None

    @staticmethod
    def _trivial_index(sl: ast.AST) -> bool:
        """Constant / slice / constant-tuple indexing is not a gather."""
        if isinstance(sl, (ast.Slice, ast.Constant)):
            return True
        if isinstance(sl, ast.Name) and sl.id.isupper():
            return True  # a module constant: one fixed element
        if isinstance(sl, ast.UnaryOp) and isinstance(sl.operand,
                                                      ast.Constant):
            return True
        if isinstance(sl, ast.Tuple):
            return all(NarrowGatherPass._trivial_index(e) for e in sl.elts)
        return False
