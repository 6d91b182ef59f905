"""Jit-discipline audit read for torch (BNG010; BNG011/BNG012 listed and
not applied): the port's counterpart of
`bng_tpu/analysis/passes/jit_discipline.py`.

The reference audits every `jax.jit` site for three retrace/donation
hazards. The port traces nothing: its compiled programs are CUDA graphs
captured over static buffers (the express program, the devloop ring) and
the hand-written kernels, compiled by `nvcc` and loaded from shared
libraries (`kernels.build`/`kernels.entry`). The same rules, read for
that:

* **BNG010 — a compiled program built inside an uncached function.** A
  CUDA graph capture (`torch.cuda.CUDAGraph()`, `torch.cuda.graph(...)`,
  `torch.cuda.make_graphed_callables`) or a kernel build
  (`kernels.build()`, `build()` inside `kernels.py`, `triton.jit`,
  `torch.utils.cpp_extension.load`/`load_inline`) in a function body
  without `functools.lru_cache` builds a new program per call — the
  counterpart of a `jax.jit` per call. Builders that memoize through
  their caller (a program dict keyed on geometry and resync count, the
  `_ENTRIES` dict keyed on kernel name) are baselined with that key, as
  the reference baselines its per-process builders, so a new uncached
  site shows up.

* **BNG011 and BNG012 do not apply to the port** (`NOT_APPLIED` says
  why). They stay in the catalog, so `--codes` lists every code of the
  reference, and this pass emits neither.
"""

from __future__ import annotations

import ast

from bng_tpu_torch.analysis.core import (Finding, Pass, Project, dotted,
                                         enclosing_function, scope_of)

CACHE_DECORATORS = {"lru_cache", "cache"}
# CUDA graph construction: each capture is a compiled program
GRAPH_BUILDS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                "torch.cuda.make_graphed_callables", "CUDAGraph",
                "make_graphed_callables"}
# kernel builds: nvcc through the port's builder, or a JIT kernel compiler
KERNEL_BUILDS = {"kernels.build", "triton.jit",
                 "torch.utils.cpp_extension.load",
                 "torch.utils.cpp_extension.load_inline",
                 "cpp_extension.load", "cpp_extension.load_inline"}
KERNELS_MODULE = "kernels.py"  # where a bare `build()` is the nvcc build

# the reference's codes with no torch counterpart -> why
NOT_APPLIED = {
    "BNG011": "torch has no buffer donation: the port's fused step updates "
              "its device tables in place (index_put_/copy_ into the same "
              "tensors), so no second copy of a table is ever live",
    "BNG012": "nothing in the port is traced: a Python scalar passed to a "
              "torch op or a kernel wrapper is a launch argument, never a "
              "retrace, and the step takes `now` as device tensors while a "
              "graph replay takes no arguments at all",
}


def _has_cache_decorator(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        d = dotted(dec.func if isinstance(dec, ast.Call) else dec)
        if d.rsplit(".", 1)[-1] in CACHE_DECORATORS:
            return True
    return False


class JitDisciplinePass(Pass):
    name = "jit-discipline"
    description = ("CUDA graphs and kernels built only in cached builders "
                   "(BNG011/BNG012 do not apply to the port)")
    codes = {
        "BNG010": "CUDA graph captured or kernel built inside an uncached "
                  "function (a new program per call)",
        "BNG011": "not applied to the port — table-updating jitted step "
                  "without donate_argnums: " + NOT_APPLIED["BNG011"],
        "BNG012": "not applied to the port — bare Python scalar / "
                  "unhashable static at a jitted call site: "
                  + NOT_APPLIED["BNG012"],
    }

    def run(self, project: Project) -> list[Finding]:
        out: list[Finding] = []
        for sf in project.files:
            out.extend(self._check_file(sf.path, sf.tree))
        return out

    def _check_file(self, path: str, tree: ast.Module):
        in_kernels = path.endswith(KERNELS_MODULE)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in GRAPH_BUILDS:
                kind = "graph"
            elif d in KERNEL_BUILDS or (in_kernels and d == "build"):
                kind = "kernel"
            else:
                continue
            fn = enclosing_function(node)
            if fn is None or _has_cache_decorator(fn):
                continue  # built once at import, or in a cached factory
            what = ("CUDA graph captured" if kind == "graph"
                    else "kernel built")
            yield Finding(
                "BNG010", path, node.lineno,
                f"{what} (`{d}`) inside `{fn.name}` without "
                f"functools.lru_cache — a new program per call unless the "
                f"caller memoizes it (baseline the memo key, or cache the "
                f"builder)",
                scope=scope_of(node), detail=f"{kind}-in-{fn.name}")
