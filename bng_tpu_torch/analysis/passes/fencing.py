"""Device-time fencing (BNG050) — no timing of asynchronous launches
without a force: the port's copy of `bng_tpu/analysis/passes/fencing.py`,
read for torch.

The gray-failure class: a wall-clock window around an ASYNCHRONOUS
launch measures enqueue cost, not device time. A CUDA launch returns to
the host as soon as it is queued, so the window must contain its own
fence: a synchronize (`torch.cuda.synchronize`, `Event.synchronize`,
`Stream.synchronize`), a copy of a result to the host (`.item()`,
`.cpu()`, `.tolist()`, `.numpy()`, `np.asarray`), or one of the
serving path's own waits. Device time proper comes from CUDA events
(`profiling.profile_step_durations`).

The pass finds function-local timing windows:

    t1 = time.perf_counter()          # origin
    ... statements ...
    lat = time.perf_counter() - t1    # close

and flags windows that contain a dispatch to one of the async step
surfaces (`_step`, `_dhcp_step`, `_dispatch_step`, `_run_dhcp_batch`,
`dispatch_scheduled_bulk`, `submit`/`poll`, `process_ring_pipelined`,
and in the port `pipeline_step`, `dhcp_fastpath`, a graph's or a ring
program's `replay` and the engine's `_replay`)
but no fence (`synchronize`, `.item`/`.cpu`/`.tolist`/`.numpy`,
`np.asarray`, `flush`/`flush_pipeline`/`quiesce`, `wait`,
`profile_step_durations`). The reference's jax fences
(`block_until_ready`, `device_get`) fence nothing in torch and are not
read. Synchronous surfaces (`process`, `process_dhcp`, `process_ring`) force
their own outputs and are not dispatch hazards.
"""

from __future__ import annotations

import ast

from bng_tpu_torch.analysis.core import Finding, Pass, Project, call_name, dotted

CLOCK_CALLS = {"time.time", "time.perf_counter", "time.perf_counter_ns",
               "time.monotonic", "perf_counter", "perf_counter_ns",
               "monotonic"}
# the reference's surfaces, and what launches directly in the port: the
# fused step and the DHCP-only program are plain calls that queue their
# kernels, and a CUDA graph's `replay()` returns once it is queued
# (a ring program's `replay` and the engine's `_replay` around it queue a
# tape of graphs and kernel launches, and return once it is queued)
ASYNC_DISPATCH = {"_step", "_dhcp_step", "_dispatch_step",
                  "_run_dhcp_batch", "dispatch_scheduled_bulk",
                  "submit", "poll", "process_ring_pipelined", "step_fn",
                  "pipeline_step", "dhcp_fastpath", "replay", "_replay"}
FENCES = {"synchronize", "item", "cpu", "tolist", "numpy", "asarray",
          "array", "flush", "flush_pipeline", "quiesce",
          "profile_step_durations", "drain_completions_blocking", "wait"}


def _clock_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and dotted(node.func) in CLOCK_CALLS)


class FencingPass(Pass):
    name = "fencing"
    description = ("wall-clock windows over async dispatches must "
                   "contain a force/fence")
    codes = {
        "BNG050": "timing window over an asynchronous launch without a "
                  "synchronize or another force",
    }

    def run(self, project: Project) -> list[Finding]:
        out: list[Finding] = []
        for sf in project.files:
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.extend(self._check_fn(sf, node))
        return out

    def _check_fn(self, sf, fn: ast.FunctionDef):
        stmts = self._flat_statements(fn)
        origins: dict[str, int] = {}  # clock var -> stmt index
        for idx, stmt in enumerate(stmts):
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and _clock_call(stmt.value)):
                origins[stmt.targets[0].id] = idx
                continue
            for var, start in list(origins.items()):
                if self._closes_window(stmt, var):
                    yield from self._check_window(
                        sf, fn, stmts[start + 1: idx + 1], stmt.lineno, var)
                    origins.pop(var, None)

    @staticmethod
    def _flat_statements(fn: ast.FunctionDef) -> list[ast.stmt]:
        """Statement stream in source order, descending into compound
        bodies (a window often opens before a loop and closes after)."""
        out: list[ast.stmt] = []

        def walk(body):
            for s in body:
                out.append(s)
                for attr in ("body", "orelse", "finalbody"):
                    inner = getattr(s, attr, None)
                    if inner:
                        walk(inner)
                for h in getattr(s, "handlers", ()):
                    walk(h.body)

        walk(fn.body)
        return out

    @staticmethod
    def _closes_window(stmt: ast.stmt, var: str) -> bool:
        """Does this statement compute `time.X() - var`?"""
        for node in ast.walk(stmt):
            if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
                    and isinstance(node.right, ast.Name)
                    and node.right.id == var
                    and _clock_call(node.left)):
                return True
        return False

    def _check_window(self, sf, fn, window: list[ast.stmt],
                      close_line: int, var: str):
        dispatched = None
        fenced = False
        for stmt in window:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name in ASYNC_DISPATCH and dispatched is None:
                    dispatched = (name, node.lineno)
                if name in FENCES:
                    fenced = True
        if dispatched is not None and not fenced:
            name, line = dispatched
            yield Finding(
                "BNG050", sf.path, close_line,
                f"timing window `{var}` (closed here) spans the async "
                f"dispatch `{name}` (line {line}) with no "
                f"synchronize/force — this measures enqueue cost, "
                f"not device time (the CPU-headline gray-failure class)",
                scope=f"{fn.name}", detail=f"{var}-{name}")
