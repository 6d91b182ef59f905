"""Error-handler audit (BNG020/BNG021) — the Yuan et al. OSDI'14 pass.

The failure study behind this pass found 92% of catastrophic
distributed-system failures rooted in *already-signaled* errors that a
handler then mishandled — and that the three dominant anti-patterns
(empty handler, catch-all that "logs and continues" without logging,
TODO handlers) are trivially statically checkable. Scope here is
`control/` and `runtime/` (the subsystems whose swallowed errors cost
leases, table rows or checkpoints). The port's copy of
`bng_tpu/analysis/passes/handlers.py`, scoped to the port's files.

* **BNG020** — a broad handler (`except:`, `except Exception`,
  `except BaseException`) whose body is only `pass`/`...`: the error is
  fully swallowed.
* **BNG021** — a broad handler that neither re-raises, returns an error
  signal, structlogs, bumps a metric, nor increments an error counter:
  the error is converted to silence. A handler that does ANY of those
  is fine — the pass checks signal propagation, not style.

Narrow handlers (`except ValueError: pass`) are accepted: catching a
specific, expected signal and discarding it is the Pythonic non-local
`if`, and flagging it would bury the real findings in noise.
"""

from __future__ import annotations

import ast

from bng_tpu_torch.analysis.core import Finding, Pass, Project, call_name, scope_of

SCOPE_PREFIXES = ("bng_tpu_torch/control/", "bng_tpu_torch/runtime/")

BROAD = {"Exception", "BaseException"}
LOG_METHODS = {"debug", "info", "warning", "error", "exception", "critical",
               "log", "report"}
METRIC_METHODS = {"inc", "dec", "observe", "set", "set_total", "add"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        tail = n.attr if isinstance(n, ast.Attribute) else (
            n.id if isinstance(n, ast.Name) else "")
        if tail in BROAD:
            return True
    return False


def _is_pass_only(handler: ast.ExceptHandler) -> bool:
    body = handler.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]  # a docstring-style comment doesn't handle anything
    if not body:
        return True
    return all(isinstance(s, ast.Pass) or
               (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis)
               for s in body)


def _signals(handler: ast.ExceptHandler) -> bool:
    """Does the handler propagate the error signal anywhere?"""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Continue, ast.Break)):
            return True
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in LOG_METHODS or name in METRIC_METHODS:
                return True
            if name in ("print",):  # stderr diagnostics in CLI paths
                return True
        if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add):
            # error-counter convention: self.stats.slow_errors += 1 etc.
            return True
    return False


class HandlerAuditPass(Pass):
    name = "handler-audit"
    description = ("no swallowed broad exception handlers in control/ "
                   "and runtime/ (Yuan OSDI'14)")
    codes = {
        "BNG020": "broad except with pass-only body (error fully "
                  "swallowed)",
        "BNG021": "broad except that neither re-raises, logs, nor "
                  "counts",
    }

    def run(self, project: Project) -> list[Finding]:
        out: list[Finding] = []
        for sf in project.files:
            if not sf.path.startswith(SCOPE_PREFIXES):
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if not _is_broad(node):
                    continue
                scope = scope_of(node)
                if _is_pass_only(node):
                    out.append(Finding(
                        "BNG020", sf.path, node.lineno,
                        "broad exception handler swallows the error with "
                        "`pass` — log it (rate-limited structlog), count "
                        "it, or narrow the except",
                        scope=scope, detail="pass-only"))
                elif not _signals(node):
                    out.append(Finding(
                        "BNG021", sf.path, node.lineno,
                        "broad exception handler neither re-raises, "
                        "logs, nor bumps a metric — the signaled error "
                        "becomes silence (Yuan OSDI'14 class)",
                        scope=scope, detail="silent-handler"))
        return out
