"""Registry-consistency passes (BNG030–BNG035).

Five vocabularies in this codebase are load-bearing: a call site using
a name outside them doesn't fail loudly — it records telemetry into a
garbage stage index, registers a fault nobody can trigger, exports a
metric no dashboard scrapes, or writes a checkpoint component restore
can never read back. Each check here compares call sites against the
declared registry, both parsed from source (facts.py):

* **BNG030** — span stage/lane argument not in the fixed vocabulary of
  telemetry/spans.py (stages are array indexes; a stray name is an
  out-of-bounds store). String or bare-int stage arguments are flagged
  unconditionally — the vocabulary is attribute constants, not strings.
* **BNG031** — `fault_point("x")` / `mutate_point("x")` / FaultSpec
  point not registered in chaos/faults.py POINT_KINDS.
* **BNG032** — metric family declared without the `bng_` prefix.
* **BNG033** — checkpoint component keys asymmetric between the save
  path and the restore path of runtime/checkpoint.py.
* **BNG034** — flight-recorder trigger reason not declared as a TRIG_*
  constant in telemetry/recorder.py.
* **BNG035** — metric family constructed outside control/metrics.py
  (families live in BNGMetrics so /metrics exposition is complete).
"""

from __future__ import annotations

import ast

from bng_tpu_torch.analysis import facts
from bng_tpu_torch.analysis.core import (Finding, Pass, Project, call_name,
                                         dotted, scope_of, str_const)

# hook name -> which positional arg carries the stage / lane constant
STAGE_HOOKS = {"lap": 0, "stamp": 0, "observe": 0, "observe_many": 0,
               "span": 0, "merge_stage": 0, "region": 0}
LANE_HOOKS = {"begin_batch": 0}
FAULT_HOOKS = {"fault_point": 0, "mutate_point": 0}


class RegistryPass(Pass):
    name = "registry"
    description = ("span stages, fault points, metric families, "
                   "checkpoint components and trigger reasons all "
                   "declared in their registries")
    codes = {
        "BNG030": "span stage/lane outside the fixed vocabulary",
        "BNG031": "fault/mutate point not registered in POINT_KINDS",
        "BNG032": "metric family without the bng_ prefix",
        "BNG033": "checkpoint component key asymmetric between "
                  "save and restore",
        "BNG034": "flight-recorder trigger reason not declared",
        "BNG035": "metric family declared outside control/metrics.py",
    }

    def run(self, project: Project) -> list[Finding]:
        out: list[Finding] = []
        vocab = facts.stage_vocabulary(project)
        points = facts.fault_registry(project)
        reasons = facts.trigger_reasons(project)
        comps = facts.checkpoint_components(project)

        if vocab is None:
            out.append(self.config_finding(
                "stages", "span stage vocabulary not found in "
                f"{facts.SPANS_FILE} — BNG030 cannot run"))
        if points is None:
            out.append(self.config_finding(
                "fault-points", "POINT_KINDS not found in "
                f"{facts.FAULTS_FILE} — BNG031 cannot run"))
        if reasons is None:
            out.append(self.config_finding(
                "trigger-reasons", "TRIG_* reasons not found in "
                f"{facts.RECORDER_FILE} — BNG034 cannot run"))
        if comps is None:
            out.append(self.config_finding(
                "checkpoint-components", "save/restore component keys "
                f"not found in {facts.CHECKPOINT_FILE} — BNG033 cannot "
                f"run"))

        for sf in project.files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if vocab is not None and name in STAGE_HOOKS:
                    out.extend(self._check_stage(sf, node, name, *vocab))
                if vocab is not None and name in LANE_HOOKS:
                    out.extend(self._check_lane(sf, node, vocab[1]))
                if points is not None and name in FAULT_HOOKS:
                    out.extend(self._check_fault(sf, node, points))
                if points is not None and name == "FaultSpec":
                    out.extend(self._check_faultspec(sf, node, points))
                if name == "trigger" and reasons is not None:
                    out.extend(self._check_trigger(sf, node, reasons))
                out.extend(self._check_metric_decl(sf, node, name))
        if comps is not None:
            out.extend(self._check_components(comps))
        return out

    # -- BNG030 ----------------------------------------------------------

    def _check_stage(self, sf, node: ast.Call, hook: str,
                     stages: set, lanes: set):
        if not node.args:
            return
        arg = node.args[0]
        # only check hook-shaped call sites: tele.lap(...), spans.lap(...)
        # or self.lap(...) inside spans.py itself pass Name args through
        if isinstance(arg, ast.Attribute):
            if arg.attr.isupper() and arg.attr not in stages:
                yield Finding(
                    "BNG030", sf.path, node.lineno,
                    f"`{hook}({dotted(arg)})` uses a stage outside the "
                    f"fixed vocabulary — stages are array indexes, an "
                    f"unknown constant is an out-of-bounds store",
                    scope=scope_of(node), detail=arg.attr)
        elif isinstance(arg, ast.Constant):
            if isinstance(arg.value, (str, int)):
                yield Finding(
                    "BNG030", sf.path, node.lineno,
                    f"`{hook}({arg.value!r})` passes a literal stage — "
                    f"use the spans.py constants (the vocabulary is "
                    f"fixed; free-form names defeat the preallocated "
                    f"array design)",
                    scope=scope_of(node), detail=str(arg.value))

    def _check_lane(self, sf, node: ast.Call, lanes: set):
        if not node.args:
            return
        arg = node.args[0]
        if isinstance(arg, ast.Attribute) and arg.attr.startswith("LANE_"):
            if arg.attr not in lanes:
                yield Finding(
                    "BNG030", sf.path, node.lineno,
                    f"`begin_batch({dotted(arg)})` uses an unknown lane "
                    f"constant",
                    scope=scope_of(node), detail=arg.attr)

    # -- BNG031 ----------------------------------------------------------

    def _check_fault(self, sf, node: ast.Call, points: set):
        if not node.args:
            return
        lit = str_const(node.args[0])
        if lit is not None and lit not in points:
            yield Finding(
                "BNG031", sf.path, node.lineno,
                f"fault point \"{lit}\" is not registered in "
                f"chaos/faults.py POINT_KINDS — the soak generator and "
                f"explicit plans can never fire it",
                scope=scope_of(node), detail=lit)

    def _check_faultspec(self, sf, node: ast.Call, points: set):
        lit = None
        if node.args:
            lit = str_const(node.args[0])
        for kw in node.keywords:
            if kw.arg == "point":
                lit = str_const(kw.value)
        if lit is not None and lit not in points:
            yield Finding(
                "BNG031", sf.path, node.lineno,
                f"FaultSpec(point=\"{lit}\") names an unregistered fault "
                f"point — no call site will ever honor it",
                scope=scope_of(node), detail=lit)

    # -- BNG032 / BNG035 -------------------------------------------------

    METRIC_DECLS = {"counter", "gauge", "histogram",
                    "Counter", "Gauge", "Histogram"}

    def _check_metric_decl(self, sf, node: ast.Call, name: str):
        if name not in self.METRIC_DECLS or not node.args:
            return
        fam = str_const(node.args[0])
        if fam is None:
            return
        if not fam.startswith("bng_"):
            yield Finding(
                "BNG032", sf.path, node.lineno,
                f"metric family \"{fam}\" lacks the bng_ prefix — the "
                f"exposition contract (metrics.go parity) is bng_*",
                scope=scope_of(node), detail=fam)
        if not sf.path.endswith("control/metrics.py"):
            yield Finding(
                "BNG035", sf.path, node.lineno,
                f"metric family \"{fam}\" declared outside "
                f"control/metrics.py — families live in BNGMetrics so "
                f"the /metrics exposition and collect loop stay complete",
                scope=scope_of(node), detail=fam)

    # -- BNG033 ----------------------------------------------------------

    def _check_components(self, comps: dict):
        save, restore = comps["save"], comps["restore"]
        for key in sorted(save - restore):
            yield Finding(
                "BNG033", facts.CHECKPOINT_FILE, comps["line"],
                f"checkpoint component \"{key}\" is written by the save "
                f"path but the restore path never consumes it — "
                f"state silently lost across warm restart",
                scope="restore_into", detail=f"save-only:{key}")
        for key in sorted(restore - save):
            yield Finding(
                "BNG033", facts.CHECKPOINT_FILE, comps["line"],
                f"checkpoint component \"{key}\" is consumed by restore "
                f"but never written by save — dead restore arm or a "
                f"missing save hook",
                scope="restore_into", detail=f"restore-only:{key}")
        for key in sorted(comps["payload"] - save):
            yield Finding(
                "BNG033", facts.CHECKPOINT_FILE, comps["line"],
                f"payload-JSON component \"{key}\" not produced by the "
                f"save path",
                scope="payload", detail=f"payload-only:{key}")

    # -- BNG034 ----------------------------------------------------------

    def _check_trigger(self, sf, node: ast.Call, reasons: set):
        if not node.args:
            return
        lit = str_const(node.args[0])
        if lit is not None and lit not in reasons:
            yield Finding(
                "BNG034", sf.path, node.lineno,
                f"flight-recorder trigger \"{lit}\" is not a declared "
                f"TRIG_* reason — dashboards key dumps on the fixed "
                f"reason set",
                scope=scope_of(node), detail=lit)
