"""bngcheck over the port (`bng_tpu_torch/analysis/`) against the reference
analyzer (`bng_tpu/analysis/`).

- **Parity harness.** Every miniature tree of the reference's
  `tests/test_analysis.py` is written twice: as the reference case writes
  it (`bng_tpu/...`) for the reference analyzer, and renamed
  (`bng_tpu_torch/...`, the same text with the package renamed) for the
  port's. Both run the same passes; the findings must be the same
  `(code, path, line, scope, detail)`, the port's paths renamed back.
  The reference case's own assertions run on the reference's findings.
  (`tests/test_concurrency.py` writes no tree: it drives the runtime
  ownership sanitizer.) The fixtures whose rule reads jax idiom
  (`PORT_READING`) hold the port's torch reading instead: on jax code it
  finds what torch would. So does the fixture whose loops sit in
  functions the port does not have (the reference's vector host path).
- **The reference's cases on the port.** The reference test module with
  its package renamed (`TWIN`) runs case by case on the port: its own
  fixtures, CLI subprocesses, baseline mechanics and the clean-corpus
  gates over the port's tree, with the port's baseline.
- **Torch readings.** BNG001, BNG004, BNG010, BNG014 and BNG050 each get
  a planted violation and a clean twin in the port's idiom, and so does the
  stage hook `region` (a stray stage: BNG030; an allocation on its
  disarmed path: BNG002); BNG011 and BNG012
  are listed by `--codes` as not applying to the port, and are never
  emitted.
- **The real tree.** `check` exits 0 on the port, no baseline entry is
  tagged `TODO: justify`, every scope table names functions and files
  the port has, and importing the analyzer imports neither torch nor
  jax.

Tolerance: exact (findings, codes and exit codes).
"""

import inspect
import json
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

import test_analysis as ref_an
from bng_tpu.analysis.core import Project as JProject
from bng_tpu.analysis.core import run_passes as j_run_passes
from bng_tpu.analysis.passes import all_codes as j_all_codes
from bng_tpu.analysis.passes import build as j_build
from bng_tpu_torch.analysis import baseline as t_baseline
from bng_tpu_torch.analysis.core import Project as TProject
from bng_tpu_torch.analysis.core import run_passes as t_run_passes
from bng_tpu_torch.analysis.passes import all_codes as t_all_codes
from bng_tpu_torch.analysis.passes import build as t_build
from bng_tpu_torch.analysis.passes import hotpath as t_hotpath
from bng_tpu_torch.analysis.passes import jit_discipline as t_jit
from bng_tpu_torch.analysis.passes import single_writer as t_sw

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
_PKG = re.compile(r"\bbng_tpu\b")


def to_port(text: str) -> str:
    return _PKG.sub("bng_tpu_torch", text)


def port_tree(root: Path, dest: Path) -> Path:
    """The reference fixture tree under `root`, renamed for the port."""
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        q = dest / to_port(rel)
        q.parent.mkdir(parents=True, exist_ok=True)
        q.write_text(to_port(p.read_text()))
    return dest


def findings_key(found, port: bool):
    out = []
    for f in found:
        path = re.sub(r"^bng_tpu_torch/", "bng_tpu/", f.path) if port else f.path
        out.append((f.code, path, f.line, f.scope, f.detail))
    return out


def cases_of(module, pred):
    out = []
    for name, cls in vars(module).items():
        if not (inspect.isclass(cls) and name.startswith("Test")):
            continue
        for meth, fn in vars(cls).items():
            if meth.startswith("test_") and pred(fn):
                out.append(f"{name}::{meth}")
    return out


def run_case(module, case, request, g=None):
    """Run `Class::method` of a test module, its method rebound to the
    globals `g` when given, its fixtures from this module's scope."""
    cls_name, meth = case.split("::")
    cls = getattr(module, cls_name)
    fn = vars(cls)[meth]
    if g is not None:
        fn = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                                fn.__closure__)
    params = list(inspect.signature(fn).parameters)[1:]
    fn(cls(), **{p: request.getfixturevalue(p) for p in params})


# ---- the parity harness ---------------------------------------------------

# fixtures whose rule the port reads for torch: the reference's tree is
# jax code, so the port finds what torch would -> (why, the port's codes)
_JIT = ("jax.jit is not a torch build: the port's BNG010 reads CUDA graph "
        "captures and kernel builds, and BNG011/BNG012 do not apply")
PORT_READING = {
    **{c: (_JIT, []) for c in cases_of(
        ref_an, lambda fn: True) if c.startswith("TestJitDisciplinePass::")},
    "TestFencingPass::test_fenced_timing_clean": (
        "its fence is jax.block_until_ready, which fences nothing in torch: "
        "the window over the launch is flagged", ["BNG050"]),
    "TestNarrowGatherPass::test_device_narrow_array_gather_flagged": (
        "its scratch array is jnp.zeros; the port reads torch constructors",
        []),
    "TestHotPathPass::test_batch_scope_loop_flagged": (
        "its loops sit in the reference's vector host path (`_assemble_vec`, "
        "`_complete_vec`), which the port does not have; the port's batch "
        "scope is read in TORCH_READINGS", []),
}

PARITY_CASES = cases_of(ref_an, lambda fn: "run_on(" in inspect.getsource(fn))


@pytest.mark.parametrize("case", PARITY_CASES)
def test_reference_fixture_gives_the_same_findings(case, request, tmp_path_factory):
    calls = []

    def run_on(root, select):
        ref = j_run_passes(JProject.load(root, [root]), j_build(select)).findings
        proot = port_tree(root, tmp_path_factory.mktemp("port"))
        port = t_run_passes(TProject.load(proot, [proot]), t_build(select)).findings
        calls.append((sorted(select), findings_key(ref, False), findings_key(port, True)))
        return ref

    g = dict(vars(ref_an))
    g["run_on"] = run_on
    run_case(ref_an, case, request, g)
    assert calls, "the case ran no analysis"
    for select, ref, port in calls:
        if case in PORT_READING:
            assert [k[0] for k in port] == PORT_READING[case][1], (select, port)
        else:
            assert port == ref, (select, ref, port)


def test_parity_harness_covers_every_tree_writing_case():
    writers = cases_of(ref_an, lambda fn: "write_tree(" in inspect.getsource(fn))
    in_process = set(PARITY_CASES)
    # the rest run the analyzer in a subprocess or through the extraction
    # cache: the renamed reference module holds them on the port below
    rest = [c for c in writers if c not in in_process]
    assert rest and all(c.startswith(("TestConcurrencyFacts::", "TestCLI::")) for c in rest)
    assert len(PARITY_CASES) == 65 and set(PORT_READING) <= in_process


# ---- the reference's cases, renamed, on the port --------------------------

TWIN = types.ModuleType("test_analysis_port_twin")
TWIN.__file__ = ref_an.__file__
exec(compile(to_port(inspect.getsource(ref_an)), ref_an.__file__, "exec"), vars(TWIN))
repo_report = TWIN.repo_report  # the port's clean-corpus fixture (module scope)

TWIN_CASES = [c for c in cases_of(TWIN, lambda fn: True) if c not in PORT_READING]


@pytest.mark.parametrize("case", TWIN_CASES)
def test_reference_case_holds_on_the_port(case, request):
    run_case(TWIN, case, request)


def test_twin_is_the_port():
    assert TWIN.Project is TProject and TWIN.build is t_build
    code = TWIN.TestHotPathPass.test_dispatch_scope_force_flagged.__code__
    assert "bng_tpu_torch/runtime/engine.py" in code.co_consts
    assert len(TWIN_CASES) + len(PORT_READING) == len(cases_of(ref_an, lambda fn: True))


# ---- torch readings: a planted violation and its clean twin each ----------

def _run(tmp_path, files, select):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return t_run_passes(TProject.load(tmp_path, [tmp_path]), t_build(select)).findings


ENGINE = "bng_tpu_torch/runtime/engine.py"
SPANS = "bng_tpu_torch/telemetry/spans.py"
# the registries the registry pass reads besides the stages
REGISTRIES = {"bng_tpu_torch/chaos/faults.py": ref_an.MINI_FAULTS,
              "bng_tpu_torch/telemetry/recorder.py": ref_an.MINI_RECORDER,
              "bng_tpu_torch/runtime/checkpoint.py": ref_an.MINI_CKPT}
REGION_SPANS = """\
(RING, DISPATCH, DHCP, TOTAL) = range(4)
STAGE_NAMES = ("ring", "dispatch", "dhcp", "total")
(LANE_ENGINE, LANE_BENCH) = range(2)
LANE_NAMES = ("engine", "bench")

_ACTIVE = None
_NOOP = None
_profiler = None


def region(stage):
    if _ACTIVE is None and not _profiler:
        return _NOOP
    return (stage, _ACTIVE)
"""
TORCH_READINGS = {
    "BNG001-dispatch-forces": ({ENGINE: """\
        import numpy as np
        import torch


        class Engine:
            def _dispatch_step(self, pkt, ev):
                res = pipeline_step(self.tables, pkt)
                n = res.verdict.sum().item()      # .item()
                v = res.out_len.cpu()             # .cpu()
                lst = res.verdict.tolist()        # .tolist()
                a = res.verdict.numpy()           # .numpy()
                h = np.asarray(res.verdict)       # np.asarray of a tensor
                torch.cuda.synchronize()          # the card synchronized
                ev.synchronize()                  # an event waited on
                if res.verdict:                   # truthiness
                    pass
                return res
        """}, {"hotpath"}, {"BNG001": 8}),
    "BNG001-retire-side-clean": ({ENGINE: """\
        import numpy as np
        import torch


        class Engine:
            def _apply_ring_verdicts(self, res, ev):
                ev.synchronize()
                torch.cuda.synchronize()
                return res.verdict.cpu().numpy(), res.out_len.item(), np.asarray(res.verdict)

            def _dispatch_step(self, pkt):
                res = pipeline_step(self.tables, torch.as_tensor(pkt))
                return res
        """}, {"hotpath"}, {}),
    "BNG050-unfenced-launch": ({"bng_tpu_torch/utils/timing.py": """\
        import time


        def bench(eng, tables, pkt, graph):
            t1 = time.perf_counter()
            pipeline_step(tables, pkt)
            a = time.perf_counter() - t1
            t2 = time.perf_counter()
            graph.replay()
            return a, time.perf_counter() - t2
        """}, {"fencing"}, {"BNG050": 2}),
    "BNG050-synchronized-clean": ({"bng_tpu_torch/utils/timing.py": """\
        import time

        import torch


        def bench(eng, tables, pkt, graph, ev):
            t1 = time.perf_counter()
            pipeline_step(tables, pkt)
            torch.cuda.synchronize()
            a = time.perf_counter() - t1
            t2 = time.perf_counter()
            graph.replay()
            ev.synchronize()
            return a, time.perf_counter() - t2
        """}, {"fencing"}, {}),
    "BNG014-narrow-torch-rows": ({"bng_tpu_torch/ops/newkernel.py": """\
        import torch


        def kernel(slots):
            scratch = torch.zeros((1024, 4), dtype=torch.int64)
            return scratch[slots]
        """}, {"gather"}, {"BNG014": 1}),
    "BNG014-wide-rows-and-writes-clean": ({"bng_tpu_torch/ops/newkernel.py": """\
        import torch

        ST_HITS = 0


        def kernel(slots, hit):
            wide = torch.zeros((1024, 8), dtype=torch.int64)
            stats = torch.zeros((4,), dtype=torch.int64)
            stats[ST_HITS] += hit.sum()      # a constant element
            stats[slots] = 1                 # a write, not a gather
            return wide[slots], stats
        """}, {"gather"}, {}),
    "BNG004-per-frame-loops": ({"bng_tpu_torch/runtime/ring.py": """\
        class PyRing:
            def assemble(self, out, out_len, out_flags):
                for i, f in enumerate(self._pending):   # per frame
                    out[i] = f
                return len(self._pending)

            def complete(self, verdict, out, out_len, n):
                i = 0
                while i < n:                            # per frame
                    i += 1
        """}, {"hotpath"}, {"BNG004": 2}),
    "BNG004-bounded-and-comprehension-clean": ({"bng_tpu_torch/runtime/ring.py": """\
        class PyRing:
            def assemble(self, out, out_len, out_flags):
                for _ in range(2):                      # a constant, not the batch
                    out = out + 1
                rows = [f for f in self._pending]       # the staging idiom
                return len(rows)
        """}, {"hotpath"}, {}),
    "BNG010-capture-per-call": ({"bng_tpu_torch/runtime/prog.py": """\
        import torch

        from bng_tpu_torch import kernels


        def step_program(fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            kernels.build()
            return graph
        """}, {"jit-discipline"}, {"BNG010": 3}),
    "BNG010-cached-builder-clean": ({"bng_tpu_torch/runtime/prog.py": """\
        import functools

        import torch

        from bng_tpu_torch import kernels

        kernels.build()


        @functools.lru_cache(maxsize=8)
        def step_program(fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            return graph
        """}, {"jit-discipline"}, {}),
    # the stage hook `region`: BNG030 reads its stage, BNG002 its disarmed path
    "BNG030-region-stray-stage": ({**REGISTRIES, SPANS: REGION_SPANS, ENGINE: """\
        from bng_tpu_torch.telemetry import spans as tele


        def dispatch(eng):
            with tele.region(tele.DISPATCH):
                with tele.region(tele.NOSUCH):
                    return eng.step()
        """}, {"registry"}, {"BNG030": 1}),
    "BNG002-region-allocates-disarmed": ({SPANS: REGION_SPANS.replace(
        "    if _ACTIVE is None", "    names = [stage]\n    if _ACTIVE is None")},
        {"hotpath"}, {"BNG002": 1}),
    "BNG002-BNG030-region-clean": ({**REGISTRIES, SPANS: REGION_SPANS, ENGINE: """\
        from bng_tpu_torch.telemetry import spans as tele


        def dispatch(eng):
            with tele.region(tele.DISPATCH):
                with tele.region(tele.DHCP):
                    return eng.step()
        """}, {"hotpath", "registry"}, {}),
    "BNG011-BNG012-never-emitted": ({ENGINE: """\
        import torch


        class Engine:
            def go(self, pkt, now):
                return self._step(pkt, int(now), now * 1e6)

            def make(self):
                def step(tables, upd):
                    return apply_fastpath_updates(tables, upd)
                return step
        """}, {"jit-discipline"}, {}),
}


@pytest.mark.parametrize("name", sorted(TORCH_READINGS))
def test_torch_reading(name, tmp_path):
    files, select, want = TORCH_READINGS[name]
    found = _run(tmp_path, files, select)
    got = {}
    for f in found:
        got[f.code] = got.get(f.code, 0) + 1
    assert got == want, [f.to_dict() for f in found]


def test_torch_readings_flag_what_the_message_names(tmp_path):
    files, select, _ = TORCH_READINGS["BNG001-dispatch-forces"]
    details = {f.detail for f in _run(tmp_path, files, select)}
    assert {"np.asarray", "torch.cuda.synchronize", "ev.synchronize", "truthiness",
            "res.verdict.tolist", "res.out_len.cpu", "res.verdict.numpy"} <= details


# ---- the catalog -----------------------------------------------------------

def test_codes_list_every_reference_code_and_say_which_do_not_apply():
    ref, port = j_all_codes(), t_all_codes()
    assert set(port) == set(ref)
    not_applied = {c for c, d in port.items() if d.startswith("not applied to the port")}
    assert not_applied == {"BNG011", "BNG012"} == set(t_jit.NOT_APPLIED)
    for c in not_applied:
        assert t_jit.NOT_APPLIED[c] in port[c]
    out = subprocess.run([sys.executable, "-m", "bng_tpu_torch.analysis", "--codes"],
                         cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0
    listed = [ln.split()[0] for ln in out.stdout.splitlines()]
    assert listed == sorted(ref)
    assert "BNG011  not applied to the port" in out.stdout


# ---- the real tree ---------------------------------------------------------

def test_check_verb_exits_zero_on_the_port():
    out = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "check"],
                         cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stderr and "(0 unjustified)" in out.stderr


def test_baseline_is_justified_and_carries_the_references_reasons():
    entries = json.loads((REPO / "bng_tpu_torch/analysis/baseline.json").read_text())["findings"]
    ref = {(e["code"], to_port(e["path"]), e["scope"], e["detail"]): e["justification"]
           for e in json.loads((REPO / "bng_tpu/analysis/baseline.json").read_text())["findings"]}
    carried = 0
    for e in entries:
        assert e["justification"] and t_baseline.TODO_TAG not in e["justification"], e
        assert not re.search(r"ISSUE \d|PERF_NOTES", e["justification"]), e
        carried += (e["code"], e["path"], e["scope"], e["detail"]) in ref
    # the reference's baseline also holds the loops of its vector host path,
    # which the port does not have
    assert carried >= 18 and len(entries) - carried <= 9


def test_scope_tables_name_the_ports_functions_and_files():
    import ast

    for table in (t_hotpath.DISPATCH_SCOPE, t_hotpath.BATCH_SCOPE):
        for path, names in table.items():
            tree = ast.parse((REPO / path).read_text())
            defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
            assert names <= defined, (path, names - defined)
    for path in t_sw.ALLOWED_WRITERS:
        assert (REPO / path).is_file(), path
    assert "_update_batch" in t_hotpath.DISPATCH_SCOPE["bng_tpu_torch/runtime/engine.py"]


def test_analyzer_imports_neither_torch_nor_jax():
    code = ("import sys; import bng_tpu_torch.analysis.cli, bng_tpu_torch.analysis.facts; "
            "sys.exit(('torch' in sys.modules) * 1 + ('jax' in sys.modules) * 2)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True)
    assert out.returncode == 0, out.stderr.decode()


def test_the_two_analyzers_keep_their_own_caches(tmp_path):
    from bng_tpu.analysis import facts as j_facts
    from bng_tpu_torch.analysis import facts as t_facts

    assert j_facts.CACHE_NAME != t_facts.CACHE_NAME
    tree = {"bng_tpu/cli.py": ref_an.CONC_CLI,
            "bng_tpu/control/widget.py": ref_an.WIDGET_HEAD}
    for rel, text in tree.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    port_tree(tmp_path, tmp_path)
    j_facts.build_concurrency_model(JProject.load(tmp_path, [tmp_path / "bng_tpu"]))
    t_facts.build_concurrency_model(TProject.load(tmp_path, [tmp_path / "bng_tpu_torch"]))
    j_files = json.loads((tmp_path / j_facts.CACHE_NAME).read_text())["files"]
    t_files = json.loads((tmp_path / t_facts.CACHE_NAME).read_text())["files"]
    assert sorted(j_files) == ["bng_tpu/cli.py", "bng_tpu/control/widget.py"]
    assert sorted(t_files) == ["bng_tpu_torch/cli.py", "bng_tpu_torch/control/widget.py"]
