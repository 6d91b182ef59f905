"""The port's `perf gate|import` verb and its ledger
(`bng_tpu_torch/telemetry/ledger.py`: `gate_file`, `import_legacy`) against
the JAX package's.

- The reference's own ledger cases run on the port (`port_twin`): every
  case of `tests/test_ledger.py`, its parametrised ones case by case,
  except the one whose subprocess imports the reference by a string
  (`BY_STRING`); `test_port_fingerprint_never_imports_jax` holds that
  rule on the port.
- Synthetic ledgers written under `tmp_path` — a clean one, a planted
  single-stage regression, an incomparable cohort (a `gpu` candidate over
  TPU-only history), a mixed ledger where `gpu` lines sit between `tpu`
  and `cpu` lines, and pre-schema lines: both packages' `gate_file` give
  the same report, both `perf gate` verbs the same rc (0/1/2/3), text and
  `--json` report, and both `perf import` verbs the same migrated lines.
  A `gpu` line never joins a TPU or CPU cohort.

Tolerance: exact.
"""

import copy
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

import test_ledger as ref_ledger
from bng_tpu import cli as j_cli
from bng_tpu.telemetry import ledger as j_ledger
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch.telemetry import ledger as t_ledger

from test_torch_deviceauth import port_twin, reference_cases

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]

# its subprocess imports `bng_tpu.telemetry.ledger` by a string, which the
# rebinding does not reach: it would test the reference again
BY_STRING = {"TestFingerprint::test_fingerprint_never_imports_jax"}
real_lines = ref_ledger.real_lines  # the reference cases' fixture (the repo ledger)


def _expand(case):
    """(case, params) for each parametrisation of a reference case."""
    cls, meth = case.split("::")
    marks = getattr(getattr(getattr(ref_ledger, cls), meth), "pytestmark", [])
    out = [(case, {})]
    for m in marks:
        if m.name == "parametrize":
            names = [n.strip() for n in m.args[0].split(",")] if isinstance(
                m.args[0], str) else list(m.args[0])
            out = [(c, {**kw, **dict(zip(names, v if len(names) > 1 else (v,)))})
                   for c, kw in out for v in m.args[1]]
    return out


CASES = [x for c in reference_cases(ref_ledger, [n for n in vars(ref_ledger)
                                                 if n.startswith("Test")])
         if c not in BY_STRING for x in _expand(c)]


@pytest.mark.parametrize("case,params", CASES,
                         ids=[c + "".join(f"[{v}]" for v in kw.values()) for c, kw in CASES])
def test_reference_ledger_case_holds_on_the_port(case, params, request):
    cls, meth = case.split("::")
    fn = getattr(port_twin(ref_ledger, cls)(), meth)
    fn(**{p: params[p] if p in params else request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


def test_port_fingerprint_never_imports_jax():
    code = ("import sys; from bng_tpu_torch.telemetry.ledger import environment_fingerprint; "
            "env = environment_fingerprint(); assert 'jax' not in sys.modules; "
            "assert env['host'] and env['platform'] == 'cpu'; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def line(i, platform="tpu", device="TPU v5e chip0", scale=1.0, stage_scale=None, **extra):
    """A schema'd bench line; `stage_scale` multiplies one stage's p99."""
    ln = copy.deepcopy(ref_ledger._tpu_line(i, scale))
    ln["device"] = device
    ln["env"] = {"platform": platform, "device_kind": device.rsplit(" chip", 1)[0],
                 "host": f"{platform}-host"}
    if stage_scale:
        stage, k = stage_scale
        ln["stage_breakdown"][stage]["p99_us"] *= k
    ln.update(extra)
    return ln


H100 = "NVIDIA H100 80GB HBM3"
LEDGERS = {
    "clean": [line(i) for i in range(6)],
    "regression": [line(i) for i in range(5)] + [line(5, stage_scale=("device_wait", 2.0))],
    "incomparable": [line(i) for i in range(5)] + [line(5, platform="gpu", device=H100)],
    "mixed": ([line(i) for i in range(4)]
              + [line(10 + i, platform="cpu", device="TFRT_CPU_0") for i in range(4)]
              + [line(20 + i, platform="gpu", device=H100) for i in range(4)]
              + [line(4)]),
    "gpu-regression": ([line(20 + i, platform="gpu", device=H100) for i in range(5)]
                       + [line(30, platform="gpu", device=H100, scale=0.4)]),
    "legacy": [{"metric": "Mpps/chip DHCP+NAT44 fast path", "value": 0.05, "unit": "Mpps",
                "device": f"TPU_{i}", "batch": 8192} for i in range(4)]
              + [{"metric": "Mpps/chip DHCP+NAT44 fast path", "value": 0.01, "unit": "Mpps",
                  "device": "TFRT_CPU_0", "batch": 8192, "error": "x"}],
}
WANT_RC = {"clean": 0, "regression": 1, "incomparable": 3, "mixed": 0, "gpu-regression": 1,
           "legacy": 0}


def write_ledger(tmp_path, name):
    p = tmp_path / f"{name}.jsonl"
    p.write_text("".join(json.dumps(ln) + "\n" for ln in LEDGERS[name]))
    return str(p)


@pytest.mark.parametrize("name", sorted(LEDGERS))
def test_gate_file_equals_reference(name, tmp_path):
    p = write_ledger(tmp_path, name)
    ref, got = j_ledger.gate_file(p), t_ledger.gate_file(p)
    assert got.to_dict() == ref.to_dict()
    assert got.rc == WANT_RC[name]
    assert got.format_text() == ref.format_text()


@pytest.mark.parametrize("name", sorted(LEDGERS))
@pytest.mark.parametrize("as_json", [False, True])
def test_perf_gate_verb_equals_reference(name, as_json, tmp_path, capsys):
    p = write_ledger(tmp_path, name)
    argv = ["perf", "gate", "--ledger", p] + (["--json"] if as_json else [])
    out = []
    for cli in (j_cli, t_cli):
        rc = cli.main(argv)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[1] == out[0]
    assert out[1][0] == WANT_RC[name]
    if as_json:
        assert json.loads(out[1][1])["rc"] == WANT_RC[name]


def test_gpu_line_never_joins_a_tpu_or_cpu_cohort(tmp_path):
    lines = LEDGERS["mixed"]
    keys = {ln["env"]["platform"]: t_ledger.cohort_key(ln) for ln in lines}
    assert len(set(keys.values())) == 3
    assert t_ledger.backend_class(lines[8]) == "gpu"
    for ln in lines:
        assert t_ledger.cohort_key(ln) == j_ledger.cohort_key(ln)
    # the mixed ledger's TPU candidate is scored against its 4 TPU lines
    # only; a gpu candidate there is scored against the 4 gpu lines only
    rep = t_ledger.gate(lines)
    assert rep.cohort_n == 4 and rep.candidate["backend"] == "tpu"
    rep = t_ledger.gate(lines + [line(24, platform="gpu", device=H100)])
    assert rep.cohort_n == 4 and rep.candidate["backend"] == "gpu" and rep.rc == 0


@pytest.mark.parametrize("name", ["legacy", "mixed"])
def test_perf_import_equals_reference(name, tmp_path, capsys):
    p = write_ledger(tmp_path, name)
    assert t_ledger.import_legacy(t_ledger.read(p)) == j_ledger.import_legacy(j_ledger.read(p))
    outs = []
    for tag, cli in (("j", j_cli), ("t", t_cli)):
        dest = tmp_path / f"{tag}.jsonl"
        assert cli.main(["perf", "import", "--ledger", p, "--out", str(dest)]) == 0
        rc = cli.main(["perf", "import", "--ledger", p])
        cap = capsys.readouterr()
        outs.append((dest.read_text(), rc, cap.out, cap.err.replace(str(dest), "<out>")))
    assert outs[1] == outs[0]
    if name == "legacy":
        assert "perf import: 5 lines (5 tagged schema_version 0)" in outs[1][3]


def test_perf_gate_subprocess_rc(tmp_path):
    """`python -m bng_tpu_torch perf gate` as an operator runs it: no card."""
    for name in ("clean", "regression", "incomparable"):
        p = write_ledger(tmp_path, name)
        out = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "perf", "gate",
                              "--ledger", p], cwd=REPO, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == WANT_RC[name], out.stdout + out.stderr
    assert "REGRESSION in stage:device_wait" in subprocess.run(
        [sys.executable, "-m", "bng_tpu_torch", "perf", "gate", "--ledger",
         write_ledger(tmp_path, "regression")], cwd=REPO, capture_output=True,
        text=True, timeout=120).stderr
