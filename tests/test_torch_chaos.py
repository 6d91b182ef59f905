"""The port's chaos suite (`bng_tpu_torch/chaos/{scenarios,runner}.py` and
`chaos run|audit`) against the JAX package's.

- Each of the 16 scripted scenarios (the HA pair's
  `ha_delta_drop_reconnect` and the four of the cluster of BNGs among
  them) runs in both packages from one seed, on the CPU (the five that
  build an engine, a scheduler or a sharded cluster on `device="cpu"`),
  and gives the same canonical report bytes, `ok` included.
- The seeded soak, `soak(seed=5, epochs=2)`, gives the same bytes.
- The catalog is the reference's 23 names, so each scenario's seed is the
  reference's (the index in the catalog); `chaos run --scenario` runs any
  of them, on the CPU with `--device cpu`.
- `chaos run --scenario` prints the reference's report; `--list`,
  `--bench-log` (through the port's ledger), `chaos audit` on a built app
  (rc 0), and no card without `--device cpu` (rc 2).

No report field is left out: no scenario here reads wall time into its
report (the one storm that did is in tests/test_torch_storms.py).

Tolerance: exact (canonical JSON bytes).
"""

import json

import pytest
import torch

from bng_tpu import cli as j_cli
from bng_tpu.chaos import runner as j_runner
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch.chaos import runner as t_runner

pytestmark = pytest.mark.torch_port

SEED = 9


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The storms' stage budgets read wall time, and the port's CPU engine
    issues many small torch ops: with every test process of a parallel run
    on all cores' intra-op threads, the oversubscribed host slows each op
    by orders of magnitude. One thread per process (restored after) keeps
    the budgets' margin; the budgets themselves are unchanged."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(t_runner.SCENARIOS))
def test_scenario_report_equals_reference(name):
    ref = j_runner.canonical_json(j_runner.run_scenarios(SEED, names=[name]))
    got = t_runner.canonical_json(t_runner.run_scenarios(SEED, names=[name], device="cpu"))
    assert got == ref
    assert json.loads(got)["ok"], got[:2000]


def test_soak_equals_reference():
    ref = j_runner.canonical_json(j_runner.soak(seed=5, epochs=2))
    got = t_runner.canonical_json(t_runner.soak(seed=5, epochs=2))
    assert got == ref and json.loads(got)["ok"]


def test_catalog_and_seeds_are_the_references():
    assert sorted(t_runner.ALL_SCENARIOS) == sorted(j_runner.ALL_SCENARIOS)
    assert len(t_runner.ALL_SCENARIOS) == 23
    assert [n for n, _d in t_runner.scenario_catalog()] == \
        [n for n, _d in j_runner.scenario_catalog()]
    # the port's devices: exactly the entries that build device state
    assert t_runner.ON_DEVICE < set(t_runner.ALL_SCENARIOS)


def test_cli_single_scenario_prints_the_references_report(capsys):
    argv = ["chaos", "run", "--seed", "5", "--scenario", "nat_expiry_under_skew"]
    assert j_cli.main(argv) == 0
    ref = capsys.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref


def test_cli_list_unknown_and_bench_log(tmp_path, capsys):
    assert t_cli.main(["chaos", "run", "--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 23 and not any("not ported" in ln for ln in lines)
    assert t_cli.main(["--device", "cpu", "chaos", "run", "--scenario", "nope"]) == 2
    assert "unknown scenario" in capsys.readouterr().err
    log = tmp_path / "chaos.jsonl"
    assert t_cli.main(["--device", "cpu", "chaos", "run", "--seed", "3", "--scenario",
                       "dora_worker_crash", "--bench-log", str(log)]) == 0
    capsys.readouterr()
    (line,) = [json.loads(x) for x in log.read_text().splitlines()]
    assert line["metric"] == "storm" and line["scenario"] == "dora_worker_crash" and line["ok"]


def test_cli_needs_a_card_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_cli.main(["chaos", "run", "--scenario", "nat_expiry_under_skew"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_cli_chaos_audit_on_a_built_app(capsys):
    assert t_cli.main(["--device", "cpu", "chaos", "audit", "--slowpath-workers", "2",
                       "--slowpath-worker-mode", "inline"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["checks"]["slice_granted"] > 0
