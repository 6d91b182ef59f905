"""The port's SLO engine against the JAX package's.

- `DEFAULT_SLOS` and `HEADLINE_TARGETS` carry the reference's budgets,
  value for value (stage, limit, `per`, `required`).
- `parse_budgets` gives the same specs, and refuses the same bad strings
  and unknown stages.
- Seeded stage breakdowns give the same `evaluate` verdicts, and seeded
  tracers the same `check_budget` verdicts (with the same `slo_breach`
  trigger count on an armed recorder).
- `SLOMonitor` over seeded per-window latency feeds, ticked on one held
  clock, gives the same breached-stage list at every tick and the same
  snapshot after it (windows, burning counts, breaches, windowed p99s).

Tolerance: exact (dicts, lists).
"""

import numpy as np
import pytest

from bng_tpu.telemetry import recorder as j_rec
from bng_tpu.telemetry import slo as j_slo
from bng_tpu.telemetry import spans as j_sp
from bng_tpu_torch.telemetry import recorder as t_rec
from bng_tpu_torch.telemetry import slo as t_slo
from bng_tpu_torch.telemetry import spans as t_sp

pytestmark = pytest.mark.torch_port

PKGS = ((j_slo, j_sp, j_rec), (t_slo, t_sp, t_rec))


def _spec(s):
    return (s.stage, s.p99_limit_us, s.per, s.required)


def test_default_budgets_match_reference():
    assert [_spec(s) for s in t_slo.DEFAULT_SLOS] == [_spec(s) for s in j_slo.DEFAULT_SLOS]
    assert t_slo.HEADLINE_TARGETS == j_slo.HEADLINE_TARGETS
    assert dict((s.stage, s.p99_limit_us) for s in t_slo.DEFAULT_SLOS)["device"] == 50.0


def test_parse_budgets_matches_reference():
    specs = ["total:0.001", "device:25:2", "reply:1e4"]
    assert [_spec(s) for s in t_slo.parse_budgets(specs)] == \
        [_spec(s) for s in j_slo.parse_budgets(specs)]
    for bad in (["total"], ["total:1:2:3"], ["nosuch:5"], ["total:0"], ["total:5:-1"]):
        with pytest.raises(ValueError):
            j_slo.parse_budgets(bad)
        with pytest.raises(ValueError):
            t_slo.parse_budgets(bad)


def _breakdown(rng):
    out = {}
    for stage in t_sp.STAGE_NAMES:
        if rng.random() < 0.6:
            p99 = float(rng.choice([10.0, 40.0, 60.0, 3_000.0, 60_000.0, 600_000.0]))
            out[stage] = {"count": int(rng.integers(1, 100)), "p50_us": p99 / 2, "p99_us": p99,
                          "p999_us": p99, "mean_us": float(rng.choice([1.0, 45.0, 1e6])),
                          "max_us": p99}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_and_check_budget_match_reference(seed, tmp_path):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        bd = _breakdown(rng)
        custom = (("device", 45.0, 1.0, True), ("total", 100.0, 8.0, False),
                  ("ops", 5.0, 1.0, True))
        assert t_slo.evaluate(bd) == j_slo.evaluate(bd)
        assert t_slo.evaluate(bd, tuple(t_slo.SLOSpec(s, lim, per=per, required=req)
                                        for s, lim, per, req in custom)) == \
            j_slo.evaluate(bd, tuple(j_slo.SLOSpec(s, lim, per=per, required=req)
                                     for s, lim, per, req in custom))
    lines = (("dispatch", 100.0, 1.0, True), ("reply", 5.0, 2.0, True),
             ("fleet", 1.0, 1.0, True), ("total", 1e9, 1.0, False))
    out = []
    for k, (slo, sp, rec_mod) in enumerate(PKGS):
        rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(min_dump_interval_s=0.0,
                                                            out_dir=str(tmp_path / str(k))))
        tr = sp.Tracer(recorder=rec)
        r = np.random.default_rng(seed)
        for stage in (sp.DISPATCH, sp.REPLY, sp.TOTAL):
            tr.observe_many(stage, r.integers(1, 400, size=50).astype(float))
        with sp.armed(tr):
            verdict = slo.check_budget(tr, tuple(slo.BudgetLine(*ln) for ln in lines))
        out.append((verdict, dict(rec.triggers)))
    assert out[1] == out[0]
    assert "fleet:missing" in out[1][0]["breaches"] and out[1][1] == {"slo_breach": 1}
    assert t_slo.check_budget(None, ()) == j_slo.check_budget(None, ()) == {"ok": True,
                                                                          "breaches": []}


def _monitor_run(slo, sp, rec_mod, seed, tmp_path):
    rng = np.random.default_rng(seed)
    rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(min_dump_interval_s=0.0,
                                                        out_dir=str(tmp_path)))
    tr = sp.Tracer(recorder=rec)
    budgets = slo.parse_budgets(["dispatch:200", "reply:50:2", "device:50", "total:5000"])
    mon = slo.SLOMonitor(tr, slos=budgets, window_s=10.0, burn_windows=2, clock=lambda: 0.0)
    ticks = []
    now = 1000.0
    with sp.armed(tr):
        for _w in range(12):
            for stage in (sp.DISPATCH, sp.REPLY, sp.DEVICE, sp.TOTAL):
                n = int(rng.choice([0, 8, 40]))
                hi = float(rng.choice([100.0, 300.0, 20_000.0]))
                tr.observe_many(stage, rng.uniform(1.0, hi, size=n))
            for _ in range(3):
                now += float(rng.choice([2.0, 5.0, 11.0]))
                ticks.append(mon.tick(now))
    return ticks, mon.snapshot(), dict(rec.triggers)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monitor_windows_and_breaches_match_reference(seed, tmp_path):
    ref = _monitor_run(j_slo, j_sp, j_rec, seed, tmp_path / "jax")
    got = _monitor_run(t_slo, t_sp, t_rec, seed, tmp_path / "port")
    assert got == ref
    ticks, snap, triggers = got
    assert snap["windows"] > 0
    assert sum(snap["breaches"].values()) == sum(len(t) for t in ticks)
    assert triggers.get("slo_breach", 0) == sum(1 for t in ticks if t)


def test_unknown_stage_is_a_configuration_error():
    with pytest.raises(ValueError, match="unknown stage"):
        t_slo.SLOSpec("nosuch", 5.0)
    with pytest.raises(ValueError, match="unknown stage"):
        t_slo.BudgetLine("nosuch", 5.0)
    with pytest.raises(ValueError, match="positive"):
        t_slo.SLOSpec("total", 0.0)
