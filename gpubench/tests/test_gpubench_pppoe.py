"""The PPPoE-over-QinQ cell run small on the CPU through the whole
harness: sound, it comes out correct; with the line's work broken in the
program underneath, not correct — once for each fault: encap that leaves
out the line's tags, decap that leaves them on, encap on a swapped C-tag,
the downstream lanes left out. And its control: the reference in the
program's place with a guarantee broken reads the upper values, unbroken
it is correct."""

import pytest
import torch

from gpubench import control_pppoe, harness
from gpubench.conftest import TINY_CFG, TINY_MIX, spec

CELL = "pppoe_qinq_64k.bidir_mtu"
PASS = 0


def _vals(state, col, fn):
    vals = state.vals.clone()
    vals[:, col] = fn(vals[:, col])
    return state._replace(vals=vals)


def plant(monkeypatch, fault: str) -> None:
    from bng_tpu_torch.ops import pipeline as pipeline_mod
    from bng_tpu_torch.ops import pppoe as pppoe_mod
    from bng_tpu_torch.runtime import engine as engine_mod

    decap, encap = pipeline_mod.pppoe_decap, pipeline_mod.pppoe_encap
    step = engine_mod.pipeline_step
    unbound = lambda w: torch.zeros_like(w)  # noqa: E731 — the line flag cleared
    if fault == "decap_leaves_tags":
        monkeypatch.setattr(pipeline_mod, "pppoe_decap", lambda pkt, ln, vo, et, s, g: decap(
            pkt, ln, vo, et, _vals(s, pppoe_mod.PS_FLAGS, unbound), g))
    elif fault in ("encap_without_tags", "c_tag_swapped"):
        col, fn = ((pppoe_mod.PS_FLAGS, unbound) if fault == "encap_without_tags"
                   else (pppoe_mod.PS_C_TAG, lambda w: w % 4094 + 1))
        monkeypatch.setattr(pipeline_mod, "pppoe_encap",
                            lambda pkt, ln, vo, et, ip, s, g, m: encap(
                                pkt, ln, vo, et, ip, _vals(s, col, fn), g, m))
    else:  # downstream_left_out: the core side's lanes never answered
        def step_f(tables, pkt, length, fa, *a, **k):
            r = step(tables, pkt, length, fa, *a, **k)
            return r._replace(verdict=torch.where(fa, r.verdict, PASS).to(r.verdict.dtype))

        monkeypatch.setattr(engine_mod, "pipeline_step", step_f)


def test_cell_is_correct_with_every_kind_of_lane(tiny):
    bench, ctx = tiny(CELL, seed=2**40 + 3)
    line = harness.execute(ctx, bench)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("fault", ["encap_without_tags", "decap_leaves_tags", "c_tag_swapped",
                                   "downstream_left_out"])
def test_planted_fault_is_caught(fault, tiny, monkeypatch):
    bench, ctx = tiny(CELL, seed=77)
    plant(monkeypatch, fault)
    line = harness.execute(ctx, bench)
    assert not line["correct"], line["checks"]


def test_traced_run_reads_the_pppoe_metrics(tiny):
    bench, ctx = tiny(CELL, trace=True, seconds=6.0)  # a few batches retire in the window
    harness.clean_environment(ctx.cfg)
    from gpubench.systems import pppoe_ring

    run = pppoe_ring.run(ctx)
    assert run.correct, run.checks
    share = harness.metric_reader("pppoe.device_share")(run)
    issue = harness.metric_reader("step.pppoe_issue_ms")(run)
    down, lcp, up = 154, 1, 101  # the tiny batch of 256 lanes
    assert share == pytest.approx(100.0 * (down + up) / (down + lcp + up))
    assert 0 < issue < harness.metric_reader("step.issue_ms")(run)


def small():
    _, _, cfg, mix = harness.load_cell(CELL, spec())
    return (dict(cfg, **{k: v for k, v in TINY_CFG.items() if k in cfg}),
            dict(mix, **{k: v for k, v in TINY_MIX.items() if k in mix}))


@pytest.mark.parametrize("variant,caught_by", [
    ("bf16_tokens", "qos_words_off"), ("tags_not_written", "bytes_off"),
    ("tags_left_on", "bytes_off"), ("c_tag_swapped", "bytes_off")])
@pytest.mark.parametrize("seed", [11, 2**33 + 1])
def test_control_is_not_correct(variant, caught_by, seed):
    cfg, mix = small()
    checks = control_pppoe.simulate(cfg, mix, seed, 40, variant)
    assert checks[caught_by][0] > checks[caught_by][1], checks


def test_unbroken_reference_is_correct():
    cfg, mix = small()
    checks = control_pppoe.simulate(cfg, mix, 3, 40, "none")
    assert all(v <= lim for v, lim in checks.values()), checks
