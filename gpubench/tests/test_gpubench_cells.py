"""Each cell run small on the CPU through the whole harness: sound, it
comes out correct; with the timed path broken underneath, not correct —
once for each fault the cell can have: a step that leaves its state
unchanged, half of a batch left out, an answer altered where it is made,
two frames' verdicts swapped (the counts kept), and on the sharded box the
exchange between chips left out."""

import pytest
import torch

from gpubench import harness
from gpubench.conftest import spec

CELLS = [w["name"] for w in spec()["workloads"]]
PASS, DROP, FWD = 0, 1, 3


def half(t, value):
    t = t.clone()
    t[t.shape[0] // 2:] = value
    return t


def plant(monkeypatch, fault: str) -> None:
    from bng_tpu_torch.ops import pipeline as pipeline_mod
    from bng_tpu_torch.ops import qos as qos_mod
    from bng_tpu_torch.parallel import exchange as exchange_mod
    from bng_tpu_torch.parallel import sharded as sharded_mod
    from bng_tpu_torch.runtime import engine as engine_mod

    step, dhcp, express = (engine_mod.pipeline_step, engine_mod.dhcp_fastpath,
                           engine_mod.express_verdicts)
    if fault == "state_unchanged":
        monkeypatch.setattr(pipeline_mod, "nat44_update_sessions", lambda *a, **k: None)
        monkeypatch.setattr(qos_mod, "write_token_rows", lambda *a, **k: None)
        return
    if fault == "exchange_left_out":
        # every shard's lookup rows stay home: the owners probe empty rows
        for cls in (exchange_mod.DeviceLocalExchange, exchange_mod.CopyingExchange):
            monkeypatch.setattr(cls, "send", lambda self, src, req: [torch.zeros_like(r)
                                                                     for r in req])
        return

    def step_f(*a, **k):
        r = step(*a, **k)
        if fault == "verdicts_swapped":
            v = r.verdict.clone()
            fwd, drop = (torch.nonzero(v == FWD).flatten(), torch.nonzero(v == DROP).flatten())
            if len(fwd) and len(drop):
                v[fwd[0]], v[drop[0]] = DROP, FWD
            return r._replace(verdict=v)
        if fault == "half_batch":
            return r._replace(verdict=half(r.verdict, PASS))
        pkt = r.out_pkt.clone()
        pkt[:, 26] ^= 1  # the first byte of the IPv4 source of every lane
        return r._replace(out_pkt=pkt)

    def dhcp_f(*a, **k):
        r = dhcp(*a, **k)
        if fault == "half_batch":
            return r._replace(is_reply=half(r.is_reply, False))
        pkt = r.out_pkt.clone()
        pkt[:, 26] ^= 1
        return r._replace(out_pkt=pkt)

    def express_f(*a, **k):
        r = express(*a, **k)
        block = r.block.clone()
        if fault == "half_batch":
            block[block.shape[0] // 2:, 0] = 0  # VB_VERDICT: not answered
        else:
            block[:, 1] += 1  # VB_YIADDR
        return r._replace(block=block)

    for mod in (engine_mod, sharded_mod):
        monkeypatch.setattr(mod, "pipeline_step", step_f)
        monkeypatch.setattr(mod, "dhcp_fastpath", dhcp_f)
    monkeypatch.setattr(engine_mod, "express_verdicts", express_f)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell, tiny):
    bench, ctx = tiny(cell)
    line = harness.execute(ctx, bench)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    e2e = [m["name"] for m in bench["end_to_end"] if harness.applies(m, cell)]
    assert sorted(line["metrics"]) == sorted(e2e)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "verdicts_swapped", "exchange_left_out"])
def test_cell_fault_is_caught(cell, fault, tiny, monkeypatch):
    bench, ctx = tiny(cell)
    if fault == "state_unchanged" and ctx.mix.get("discover_share") == 1.0:
        pytest.skip("every frame of this mix takes the DHCP-only program, which writes no state")
    if fault == "verdicts_swapped" and ctx.mix.get("discover_share") == 1.0:
        pytest.skip("every frame of this mix is a DISCOVER answered alike: no two verdicts differ")
    if fault == "exchange_left_out" and "shards" not in ctx.cfg:
        pytest.skip("one box: no exchange between chips")
    plant(monkeypatch, fault)
    line = harness.execute(ctx, bench)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_its_layers(cell, tiny):
    bench, ctx = tiny(cell, trace=True)
    line = harness.execute(ctx, bench)
    assert line["correct"], line["checks"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    names = {m["name"] for m in bench["per_layer"] if harness.applies(m, cell)}
    # on the CPU the device-trace metrics find nothing to read and are left out
    host = {m["name"] for m in bench["per_layer"] if harness.applies(m, cell)
            and m["source"] != "device_trace"}
    assert host <= set(line["metrics"]) <= names


def test_sharded_box_on_eight_shards_answers_discovers_wrong(tiny):
    """The held sharded cell at its own eight shards (small tables, 256
    lanes a shard): the program answers some cached DISCOVERs with PASS,
    the fault that keeps the cell out of BENCHMARK.json. Two shards answer
    all (`test_cell_is_correct`). When the program is mended this test
    fails: put the cell back and turn this into a correct-run test."""
    bench, ctx = tiny("sharded_1m.mix_80_20", seed=4600000001, seconds=2.0)
    ctx.cfg.update({"shards": 8, "batch": 2048, "nat_public_ips": 8,
                    "nat_public_ips_per_shard": 1})
    checks = harness.execute(ctx, bench)["checks"]
    assert checks["verdicts_off"]["value"] > 0, checks
    assert all(checks[k]["value"] == 0 for k in ("unanswered", "bytes_off", "missteered")), checks
