"""The per-layer metrics that read the program's dispatch spans (`drain`,
`upload`, `issue`) and its device program's stage spans (`dhcp`, `nat44`):
each reads a number from a traced CPU run of its cells, and nothing from an
untraced run, whose tracer is never armed."""

import importlib

import pytest

from gpubench import harness
from gpubench.conftest import spec

SPAN_METRICS = ("ring.drain_ms", "ring.upload_ms", "step.issue_ms", "step.dhcp_issue_ms",
                "step.nat44_issue_ms")
CELLS = sorted({c for m in spec()["per_layer"] if m["name"] in SPAN_METRICS
                for c in m["workloads"]})


def served(tiny, cell: str, trace: bool):
    bench, ctx = tiny(cell, trace=trace)
    harness.clean_environment(ctx.cfg)
    run = importlib.import_module(f"gpubench.systems.{ctx.cfg['system']}").run(ctx)
    mine = [m["name"] for m in bench["per_layer"]
            if m["name"] in SPAN_METRICS and harness.applies(m, cell)]
    return run, mine


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_read_the_traced_window(cell, tiny):
    run, mine = served(tiny, cell, trace=True)
    assert run.correct, run.checks
    got = {name: harness.metric_reader(name)(run) for name in mine}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert ("step.nat44_issue_ms" in got) == (cell == "ipoe_1m.mix_80_20")
    # the dispatch's parts fit inside it, and the DHCP stage inside the issue
    dispatch = harness.metric_reader("ring.dispatch_ms")(run)
    assert got["ring.drain_ms"] + got["ring.upload_ms"] + got["step.issue_ms"] <= dispatch
    assert got["step.dhcp_issue_ms"] <= got["step.issue_ms"]


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_read_nothing_untraced(cell, tiny):
    run, mine = served(tiny, cell, trace=False)
    assert run.layer["tracer"] is None and mine
    assert [harness.metric_reader(name)(run) for name in mine] == [None] * len(mine)
