"""The port's metrics registry and collector against the JAX package's.

- A fresh `BNGMetrics().expose()` is byte-equal to the reference's: every
  family the reference registers, in its order, with its help text.
- After the same seeded `collect_*` / `record_*` calls (engine stats,
  garden, antispoof, edge and its host tables, intercept, pools, DHCP
  server, exhaustion, scheduler snapshot, tracer and SLO monitor, sharded
  telemetry, checkpointer, audit report, transitions, restores), the
  exposition is byte-equal again, `bng_stage_latency_us` included.
- The registry's own rules: labels must match the family's, counters only
  go up, `set_total` never moves a counter back, `remove` drops a child.
- `MetricsCollector`: a failing source is counted and the others still
  run; `serve_http(0)` binds a free port and `GET /metrics` returns
  `expose()` byte for byte (404 elsewhere).
- Every collector of the reference is in the port (the wire's, the
  fabric's, the handoff's, the member's and the cluster's among them).

Tolerance: exact (bytes).
"""

import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from bng_tpu.chaos import invariants as j_inv
from bng_tpu.control import metrics as j_m
from bng_tpu.telemetry import slo as j_slo
from bng_tpu.telemetry import spans as j_sp
from bng_tpu_torch.chaos import invariants as t_inv
from bng_tpu_torch.control import metrics as t_m
from bng_tpu_torch.telemetry import slo as t_slo
from bng_tpu_torch.telemetry import spans as t_sp

pytestmark = pytest.mark.torch_port

PKGS = ((j_m, j_sp, j_slo, j_inv), (t_m, t_sp, t_slo, t_inv))


def test_fresh_exposition_is_byte_equal():
    got, ref = t_m.BNGMetrics().expose(), j_m.BNGMetrics().expose()
    assert got == ref
    assert got.count("# TYPE ") == ref.count("# TYPE ") > 140


def _engine_stats(rng):
    def arr(n):
        return rng.integers(0, 10**6, size=n).astype(np.uint64)

    return SimpleNamespace(dhcp=arr(10), garden=arr(2), spoof=arr(6), edge=arr(4))


def _sched_snapshot(rng):
    def lane():
        return {"queue_depth": int(rng.integers(100)), "inflight": int(rng.integers(3)),
                "dropped_overflow": int(rng.integers(10))}

    return {"express": {**lane(), "aot_dispatches": int(rng.integers(1000)),
                        "jit_dispatches": int(rng.integers(10)),
                        "aot_misses": int(rng.integers(5)),
                        "fallbacks": {"geometry_miss": int(rng.integers(1, 5))},
                        "devloop": {"dispatches": int(rng.integers(50))}},
            "bulk": lane(), "oversize_dropped": int(rng.integers(3)),
            "completions_dropped": int(rng.integers(3))}


def _collect_all(m, sp, slo, inv, seed):
    rng = np.random.default_rng(seed)
    met = m.BNGMetrics()
    st = _engine_stats(rng)
    met.collect_engine(st)
    met.collect_garden(st)
    met.collect_antispoof(st)
    edge_tables = SimpleNamespace(tap_rows=lambda: list(range(int(rng.integers(9)))),
                                  route_rows=lambda: list(range(int(rng.integers(40)))),
                                  dirty_count=lambda: int(rng.integers(5)))
    met.collect_edge(st, edge_tables)
    met.collect_edge({"edge": st.edge})
    met.collect_intercept({"warrants": 3, "active_sessions": 2, "iri_records": 11,
                           "cc_records": int(rng.integers(100)), "filtered": 1,
                           "export_errors": 0})
    met.collect_pools({str(k): {"size": 254, "allocated": int(rng.integers(254))}
                       for k in range(1, 4)})
    met.collect_dhcp_server(SimpleNamespace(
        discover=int(rng.integers(900)), offer=int(rng.integers(900)), request=5, ack=4,
        nak=0, release=1, pool_exhausted=int(rng.integers(3))))
    met.collect_exhaustion(
        dhcpv6=SimpleNamespace(stats=SimpleNamespace(addr_exhausted=2, pd_exhausted=0)),
        nat=SimpleNamespace(exhausted={"block": int(rng.integers(1, 4)), "port": 0}))
    met.collect_scheduler(SimpleNamespace(stats_snapshot=lambda: _sched_snapshot(rng)))
    for lane in ("express", "bulk"):
        for _ in range(5):
            met.sched_dispatches.inc(lane=lane, close=("full", "deadline")[int(rng.integers(2))])
            met.sched_batch_occupancy.observe(float(rng.random()), lane=lane)
            met.sched_dispatch_latency.observe(float(rng.random()) / 100, lane=lane)
        met.sched_frames.inc(int(rng.integers(100)), lane=lane)
    tr = sp.Tracer()
    for stage in (sp.DISPATCH, sp.DEVICE_WAIT, sp.REPLY, sp.TOTAL):
        tr.observe_many(stage, rng.integers(1, 20_000, size=30).astype(float))
    tr.seq, tr.records_dropped = int(rng.integers(100)), 2
    tr.recorder = SimpleNamespace(triggers={"slo_breach": 2, "express_fallback": 1})
    met.attach_telemetry(tr)
    met.collect_telemetry(tr)
    mon = slo.SLOMonitor(tr, slos=slo.parse_budgets(["dispatch:100", "total:1e9"]),
                         window_s=1.0, burn_windows=1)
    mon.tick(0.0)
    tr.observe_many(sp.DISPATCH, np.full(40, 5000.0))
    mon.tick(2.0)
    met.collect_slo(mon)
    met.collect_sharded(SimpleNamespace(telemetry=SimpleNamespace(snapshot=lambda: {
        "psum_dhcp_hits": 77,
        "per_shard": [{"verdicts": {"tx": 3, "fwd": i}, "nat_punts": i, "missteers": 0,
                       "stages": {"step": {"p99_us": 10.0 * (i + 1)}}} for i in range(2)]})))
    met.collect_checkpoint(SimpleNamespace(started_at=100.0, stats={
        "saves": 2, "failures": 1, "last_success_t": 150.0, "last_bytes": 4096,
        "last_seq": 9}), now=175.5)
    met.collect_checkpoint(SimpleNamespace(started_at=100.0, stats={
        "saves": 0, "failures": 0, "last_success_t": 0.0, "last_bytes": 0,
        "last_seq": 0}), now=130.0)
    met.ckpt_duration.observe(0.25, reason="sigterm")
    report = inv.AuditReport()
    report.add("fastpath-stale-row", "sub/1", "x")
    report.add("nat-orphan-session", "s/2", "y")
    met.record_audit(report)
    met.record_audit(inv.AuditReport(), epoch=42)
    met.record_transition({"op": "engine_swap", "outcome": "ok", "duration_s": 0.5,
                           "quiesce_s": 0.01, "frames_deferred": 3, "delta_rows": 7})
    met.record_transition({"op": "engine_swap", "outcome": "rolled_back"})
    met.record_restore({"fastpath": 12, "nat": 0})
    met.record_restore({}, outcome="rejected")
    return met.expose()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_after_the_same_collects_is_byte_equal(seed):
    ref = _collect_all(*PKGS[0], seed)
    got = _collect_all(*PKGS[1], seed)
    assert got == ref
    for family in ("bng_stage_latency_us_count{stage=\"dispatch\"} 70",
                   "bng_ops_transitions_total{op=\"engine_swap\",outcome=\"ok\"} 1",
                   "bng_ckpt_restores_total{outcome=\"rejected\"} 1",
                   "bng_invariant_last_audit_epoch 42", "bng_slo_breaches_total{stage=\"dispatch\"} 1",
                   "bng_express_fallback_total{reason=\"geometry_miss\"}"):
        assert family in got


def test_registry_rules():
    r = t_m.Registry()
    c = r.counter("c_total", "c", ("a",))
    with pytest.raises(ValueError):
        c.inc(a="x", b="y")
    with pytest.raises(ValueError):
        c.inc(-1, a="x")
    c.set_total(5, a="x")
    c.set_total(3, a="x")
    assert c.value(a="x") == 5.0
    assert c.remove(a="x") and not c.remove(a="x") and c.labeled() == []
    with pytest.raises(ValueError, match="duplicate"):
        r.counter("c_total", "again")
    g = r.gauge("g", "g")
    g.set(2.5)
    g.dec(1)
    assert g.value() == 1.5
    h = r.histogram("h_seconds", "h", buckets=(0.1, 1.0))
    h.observe(0.5)
    assert 'h_seconds_bucket{le="+Inf"} 1' in r.expose()


def test_collector_counts_a_failing_source_and_serves_http():
    met = t_m.BNGMetrics()
    col = t_m.MetricsCollector(met, interval=60.0)
    calls = []

    def bad():
        raise RuntimeError("boom")

    col.add_source(bad)
    col.add_source(lambda: calls.append(1) or met.garden_gated_drops.set_total(9))
    col.collect_once()
    assert col.source_errors == 1 and calls == [1]
    port = col.serve_http(0)
    try:
        assert port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        assert body == met.expose() and "bng_walled_garden_device_drops_total 9" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
        assert e.value.code == 404
    finally:
        col.stop()


def test_left_out_collectors_are_absent():
    """None is left out any more: the wire's, the fabric's, the handoff's
    and cluster membership's collectors came with their components
    (tests/test_torch_wire.py, test_torch_fabric.py, test_torch_cluster.py),
    and collect_dns with the DNS listener (tests/test_torch_dns.py)."""
    kept = [n for n in dir(j_m.BNGMetrics) if n.startswith(("collect_", "record_"))]
    assert {"collect_wire", "collect_fabric", "collect_handoff", "record_member",
            "record_cluster", "collect_dns"} <= set(kept)
    assert [n for n in kept if not hasattr(t_m.BNGMetrics, n)] == []
