"""The port's blue/green swap against the JAX package's.

The cases of `tests/test_ops.py::TestBlueGreenSwap`, each run on a stack
of each package built by the same host calls (the reference's
`_engine_stack`: a DHCP server behind the engine, five DORAs): a clean
swap that flips and serves on the device, a crash at `ops.swap` that
rolls back, an unexpected error after the delta replay that still heals
the active engine, a snapshot `io_error` that fails before any standby,
the delta replay shipping the rows written after the snapshot, and a
swap under a scheduler that re-points both lanes. In each the port's
report (`outcome`, `restored_rows`, `delta_rows`, `delta_steps`,
`delta_resync`, `audit_ok`, `violations`, `frames_deferred`, `error`)
equals the reference's, and the next batches give the same bytes and
table words. With a tracer armed, the swap's phases record the same
number of `ops` laps in both packages.

Port-only: `adopt_device_tables` (the path a standby built with
`device_tables=` takes) on an engine whose express program and
devloop ring program were built re-captures and re-seeds them: after
adopting a snapshot's chain, a lease written after the snapshot misses on
both lanes until the delta replay ships it (a stale program would still
answer from the old tensors).

Where the port differs from the reference on purpose, both outputs are
pinned (ROADMAP Queue 3): a dense config change (a pool, a hairpin
address) made between the snapshot and the flip with no slot dirty
reaches the port's standby and the swap flips, while the reference's
standby keeps the snapshot's pools and rolls back on the audit; and the
edge stage goes with the port's standby, while the reference builds its
standby without one.

Sharded (N = 2 and 4): `sharded_blue_green_swap` flips, and an `ops.swap`
crash keeps the active cluster, with the reference's report.

Tolerance: exact.
"""

import numpy as np
import pytest

from bng_tpu import chaos as j_chaos
from bng_tpu.chaos.faults import FAIL, IO_ERROR
from bng_tpu.chaos.scenarios import _discover, _mac, _renew, _reply, _request
from bng_tpu.control import dhcp_codec
from bng_tpu.runtime import ops as j_ops
from bng_tpu.runtime.scheduler import SchedulerConfig as JConfig
from bng_tpu.runtime.scheduler import TieredScheduler as JSched
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import invariants as t_invariants
from bng_tpu_torch.runtime import ops as t_ops
from bng_tpu_torch.runtime.scheduler import SchedulerConfig as TConfig
from bng_tpu_torch.runtime.scheduler import TieredScheduler as TSched
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_checkpoint import JAX, PKGS, PORT, SERVER_IP, SERVER_MAC, cluster, words
from test_torch_stages import assert_tuple_equal

pytestmark = pytest.mark.torch_port

TIMES = ("quiesce_s", "hydrate_s", "flip_s", "duration_s", "audit_s")
OPS = {"jax": j_ops, "port": t_ops}
SCHED = {"jax": (JSched, JConfig), "port": (TSched, TConfig)}


def engine_stack(p, edge: bool = False):
    """The reference's `_engine_stack` (tests/test_ops.py) in package p: a
    server stack of chaos/scenarios.py, an engine of B = 32, five DORAs."""
    clock = p.faults.SimClock()
    fp = p.FastPathTables(sub_nbuckets=512, vlan_nbuckets=64, cid_nbuckets=64, max_pools=16)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    pools = p.PoolManager(fp)
    pools.add_pool(p.Pool(pool_id=1, network=ip_to_u32("10.0.0.0"), prefix_len=20,
                          gateway=SERVER_IP, dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    nat = p.NATManager(public_ips=[ip_to_u32("203.0.113.1")], ports_per_subscriber=64,
                       sessions_nbuckets=256, sub_nat_nbuckets=64)
    server = p.DHCPServer(SERVER_MAC, SERVER_IP, pools, fastpath_tables=fp,
                          nat_hook=lambda ip, now: nat.allocate_nat(ip, int(now)), clock=clock)
    kw = dict(p.kw)
    if edge:
        e = p.EdgeTables(nbuckets=64, stash=8, update_slots=16, max_filters=8)
        e.set_route(ip_to_u32("10.0.0.2"), b"\x02\x47\x57\x00\x00\x01", table_id=100)
        e.arm_tap(ip_to_u32("10.0.0.3"), 5)
        kw["edge"] = e
    eng = p.Engine(fp, nat, batch_size=32, slow_path=server.handle_frame, clock=clock, **kw)
    leased = {}
    for i in range(5):
        m = _mac(300 + i)
        out = eng.process([_discover(m, 100 + i)])
        ip = _reply((out["slow"] or out["tx"])[0][1]).yiaddr
        eng.process([_request(m, ip, 200 + i)])
        leased[m] = ip
    return clock, server, pools, fp, nat, eng, leased


def _ack_of(rep, want_ip):
    p = _reply(rep) if rep is not None else None
    return p is not None and p.msg_type == dhcp_codec.ACK and p.yiaddr == want_ip


def strip(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if k not in TIMES}


def renew_all(eng, clock, leased, xid):
    return [eng.process([_renew(m, leased[m], xid + i)], now=clock.advance(30.0))
            for i, m in enumerate(sorted(leased))]


def swap_both(arm=None, sched=False, patch_audit=None, monkeypatch=None):
    """One swap per package on its own stack; returns [(report, stack, comps)]."""
    got = []
    for p in PKGS:
        st = engine_stack(p)
        clock, server, pools, _fp, nat, eng, leased = st
        comps = {"engine": eng, "pools": pools, "dhcp": server}
        if sched:
            cls, cfg = SCHED[p.name]
            comps["scheduler"] = cls(eng, cfg(bulk_batch=32), clock=clock)
        if patch_audit is not None:
            mod = j_chaos.invariants if p is JAX else t_invariants
            monkeypatch.setattr(mod, "audit_invariants", patch_audit)
        if arm is not None:
            with p.faults.armed(p.faults.FaultPlan(1, [p.faults.FaultSpec("ops." + arm[0],
                                                                          arm[1])]), log=False):
                rep = OPS[p.name].blue_green_swap(comps)
        else:
            rep = OPS[p.name].blue_green_swap(comps)
        if patch_audit is not None:
            monkeypatch.undo()
        got.append((rep, st, comps))
    assert strip(got[1][0]) == strip(got[0][0])
    assert "duration_s" in got[1][0]
    return got


def next_batches_agree(got, xid):
    outs = []
    for rep, (clock, server, pools, fp, nat, eng, leased), comps in got:
        e = comps["engine"]
        outs.append(renew_all(e, clock, leased, xid))
    assert outs[1] == outs[0]
    assert_tuple_equal(words(got[1][2]["engine"]), words(got[0][2]["engine"]), "tables")
    return outs[1]


def test_swap_flips_and_serves_on_device():
    got = swap_both()
    rep, st, comps = got[1]
    assert rep["outcome"] == "ok" and rep["audit_ok"] and rep["violations"] == {}
    standby = comps["engine"]
    assert standby is not st[5] and standby.stats is st[5].stats
    assert standby.resync_count == 1  # its chain came in through adopt_device_tables
    outs = next_batches_agree(got, 0xA01)
    assert all(o["tx"] and _ack_of(o["tx"][0][1], ip)
               for o, ip in zip(outs, [st[6][m] for m in sorted(st[6])]))
    _, server, pools, _, nat, _, _ = st
    assert t_invariants.audit_invariants(engine=standby, pools=pools, dhcp=server, nat=nat).ok


def test_crash_mid_swap_rolls_back():
    got = swap_both(arm=("swap", FAIL))
    rep, st, comps = got[1]
    assert rep["outcome"] == "rolled_back" and comps["engine"] is st[5]
    outs = next_batches_agree(got, 0xA02)
    assert all(_ack_of((o["tx"] or o["slow"])[0][1], st[6][m])
               for o, m in zip(outs, sorted(st[6])))


def test_unexpected_error_after_delta_still_heals_active(monkeypatch):
    def exploding_audit(*a, **kw):
        raise RuntimeError("injected: device backend fell over")

    got = swap_both(patch_audit=exploding_audit, monkeypatch=monkeypatch)
    rep, st, comps = got[1]
    assert rep["outcome"] == "rolled_back" and "RuntimeError" in rep["error"]
    assert comps["engine"] is st[5]
    next_batches_agree(got, 0xA05)
    _, server, pools, _, nat, eng, _ = st
    assert t_invariants.audit_invariants(engine=eng, pools=pools, dhcp=server, nat=nat).ok


def test_snapshot_io_error_fails_before_standby():
    got = swap_both(arm=("snapshot", IO_ERROR))
    rep, st, comps = got[1]
    assert rep["outcome"] == "failed" and "OSError" in rep["error"]
    assert comps["engine"] is st[5] and "hydrate_s" not in rep


def test_swap_with_scheduler_repoints_lanes():
    got = swap_both(sched=True)
    res = []
    for rep, (clock, server, pools, fp, nat, eng, leased), comps in got:
        sched = comps["scheduler"]
        assert rep["outcome"] == "ok" and sched.engine is comps["engine"]
        m = sorted(leased)[0]
        res.append(sched.process([_renew(m, leased[m], 0xA03)], now=clock.advance(30.0)))
    assert res[1] == res[0]
    assert _ack_of((res[1]["tx"] or res[1]["slow"])[0][1], got[1][1][6][sorted(got[1][1][6])[0]])
    assert_tuple_equal(words(got[1][2]["engine"]), words(got[0][2]["engine"]), "tables")


@pytest.mark.parametrize("arm", [None, "swap"])
def test_swap_phases_lap_the_ops_stage(arm):
    """With a tracer armed, each phase the swap runs records one lap of the
    `ops` stage, as in the reference: quiesce, hydrate, delta, audit and
    flip on a flip; the first three when `ops.swap` crashes it."""
    from bng_tpu.telemetry import spans as j_spans
    from bng_tpu_torch.telemetry import spans as t_spans

    got = []
    for p, spans in zip(PKGS, (j_spans, t_spans)):
        clock, server, pools, _fp, nat, eng, leased = engine_stack(p)
        comps = {"engine": eng, "pools": pools, "dhcp": server}
        with spans.armed() as tr:
            if arm is not None:
                with p.faults.armed(p.faults.FaultPlan(1, [p.faults.FaultSpec("ops." + arm, FAIL)]),
                                    log=False):
                    rep = OPS[p.name].blue_green_swap(comps)
            else:
                rep = OPS[p.name].blue_green_swap(comps)
        got.append((rep["outcome"], tr.breakdown()["ops"]["count"]))
    assert got[1] == got[0]
    assert got[1] == (("ok", 5) if arm is None else ("rolled_back", 3))


def _hydrated_standby(p, st, ck, edge=None):
    clock, server, pools, fp, nat, eng, _ = st
    tmp = OPS[p.name].clone_mirrors(eng)
    p.ck.restore_checkpoint(ck, **tmp)
    hyd = p.Engine(tmp["fastpath"], tmp["nat"], qos=tmp["qos"], antispoof=tmp["antispoof"],
                   batch_size=eng.B, clock=clock, **p.kw)
    standby = p.Engine(fp, nat, qos=eng.qos, antispoof=eng.antispoof, batch_size=eng.B,
                       slow_path=server.handle_frame, clock=clock, **p.kw)
    standby.adopt_device_tables(hyd.tables)
    return standby


def test_delta_replay_ships_post_snapshot_rows():
    got = []
    for p in PKGS:
        st = engine_stack(p)
        clock, server, pools, fp, nat, eng, _ = st
        eng.quiesce()
        eng.fold_device_authoritative()
        ck = p.ck.roundtrip_checkpoint(p.ck.build_checkpoint(
            0, clock(), fastpath=fp, nat=nat, qos=eng.qos, antispoof=eng.antispoof))
        m = _mac(999)  # one more subscriber leases after the snapshot
        out = eng.process([_discover(m, 0xB00)])
        ip = _reply((out["slow"] or out["tx"])[0][1]).yiaddr
        eng.process([_request(m, ip, 0xB01)])
        eng.quiesce()
        standby = _hydrated_standby(p, st, ck)
        d = OPS[p.name].replay_delta_since(standby, ck.arrays)
        audit = (t_invariants if p is PORT else j_chaos.invariants).audit_invariants(
            engine=standby, pools=pools, dhcp=server, nat=nat)
        got.append((d, audit.violations_by_kind(), audit.ok, standby.pending_dirty()))
    assert got[1] == got[0]
    d, _, ok, pending = got[1]
    assert d["rows"] > 0 and not d["resync"] and ok and pending == 0


@pytest.mark.parametrize("loop", ["aot", "devloop"])
def test_adopt_recaptures_express_and_reseeds_devloop(loop):
    """Adopting a snapshot's chain rolls the device back to the snapshot: a
    lease written after it misses on the express lane (per-batch program or
    devloop ring) until the replay ships it and the scheduler takes the
    engine again. A program left over the old tensors, or a leading copy
    not re-seeded, would still answer it right after the adoption."""
    from test_torch_scheduler import PORT as SP, T0, FakeClock, build_stack, dhcp, mac

    cfg = {"express_loop": loop, "devloop_k": 3} if loop == "devloop" else {}
    sched, server, fp = build_stack(SP, FakeClock(), **cfg)
    eng = sched.engine
    hits = [dhcp(mac(i % 4), F.DISCOVER, 0x700 + i) for i in range(24)]
    assert len(sched.process(hits, now=T0)["tx"]) == 24
    sched.quiesce()
    eng.fold_device_authoritative()
    ck = PORT.ck.roundtrip_checkpoint(PORT.ck.build_checkpoint(
        0, T0, fastpath=fp, nat=eng.nat, qos=eng.qos, antispoof=eng.antispoof))
    x = mac(0x55)
    fp.add_subscriber(x, 1, ip_to_u32("10.0.0.55"), int(T0) + 900)
    probe = [dhcp(x, F.DISCOVER, 0x800 + i) for i in range(24)]
    assert len(sched.process(probe, now=T0)["tx"]) == 24  # x shipped to the old chain
    sched.quiesce()
    captures, resyncs = eng.express_captures, eng.resync_count
    tmp = t_ops.clone_mirrors(eng)
    PORT.ck.restore_checkpoint(ck, **tmp)
    hyd = PORT.Engine(tmp["fastpath"], tmp["nat"], qos=tmp["qos"], antispoof=tmp["antispoof"],
                      batch_size=eng.B, pkt_slot=eng.L, device="cpu")
    eng.adopt_device_tables(hyd.tables)
    assert eng.resync_count == resyncs + 1 and eng.express_captures == captures + 1
    assert eng.express_aot(8).tables is eng.tables.dhcp
    out = sched.process(probe, now=T0)
    assert not out["tx"] and len(out["slow"]) == 24  # the snapshot has no x
    assert len(sched.process(hits, now=T0)["tx"]) == 24  # the snapshot's rows serve
    d = t_ops.replay_delta_since(eng, ck.arrays)
    assert d["rows"] >= 1 and not d["resync"]
    sched.adopt_engine(eng)  # the replayed chain serves the lanes, as the swap's flip does
    assert len(sched.process(probe, now=T0)["tx"]) == 24
    if loop == "devloop":
        assert sched.stats_snapshot()["express"]["devloop"]["fallback_slots"] == 0


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_dense_change_between_snapshot_and_flip(p, monkeypatch):
    """A pool and a hairpin address added after the snapshot (the clone runs
    after it, before the standby is built), with no dirty slot anywhere.
    The port's standby holds the snapshot's arrays and records them as last
    shipped, so its replay ships the change and the swap flips. The
    reference's replay runs only while slots are dirty, none here: its
    standby keeps the snapshot's pools, the audit finds them and the swap
    rolls back (ROADMAP Queue 3)."""
    st = engine_stack(p)
    clock, server, pools, fp, nat, eng, leased = st
    eng.process([])  # the last lease's row ships: nothing is dirty at the snapshot
    comps = {"engine": eng, "pools": pools, "dhcp": server}
    real = OPS[p.name].clone_mirrors

    def clone_then_change(engine):
        fp.add_pool(5, ip_to_u32("10.5.0.0"), 24, ip_to_u32("10.5.0.1"), lease_time=600)
        nat.add_hairpin_ip(ip_to_u32("203.0.113.1"))
        return real(engine)

    monkeypatch.setattr(OPS[p.name], "clone_mirrors", clone_then_change)
    rep = OPS[p.name].blue_green_swap(comps)
    if p is JAX:
        assert rep["outcome"] == "rolled_back" and rep["delta_steps"] == 0
        assert rep["violations"] == {"mirror-mismatch": 1} and comps["engine"] is eng
        return
    assert rep["outcome"] == "ok" and rep["audit_ok"], rep
    assert rep["delta_rows"] == 0 and rep["delta_steps"] == 1
    got = words(comps["engine"])
    assert np.array_equal(got.dhcp.pools, fp.pools)
    assert np.array_equal(got.nat.hairpin_ips, nat.hairpin)


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_edge_stage_goes_with_the_standby(p):
    """The port's standby keeps the active's edge stage (taps, routes); the
    reference's standby is built without one (ROADMAP Queue 3)."""
    st = engine_stack(p, edge=True)
    clock, server, pools, fp, nat, eng, leased = st
    comps = {"engine": eng, "pools": pools, "dhcp": server}
    rep = OPS[p.name].blue_green_swap(comps)
    assert rep["outcome"] == "ok" and rep["audit_ok"], rep
    standby = comps["engine"]
    if p is JAX:
        assert standby.edge is None and standby.geom.tap is None
        assert not any(k.startswith("edge.") for k in rep["restored_rows"])
        return
    assert standby.edge is eng.edge and standby.geom.tap is not None
    assert rep["restored_rows"]["edge.tap"] == 1 and rep["restored_rows"]["edge.route"] == 1
    audit = t_invariants.audit_invariants(engine=standby, pools=pools, dhcp=server, nat=nat)
    assert audit.ok and audit.checks["edge_tap_rows"] == 1 and audit.checks["edge_route_rows"] == 1
    assert audit.checks["mirror_buckets.edge.tap"] == 64


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arm", [None, "swap"])
def test_sharded_swap_matches_reference(arm, n):
    got = []
    for p in PKGS:
        cl = cluster(p, n)
        comps = {"cluster": cl}
        if arm:
            with p.faults.armed(p.faults.FaultPlan(1, [p.faults.FaultSpec("ops.swap", FAIL)]),
                                log=False):
                rep = OPS[p.name].sharded_blue_green_swap(comps, clock=lambda: 1_753_000_000.0)
        else:
            rep = OPS[p.name].sharded_blue_green_swap(comps, clock=lambda: 1_753_000_000.0)
        got.append((strip(rep), comps["cluster"] is cl))
    assert got[1] == got[0]
    rep, kept = got[1]
    if arm:
        assert rep["outcome"] == "failed" and kept
    else:
        assert rep["outcome"] == "ok" and rep["audit_ok"] and not kept
