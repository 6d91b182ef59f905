"""The port's slow-path fleet (`bng_tpu_torch/control/{fleet,admission}.py`,
the autoscaler in `control/opsctl.py`, and the fleet's parts of the audit,
the checkpoint, the metrics and `run`) against the JAX package's.

- The inline fleet: the same DORA, renewal and release frames through
  both packages' fleets (1 and 3 workers, one held SimClock) give the same
  reply bytes, worker lease books (`export_state`), parent pool bitmaps,
  host fast-path rows and stats. Worker `busy_s` is wall time
  (`time.perf_counter`) and is masked from the stats.
- Admission: a small inbox and a queue-age deadline shed the same frames
  with the same counts (DISCOVERs only, never an OFFERed REQUEST).
- Resize (shrink and grow) and a rolling restart with OFFERs in flight
  give the same reports (`duration_s` masked: wall time) and books.
- CoA on the owning shard: locate, a policy change and a disconnect.
- RADIUS on the owning shard: each worker's own client (the reference's
  `FakeRadiusServer` on its transport) gives the same replies, auth
  counts and lease policies; a worker whose server never answers
  refuses new subscribers in both packages.
- The checkpoint's `fleet` component encodes byte-equal in both
  packages, and each restores the other's, into a fleet of another size
  and into a fleet-less server.
- The audit's fleet clauses: clean, then a double grant, an allocation
  outside its grant, a carve leak and a worker double lease, reported as
  the reference reports them.
- `collect_fleet` / `record_fleet_blocked`: the same exposition lines.
- `FleetAutoscaler`: the same decisions over the same looks.
- One 2-worker process-mode fleet (spawned workers) answers as the inline
  one does; the Nexus mode builds a worker-local allocator and FSM.
- `run --slowpath-workers 2 --slowpath-worker-mode inline` on the CPU:
  the same TX bytes and lease books as the reference's app; the `ctl`
  verbs over `--ctl-listen` (status, fleet resize, rolling restart,
  engine swap) with a clean audit after; `loadtest --workers 2`.

Tolerance: exact (bytes, dicts), with the wall-time fields named above
masked.
"""

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from bng_tpu.chaos import faults as j_faults
from bng_tpu.chaos import invariants as j_inv
from bng_tpu.chaos import scenarios as j_sc
from bng_tpu.control import admission as j_adm
from bng_tpu.control import fleet as j_fleet
from bng_tpu.control import metrics as j_metrics
from bng_tpu.control import opsctl as j_ops
from bng_tpu.control.radius import client as j_rc
from bng_tpu.runtime import checkpoint as j_ck
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch.chaos import faults as t_faults
from bng_tpu_torch.chaos import invariants as t_inv
from bng_tpu_torch.chaos import scenarios as t_sc
from bng_tpu_torch.control import admission as t_adm
from bng_tpu_torch.control import fleet as t_fleet
from bng_tpu_torch.control import metrics as t_metrics
from bng_tpu_torch.control import opsctl as t_ops
from bng_tpu_torch.control.radius import client as t_rc
from bng_tpu_torch.runtime import checkpoint as t_ck

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(name="jax", sc=j_sc, fleet=j_fleet, adm=j_adm, inv=j_inv, ck=j_ck,
                      faults=j_faults, metrics=j_metrics, ops=j_ops, rc=j_rc)
PORT = SimpleNamespace(name="port", sc=t_sc, fleet=t_fleet, adm=t_adm, inv=t_inv, ck=t_ck,
                       faults=t_faults, metrics=t_metrics, ops=t_ops, rc=t_rc)
PKGS = (JAX, PORT)
WALL = ("busy_s", "lat_hist", "duration_s", "quiesce_s")


def _mask(x):
    """Drop the wall-time fields (perf_counter readings) from a report."""
    if isinstance(x, dict):
        return {k: _mask(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def _macs(n, base=0):
    return [t_sc._mac(0x4000 + base + i) for i in range(n)]


def _dora(p, fleet, clock, macs, rounds=4):
    """DORA every MAC (retransmitting lost exchanges), renew half, release
    two; returns (every batch's replies, {mac: ip} of the live leases)."""
    sc = p.sc
    replies, offers, leased, xid = [], {}, {}, 1
    for _ in range(rounds):
        batch, bm = [], []
        for m in macs:
            if m in leased:
                continue
            f = sc._request(m, offers[m], xid) if m in offers else sc._discover(m, xid)
            batch.append((len(batch), f))
            bm.append(m)
            xid += 1
        if not batch:
            break
        out = fleet.handle_batch(batch, now=clock())
        replies.append(out)
        for (_lane, rep), m in zip(out, bm):
            if rep is None:
                continue
            pk = sc._reply(rep)
            if pk.msg_type == sc.dhcp_codec.OFFER:
                offers[m] = pk.yiaddr
            elif pk.msg_type == sc.dhcp_codec.ACK:
                leased[m] = pk.yiaddr
        clock.advance(1.0)
    ms = sorted(leased)
    replies.append(fleet.handle_batch(
        [(i, sc._renew(m, leased[m], 0x7000 + i)) for i, m in enumerate(ms[::2])],
        now=clock.advance(30.0)))
    replies.append(fleet.handle_batch(
        [(i, sc._release(m, leased[m], 0x7800 + i)) for i, m in enumerate(ms[:2])],
        now=clock()))
    return replies, {m: leased[m] for m in ms[2:]}


def _state(fleet, pools, fastpath):
    sub = fastpath.sub
    used = np.nonzero(sub.used)[0]
    return (_mask(fleet.export_state()), _mask(fleet.stats_snapshot()),
            {pid: dict(p._allocated) for pid, p in pools.pools.items()},
            sub.keys[used].tolist(), sub.vals[used].tolist())


@pytest.mark.parametrize("workers", [1, 3])
def test_inline_fleet_dora_matches_reference(workers):
    got = []
    for p in PKGS:
        clock = p.faults.SimClock(1000.0)
        fleet, pools, fastpath = p.sc.build_fleet(workers, clock)
        replies, leased = _dora(p, fleet, clock, _macs(20))
        got.append((replies, leased, _state(fleet, pools, fastpath)))
    assert got[1] == got[0]
    replies, leased, (state, snap, *_rest) = got[1]
    assert len(leased) == 18 and len(set(leased.values())) == 18
    assert snap["workers"] == workers and snap["worker_failures"] == 0
    assert sum(len(w["leases"]) for w in state["workers"]) == 18  # two released


def test_admission_sheds_like_reference():
    got = []
    for p in PKGS:
        clock = p.faults.SimClock(1000.0)
        fastpath = p.sc._make_fastpath()
        pools = p.sc._make_pools(fastpath)
        spec = p.fleet.FleetSpec.from_pool_manager(p.sc.SERVER_MAC, p.sc.SERVER_IP, pools,
                                                   slice_size=64, low_watermark=16)
        fleet = p.fleet.SlowPathFleet(spec, 2, pools, mode="inline", table_sink=fastpath,
                                      clock=clock,
                                      admission=p.adm.AdmissionConfig(inbox_capacity=4,
                                                                      deadline_ms=50.0))
        macs = _macs(24, 100)
        first = fleet.handle_batch([(i, p.sc._discover(m, i)) for i, m in enumerate(macs)],
                                   now=clock())
        offered = [m for (_l, r), m in zip(first, macs) if r is not None]
        # REQUESTs of the OFFERed clients beside DISCOVERs of new clients,
        # over the inboxes: only the DISCOVERs shed
        items = [(i, p.sc._request(m, p.sc._reply(r).yiaddr, 100 + i))
                 for i, ((_l, r), m) in enumerate(zip(first, macs)) if r is not None]
        items += [(len(items) + i, p.sc._discover(m, 200 + i))
                  for i, m in enumerate(_macs(6, 300))]
        second = fleet.handle_batch(items, now=clock.advance(0.5))
        # two DISCOVERs queued 0.2 s (past the 50 ms deadline), under the
        # inbox bound: they shed on the deadline
        third = fleet.handle_batch([(i, p.sc._discover(m, 400 + i), clock() - 0.2)
                                    for i, m in enumerate(_macs(2, 400))], now=clock())
        got.append((first, second, third, offered, fleet.admission.stats_snapshot()))
    assert got[1] == got[0]
    first, second, third, offered, adm = got[1]
    assert 0 < len(offered) < 24 and adm["shed"]["inbox_full"] == 16 + 6
    assert all(r is not None for _l, r in second[:len(offered)])  # no OFFERed REQUEST shed
    assert adm["shed"]["deadline"] == 2 and third == [(0, None), (1, None)]


def test_resize_and_rolling_restart_match_reference():
    got = []
    for p in PKGS:
        clock = p.faults.SimClock(1000.0)
        fleet, pools, fastpath = p.sc.build_fleet(4, clock)
        _replies, leased = _dora(p, fleet, clock, _macs(16, 500))
        offers = p.sc._start_inflight(fleet, clock, _macs(4, 600))
        shrink = fleet.resize(2)
        done = p.sc._complete_inflight(fleet, clock, offers)
        grow = fleet.resize(5)
        offers = p.sc._start_inflight(fleet, clock, _macs(3, 700))
        roll = fleet.rolling_restart()
        done2 = p.sc._complete_inflight(fleet, clock, offers)
        renewed = p.sc._renew_all(fleet, clock, leased)
        audit = p.inv.audit_invariants(pools=pools, fleet=fleet, fastpath=fastpath)
        got.append((_mask(shrink), _mask(grow), _mask(roll), done, done2, renewed,
                    _state(fleet, pools, fastpath), audit.to_dict()))
    assert got[1] == got[0]
    shrink, grow, roll, done, done2, renewed, _st, audit = got[1]
    assert shrink["outcome"] == grow["outcome"] == roll["outcome"] == "ok"
    assert shrink["offers_moved"] == 4 and done == 4 and done2 == 3
    assert renewed == 14
    assert audit["ok"]


def test_coa_on_the_owning_shard_matches_reference():
    got = []
    for p in PKGS:
        clock = p.faults.SimClock(1000.0)
        fleet, pools, fastpath = p.sc.build_fleet(3, clock)
        _replies, leased = _dora(p, fleet, clock, _macs(9, 800))
        ms = sorted(leased)
        out = [fleet.handle_coa("locate", ip=leased[ms[0]]),
               fleet.handle_coa("locate", mac=ms[1]),
               fleet.handle_coa("qos", ip=leased[ms[2]], policy_name="gold"),
               fleet.handle_coa("disconnect", ip=leased[ms[3]]),
               fleet.handle_coa("locate", ip=0x0A0A0A0A)]
        got.append((_mask(out), _state(fleet, pools, fastpath)))
    assert got[1] == got[0]
    out = got[1][0]
    assert [o["found"] for o in out] == [True, True, True, True, False]


def test_radius_fan_out_per_shard_matches_reference():
    """Each worker authenticates its own shard's subscribers over its own
    RADIUS client: the same replies, per-worker auth requests and lease
    policies as the reference's; a worker whose server never answers
    refuses (no cached profile exists for a new MAC in either package)."""
    from test_radius import SECRET, FakeRadiusServer

    from bng_tpu.control.radius import packet as rp

    got = []
    for p in PKGS:
        clock = p.faults.SimClock(1000.0)
        fastpath = p.sc._make_fastpath()
        pools = p.sc._make_pools(fastpath)
        spec = p.fleet.FleetSpec.from_pool_manager(
            p.sc.SERVER_MAC, p.sc.SERVER_IP, pools, slice_size=64, low_watermark=16,
            radius_servers=[p.rc.RadiusServerConfig("10.0.0.5", secret=SECRET, timeout_s=0.01,
                                                    retries=1)])
        fleet = p.fleet.SlowPathFleet(spec, 3, pools, mode="inline", table_sink=fastpath,
                                      clock=clock)
        users = {"": {"password": "", "attrs": [(rp.FILTER_ID, "gold")]}}
        for w, worker in enumerate(fleet._inline):
            worker.radius.transport = ((lambda *a: None) if w == 2
                                       else FakeRadiusServer(users=users))
        replies, leased = _dora(p, fleet, clock, _macs(12, 1300), rounds=2)
        snap = fleet.stats_snapshot()
        got.append((replies, leased, [w.get("auth_requests") for w in snap["per_worker"]],
                    sorted((lz["mac"], lz["qos_policy"]) for w in fleet.export_state()["workers"]
                           for lz in w["leases"])))
    assert got[1] == got[0]
    _replies, leased, auth, policies = got[1]
    assert 0 < len(leased) < 12 and all(a for a in auth)
    assert {pol for _m, pol in policies} == {"gold"}


def _fleet_with_books(p, workers=3):
    clock = p.faults.SimClock(1000.0)
    fleet, pools, fastpath = p.sc.build_fleet(workers, clock)
    _replies, leased = _dora(p, fleet, clock, _macs(12, 900))
    return fleet, pools, fastpath, leased, clock


def test_fleet_checkpoint_component_byte_equal_and_cross_restores():
    built = {p.name: _fleet_with_books(p) for p in PKGS}
    data = {p.name: p.ck.encode_checkpoint(p.ck.build_checkpoint(
        1, 1000.0, fleet=built[p.name][0], node_id="t")) for p in PKGS}
    assert data["port"] == data["jax"]
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        ck = dst.ck.decode_checkpoint(data[src.name])
        # into a fleet of another size: every lease re-shards onto its owner
        clock = dst.faults.SimClock(1000.0)
        fleet2, pools2, fp2 = dst.sc.build_fleet(2, clock)
        rows = dst.ck.restore_checkpoint(ck, fleet=fleet2)
        leased = built[src.name][3]
        assert rows == {"fleet.leases": len(leased)}
        assert dst.sc._renew_all(fleet2, clock, leased) == len(leased)
        assert dst.inv.audit_invariants(pools=pools2, fleet=fleet2, fastpath=fp2).ok
        # into a server with no fleet: the worker books merge
        server, _pools, _fp, _nat = dst.sc._build_server_stack(dst.faults.SimClock(1000.0))
        assert dst.ck.restore_checkpoint(ck, dhcp=server) == {"dhcp.leases": len(leased)}
        assert {lz.ip for lz in server.leases.values()} == set(leased.values())


def _plant(p, fleet, pools, kind):
    w0, w1 = fleet._inline[0], fleet._inline[1]
    sp0, sp1 = w0.pools.pools[1], w1.pools.pools[1]
    if kind == "double-grant":
        sp1.grant([next(iter(sp0._granted))])
    elif kind == "outside-grant":
        ip = pools.pools[1].first + 3000
        sp0._allocated[ip] = "x"
    elif kind == "carve-leak":
        ip = next(iter(sp0._granted))
        pools.pools[1]._allocated[ip] = "someone-else"
    elif kind == "double-lease":
        mk, lease = next(iter(w0.server.leases.items()))
        w1.server.leases[mk] = lease


@pytest.mark.parametrize("kind", ["clean", "double-grant", "outside-grant", "carve-leak",
                                  "double-lease"])
def test_fleet_audit_clauses_match_reference(kind):
    got = []
    for p in PKGS:
        fleet, pools, fastpath, _leased, _clock = _fleet_with_books(p)
        _plant(p, fleet, pools, kind)
        got.append(p.inv.audit_invariants(pools=pools, fleet=fleet, fastpath=fastpath,
                                          check_roundtrip=kind == "clean").to_dict())
    assert got[1] == got[0]
    assert got[1]["ok"] == (kind == "clean")
    assert got[1]["checks"]["slice_granted"] > 0


def test_collect_fleet_and_blocked_gauge_match_reference():
    got = []
    for p in PKGS:
        fleet, *_ = _fleet_with_books(p)
        m = p.metrics.BNGMetrics()
        m.collect_fleet(fleet)
        m.collect_exhaustion(fleet=fleet)
        m.record_fleet_blocked(["pppoe", "sharded"])
        m.record_fleet_blocked(["pppoe"])
        got.append([ln for ln in m.expose().splitlines()
                    if ln.startswith(("bng_slowpath_", "bng_fabric_", "bng_pool_exhausted"))
                    and "busy_seconds" not in ln])
    assert got[1] == got[0]
    assert 'bng_slowpath_fleet_blocked{blocker="pppoe"} 1' in got[1]
    assert not any('blocker="sharded"' in ln for ln in got[1])


def test_autoscaler_decisions_match_reference():
    class Fake:
        def __init__(self):
            self.n, self.shed, self.busy = 2, 0, 0.0
            self.admission = SimpleNamespace(shed_total=lambda: self.shed)

        def busy_seconds_total(self):
            return self.busy

    looks = [(0, 0.0), (5, 1.0), (5, 1.5), (5, 0.2), (5, 0.3), (5, 0.35), (5, 0.4),
             (5, 0.45), (9, 3.0), (9, 9.0), (9, 9.1), (9, 9.2), (9, 9.3), (9, 9.4)]
    got = []
    for p in PKGS:
        f = Fake()
        sc = p.ops.FleetAutoscaler(f, p.ops.AutoscaleConfig(min_workers=1, max_workers=4,
                                                            hold=2, cooldown_s=10.0),
                                   clock=lambda: 0.0)
        out = []
        for i, (shed, busy) in enumerate(looks):
            f.shed, f.busy = shed, busy
            t = sc.target(now=float(i * 6))
            if t is not None:
                f.n = t
            out.append((t, f.n))
        got.append((out, sc.decisions))
    assert got[1] == got[0]
    assert got[1][1] >= 2


def _no_expiry(state):
    """A spawned worker's DHCP server runs on the host clock (a SimClock
    cannot cross the process boundary), so lease expiries and the start
    stamp in session ids (`bng-<start hex>-<seq>`) are wall time."""
    return [[{**{k: v for k, v in lz.items() if k != "expiry"},
              "session_id": lz["session_id"].rsplit("-", 1)[1]} for lz in w["leases"]]
            for w in state["workers"]]


def test_process_mode_fleet_answers_like_inline():
    """Two spawned worker processes: the same replies, books (expiry
    and session stamps masked: the children's clock is the host's) and
    audit as the
    reference's inline fleet."""
    got = []
    for p, mode in ((JAX, "inline"), (PORT, "process")):
        clock = p.faults.SimClock(1000.0)
        fastpath = p.sc._make_fastpath()
        pools = p.sc._make_pools(fastpath)
        spec = p.fleet.FleetSpec.from_pool_manager(p.sc.SERVER_MAC, p.sc.SERVER_IP, pools,
                                                   slice_size=64, low_watermark=16)
        fleet = p.fleet.SlowPathFleet(spec, 2, pools, mode=mode, table_sink=fastpath,
                                      clock=clock)
        try:
            replies, leased = _dora(p, fleet, clock, _macs(10, 1100))
            audit = p.inv.audit_invariants(pools=pools, fleet=fleet, fastpath=fastpath,
                                           check_roundtrip=False)
            audit = audit.to_dict()
            # slices live in the children in process mode: the clause audits
            # inline slices only (the reference's too)
            granted = audit["checks"].pop("slice_granted")
            got.append((replies, leased, _no_expiry(fleet.export_state()), audit,
                        fleet.stats_snapshot()["worker_failures"]))
        finally:
            fleet.close()
    assert got[1] == got[0]
    assert len(got[1][1]) == 8 and got[1][3]["ok"] and got[1][4] == 0 and granted == 0


def test_nexus_mode_refused_by_name():
    """The Nexus mode the port once refused by name now builds in both
    packages: each worker its own HTTPAllocator under `<node>-w<i>` and
    its own partition FSM (`tests/test_torch_resilience.py` serves
    through it)."""
    assert not hasattr(t_fleet, "refuse_nexus")
    got = []
    for p in PKGS:
        fp = p.sc._make_fastpath()
        pools = p.sc._make_pools(fp)
        spec = p.fleet.FleetSpec.from_pool_manager(p.sc.SERVER_MAC, p.sc.SERVER_IP, pools,
                                                   nexus_url="http://nexus:9000",
                                                   nexus_node_id="mb")
        fleet = p.fleet.SlowPathFleet(spec, 2, pools, mode="inline")
        try:
            got.append([(w.nexus.base_url, w.nexus.node_id, w.nexus_resilience.state.value,
                         type(w.server.allocator).__name__) for w in fleet._inline])
        finally:
            fleet.close()
        w = p.fleet.FleetWorker(spec, 0, 1)
        got.append((w.nexus.node_id, w.nexus_resilience.partitioned))
    assert got[2:] == got[:2]
    assert got[0] == [("http://nexus:9000", f"mb-w{i}", "normal", "_WorkerNexusAllocator")
                      for i in range(2)]


# -- run with workers ----------------------------------------------------

def _app_dora(m, n_macs=6):
    """Both apps at `run`'s defaults with an inline 2-worker fleet, over a
    ring at one held clock: DORA n MACs, then renew them (answered on the
    device from the rows the fleet's events replayed)."""
    from test_torch_cli import F, _beat, _client
    from bng_tpu_torch.utils.net import ip_to_u32

    clk = [float(1_753_000_000)]
    cfg = m.cli.BNGConfig(pool_cidr="10.50.0.0/24", lease_time=600, batch_size=32,
                          slowpath_workers=2, slowpath_worker_mode="inline")
    app = m.cli.BNGApp(cfg, clock=lambda: clk[0], **m.kw)
    try:
        ring = app.components["ring"] = m.Ring(256, 2048, 128)
        macs = [bytes.fromhex(f"02deadbe{i:04x}") for i in range(n_macs)]
        steps = [_beat(app, ring, clk, [_client(mc, F.DISCOVER, xid=0x100 + i)
                                        for i, mc in enumerate(macs)])]
        offers = {F.decode_dhcp(F.decode(f).payload).chaddr[:6]:
                  F.decode_dhcp(F.decode(f).payload).yiaddr for f in steps[0]}
        steps.append(_beat(app, ring, clk, [
            _client(mc, F.REQUEST, xid=0x200 + i, requested_ip=offers[mc],
                    server_id=ip_to_u32("10.0.0.1")) for i, mc in enumerate(macs)]))
        clk[0] += 30
        steps.append(_beat(app, ring, clk, [_client(mc, F.REQUEST, xid=0x300 + i,
                                                    ciaddr=offers[mc])
                                            for i, mc in enumerate(macs)]))
        fleet = app.components["fleet"]
        st = app.stats()
        shared = {k: st[k] for k in ("engine", "pools", "nat")}
        return (steps, _mask(fleet.export_state()), shared, _mask(st["slowpath_fleet"]),
                app.components["engine"].stats.tx)
    finally:
        app.close()


def test_run_with_inline_workers_matches_reference():
    from test_torch_cli import JAX as CJ, PORT as CP

    ref, got = _app_dora(CJ), _app_dora(CP)
    assert got[:4] == ref[:4]
    steps, books, _shared, snap, _tx = got
    assert [len(s) for s in steps] == [6, 6, 6]
    assert sum(len(w["leases"]) for w in books["workers"]) == 6
    assert snap["workers"] == 2 and snap["worker_failures"] == 0


def test_run_once_with_workers_and_blocked_fleet(capsys):
    assert t_cli.main(["--device", "cpu", "run", "--once", "--slowpath-workers", "2",
                       "--slowpath-worker-mode", "inline"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["slowpath_fleet"]["workers"] == 2 and st["slowpath_fleet"]["mode"] == "inline"
    app = t_cli.BNGApp(t_cli.BNGConfig(slowpath_workers=2, pppoe_enabled=True), device="cpu")
    try:
        assert app.fleet_blockers == ["pppoe"] and "fleet" not in app.components
        assert app.stats()["slowpath_fleet_blocked"] == ["pppoe"]
        assert 'bng_slowpath_fleet_blocked{blocker="pppoe"} 1' in \
            app.components["metrics"].expose()
        assert app.fleet_resize(3)["error"] == "no slow-path fleet: blocked by ['pppoe']"
    finally:
        app.close()


def test_ctl_verbs_over_the_wire(capsys):
    app = t_cli.BNGApp(t_cli.BNGConfig(slowpath_workers=2, slowpath_worker_mode="inline",
                                       synthetic_subs=32, batch_size=32, metrics_enabled=True),
                       device="cpu")
    srv = t_ops.OpsServer(app.components["ops"], "127.0.0.1", 0).start()
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            app.drive_once()
            app.components["ops"].run_pending()
            stop.wait(0.005)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    addr = f"{srv.addr[0]}:{srv.addr[1]}"
    try:
        for argv, check in ((["fleet", "resize", "3"], lambda r: r["to"] == 3),
                            (["fleet", "rolling-restart"], lambda r: len(r["replaced"]) == 3),
                            (["engine", "swap"], lambda r: r["audit_ok"]),
                            (["status"], lambda r: r["fleet"]["workers"] == 3
                             and r["fleet"]["resizes"] == 1)):
            assert t_cli.main(["ctl", "--ctl-addr", addr, *argv]) == 0, argv
            rep = json.loads(capsys.readouterr().out)
            assert argv == ["status"] or rep["outcome"] == "ok", rep
            assert check(rep), rep
        stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        from bng_tpu_torch.chaos.invariants import audit_app

        assert audit_app(app).ok
        assert 'bng_ops_transitions_total{op="fleet_resize",outcome="ok"} 1' in \
            app.components["metrics"].expose()
    finally:
        stop.set()
        srv.close()
        app.close()
    assert t_cli.main(["ctl", "--ctl-addr", addr, "status"]) == 2  # nothing listens


def test_loadtest_with_workers(capsys):
    assert t_cli.main(["--device", "cpu", "loadtest", "--duration", "0.5", "--warmup", "0.2",
                       "--macs", "128", "--batch-size", "32", "--workers", "2",
                       "--fleet-mode", "inline", "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["fleet"]["workers"] == 2 and res["fleet"]["worker_failures"] == 0
    assert res["fleet"]["admission"]["admitted"] > 0
