"""`run --shards N` on the port (`bng_tpu_torch/cli.py`: the sharded
composition root) against the JAX package's.

The reference runs its shards on the virtual CPU devices tests/conftest.py
forces; the port runs its N logical shards on one device (`--device cpu`
here, the card in production). They must give the same bits:

- `run --shards 2 --once`: the same stats document (the port's adds the
  device it ran on).
- Both packages' `BNGApp(shards=2)` on one held clock, fed by the
  cluster-built steered ring: synthetic DISCOVER beats, a DORA through the
  ring, a renewal DISCOVER answered on the device, UDP flows punted to the
  owner shard's NAT and a QoS row from the lease; the same TX and FWD
  bytes, the same `stats()` (the `sharded` block included), the same
  per-shard host table words and device tables, and the same metrics
  exposition of the `bng_shard_*` families.
- The reference's `TestShardedApp` cases on the port: zero missteers,
  OFFERs served, a sharded swap that flips, a post-swap DORA landing on the
  serving cluster, `audit_app` clean; a full DORA whose renewal is
  answered on the device.
- The checkpointer at `--shards 2`: the SIGTERM snapshot encodes to the
  reference's bytes, a restarted app restores it slot-exact (each
  package's snapshot into the other's app) and answers the restored
  leases' renewals on the device, and a single-engine snapshot is rejected
  to a cold start. The sharded snapshot carries an HA store byte-equal and
  restores it into an active and a standby.
- An HA active under shards with NAT on: the reference's lease hook reads
  a host NAT manager that the sharded path does not have and raises; the
  port refuses that config at construction. With NAT off both serve.
- `sharded_blockers`: the scheduler, PPPoE and the fleet are turned off
  under shards, reported in `stats()` (and the fleet's `sharded` blocker),
  as the reference reports them.

Tolerance: exact (bytes, dicts, table words).
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from bng_tpu import cli as j_cli
from bng_tpu.chaos.invariants import audit_app as j_audit_app
from bng_tpu.control.statestore import CheckpointStore as JStore
from bng_tpu.runtime import checkpoint as jck
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos.invariants import audit_app as t_audit_app
from bng_tpu_torch.control.statestore import CheckpointStore as TStore
from bng_tpu_torch.runtime import checkpoint as tck
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_stages import assert_tuple_equal

pytestmark = pytest.mark.torch_port

NOW = 1_753_000_000.0
REMOTE = ip_to_u32("93.184.216.34")
JAX = SimpleNamespace(name="jax", cli=j_cli, ck=jck, Store=JStore, audit=j_audit_app, kw={})
PORT = SimpleNamespace(name="port", cli=t_cli, ck=tck, Store=TStore, audit=t_audit_app,
                       kw={"device": "cpu"})
PKGS = (JAX, PORT)
# the reference's TestShardedApp geometry
APP = dict(shards=2, shard_nbuckets=64, batch_size=16, synthetic_subs=8, dhcpv6_enabled=False,
           slaac_enabled=False, metrics_enabled=True)


def _app(p, clock=lambda: NOW, **over):
    return p.cli.BNGApp(p.cli.BNGConfig(**{**APP, **over}), clock=clock, **p.kw)


def _stats(app) -> dict:
    s = app.stats()
    s.pop("device", None)
    return s


def mac_i(i: int) -> bytes:
    return (0x02D0 << 32 | i).to_bytes(6, "big")


def _dhcp(m, msg_type, xid, **kw) -> bytes:
    p = F.build_request(m, msg_type, xid=xid, **kw)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(m, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67, p.encode().ljust(320, b"\x00"))


def _drain(ring) -> tuple[list, list]:
    tx, fwd = [], []
    while (got := ring.tx_pop()) is not None:
        tx.append(bytes(got[0]))
    while (got := ring.fwd_pop()) is not None:
        fwd.append(bytes(got[0]))
    return tx, fwd


def _beat(app, n=2):
    for _ in range(n):
        app.drive_once()
    app.components["cluster"].flush_pipeline(app._slow_path)
    return _drain(app.components["ring"])


def _host_words(cl) -> list:
    out = []
    for i in range(cl.n):
        for t in ("sub", "vlan", "cid"):
            tb = getattr(cl.fastpath[i], t)
            out.append((i, t, tb.keys.tobytes(), tb.vals.tobytes(), tb.used.tobytes()))
        out.append((i, "pools", cl.fastpath[i].pools.tobytes()))
        m, a = cl.nat[i].checkpoint_state()
        out.append((i, "nat", json.dumps(m, sort_keys=True),
                    [(k, a[k].tobytes()) for k in sorted(a)]))
        out.append((i, "qos", cl.qos[i].up.rows.tobytes(), cl.qos[i].down.rows.tobytes()))
        out.append((i, "garden", cl.garden[i].subscribers.keys.tobytes(),
                    cl.garden[i].allowed.tobytes()))
    return out


def _traffic(app) -> dict:
    """Synthetic beats, a DORA through the ring, a device-answered renewal
    and NAT'd flows; everything the TX/FWD rings carried."""
    ring = app.components["ring"]
    log = {"tx": [], "fwd": []}

    def keep(got):
        log["tx"] += got[0]
        log["fwd"] += got[1]
        return got

    for _ in range(6):
        keep(_beat(app))
    app.config.synthetic_subs = 0  # the scripted frames alone from here
    ips = {}
    for i in range(6):
        m = mac_i(i)
        assert ring.rx_push(_dhcp(m, F.DISCOVER, 0x51 + i), from_access=True)
        tx, _ = keep(_beat(app))
        od = F.decode(tx[-1])
        yiaddr = F.decode_dhcp(od.payload).yiaddr
        assert ring.rx_push(_dhcp(m, F.REQUEST, 0x61 + i, requested_ip=yiaddr,
                                  server_id=od.src_ip), from_access=True)
        keep(_beat(app))
        ips[m] = yiaddr
    for i in range(6):  # renewals: cached on the owner shard
        assert ring.rx_push(_dhcp(mac_i(i), F.DISCOVER, 0x71 + i), from_access=True)
    keep(_beat(app, 3))
    for _round in range(2):  # flows from each lease: punted, then translated
        for k, (m, ip) in enumerate(ips.items()):
            for j in range(2):
                fr = F.udp_packet(m, bytes.fromhex("02aabbccdd01"), ip, REMOTE, 40000 + j, 53,
                                  b"q" * (64 + k))
                assert ring.rx_push(fr, from_access=True)
        keep(_beat(app, 3))
        keep(_beat(app, 3))
    return log


def test_run_once_stats_equal_reference(capsys):
    assert j_cli.main(["run", "--shards", "2", "--once"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert t_cli.main(["--device", "cpu", "run", "--shards", "2", "--once"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.pop("device") == "cpu"
    assert got == ref and ref["sharded"]["shards"] == 2


def test_ring_traffic_tables_and_metrics_equal_reference():
    apps = [_app(p) for p in PKGS]
    try:
        logs = [_traffic(a) for a in apps]
        assert logs[1]["tx"] == logs[0]["tx"] and logs[1]["fwd"] == logs[0]["fwd"]
        assert len(logs[0]["fwd"]) >= 12  # the flows leave NAT'd
        assert _stats(apps[1]) == _stats(apps[0])
        s = _stats(apps[0])["sharded"]
        assert s["missteers"] == 0 and s["psum_dhcp_hits"] >= 6 and s["nat_punts"] >= 12
        cls = [a.components["cluster"] for a in apps]
        for cl in cls:
            cl.quiesce()
        assert _host_words(cls[1]) == _host_words(cls[0])
        ref = jax.tree_util.tree_map(np.asarray, cls[0].tables)
        for i in range(2):
            assert_tuple_equal(convert.tables_to_numpy(cls[1].tables[i]),
                               jax.tree_util.tree_map(lambda a, i=i: a[i], ref), f"shard{i}")
        # the bng_shard_* families from the sharded collector
        expo = []
        for a in apps:
            a.components["collector"].collect_once()
            expo.append(sorted(ln for ln in a.components["metrics"].expose().splitlines()
                               if ln.startswith("bng_shard_") and "_us" not in ln))
        assert expo[1] == expo[0] and expo[0]
    finally:
        for a in apps:
            a.close()


@pytest.fixture()
def app():
    a = _app(PORT)
    yield a
    a.close()


def test_run_shards_end_to_end(app):
    """The reference's case: ring-steered batches reach owner shards with
    zero missteers, the slow path serves OFFERs, a sharded swap flips live,
    a DORA after the swap lands on the serving cluster, the audit is
    clean."""
    c = app.components
    assert "cluster" in c and "engine" not in c and "qos" not in c and "nat" not in c
    for _ in range(20):
        app.drive_once()
    c["cluster"].flush_pipeline(app._slow_path)
    s = app.stats()
    assert s["dhcp"]["offer"] > 0 and s["sharded"]["missteers"] == 0
    assert s["sharded"]["frames"] > 0
    before = c["cluster"]
    rep = app.engine_swap()
    assert rep["outcome"] == "ok" and rep["audit_ok"], rep
    assert c["cluster"] is not before
    for _ in range(5):
        app.drive_once()
    c["cluster"].flush_pipeline(app._slow_path)
    dhcp = c["dhcp"]
    m = mac_i(321)
    offer = dhcp.handle_frame(_dhcp(m, F.DISCOVER, 0x71))
    assert offer is not None
    od = F.decode(offer)
    assert dhcp.handle_frame(_dhcp(m, F.REQUEST, 0x72,
                                   requested_ip=F.decode_dhcp(od.payload).yiaddr,
                                   server_id=od.src_ip)) is not None
    assert c["cluster"].get_subscriber(m) is not None
    assert before.get_subscriber(m) is None  # the retired cluster took no write
    audit = t_audit_app(app)
    assert audit.ok, audit.to_dict()
    assert audit.checks.get("shard_mirror_drain_steps") is not None


def test_full_dora_renewal_hits_device(app):
    c = app.components
    ring, cl = c["ring"], c["cluster"]
    app.config.synthetic_subs = 0
    m = mac_i(77)
    assert ring.rx_push(_dhcp(m, F.DISCOVER, 0x51), from_access=True)
    tx, _ = _beat(app)
    od = F.decode(tx[0])
    assert ring.rx_push(_dhcp(m, F.REQUEST, 0x52, requested_ip=F.decode_dhcp(od.payload).yiaddr,
                              server_id=od.src_ip), from_access=True)
    assert _beat(app)[0]
    hits = cl.telemetry.psum_dhcp_hits
    assert ring.rx_push(_dhcp(m, F.DISCOVER, 0x53), from_access=True)
    assert _beat(app)[0]
    assert cl.telemetry.psum_dhcp_hits > hits
    assert cl.telemetry.snapshot()["missteer_total"] == 0


def test_sharded_warm_restart_equals_reference(tmp_path):
    """The SIGTERM snapshot at --shards 2 is byte-equal across the packages;
    each package's restarted app restores the other's slot-exact, audits
    clean and answers the restored leases' renewals on the device."""
    blobs, apps = [], []
    for p in PKGS:
        d = tmp_path / p.name
        a = _app(p, checkpoint_dir=str(d), node_id="bng-s")
        apps.append(a)
        _traffic(a)
        path = a.components["checkpointer"].save_now(reason="sigterm")
        blobs.append((path.name, path.read_bytes()))
    try:
        assert blobs[1] == blobs[0]
        for src, dst in ((JAX, PORT), (PORT, JAX)):
            d = tmp_path / f"{src.name}-into-{dst.name}"
            d.mkdir()
            name, blob = blobs[PKGS.index(src)]
            (d / name).write_bytes(blob)
            b = _app(dst, checkpoint_dir=str(d), node_id="bng-s")
            b.config.synthetic_subs = 0  # the ring is built; the renewals alone
            try:
                assert "checkpoint_error" not in b.components, b.components["checkpoint_error"]
                rows = b.components["checkpoint_restored"]
                assert rows["dhcp.leases"] == 6
                assert _host_words(b.components["cluster"]) == \
                    _host_words(apps[PKGS.index(src)].components["cluster"])
                assert dst.audit(b).ok
                cl = b.components["cluster"]
                hits = cl.telemetry.psum_dhcp_hits
                for i in range(6):
                    assert b.components["ring"].rx_push(_dhcp(mac_i(i), F.DISCOVER, 0x91 + i),
                                                        from_access=True)
                assert len(_beat(b, 3)[0]) == 6
                assert cl.telemetry.psum_dhcp_hits == hits + 6
                assert b.components["dhcp"].stats.discover == 0  # no slow-path exchange
            finally:
                b.close()
    finally:
        for a in apps:
            a.close()


def test_sharded_checkpoint_carries_the_ha_store():
    """`build_sharded_checkpoint(..., ha=)`: the HA store rides the sharded
    snapshot byte-equal across the packages and restores into an active and
    a standby of the other package."""
    from test_torch_ha import JAX as HJ, PORT as HP, _active

    blobs = []
    for p, hp in ((JAX, HJ), (PORT, HP)):
        a = _app(p, synthetic_subs=0)
        try:
            ck = p.ck.build_sharded_checkpoint(a.components["cluster"], 2, NOW,
                                               dhcp=a.components["dhcp"], ha=_active(hp),
                                               node_id="bng-s")
            blobs.append(p.ck.encode_checkpoint(ck))
        finally:
            a.close()
    assert blobs[1] == blobs[0]
    want = _active(HJ).checkpoint_state()
    for (src, dst), hp in (((JAX, PORT), HP), ((PORT, JAX), HJ)):
        ck = dst.ck.decode_checkpoint(blobs[PKGS.index(src)])
        b = _app(dst, synthetic_subs=0)
        try:
            for live in (hp.ha.ActiveSyncer(hp.ha.InMemorySessionStore()),
                         hp.ha.StandbySyncer(hp.ha.InMemorySessionStore(), transport=None)):
                rows = dst.ck.restore_sharded_checkpoint(ck, b.components["cluster"],
                                                         dhcp=b.components["dhcp"], ha=live)
                assert rows["ha.sessions"] == 4 and live.checkpoint_state() == want
        finally:
            b.close()


def test_ha_active_under_shards_keeps_the_references_fault():
    """The reference's HA active reads its host NAT manager for each lease's
    block; under shards there is none, so its lease hook raises and the
    REQUEST gets no ACK (ROADMAP Queue 3). The port refuses that config at
    construction, naming `--shards 1`; with NAT off both packages' actives
    serve under shards and push the same session."""
    a = _app(JAX, ha_role="active", synthetic_subs=0)
    try:
        dhcp = a.components["dhcp"]
        m = mac_i(5)
        od = F.decode(dhcp.handle_frame(_dhcp(m, F.DISCOVER, 0x11)))
        req = _dhcp(m, F.REQUEST, 0x12, requested_ip=F.decode_dhcp(od.payload).yiaddr,
                    server_id=od.src_ip)
        with pytest.raises(AttributeError):
            dhcp.handle_frame(req)
        assert (len(a.components["ha_store"]), dhcp.stats.ack) == (0, 0)
    finally:
        a.close()
    with pytest.raises(t_cli.UnservableConfigError, match="--shards 1"):
        _app(PORT, ha_role="active", synthetic_subs=0)
    assert t_cli.main(["--device", "cpu", "run", "--once", "--shards", "2",
                       "--ha-role", "active"]) == 2

    got = []
    for p in PKGS:
        a = _app(p, ha_role="active", synthetic_subs=0, nat_enabled=False)
        try:
            dhcp = a.components["dhcp"]
            m = mac_i(5)
            od = F.decode(dhcp.handle_frame(_dhcp(m, F.DISCOVER, 0x11)))
            ip = F.decode_dhcp(od.payload).yiaddr
            ack = F.decode_dhcp(F.decode(dhcp.handle_frame(
                _dhcp(m, F.REQUEST, 0x12, requested_ip=ip, server_id=od.src_ip))).payload)
            assert ack.msg_type == F.ACK and ack.yiaddr == ip
            got.append(sorted((s.mac, s.ip, s.pool_id) for s in a.components["ha_store"].all()))
        finally:
            a.close()
    assert got[1] == got[0] and len(got[0]) == 1


def test_single_engine_snapshot_rejected_to_cold_start(tmp_path):
    errs = []
    for p in PKGS:
        d = tmp_path / p.name
        one = _app(p, shards=1, synthetic_subs=0, checkpoint_dir=str(d))
        try:
            one.components["checkpointer"].save_now()
        finally:
            one.close()
        two = _app(p, checkpoint_dir=str(d))
        try:
            errs.append(two.components.get("checkpoint_error", ""))
            assert "checkpoint_restored" not in two.components
            assert two.components["dhcp"].leases == {}
        finally:
            two.close()
    assert errs[1] == errs[0] and "single-engine" in errs[0]


def test_sharded_blockers_reported_as_reference():
    got = []
    for p in PKGS:
        a = _app(p, scheduler_enabled=True, pppoe_enabled=True, slowpath_workers=2,
                 slowpath_worker_mode="inline", synthetic_subs=0)
        try:
            assert "scheduler" not in a.components and "fleet" not in a.components
            assert "pppoe_tables" not in a.components
            s = _stats(a)
            got.append((a.sharded_blockers, a.fleet_blockers, s["sharded_blockers"],
                        s["slowpath_fleet_blocked"], s["sharded"]))
        finally:
            a.close()
    assert got[1] == got[0]
    assert got[0][0] == ["scheduler", "pppoe", "slowpath-fleet"]
    assert got[0][1] == ["pppoe", "sharded"]
