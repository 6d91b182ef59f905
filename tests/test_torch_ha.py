"""The port's HA pair (`bng_tpu_torch/control/ha.py`), its checkpoint
component, the pair's audit clause and its chaos scenario against the JAX
package's.

- Syncers: the same script of pushes, deletes, a flaky and a dead peer,
  stream drops, a replay-buffer gap, a sink that raises, a bootstrap and a
  restarted active gives the same store, sequence numbers, stats, replay
  answers and backoff schedule at every step in both packages; so do the
  health monitor and the failover controller under one probe script.
- The `ha` checkpoint component: the same active (alone, and beside a DHCP
  lease book) encodes to the same bytes in both packages; each package
  decodes the other's and restores it into an active (which resumes its
  sequence) and into a standby (which bootstraps, then replays only the
  delta); a corrupt session row is refused before any store changes.
- `_audit_ha_pair`: a connected standby with a session the active
  deleted, one missing, and one that differs gives the reference's report;
  a disconnected standby is allowed to lag.
- `ha_delta_drop_reconnect` gives the reference's canonical report.

Tolerance: exact (dicts, bytes, canonical JSON).
"""

from types import SimpleNamespace

import pytest

from bng_tpu.chaos import invariants as j_inv
from bng_tpu.chaos import runner as j_runner
from bng_tpu.chaos import scenarios as j_sc
from bng_tpu.control import ha as j_ha
from bng_tpu.control.dhcp_server import DHCPServer as JServer
from bng_tpu.control.pool import Pool as JPool
from bng_tpu.control.pool import PoolManager as JPools
from bng_tpu.runtime import checkpoint as jck
from bng_tpu.runtime.tables import FastPathTables as JFastPath
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import invariants as t_inv
from bng_tpu_torch.chaos import runner as t_runner
from bng_tpu_torch.chaos import scenarios as t_sc
from bng_tpu_torch.control import ha as t_ha
from bng_tpu_torch.control.dhcp_server import DHCPServer as TServer
from bng_tpu_torch.control.pool import Pool as TPool
from bng_tpu_torch.control.pool import PoolManager as TPools
from bng_tpu_torch.runtime import checkpoint as tck
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPath
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

NOW = 1_753_000_000.0
SERVER_MAC = bytes.fromhex("02aabbccdd01")
SERVER_IP = ip_to_u32("10.0.0.1")
JAX = SimpleNamespace(name="jax", ha=j_ha, ck=jck, inv=j_inv, FastPathTables=JFastPath,
                      Pool=JPool, PoolManager=JPools, DHCPServer=JServer)
PORT = SimpleNamespace(name="port", ha=t_ha, ck=tck, inv=t_inv, FastPathTables=TFastPath,
                       Pool=TPool, PoolManager=TPools, DHCPServer=TServer)
PKGS = (JAX, PORT)


def _session(ha, i: int, t: float = NOW, **kw):
    return ha.SessionState(session_id=f"s-{i:04d}", mac=f"02:00:00:00:00:{i:02x}",
                           ip=ip_to_u32("10.3.0.1") + i, pool_id=1, lease_expiry=t + 3600,
                           qos_policy="residential-100mbps", updated_at=t, **kw)


def _rows(store) -> list:
    return sorted(sorted(s.to_dict().items()) for s in store.all())


def _view(active, standby) -> dict:
    return {"active_seq": active._seq, "standby_seq": standby.last_seq,
            "connected": standby.connected, "active_stats": dict(active.stats),
            "standby_stats": dict(standby.stats),
            "active_store": _rows(active.store), "standby_store": _rows(standby.store),
            "next_attempt": standby._next_attempt, "backoff": standby._backoff}


def _syncer_script(p) -> list:
    """One run of the pair through every path of the syncers."""
    ha = p.ha
    active = ha.ActiveSyncer(ha.InMemorySessionStore(), replay_buffer=6)
    peer = {"up": False}

    def transport():
        if not peer["up"]:
            raise ConnectionError("peer down")
        return active

    standby = ha.StandbySyncer(ha.InMemorySessionStore(), transport=transport,
                               backoff_initial_s=1.0, backoff_max_s=8.0)
    log = []
    for t in (0.0, 0.5, 1.0, 3.0):  # dead peer: backoff 1, 2, 4
        standby.tick(t)
        log.append(_view(active, standby))
    for i in range(4):
        active.push_change(_session(ha, i))
    peer["up"] = True
    standby.tick(7.0)  # full sync
    log.append(_view(active, standby))
    for i in range(4, 7):
        active.push_change(_session(ha, i))
    active.push_change(None, session_id="s-0001")
    log.append(_view(active, standby))
    log.append([c.seq for c in active.replay_since(active._seq - 2)])
    log.append(active.replay_since(0))  # fell out of the buffer
    log.append(active.replay_since(active._seq))
    # a drop: the standby misses two changes, then heals by replay
    standby.disconnect()
    active.push_change(_session(ha, 7))
    active.push_change(_session(ha, 2, t=NOW + 5))
    standby.tick(8.0)
    log.append(_view(active, standby))
    # a longer outage outruns the replay buffer: a full resync
    standby.disconnect()
    for i in range(8, 16):
        active.push_change(_session(ha, i))
    standby.tick(9.0)
    log.append(_view(active, standby))

    # a sink that raises is dropped, the active's write path goes on
    def bad(_ch):
        raise RuntimeError("replica sink broke")

    active.subscribe(bad)
    active.push_change(_session(ha, 16))
    log.append(_view(active, standby))
    # the checkpoint cut: a restarted active resumes the sequence, a fresh
    # standby bootstraps from it and replays only what came after
    cut = active.checkpoint_state()
    active.push_change(_session(ha, 17))
    active2 = ha.ActiveSyncer(ha.InMemorySessionStore())
    log.append(active2.restore_state(cut))
    standby2 = ha.StandbySyncer(ha.InMemorySessionStore(), transport=lambda: active)
    log.append(standby2.bootstrap_state(cut))
    standby2.tick(10.0)
    log.append(_view(active, standby2))
    log.append(_view(active2, standby2))
    log.append(standby2.checkpoint_state())
    return log


def test_syncer_sequences_equal_reference():
    ref, got = _syncer_script(JAX), _syncer_script(PORT)
    assert got == ref
    assert ref[-3]["standby_stats"] == {"full_syncs": 0, "deltas": 1, "reconnects": 1,
                                        "bootstraps": 1}


def _failover_script(p) -> list:
    ha = p.ha
    probes = iter([True, False, False, False, False, True, True, True, False, True, True]
                  + [True] * 40)
    events, roles = [], []
    ctl = ha.FailoverController(failover_delay_s=2.0, failback_delay_s=5.0,
                                on_role_change=roles.append)

    def on_event(ev):
        events.append((ev.state.value, ev.at, ev.consecutive_failures))
        ctl.handle_health_event(ev)

    mon = ha.HealthMonitor(lambda: next(probes), interval_s=1.0, failure_threshold=3,
                           recovery_threshold=2, on_event=on_event)
    log = []
    for k in range(1, 30):
        t = float(k)
        log.append((mon.tick(t).value, mon.tick(t + 0.5).value))
        ctl.tick(t)
        log.append((ctl.state.value, ctl.role.value, dict(ctl.stats)))
    ctl.force_failover()
    ctl.force_failback()
    log.append((ctl.state.value, ctl.role.value, dict(ctl.stats)))
    return [log, events, [r.value for r in roles]]


def test_health_monitor_and_failover_equal_reference():
    ref, got = _failover_script(JAX), _failover_script(PORT)
    assert got == ref
    assert "active" in ref[2] and ref[2][-1] == "standby"


def _server(p, populate=True):
    fp = p.FastPathTables(sub_nbuckets=64, vlan_nbuckets=64, cid_nbuckets=64, max_pools=4)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    pools = p.PoolManager(fp)
    pools.add_pool(p.Pool(pool_id=1, network=ip_to_u32("10.0.0.0"), prefix_len=24,
                          gateway=SERVER_IP, dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    srv = p.DHCPServer(SERVER_MAC, SERVER_IP, pools, fastpath_tables=fp, clock=lambda: NOW)
    for i in range(4 if populate else 0):
        m = bytes([0x02, 0xDE, 0xAD, 0x00, 0x00, i])
        offer = srv.handle_frame(_dhcp(m, F.DISCOVER, 0x10 + i))
        od = F.decode(offer)
        srv.handle_frame(_dhcp(m, F.REQUEST, 0x20 + i, requested_ip=F.decode_dhcp(od.payload).yiaddr,
                               server_id=SERVER_IP))
    return srv


def _dhcp(m, msg_type, xid, **kw) -> bytes:
    p = F.build_request(m, msg_type, xid=xid, **kw)
    return F.udp_packet(m, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67, p.encode().ljust(320, b"\x00"))


def _active(p, n=5):
    a = p.ha.ActiveSyncer(p.ha.InMemorySessionStore())
    for i in range(n):
        a.push_change(_session(p.ha, i, nat_public_ip=ip_to_u32("203.0.113.1"),
                               nat_port_start=1024 * (i + 1), nat_port_end=1024 * (i + 2) - 1))
    a.push_change(None, session_id="s-0002")
    return a


@pytest.mark.parametrize("with_dhcp", [False, True], ids=["ha", "ha+dhcp"])
def test_ha_component_bytes_and_cross_restore(with_dhcp):
    blobs = []
    for p in PKGS:
        extra = {"dhcp": _server(p)} if with_dhcp else {}
        ck = p.ck.build_checkpoint(3, NOW, ha=_active(p), node_id="pair", **extra)
        blobs.append(p.ck.encode_checkpoint(ck))
    assert blobs[1] == blobs[0]
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        ck = dst.ck.decode_checkpoint(blobs[PKGS.index(src)])
        got = []
        for role in ("active", "standby"):
            live = (dst.ha.ActiveSyncer(dst.ha.InMemorySessionStore()) if role == "active"
                    else dst.ha.StandbySyncer(dst.ha.InMemorySessionStore(), transport=None))
            extra = {"dhcp": _server(dst, populate=False)} if with_dhcp else {}
            rows = dst.ck.restore_checkpoint(ck, ha=live, **extra)
            seq = live._seq if role == "active" else live.last_seq
            got.append((rows["ha.sessions"], seq, live.checkpoint_state()))
            if with_dhcp:
                assert rows["dhcp.leases"] == 4
                assert extra["dhcp"].export_leases() == _server(dst).export_leases()
        want = _active(JAX).checkpoint_state()
        assert got[0] == got[1] == (4, 6, want)
        # a standby that bootstrapped from the snapshot replays only the delta
        src_active = _active(dst)
        src_active.push_change(_session(dst.ha, 9))
        sb = dst.ha.StandbySyncer(dst.ha.InMemorySessionStore(), transport=lambda: src_active)
        dst.ck.restore_checkpoint(ck, ha=sb, **({"dhcp": _server(dst, populate=False)}
                                                if with_dhcp else {}))
        sb.tick(0.0)
        assert sb.connected and sb.stats["full_syncs"] == 0 and sb.stats["deltas"] == 1
        assert sb.checkpoint_state() == src_active.checkpoint_state()


def test_corrupt_ha_component_refused_before_any_change():
    msgs = []
    for p in PKGS:
        ck = p.ck.build_checkpoint(1, NOW, ha=_active(p))
        blob = p.ck.encode_checkpoint(ck)
        ck = p.ck.decode_checkpoint(blob)
        bad = {"seq": 4, "sessions": [{"session_id": "x", "ip": 1, "bogus_field_only": 1},
                                      {"mac": "no id"}]}
        ck.meta["components"]["ha"] = bad
        ck.arrays.pop("ha/__json__", None)
        ck.arrays.pop("ha/__payload_json__", None)
        live = p.ha.ActiveSyncer(p.ha.InMemorySessionStore())
        live.push_change(_session(p.ha, 1))
        before = live.checkpoint_state()
        with pytest.raises(p.ck.CheckpointError) as e:
            p.ck.restore_checkpoint(ck, ha=live)
        assert live.checkpoint_state() == before
        msgs.append(str(e.value).split(":")[0])
    assert msgs[0] == msgs[1] == "ha"


def _planted(p, case):
    ha = p.ha
    active = ha.ActiveSyncer(ha.InMemorySessionStore())
    standby = ha.StandbySyncer(ha.InMemorySessionStore(), transport=lambda: active)
    for i in range(4):
        active.push_change(_session(ha, i))
    standby.tick(0.0)
    for i in range(4, 6):
        active.push_change(_session(ha, i))
    if case == "standby_extra":
        standby.store.put(_session(ha, 40))
    elif case == "standby_missing":
        standby.store.delete("s-0004")
    elif case == "state_differs":
        standby.store.put(_session(ha, 1, t=NOW + 99))
    elif case == "disconnected_lags":
        standby.disconnect()
        active.push_change(_session(ha, 7))
        standby.store.delete("s-0000")
    elif case == "all_three":
        standby.store.put(_session(ha, 41))
        standby.store.delete("s-0003")
        standby.store.put(_session(ha, 5, t=NOW - 1))
    return active, standby


@pytest.mark.parametrize("case", ["clean", "standby_extra", "standby_missing", "state_differs",
                                  "disconnected_lags", "all_three"])
def test_audit_ha_pair_planted_violations(case):
    reps = []
    for p in PKGS:
        active, standby = _planted(p, case)
        reps.append(p.inv.audit_invariants(ha_pair=(active, standby),
                                           check_roundtrip=False).to_dict())
    assert reps[1] == reps[0]
    clean = case in ("clean", "disconnected_lags")
    assert reps[0]["ok"] == clean
    if not clean:
        assert set(reps[0]["violations_by_kind"]) == {"ha-store-divergence"}


@pytest.mark.parametrize("seed", [1, 5, 23])
def test_ha_delta_drop_reconnect_equals_reference(seed):
    ref = j_runner.canonical_json(j_sc.ha_delta_drop_reconnect(seed))
    got = t_runner.canonical_json(t_sc.ha_delta_drop_reconnect(seed))
    assert got == ref and '"ok": true' in got
    # the runner runs it now; its seed is the reference's
    assert "ha_delta_drop_reconnect" in t_runner.ALL_SCENARIOS
