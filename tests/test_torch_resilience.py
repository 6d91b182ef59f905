"""The port's partition tolerance (`bng_tpu_torch/control/resilience.py`),
the Nexus allocator wiring of `run` (`cli.py` step 4b and its hooks) and
the fleet's Nexus mode, against the JAX package's.

- The reference's own cases of `tests/test_ha_resilience.py::TestResilience`
  and `test_radius_only_outage_activates_degraded_auth` run on the port
  (rebound by `test_torch_deviceauth.port_twin`).
- The FSM across packages: seeded health sequences for the Nexus and
  RADIUS probes, seeded partition-time allocations and a central view:
  the same state sequence, events, conflicts and renumber calls.
- `run` with `--nexus-url` (and PSK device auth) on a reference app and a
  port app (`device="cpu"`) at one held clock, against a loopback
  `ClusterServer` Nexus: Nexus-first DORAs, the Nexus closed (the FSM
  partitions after its threshold ticks), DORAs from the local pool, then a
  heal where the Nexus claims 3 of those addresses for another subscriber
  at an earlier time. Both give the same OFFER yiaddrs, state sequence,
  `conflicts_found`/`renumbered`, leases, `stats()["resilience"]` and
  every host fast-path table word; the port's device tables after the
  drain equal the reference's tables uploaded from its host mirror; the
  losers' next DISCOVERs get the same Nexus answer.
- Degraded auth through `run`'s authenticator on both apps: a subscriber
  accepted before is served from the cached profile when every RADIUS
  server times out; a REJECT is never served from the cache; a new
  subscriber gets no lease.
- The fleet's Nexus mode (inline): workers allocate through the Nexus
  under `<node>-w<i>`, and with nothing listening fall back to the local
  slice; with two workers an answer outside the answering worker's lease
  slice is not taken (the reference's result) — the same replies, leases
  and central records in both packages.

Tolerance: exact.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

import test_ha_resilience as ref_ha
from test_radius import SECRET, FakeRadiusServer
from test_torch_deviceauth import run_on_port

from bng_tpu import cli as j_cli
from bng_tpu.chaos import faults as j_faults
from bng_tpu.chaos import scenarios as j_sc
from bng_tpu.control import cluster_http as j_ch
from bng_tpu.control import fleet as j_fleet
from bng_tpu.control import resilience as j_res
from bng_tpu.control.radius import packet as rp
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import faults as t_faults
from bng_tpu_torch.chaos import scenarios as t_sc
from bng_tpu_torch.control import cluster_http as t_ch
from bng_tpu_torch.control import dhcp_codec as t_codec
from bng_tpu_torch.control import fleet as t_fleet
from bng_tpu_torch.control import resilience as t_res
from bng_tpu_torch.runtime import engine as t_engine
from bng_tpu_torch.utils.net import ip_to_u32, u32_to_ip

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(name="jax", cli=j_cli, ch=j_ch, res=j_res, fleet=j_fleet, sc=j_sc,
                      faults=j_faults, kw={})
PORT = SimpleNamespace(name="port", cli=t_cli, ch=t_ch, res=t_res, fleet=t_fleet, sc=t_sc,
                       faults=t_faults, kw={"device": "cpu"})
PKGS = (JAX, PORT)
SERVER_IP = ip_to_u32("10.0.0.1")


# ---- the reference's FSM cases on the port ------------------------------

FSM_CASES = [f"TestResilience::{m}" for m in vars(ref_ha.TestResilience) if m.startswith("test_")]
FSM_CASES.append("test_radius_only_outage_activates_degraded_auth")


@pytest.mark.parametrize("case", FSM_CASES)
def test_reference_fsm_case_holds_on_the_port(case, request):
    run_on_port(ref_ha, case, request)


@pytest.mark.parametrize("seed", [3, 17])
def test_fsm_trace_matches_reference(seed):
    """Seeded probe outcomes, allocations and central claims: the same
    transitions, events, renumber calls and degraded-auth flags."""
    got = []
    for p in PKGS:
        rng = np.random.default_rng(seed)
        nexus_ok = rng.random(64) < 0.55
        radius_ok = rng.random(64) < 0.6
        claims = {int(ip): (f"remote-{i}", float(t)) for i, (ip, t) in enumerate(
            zip(rng.integers(0, 32, 12), rng.integers(0, 200, 12)))}
        i = [0]
        states, renum, sent = [], [], []
        m = p.res.ResilienceManager(
            nexus_healthy=lambda: bool(nexus_ok[i[0]]),
            radius_healthy=lambda: bool(radius_ok[i[0]]),
            check_interval_s=1.0, failure_threshold=3, central_lookup=claims.get,
            renumber=lambda sub: renum.append(sub) or len(sub) % 2 == 0,
            on_state_change=lambda s: states.append(s.value), probe_clock=lambda: 0.0)
        m.radius_handler.cache_profile(p.res.CachedProfile("alice", "gold", cached_at=0.0))
        trace = []
        for k in range(64):
            i[0] = k
            for j in rng.integers(0, 32, 2):
                m.record_allocation(f"sub-{k}-{int(j)}", int(j), at=float(k * 5))
            if k % 7 == 0:
                m.radius_handler.buffer_accounting({"k": k})
            st = m.tick(float(k + 1), acct_send=lambda r: sent.append(r) or True)
            trace.append((st.value, m.degraded_auth_active, m.radius_down, m.conflicts.count))
        got.append((trace, states, renum, sent, vars(m.events),
                    [(c.ip, c.winner, c.loser) for c in m._last_conflicts]))
    assert got[1] == got[0]
    assert "partitioned" in got[0][1] and got[0][4]["conflicts_found"] > 0


# ---- run --nexus-url on both apps ----------------------------------------

class Backend:
    """A loopback Nexus: sequential addresses in 10.77.0.0/16 and a
    heal-time central view by IP."""

    def __init__(self):
        self.ips, self.by_ip, self.next = {}, {}, 10

    def allocate(self, subscriber_id, pool_hint):
        if subscriber_id not in self.ips:
            self.ips[subscriber_id] = f"10.77.{self.next >> 8}.{self.next & 0xFF}"
            self.next += 1
        return self.ips[subscriber_id]

    def lookup(self, sid):
        return self.ips.get(sid)

    def lookup_by_ip(self, ip):
        return self.by_ip.get(ip)

    def release(self, sid):
        return self.ips.pop(sid, None) is not None

    def pool_info(self):
        return {"pools": []}


class Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _frame(mac, msg_type, **kw):
    p = F.build_request(mac, msg_type, **kw)
    return F.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67, p.encode().ljust(320, b"\x00"))


def _dora(dhcp, mac):
    """(OFFER yiaddr or None, the ACK/NAK bytes or None)."""
    offer = dhcp.handle_frame(_frame(mac, F.DISCOVER))
    if offer is None:
        return None, None
    yiaddr = F.decode_dhcp(F.decode(offer).payload).yiaddr
    return yiaddr, dhcp.handle_frame(_frame(mac, F.REQUEST, requested_ip=yiaddr,
                                            server_id=SERVER_IP))


def _macs(seed, n):
    rng = np.random.default_rng(seed)
    return [b"\x02" + rng.bytes(5) for _ in range(n)]


def _host_words(fp):
    out = {}
    for name in ("sub", "vlan", "cid"):
        t = getattr(fp, name)
        out[name] = [t.keys.tolist(), t.vals.tolist(), t.used.tolist()]
    out["pools"] = fp.pools.tolist()
    return out


def _nexus_drive(p):
    clock = Clock(5_000_000.0)
    backend = Backend()
    srv = p.ch.ClusterServer().mount_allocator(backend).start()
    app = p.cli.BNGApp(p.cli.BNGConfig(
        nexus_url=srv.url, pool_cidr="10.77.0.0/16", device_auth_method="psk",
        device_auth_psk="0123456789abcdef-psk", metrics_enabled=False, dhcpv6_enabled=False,
        slaac_enabled=False, walled_garden_enabled=False, nat_enabled=False,
        qos_enabled=False), clock=clock, **p.kw)
    srv2 = None
    try:
        c = app.components
        dhcp, res = c["dhcp"], c["resilience"]
        out = {"deviceauth": (type(c["deviceauth"]).__name__, c["deviceauth"].mode.value)}
        first = [_dora(dhcp, m) for m in _macs(1, 6)]
        out["nexus_yiaddrs"] = [u32_to_ip(y) for y, _ in first]
        out["backend"] = dict(backend.ips)
        out["acks"] = [a for _, a in first]
        srv.close()
        states = []
        for _ in range(4):
            clock.t += 6.0
            app.tick()
            states.append(res.state.value)
        part = [_dora(dhcp, m) for m in _macs(2, 8)]
        out["partition_yiaddrs"] = [y for y, _ in part]
        out["partition_acks"] = [a for _, a in part]
        out["recorded"] = res.conflicts.count
        losers = _macs(2, 8)[1:7:2]
        for i, m in enumerate(losers):
            ip = u32_to_ip(dict(zip(_macs(2, 8), out["partition_yiaddrs"]))[m])
            backend.by_ip[ip] = (f"other-node-sub-{i}", clock.t - 9999.0)
        srv2 = p.ch.ClusterServer(srv.host, srv.port).mount_allocator(backend).start()
        for _ in range(4):
            clock.t += 6.0
            app.tick()
            states.append(res.state.value)
        out["states"] = states
        out["events"] = dict(vars(res.events))
        out["stats"] = app.stats()["resilience"]
        out["leases"] = dhcp.export_leases()
        out["host_words"] = _host_words(c["fastpath"])
        eng = c["engine"]
        if p is PORT:
            upd = eng._drain_fastpath_updates()
            t_engine.apply_fastpath_updates(eng.tables.dhcp, upd)
            dev = convert.tables_to_numpy(eng.tables.dhcp)
        else:
            dev = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                         eng._device_tables().dhcp)
        out["rediscover"] = [_dora(dhcp, m)[0] for m in losers]
        return out, dev, [m.hex() for m in losers]
    finally:
        app.close()
        srv.close()
        if srv2 is not None:
            srv2.close()


def _assert_words_equal(got, ref, what):
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if r is None:
            continue
        if hasattr(r, "_fields"):
            _assert_words_equal(g, r, f"{what}.{f}")
        else:
            assert np.array_equal(np.asarray(g).view(np.uint32),
                                  np.asarray(r).view(np.uint32)), f"{what}.{f}"


def test_run_nexus_partition_heal_matches_reference():
    (ref, ref_dev, losers), (got, got_dev, _) = (_nexus_drive(p) for p in PKGS)
    assert got == ref
    _assert_words_equal(got_dev, ref_dev, "dhcp")
    # the reference test's expectations, on the port's results
    assert got["nexus_yiaddrs"] == [got["backend"][m.hex()] for m in _macs(1, 6)]
    assert all(a is not None for a in got["acks"] + got["partition_acks"])
    assert got["states"][:3] == ["normal", "normal", "partitioned"]
    assert got["states"][-1] == "normal" and got["recorded"] == 8
    assert got["events"]["conflicts_found"] == 3 and got["events"]["renumbered"] == 3
    assert got["stats"] == {"state": "normal", "degraded_auth": False}
    live = {lease["mac"] for lease in got["leases"]["leases"]}
    assert not set(losers) & live and len(live) == 6 + 8 - 3
    assert all(ip.startswith("10.77.") for ip in map(u32_to_ip, got["rediscover"]))


def _auth_drive(p):
    clock = Clock(6_000_000.0)
    srv = p.ch.ClusterServer().mount_allocator(Backend()).start()
    app = p.cli.BNGApp(p.cli.BNGConfig(
        nexus_url=srv.url, lease_time=300, radius_server="10.0.0.5:1812", radius_secret=SECRET.decode(),
        metrics_enabled=False, dhcpv6_enabled=False, slaac_enabled=False,
        walled_garden_enabled=False, nat_enabled=False), clock=clock, **p.kw)
    try:
        radius, dhcp = app.components["radius"], app.components["dhcp"]
        cache = app.components["resilience"].radius_handler
        accept = FakeRadiusServer(users={"": {"password": "", "attrs": [(rp.FILTER_ID, "gold")]}})
        a, b, new = _macs(5, 3)
        radius.transport = accept
        out = [_dora(dhcp, a), _dora(dhcp, b)]  # both accepted, both cached
        clock.t += 400.0
        app.tick()
        out.append(sorted(dhcp.leases))
        radius.transport = FakeRadiusServer(users={})  # a real REJECT for b
        out.append(_dora(dhcp, b))
        radius.transport = lambda *a: None  # every server times out
        out += [_dora(dhcp, a), _dora(dhcp, new)]
        out.append(dict(cache.stats))
        out.append({k: (v.qos_policy, v.ip) for k, v in dhcp.leases.items()})
        return out
    finally:
        app.close()
        srv.close()


def test_run_degraded_auth_serves_cached_profile_matches_reference():
    ref, got = (_auth_drive(p) for p in PKGS)
    assert got == ref
    assert got[0][1] is not None and got[2] == []
    nak = got[3][1]
    assert nak is None or F.decode_dhcp(F.decode(nak).payload).msg_type == t_codec.NAK
    cached = got[4][1]
    assert cached is not None and F.decode_dhcp(F.decode(cached).payload).msg_type == F.ACK
    assert got[5][1] is None or F.decode_dhcp(F.decode(got[5][1]).payload).msg_type == t_codec.NAK
    assert got[6]["cache_hits"] == 1
    assert [pol for pol, _ip in got[7].values()] == ["gold"]


# ---- the fleet's Nexus mode (inline) -------------------------------------

def _fleet_drive(p, url_of, workers=1, n=4):
    clock = p.faults.SimClock(1000.0)
    backend = Backend()
    srv = p.ch.ClusterServer().mount_allocator(backend).start()
    fastpath = p.sc._make_fastpath()
    pools = p.sc._make_pools(fastpath, cidr_net="10.77.0.0", prefix_len=16)
    spec = p.fleet.FleetSpec.from_pool_manager(p.sc.SERVER_MAC, p.sc.SERVER_IP, pools,
                                               nexus_url=url_of(srv), nexus_node_id="mb-test")
    fleet = p.fleet.SlowPathFleet(spec, workers, pools, mode="inline", table_sink=fastpath,
                                  clock=clock)
    try:
        macs = [p.sc._mac(0x5100 + i) for i in range(n)]
        leased = p.sc.dora_with_retries(fleet, macs, clock)
        w = [(x.nexus.node_id, x.nexus_resilience.state.value) for x in fleet._inline]
        return ({m.hex(): u32_to_ip(ip) for m, ip in leased.items()}, dict(backend.ips), w,
                fleet.export_state())
    finally:
        fleet.close()
        srv.close()


@pytest.mark.parametrize("nexus", ["up", "down"])
def test_fleet_workers_allocate_through_nexus_match_reference(nexus):
    url_of = (lambda s: s.url) if nexus == "up" else (lambda s: "http://127.0.0.1:9")
    ref, got = (_fleet_drive(p, url_of) for p in PKGS)
    assert got == ref
    leased, central, workers, _state = got
    assert len(leased) == 4 and workers == [("mb-test-w0", "normal")]
    if nexus == "up":
        assert central and leased == central  # every address is the Nexus's answer
    else:
        assert not central and all(ip.startswith("10.77.") for ip in leased.values())


def test_fleet_nexus_answer_outside_the_workers_slice_keeps_the_references_result():
    """With several workers, a Nexus answer outside the answering worker's
    lease slice is not taken: the worker leases from its slice and the
    Nexus keeps its record for the subscriber (the reference's result,
    ROADMAP Queue 3). The same leases and central records in both."""
    ref, got = (_fleet_drive(p, lambda s: s.url, workers=2, n=8) for p in PKGS)
    assert got == ref
    leased, central, workers, _state = got
    assert [n for n, _s in workers] == ["mb-test-w0", "mb-test-w1"] and len(leased) == 8
    taken = sum(central[m] == ip for m, ip in leased.items())
    assert set(central) == set(leased) and 0 < taken < len(leased)
