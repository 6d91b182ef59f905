"""The port's cluster wire (`bng_tpu_torch/control/cluster_http.py`) against
the JAX package's, over real loopback sockets.

- HA over HTTP, across the packages both ways (and port to port): a
  standby full-syncs from an active's listener, follows the SSE deltas
  (puts and a delete), heals a dropped stream by `replay_since` with no
  second full sync, and full-resyncs after a replay-buffer gap; its store
  ends equal to the active's, and the pair audits clean.
- The replicated store: a `DistributedStore` of one package syncs with a
  listener of the other (`HTTPStorePeer`): one anti-entropy round makes
  both digests equal, a tombstone and binary values included; an
  unreachable peer is skipped.
- The peer pool mounted on a listener: an allocation the other package's
  node does not own is forwarded over HTTP to the owner and read back;
  the release goes over the wire too.
- `run` as a pair: port `BNGApp`s with `--ha-role active --cluster-listen
  127.0.0.1:0` and `--ha-role standby --ha-peer http://...` (and a
  reference active with a port standby) on `--device cpu`: leases DORAed
  on the active reach the standby, whose store ends equal; a store pair in
  `--store-mode write`, each the other's `--store-peers`, converges after
  one sync tick; BGP builds its controller.

Every wait on a socket or stream has its own deadline (`wait_until`).

Tolerance: exact (session dicts, digests, addresses).
"""

import socket
import time
from types import SimpleNamespace

import pytest

from bng_tpu import cli as j_cli
from bng_tpu.control import cluster_http as j_http
from bng_tpu.control import crdt as j_crdt
from bng_tpu.control import ha as j_ha
from bng_tpu.control import peerpool as j_pp
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import invariants as t_inv
from bng_tpu_torch.control import cluster_http as t_http
from bng_tpu_torch.control import crdt as t_crdt
from bng_tpu_torch.control import ha as t_ha
from bng_tpu_torch.control import peerpool as t_pp
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(name="jax", http=j_http, ha=j_ha, crdt=j_crdt, pp=j_pp, cli=j_cli, kw={})
PORT = SimpleNamespace(name="port", http=t_http, ha=t_ha, crdt=t_crdt, pp=t_pp, cli=t_cli,
                       kw={"device": "cpu"})
PAIRS = [(JAX, PORT), (PORT, JAX), (PORT, PORT)]
PAIR_IDS = ["jax-active/port-standby", "port-active/jax-standby", "port-active/port-standby"]
NOW = 1_753_000_000.0


def wait_until(pred, timeout=15.0, step=0.02):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return False


@pytest.fixture
def servers():
    live = []
    yield live
    for s in live:
        s.close()


def _session(ha, i, t=NOW):
    return ha.SessionState(f"s-{i:03d}", mac=f"02:00:00:00:01:{i:02x}",
                           ip=ip_to_u32("10.7.0.1") + i, pool_id=1, lease_expiry=t + 600,
                           updated_at=t)


def _dicts(store):
    return sorted((s.session_id, sorted(s.to_dict().items())) for s in store.all())


@pytest.mark.parametrize("act_p,sb_p", PAIRS, ids=PAIR_IDS)
def test_standby_syncs_from_active_over_loopback(act_p, sb_p, servers):
    active = act_p.ha.ActiveSyncer(act_p.ha.InMemorySessionStore(), replay_buffer=8)
    srv = act_p.http.ClusterServer().mount_ha(active).start()
    servers.append(srv)
    for i in range(3):
        active.push_change(_session(act_p.ha, i))
    store = sb_p.ha.InMemorySessionStore()
    standby = sb_p.ha.StandbySyncer(store, transport=lambda: sb_p.http.HTTPActiveProxy(
        srv.url, on_stream_end=lambda: standby.disconnect()))
    standby.tick(0.0)
    assert standby.connected and len(store) == 3 and standby.stats["full_syncs"] == 1
    # live SSE deltas: puts and a delete
    active.push_change(_session(act_p.ha, 3))
    active.push_change(None, session_id="s-001")
    assert wait_until(lambda: standby.last_seq == active._seq)
    assert _dicts(store) == _dicts(active.store)
    # the stream drops: the standby heals by replay_since, no full sync
    standby.disconnect()
    active.push_change(_session(act_p.ha, 4))
    active.push_change(_session(act_p.ha, 0, t=NOW + 30))
    standby.tick(1.0)
    assert standby.connected and standby.stats["full_syncs"] == 1
    assert wait_until(lambda: standby.last_seq == active._seq)
    assert _dicts(store) == _dicts(active.store)
    rep = t_inv.audit_invariants(ha_pair=(active, standby), check_roundtrip=False)
    assert rep.ok and rep.checks["ha_sessions"] == 4
    # a gap past the replay buffer: a full resync
    standby.disconnect()
    for i in range(10, 30):
        active.push_change(_session(act_p.ha, i))
    standby.tick(2.0)
    assert wait_until(lambda: standby.last_seq == active._seq)
    assert standby.stats["full_syncs"] == 2 and _dicts(store) == _dicts(active.store)
    # the active goes away: the stream ends, the sessions stay
    srv.close()
    assert wait_until(lambda: not standby.connected)
    standby.tick(100.0)
    assert not standby.connected and len(store) == len(active.store)


@pytest.mark.parametrize("a_p,b_p", PAIRS, ids=["jax-listens", "port-listens", "port-port"])
def test_store_peers_converge_over_loopback(a_p, b_p, servers):
    clk = {"t": NOW}
    a = b_p.crdt.DistributedStore("a", mode=b_p.crdt.MODE_WRITE, clock=lambda: clk["t"])
    b = a_p.crdt.DistributedStore("b", mode=a_p.crdt.MODE_WRITE, clock=lambda: clk["t"])
    srv_b = a_p.http.ClusterServer().mount_store(b).start()
    servers.append(srv_b)
    a.add_peer(b_p.http.HTTPStorePeer(srv_b.url))
    a.add_peer(b_p.http.HTTPStorePeer("http://127.0.0.1:1"))  # nothing listens
    a.put("sub/1", b"ip=10.0.0.1")
    clk["t"] += 0.25
    b.put("sub/2", b"ip=10.0.0.2")
    b.delete("sub/2")
    b.put("sub/3", b"\x00\x01\xff")
    a.tick()  # one round over HTTP, both directions
    assert a.get("sub/3") == b"\x00\x01\xff" and a.get("sub/2") is None
    assert b.get("sub/1") == b"ip=10.0.0.1"
    assert a.store.digest() == b.store.digest()


@pytest.mark.parametrize("a_p,b_p", PAIRS, ids=["jax-owner", "port-owner", "port-port"])
def test_peer_pool_forwards_over_loopback(a_p, b_p, servers):
    nodes = ["n1", "n2"]
    urls = {}
    rng1 = b_p.pp.PoolRange(network=0x0A640000, size=1000)
    rng2 = a_p.pp.PoolRange(network=0x0A640000, size=1000)
    p1 = b_p.pp.PeerPool("n1", nodes, rng1,
                         transport=lambda node: b_p.http.HTTPPeerProxy(urls[node]))
    p2 = a_p.pp.PeerPool("n2", nodes, rng2,
                         transport=lambda node: a_p.http.HTTPPeerProxy(urls[node]))
    for n, pool, pk in (("n1", p1, b_p), ("n2", p2, a_p)):
        srv = pk.http.ClusterServer().mount_pool(pool).start()
        servers.append(srv)
        urls[n] = srv.url
    sub = next(s for s in (f"sub{i}" for i in range(100)) if p1.owner_ranked(s)[0] == "n2")
    ip = p1.allocate(sub)
    assert p1.stats["forwarded"] == 1 and p2.stats["local_allocs"] == 1
    assert p2.by_subscriber[sub] == ip and p1.get(sub) == ip
    # the address is the one the owner would have picked alone
    ref = j_pp.PeerPool("n2", ["n2"], j_pp.PoolRange(network=0x0A640000, size=1000))
    assert ref.allocate(sub) == ip
    assert p1.release(sub) and sub not in p2.by_subscriber


def _dora(dhcp, n, base=0):
    for i in range(base, base + n):
        m = (0x02CC00000000 | i).to_bytes(6, "big")
        offer = dhcp.handle_frame(_frame(m, F.DISCOVER, 0x100 + i))
        od = F.decode(offer)
        ack = dhcp.handle_frame(_frame(m, F.REQUEST, 0x200 + i,
                                       requested_ip=F.decode_dhcp(od.payload).yiaddr,
                                       server_id=od.src_ip))
        assert ack is not None


def _frame(m, msg_type, xid, **kw):
    p = F.build_request(m, msg_type, xid=xid, **kw)
    return F.udp_packet(m, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67, p.encode().ljust(320, b"\x00"))


BASE = dict(dhcpv6_enabled=False, slaac_enabled=False, metrics_enabled=False,
            coa_enabled=False, walled_garden_enabled=False, batch_size=16)


@pytest.mark.parametrize("act_p", [JAX, PORT], ids=["jax-active", "port-active"])
def test_run_pair_stores_end_equal(act_p):
    clock = lambda: NOW  # noqa: E731
    act = act_p.cli.BNGApp(act_p.cli.BNGConfig(
        ha_role="active", cluster_listen="127.0.0.1:0", node_id="bng-a", **BASE),
        clock=clock, **act_p.kw)
    try:
        url = act.components["cluster_server"].url
        _dora(act.components["dhcp"], 6)  # before the standby joins
        sb = t_cli.BNGApp(t_cli.BNGConfig(ha_role="standby", ha_peer=url, node_id="bng-b",
                                          **BASE), clock=clock, device="cpu")
        try:
            sb.tick(NOW)
            ha_a, ha_b = act.components["ha"], sb.components["ha"]
            assert ha_b.connected and sb.components["ha_role"].value == "standby"
            _dora(act.components["dhcp"], 6, base=6)  # live deltas
            assert wait_until(lambda: ha_b.last_seq == ha_a._seq)
            assert len(ha_b.store) == 12
            assert _dicts(ha_b.store) == _dicts(ha_a.store)
            assert t_inv.audit_invariants(ha_pair=(ha_a, ha_b), check_roundtrip=False).ok
            # the port's active feeds the same session rows as the reference's
            nat = {s.session_id: s.nat_public_ip for s in ha_a.store.all()}
            assert all(nat.values()) and len(nat) == 12
        finally:
            sb.close()
    finally:
        act.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_store_pair_converges_and_bgp_builds():
    ports = [_free_port(), _free_port()]
    apps = []
    try:
        for me, other in ((0, 1), (1, 0)):
            apps.append(t_cli.BNGApp(t_cli.BNGConfig(
                node_id=f"bng-{me}", store_mode="write",
                store_peers=[f"http://127.0.0.1:{ports[other]}"],
                cluster_listen=f"127.0.0.1:{ports[me]}", bgp_enabled=True,
                bgp_router_id="10.255.0.1", **BASE), device="cpu"))
        s0, s1 = (a.components["cluster_store"] for a in apps)
        s0.put("sub/02cc00000001", b"10.0.0.7")
        s1.put("sub/02cc00000002", b"10.0.0.8")
        s1.delete("sub/02cc00000002")
        apps[0].tick(NOW + 10)  # one anti-entropy round over the wire
        assert s0.store.digest() == s1.store.digest()
        assert s1.get("sub/02cc00000001") == b"10.0.0.7"
        assert s0.get("sub/02cc00000002") is None
        assert sorted(s0.members()) == ["bng-0", "bng-1"]
        assert type(apps[0].components["bgp"]).__name__ == "BGPController"
        assert apps[0].components["cluster_server"].url == f"http://127.0.0.1:{ports[0]}"
    finally:
        for a in apps:
            a.close()
