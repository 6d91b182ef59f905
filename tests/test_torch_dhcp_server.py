"""The port's slow-path DHCP server against the JAX package's.

The same frames, at the same clock, go through `bng_tpu`'s `DHCPServer`
and the port's, each over its own `FastPathTables` and `PoolManager`:
DORA, renewal, NAK, rebinding, RELEASE, DECLINE, INFORM, an option-82
lease, a VLAN lease from an authenticator profile, an authenticator
reject, pool exhaustion (silent and counted), lease-time jitter and the
expiry sweep. Compared: every reply's bytes, the server stats, the hook
calls, `export_leases` (and a restore of it), and the host words of the
subscriber, circuit-ID and VLAN tables with their dirty sets. The codec's
`ReplyTemplate` and `ExpressWireTemplate` renders are held against the
reference's too.

Tolerance: bit-exact (the same bytes, counts and table words).
"""

import dataclasses

import numpy as np
import pytest

from bng_tpu.control import dhcp_codec as j_codec
from bng_tpu.control.dhcp_server import DHCPServer as JServer
from bng_tpu.control.pool import Pool as JPool
from bng_tpu.control.pool import PoolManager as JPools
from bng_tpu.runtime.tables import FastPathTables as JFastPath
from bng_tpu_torch import frames as F
from bng_tpu_torch.control import dhcp_codec as t_codec
from bng_tpu_torch.control.dhcp_server import DHCPServer as TServer
from bng_tpu_torch.control.pool import Pool as TPool
from bng_tpu_torch.control.pool import PoolManager as TPools
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPath
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

SERVER_MAC = bytes.fromhex("02aabbccdd01")
SERVER_IP = ip_to_u32("10.0.0.1")
NOW = 1_700_000_000
RELAY = ip_to_u32("10.9.9.9")


class FakeClock:
    def __init__(self, t=float(NOW)):
        self.t = t

    def __call__(self):
        return self.t


def mac(i: int) -> bytes:
    return (0x02B0 << 32 | i).to_bytes(6, "big")


REJECTED, VLAN_USER = mac(0x66), mac(0x77)  # the authenticator's two special clients


def dhcp_frame(m, msg_type, xid, vlans=None, giaddr=0, ciaddr=0, requested_ip=0, server_id=0,
               circuit_id=b"", broadcast=False, src_ip=0):
    p = t_codec.build_request(m, msg_type, xid=xid, requested_ip=requested_ip,
                              server_id=server_id, ciaddr=ciaddr, giaddr=giaddr,
                              broadcast=broadcast, circuit_id=circuit_id, remote_id=b"r" if
                              circuit_id else b"")
    p.options.append((t_codec.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(m, b"\xff" * 6, src_ip, 0xFFFFFFFF, 68, 67,
                        p.encode().ljust(320, b"\x00"), vlans=vlans)


def pools_for(mod_pool, small: bool):
    if small:  # a /29: 6 hosts, the gateway takes one, so 5 to lease
        return [mod_pool(pool_id=2, network=ip_to_u32("10.2.0.0"), prefix_len=29,
                         gateway=ip_to_u32("10.2.0.1"), lease_time=600)]
    return [mod_pool(pool_id=1, network=ip_to_u32("10.0.0.0"), prefix_len=24, gateway=SERVER_IP,
                     dns_primary=ip_to_u32("1.1.1.1"), dns_secondary=ip_to_u32("8.8.8.8"),
                     lease_time=3600),
            mod_pool(pool_id=3, network=ip_to_u32("10.3.0.0"), prefix_len=16,
                     gateway=ip_to_u32("10.3.0.1"), lease_time=7200, client_class=5)]


def build(side: str, small=False, jitter=0.0, auth=True):
    """One side's (server, fastpath tables, hook record, clock)."""
    fp_cls, pools_cls, pool_cls, srv_cls = (
        (JFastPath, JPools, JPool, JServer) if side == "jax" else
        (TFastPath, TPools, TPool, TServer))
    fp = fp_cls(sub_nbuckets=256, vlan_nbuckets=64, cid_nbuckets=64, max_pools=16)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    pm = pools_cls(fp)
    for p in pools_for(pool_cls, small):
        pm.add_pool(p)
    rec, clock = [], FakeClock()

    def authenticator(mac, circuit_id, remote_id):
        rec.append(("auth", mac, circuit_id, remote_id))
        if mac == REJECTED:
            return None
        if mac == VLAN_USER:
            return {"s_tag": 100, "c_tag": 7, "lease_time": 1200, "qos_policy": "gold",
                    "username": "vlan-user"}
        return {}

    srv = srv_cls(SERVER_MAC, SERVER_IP, pm, fastpath_tables=fp,
                  authenticator=authenticator if auth else None,
                  qos_hook=lambda ip, pol: rec.append(("qos", ip, pol)),
                  nat_hook=lambda ip, now: rec.append(("nat", ip, now)),
                  release_hook=lambda lease: rec.append(("release", lease.ip)),
                  accounting_hook=lambda ev, lease, sid: rec.append(("acct", ev, lease.ip, sid)),
                  clock=clock, lease_jitter_frac=jitter)
    return srv, fp, rec, clock


def table_words(fp):
    out = {}
    for name in ("sub", "vlan", "cid"):
        t = getattr(fp, name)
        out[name] = (t.keys.copy(), t.vals.copy(), t.used.copy(), sorted(t._dirty))
    out["pools"] = fp.pools.copy()
    return out


def assert_same(j, t):
    jsrv, jfp, jrec, _ = j
    tsrv, tfp, trec, _ = t
    assert dataclasses.asdict(tsrv.stats) == dataclasses.asdict(jsrv.stats)
    assert trec == jrec
    assert tsrv.export_leases() == jsrv.export_leases()
    assert tsrv.export_offers() == jsrv.export_offers()
    jw, tw = table_words(jfp), table_words(tfp)
    for name in jw:
        if name == "pools":
            assert np.array_equal(tw[name], jw[name])
            continue
        for a, b in zip(tw[name], jw[name]):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), name
            else:
                assert a == b, name


def drive(stacks, frames_at):
    """Each (time, frame) through both servers; returns the replies."""
    out = []
    for t, frame in frames_at:
        replies = []
        for srv, _, _, clock in stacks:
            clock.t = float(t)
            replies.append(srv.handle_frame(frame))
        assert replies[1] == replies[0]
        out.append(replies[1])
    return out


def test_dhcp_server_lifecycle_matches_reference():
    stacks = (build("jax"), build("port"))
    a, b, c, d = mac(1), mac(2), mac(3), mac(4)
    ip_a = ip_to_u32("10.0.0.2")  # the pool's first free address (the gateway is .1)
    script = [
        (NOW, dhcp_frame(a, 1, 0x10)),                                        # DISCOVER
        (NOW, dhcp_frame(a, 3, 0x10, requested_ip=ip_a, server_id=SERVER_IP)),  # REQUEST -> ACK
        (NOW + 5, dhcp_frame(a, 1, 0x11)),                                    # DISCOVER, leased
        (NOW + 100, dhcp_frame(a, 3, 0x12, ciaddr=ip_a, src_ip=ip_a)),       # renewal (unicast)
        (NOW + 101, dhcp_frame(b, 3, 0x20, requested_ip=ip_to_u32("192.0.2.9"))),  # NAK: no pool
        (NOW + 102, dhcp_frame(b, 3, 0x21)),                                  # NAK: nothing offered
        (NOW + 103, dhcp_frame(b, 3, 0x22, requested_ip=ip_to_u32("10.0.0.77"))),  # rebinding
        (NOW + 104, dhcp_frame(c, 1, 0x30, circuit_id=b"port-7/0/1", giaddr=RELAY)),  # opt82, relayed
        (NOW + 104, dhcp_frame(c, 3, 0x31, circuit_id=b"port-7/0/1", giaddr=RELAY)),
        (NOW + 105, dhcp_frame(c, 1, 0x32, circuit_id=b"port-7/0/1", giaddr=RELAY)),  # by circuit-ID
        (NOW + 106, dhcp_frame(VLAN_USER, 1, 0x40, vlans=[100, 7])),           # VLAN profile
        (NOW + 106, dhcp_frame(VLAN_USER, 3, 0x41, vlans=[100, 7])),
        (NOW + 107, dhcp_frame(REJECTED, 1, 0x50)),                            # rejected at REQUEST
        (NOW + 107, dhcp_frame(REJECTED, 3, 0x51)),
        (NOW + 108, dhcp_frame(d, 8, 0x60, ciaddr=ip_to_u32("10.0.0.200"))),    # INFORM
        (NOW + 108, dhcp_frame(d, 8, 0x61, broadcast=True)),                    # INFORM, no ciaddr
        (NOW + 109, dhcp_frame(b, 4, 0x62, requested_ip=ip_to_u32("10.0.0.77"))),  # DECLINE
        (NOW + 110, dhcp_frame(b, 1, 0x63)),                                  # re-DISCOVER after decline
        (NOW + 111, dhcp_frame(a, 7, 0x13, ciaddr=ip_a)),                      # RELEASE
        (NOW + 112, dhcp_frame(a, 1, 0x14)),                                  # DISCOVER: freed address
        (NOW + 113, b"\x00" * 40),                                            # garbage
        (NOW + 113, F.udp_packet(a, b"\xff" * 6, 0, 1, 68, 53, b"not dhcp")),  # other port
    ]
    replies = drive(stacks, script)
    assert_same(*stacks)

    def dec(r):
        return t_codec.decode(F.decode(r).payload)

    kinds = [None if r is None else dec(r).msg_type for r in replies]
    assert kinds == [2, 5, 2, 5, 6, 6, 5, 2, 5, 2, 2, 5, 2, 6, 5, 5, None, 2, None, 2, None, None]
    assert dec(replies[1]).yiaddr == ip_a and dec(replies[6]).yiaddr == ip_to_u32("10.0.0.77")
    assert F.decode(replies[7]).dst_ip == RELAY  # relayed: unicast to giaddr
    tsrv, tfp = stacks[1][0], stacks[1][1]
    assert tsrv.stats.auth_reject == 1 and tsrv.stats.decline == 1 and tsrv.stats.release == 1
    assert tfp.vlan.count == 1 and tfp.cid.count == 1  # the VLAN and option-82 leases' rows
    assert any(ev[0] == "acct" and ev[1] == "renew" for ev in stacks[1][2])

    # the expiry sweep (bounded, then the rest) and a restore of the lease book
    for max_reaps in (1, None):
        got = [srv.cleanup_expired(now=NOW + 10_000, max_reaps=max_reaps) for srv, *_ in stacks]
        assert got[0] == got[1] and got[1] >= 1
    assert_same(*stacks)
    state = stacks[0][0].export_leases()
    fresh = (build("jax"), build("port"))
    assert [s.restore_leases(state) for s, *_ in fresh] == [len(state["leases"])] * 2
    assert_same(*fresh)


def test_pool_exhaustion_silent_and_counted():
    stacks = (build("jax", small=True, auth=False), build("port", small=True, auth=False))
    replies = drive(stacks, [(NOW + i, dhcp_frame(mac(0x100 + i), 1, 0x900 + i))
                             for i in range(8)])
    assert [r is None for r in replies] == [False] * 5 + [True] * 3
    assert stacks[1][0].stats.pool_exhausted == 3 and stacks[1][0].stats.offer == 5
    assert_same(*stacks)


def test_lease_jitter_matches_reference():
    stacks = (build("jax", jitter=0.5, auth=False), build("port", jitter=0.5, auth=False))
    script = []
    for i in range(12):
        m = mac(0x200 + i)
        script += [(NOW, dhcp_frame(m, 1, 0xA00 + i)), (NOW, dhcp_frame(m, 3, 0xB00 + i))]
    replies = drive(stacks, script)
    lease_t = {t_codec.decode(F.decode(r).payload).opt(t_codec.OPT_LEASE_TIME)
               for r in replies[1::2]}
    assert len(lease_t) > 3  # per-MAC spread
    assert_same(*stacks)


@pytest.mark.parametrize("addressing", ["bcast", "unicast", "relayed", "qinq"])
def test_templates_render_like_reference(addressing):
    kw = {"bcast": {}, "unicast": {"ciaddr": ip_to_u32("10.0.0.5"), "src_ip": ip_to_u32("10.0.0.5")},
          "relayed": {"giaddr": RELAY}, "qinq": {"vlans": [200, 30]}}[addressing]
    frames = [dhcp_frame(mac(k), 1 + 2 * (k % 2), 0xC00 + k, **kw) for k in range(5)]
    vlan_off = 8 if addressing == "qinq" else 0
    dhcp_off = 14 + vlan_off + 28
    args = (SERVER_MAC, SERVER_IP, ip_to_u32("10.0.0.1"), ip_to_u32("1.1.1.1"), 0, 3600,
            0xFFFFFF00, t_codec.OFFER)
    jt, tt = j_codec.ExpressWireTemplate(*args), t_codec.ExpressWireTemplate(*args)
    relayed, bcast = addressing == "relayed", addressing in ("bcast", "qinq")
    ys = [ip_to_u32("10.0.0.40") + k for k in range(5)]
    got = [tt.render(f, vlan_off, dhcp_off, relayed, bcast, y) for f, y in zip(frames, ys)]
    assert got == [jt.render(f, vlan_off, dhcp_off, relayed, bcast, y) for f, y in zip(frames, ys)]
    cache = t_codec.ExpressTemplateCache(maxsize=2)
    assert cache.get(*args) is cache.get(*args)

    opts = [(t_codec.OPT_MSG_TYPE, b"\x05"), (t_codec.OPT_SERVER_ID, SERVER_IP.to_bytes(4, "big"))]
    r = dict(xid=0x1234, chaddr=mac(9), yiaddr=7, flags=0x8000, ciaddr=3, giaddr=RELAY, secs=2)
    assert (t_codec.ReplyTemplate(opts, siaddr=SERVER_IP).render(**r)
            == j_codec.ReplyTemplate(opts, siaddr=SERVER_IP).render(**r))
    req = t_codec.build_request(mac(3), t_codec.REQUEST, requested_ip=5, server_id=6,
                                circuit_id=b"cid", remote_id=b"rid", broadcast=True)
    jreq = j_codec.build_request(mac(3), j_codec.REQUEST, requested_ip=5, server_id=6,
                                 circuit_id=b"cid", remote_id=b"rid", broadcast=True)
    assert req.encode() == jreq.encode()
    assert t_codec.decode(req.encode()).option82() == (b"cid", b"rid")
