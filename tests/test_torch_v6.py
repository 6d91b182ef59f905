"""The port's DHCPv6 server, SLAAC server and slow-path demux against
`bng_tpu.control`, message for message.

- DHCPv6: both packages' `DHCPv6Server` (the same pools, one held clock)
  take the same message sequence; every reply's bytes, the lease books,
  both pools' allocations and the stats must match. Sequences: SOLICIT/
  ADVERTISE/REQUEST/REPLY with IA_NA and IA_PD, rapid commit, renew and
  rebind (known and unknown IAIDs, a rebind after state loss), release,
  decline, confirm on and off link, information-request, distinct
  delegated prefixes, pool exhaustion, another server's REQUEST, relayed
  and nested relayed SOLICITs with a hop-limit loop, and the expiry
  sweep. The codec (`DHCPv6Message`, IA_NA, DUID-LL, relay messages)
  encodes the same bytes in both.
- SLAAC: both `SLAACServer`s give the same RA bytes for an RS, for
  `build_ra_frame` and for periodic ticks, and the same EUI-64,
  link-local and stable-privacy addresses.
- The demux: both `SlowPathDemux`es route v4 DHCP, DHCPv6 (direct and
  relayed), RS, PPPoE and junk frames the same, with the same replies,
  pending PPPoE frames and stats.

Tolerance: exact (bytes, dicts).
"""

import dataclasses
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from bng_tpu.control import dhcp_server as j_dhcp, pool as j_pool, slaac as j_slaac
from bng_tpu.control import slowpath as j_slowpath
from bng_tpu.control.dhcpv6 import protocol as j_p6, server as j_v6
from bng_tpu.control.pppoe import auth as j_auth, server as j_pppoe
from bng_tpu_torch import frames as F
from bng_tpu_torch.control import dhcp_server as t_dhcp, pool as t_pool, slaac as t_slaac
from bng_tpu_torch.control import slowpath as t_slowpath
from bng_tpu_torch.control.dhcpv6 import protocol as t_p6, server as t_v6
from bng_tpu_torch.control.pppoe import auth as t_auth, server as t_pppoe
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

p6 = j_p6  # message constructors: the bytes are what both servers read
PKGS = (SimpleNamespace(name="jax", p6=j_p6, v6=j_v6, slaac=j_slaac, slowpath=j_slowpath,
                        dhcp=j_dhcp, pool=j_pool, auth=j_auth, pppoe=j_pppoe),
        SimpleNamespace(name="port", p6=t_p6, v6=t_v6, slaac=t_slaac, slowpath=t_slowpath,
                        dhcp=t_dhcp, pool=t_pool, auth=t_auth, pppoe=t_pppoe))
NOW = 1_753_000_000.0
CLIENT_MAC = b"\x02\xcc\x00\x00\x00\x42"
CLIENT_DUID = p6.generate_duid_ll(CLIENT_MAC).encode()
SERVER_MAC = b"\x02\xbb\x00\x00\x00\x01"
SERVER_DUID = p6.generate_duid_ll(SERVER_MAC).encode()


def _v6_server(p, clock, pool="2001:db8:100::/64", lifetimes=(3600, 7200), pd=True):
    cfg = p.v6.DHCPv6ServerConfig(
        dns_servers=[bytes.fromhex("20010db8000000000000000000000053")],
        domain_list=["isp.example"])
    return p.v6.DHCPv6Server(
        cfg, address_pool=p.v6.AddressPool6(pool, *lifetimes),
        prefix_pool=p.v6.PrefixPool6("2001:db8:f000::/40", delegated_len=56) if pd else None,
        clock=clock)


def _msg(mtype, xid, duid=CLIENT_DUID, server=True, na=(), pd=(), rapid=False):
    m = p6.DHCPv6Message(mtype, xid)
    if duid is not None:
        m.add(p6.OPT_CLIENTID, duid)
    if server:
        m.add(p6.OPT_SERVERID, SERVER_DUID)
    for ia in na:
        m.add_ia_na(ia if isinstance(ia, p6.IANA) else p6.IANA(ia))
    for ia in pd:
        m.add_ia_pd(p6.IAPD(ia))
    if rapid:
        m.add(p6.OPT_RAPID_COMMIT, b"")
    return m.encode()


def _addr(off):
    return (int.from_bytes(bytes.fromhex("20010db8010000000000000000000000"), "big")
            + off).to_bytes(16, "big")


def _with_addr(iaid, addr):
    ia = p6.IANA(iaid)
    ia.addresses.append(p6.IAAddress(addr, 100, 200))
    return ia


def _relay(inner, hops=0, iface=b"eth0.100"):
    return p6.RelayMessage(
        p6.RELAY_FORW, hops, bytes.fromhex("20010db8000000010000000000000001"),
        bytes.fromhex("fe80000000000000020000fffe000001"),
        options=([(p6.OPT_INTERFACE_ID, iface)] if iface else [])
        + [(p6.OPT_RELAY_MSG, inner)]).encode()


def _other_duid(i):
    return p6.generate_duid_ll(bytes([2, 0, 0, 0, 0, i])).encode()


def _nested_loop():
    wrapped = _msg(p6.SOLICIT, 1, server=False, na=[1])
    for _ in range(10):
        wrapped = _relay(wrapped, iface=None)
    return wrapped


# each: (server kwargs, [(seconds after NOW, raw message) ...], sweep at)
V6_CASES = {
    "solicit_request": ({}, [(0, _msg(p6.SOLICIT, 0x123456, server=False, na=[1], pd=[1])),
                             (1, _msg(p6.REQUEST, 0x654321, na=[1], pd=[1]))], None),
    "rapid_commit": ({}, [(0, _msg(p6.SOLICIT, 7, server=False, na=[1], rapid=True))], None),
    "renew_rebind": ({}, [(0, _msg(p6.SOLICIT, 1, server=False, na=[1], rapid=True)),
                          (5, _msg(p6.RENEW, 2, na=[1])), (6, _msg(p6.RENEW, 3, na=[99])),
                          (7, _msg(p6.REBIND, 4, server=False, na=[99]))], None),
    "rebind_after_state_loss": ({}, [(0, _msg(p6.REBIND, 2, server=False,
                                              na=[_with_addr(1, _addr(0x77))]))], None),
    "release": ({}, [(0, _msg(p6.SOLICIT, 1, server=False, na=[1], rapid=True)),
                     (3, _msg(p6.RELEASE, 5, na=[1])),
                     (4, _msg(p6.SOLICIT, 6, server=False, na=[2], rapid=True))], None),
    "decline": ({}, [(0, _msg(p6.SOLICIT, 1, server=False, na=[1], rapid=True)),
                     (3, _msg(p6.DECLINE, 6, na=[1])),
                     (4, _msg(p6.SOLICIT, 7, server=False, na=[2], rapid=True))], None),
    "confirm": ({}, [(0, _msg(p6.CONFIRM, 7, server=False, na=[_with_addr(1, _addr(5))])),
                     (0, _msg(p6.CONFIRM, 8, server=False, na=[_with_addr(
                         1, bytes.fromhex("20010db8deadbeef") + bytes(8))]))], None),
    "info_request": ({}, [(0, _msg(p6.INFORMATION_REQUEST, 9, duid=None, server=False))], None),
    "pd_distinct": ({}, [(i, _msg(p6.REQUEST, i, duid=_other_duid(i), pd=[1]))
                         for i in range(4)], None),
    "exhaustion": ({"pool": "2001:db8::/126", "pd": False},
                   [(i, _msg(p6.REQUEST, i, duid=_other_duid(i), na=[1])) for i in range(5)],
                   None),
    "other_server": ({}, [(0, _msg(p6.REQUEST, 1, na=[1]).replace(
        SERVER_DUID, p6.generate_duid_ll(b"\x02\xee\x00\x00\x00\x99").encode()))], None),
    "relay": ({}, [(0, _relay(_msg(p6.SOLICIT, 1, server=False, na=[1]))),
                   (1, _relay(_relay(_msg(p6.SOLICIT, 2, server=False, na=[1]), iface=b"inner"),
                              hops=1, iface=b"outer")),
                   (2, _nested_loop()), (3, bytes([p6.RELAY_FORW])), (4, _relay(b""))], None),
    "expiry_sweep": ({"lifetimes": (10, 20)},
                     [(0, _msg(p6.SOLICIT, 1, server=False, na=[1], pd=[1], rapid=True)),
                      (1, _msg(p6.SOLICIT, 2, duid=_other_duid(9), server=False, na=[3],
                               rapid=True))], 21),
    "truncated": ({}, [(0, b"\x01"), (0, b"\x01\x02"), (0, b"")], None),
}


def _book(srv):
    return (sorted((k, dataclasses.astuple(v)) for k, v in srv.leases.items()),
            sorted(srv.addr_pool._allocated.items()), sorted(srv.addr_pool._free),
            sorted(srv.prefix_pool._allocated.items()) if srv.prefix_pool else None,
            dataclasses.asdict(srv.stats))


@pytest.mark.parametrize("case", list(V6_CASES))
def test_dhcpv6_server_matches_reference(case):
    kw, msgs, sweep = V6_CASES[case]
    got = []
    for p in PKGS:
        t = [NOW]
        srv = _v6_server(p, lambda: t[0], **kw)
        assert srv.duid.encode() == SERVER_DUID
        replies = []
        for dt, raw in msgs:
            t[0] = NOW + dt
            replies.append(srv.handle_message(raw))
        swept = srv.cleanup_expired(NOW + sweep) if sweep is not None else None
        got.append((replies, swept, _book(srv)))
    assert got[1] == got[0]
    replies = got[1][0]
    assert any(r is not None for r in replies) or case in ("other_server", "truncated")


def test_dhcpv6_codec_matches_reference():
    ia = t_p6.IANA(7, 100, 200)
    ia.addresses.append(t_p6.IAAddress(b"\x20\x01" + b"\x00" * 14, 300, 400))
    j_ia = j_p6.IANA(7, 100, 200)
    j_ia.addresses.append(j_p6.IAAddress(b"\x20\x01" + b"\x00" * 14, 300, 400))
    assert ia.encode() == j_ia.encode()
    for raw in (_msg(p6.SOLICIT, 0x123456, na=[1], pd=[2], rapid=True),
                _relay(_msg(p6.SOLICIT, 1, server=False, na=[1]), hops=3)):
        cls = "RelayMessage" if raw[0] == p6.RELAY_FORW else "DHCPv6Message"
        back = getattr(t_p6, cls).decode(raw)
        assert back.encode() == raw == getattr(j_p6, cls).decode(raw).encode()
    assert t_p6.generate_duid_ll(CLIENT_MAC).encode() == CLIENT_DUID
    d = t_p6.DUID.decode(CLIENT_DUID)
    assert (d.duid_type, d.data) == (p6.DUID_LL, struct.pack(">H", 1) + CLIENT_MAC)


def _slaac(p, **kw):
    return p.slaac.SLAACServer(p.slaac.SLAACConfig(
        prefixes=[p.slaac.PrefixConfig(prefix=bytes.fromhex("20010db801000000") + bytes(8))],
        rdnss=[bytes.fromhex("20010db8000000000000000000000053")], dnssl=["isp.example"],
        mtu=1500, **kw))


def _rs(mac):
    ll = bytes.fromhex("fe80000000000000") + mac[:3] + b"\xff\xfe" + mac[3:]
    icmp = bytes([133, 0, 0, 0, 0, 0, 0, 0])
    ip6 = (bytes([0x60, 0, 0, 0]) + len(icmp).to_bytes(2, "big") + bytes([58, 255]) + ll
           + bytes.fromhex("ff020000000000000000000000000002"))
    return bytes.fromhex("333300000002") + mac + b"\x86\xdd" + ip6 + icmp


@pytest.mark.parametrize("flags", [{}, {"managed": True, "other_config": True}],
                         ids=["slaac", "managed"])
def test_slaac_matches_reference(flags):
    got = []
    for p in PKGS:
        srv = _slaac(p, **flags)
        out = [srv.build_ra(), srv.build_ra_frame(), srv.handle_frame(_rs(CLIENT_MAC)),
               srv.handle_frame(b"\x00" * 80), srv.handle_frame(b"short")]
        out += [srv.tick(t) for t in (100.0, 150.0, 301.0, 302.0, 700.0)]
        prefix = bytes.fromhex("20010db801000000") + bytes(8)
        out += [p.slaac.eui64_iid(CLIENT_MAC), p.slaac.eui64_address(prefix, CLIENT_MAC),
                p.slaac.link_local(CLIENT_MAC),
                p.slaac.stable_privacy_iid(prefix, CLIENT_MAC, b"secret")]
        got.append((out, dataclasses.asdict(srv.stats)))
    assert got[1] == got[0]
    assert got[1][0][2] is not None and got[1][1]["rs_received"] == 1


def _pppoe_padi(mac):
    return F.pppoe_padi_frame(mac, host_uniq=b"hu")


def _demux(p, clock):
    pools = p.pool.PoolManager(None)
    pools.add_pool(p.pool.Pool(pool_id=1, network=ip_to_u32("10.4.0.0"), prefix_len=24,
                               gateway=ip_to_u32("10.4.0.1"), lease_time=3600))
    v4 = p.dhcp.DHCPServer(SERVER_MAC, ip_to_u32("10.4.0.1"), pools, clock=clock)
    v6 = _v6_server(p, clock)
    ra = _slaac(p)
    pppoe = p.pppoe.PPPoEServer(
        p.pppoe.PPPoEServerConfig(server_mac=SERVER_MAC, cookie_secret=b"k" * 16),
        p.auth.LocalVerifier({"alice": b"secret123"}), lambda u, m: ip_to_u32("10.4.0.200"),
        magic_source=lambda: 0x01020304, challenge_source=lambda: b"C" * 16)
    return p.slowpath.SlowPathDemux(dhcp=v4, dhcpv6=v6, slaac=ra, pppoe=pppoe, clock=clock)


def _demux_corpus(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k, kind in enumerate(np.concatenate([rng.permutation(7), rng.integers(0, 7, 5)])):
        mac = bytes([2, 0xD4, 0, 0, seed, k])
        ll = bytes.fromhex("fe80000000000000") + mac[:3] + b"\xff\xfe" + mac[3:]
        duid = p6.generate_duid_ll(mac).encode()
        if kind == 0:
            out.append(F.discover_frame(mac, int(rng.integers(1 << 32)), pad=320))
        elif kind == 1:
            out.append(F.udp6_packet(mac, bytes.fromhex("333300010002"), ll,
                                     bytes.fromhex("ff020000000000000000000000010002"), 546, 547,
                                     _msg(p6.SOLICIT, k, duid=duid, server=False, na=[1],
                                          pd=[1], rapid=bool(k % 2))))
        elif kind == 2:
            out.append(F.udp6_packet(mac, SERVER_MAC, bytes.fromhex("20010db80000000900") +
                                     bytes(6) + b"\x00\xfe", bytes(15) + b"\x01", 547, 547,
                                     _relay(_msg(p6.SOLICIT, k, duid=duid, server=False,
                                                 na=[1]))))
        elif kind == 3:
            out.append(_rs(mac))
        elif kind == 4:
            out.append(_pppoe_padi(mac))
        elif kind == 5:
            out.append(F.pppoe_session_frame(SERVER_MAC, mac, 0x77, F.PROTO_LCP,
                                             b"\x09\x01\x00\x08\x00\x00\x00\x00"))
        else:
            out.append(bytes(rng.integers(0, 256, int(rng.integers(0, 70)), dtype=np.uint8)))
    out += [b"\x00" * 10, b"\x02" * 12 + b"\x12\x34" + b"x" * 40,
            b"\x02" * 12 + b"\x86\xdd" + bytes(40)]
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_slowpath_demux_matches_reference(seed):
    got = []
    for p in PKGS:
        t = [NOW]
        demux = _demux(p, lambda: t[0])
        replies = []
        for f in _demux_corpus(seed):
            t[0] += 1.0
            replies.append((demux(f), demux.drain_pending()))
        demux.requeue([b"a", b"b"])
        demux.requeue([b"z"], front=True)
        got.append((replies, demux.drain_pending(), dict(demux.stats),
                    dataclasses.asdict(demux.pppoe.stats), _book(demux.dhcpv6)))
    assert got[1] == got[0]
    st = got[1][2]
    assert got[1][1] == [b"z", b"a", b"b"] and st["unmatched"] >= 3
    assert min(st["dhcp4"], st["dhcp6"], st["slaac"], st["pppoe"]) >= 1
