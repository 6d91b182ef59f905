"""The port's PPPoE ops against `bng_tpu.ops.pppoe`, bit for bit, on a
seeded frame corpus: `pppoe_decap`, `pppoe_encap`, `qinq_push` and
`qinq_pop`. The corpus covers 0, 4 and 8 bytes of VLAN tags, session
IPv4 data (with Ethernet padding past the declared length), discovery,
LCP, IPCP and IPv6 PPP, a malformed length, a bad ver/type, a non-zero
code, a truncated header, an unknown session, a MAC mismatch, plain
IPv4, and encap and QinQ push at L-8 and L-7 bytes. Both packages'
session tables are built by the same host calls. Tolerance: bit-exact.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bng_tpu.ops import pppoe as jp
from bng_tpu.ops.parse import eth_vlan as j_eth_vlan, parse_batch as j_parse
from bng_tpu.runtime.tables import PPPoEFastPathTables as JPPPoE
from bng_tpu_torch import frames as F
from bng_tpu_torch.ops import pppoe as tp
from bng_tpu_torch.ops.parse import eth_vlan as t_eth_vlan, parse_batch as t_parse
from bng_tpu_torch.runtime.tables import PPPoEFastPathTables as TPPPoE
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_stages import assert_tuple_equal
from test_torch_words import bits

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
L = 256
AC_MAC = bytes.fromhex("02aabbccdd01")
REMOTE = ip_to_u32("93.184.216.34")
SESSIONS = [(0x10 + k, bytes([0x02, 0xC0, 0xFF, 0xEE, 0x00, k]), ip_to_u32(f"10.0.0.{70 + k}"))
            for k in range(6)]

_decap = jax.jit(jp.pppoe_decap, static_argnums=(5,))
_encap = jax.jit(jp.pppoe_encap, static_argnums=(6,))
_push = jax.jit(jp.qinq_push)
_pop = jax.jit(jp.qinq_pop)


def _tables(cls):
    t = cls(nbuckets=64, stash=8, update_slots=16, server_mac=AC_MAC)
    for sid, mac, ip in SESSIONS:
        t.session_up(SimpleNamespace(session_id=sid, client_mac=mac, assigned_ip=ip))
    t.session_up(SimpleNamespace(session_id=0x30, client_mac=bytes(6), assigned_ip=0))
    return t


@pytest.fixture(scope="module")
def tables():
    j, t = _tables(JPPPoE), _tables(TPPPoE)
    jt = SimpleNamespace(sid=jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)),
                                                    j.by_sid.device_state()),
                         ip=jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)),
                                                   j.by_ip.device_state()),
                         mac=jnp.asarray(j.server_mac), geom=j.geom)
    tt = SimpleNamespace(sid=t.by_sid.device_state(CPU), ip=t.by_ip.device_state(CPU),
                         mac=torch.from_numpy(t.server_mac.view(np.int32)), geom=t.geom)
    return jt, tt


def _vlans(rng):
    return [None, [int(rng.integers(1, 4095))], [int(rng.integers(1, 4095)),
                                                  int(rng.integers(1, 4095))]][rng.integers(3)]


def _ip_udp(rng, src, dst, n):
    return F.udp_packet(b"\x00" * 6, b"\x00" * 6, src, dst, int(rng.integers(1024, 65535)),
                        53, bytes(rng.integers(0, 256, size=n, dtype=np.uint8)))[14:]


def decap_corpus(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):  # established-session IPv4 data
        sid, mac, ip = SESSIONS[rng.integers(len(SESSIONS))]
        out.append(F.pppoe_session_frame(AC_MAC, mac, sid, F.PROTO_IPV4,
                                         _ip_udp(rng, ip, REMOTE, int(rng.integers(0, 80))),
                                         vlans=_vlans(rng)))
    sid, mac, ip = SESSIONS[0]
    padded = F.pppoe_session_frame(AC_MAC, mac, sid, F.PROTO_IPV4, _ip_udp(rng, ip, REMOTE, 4))
    out.append(padded + bytes(20))  # Ethernet padding past the declared length
    lcp = F.CPPacket(F.CP_ECHO_REQ, 7, data=b"\x01\x02\x03\x04").encode()
    ipcp = F.CPPacket(F.CP_CONF_REQ, 3, options=[F.CPOption(3, bytes(4))]).encode()
    out += [
        F.pppoe_session_frame(AC_MAC, mac, sid, F.PROTO_LCP, lcp, vlans=_vlans(rng)),
        F.pppoe_session_frame(AC_MAC, mac, sid, F.PROTO_IPCP, ipcp),
        F.pppoe_session_frame(AC_MAC, mac, sid, F.PROTO_IPV6, bytes(48)),
        F.pppoe_padi_frame(mac, host_uniq=b"hu", vlans=_vlans(rng)),
        F.pppoe_session_frame(AC_MAC, mac, 0x7777, F.PROTO_IPV4, _ip_udp(rng, ip, REMOTE, 8)),
        F.pppoe_session_frame(AC_MAC, b"\x02\x99" * 3, sid, F.PROTO_IPV4,
                              _ip_udp(rng, ip, REMOTE, 8)),  # MAC mismatch
        F.udp_packet(mac, AC_MAC, ip, REMOTE, 1, 2, b"plain", vlans=_vlans(rng)),
    ]
    good = F.pppoe_session_frame(AC_MAC, mac, sid, F.PROTO_IPV4, _ip_udp(rng, ip, REMOTE, 10))
    bad_len = bytearray(good)
    bad_len[18:20] = (len(good) - 20 + 1).to_bytes(2, "big")  # declared past the frame
    bad_vt = bytearray(good)
    bad_vt[14] = 0x12
    bad_code = bytearray(good)
    bad_code[15] = 0x07
    short_plen = bytearray(good)
    short_plen[18:20] = (1).to_bytes(2, "big")  # cannot hold the PPP protocol word
    out += [bytes(bad_len), bytes(bad_vt), bytes(bad_code), bytes(short_plen), good[:19]]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def encap_corpus(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        _, _, ip = SESSIONS[rng.integers(len(SESSIONS))]
        out.append(F.udp_packet(b"\x04" * 6, b"\x06" * 6, REMOTE, ip, 53, 4000,
                                bytes(int(rng.integers(0, 60))), vlans=_vlans(rng)))
    ip = SESSIONS[1][2]
    fill = L - 8 - 42  # a frame of exactly L-8 bytes encaps, L-7 does not
    out += [
        F.udp_packet(b"\x04" * 6, b"\x06" * 6, REMOTE, ip, 53, 4000, bytes(fill)),
        F.udp_packet(b"\x04" * 6, b"\x06" * 6, REMOTE, ip, 53, 4000, bytes(fill + 1)),
        F.udp_packet(b"\x04" * 6, b"\x06" * 6, REMOTE, ip_to_u32("10.9.9.9"), 53, 4000, b"x"),
        b"\x04" * 6 + b"\x06" * 6 + b"\x86\xdd" + bytes(40),  # IPv6: not encapped
    ]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _batch(frames, B=32):
    pkt = np.zeros((B, L), dtype=np.uint8)
    length = np.zeros((B,), dtype=np.uint32)
    for i, fr in enumerate(frames):
        pkt[i, : len(fr)] = np.frombuffer(fr, dtype=np.uint8)
        length[i] = len(fr)
    return pkt, length


def _both(pkt, length):
    return (jnp.asarray(pkt), jnp.asarray(length),
            torch.from_numpy(pkt.copy()), torch.from_numpy(length.astype(np.int64)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pppoe_decap(tables, seed):
    jt, tt = tables
    jpkt, jlen, tpkt, tlen = _both(*_batch(decap_corpus(seed)))
    jvo, jet = j_eth_vlan(jpkt)
    tvo, tet = t_eth_vlan(tpkt)
    ref = _decap(jpkt, jlen, jvo, jet, jt.sid, jt.geom)
    got = tp.pppoe_decap(tpkt, tlen, tvo, tet, tt.sid, tt.geom)
    assert_tuple_equal(got, ref, "decap")
    st = np.asarray(ref.stats)
    # data decapped, control punted, malformed, and misses all occur
    assert st[jp.PST_DECAP] >= 5 and st[jp.PST_CTRL_PUNT] >= 4
    assert st[jp.PST_BAD] >= 5 and st[jp.PST_MISS] >= 2


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("stamp_ac_mac", [True, False])
def test_pppoe_encap(tables, seed, stamp_ac_mac):
    jt, tt = tables
    jpkt, jlen, tpkt, tlen = _both(*_batch(encap_corpus(seed)))
    jpar, tpar = j_parse(jpkt, jlen), t_parse(tpkt, tlen)
    ref = _encap(jpkt, jlen, jpar.vlan_offset, jpar.ethertype, jpar.dst_ip, jt.ip, jt.geom,
                 jt.mac if stamp_ac_mac else None)
    got = tp.pppoe_encap(tpkt, tlen, tpar.vlan_offset, tpar.ethertype, tpar.dst_ip, tt.ip,
                         tt.geom, tt.mac if stamp_ac_mac else None)
    assert_tuple_equal(got, ref, "encap")
    assert int(np.asarray(ref.stats)[jp.PST_ENCAP]) == 6  # 5 sessions + the L-8 frame


@pytest.mark.parametrize("seed", [4, 5])
def test_qinq_push_and_pop(seed):
    rng = np.random.default_rng(seed)
    frames = [F.udp_packet(b"\x04" * 6, b"\x06" * 6, REMOTE, 1, 2, 3,
                           bytes(int(rng.integers(0, 100))), vlans=_vlans(rng)) for _ in range(20)]
    frames += [F.udp_packet(b"\x04" * 6, b"\x06" * 6, REMOTE, 1, 2, 3, bytes(L - 8 - 42 + k))
               for k in (0, 1)]
    pkt, length = _batch(frames)
    jpkt, jlen, tpkt, tlen = _both(pkt, length)
    gate = rng.random(32) < 0.8
    tags = rng.integers(0, 1 << 16, size=(2, 32)).astype(np.uint32)  # above 0xFFF: masked
    ref = _push(jpkt, jlen, jnp.asarray(tags[0]), jnp.asarray(tags[1]), jnp.asarray(gate))
    got = tp.qinq_push(tpkt, tlen, torch.from_numpy(tags[0].astype(np.int64)),
                       torch.from_numpy(tags[1].astype(np.int64)), torch.from_numpy(gate))
    for g, r in zip(got, ref):
        assert np.array_equal(bits(g), bits(r))
    jvo = j_parse(jpkt, jlen).vlan_offset
    tvo = t_parse(tpkt, tlen).vlan_offset
    ref = _pop(jpkt, jlen, jvo, jnp.asarray(gate))
    got = tp.qinq_pop(tpkt, tlen, tvo, torch.from_numpy(gate))
    for g, r in zip(got, ref):
        assert np.array_equal(bits(g), bits(r))
    assert 0 < int(np.asarray(ref[2]).sum()) < len(frames)


def test_session_tables_match_reference(tables):
    j, t = _tables(JPPPoE), _tables(TPPPoE)
    for a, b in ((j.by_sid, t.by_sid), (j.by_ip, t.by_ip)):
        assert np.array_equal(a.keys, b.keys) and np.array_equal(a.vals, b.vals)
    j.session_down(SimpleNamespace(session=SimpleNamespace(
        session_id=SESSIONS[2][0], assigned_ip=SESSIONS[2][2])))
    t.session_down(SimpleNamespace(session=SimpleNamespace(
        session_id=SESSIONS[2][0], assigned_ip=SESSIONS[2][2])))
    for a, b in ((j.by_sid, t.by_sid), (j.by_ip, t.by_ip)):
        assert np.array_equal(a.keys, b.keys) and np.array_equal(a.used, b.used)
    assert np.array_equal(j.server_mac, t.server_mac)


def test_bulk_sessions_match_session_up():
    one, bulk = TPPPoE(nbuckets=64, stash=8), TPPPoE(nbuckets=64, stash=8)
    for sid, mac, ip in SESSIONS:
        one.session_up(SimpleNamespace(session_id=sid, client_mac=mac, assigned_ip=ip))
    bulk.bulk_sessions_up([s for s, _, _ in SESSIONS],
                          [int.from_bytes(m, "big") for _, m, _ in SESSIONS],
                          [ip for _, _, ip in SESSIONS])
    for s, _, ip in SESSIONS:
        assert np.array_equal(one.by_sid.lookup([s]), bulk.by_sid.lookup([s]))
        assert np.array_equal(one.by_ip.lookup([ip]), bulk.by_ip.lookup([ip]))


def test_frames_match_reference_codec():
    from bng_tpu.control.pppoe import codec as jc

    mac = SESSIONS[0][1]
    inner = _ip_udp(np.random.default_rng(0), 1, 2, 5)
    ref = jc.eth_frame(AC_MAC, mac, jc.ETH_PPPOE_SESSION,
                       jc.PPPoEPacket(code=0, session_id=0x42,
                                      payload=jc.ppp_frame(jc.PROTO_IPV4, inner)).encode(),
                       vlans=[5, 6])
    assert F.pppoe_session_frame(AC_MAC, mac, 0x42, F.PROTO_IPV4, inner, vlans=[5, 6]) == ref
    padi = jc.eth_frame(b"\xff" * 6, mac, jc.ETH_PPPOE_DISCOVERY,
                        jc.PPPoEPacket(code=jc.CODE_PADI, payload=jc.serialize_tags(
                            [jc.Tag(jc.TAG_SERVICE_NAME), jc.Tag(jc.TAG_HOST_UNIQ, b"u")])).encode())
    assert F.pppoe_padi_frame(mac, host_uniq=b"u") == padi
    for cp in ((F.CP_ECHO_REQ, 1, [], b"abcd"), (F.CP_CONF_REQ, 2, [(1, b"\x05\xdc")], b"")):
        got = F.CPPacket(cp[0], cp[1], [F.CPOption(*o) for o in cp[2]], cp[3]).encode()
        want = jc.CPPacket(cp[0], cp[1], [jc.CPOption(*o) for o in cp[2]], cp[3]).encode()
        assert got == want
    dec = F.PPPoEPacket.decode(ref[22:])
    assert (dec.session_id, dec.payload) == (0x42, jc.PPPoEPacket.decode(ref[22:]).payload)
