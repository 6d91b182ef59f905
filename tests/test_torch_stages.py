"""Each stage of the port's IPoE step against the JAX package on one mixed
batch, bit for bit: parse_batch, antispoof_kernel, dhcp_fastpath, and
nat44_kernel + nat44_update_sessions. Both packages get the same tables,
built by the same host calls, and the same frames. The batch covers
untagged, VLAN and QinQ DISCOVER/REQUEST, option 82, relayed, expired,
bad-pool and unknown clients, established and new NAT flows (one session
hit twice), an ICMP echo, ingress TCP with FIN beside ACK on one slot,
an IPv6 frame, a spoofed source and a truncated frame.

The deployment and frame builders here are shared with
tests/test_torch_pipeline.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bng_tpu.control.nat import NATManager as JNATManager
from bng_tpu.ops.antispoof import antispoof_kernel as j_antispoof
from bng_tpu.ops.dhcp import dhcp_fastpath as j_dhcp
from bng_tpu.ops.nat44 import nat44_kernel as j_nat, nat44_update_sessions as j_nat_upd
from bng_tpu.ops.parse import eth_vlan as j_eth_vlan, parse_batch as j_parse
from bng_tpu.runtime.engine import AntispoofTables as JAntispoofTables
from bng_tpu.runtime.engine import QoSTables as JQoSTables
from bng_tpu.runtime.tables import FastPathTables as JFastPathTables
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.nat import NATManager as TNATManager
from bng_tpu_torch.ops.antispoof import MODE_LOOSE, MODE_STRICT, antispoof_kernel as t_antispoof
from bng_tpu_torch.ops.dhcp import dhcp_fastpath as t_dhcp
from bng_tpu_torch.ops.nat44 import nat44_kernel as t_nat, nat44_update_sessions as t_nat_upd
from bng_tpu_torch.ops.parse import eth_vlan as t_eth_vlan, parse_batch as t_parse
from bng_tpu_torch.runtime.engine import AntispoofTables as TAntispoofTables
from bng_tpu_torch.runtime.engine import QoSTables as TQoSTables
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPathTables
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_words import bits

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
NOW = 1_753_000_000
L = 512

JAX_PKG = SimpleNamespace(FastPathTables=JFastPathTables, NATManager=JNATManager,
                          QoSTables=JQoSTables, AntispoofTables=JAntispoofTables)
PORT_PKG = SimpleNamespace(FastPathTables=TFastPathTables, NATManager=TNATManager,
                           QoSTables=TQoSTables, AntispoofTables=TAntispoofTables)


def assert_tuple_equal(got, ref, what):
    for f in ref._fields:
        r = getattr(ref, f)
        if r is None:
            continue
        g = getattr(got, f)
        if hasattr(r, "_fields"):
            assert_tuple_equal(g, r, f"{what}.{f}")
            continue
        assert np.array_equal(bits(g), bits(r)), f"{what}.{f}"


def mac(i: int) -> bytes:
    return bytes([0x02, 0xDE, 0xAD, 0x00, 0x00, i])


# the deployment: host calls applied identically to either package
SUB_MACS = {1: (1, "10.0.0.21", NOW + 900), 2: (2, "10.1.0.5", NOW + 900),
            3: (3, "10.3.0.7", NOW + 900), 4: (1, "10.0.0.24", NOW - 5),  # expired
            5: (9, "10.0.0.25", NOW + 900)}  # pool 9 does not exist
FLOW_SUBS = ("10.0.0.10", "10.0.0.11", "10.0.0.12")
REMOTE = "93.184.216.34"


def deploy(pkg):
    fp = pkg.FastPathTables(sub_nbuckets=256, vlan_nbuckets=64, cid_nbuckets=64,
                            max_pools=16, stash=16, update_slots=32)
    fp.set_server_config(bytes.fromhex("02aabbccdd01"), ip_to_u32("10.0.0.1"))
    fp.add_pool(1, ip_to_u32("10.0.0.0"), 24, ip_to_u32("10.0.0.1"),
                ip_to_u32("1.1.1.1"), ip_to_u32("8.8.8.8"), 3600)
    fp.add_pool(2, ip_to_u32("10.1.0.0"), 16, ip_to_u32("10.1.0.1"), ip_to_u32("1.1.1.1"), 0, 7200)
    fp.add_pool(3, ip_to_u32("10.3.0.0"), 20, ip_to_u32("10.3.0.1"), 0, 0, 86400)
    for i, (pool, ip, exp) in SUB_MACS.items():
        fp.add_subscriber(mac(i), pool_id=pool, ip=ip_to_u32(ip), lease_expiry=exp)
    fp.add_vlan_subscriber(100, 0, pool_id=2, ip=ip_to_u32("10.1.0.9"), lease_expiry=NOW + 900)
    fp.add_vlan_subscriber(200, 300, pool_id=1, ip=ip_to_u32("10.0.0.30"), lease_expiry=NOW + 900)
    fp.add_circuit_id_subscriber(b"olt-3/port-7", pool_id=3, ip=ip_to_u32("10.3.0.8"),
                                 lease_expiry=NOW + 900)

    nat = pkg.NATManager(public_ips=[ip_to_u32("203.0.113.1"), ip_to_u32("203.0.113.2")],
                         ports_per_subscriber=64, sessions_nbuckets=256, sub_nat_nbuckets=64,
                         stash=16, update_slots=64)
    for ip in FLOW_SUBS:
        nat.allocate_nat(ip_to_u32(ip), NOW)
    udp = nat.handle_new_flow(ip_to_u32("10.0.0.10"), ip_to_u32(REMOTE), 5000, 443, 17, 100, NOW)
    tcp = nat.handle_new_flow(ip_to_u32("10.0.0.11"), ip_to_u32(REMOTE), 40000, 80, 6, 100, NOW)
    nat.handle_new_flow(ip_to_u32("10.0.0.12"), ip_to_u32("8.8.8.8"), 77, 0, 1, 98, NOW)

    qos = pkg.QoSTables(nbuckets=64)
    qos.set_subscriber(ip_to_u32("10.0.0.10"), down_bps=8_000_000, up_bps=8_000,
                       up_burst=600, down_burst=20_000)
    qos.set_subscriber(ip_to_u32("10.0.0.11"), down_bps=0, up_bps=50_000_000, priority=3)

    spoof = pkg.AntispoofTables(nbuckets=64, stash=16)
    spoof.set_config(MODE_LOOSE, True)
    spoof.add_binding(mac(0x10), ip_to_u32("10.0.0.10"), MODE_STRICT)
    spoof.add_binding(mac(0x11), ip_to_u32("10.0.0.11"), MODE_STRICT)
    spoof.add_allowed_range(ip_to_u32("10.0.0.0"), 24)
    spoof.add_allowed_range(ip_to_u32("192.168.0.0"), 16)
    return SimpleNamespace(fp=fp, nat=nat, qos=qos, spoof=spoof, udp_nat=udp, tcp_nat=tcp)


def frame_mix(tcp_nat):
    """(frames, from_access) for one mixed batch."""
    rem = ip_to_u32(REMOTE)
    f = [
        (F.discover_frame(mac(1), 0x101), True),  # untagged DISCOVER, MAC hit
        (F.discover_frame(mac(9), 0x102, vlans=[100]), True),  # VLAN hit
        (F.discover_frame(mac(9), 0x103, vlans=[200, 300], msg_type=F.REQUEST), True),  # QinQ
        (F.discover_frame(mac(8), 0x104, circuit_id=b"olt-3/port-7", pad=320), True),  # option 82
        (F.discover_frame(mac(2), 0x105, giaddr=ip_to_u32("10.1.0.254")), True),  # relayed
        (F.discover_frame(mac(4), 0x106), True),  # expired lease
        (F.discover_frame(mac(5), 0x107), True),  # pool missing
        (F.discover_frame(mac(7), 0x108), True),  # unknown MAC
        (F.discover_frame(mac(3), 0x109, vlans=[999]), True),  # VLAN miss -> MAC hit
        (F.udp_packet(mac(0x10), b"\x04" * 6, ip_to_u32("10.0.0.10"), rem, 5000, 443,
                      b"a" * 300), True),  # established flow (QoS-limited sub)
        (F.udp_packet(mac(0x10), b"\x04" * 6, ip_to_u32("10.0.0.10"), rem, 5000, 443,
                      b"b" * 200), True),  # same session again
        (F.udp_packet(mac(0x10), b"\x04" * 6, ip_to_u32("10.0.0.10"), rem, 5001, 53,
                      b"c" * 40), True),  # new flow -> punt
        (F.tcp_packet(mac(0x11), b"\x04" * 6, ip_to_u32("10.0.0.11"), rem, 40000, 80,
                      b"GET /", flags=0x18), True),  # established TCP egress
        (F.tcp_packet(b"\x04" * 6, mac(0x11), rem, tcp_nat[0], 80, tcp_nat[1], b"ok",
                      flags=0x10), False),  # ingress ACK
        (F.tcp_packet(b"\x04" * 6, mac(0x11), rem, tcp_nat[0], 80, tcp_nat[1], b"",
                      flags=0x11), False),  # ingress FIN|ACK on the same slot
        (F.udp_packet(mac(0x10), b"\x04" * 6, ip_to_u32("10.0.0.99"), rem, 1, 2, b"x" * 30),
         True),  # spoofed source on a strict binding
        (F.udp_packet(mac(0x33), b"\x04" * 6, ip_to_u32("172.16.0.5"), rem, 1, 2, b"y" * 30),
         True),  # unbound MAC, outside the loose ranges
        (F.udp_packet(b"\x04" * 6, mac(0x10), rem, ip_to_u32("203.0.113.1"), 443, 1, b"z" * 20),
         False),  # ingress miss
    ]
    # ICMP echo with a session (egress) — built from raw headers
    icmp = b"\x08\x00\x00\x00" + (77).to_bytes(2, "big") + b"\x00\x01" + b"ping"
    csum = F.checksum16(icmp)
    icmp = icmp[:2] + csum.to_bytes(2, "big") + icmp[4:]
    ip = F.ipv4_header(ip_to_u32("10.0.0.12"), ip_to_u32("8.8.8.8"), len(icmp), 1)
    f.append((F.eth_header(b"\x04" * 6, mac(0x12), 0x0800) + ip + icmp, True))
    # REQUESTs: untagged with ciaddr set (unicast reply), VLAN with the broadcast flag
    for vl, kw in ((None, dict(ciaddr=ip_to_u32("10.0.0.21"))), ([100], dict(broadcast=True))):
        req = F.build_request(mac(1) if vl is None else mac(9), F.REQUEST, xid=0x200, **kw)
        req.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6])))
        f.append((F.udp_packet(req.chaddr, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                               req.encode().ljust(300, b"\x00"), vlans=vl), True))
    # an IPv6 frame and a truncated frame
    f.append((mac(0x10) + mac(0x13) + b"\x86\xdd" + bytes(60), True))
    f.append((b"\x01\x02\x03", True))
    frames = [x for x, _ in f]
    fa = [a for _, a in f]
    return frames, fa


def batch(frames, B):
    pkt = np.zeros((B, L), dtype=np.uint8)
    length = np.zeros((B,), dtype=np.uint32)
    for i, fr in enumerate(frames):
        pkt[i, : len(fr)] = np.frombuffer(fr, dtype=np.uint8)
        length[i] = len(fr)
    return pkt, length


def jax_tables(d):
    """The JAX package's uploads of each table set, copied: on the CPU
    `jnp.asarray` may alias a host mirror array (alignment-dependent)."""
    import jax

    def cp(tree):
        return jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), tree)

    return SimpleNamespace(dhcp=cp(d.fp.device_tables()), nat=cp(d.nat.device_tables()),
                           spoof=cp(d.spoof.bindings.device_state()))


@pytest.fixture(scope="module")
def stage_in():
    jd, td = deploy(JAX_PKG), deploy(PORT_PKG)
    assert jd.tcp_nat == td.tcp_nat and jd.udp_nat == td.udp_nat
    frames, fa = frame_mix(td.tcp_nat)
    pkt, length = batch(frames, 32)
    return SimpleNamespace(jd=jd, td=td, jpkt=jnp.asarray(pkt), jlen=jnp.asarray(length),
                           tpkt=torch.from_numpy(pkt),
                           tlen=torch.from_numpy(length.astype(np.int64)))


def test_parse_batch(stage_in):
    s = stage_in
    assert_tuple_equal(t_parse(s.tpkt, s.tlen), j_parse(s.jpkt, s.jlen), "parsed")
    for got, ref in zip(t_eth_vlan(s.tpkt), j_eth_vlan(s.jpkt)):
        assert np.array_equal(bits(got), bits(ref))


def test_antispoof_kernel(stage_in):
    jd, td = stage_in.jd, stage_in.td
    ref = j_antispoof(stage_in.jpkt, j_parse(stage_in.jpkt, stage_in.jlen),
                      jax_tables(jd).spoof, jd.spoof.geom,
                      jnp.asarray(jd.spoof.ranges), jnp.asarray(jd.spoof.config))
    got = t_antispoof(stage_in.tpkt, t_parse(stage_in.tpkt, stage_in.tlen),
                      td.spoof.bindings.device_state(CPU), td.spoof.geom,
                      torch.from_numpy(td.spoof.ranges.view(np.int32)),
                      torch.from_numpy(td.spoof.config.view(np.int32)))
    assert_tuple_equal(got, ref, "antispoof")
    assert bool(np.asarray(ref.dropped).any()) and bool(np.asarray(ref.violation).any())


def test_dhcp_fastpath(stage_in):
    jd, td = stage_in.jd, stage_in.td
    ref = j_dhcp(stage_in.jpkt, stage_in.jlen, j_parse(stage_in.jpkt, stage_in.jlen),
                 jax_tables(jd).dhcp, jd.fp.geom, jnp.uint32(NOW))
    got = t_dhcp(stage_in.tpkt, stage_in.tlen, t_parse(stage_in.tpkt, stage_in.tlen),
                 td.fp.device_tables(CPU), td.fp.geom, torch.tensor(NOW))
    assert_tuple_equal(got, ref, "dhcp")
    # the batch really exercises replies, misses, expiry and the pool error
    st = np.asarray(ref.stats)
    assert int(np.asarray(ref.is_reply).sum()) >= 8
    assert st[2] > 0 and st[3] > 0 and st[4] > 0 and st[5] > 0


def test_nat44_kernel_and_update_sessions(stage_in):
    jd, td = stage_in.jd, stage_in.td
    jtab = jax_tables(jd).nat
    ttab = td.nat.device_tables(CPU)
    jp, tp = j_parse(stage_in.jpkt, stage_in.jlen), t_parse(stage_in.tpkt, stage_in.tlen)
    ref = j_nat(stage_in.jpkt, stage_in.jlen, jp, jtab, jd.nat.geom, jnp.uint32(NOW + 7))
    got = t_nat(stage_in.tpkt, stage_in.tlen, tp, ttab, td.nat.geom, torch.tensor(NOW + 7))
    assert_tuple_equal(got, ref, "nat")
    assert int(np.asarray(ref.punted).sum()) >= 1
    assert int(np.asarray(ref.egress_hit).sum()) == 4  # UDP twice, TCP, ICMP
    assert int(np.asarray(ref.ingress_hit).sum()) == 2  # ACK and FIN|ACK, one slot
    keep = np.array(ref.translated)
    keep[10] = False  # one forwarded lane that a later stage dropped
    new_sessions = j_nat_upd(jtab.sessions, ref, jp, stage_in.jlen, jnp.asarray(keep),
                             jnp.uint32(NOW + 7))
    out = t_nat_upd(ttab.sessions, got, tp, stage_in.tlen, torch.from_numpy(keep),
                    torch.tensor(NOW + 7))
    assert out is ttab.sessions
    assert np.array_equal(bits(ttab.sessions.vals), np.asarray(new_sessions.vals))
