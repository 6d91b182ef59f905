"""The deployments and batches that the port's CPU tests share with its
card tests: plain port code, no JAX (the card's machine has none). Host
calls only, so `deploy(pkg)` and `deploy_full(pkg)` build the same tables
from the JAX package's classes too.

- `deploy(pkg)`: the IPoE box (DHCP subscribers by MAC, VLAN and option
  82; NAT44 sessions; QoS; antispoof); `frame_mix(tcp_nat)`: one mixed
  batch over it (every DHCP lookup kind, established and new flows both
  ways, an ICMP echo, a spoofed source, an IPv6 and a truncated frame).
- `deploy_full(pkg)`: that box with the walled garden, PPPoE sessions,
  taps and routes; `full_batch(d)`: the mix with PPPoE and garden lanes.
"""

from types import SimpleNamespace

import numpy as np

from bng_tpu_torch import frames as F
from bng_tpu_torch.control.nat import NATManager as TNATManager
from bng_tpu_torch.edge.tables import EdgeTables as TEdgeTables
from bng_tpu_torch.ops.antispoof import MODE_LOOSE, MODE_STRICT
from bng_tpu_torch.runtime.engine import AntispoofTables as TAntispoofTables
from bng_tpu_torch.runtime.engine import GardenTables as TGardenTables
from bng_tpu_torch.runtime.engine import QoSTables as TQoSTables
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPathTables
from bng_tpu_torch.runtime.tables import PPPoEFastPathTables as TPPPoETables
from bng_tpu_torch.utils.net import ip_to_u32

NOW = 1_753_000_000
L = 512

PORT_PKG = SimpleNamespace(FastPathTables=TFastPathTables, NATManager=TNATManager,
                           QoSTables=TQoSTables, AntispoofTables=TAntispoofTables)


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


AC_MAC = bytes.fromhex("02aabbccdd01")
PORTAL, DNS = ip_to_u32("10.9.9.9"), ip_to_u32("10.9.9.53")
GW = bytes.fromhex("02475700000a")
# PPPoE sessions: (session id, client MAC, address)
SESSIONS = [(0x42, bytes.fromhex("02c0ffee0007"), ip_to_u32("10.0.0.77")),
            (0x43, bytes.fromhex("02c0ffee0008"), ip_to_u32("10.0.0.78"))]
GARDENED = ip_to_u32("10.0.0.12")
TAPPED = {ip_to_u32("10.0.0.10"): 7, ip_to_u32("10.0.0.11"): 9}

PORT_FULL = SimpleNamespace(**vars(PORT_PKG), GardenTables=TGardenTables,
                            PPPoEFastPathTables=TPPPoETables, EdgeTables=TEdgeTables)


def deploy_full(pkg):
    """The IPoE deployment of test_torch_stages plus every optional stage."""
    d = deploy(pkg)
    d.garden = pkg.GardenTables(nbuckets=64, stash=8, update_slots=16)
    d.garden.set_gardened(GARDENED, True)
    d.garden.allow_destination(PORTAL, 80, 6)
    d.garden.allow_destination(PORTAL, 443, 6)
    d.garden.allow_destination(DNS, 53, 17)
    d.garden.allow_destination(DNS, 53, 6)
    d.pppoe = pkg.PPPoEFastPathTables(nbuckets=64, stash=8, update_slots=16, server_mac=AC_MAC)
    for sid, m, ip in SESSIONS:
        d.pppoe.session_up(SimpleNamespace(session_id=sid, client_mac=m, assigned_ip=ip))
        d.nat.allocate_nat(ip, NOW)
    # one established flow of the first PPPoE subscriber (downstream encap)
    d.pppoe_nat = d.nat.handle_new_flow(SESSIONS[0][2], ip_to_u32(REMOTE), 6000, 53, 17, 80, NOW)
    d.edge = pkg.EdgeTables(nbuckets=64, stash=8, update_slots=16, max_filters=8)
    d.edge.arm_tap(ip_to_u32("10.0.0.10"), 7)
    d.edge.arm_tap(ip_to_u32("10.0.0.11"), 9, [(80, 6, 0)])
    for ip in ("10.0.0.10", "10.0.0.11", "10.0.0.12", "10.0.0.77"):
        d.edge.set_route(ip_to_u32(ip), GW, table_id=100)
    return d


def pppoe_frames(d):
    """(frames, from_access) exercising the PPPoE and garden stages."""
    (sid, m, ip), (sid2, m2, ip2) = SESSIONS
    rem = ip_to_u32(REMOTE)

    def inner(src, dst, sport, dport, n):
        return F.udp_packet(m, AC_MAC, src, dst, sport, dport, b"p" * n)[14:]

    lcp = F.CPPacket(F.CP_ECHO_REQ, 1, data=b"\x00\x00\x00\x01").encode()
    return [
        (F.pppoe_session_frame(AC_MAC, m, sid, F.PROTO_IPV4, inner(ip, rem, 6000, 53, 40)),
         True),  # established PPPoE flow: decap, SNAT
        (F.pppoe_session_frame(AC_MAC, m2, sid2, F.PROTO_IPV4, inner(ip2, rem, 6001, 53, 30),
                               vlans=[100, 200]), True),  # QinQ, new flow, no route: punt
        (F.pppoe_session_frame(AC_MAC, m, sid, F.PROTO_LCP, lcp), True),  # control: PASS
        (F.pppoe_padi_frame(m, host_uniq=b"u1"), True),  # discovery: PASS
        (F.pppoe_session_frame(AC_MAC, m, 0x99, F.PROTO_IPV4, inner(ip, rem, 6000, 53, 8)),
         True),  # unknown session: PASS
        (F.pppoe_session_frame(AC_MAC, m, sid, F.PROTO_IPV4, inner(ip, rem, 6000, 53, 8)),
         False),  # session ethertype from the core: untouched
        (F.udp_packet(b"\x04" * 6, b"\x06" * 6, rem, d.pppoe_nat[0], 53, d.pppoe_nat[1],
                      b"answer" * 4), False),  # downstream: DNAT, then encap
        (F.tcp_packet(mac(0x12), b"\x04" * 6, GARDENED, PORTAL, 33000, 80, b"GET"),
         True),  # gardened, allowed destination
        (F.udp_packet(mac(0x12), b"\x04" * 6, GARDENED, rem, 33001, 443, b"q" * 20),
         True),  # gardened, not allowed: DROP
    ]


def full_batch(d):
    frames, fa = frame_mix(d.tcp_nat)
    extra = pppoe_frames(d)
    return frames + [f for f, _ in extra], fa + [a for _, a in extra]
