"""Frame constructors and decoders for a DHCP DISCOVER/OFFER, a UDP/TCP flow,
a DHCPv6 reply and PPPoE session and discovery frames.

The port's own copy of the subset of `bng_tpu/control/packets.py`
(`udp_packet`, `tcp_packet`, `udp6_packet`, `decode`) that the engine's
new-flow punt, the slow-path demux, `chip_smoke.py` and the tests use,
with the DHCP codec's packet, request constructor and decoder re-exported from
`control/dhcp_codec.py` and the PPPoE/PPP codec (`eth_frame`,
`PPPoEPacket`, tags, `CPPacket`, `ppp_frame`, the session and PADI
frames) from `control/pppoe/codec.py`. Byte-identical output.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from bng_tpu_torch.control.dhcp_codec import (  # noqa: F401 — re-exported
    ACK, DISCOVER, OFFER, OPT_PARAM_REQ_LIST, REQUEST, build_request,
)
from bng_tpu_torch.control.dhcp_codec import decode as decode_dhcp  # noqa: F401
from bng_tpu_torch.control.pppoe.codec import (  # noqa: F401 — re-exported
    CODE_PADI, CODE_PADO, CODE_PADR, CODE_PADS, CODE_PADT, CODE_SESSION, CP_CONF_ACK,
    CP_CONF_NAK, CP_CONF_REJ, CP_CONF_REQ, CP_ECHO_REP, CP_ECHO_REQ, CP_TERM_ACK, CP_TERM_REQ,
    ETH_P_8021AD, ETH_P_8021Q, ETH_PPPOE_DISCOVERY, ETH_PPPOE_SESSION, PROTO_IPCP, PROTO_IPV4,
    PROTO_IPV6, PROTO_LCP,
    TAG_AC_NAME, TAG_END_OF_LIST, TAG_HOST_UNIQ, TAG_SERVICE_NAME, CPOption, CPPacket,
    PPPoEPacket, Tag, eth_frame, ppp_frame, pppoe_padi_frame, pppoe_session_frame,
    serialize_tags,
)
from bng_tpu_torch.utils.net import ipv4_header

ETH_P_IP = 0x0800


def checksum16(data: bytes) -> int:
    """One's-complement 16-bit checksum (the whole buffer reduced mod 0xFFFF)."""
    if len(data) % 2:
        data += b"\x00"
    n = int.from_bytes(data, "big")
    s = n % 0xFFFF
    if s == 0 and n != 0:
        s = 0xFFFF
    return (~s) & 0xFFFF


def eth_header(dst: bytes, src: bytes, ethertype: int, vlans: list[int] | None = None) -> bytes:
    """L2 header; vlans = [outer_vid] (802.1Q) or [outer_vid, inner_vid] (QinQ)."""
    return eth_frame(dst, src, ethertype, b"", vlans)


def udp_packet(src_mac: bytes, dst_mac: bytes, src_ip: int, dst_ip: int, src_port: int,
               dst_port: int, payload: bytes, vlans: list[int] | None = None,
               ttl: int = 64) -> bytes:
    udp = struct.pack("!HHHH", src_port, dst_port, 8 + len(payload), 0) + payload
    ip = ipv4_header(src_ip, dst_ip, len(udp), 17, ttl=ttl)
    return eth_header(dst_mac, src_mac, ETH_P_IP, vlans) + ip + udp


def tcp_packet(src_mac: bytes, dst_mac: bytes, src_ip: int, dst_ip: int, src_port: int,
               dst_port: int, payload: bytes = b"", flags: int = 0x18, seq: int = 0,
               ack: int = 0, vlans: list[int] | None = None) -> bytes:
    tcp = struct.pack("!HHIIBBHHH", src_port, dst_port, seq, ack, 5 << 4, flags,
                      65535, 0, 0) + payload
    pseudo = struct.pack("!IIBBH", src_ip, dst_ip, 0, 6, len(tcp))
    csum = checksum16(pseudo + tcp)
    tcp = tcp[:16] + struct.pack("!H", csum) + tcp[18:]
    ip = ipv4_header(src_ip, dst_ip, len(tcp), 6)
    return eth_header(dst_mac, src_mac, ETH_P_IP, vlans) + ip + tcp


def udp6_packet(src_mac: bytes, dst_mac: bytes, src_ip: bytes, dst_ip: bytes, src_port: int,
                dst_port: int, payload: bytes, hop_limit: int = 64) -> bytes:
    """Eth + IPv6 + UDP frame (DHCPv6 control traffic). The UDP checksum
    is mandatory in IPv6 (RFC 8200 §8.1): computed over the v6
    pseudo-header + UDP header + payload; addresses are 16 bytes."""
    udp_len = 8 + len(payload)
    udp_hdr = struct.pack("!HHHH", src_port, dst_port, udp_len, 0)
    pseudo = src_ip + dst_ip + struct.pack("!IHBB", udp_len, 0, 0, 17)
    csum = checksum16(pseudo + udp_hdr + payload)
    if csum == 0:  # all-zero means "no checksum" in UDP: transmit as ffff
        csum = 0xFFFF
    udp_hdr = struct.pack("!HHHH", src_port, dst_port, udp_len, csum)
    ip6 = struct.pack("!IHBB", 0x60000000, udp_len, 17, hop_limit) + src_ip + dst_ip
    return dst_mac + src_mac + struct.pack("!H", 0x86DD) + ip6 + udp_hdr + payload


@dataclass
class DecodedPacket:
    dst_mac: bytes = b""
    src_mac: bytes = b""
    vlans: list[int] = field(default_factory=list)
    ethertype: int = 0
    src_ip: int = 0
    dst_ip: int = 0
    ttl: int = 0
    proto: int = 0
    ip_total_len: int = 0
    ip_checksum: int = 0
    ip_checksum_ok: bool = False
    src_port: int = 0
    dst_port: int = 0
    udp_len: int = 0
    l4_checksum: int = 0
    payload: bytes = b""
    tcp_flags: int = 0
    icmp_id: int = 0


def decode(raw: bytes) -> DecodedPacket:
    """Parse a raw frame back into fields."""
    p = DecodedPacket()
    p.dst_mac, p.src_mac = raw[0:6], raw[6:12]
    off = 12
    et = struct.unpack_from("!H", raw, off)[0]
    off += 2
    while et in (ETH_P_8021Q, ETH_P_8021AD):
        tci = struct.unpack_from("!H", raw, off)[0]
        p.vlans.append(tci & 0x0FFF)
        et = struct.unpack_from("!H", raw, off + 2)[0]
        off += 4
    p.ethertype = et
    if et != ETH_P_IP:
        return p
    (ver_ihl, _tos, p.ip_total_len, _ident, _frag, p.ttl, p.proto,
     p.ip_checksum, p.src_ip, p.dst_ip) = struct.unpack_from("!BBHHHBBHII", raw, off)
    ihl = (ver_ihl & 0x0F) * 4
    p.ip_checksum_ok = checksum16(raw[off: off + ihl]) == 0
    l4 = off + ihl
    if p.proto == 17:
        p.src_port, p.dst_port, p.udp_len, p.l4_checksum = struct.unpack_from("!HHHH", raw, l4)
        p.payload = raw[l4 + 8: l4 + p.udp_len]
    elif p.proto == 6:
        p.src_port, p.dst_port = struct.unpack_from("!HH", raw, l4)
        data_off = (raw[l4 + 12] >> 4) * 4
        p.tcp_flags = raw[l4 + 13]
        p.l4_checksum = struct.unpack_from("!H", raw, l4 + 16)[0]
        p.payload = raw[l4 + data_off: off + p.ip_total_len]
    elif p.proto == 1:
        p.l4_checksum = struct.unpack_from("!H", raw, l4 + 2)[0]
        p.icmp_id = struct.unpack_from("!H", raw, l4 + 4)[0]
        p.payload = raw[l4 + 8: off + p.ip_total_len]
    return p


def _l4_with_pseudo(raw: bytes) -> tuple[DecodedPacket, int, bytes]:
    """(decoded frame, offset of its L4 header, IPv4 pseudo-header + L4 bytes)."""
    p = decode(raw)
    off = 14 + 4 * len(p.vlans)
    l4_off = off + (raw[off] & 0x0F) * 4
    l4 = raw[l4_off: off + p.ip_total_len]
    return p, l4_off, struct.pack("!IIBBH", p.src_ip, p.dst_ip, 0, p.proto, len(l4)) + l4


def with_udp_checksum(raw: bytes) -> bytes:
    """A UDP frame with its checksum computed (`udp_packet` leaves it 0, "none")."""
    p, l4_off, data = _l4_with_pseudo(raw)
    if p.proto != 17:
        raise ValueError("with_udp_checksum: not a UDP frame")
    csum = checksum16(data[:18] + b"\x00\x00" + data[20:]) or 0xFFFF  # 12-byte pseudo-header
    return raw[: l4_off + 6] + struct.pack("!H", csum) + raw[l4_off + 8:]


def l4_checksum_ok(raw: bytes) -> bool:
    """Whether a UDP or TCP frame's checksum verifies over the IPv4
    pseudo-header. A UDP checksum of 0 means none was computed."""
    p, _, data = _l4_with_pseudo(raw)
    if p.proto == 17 and p.l4_checksum == 0:
        return True
    return p.proto in (6, 17) and checksum16(data) == 0


# ---- DHCPv4 (RFC 2131/2132): the codec lives in control/dhcp_codec.py ----

def discover_frame(mac: bytes, xid: int, vlans: list[int] | None = None, giaddr: int = 0,
                   circuit_id: bytes = b"", msg_type: int = DISCOVER, pad: int = 300) -> bytes:
    """A client DHCP request frame with its BOOTP payload padded to `pad`
    bytes. The device fast path needs >= 12 option bytes, and it reads
    option 82 only with a 64-byte option window (pad >= 304)."""
    p = build_request(mac, msg_type, xid=xid, giaddr=giaddr, circuit_id=circuit_id)
    p.options.append((OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                      p.encode().ljust(pad, b"\x00"), vlans=vlans)
