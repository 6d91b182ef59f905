"""PPPoE + PPP wire codec.

The port's copy of `bng_tpu/control/pppoe/codec.py` (jax-free), with two
frame constructors of its own (`pppoe_session_frame`, `pppoe_padi_frame`) that
the device stage's tests and `chip_smoke.py` use; `frames.py` re-exports
the codec.

Parity: pkg/pppoe/protocol.go — PPPoE header/tags (discovery codes,
tag constants :31-40, ParseTags/SerializeTags :162-204) and the PPP
control-protocol packet layout (code, id, length, options) shared by
LCP/IPCP/IPV6CP (lcp.go option codec).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

ETH_PPPOE_DISCOVERY = 0x8863
ETH_PPPOE_SESSION = 0x8864

# PPPoE codes (RFC 2516)
CODE_PADI = 0x09
CODE_PADO = 0x07
CODE_PADR = 0x19
CODE_PADS = 0x65
CODE_PADT = 0xA7
CODE_SESSION = 0x00

# PPPoE tag types (protocol.go:31-40)
TAG_END_OF_LIST = 0x0000
TAG_SERVICE_NAME = 0x0101
TAG_AC_NAME = 0x0102
TAG_HOST_UNIQ = 0x0103
TAG_AC_COOKIE = 0x0104
TAG_VENDOR_SPECIFIC = 0x0105
TAG_RELAY_SESSION_ID = 0x0110
TAG_SERVICE_NAME_ERR = 0x0201
TAG_AC_SYSTEM_ERR = 0x0202
TAG_GENERIC_ERR = 0x0203

# PPP protocol numbers
PROTO_IPV4 = 0x0021
PROTO_IPV6 = 0x0057
PROTO_IPCP = 0x8021
PROTO_IPV6CP = 0x8057
PROTO_LCP = 0xC021
PROTO_PAP = 0xC023
PROTO_CHAP = 0xC223

# PPP control-protocol codes (RFC 1661 §5)
CP_CONF_REQ = 1
CP_CONF_ACK = 2
CP_CONF_NAK = 3
CP_CONF_REJ = 4
CP_TERM_REQ = 5
CP_TERM_ACK = 6
CP_CODE_REJ = 7
CP_PROTO_REJ = 8
CP_ECHO_REQ = 9
CP_ECHO_REP = 10
CP_DISCARD_REQ = 11


@dataclass
class Tag:
    type: int
    value: bytes = b""


@dataclass
class PPPoEPacket:
    """One PPPoE frame (after the Ethernet header)."""

    code: int
    session_id: int = 0
    payload: bytes = b""
    ver_type: int = 0x11

    def encode(self) -> bytes:
        return struct.pack(">BBHH", self.ver_type, self.code, self.session_id,
                           len(self.payload)) + self.payload

    @classmethod
    def decode(cls, data: bytes) -> "PPPoEPacket":
        if len(data) < 6:
            raise ValueError("PPPoE header truncated")
        ver_type, code, sid, length = struct.unpack(">BBHH", data[:6])
        if ver_type != 0x11:
            raise ValueError(f"bad PPPoE ver/type {ver_type:#x}")
        if length > len(data) - 6:
            raise ValueError("PPPoE length exceeds frame")
        return cls(code=code, session_id=sid, payload=data[6 : 6 + length],
                   ver_type=ver_type)


def parse_tags(data: bytes) -> list[Tag]:
    """Parity: ParseTags (protocol.go:162-190); stops at End-Of-List."""
    tags: list[Tag] = []
    off = 0
    while off + 4 <= len(data):
        ttype, tlen = struct.unpack(">HH", data[off : off + 4])
        if ttype == TAG_END_OF_LIST:
            break
        off += 4
        if off + tlen > len(data):
            raise ValueError("tag length exceeds payload")
        tags.append(Tag(ttype, data[off : off + tlen]))
        off += tlen
    return tags


def serialize_tags(tags: list[Tag]) -> bytes:
    out = bytearray()
    for t in tags:
        out += struct.pack(">HH", t.type, len(t.value)) + t.value
    return bytes(out)


def find_tag(tags: list[Tag], ttype: int) -> Tag | None:
    for t in tags:
        if t.type == ttype:
            return t
    return None


@dataclass
class CPOption:
    """One LCP/IPCP/IPV6CP option: type, data (TLV with 2-byte overhead)."""

    type: int
    data: bytes = b""

    def encode(self) -> bytes:
        return bytes([self.type, len(self.data) + 2]) + self.data


@dataclass
class CPPacket:
    """PPP control-protocol packet: code, identifier, body.

    For CONF_* codes the body is an option list; for ECHO_*/TERM_* it is
    opaque data (magic number + payload for echoes).
    """

    code: int
    identifier: int
    options: list[CPOption] = field(default_factory=list)
    data: bytes = b""

    def encode(self) -> bytes:
        if self.code in (CP_CONF_REQ, CP_CONF_ACK, CP_CONF_NAK, CP_CONF_REJ):
            body = b"".join(o.encode() for o in self.options)
        else:
            body = self.data
        return struct.pack(">BBH", self.code, self.identifier, len(body) + 4) + body

    @classmethod
    def decode(cls, data: bytes) -> "CPPacket":
        if len(data) < 4:
            raise ValueError("CP packet truncated")
        code, ident, length = struct.unpack(">BBH", data[:4])
        if length < 4 or length > len(data):
            raise ValueError("bad CP length")
        body = data[4:length]
        pkt = cls(code=code, identifier=ident)
        if code in (CP_CONF_REQ, CP_CONF_ACK, CP_CONF_NAK, CP_CONF_REJ):
            off = 0
            while off + 2 <= len(body):
                otype, olen = body[off], body[off + 1]
                if olen < 2 or off + olen > len(body):
                    raise ValueError("bad CP option length")
                pkt.options.append(CPOption(otype, body[off + 2 : off + olen]))
                off += olen
        else:
            pkt.data = body
        return pkt


def ppp_frame(proto: int, body: bytes) -> bytes:
    """PPP payload inside a PPPoE session frame (no HDLC framing on PPPoE)."""
    return struct.pack(">H", proto) + body


def parse_ppp(payload: bytes) -> tuple[int, bytes]:
    if len(payload) < 2:
        raise ValueError("PPP payload truncated")
    return struct.unpack(">H", payload[:2])[0], payload[2:]


ETH_P_8021Q = 0x8100
ETH_P_8021AD = 0x88A8


def eth_frame(dst: bytes, src: bytes, ethertype: int, payload: bytes,
              vlans: list[int] | None = None) -> bytes:
    """L2 frame; vlans = [outer_vid] (802.1Q) or [outer_vid, inner_vid] (QinQ).
    `bng_tpu_torch.frames.eth_header` is this frame with no payload."""
    hdr = dst + src
    if vlans:
        if len(vlans) == 2:
            hdr += struct.pack(">HH", ETH_P_8021AD, vlans[0])
            hdr += struct.pack(">HH", ETH_P_8021Q, vlans[1])
        else:
            hdr += struct.pack(">HH", ETH_P_8021Q, vlans[0])
    return hdr + struct.pack(">H", ethertype) + payload


def parse_eth(frame: bytes) -> tuple[bytes, bytes, int, bytes]:
    if len(frame) < 14:
        raise ValueError("ethernet frame truncated")
    return frame[0:6], frame[6:12], struct.unpack(">H", frame[12:14])[0], frame[14:]


def parse_eth_vlan(frame: bytes) -> tuple[bytes, bytes, int, bytes, list[int]]:
    """parse_eth that strips 802.1Q/802.1ad tags (subscriber frames are
    typically S/C-tagged; parity with parse_packet_headers'
    VLAN/QinQ handling in the DHCP fast path)."""
    dst, src, etype, payload = parse_eth(frame)
    vlans: list[int] = []
    while etype in (ETH_P_8021Q, ETH_P_8021AD) and len(payload) >= 4:
        tci, etype = struct.unpack(">HH", payload[:4])
        vlans.append(tci & 0x0FFF)
        payload = payload[4:]
    return dst, src, etype, payload, vlans


def pppoe_session_frame(dst: bytes, src: bytes, session_id: int, proto: int, body: bytes,
                        vlans: list[int] | None = None) -> bytes:
    """A PPPoE session-stage frame carrying one PPP packet."""
    return eth_frame(dst, src, ETH_PPPOE_SESSION,
                     PPPoEPacket(code=CODE_SESSION, session_id=session_id,
                                 payload=ppp_frame(proto, body)).encode(), vlans)


def pppoe_padi_frame(src: bytes, host_uniq: bytes = b"", vlans: list[int] | None = None) -> bytes:
    """A PADI discovery broadcast (Service-Name any, optional Host-Uniq)."""
    tags = [Tag(TAG_SERVICE_NAME)] + ([Tag(TAG_HOST_UNIQ, host_uniq)] if host_uniq else [])
    return eth_frame(b"\xff" * 6, src, ETH_PPPOE_DISCOVERY,
                     PPPoEPacket(code=CODE_PADI, payload=serialize_tags(tags)).encode(), vlans)
