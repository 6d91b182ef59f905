"""DHCPv4 wire codec (RFC 2131/2132): the slow-path server's codec and the
express lane's reply templates.

A copy of `bng_tpu/control/dhcp_codec.py`: `DHCPPacket` (with its
pre-encoded option and payload fast paths), `encode_options`,
`ReplyTemplate`, `decode`, `build_request`, `ExpressWireTemplate`
(`render`, `render_batch`) and `ExpressTemplateCache`. The port keeps
one `DHCPPacket`; `frames.py` re-exports it. Byte-identical output.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from bng_tpu_torch.utils.net import ipv4_header, udp_header

DHCP_MAGIC = 0x63825363

# Message types
DISCOVER, OFFER, REQUEST, DECLINE, ACK, NAK, RELEASE, INFORM = range(1, 9)

# Option codes
OPT_PAD = 0
OPT_SUBNET_MASK = 1
OPT_ROUTER = 3
OPT_DNS = 6
OPT_HOSTNAME = 12
OPT_REQUESTED_IP = 50
OPT_LEASE_TIME = 51
OPT_MSG_TYPE = 53
OPT_SERVER_ID = 54
OPT_PARAM_REQ_LIST = 55
OPT_RENEWAL_TIME = 58
OPT_REBIND_TIME = 59
OPT_VENDOR_CLASS = 60
OPT_CLIENT_ID = 61
OPT_RELAY_AGENT_INFO = 82
OPT_END = 255

OPT82_CIRCUIT_ID = 1
OPT82_REMOTE_ID = 2


@dataclass
class DHCPPacket:
    op: int = 1  # 1=BOOTREQUEST 2=BOOTREPLY
    htype: int = 1
    hlen: int = 6
    hops: int = 0
    xid: int = 0
    secs: int = 0
    flags: int = 0
    ciaddr: int = 0
    yiaddr: int = 0
    siaddr: int = 0
    giaddr: int = 0
    chaddr: bytes = b"\x00" * 6  # client MAC (first hlen bytes)
    sname: bytes = b""
    file: bytes = b""
    options: list[tuple[int, bytes]] = field(default_factory=list)
    # pre-encoded option bytes (END included), used by encode() while
    # `options` still equals the snapshot set_options_raw() took; any
    # later change to `options` falls back to the full TLV encode
    options_raw: bytes | None = None
    _options_raw_snap: tuple | None = None
    # the whole payload pre-rendered (a ReplyTemplate render), under the
    # same snapshot guard
    encoded: bytes | None = None
    _encoded_snap: tuple | None = None

    def set_options_raw(self, raw: bytes) -> None:
        """Install pre-encoded option bytes for the CURRENT `options` list."""
        self.options_raw = raw
        self._options_raw_snap = tuple(self.options)

    def set_encoded(self, raw: bytes) -> None:
        """Install the complete pre-rendered payload for the CURRENT
        `options` list; the header fields must already match the render."""
        self.encoded = raw
        self._encoded_snap = tuple(self.options)

    @staticmethod
    def _snap_matches(snap: tuple | None, options: list) -> bool:
        return (snap is not None and len(snap) == len(options)
                and all(a is b or a == b for a, b in zip(snap, options)))

    def opt(self, code: int) -> bytes | None:
        for c, v in self.options:
            if c == code:
                return v
        return None

    @property
    def msg_type(self) -> int:
        v = self.opt(OPT_MSG_TYPE)
        return v[0] if v else 0

    @property
    def requested_ip(self) -> int:
        v = self.opt(OPT_REQUESTED_IP)
        return struct.unpack("!I", v)[0] if v and len(v) == 4 else 0

    @property
    def server_id(self) -> int:
        v = self.opt(OPT_SERVER_ID)
        return struct.unpack("!I", v)[0] if v and len(v) == 4 else 0

    def option82(self) -> tuple[bytes, bytes]:
        """(circuit_id, remote_id) from the option-82 sub-options."""
        v = self.opt(OPT_RELAY_AGENT_INFO)
        circuit, remote = b"", b""
        if not v:
            return circuit, remote
        i = 0
        while i + 2 <= len(v):
            sub, slen = v[i], v[i + 1]
            data = v[i + 2: i + 2 + slen]
            if sub == OPT82_CIRCUIT_ID:
                circuit = data
            elif sub == OPT82_REMOTE_ID:
                remote = data
            i += 2 + slen
        return circuit, remote

    def encode(self) -> bytes:
        if self.encoded is not None and self._snap_matches(self._encoded_snap, self.options):
            return self.encoded
        fixed = struct.pack("!BBBBIHHIIII", self.op, self.htype, self.hlen, self.hops,
                            self.xid, self.secs, self.flags,
                            self.ciaddr, self.yiaddr, self.siaddr, self.giaddr)
        chaddr = (self.chaddr + b"\x00" * 16)[:16]
        sname = (self.sname + b"\x00" * 64)[:64]
        bfile = (self.file + b"\x00" * 128)[:128]
        use_raw = (self.options_raw is not None
                   and self._snap_matches(self._options_raw_snap, self.options))
        opts = self.options_raw if use_raw else encode_options(self.options)
        return fixed + chaddr + sname + bfile + struct.pack("!I", DHCP_MAGIC) + opts


def encode_options(options: list[tuple[int, bytes]]) -> bytes:
    """TLV-encode an option list (END terminated)."""
    parts = []
    for code, val in options:
        if code == OPT_PAD:
            parts.append(b"\x00")
        else:
            parts.append(bytes((code, len(val))) + val)
    parts.append(bytes((OPT_END,)))
    return b"".join(parts)


# fixed-field offsets in the BOOTP payload (RFC 2131 figure 1)
_OFF_XID = 4
_OFF_SECS = 8
_OFF_FLAGS = 10
_OFF_CIADDR = 12
_OFF_YIADDR = 16
_OFF_SIADDR = 20
_OFF_GIADDR = 24
_OFF_CHADDR = 28
_OFF_MAGIC = 236
_OPTIONS_START = 240


class ReplyTemplate:
    """Preassembled BOOTREPLY payload: the 240-byte header, the magic
    cookie and the option bytes are built once; `render` copies the
    prototype and patches the per-client words (xid, secs, flags, ciaddr,
    yiaddr, giaddr, chaddr). The prototype bakes op = BOOTREPLY,
    htype/hlen, siaddr and the options (END included)."""

    __slots__ = ("_proto", "options")

    def __init__(self, options: list[tuple[int, bytes]], siaddr: int = 0,
                 options_raw: bytes | None = None):
        raw = options_raw if options_raw is not None else encode_options(options)
        proto = bytearray(_OPTIONS_START + len(raw))
        proto[0] = 2  # op: BOOTREPLY
        proto[1] = 1  # htype: Ethernet
        proto[2] = 6  # hlen
        struct.pack_into("!I", proto, _OFF_SIADDR, siaddr)
        struct.pack_into("!I", proto, _OFF_MAGIC, DHCP_MAGIC)
        proto[_OPTIONS_START:] = raw
        self._proto = bytes(proto)
        # the decoded view of the baked options, for a DHCPPacket built
        # around a render
        self.options = list(options)

    def render(self, xid: int, chaddr: bytes, yiaddr: int = 0,
               flags: int = 0, ciaddr: int = 0, giaddr: int = 0,
               secs: int = 0) -> bytes:
        buf = bytearray(self._proto)
        struct.pack_into("!I", buf, _OFF_XID, xid)
        struct.pack_into("!H", buf, _OFF_SECS, secs)
        struct.pack_into("!H", buf, _OFF_FLAGS, flags)
        struct.pack_into("!II", buf, _OFF_CIADDR, ciaddr, yiaddr)
        struct.pack_into("!I", buf, _OFF_GIADDR, giaddr)
        buf[_OFF_CHADDR: _OFF_CHADDR + 16] = (chaddr + b"\x00" * 16)[:16]
        return bytes(buf)


def decode(data: bytes) -> DHCPPacket:
    if len(data) < 240:
        raise ValueError(f"DHCP packet too short: {len(data)}")
    p = DHCPPacket()
    (p.op, p.htype, p.hlen, p.hops, p.xid, p.secs, p.flags,
     p.ciaddr, p.yiaddr, p.siaddr, p.giaddr) = struct.unpack_from("!BBBBIHHIIII", data, 0)
    p.chaddr = data[28: 28 + max(p.hlen, 6)][:16]
    p.sname = data[44:108].rstrip(b"\x00")
    p.file = data[108:236].rstrip(b"\x00")
    magic = struct.unpack_from("!I", data, 236)[0]
    if magic != DHCP_MAGIC:
        raise ValueError(f"bad DHCP magic: {magic:#x}")
    i = 240
    while i < len(data):
        code = data[i]
        if code == OPT_END:
            break
        if code == OPT_PAD:
            i += 1
            continue
        if i + 1 >= len(data):
            break
        ln = data[i + 1]
        p.options.append((code, data[i + 2: i + 2 + ln]))
        i += 2 + ln
    return p


def build_request(mac: bytes, msg_type: int, xid: int = 0x12345678, requested_ip: int = 0,
                  server_id: int = 0, ciaddr: int = 0, giaddr: int = 0,
                  broadcast: bool = False, circuit_id: bytes = b"", remote_id: bytes = b"",
                  extra_options: list[tuple[int, bytes]] | None = None) -> DHCPPacket:
    """A client DISCOVER/REQUEST/... packet."""
    p = DHCPPacket(op=1, xid=xid, chaddr=mac, ciaddr=ciaddr, giaddr=giaddr)
    if broadcast:
        p.flags = 0x8000
    p.options.append((OPT_MSG_TYPE, bytes([msg_type])))
    if requested_ip:
        p.options.append((OPT_REQUESTED_IP, struct.pack("!I", requested_ip)))
    if server_id:
        p.options.append((OPT_SERVER_ID, struct.pack("!I", server_id)))
    if extra_options:
        p.options.extend(extra_options)
    if circuit_id or remote_id:
        sub = b""
        if circuit_id:
            sub += bytes([OPT82_CIRCUIT_ID, len(circuit_id)]) + circuit_id
        if remote_id:
            sub += bytes([OPT82_REMOTE_ID, len(remote_id)]) + remote_id
        p.options.append((OPT_RELAY_AGENT_INFO, sub))
    return p


class ExpressWireTemplate:
    """Preassembled full-wire DHCP reply for the express lane.

    The express device program (`ops/express.py`) emits only the verdict,
    yiaddr and pool/lease words; everything byte-static per (pool config,
    server config, reply type) is assembled once here: the non-relayed
    IPv4+UDP header pair and the BOOTREPLY payload through a
    `ReplyTemplate`. `render` patches the per-client words and copies the
    request's tag stack: byte-identical to the device compose in
    `ops/dhcp.py` (option order 53, 54, 51, 1, 3, [6], 58, 59, END; TTL
    64, IP id 0, UDP checksum 0; relayed, broadcast or unicast
    addressing).
    """

    __slots__ = ("_src_mac", "_server_ip", "_bootp", "_l3", "_udp_len")

    def __init__(self, server_mac: bytes, server_ip: int, gateway: int,
                 dns1: int, dns2: int, lease_t: int, mask: int,
                 reply_type: int):
        opts = [
            (OPT_MSG_TYPE, bytes([reply_type])),
            (OPT_SERVER_ID, struct.pack("!I", server_ip)),
            (OPT_LEASE_TIME, struct.pack("!I", lease_t)),
            (OPT_SUBNET_MASK, struct.pack("!I", mask)),
            (OPT_ROUTER, struct.pack("!I", gateway)),
        ]
        if dns1:
            dns = struct.pack("!I", dns1)
            if dns2:
                dns += struct.pack("!I", dns2)
            opts.append((OPT_DNS, dns))
        opts.append((OPT_RENEWAL_TIME, struct.pack("!I", lease_t // 2)))
        opts.append((OPT_REBIND_TIME, struct.pack("!I", (lease_t * 7) // 8)))
        self._src_mac = server_mac
        self._server_ip = server_ip
        self._bootp = ReplyTemplate(opts, siaddr=server_ip)
        self._udp_len = 8 + len(self._bootp._proto)
        self._l3 = (ipv4_header(server_ip, 0xFFFFFFFF, self._udp_len, 17)
                    + udp_header(67, 68, len(self._bootp._proto)))

    def render(self, frame: bytes, vlan_off: int, dhcp_off: int,
               relayed: bool, use_bcast: bool, yiaddr: int) -> bytes:
        """Patch the per-client words into the prototype. xid, secs,
        flags, ciaddr, giaddr, chaddr and the VLAN tag stack are copied
        from the request `frame`, as the device compose copies them."""
        xid, secs, flags16 = struct.unpack_from("!IHH", frame, dhcp_off + 4)
        ciaddr, = struct.unpack_from("!I", frame, dhcp_off + 12)
        giaddr, = struct.unpack_from("!I", frame, dhcp_off + 24)
        chaddr = frame[dhcp_off + 28: dhcp_off + 44]
        payload = self._bootp.render(xid, chaddr, yiaddr=yiaddr, flags=flags16,
                                     ciaddr=ciaddr, giaddr=giaddr, secs=secs)
        if relayed:
            # unicast to the relay on port 67
            l3b = (ipv4_header(self._server_ip, giaddr, self._udp_len, 17)
                   + udp_header(67, 67, len(self._bootp._proto)))
            dst_mac = frame[6:12]  # the relay's source MAC
        else:
            l3b = self._l3
            dst_mac = b"\xff" * 6 if use_bcast else chaddr[:6]
        return dst_mac + self._src_mac + frame[12: 14 + vlan_off] + l3b + payload

    def render_batch(self, fmat, vlan_off: int, dhcp_off: int,
                     relayed: bool, use_bcast: bool, yiaddrs) -> list:
        """`render` over one group of requests that share vlan_off,
        dhcp_off, relayed and use_bcast: the per-client words are column
        copies from the packed request matrix `fmat` ([n, >= dhcp_off+240]
        uint8), the relayed IPv4 checksum is refolded per row, and the
        result is n bytes objects cut from one buffer. Byte-identical to
        `render`."""
        n = fmat.shape[0]
        proto = self._bootp._proto
        plen = len(proto)
        eth_l3 = 14 + vlan_off
        pb = eth_l3 + 28  # payload base (20-byte IPv4 + 8-byte UDP)
        out = np.empty((n, pb + plen), dtype=np.uint8)
        if relayed:
            out[:, 0:6] = fmat[:, 6:12]  # the relay's source MAC
        elif use_bcast:
            out[:, 0:6] = 0xFF
        else:
            out[:, 0:6] = fmat[:, dhcp_off + 28: dhcp_off + 34]  # chaddr
        out[:, 6:12] = np.frombuffer(self._src_mac, dtype=np.uint8)
        out[:, 12: eth_l3] = fmat[:, 12: eth_l3]
        if not relayed:
            out[:, eth_l3: pb] = np.frombuffer(self._l3, dtype=np.uint8)
        else:
            gi = ((fmat[:, dhcp_off + 24].astype(np.int64) << 24)
                  | (fmat[:, dhcp_off + 25].astype(np.int64) << 16)
                  | (fmat[:, dhcp_off + 26].astype(np.int64) << 8)
                  | fmat[:, dhcp_off + 27])
            total = 20 + self._udp_len
            # ipv4_header's checksum over each row's destination
            s = (0x4500 + total + ((64 << 8) | 17)
                 + (self._server_ip >> 16) + (self._server_ip & 0xFFFF)
                 + (gi >> 16) + (gi & 0xFFFF))
            s = (s & 0xFFFF) + (s >> 16)
            s = (s & 0xFFFF) + (s >> 16)
            csum = (~s) & 0xFFFF
            hdr = np.zeros((n, 20), dtype=np.uint8)
            hdr[:, 0] = 0x45
            hdr[:, 2] = total >> 8
            hdr[:, 3] = total & 0xFF
            hdr[:, 8] = 64
            hdr[:, 9] = 17
            hdr[:, 10] = csum >> 8
            hdr[:, 11] = csum & 0xFF
            hdr[:, 12:16] = np.frombuffer(self._server_ip.to_bytes(4, "big"), dtype=np.uint8)
            hdr[:, 16:20] = fmat[:, dhcp_off + 24: dhcp_off + 28]
            out[:, eth_l3: eth_l3 + 20] = hdr
            out[:, eth_l3 + 20: pb] = np.frombuffer(udp_header(67, 67, plen), dtype=np.uint8)
        out[:, pb:] = np.frombuffer(proto, dtype=np.uint8)
        # xid + secs + flags in one copy, then ciaddr, yiaddr, giaddr, chaddr
        out[:, pb + _OFF_XID: pb + _OFF_CIADDR] = (
            fmat[:, dhcp_off + _OFF_XID: dhcp_off + _OFF_CIADDR])
        out[:, pb + _OFF_CIADDR: pb + _OFF_YIADDR] = (
            fmat[:, dhcp_off + _OFF_CIADDR: dhcp_off + _OFF_YIADDR])
        out[:, pb + _OFF_YIADDR: pb + _OFF_YIADDR + 4] = (
            np.asarray(yiaddrs, dtype=">u4").view(np.uint8).reshape(n, 4))
        out[:, pb + _OFF_GIADDR: pb + _OFF_GIADDR + 4] = (
            fmat[:, dhcp_off + _OFF_GIADDR: dhcp_off + _OFF_GIADDR + 4])
        out[:, pb + _OFF_CHADDR: pb + _OFF_CHADDR + 16] = (
            fmat[:, dhcp_off + _OFF_CHADDR: dhcp_off + _OFF_CHADDR + 16])
        big = out.tobytes()
        w = pb + plen
        return [big[i * w: (i + 1) * w] for i in range(n)]


class ExpressTemplateCache:
    """Bounded cache of ExpressWireTemplates keyed by every option-relevant
    value, so a reconfigured pool or server builds a new entry and never
    serves a stale one. The lease time comes from the device-reported
    lease words, so options 51/58/59 follow the table that served the
    probe."""

    def __init__(self, maxsize: int = 1024):
        self.maxsize = maxsize
        self._cache: dict[tuple, ExpressWireTemplate] = {}

    def get(self, server_mac: bytes, server_ip: int, gateway: int,
            dns1: int, dns2: int, lease_t: int, mask: int,
            reply_type: int) -> ExpressWireTemplate:
        key = (server_mac, server_ip, gateway, dns1, dns2, lease_t, mask, reply_type)
        tmpl = self._cache.get(key)
        if tmpl is None:
            tmpl = ExpressWireTemplate(server_mac, server_ip, gateway,
                                       dns1, dns2, lease_t, mask, reply_type)
            if len(self._cache) >= self.maxsize:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = tmpl
        return tmpl
