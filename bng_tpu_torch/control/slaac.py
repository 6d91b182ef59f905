"""SLAAC Router Advertisement daemon (radvd role).

The port's copy of `bng_tpu/control/slaac.py` (jax-free).

Parity: pkg/slaac/radvd.go — Server (:49), buildRA (:315-378),
prefix/RDNSS/DNSSL options (:380-457); types.go EUI-64 (:124-148) and
stable-privacy address generation (:150).

Tick-driven: tick(now) emits periodic RAs; handle_rs() answers router
solicitations. Frames are full Ethernet+IPv6+ICMPv6 with checksum, ready
for the engine's TX path.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

# ICMPv6 types
ICMP6_RS = 133
ICMP6_RA = 134

# NDP option types
NDP_OPT_SRC_LLADDR = 1
NDP_OPT_PREFIX_INFO = 3
NDP_OPT_MTU = 5
NDP_OPT_RDNSS = 25
NDP_OPT_DNSSL = 31

ALL_NODES_MAC = bytes.fromhex("333300000001")
ALL_NODES_IP6 = bytes.fromhex("ff020000000000000000000000000001")


def eui64_iid(mac: bytes) -> bytes:
    """EUI-64 interface identifier (parity: types.go:124-148)."""
    return bytes([mac[0] ^ 0x02]) + mac[1:3] + b"\xff\xfe" + mac[3:6]


def eui64_address(prefix: bytes, mac: bytes) -> bytes:
    """prefix(8B used) + EUI-64 iid."""
    return prefix[:8] + eui64_iid(mac)


def stable_privacy_iid(prefix: bytes, mac: bytes, secret: bytes,
                       dad_counter: int = 0) -> bytes:
    """RFC 7217 stable-privacy IID (parity: types.go:150)."""
    h = hashlib.sha256(prefix[:8] + mac + struct.pack(">I", dad_counter) + secret).digest()
    iid = bytearray(h[:8])
    iid[0] &= ~0x02  # clear universal/local bit
    return bytes(iid)


def link_local(mac: bytes) -> bytes:
    return bytes.fromhex("fe80000000000000") + eui64_iid(mac)


def _icmp6_checksum(src: bytes, dst: bytes, payload: bytes) -> int:
    """ICMPv6 checksum over the IPv6 pseudo-header (RFC 8200 §8.1)."""
    pseudo = src + dst + struct.pack(">I", len(payload)) + b"\x00\x00\x00\x3a"
    data = pseudo + payload
    if len(data) & 1:
        data += b"\x00"
    s = sum(struct.unpack(f">{len(data) // 2}H", data))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


@dataclass
class PrefixConfig:
    """One advertised prefix (parity: radvd.go Prefix config)."""

    prefix: bytes  # 16 bytes
    prefix_len: int = 64
    on_link: bool = True
    autonomous: bool = True  # A flag: SLAAC allowed
    valid_lifetime: int = 86400
    preferred_lifetime: int = 14400


@dataclass
class SLAACConfig:
    server_mac: bytes = b"\x02\xbb\x00\x00\x00\x01"
    prefixes: list[PrefixConfig] = field(default_factory=list)
    managed: bool = False  # M flag: addresses via DHCPv6
    other_config: bool = False  # O flag: other config via DHCPv6
    router_lifetime: int = 1800
    reachable_time_ms: int = 0
    retrans_timer_ms: int = 0
    cur_hop_limit: int = 64
    mtu: int = 0  # 0 = don't advertise
    rdnss: list[bytes] = field(default_factory=list)  # 16B each
    rdnss_lifetime: int = 3600
    dnssl: list[str] = field(default_factory=list)
    interval_s: float = 200.0  # MaxRtrAdvInterval default range


@dataclass
class SLAACStats:
    ra_sent: int = 0
    rs_received: int = 0
    periodic: int = 0


class SLAACServer:
    def __init__(self, config: SLAACConfig):
        self.config = config
        self.stats = SLAACStats()
        self._last_ra = 0.0
        self.ll_addr = link_local(config.server_mac)

    # ---- option encoders (parity: radvd.go:380-457) ----
    def _prefix_option(self, p: PrefixConfig) -> bytes:
        flags = (0x80 if p.on_link else 0) | (0x40 if p.autonomous else 0)
        return struct.pack(">BBBBIII", NDP_OPT_PREFIX_INFO, 4, p.prefix_len,
                           flags, p.valid_lifetime, p.preferred_lifetime,
                           0) + p.prefix

    def _rdnss_option(self) -> bytes:
        n = len(self.config.rdnss)
        length = 1 + 2 * n
        return struct.pack(">BBHI", NDP_OPT_RDNSS, length, 0,
                           self.config.rdnss_lifetime) + b"".join(self.config.rdnss)

    def _dnssl_option(self) -> bytes:
        out = bytearray()
        for d in self.config.dnssl:
            for label in d.rstrip(".").split("."):
                out += bytes([len(label)]) + label.encode()
            out += b"\x00"
        pad = (-len(out)) % 8
        out += b"\x00" * pad
        # RFC 6106 §5.2: length in 8-octet units incl. the 8-byte header
        length = 1 + len(out) // 8
        return struct.pack(">BBHI", NDP_OPT_DNSSL, length, 0,
                           self.config.rdnss_lifetime) + bytes(out)

    def build_ra(self) -> bytes:
        """ICMPv6 RA payload (parity: buildRA radvd.go:315-378)."""
        c = self.config
        flags = (0x80 if c.managed else 0) | (0x40 if c.other_config else 0)
        body = struct.pack(">BBHBBHII", ICMP6_RA, 0, 0, c.cur_hop_limit,
                           flags, c.router_lifetime,
                           c.reachable_time_ms, c.retrans_timer_ms)
        # source link-layer address option
        body += struct.pack(">BB", NDP_OPT_SRC_LLADDR, 1) + c.server_mac
        if c.mtu:
            body += struct.pack(">BBHI", NDP_OPT_MTU, 1, 0, c.mtu)
        for p in c.prefixes:
            body += self._prefix_option(p)
        if c.rdnss:
            body += self._rdnss_option()
        if c.dnssl:
            body += self._dnssl_option()
        return body

    def build_ra_frame(self, dst_mac: bytes = ALL_NODES_MAC,
                       dst_ip: bytes = ALL_NODES_IP6) -> bytes:
        """Full Ethernet+IPv6+ICMPv6 RA frame with checksum."""
        payload = bytearray(self.build_ra())
        csum = _icmp6_checksum(self.ll_addr, dst_ip, bytes(payload))
        payload[2:4] = struct.pack(">H", csum)
        ip6 = struct.pack(">IHBB", 0x60000000, len(payload), 58, 255)
        ip6 += self.ll_addr + dst_ip
        eth = dst_mac + self.config.server_mac + b"\x86\xdd"
        return eth + ip6 + bytes(payload)

    # ---- RS handling + periodic ticks ----
    def handle_rs(self, src_mac: bytes, src_ip: bytes) -> bytes:
        """Solicited RA: unicast if the client has a source address
        (parity: radvd.go solicited path)."""
        self.stats.rs_received += 1
        self.stats.ra_sent += 1
        unspecified = src_ip == b"\x00" * 16
        if unspecified:
            return self.build_ra_frame()
        return self.build_ra_frame(dst_mac=src_mac, dst_ip=src_ip)

    def handle_frame(self, frame: bytes) -> bytes | None:
        """Engine PASS-lane entry: answer RS frames."""
        if len(frame) < 54 + 4 or frame[12:14] != b"\x86\xdd":
            return None
        if frame[20] != 58:  # next header ICMPv6
            return None
        icmp_off = 54
        if frame[icmp_off] != ICMP6_RS:
            return None
        return self.handle_rs(frame[6:12], frame[22:38])

    def tick(self, now: float) -> list[bytes]:
        # first tick always advertises (radvd sends initial RAs on start)
        if self._last_ra == 0.0 or now - self._last_ra >= self.config.interval_s:
            self._last_ra = now
            self.stats.ra_sent += 1
            self.stats.periodic += 1
            return [self.build_ra_frame()]
        return []
