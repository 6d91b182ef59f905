"""DHCPv6 wire codec (RFC 8415).

The port's copy of `bng_tpu/control/dhcpv6/protocol.py` (jax-free).

Parity: pkg/dhcpv6/protocol.go:166-453 — message header (type +
transaction-id), TLV options, DUID, IA_NA/IA_PD containers with nested
IAAddress/IAPrefix options, status codes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# message types (RFC 8415 §7.3)
SOLICIT = 1
ADVERTISE = 2
REQUEST = 3
CONFIRM = 4
RENEW = 5
REBIND = 6
REPLY = 7
RELEASE = 8
DECLINE = 9
RECONFIGURE = 10
INFORMATION_REQUEST = 11
RELAY_FORW = 12
RELAY_REPL = 13

# option codes (RFC 8415 §21)
OPT_CLIENTID = 1
OPT_SERVERID = 2
OPT_RELAY_MSG = 9  # RFC 8415 §21.10 — the encapsulated client message
OPT_INTERFACE_ID = 18  # RFC 8415 §21.18 — echoed verbatim in the reply
OPT_IA_NA = 3
OPT_IA_TA = 4
OPT_IAADDR = 5
OPT_ORO = 6
OPT_PREFERENCE = 7
OPT_ELAPSED_TIME = 8
OPT_UNICAST = 12
OPT_STATUS_CODE = 13
OPT_RAPID_COMMIT = 14
OPT_DNS_SERVERS = 23
OPT_DOMAIN_LIST = 24
OPT_IA_PD = 25
OPT_IAPREFIX = 26

# status codes (RFC 8415 §21.13)
STATUS_SUCCESS = 0
STATUS_UNSPEC_FAIL = 1
STATUS_NO_ADDRS_AVAIL = 2
STATUS_NO_BINDING = 3
STATUS_NOT_ON_LINK = 4
STATUS_USE_MULTICAST = 5
STATUS_NO_PREFIX_AVAIL = 6

# DUID types (RFC 8415 §11)
DUID_LLT = 1
DUID_EN = 2
DUID_LL = 3


@dataclass
class DUID:
    duid_type: int
    data: bytes  # type-specific body

    def encode(self) -> bytes:
        return struct.pack(">H", self.duid_type) + self.data

    @classmethod
    def decode(cls, raw: bytes) -> "DUID":
        if len(raw) < 2:
            raise ValueError("DUID truncated")
        return cls(struct.unpack(">H", raw[:2])[0], raw[2:])


def generate_duid_ll(mac: bytes, hw_type: int = 1) -> DUID:
    """DUID-LL from a MAC (parity: server.go:1028 GenerateDUID)."""
    return DUID(DUID_LL, struct.pack(">H", hw_type) + mac)


@dataclass
class IAAddress:
    """IA Address option (RFC 8415 §21.6)."""

    address: bytes  # 16 bytes
    preferred: int = 0
    valid: int = 0
    options: list[tuple[int, bytes]] = field(default_factory=list)

    def encode(self) -> bytes:
        body = self.address + struct.pack(">II", self.preferred, self.valid)
        body += encode_options(self.options)
        return body

    @classmethod
    def decode(cls, raw: bytes) -> "IAAddress":
        if len(raw) < 24:
            raise ValueError("IAADDR truncated")
        pref, valid = struct.unpack(">II", raw[16:24])
        return cls(raw[:16], pref, valid, decode_options(raw[24:]))


@dataclass
class IAPrefix:
    """IA Prefix option (RFC 8415 §21.22)."""

    prefix: bytes  # 16 bytes
    prefix_len: int = 0
    preferred: int = 0
    valid: int = 0
    options: list[tuple[int, bytes]] = field(default_factory=list)

    def encode(self) -> bytes:
        body = struct.pack(">IIB", self.preferred, self.valid, self.prefix_len)
        body += self.prefix + encode_options(self.options)
        return body

    @classmethod
    def decode(cls, raw: bytes) -> "IAPrefix":
        if len(raw) < 25:
            raise ValueError("IAPREFIX truncated")
        pref, valid, plen = struct.unpack(">IIB", raw[:9])
        return cls(raw[9:25], plen, pref, valid, decode_options(raw[25:]))


@dataclass
class IANA:
    """IA_NA container (RFC 8415 §21.4)."""

    iaid: int
    t1: int = 0
    t2: int = 0
    addresses: list[IAAddress] = field(default_factory=list)
    status: tuple[int, str] | None = None

    def encode(self) -> bytes:
        body = struct.pack(">III", self.iaid, self.t1, self.t2)
        for a in self.addresses:
            enc = a.encode()
            body += struct.pack(">HH", OPT_IAADDR, len(enc)) + enc
        if self.status is not None:
            s = struct.pack(">H", self.status[0]) + self.status[1].encode()
            body += struct.pack(">HH", OPT_STATUS_CODE, len(s)) + s
        return body

    @classmethod
    def decode(cls, raw: bytes) -> "IANA":
        if len(raw) < 12:
            raise ValueError("IA_NA truncated")
        iaid, t1, t2 = struct.unpack(">III", raw[:12])
        ia = cls(iaid, t1, t2)
        for code, data in decode_options(raw[12:]):
            if code == OPT_IAADDR:
                ia.addresses.append(IAAddress.decode(data))
            elif code == OPT_STATUS_CODE and len(data) >= 2:
                ia.status = (struct.unpack(">H", data[:2])[0],
                             data[2:].decode("utf-8", "replace"))
        return ia


@dataclass
class IAPD:
    """IA_PD container (RFC 8415 §21.21)."""

    iaid: int
    t1: int = 0
    t2: int = 0
    prefixes: list[IAPrefix] = field(default_factory=list)
    status: tuple[int, str] | None = None

    def encode(self) -> bytes:
        body = struct.pack(">III", self.iaid, self.t1, self.t2)
        for p in self.prefixes:
            enc = p.encode()
            body += struct.pack(">HH", OPT_IAPREFIX, len(enc)) + enc
        if self.status is not None:
            s = struct.pack(">H", self.status[0]) + self.status[1].encode()
            body += struct.pack(">HH", OPT_STATUS_CODE, len(s)) + s
        return body

    @classmethod
    def decode(cls, raw: bytes) -> "IAPD":
        if len(raw) < 12:
            raise ValueError("IA_PD truncated")
        iaid, t1, t2 = struct.unpack(">III", raw[:12])
        ia = cls(iaid, t1, t2)
        for code, data in decode_options(raw[12:]):
            if code == OPT_IAPREFIX:
                ia.prefixes.append(IAPrefix.decode(data))
            elif code == OPT_STATUS_CODE and len(data) >= 2:
                ia.status = (struct.unpack(">H", data[:2])[0],
                             data[2:].decode("utf-8", "replace"))
        return ia


def encode_options(options: list[tuple[int, bytes]]) -> bytes:
    out = bytearray()
    for code, data in options:
        out += struct.pack(">HH", code, len(data)) + data
    return bytes(out)


def decode_options(raw: bytes) -> list[tuple[int, bytes]]:
    out = []
    off = 0
    while off + 4 <= len(raw):
        code, length = struct.unpack(">HH", raw[off : off + 4])
        off += 4
        if off + length > len(raw):
            raise ValueError("option length exceeds buffer")
        out.append((code, raw[off : off + length]))
        off += length
    return out


@dataclass
class DHCPv6Message:
    msg_type: int
    transaction_id: int  # 24-bit
    options: list[tuple[int, bytes]] = field(default_factory=list)

    def encode(self) -> bytes:
        hdr = struct.pack(">I", (self.msg_type << 24) | (self.transaction_id & 0xFFFFFF))
        return hdr + encode_options(self.options)

    @classmethod
    def decode(cls, raw: bytes) -> "DHCPv6Message":
        if len(raw) < 4:
            raise ValueError("DHCPv6 message truncated")
        word = struct.unpack(">I", raw[:4])[0]
        return cls(word >> 24, word & 0xFFFFFF, decode_options(raw[4:]))

    # -- helpers --
    def get(self, code: int) -> bytes | None:
        for c, d in self.options:
            if c == code:
                return d
        return None

    def get_all(self, code: int) -> list[bytes]:
        return [d for c, d in self.options if c == code]

    def add(self, code: int, data: bytes) -> None:
        self.options.append((code, data))

    @property
    def client_duid(self) -> bytes | None:
        return self.get(OPT_CLIENTID)

    @property
    def server_duid(self) -> bytes | None:
        return self.get(OPT_SERVERID)

    def ia_nas(self) -> list[IANA]:
        return [IANA.decode(d) for d in self.get_all(OPT_IA_NA)]

    def ia_pds(self) -> list[IAPD]:
        return [IAPD.decode(d) for d in self.get_all(OPT_IA_PD)]

    def has_rapid_commit(self) -> bool:
        return self.get(OPT_RAPID_COMMIT) is not None

    def add_ia_na(self, ia: IANA) -> None:
        self.add(OPT_IA_NA, ia.encode())

    def add_ia_pd(self, ia: IAPD) -> None:
        self.add(OPT_IA_PD, ia.encode())

    def add_status(self, code: int, msg: str = "") -> None:
        self.add(OPT_STATUS_CODE, struct.pack(">H", code) + msg.encode())


@dataclass
class RelayMessage:
    """RFC 8415 §9: Relay-Forward/Relay-Reply framing.

    Parity: the reference defines the same shape (protocol.go:104-111)
    — hop-count + link-address + peer-address + options, with the
    client's message nested in OPT_RELAY_MSG (possibly through a chain
    of relays). The fixed header is 34 bytes vs the client messages' 4.
    """

    msg_type: int  # RELAY_FORW | RELAY_REPL
    hop_count: int
    link_address: bytes  # 16
    peer_address: bytes  # 16
    options: list[tuple[int, bytes]] = field(default_factory=list)

    def encode(self) -> bytes:
        if len(self.link_address) != 16 or len(self.peer_address) != 16:
            raise ValueError("relay addresses must be 16 bytes")
        return (bytes([self.msg_type, self.hop_count & 0xFF])
                + self.link_address + self.peer_address
                + encode_options(self.options))

    @classmethod
    def decode(cls, raw: bytes) -> "RelayMessage":
        if len(raw) < 34:
            raise ValueError("relay message truncated")
        if raw[0] not in (RELAY_FORW, RELAY_REPL):
            raise ValueError(f"not a relay message: type {raw[0]}")
        return cls(raw[0], raw[1], raw[2:18], raw[18:34],
                   decode_options(raw[34:]))

    def get(self, code: int) -> bytes | None:
        for c, d in self.options:
            if c == code:
                return d
        return None
