"""RADIUS wire codec (RFC 2865/2866/5176).

The port's copy of `bng_tpu/control/radius/packet.py` (jax-free).

Parity: the role layeh.com/radius plays for pkg/radius (client.go), built
from scratch: header, TLV attributes, request/response authenticators,
User-Password crypt, Message-Authenticator (HMAC-MD5, client.go:405).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

# Codes
ACCESS_REQUEST = 1
ACCESS_ACCEPT = 2
ACCESS_REJECT = 3
ACCOUNTING_REQUEST = 4
ACCOUNTING_RESPONSE = 5
ACCESS_CHALLENGE = 11
DISCONNECT_REQUEST = 40
DISCONNECT_ACK = 41
DISCONNECT_NAK = 42
COA_REQUEST = 43
COA_ACK = 44
COA_NAK = 45

# Attribute types (subset the BNG uses)
USER_NAME = 1
USER_PASSWORD = 2
CHAP_PASSWORD = 3
NAS_IP_ADDRESS = 4
NAS_PORT = 5
SERVICE_TYPE = 6
FRAMED_IP_ADDRESS = 8
FILTER_ID = 11
REPLY_MESSAGE = 18
STATE = 24
CLASS = 25
VENDOR_SPECIFIC = 26
SESSION_TIMEOUT = 27
IDLE_TIMEOUT = 28
CALLED_STATION_ID = 30
CALLING_STATION_ID = 31
NAS_IDENTIFIER = 32
ACCT_STATUS_TYPE = 40
ACCT_DELAY_TIME = 41
ACCT_INPUT_OCTETS = 42
ACCT_OUTPUT_OCTETS = 43
ACCT_SESSION_ID = 44
ACCT_SESSION_TIME = 46
ACCT_INPUT_PACKETS = 47
ACCT_OUTPUT_PACKETS = 48
ACCT_TERMINATE_CAUSE = 49
CHAP_CHALLENGE = 60
NAS_PORT_TYPE = 61
EVENT_TIMESTAMP = 55
MESSAGE_AUTHENTICATOR = 80

# Acct-Status-Type values
ACCT_START, ACCT_STOP, ACCT_INTERIM = 1, 2, 3
# Terminate causes (RFC 2866 §5.10)
TERM_USER_REQUEST, TERM_LOST_CARRIER, TERM_IDLE_TIMEOUT, TERM_SESSION_TIMEOUT, TERM_ADMIN_RESET = 1, 2, 4, 5, 6


class RadiusPacket:
    def __init__(self, code: int, pid: int = 0, authenticator: bytes = b"\x00" * 16):
        self.code = code
        self.id = pid
        self.authenticator = authenticator
        self.attributes: list[tuple[int, bytes]] = []

    # -- attribute helpers --
    def add(self, attr_type: int, value: bytes | str | int) -> None:
        if isinstance(value, str):
            value = value.encode()
        elif isinstance(value, int):
            value = struct.pack("!I", value)
        if len(value) > 253:
            raise ValueError("attribute too long")
        self.attributes.append((attr_type, value))

    def get(self, attr_type: int) -> bytes | None:
        for t, v in self.attributes:
            if t == attr_type:
                return v
        return None

    def get_all(self, attr_type: int) -> list[bytes]:
        return [v for t, v in self.attributes if t == attr_type]

    def get_int(self, attr_type: int) -> int | None:
        v = self.get(attr_type)
        return struct.unpack("!I", v)[0] if v and len(v) == 4 else None

    def get_str(self, attr_type: int) -> str | None:
        v = self.get(attr_type)
        return v.decode(errors="replace") if v is not None else None

    # -- wire --
    def _attrs_bytes(self) -> bytes:
        out = b""
        for t, v in self.attributes:
            out += bytes([t, len(v) + 2]) + v
        return out

    def encode(self, secret: bytes = b"", request_auth: bytes | None = None,
               sign_message_authenticator: bool = False) -> bytes:
        """Encode; computes the correct (request/response/accounting)
        authenticator when `secret` is given."""
        if sign_message_authenticator:
            # placeholder first; HMAC over the packet with zeroed MA
            self.attributes = [(t, v) for t, v in self.attributes if t != MESSAGE_AUTHENTICATOR]
            self.attributes.append((MESSAGE_AUTHENTICATOR, b"\x00" * 16))
        attrs = self._attrs_bytes()
        length = 20 + len(attrs)

        if self.code == ACCESS_REQUEST:
            auth = self.authenticator  # random request authenticator
        elif self.code in (ACCOUNTING_REQUEST, DISCONNECT_REQUEST, COA_REQUEST):
            # Request Authenticator = MD5(Code+ID+Len+16 zeros+Attrs+Secret)
            hdr = struct.pack("!BBH", self.code, self.id, length)
            auth = hashlib.md5(hdr + b"\x00" * 16 + attrs + secret).digest()
            self.authenticator = auth
        else:
            # response: MD5(Code+ID+Len+RequestAuth+Attrs+Secret)
            assert request_auth is not None, "response needs the request authenticator"
            hdr = struct.pack("!BBH", self.code, self.id, length)
            auth = hashlib.md5(hdr + request_auth + attrs + secret).digest()
            self.authenticator = auth

        if sign_message_authenticator:
            hdr = struct.pack("!BBH", self.code, self.id, length)
            base = self.authenticator if self.code == ACCESS_REQUEST else auth
            mac = hmac.new(secret, hdr + base + attrs, hashlib.md5).digest()
            self.attributes[-1] = (MESSAGE_AUTHENTICATOR, mac)
            attrs = self._attrs_bytes()

        return struct.pack("!BBH", self.code, self.id, length) + self.authenticator + attrs

    @classmethod
    def decode(cls, data: bytes) -> "RadiusPacket":
        if len(data) < 20:
            raise ValueError("RADIUS packet too short")
        code, pid, length = struct.unpack_from("!BBH", data, 0)
        if length > len(data) or length < 20:
            raise ValueError("bad RADIUS length")
        p = cls(code, pid, data[4:20])
        i = 20
        while i + 2 <= length:
            t, ln = data[i], data[i + 1]
            if ln < 2 or i + ln > length:
                raise ValueError("bad attribute length")
            p.attributes.append((t, data[i + 2 : i + ln]))
            i += ln
        return p

    # -- crypto --
    def verify_response(self, secret: bytes, request_auth: bytes, raw: bytes) -> bool:
        """Validate a response authenticator against the original request."""
        hdr = raw[:4]
        attrs = raw[20 : struct.unpack("!H", raw[2:4])[0]]
        expect = hashlib.md5(hdr + request_auth + attrs + secret).digest()
        return hmac.compare_digest(expect, self.authenticator)

    def verify_request(self, secret: bytes, raw: bytes) -> bool:
        """Validate a CoA/Disconnect/Accounting request authenticator
        (parity: coa.go:486-502)."""
        hdr = raw[:4]
        attrs = raw[20 : struct.unpack("!H", raw[2:4])[0]]
        expect = hashlib.md5(hdr + b"\x00" * 16 + attrs + secret).digest()
        return hmac.compare_digest(expect, self.authenticator)


def encrypt_password(password: bytes, secret: bytes, request_auth: bytes) -> bytes:
    """RFC 2865 §5.2 User-Password obfuscation."""
    if len(password) % 16:
        password += b"\x00" * (16 - len(password) % 16)
    out = b""
    prev = request_auth
    for i in range(0, len(password), 16):
        key = hashlib.md5(secret + prev).digest()
        block = bytes(a ^ b for a, b in zip(password[i : i + 16], key))
        out += block
        prev = block
    return out


def decrypt_password(blob: bytes, secret: bytes, request_auth: bytes) -> bytes:
    out = b""
    prev = request_auth
    for i in range(0, len(blob), 16):
        key = hashlib.md5(secret + prev).digest()
        out += bytes(a ^ b for a, b in zip(blob[i : i + 16], key))
        prev = blob[i : i + 16]
    return out.rstrip(b"\x00")


def new_request_authenticator() -> bytes:
    return os.urandom(16)
