"""Address and header helpers (copy of the parts of `bng_tpu/utils/net.py`
and of `ipv4_header`/`udp_header` from `bng_tpu/control/packets.py` that
the port uses)."""

from __future__ import annotations

import struct

_U32 = 0xFFFFFFFF


def parse_mac(mac: str) -> bytes:
    """Parse "aa:bb:cc:dd:ee:ff" (or '-' separated) into 6 bytes."""
    parts = mac.replace("-", ":").split(":")
    if len(parts) != 6:
        raise ValueError(f"malformed MAC {mac!r}: want 6 colon-separated octets")
    try:
        return bytes(int(p, 16) for p in parts)
    except ValueError as e:
        raise ValueError(f"malformed MAC {mac!r}: {e}") from None


def mac_to_u64(mac: bytes | str) -> int:
    """6-byte MAC -> u64 key (big-endian: mac[0] is the top byte)."""
    if isinstance(mac, str):
        mac = parse_mac(mac)
    if len(mac) != 6:
        raise ValueError(f"MAC must be 6 bytes, got {len(mac)}")
    return int.from_bytes(mac, "big")


def ip_to_u32(ip: str | bytes) -> int:
    """Dotted-quad (or 4 raw bytes) to host-order u32 (10.0.0.1 -> 0x0A000001)."""
    if isinstance(ip, bytes):
        if len(ip) != 4:
            raise ValueError("need 4 bytes")
        parts = list(ip)
    else:
        parts = [int(p) for p in ip.split(".")]
    if len(parts) != 4 or any(p < 0 or p > 255 for p in parts):
        raise ValueError(f"bad IPv4 address: {ip!r}")
    return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]


def u32_to_ip(v: int) -> str:
    return f"{(v >> 24) & 0xFF}.{(v >> 16) & 0xFF}.{(v >> 8) & 0xFF}.{v & 0xFF}"


def split_u64(v: int) -> tuple[int, int]:
    """u64 -> (lo32, hi32) for storage in table key words."""
    return v & _U32, (v >> 32) & _U32


def prefix_to_mask(prefix_len: int) -> int:
    """CIDR prefix length to host-order netmask u32."""
    if prefix_len <= 0:
        return 0
    if prefix_len >= 32:
        return _U32
    return (_U32 << (32 - prefix_len)) & _U32


def ipv4_header(src_ip: int, dst_ip: int, payload_len: int, proto: int, ttl: int = 64,
                ident: int = 0, tos: int = 0) -> bytes:
    total = 20 + payload_len
    s = ((0x4500 | tos) + total + ident + ((ttl << 8) | proto)
         + (src_ip >> 16) + (src_ip & 0xFFFF) + (dst_ip >> 16) + (dst_ip & 0xFFFF))
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    return struct.pack("!BBHHHBBHII", 0x45, tos, total, ident, 0, ttl, proto,
                       (~s) & 0xFFFF, src_ip, dst_ip)


def udp_header(src_port: int, dst_port: int, payload_len: int, csum: int = 0) -> bytes:
    return struct.pack("!HHHH", src_port, dst_port, 8 + payload_len, csum)


FNV1A32_OFFSET = 0x811C9DC5
FNV1A32_PRIME = 0x01000193


def fnv1a32(data: bytes, seed: int = FNV1A32_OFFSET) -> int:
    """FNV-1a 32-bit hash (the ring's shard steering key)."""
    h = seed
    for b in data:
        h ^= b
        h = (h * FNV1A32_PRIME) & _U32
    return h
