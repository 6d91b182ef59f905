"""Address helpers (copy of the parts of `bng_tpu/utils/net.py` the port uses)."""

from __future__ import annotations

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
