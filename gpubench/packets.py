"""Frames as rows of bytes, built in bulk with NumPy.

The generator makes the benchmark's input frames here and the reference
makes the frames it expects back here, so neither touches the program
under test. `discover_rows` and `flow_rows` return `(rows [n, W] uint8,
lengths [n])`; a row holds one frame from byte 0 and zeros after it.
"""

from __future__ import annotations

import numpy as np

ETH, IP4, UDP, BOOTP = 14, 20, 8, 240
DHCP_MAGIC = 0x63825363
BCAST_MAC = b"\xff" * 6
FLOW_DST_MAC = b"\x04" * 6  # the upstream router's MAC on the access side
FLOW_HDR = ETH + IP4 + UDP  # 42: a flow frame's headers, the rest is payload
DISCOVER_BOOTP = 300  # BOOTP payload of a DISCOVER, options padded
DISCOVER_LEN = ETH + IP4 + UDP + DISCOVER_BOOTP  # 342
OFFER_OPTIONS = 50  # 53, 54, 51, 1, 3, 6 (two servers), 58, 59, 255
OFFER_LEN = ETH + IP4 + UDP + BOOTP + OFFER_OPTIONS  # 332
ROW = 512  # bytes of a pool row: one frame slot of the ring


def be(values, nbytes: int) -> np.ndarray:
    """[n] unsigned ints -> [n, nbytes] big-endian bytes."""
    v = np.asarray(values, dtype=np.uint64).reshape(-1, 1)
    shifts = np.arange(nbytes - 1, -1, -1, dtype=np.uint64) * np.uint64(8)
    return ((v >> shifts) & np.uint64(0xFF)).astype(np.uint8)


def mac_bytes(macs_u48) -> np.ndarray:
    return be(macs_u48, 6)


def csum16(rows: np.ndarray) -> np.ndarray:
    """RFC 1071 checksum of each row (even width): the one's complement
    of the one's complement sum of its 16-bit big-endian words."""
    w = rows[:, 0::2].astype(np.uint64) << np.uint64(8) | rows[:, 1::2].astype(np.uint64)
    s = w.sum(axis=1)
    while (s >> np.uint64(16)).any():
        s = (s & np.uint64(0xFFFF)) + (s >> np.uint64(16))
    return (~s & np.uint64(0xFFFF)).astype(np.uint64)


def ipv4_header(src_ip, dst_ip, payload_len: int, proto: int, n: int) -> np.ndarray:
    """[n, 20] IPv4 headers (no options, TTL 64, id 0, no fragment bits)
    with their checksums."""
    h = np.zeros((n, IP4), dtype=np.uint8)
    h[:, 0], h[:, 1] = 0x45, 0
    h[:, 2:4] = be(np.full(n, IP4 + payload_len), 2)
    h[:, 8], h[:, 9] = 64, proto
    h[:, 12:16] = be(np.broadcast_to(np.asarray(src_ip, dtype=np.uint64), (n,)), 4)
    h[:, 16:20] = be(np.broadcast_to(np.asarray(dst_ip, dtype=np.uint64), (n,)), 4)
    h[:, 10:12] = be(csum16(h), 2)
    return h


def udp_checksum(ip_hdr: np.ndarray, udp: np.ndarray) -> np.ndarray:
    """UDP checksums over the IPv4 pseudo-header (0 is sent as 0xFFFF);
    `udp` holds the header with a zero checksum field and the payload."""
    n, m = udp.shape
    pseudo = np.zeros((n, 12 + m + (m & 1)), dtype=np.uint8)
    pseudo[:, 0:8] = ip_hdr[:, 12:20]
    pseudo[:, 9] = ip_hdr[:, 9]
    pseudo[:, 10:12] = be(np.full(n, m), 2)
    pseudo[:, 12:12 + m] = udp
    c = csum16(pseudo)
    return np.where(c == 0, 0xFFFF, c)


def discover_rows(macs_u48, xids) -> tuple[np.ndarray, np.ndarray]:
    """Cached-client DISCOVERs: broadcast, from 0.0.0.0:68 to
    255.255.255.255:67, BOOTREQUEST with chaddr = the source MAC, options
    53 (DISCOVER), 55 (1, 3, 6, 51, 54) and 255, padded to 300 bytes."""
    macs = mac_bytes(macs_u48)
    n = len(macs)
    rows = np.zeros((n, ROW), dtype=np.uint8)
    rows[:, 0:6] = np.frombuffer(BCAST_MAC, dtype=np.uint8)
    rows[:, 6:12] = macs
    rows[:, 12:14] = (0x08, 0x00)
    rows[:, ETH:ETH + IP4] = ipv4_header(0, 0xFFFFFFFF, UDP + DISCOVER_BOOTP, 17, n)
    u = ETH + IP4
    rows[:, u:u + 8] = be(np.array([68, 67, UDP + DISCOVER_BOOTP, 0]), 2).reshape(-1)
    d = u + UDP
    rows[:, d:d + 4] = (1, 1, 6, 0)
    rows[:, d + 4:d + 8] = be(xids, 4)
    rows[:, d + 28:d + 34] = macs
    rows[:, d + 236:d + 240] = be([DHCP_MAGIC], 4)
    rows[:, d + 240:d + 251] = (53, 1, 1, 55, 5, 1, 3, 6, 51, 54, 255)
    return rows, np.full(n, DISCOVER_LEN, dtype=np.int64)


def flow_rows(src_macs_u48, src_ips, dst_ips, sports, dports,
              frame_lens) -> tuple[np.ndarray, np.ndarray]:
    """Upstream UDP frames of established flows, each `frame_lens` bytes
    long (one length for all, or one a frame; at least FLOW_HDR), the
    payload filled with 'x' and the UDP checksum computed."""
    n = len(src_ips)
    lens = np.broadcast_to(np.asarray(frame_lens, dtype=np.int64), (n,))
    if n and (lens.min() < FLOW_HDR or lens.max() > ROW):
        raise ValueError(f"flow frames are {FLOW_HDR}..{ROW} bytes long")
    rows = np.zeros((n, ROW), dtype=np.uint8)
    rows[:, 0:6] = np.frombuffer(FLOW_DST_MAC, dtype=np.uint8)
    rows[:, 6:12] = mac_bytes(src_macs_u48)
    rows[:, 12:14] = (0x08, 0x00)
    src_ips, dst_ips = np.asarray(src_ips), np.asarray(dst_ips)
    sports, dports = np.asarray(sports), np.asarray(dports)
    u = ETH + IP4
    sizes = np.unique(lens)
    for flen in sizes:
        # one size: work on the rows in place, not on a gathered copy
        sel = slice(None) if len(sizes) == 1 else np.nonzero(lens == flen)[0]
        m = len(lens[sel])
        pay = int(flen) - FLOW_HDR
        ip = ipv4_header(src_ips[sel], dst_ips[sel], UDP + pay, 17, m)
        r = rows[sel]
        r[:, ETH:ETH + IP4] = ip
        r[:, u:u + 2] = be(sports[sel], 2)
        r[:, u + 2:u + 4] = be(dports[sel], 2)
        r[:, u + 4:u + 6] = be(np.full(m, UDP + pay), 2)
        r[:, u + UDP:u + UDP + pay] = ord("x")
        r[:, u + 6:u + 8] = be(udp_checksum(ip, r[:, u:u + UDP + pay]), 2)
        if len(sizes) > 1:
            rows[sel] = r
    return rows, lens.copy()
