"""Internet checksums over [B] int64 lanes (port of `bng_tpu/ops/checksum.py`).

16-bit fields are held in host order; one's-complement sums are byte-order
agnostic, so host-order arithmetic gives byte-identical packets once the
bytes are composed.
"""

from __future__ import annotations

import torch


def fold16(s):
    """Fold a one's-complement accumulator to 16 bits."""
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    return s


def csum_finish(s):
    return (~fold16(s)) & 0xFFFF


def ipv4_header_checksum(words):
    """Checksum from a list of 16-bit field values (the checksum field as 0)."""
    s = torch.zeros_like(words[0])
    for w in words:
        s = s + (w & 0xFFFF)
    return csum_finish(s)


def csum_update32(csum, old32, new32):
    """Incremental checksum update for a changed 32-bit value."""
    s = (~csum) & 0xFFFF
    s = s + ((~old32) & 0xFFFF)
    s = s + ((~(old32 >> 16)) & 0xFFFF)
    s = s + (new32 & 0xFFFF)
    s = s + (new32 >> 16)
    return (~fold16(s)) & 0xFFFF


def csum_update16(csum, old16, new16):
    s = (~csum) & 0xFFFF
    s = s + ((~old16) & 0xFFFF)
    s = s + (new16 & 0xFFFF)
    return (~fold16(s)) & 0xFFFF
