"""lowbias32 hash mixing, bit-identical to `bng_tpu/ops/hashing.py`.

Works on torch or numpy int64 arrays holding uint32 values in [0, 2^32):
the products are split into 16-bit halves so no intermediate leaves the
signed 64-bit range, and every result is masked back to 32 bits. The host
mirrors (numpy) and the plain device code (torch) share these functions;
the CUDA kernels recompute the same mix with native uint32 wrap.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# the cuckoo table's two hash seeds (lowbias32 finalizer constants below)
SEED1 = 0x9E3779B9
SEED2 = 0x85EBCA6B

_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def u32(t):
    """int32 word tensor (uint32 bits) -> int64 value in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def mul32(h, m: int):
    """(h * m) mod 2^32 for int64 h in [0, 2^32) without int64 overflow."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & MASK32


def mix32(h):
    h = h ^ (h >> 16)
    h = mul32(h, _M1)
    h = h ^ (h >> 15)
    h = mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def hash_words(words, seed: int):
    """Order-dependent hash of a list of same-shape word arrays."""
    h = mix32(words[0] ^ seed)
    for w in words[1:]:
        h = mix32(h ^ w)
    return h
