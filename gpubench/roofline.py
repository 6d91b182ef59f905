"""The yardstick of the kernels: the chip's peaks, and the bytes each
kernel call needs, reckoned from the table geometry and the call's own
inputs with the benchmark's own hashing (whatever implements the probe).

K1 (`csrc/probe.cu`) probes a bucketized cuckoo table: for each query of
K key words, bucket b1 = lowbias32(key, SEED1), b2 = lowbias32(key,
SEED2); a key found in b1 needs one bucket row of 4 ways, anything else
(found in b2 or the stash, or missing) two. The bytes are the queries,
those bucket rows, the stash rows, the value rows of the keys found, and
the outputs (found, slot, values). K2 (`csrc/seg_prefix.cu`) reads the
segment ids and values and writes the outputs asked for; its O(B) adds
are far below the bytes' time, so the bytes bound it too.
(A copy of `chip_smoke.probe_bound_ms` and `seg_bound_ms`.)
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at its full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12,
                              "fp32_flops": 67e12, "int8_ops": 1979e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"

SEED1, SEED2 = 0x9E3779B9, 0x85EBCA6B
_M1, _M2 = 0x7FEB352D, 0x846CA68B
M32 = np.uint64(0xFFFFFFFF)
WAYS = 4


def _mix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(_M1)) & M32
    h = h ^ (h >> np.uint64(15))
    h = (h * np.uint64(_M2)) & M32
    return h ^ (h >> np.uint64(16))


def lowbias32(words: np.ndarray, seed: int) -> np.ndarray:
    """[B, K] uint32 key words -> [B] hash (lowbias32 chained over words)."""
    w = words.astype(np.uint64) & M32
    h = _mix32(w[:, 0] ^ np.uint64(seed))
    for k in range(1, w.shape[1]):
        h = _mix32(h ^ w[:, k])
    return h


def peak(card: str) -> dict:
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])


def k1_bytes(krows: np.ndarray, stash_rows: np.ndarray, V: int, query: np.ndarray) -> int:
    """Bytes one K1 call needs. krows: [nbuckets, 4*KW] uint32 key rows
    (word K of a way is its used flag); stash_rows: [stash, KW]; query:
    [B, K] uint32."""
    nb = krows.shape[0]
    Bq, K = query.shape
    stash, KW = stash_rows.shape
    q = query.astype(np.uint32)
    b1 = (lowbias32(q, SEED1) & np.uint64(nb - 1)).astype(np.int64)
    b2 = (lowbias32(q, SEED2) & np.uint64(nb - 1)).astype(np.int64)

    def hit(b):
        cand = krows[b].reshape(Bq, WAYS, KW)
        return ((cand[:, :, :K] == q[:, None, :]).all(-1) & (cand[:, :, K] != 0)).any(-1)

    in_b1 = hit(b1)
    found = in_b1 | hit(b2)
    if stash:
        found |= ((stash_rows[None, :, :K] == q[:, None, :]).all(-1)
                  & (stash_rows[None, :, K] != 0)).any(-1)
    rows = 2 * Bq - int(in_b1.sum())
    return int(Bq * K * 4 + rows * WAYS * KW * 4 + int(found.sum()) * V * 4 + stash * KW * 4
               + Bq * (1 + 4 + V * 4))


def k2_bytes(B: int, compute: str) -> int:
    """Bytes one K2 call needs: slot and value words read, outputs written."""
    outs = 2 if compute == "both" else 1
    return B * 8 + B * 4 * outs


def share_pct(nbytes: float, seconds: float, card: str) -> float | None:
    """Least time (bytes over the card's bandwidth) over the measured time, in %."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / peak(card)["hbm_bytes_per_s"]) / seconds
