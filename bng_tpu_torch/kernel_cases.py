"""Edge-case inputs for the port's two kernels, made from a seed with numpy.

`chip_smoke.py` holds each CUDA kernel against its plain version on every
case here, and the tier-1 tests hold the plain versions against the JAX
package (or an integer oracle) on the same cases, so the inputs agree by
construction. Arrays are numpy int32 holding uint32 bits, the port's word
convention; `torch.from_numpy` takes them as they are.

K1 (`probe_case`): tables whose stash holds used rows at scattered
positions, index 0 and index stash-1 among them, with holes left by
insert-then-delete; a table without a stash; an empty table; K = 8 with
16-word ways; V = 16; B from 1 to 8192. Every query batch mixes keys in
the buckets and in the stash, deleted keys, all-zero keys (the words of
a deleted row) and random misses, with duplicate rows.

K2 (`seg_case`): B on both sides of the one-CTA route's limit `B_ONE`,
slot ids that differ only in the top byte or the sign bit, one slot for
all lanes, a slot for every lane, a slot for every lane but 5 or 20
pairs (the main path's shape, on either side of the kernel's 32-candidate
path), 0xFFFFFFFF words in an 8192-lane bucket; each for "prefix",
"total" and "both".
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bng_tpu_torch.ops.seg_prefix import B_ONE, COMPUTE
from bng_tpu_torch.ops.table import WAYS, HostTable


class ProbeCase(NamedTuple):
    krows: np.ndarray  # [nbuckets, WAYS*KW] int32
    stash_rows: np.ndarray  # [stash, KW] int32
    vals: np.ndarray  # [nbuckets*WAYS + stash, V] int32
    query: np.ndarray  # [B, K] int32
    nbuckets: int
    stash: int


class SegCase(NamedTuple):
    slot: np.ndarray  # [B] int32
    vec: np.ndarray  # [B] int32 (uint32 bits)
    compute: str


# name -> (nbuckets, K, V, stash, fill, B); fill is "scattered" (stash
# filled, then punched), "half" (buckets at ~50% load) or "empty"
PROBE_SPECS = {
    **{f"scattered-B{B}": (4, 2, 8, 64, "scattered", B) for B in (1, 7, 8, 9, 1000)},
    "scattered-stash256-B8192": (4, 2, 8, 256, "scattered", 8192),
    "scattered-k1": (4, 1, 8, 64, "scattered", 1000),
    "scattered-k4-v8": (4, 4, 8, 64, "scattered", 1000),
    "scattered-k4-v16": (4, 4, 16, 256, "scattered", 1000),
    "scattered-k8-kw16": (4, 8, 8, 256, "scattered", 1000),
    "no-stash": (64, 2, 8, 0, "half", 1000),
    "empty-table": (64, 4, 16, 256, "empty", 1000),
    "half-load-empty-stash-B8192": (1024, 2, 8, 256, "half", 8192),
}

_MIXED = [f"mixed-B{B}" for B in (1, 31, 33, 1000, B_ONE, B_ONE + 1)]
SEG_PATTERNS = _MIXED + ["top-byte-ids", "one-slot", "own-slot", "own-slot-5-pairs",
                         "own-slot-20-pairs", "words-ffffffff-8192", "words-2^31-mixed"]
SEG_SPECS = [f"{p}/{c}" for p in SEG_PATTERNS for c in COMPUTE]


def _stash_filled(nbuckets, K, V, stash, rng):
    """Buckets half full, every stash row used, then about 2/3 of the stash
    rows deleted, rows 0 and stash-1 kept. Returns the table and the
    deleted keys.

    The stash rows are written where `HostTable.insert` puts a key once
    its kick walk gives up; going through that walk (MAX_KICKS moves per
    key) would take seconds per table."""
    t = HostTable(nbuckets, K, V, stash=stash, name="case")
    base = nbuckets * WAYS
    keys = np.unique(rng.integers(1, 2**32, size=(base // 2 + stash, K), dtype=np.uint32),
                     axis=0)
    rng.shuffle(keys)
    t.bulk_insert(keys[: base // 2], rng.integers(0, 2**32, size=(base // 2, V), dtype=np.uint32))
    for s, key in enumerate(keys[base // 2: base // 2 + stash]):
        t._place(base + s, key, rng.integers(0, 2**32, size=V, dtype=np.uint32))
        t.count += 1
    keep = rng.random(stash) < 1 / 3
    keep[[0, stash - 1]] = True
    deleted = []
    for s in np.nonzero(~keep)[0]:
        deleted.append(t.keys[base + s].copy())
        t.delete(deleted[-1])
    return t, np.array(deleted, dtype=np.uint32).reshape(-1, K)


def _queries(t, deleted, B, rng):
    """Present keys (stash rows first), deleted keys, zero keys and random
    misses, with duplicate rows."""
    base = t.nbuckets * WAYS
    used = np.nonzero(t.used)[0]
    stash_keys = t.keys[used[used >= base]]
    bucket_keys = t.keys[used[used < base]]
    K = t.K
    pools = [p for p in (stash_keys, bucket_keys, deleted,
                         np.zeros((1, K), np.uint32),
                         rng.integers(0, 2**32, size=(64, K), dtype=np.uint32)) if len(p)]
    head = [stash_keys[-1:], stash_keys[:1], np.zeros((1, K), np.uint32)]
    rows = np.stack([p[rng.integers(0, len(p), B)] for p in pools])  # [pools, B, K]
    mixed = rows[rng.integers(0, len(pools), B), np.arange(B)]
    q = np.concatenate(head + [mixed])[:B]
    dup = rng.random(B) < 0.1  # duplicate the row before
    dup[0] = False
    q[dup] = q[np.nonzero(dup)[0] - 1]
    return q


@functools.lru_cache(maxsize=None)
def probe_case(name: str) -> ProbeCase:
    nbuckets, K, V, stash, fill, B = PROBE_SPECS[name]
    rng = np.random.default_rng(sorted(PROBE_SPECS).index(name) + 1000)
    deleted = np.zeros((0, K), np.uint32)
    if fill == "scattered":
        t, deleted = _stash_filled(nbuckets, K, V, stash, rng)
    else:
        t = HostTable(nbuckets, K, V, stash=stash, name="case")
        if fill == "half":
            keys = np.unique(rng.integers(1, 2**32, size=(nbuckets * WAYS // 2, K),
                                          dtype=np.uint32), axis=0)
            t.bulk_insert(keys, rng.integers(0, 2**32, size=(len(keys), V), dtype=np.uint32))
    st = t.device_state(torch.device("cpu"))
    q = _queries(t, deleted, B, rng)
    return ProbeCase(st.krows.numpy(), st.stash_rows.numpy(), st.vals.numpy(),
                     q.view(np.int32), nbuckets, stash)


@functools.lru_cache(maxsize=None)
def seg_case(name: str) -> SegCase:
    pattern, compute = name.split("/")
    rng = np.random.default_rng(SEG_PATTERNS.index(pattern) + 2000)
    vec = None
    if pattern.startswith("mixed-B"):
        B = int(pattern[len("mixed-B"):])
        slot = rng.integers(0, 40, size=B).astype(np.int32)  # shared buckets
        slot[: B // 4] = -1 - np.arange(B // 4, dtype=np.int32)  # unique negatives
        slot[B // 4: B // 2] = 7  # one long run, interleaved below
        rng.shuffle(slot)
    elif pattern == "top-byte-ids":
        ids = np.array([0, 0x01000000, 0x7F000000, -2**31, -1], dtype=np.int64)
        slot = ids[rng.integers(0, len(ids), 1000)].astype(np.int32)
    elif pattern == "one-slot":
        slot = np.full(1000, 5, dtype=np.int32)
    elif pattern.startswith("own-slot"):
        slot = rng.permutation(np.arange(-B_ONE // 2, B_ONE // 2, dtype=np.int32) * 977)
        if pattern != "own-slot":  # "own-slot-<n>-pairs": n lanes take another lane's id
            n = int(pattern.split("-")[2])
            pick = rng.choice(B_ONE, size=2 * n, replace=False)
            slot[pick[:n]] = slot[pick[n:]]
    elif pattern == "words-ffffffff-8192":
        slot = np.full(8192, 0x12345, dtype=np.int32)
        vec = np.full(8192, -1, dtype=np.int32)  # 0xFFFFFFFF
    else:  # words-2^31-mixed: bucket sums far past 2^24
        slot = rng.integers(-3, 30, size=B_ONE).astype(np.int32)
        vec = rng.integers(0, 2**31, size=B_ONE).astype(np.int32)
    if vec is None:
        vec = rng.integers(0, 1600, size=len(slot)).astype(np.int32)
    return SegCase(slot, vec, compute)
