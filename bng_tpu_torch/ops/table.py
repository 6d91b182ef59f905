"""Device cuckoo tables and their host mirrors (port of `bng_tpu/ops/table.py`).

Device state is bucket-packed exactly as in the JAX package: one
[WAYS*KW]-word probe row per bucket (each way's K key words, then the
used flag at word K), a [stash, KW] stash, and [S, V] value rows with
S = nbuckets*WAYS + stash. All words are int32 tensors holding the uint32
bits (see the package docstring).

The host is the single writer: `HostTable` (numpy) inserts, deletes and
relocates, and drains bounded `TableUpdate` batches that `apply_update`
scatters into the device tensors IN PLACE (the JAX step returns new
arrays from a donated scatter instead). Lookups go through K1
(`ops/probe.py`): `device_lookup` launches the CUDA kernel for a CUDA
tensor and takes the plain version for a CPU tensor. The port has no
implementation selector.

A table may be hash-sharded over N shards (`TableGeom.axis`/`n_shards`,
as in the reference): each shard holds an independent cuckoo table of
the keys `shard_owner` gives it, and `sharded_lookup` probes each key on
its owner through a bounded exchange (`parallel/exchange.py`), with the
reference's per-destination capacity and punt semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bng_tpu_torch.ops.hashing import MASK32, SEED1, SEED2, hash_words, u32
from bng_tpu_torch.ops.probe import WAYS, probe, probe_plain

MAX_KICKS = 128  # bounded cuckoo eviction walk (host side)


def way_stride(key_words: int) -> int:
    """Words per way in the packed probe rows: key words + used flag,
    rounded up to a multiple of 8."""
    return ((key_words + 1 + 7) // 8) * 8


class TableState(NamedTuple):
    """Device-side table tensors (all int32 words)."""

    krows: torch.Tensor  # [NB, WAYS*KW] packed bucket probe rows
    stash_rows: torch.Tensor  # [stash, KW] packed stash probe rows
    vals: torch.Tensor  # [S, V] value words


class TableUpdate(NamedTuple):
    """A bounded batch of dirty rows; indices >= the target's length are
    padding and write nothing (JAX's mode="drop")."""

    bidx: torch.Tensor  # [U] int64 bucket indices
    brows: torch.Tensor  # [U, WAYS*KW] replacement bucket rows
    sidx: torch.Tensor  # [U] int64 stash-local indices
    srows: torch.Tensor  # [U, KW] replacement stash rows
    idx: torch.Tensor  # [U] int64 global slots (value rows)
    vals: torch.Tensor  # [U, V]


class LookupResult(NamedTuple):
    found: torch.Tensor  # [B] bool
    slot: torch.Tensor  # [B] int32 (valid where found; b1*4 on a miss)
    vals: torch.Tensor  # [B, V] int32 words (zeros where not found)


class ShardedLookupResult(NamedTuple):
    found: torch.Tensor  # [B] bool
    slot: torch.Tensor  # [B] int32, owner-local
    vals: torch.Tensor  # [B, V] int32 words (zeros where not found)
    # the lane overflowed its destination's exchange capacity and was not
    # probed (found=False there too): the slow path treats it as a miss to
    # retry, not a definitive miss
    punted: torch.Tensor


class TableGeom(NamedTuple):
    """Static geometry of one table, plus optional hash-sharding.

    axis=None: the table is local to its shard. axis set: the table is
    hash-sharded over `n_shards` shards and a lookup rides the bounded
    key/result exchange (`sharded_lookup`)."""

    nbuckets: int
    stash: int
    axis: str | None = None
    n_shards: int = 1
    # per-destination exchange capacity = ceil(b/N) * capacity_factor,
    # rounded up to 8 lanes; lanes past it punt. factor >= N reproduces
    # the never-punting worst-case exchange
    capacity_factor: float = 2.0


class ShardedTable(NamedTuple):
    """One shard's handle on a hash-sharded table during a sharded step:
    every shard's state (each on its own device), the index of the shard
    whose lanes look up, and the exchange that carries keys to their
    owners and results back."""

    shards: tuple  # TableState per shard
    index: int
    exchange: object  # parallel/exchange.py


# shard-owner hash seed, distinct from the cuckoo bucket seeds so shard
# routing and in-table placement are independent
SEED_SHARD = 0xC2B2AE35


def shard_owner(query_words, n_shards: int):
    """Owner shard of each key: mix(key) % n_shards. Host (numpy uint32 or
    int64 arrays) and device (int32 word tensors) both call this; routing
    agrees with the reference bit for bit. Returns int64."""
    if isinstance(query_words[0], torch.Tensor):
        words = [u32(w) for w in query_words]
    else:
        words = [np.asarray(w).astype(np.int64) & MASK32 for w in query_words]
    return hash_words(words, SEED_SHARD) % n_shards


def exchange_capacity(b: int, g: TableGeom) -> int:
    """Per-destination lane capacity of the sharded exchange for a local
    batch of b lanes: factor x the balanced share, 8-aligned, capped at b."""
    return min(b, max(8, int(-(-b // g.n_shards) * g.capacity_factor + 7) & ~7))


def scatter_set_drop(dst, idx, src, col: int | None = None):
    """In place: dst[idx] = src (or dst[idx, col] = src) for in-range idx;
    lanes whose idx is out of range write nothing.

    A boolean-mask gather would need a host sync on the card. Instead the
    out-of-range lanes are parked on the target of the first in-range
    lane, carrying that lane's value (or, when no lane is in range, on
    row 0 carrying row 0's current value). Correct whenever in-range lanes
    that share a target carry the same value, which every caller
    guarantees (the same condition under which the JAX scatter is
    deterministic). The first lane is picked with `index_select`: indexing
    with a 0-d CUDA tensor would read it back to the host."""
    n = dst.shape[0]
    if n == 0:
        return dst
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < n)
    first = keep.to(torch.uint8).argmax().view(1)
    any_keep = keep.any()
    zero = torch.zeros((), dtype=torch.int64, device=idx.device)
    park = torch.where(any_keep, idx.index_select(0, first), zero)
    target = dst[:, col] if col is not None else dst
    park_val = torch.where(any_keep, src.index_select(0, first), target[:1])
    idx = torch.where(keep, idx, park)
    keep_b = keep.view(-1, *([1] * (src.dim() - 1)))
    src = torch.where(keep_b, src, park_val)
    if col is None:
        dst.index_put_((idx,), src)
    else:
        dst.index_put_((idx, torch.full_like(idx, col)), src)
    return dst


def apply_update(state: TableState, upd: TableUpdate) -> TableState:
    """Scatter dirty rows into the device table in place (three row scatters)."""
    scatter_set_drop(state.krows, upd.bidx, upd.brows)
    scatter_set_drop(state.stash_rows, upd.sidx, upd.srows)
    scatter_set_drop(state.vals, upd.idx, upd.vals)
    return state


def device_lookup(state: TableState, query, nbuckets: int, stash: int) -> LookupResult:
    """Batched probe through K1. query: [B, K] int32 key words."""
    return LookupResult(*probe(state.krows, state.stash_rows, state.vals,
                               query.to(torch.int32).contiguous(), nbuckets, stash))


def lookup(state, query, g: TableGeom) -> LookupResult:
    """Local probe, or the sharded exchange when `g` names a shard axis."""
    if g.axis is None or g.n_shards == 1:
        return device_lookup(state, query, g.nbuckets, g.stash)
    return sharded_lookup(state, query, g)


def sharded_lookup(state: ShardedTable, query, g: TableGeom) -> ShardedLookupResult:
    """The reference's `sharded_lookup` for the lanes of shard `state.index`.

    1. owner = shard_owner(key) per lane;
    2. keys pack into an [N, C, K] per-destination buffer, C =
       exchange_capacity(b). A lane's position counts the earlier lanes of
       this shard bound for the same owner; lanes at position >= C punt
       (found=False, punted=True) and are not probed;
    3. the exchange carries each owner its [C, K] rows, the owner probes
       its own table with K1 (padding rows are zero keys, probed too), and
       the results come back packed as V+2 words (vals, found, slot);
    4. lane i reads its (owner, position) cell.
    Bit for bit the reference's result, slot words of punted lanes
    included (the cell at position C-1)."""
    b, K = query.shape
    N = g.n_shards
    C = exchange_capacity(b, g)
    dev = query.device
    query = query.to(torch.int32)
    owner = shard_owner([query[:, k] for k in range(K)], N)
    onehot = (owner[:, None] == torch.arange(N, device=dev)[None, :]).to(torch.int64)
    pos = (onehot.cumsum(0) - 1).gather(1, owner[:, None])[:, 0]
    fits = pos < C
    flat = torch.where(fits, owner * C + pos, N * C)  # overflow lanes land on a spare row
    req = torch.zeros((N * C + 1, K), dtype=torch.int32, device=dev)
    req.index_copy_(0, flat, query)
    recv = state.exchange.send(state.index, req[: N * C].view(N, C, K))
    resp = []
    for o, rows in enumerate(recv):
        s = state.shards[o]
        found, slot, vals = probe(s.krows, s.stash_rows, s.vals, rows.contiguous(),
                                  g.nbuckets, g.stash)
        resp.append(torch.cat([vals, found.to(torch.int32)[:, None], slot[:, None]], dim=1))
    packed = state.exchange.receive(state.index, resp)  # [N, C, V+2] on this shard's device
    V = packed.shape[2] - 2
    cell = packed[owner, pos.clamp(max=C - 1)]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return ShardedLookupResult(
        found=(cell[:, V] != 0) & fits,
        slot=cell[:, V + 1],
        vals=torch.where(fits[:, None], cell[:, :V], zero),
        punted=~fits,
    )


def xla_lookup(state: TableState, query, nbuckets: int, stash: int) -> LookupResult:
    """The plain version of K1 on any device (the JAX `xla_lookup`)."""
    return LookupResult(*probe_plain(state.krows, state.stash_rows, state.vals,
                                     query.to(torch.int32).contiguous(), nbuckets, stash))


PINNED_UPLOAD_MAX = 16 << 20  # bytes; larger uploads are startup table loads


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> a tensor on `device` that never aliases `a`.

    On the card an array of at most PINNED_UPLOAD_MAX bytes is copied into
    pinned host memory and sent with an async copy: the host does not
    wait for work queued before it, and `a` may be rewritten as soon as
    this returns (the pinned copy is the transfer's source, and the
    caching host allocator holds it until the transfer is done). Larger
    arrays take the plain copy, which waits for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda" and t.nbytes <= PINNED_UPLOAD_MAX:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


class PinnedStage:
    """A persistent host staging buffer that uploads copy from.

    On the card the buffer is pinned and an upload is an async copy with an
    event recorded behind it; `acquire()` hands the host view back for
    rewriting only once that event has passed, so a batch whose copy is
    still queued is never overwritten (a rewrite that had to wait counts in
    `waits`). On the CPU it is a plain buffer and an upload a copy. `host`
    is the numpy view; uint32 words travel as int32 (the same bits)."""

    def __init__(self, shape, dtype, device):
        self.device = torch.device(device)
        host = np.zeros(shape, dtype=dtype)
        t = torch.from_numpy(host.view(np.int32) if host.dtype == np.uint32 else host)
        if self.device.type == "cuda":
            t = t.pin_memory()
        self.tensor = t
        self.host = t.numpy().view(host.dtype)
        # one event, recorded again behind each upload
        self._event = torch.cuda.Event() if self.device.type == "cuda" else None
        self._pending = False
        self.waits = 0

    def acquire(self) -> np.ndarray:
        """The host view, once the last upload from it has run."""
        if self._pending:
            self._pending = False
            if not self._event.query():
                self.waits += 1
                self._event.synchronize()
        return self.host

    def _guard(self) -> None:
        if self._event is not None:
            self._event.record()
            self._pending = True

    def upload_into(self, dst: torch.Tensor) -> torch.Tensor:
        """Copy the buffer into the device tensor `dst` (same shape and dtype)."""
        dst.copy_(self.tensor, non_blocking=True)
        self._guard()
        return dst

    def upload(self) -> torch.Tensor:
        """A new device tensor holding the buffer (never aliasing it)."""
        out = self.tensor.to(self.device, non_blocking=True, copy=True)
        self._guard()
        return out


def words_to_device(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy -> int32 word tensor (bit-identical) on `device`.
    Always a copy: device tensors are written in place and must never
    alias the host mirror."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return to_device(a, device)


class HostTable:
    """Host-authoritative mirror of one device table (numpy, single writer).

    A copy of `bng_tpu/ops/table.py:HostTable`: the same insert/delete
    sequence gives byte-identical rows, including the cuckoo kick walk's
    `np.random.default_rng(0xB46)`, and the same checkpoint arrays.

    `compat_val_pad_from` lists older value widths this table's layout is
    a pure zero-pad of: a checkpoint with such rows restores zero-padded
    (`restore_arrays`).
    """

    def __init__(self, nbuckets: int, key_words: int, val_words: int,
                 stash: int = 64, name: str = "",
                 compat_val_pad_from: tuple[int, ...] = ()):
        if nbuckets & (nbuckets - 1):
            raise ValueError("nbuckets must be a power of two")
        self.nbuckets = nbuckets
        self.K = key_words
        self.KW = way_stride(key_words)
        self.V = val_words
        self.stash = stash
        self.name = name
        self.compat_val_pad_from = tuple(compat_val_pad_from)
        S = nbuckets * WAYS + stash
        self.S = S
        self.keys = np.zeros((S, key_words), dtype=np.uint32)
        self.vals = np.zeros((S, val_words), dtype=np.uint32)
        self.used = np.zeros((S,), dtype=np.uint32)
        self.count = 0
        self._dirty: set[int] = set()
        self._dirty_all = False  # set by large bulk_insert: full resync needed
        self._rng = np.random.default_rng(0xB46)
        self._empty_updates: dict = {}  # (max_slots, device) -> TableUpdate

    def _buckets(self, key: np.ndarray) -> tuple[int, int]:
        words = [key[k: k + 1].astype(np.int64) for k in range(self.K)]
        m = self.nbuckets - 1
        return int((hash_words(words, SEED1) & m)[0]), int((hash_words(words, SEED2) & m)[0])

    def _find_slot(self, key: np.ndarray) -> int | None:
        b1, b2 = self._buckets(key)
        for b in (b1, b2):
            for w in range(WAYS):
                s = b * WAYS + w
                if self.used[s] and np.array_equal(self.keys[s], key):
                    return s
        base = self.nbuckets * WAYS
        for s in range(base, base + self.stash):
            if self.used[s] and np.array_equal(self.keys[s], key):
                return s
        return None

    def _place(self, s: int, key: np.ndarray, val: np.ndarray) -> None:
        self.keys[s] = key
        self.vals[s] = val
        self.used[s] = 1
        self._dirty.add(s)

    def insert(self, key, val) -> int:
        """Insert or update. Returns the slot index."""
        key = np.asarray(key, dtype=np.uint32).reshape(self.K)
        val = np.asarray(val, dtype=np.uint32).reshape(self.V)
        s = self._find_slot(key)
        if s is not None:  # update in place
            self.vals[s] = val
            self._dirty.add(s)
            return s

        cur_key, cur_val = key, val
        moves: list[tuple[int, np.ndarray, np.ndarray]] = []  # for rollback
        for _kick in range(MAX_KICKS):
            b1, b2 = self._buckets(cur_key)
            for b in (b1, b2):
                for w in range(WAYS):
                    slot = b * WAYS + w
                    if not self.used[slot]:
                        self._place(slot, cur_key, cur_val)
                        self.count += 1
                        return self._find_slot(key)
            b = b1 if self._rng.integers(2) == 0 else b2
            w = int(self._rng.integers(WAYS))
            slot = b * WAYS + w
            evict_key = self.keys[slot].copy()
            evict_val = self.vals[slot].copy()
            self._place(slot, cur_key, cur_val)
            moves.append((slot, evict_key, evict_val))
            cur_key, cur_val = evict_key, evict_val

        base = self.nbuckets * WAYS
        for s in range(base, base + self.stash):
            if not self.used[s]:
                self._place(s, cur_key, cur_val)
                self.count += 1
                return self._find_slot(key)

        for slot, old_key, old_val in reversed(moves):
            self._place(slot, old_key, old_val)
        raise RuntimeError(f"table {self.name!r} full (count={self.count})")

    def bulk_insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Vectorized initial build: 8 placement passes (2 buckets x 4 ways,
        first wins per slot), then the cuckoo-kick path for the residue.
        Keys must be unique and new. A large build abandons delta sync."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint32).reshape(-1, self.K))
        vals = np.ascontiguousarray(np.asarray(vals, dtype=np.uint32).reshape(-1, self.V))
        n = len(keys)
        if n == 0:
            return
        words = [keys[:, k].astype(np.int64) for k in range(self.K)]
        m = self.nbuckets - 1
        b1 = hash_words(words, SEED1) & m
        b2 = hash_words(words, SEED2) & m

        unplaced = np.ones((n,), dtype=bool)
        placed_slots: list[np.ndarray] = []
        for side in (b1, b2):
            for w in range(WAYS):
                idxs = np.nonzero(unplaced)[0]
                if len(idxs) == 0:
                    break
                slot = side[idxs] * WAYS + w
                free = self.used[slot] == 0
                idxs, slot = idxs[free], slot[free]
                if len(idxs) == 0:
                    continue
                uq_slot, first = np.unique(slot, return_index=True)
                take = idxs[first]
                self.keys[uq_slot] = keys[take]
                self.vals[uq_slot] = vals[take]
                self.used[uq_slot] = 1
                unplaced[take] = False
                placed_slots.append(uq_slot)
        self.count += sum(len(s) for s in placed_slots)

        for i in np.nonzero(unplaced)[0]:
            self.insert(keys[i], vals[i])

        if n > self.stash:
            self._dirty.clear()
            self._dirty_all = True
        else:
            for s in placed_slots:
                self._dirty.update(int(x) for x in s)

    def delete(self, key) -> bool:
        key = np.asarray(key, dtype=np.uint32).reshape(self.K)
        s = self._find_slot(key)
        if s is None:
            return False
        self.used[s] = 0
        self.keys[s] = 0
        self.vals[s] = 0
        self.count -= 1
        self._dirty.add(s)
        return True

    def find_slots(self, keys, chunk: int = 1 << 16) -> np.ndarray:
        """`_find_slot` over many keys at once: each key's slot (the first
        match in its b1 ways, then its b2 ways, then the stash) or -1."""
        keys = np.asarray(keys, dtype=np.uint32).reshape(-1, self.K)
        out = np.full((len(keys),), -1, dtype=np.int64)
        m = self.nbuckets - 1
        ways = np.arange(WAYS)
        base = self.nbuckets * WAYS
        for lo in range(0, len(keys), chunk):
            q = keys[lo: lo + chunk]
            words = [q[:, k].astype(np.int64) for k in range(self.K)]
            b1, b2 = hash_words(words, SEED1) & m, hash_words(words, SEED2) & m
            cand = np.concatenate([b1[:, None] * WAYS + ways, b2[:, None] * WAYS + ways], axis=1)
            hit = (self.used[cand] != 0) & (self.keys[cand] == q[:, None, :]).all(axis=2)
            got = np.where(hit.any(axis=1), cand[np.arange(len(q)), hit.argmax(axis=1)], -1)
            for i in np.nonzero(got < 0)[0]:  # the few misses: try the stash
                st = np.nonzero((self.used[base:] != 0) & (self.keys[base:] == q[i]).all(axis=1))[0]
                if len(st):
                    got[i] = base + st[0]
            out[lo: lo + len(q)] = got
        return out

    def lookup(self, key) -> np.ndarray | None:
        key = np.asarray(key, dtype=np.uint32).reshape(self.K)
        s = self._find_slot(key)
        return self.vals[s].copy() if s is not None else None

    def update_val_words(self, key, word_idx: int, words) -> bool:
        """Patch specific value words of an existing entry."""
        key = np.asarray(key, dtype=np.uint32).reshape(self.K)
        s = self._find_slot(key)
        if s is None:
            return False
        words = np.atleast_1d(np.asarray(words, dtype=np.uint32))
        self.vals[s, word_idx: word_idx + len(words)] = words
        self._dirty.add(s)
        return True

    # -- device synchronization --
    def _pack_bucket_rows(self, buckets: np.ndarray, mask_dirty: bool = False) -> np.ndarray:
        """Packed [len(buckets), WAYS*KW] probe rows. mask_dirty: ways whose
        slot is still dirty read used=0 (their value rows have not shipped)."""
        nb = len(buckets)
        rows = np.zeros((nb, WAYS * self.KW), dtype=np.uint32)
        r3 = rows.reshape(nb, WAYS, self.KW)
        slots = buckets[:, None] * WAYS + np.arange(WAYS)[None, :]
        r3[:, :, : self.K] = self.keys[slots]
        used = self.used[slots]
        if mask_dirty and self._dirty:
            still_dirty = np.isin(slots, np.fromiter(self._dirty, dtype=np.int64,
                                                     count=len(self._dirty)))
            used = np.where(still_dirty, 0, used)
        r3[:, :, self.K] = used
        return rows

    def _pack_stash_rows(self, sidx: np.ndarray) -> np.ndarray:
        rows = np.zeros((len(sidx), self.KW), dtype=np.uint32)
        g = self.nbuckets * WAYS + sidx
        rows[:, : self.K] = self.keys[g]
        rows[:, self.K] = self.used[g]
        return rows

    def device_state(self, device) -> TableState:
        """Full upload (startup / resync)."""
        self._dirty.clear()
        self._dirty_all = False
        return TableState(
            krows=words_to_device(self._pack_bucket_rows(np.arange(self.nbuckets)), device),
            stash_rows=words_to_device(self._pack_stash_rows(np.arange(self.stash)), device),
            vals=words_to_device(self.vals, device),
        )

    def dirty_count(self) -> int:
        return self.S if self._dirty_all else len(self._dirty)

    def mark_dirty(self, slots) -> int:
        """Queue slots for the next bounded drain without touching their
        rows (the delta replay of a blue/green swap). Returns the number
        of newly queued slots."""
        before = len(self._dirty)
        self._dirty.update(int(s) for s in slots)
        return len(self._dirty) - before

    def make_update(self, max_slots: int, device) -> TableUpdate:
        """Drain up to max_slots dirty slots into a fixed-size TableUpdate
        (padding rows parked at NB / stash / S). The remainder stays queued."""
        if self._dirty_all:
            raise RuntimeError(
                f"table {self.name!r}: bulk_insert invalidated delta sync; "
                "call device_state() for a full upload first")
        take = sorted(self._dirty)[:max_slots]
        self._dirty.difference_update(take)
        base = self.nbuckets * WAYS
        b_take = sorted({s // WAYS for s in take if s < base})
        s_take = [s - base for s in take if s >= base]

        U = max_slots
        bidx = np.full((U,), self.nbuckets, dtype=np.int64)
        brows = np.zeros((U, WAYS * self.KW), dtype=np.uint32)
        sidx = np.full((U,), self.stash, dtype=np.int64)
        srows = np.zeros((U, self.KW), dtype=np.uint32)
        idx = np.full((U,), self.S, dtype=np.int64)
        vv = np.zeros((U, self.V), dtype=np.uint32)
        if b_take:
            bs = np.asarray(b_take, dtype=np.int64)
            bidx[: len(bs)] = bs
            brows[: len(bs)] = self._pack_bucket_rows(bs, mask_dirty=True)
        if s_take:
            ss = np.asarray(s_take, dtype=np.int64)
            sidx[: len(ss)] = ss
            srows[: len(ss)] = self._pack_stash_rows(ss)
        n = len(take)
        if n:
            ts = np.asarray(take, dtype=np.int64)
            idx[:n] = ts
            vv[:n] = self.vals[ts]
        return TableUpdate(
            bidx=words_to_device(bidx, device), brows=words_to_device(brows, device),
            sidx=words_to_device(sidx, device), srows=words_to_device(srows, device),
            idx=words_to_device(idx, device), vals=words_to_device(vv, device),
        )

    def empty_update(self, max_slots: int, device) -> TableUpdate:
        """An all-padding TableUpdate (applying it writes nothing), built
        without touching dirty tracking and kept per (size, device): the
        scheduler's no-drain bulk steps ship it so that pending deltas wait
        for the next drain, at no host-to-device traffic."""
        key = (max_slots, str(device))
        upd = self._empty_updates.get(key)
        if upd is None:
            U = max_slots
            upd = self._empty_updates[key] = TableUpdate(
                bidx=words_to_device(np.full((U,), self.nbuckets, dtype=np.int64), device),
                brows=words_to_device(np.zeros((U, WAYS * self.KW), dtype=np.uint32), device),
                sidx=words_to_device(np.full((U,), self.stash, dtype=np.int64), device),
                srows=words_to_device(np.zeros((U, self.KW), dtype=np.uint32), device),
                idx=words_to_device(np.full((U,), self.S, dtype=np.int64), device),
                vals=words_to_device(np.zeros((U, self.V), dtype=np.uint32), device),
            )
        return upd

    # -- checkpoint (runtime/checkpoint.py) --
    def checkpoint_geom(self) -> dict:
        """The geometry a checkpoint must match: slots mean nothing at
        another shape."""
        return {"nbuckets": self.nbuckets, "key_words": self.K,
                "val_words": self.V, "stash": self.stash}

    def checkpoint_arrays(self) -> dict[str, np.ndarray]:
        """The whole mirror, slot-exact (a restore needs no rehash)."""
        return {"keys": self.keys, "vals": self.vals, "used": self.used}

    def restore_arrays(self, arrays: dict[str, np.ndarray], geom: dict) -> int:
        """Overwrite the mirror from checkpoint arrays; ValueError on any
        geometry, shape or dtype mismatch. The one sanctioned mismatch: a
        val_words listed in `compat_val_pad_from` restores its rows
        zero-padded. Abandons delta tracking like a bulk build, so a full
        upload must follow. Returns the restored row count."""
        live = self.checkpoint_geom()
        pad_vals_from = None
        if geom != live:
            narrow = dict(geom)
            vw = narrow.pop("val_words", None)
            wide = dict(live)
            wide.pop("val_words")
            if narrow == wide and vw in self.compat_val_pad_from:
                pad_vals_from = int(vw)
            else:
                raise ValueError(
                    f"table {self.name!r}: checkpoint geometry {geom} != "
                    f"live geometry {live}")
        for name, target in (("keys", self.keys), ("vals", self.vals), ("used", self.used)):
            src = arrays[name]
            expect = target.shape
            if name == "vals" and pad_vals_from is not None:
                expect = (target.shape[0], pad_vals_from)
            if src.shape != expect or src.dtype != target.dtype:
                raise ValueError(
                    f"table {self.name!r}: checkpoint array {name!r} is "
                    f"{src.dtype}{src.shape}, expected {target.dtype}{expect}")
            if name == "vals" and pad_vals_from is not None:
                target[:] = 0
                target[:, :pad_vals_from] = src
            else:
                target[:] = src
        self.count = int(np.count_nonzero(self.used))
        self._dirty.clear()
        self._dirty_all = True
        return self.count

    def lookup_batch_host(self, queries: np.ndarray) -> np.ndarray:
        """Reference host-side batched lookup (for tests)."""
        out = np.zeros((len(queries), self.V), dtype=np.uint32)
        for i, q in enumerate(queries):
            v = self.lookup(q)
            if v is not None:
                out[i] = v
        return out
