"""Bucket-packed QoS policy table (port of `bng_tpu/ops/qtable.py`).

Every 4-way bucket is four consecutive 8-word way rows, and a
subscriber's policy and token state live in its one row:

    rows[nbuckets*4, 8] int32 words:
        +0 key (subscriber ip)   +1 flags (bit0 = used)
        +2 rate_lo  +3 rate_hi   +4 burst  +5 priority
        +6 tokens (float32 bits)  +7 last_us

The QoS stage writes token state back IN PLACE (`write_token_rows`);
host policy sync scatters whole way rows at changed slots only
(`apply_qupdate`, also in place). Tokens are reinterpreted with
`.view(torch.float32)` / `.view(torch.int32)`, never value-cast.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bng_tpu_torch.ops.hashing import SEED1, SEED2, hash_words, u32
from bng_tpu_torch.ops.table import words_to_device, scatter_set_drop

WAYS = 4
SLOT_W = 8  # words per way row
ROW_W = WAYS * SLOT_W  # 32 — one bucket
MAX_KICKS = 128

(QW_KEY, QW_FLAGS, QW_RATE_LO, QW_RATE_HI, QW_BURST, QW_PRIORITY,
 QW_TOKENS, QW_LAST_US) = range(8)
FLAG_USED = 1


def _f2u(v: float) -> int:
    return int(np.array(v, dtype=np.float32).view(np.uint32))


def _u2f(u: int) -> float:
    return float(np.array(u, dtype=np.uint32).view(np.float32))


class QTableState(NamedTuple):
    rows: torch.Tensor  # [NB*4, 8] int32 packed way rows


class QTableUpdate(NamedTuple):
    """Bounded dirty-slot scatter; slot >= NB*4 rows are padding."""

    slot: torch.Tensor  # [U] int64 global slot indices
    rows: torch.Tensor  # [U, 8] int32 replacement way rows


class QTableGeom(NamedTuple):
    """Static geometry. axis/n_shards mirror TableGeom so the chip-local
    guard in `ops/qos.py` reads the same fields (QoS tables are placed by
    subscriber affinity, never hash-sharded)."""

    nbuckets: int
    axis: str | None = None
    n_shards: int = 1


class QLookup(NamedTuple):
    found: torch.Tensor  # [B] bool
    slot: torch.Tensor  # [B] int64 global slot (valid where found)
    row: torch.Tensor  # [B, 8] int32 the selected way row (stale where not found)
    rate_lo: torch.Tensor  # [B] int64 (uint32 value)
    rate_hi: torch.Tensor
    burst: torch.Tensor
    priority: torch.Tensor
    tokens: torch.Tensor  # [B] float32
    last_us: torch.Tensor  # [B] int64 (uint32 value)


def apply_qupdate(state: QTableState, upd: QTableUpdate) -> QTableState:
    """Scatter dirty way rows in place (one row scatter)."""
    scatter_set_drop(state.rows, upd.slot, upd.rows)
    return state


def qlookup(state: QTableState, ip, g: QTableGeom) -> QLookup:
    """2 wide bucket-row gathers + lane compares. ip: [B] int64 keys."""
    Bsz = ip.shape[0]
    mask = g.nbuckets - 1
    b1 = hash_words([ip], SEED1) & mask
    b2 = hash_words([ip], SEED2) & mask
    wide = state.rows.view(g.nbuckets, ROW_W)
    cand = torch.cat([wide[b1].view(Bsz, WAYS, SLOT_W),
                      wide[b2].view(Bsz, WAYS, SLOT_W)], dim=1)  # [B, 2W, 8]
    match = (u32(cand[:, :, QW_KEY]) == ip[:, None]) & ((cand[:, :, QW_FLAGS] & FLAG_USED) != 0)
    found = match.any(dim=1)
    first = match.to(torch.uint8).argmax(dim=1)  # 0 when none
    sel = cand[torch.arange(Bsz, device=ip.device), first]  # [B, 8]
    bucket = torch.where(first < WAYS, b1, b2)
    slot = bucket * WAYS + (first % WAYS)
    return QLookup(
        found=found,
        slot=slot,
        row=sel,
        rate_lo=u32(sel[:, QW_RATE_LO]),
        rate_hi=u32(sel[:, QW_RATE_HI]),
        burst=u32(sel[:, QW_BURST]),
        priority=u32(sel[:, QW_PRIORITY]),
        tokens=sel[:, QW_TOKENS].contiguous().view(torch.float32),
        last_us=u32(sel[:, QW_LAST_US]),
    )


def write_token_rows(state: QTableState, wslot, row, tokens, now_us) -> QTableState:
    """Head lanes rewrite their way row with updated tokens/last_us, in
    place — one [B, 8] row scatter. wslot >= NB*4: the lane writes nothing.
    now_us: int64 scalar tensor (uint32 value)."""
    Bsz = wslot.shape[0]
    tok_u = tokens.to(torch.float32).contiguous().view(torch.int32)
    now_b = now_us.to(torch.int32).expand(Bsz)
    new_row = torch.cat([row[:, :QW_TOKENS], tok_u[:, None], now_b[:, None]], dim=1)
    scatter_set_drop(state.rows, wslot, new_row)
    return state


class HostQTable:
    """Host-authoritative mirror of one QoS table (numpy, single writer);
    a copy of `bng_tpu/ops/qtable.py:HostQTable`."""

    def __init__(self, nbuckets: int, name: str = ""):
        if nbuckets & (nbuckets - 1):
            raise ValueError("nbuckets must be a power of two")
        self.nbuckets = nbuckets
        self.S = nbuckets * WAYS
        self.name = name
        self.rows = np.zeros((self.S, SLOT_W), dtype=np.uint32)
        self.count = 0
        self._dirty: set[int] = set()
        self._dirty_all = False
        self._empty_updates: dict = {}  # (max_slots, device) -> QTableUpdate
        self._rng = np.random.default_rng(0xB46)

    def _buckets(self, ip: int) -> tuple[int, int]:
        k = np.asarray([ip & 0xFFFFFFFF], dtype=np.int64)
        m = self.nbuckets - 1
        return int((hash_words([k], SEED1) & m)[0]), int((hash_words([k], SEED2) & m)[0])

    def _find(self, ip: int) -> int | None:
        b1, b2 = self._buckets(ip)
        for b in (b1, b2):
            for w in range(WAYS):
                s = self.rows[b * WAYS + w]
                if (s[QW_FLAGS] & 1) and int(s[QW_KEY]) == (ip & 0xFFFFFFFF):
                    return b * WAYS + w
        return None

    def _place(self, slot: int, ip: int, rate_bps: int, burst: int,
               priority: int, start_full: bool) -> int:
        s = self.rows[slot]
        s[QW_KEY] = ip & 0xFFFFFFFF
        s[QW_FLAGS] = 1
        s[QW_RATE_LO] = rate_bps & 0xFFFFFFFF
        s[QW_RATE_HI] = (rate_bps >> 32) & 0xFFFFFFFF
        s[QW_BURST] = burst
        s[QW_PRIORITY] = priority
        s[QW_TOKENS] = _f2u(float(burst if start_full else 0))
        s[QW_LAST_US] = 0
        self._dirty.add(slot)
        return slot

    def insert(self, ip: int, rate_bps: int, burst: int, priority: int = 0,
               start_full: bool = True) -> int:
        """Install or update a policy. Returns the global slot index."""
        hit = self._find(ip)
        if hit is not None:
            return self._place(hit, ip, rate_bps, burst, priority, start_full)

        cur = (ip, rate_bps, burst, priority, start_full)
        moves: list[tuple[int, np.ndarray]] = []
        for _ in range(MAX_KICKS):
            b1, b2 = self._buckets(cur[0])
            for b in (b1, b2):
                for w in range(WAYS):
                    if not (self.rows[b * WAYS + w][QW_FLAGS] & 1):
                        self._place(b * WAYS + w, *cur)
                        self.count += 1
                        hit = self._find(ip)
                        if hit is None:
                            raise RuntimeError(f"qos table {self.name!r}: lost {ip:#x}")
                        return hit
            # both buckets full: evict a random way; a relocated entry
            # refills to full burst (the host cannot read device tokens)
            b = b1 if self._rng.integers(2) == 0 else b2
            w = int(self._rng.integers(WAYS))
            slot = b * WAYS + w
            s = self.rows[slot].copy()
            moves.append((slot, s))
            ev_rate = int(s[QW_RATE_LO]) | (int(s[QW_RATE_HI]) << 32)
            self._place(slot, *cur)
            cur = (int(s[QW_KEY]), ev_rate, int(s[QW_BURST]), int(s[QW_PRIORITY]), True)

        for slot, s in reversed(moves):
            self.rows[slot] = s
            self._dirty.add(slot)
        raise RuntimeError(
            f"qos table {self.name!r} full (count={self.count}, "
            f"nbuckets={self.nbuckets}); size buckets >= subscribers/2")

    def delete(self, ip: int) -> bool:
        slot = self._find(ip)
        if slot is None:
            return False
        self.rows[slot] = 0
        self.count -= 1
        self._dirty.add(slot)
        return True

    def lookup(self, ip: int) -> dict | None:
        slot = self._find(ip)
        if slot is None:
            return None
        s = self.rows[slot]
        return {
            "slot": slot,
            "rate_bps": int(s[QW_RATE_LO]) | (int(s[QW_RATE_HI]) << 32),
            "burst": int(s[QW_BURST]),
            "priority": int(s[QW_PRIORITY]),
            "tokens": _u2f(int(s[QW_TOKENS])),
        }

    def bulk_insert(self, ips: np.ndarray, rates_bps: np.ndarray,
                    bursts: np.ndarray, priorities: np.ndarray | None = None,
                    start_full: bool = True) -> None:
        """Vectorized initial build (keys must be new)."""
        ips = np.asarray(ips, dtype=np.uint32).reshape(-1)
        rates = np.asarray(rates_bps, dtype=np.uint64).reshape(-1)
        bursts = np.asarray(bursts, dtype=np.uint32).reshape(-1)
        prios = (np.zeros_like(ips) if priorities is None
                 else np.asarray(priorities, dtype=np.uint32).reshape(-1))
        n = len(ips)
        if n == 0:
            return
        m = self.nbuckets - 1
        words = [ips.astype(np.int64)]
        b1 = hash_words(words, SEED1) & m
        b2 = hash_words(words, SEED2) & m

        flags = self.rows[:, QW_FLAGS].reshape(self.nbuckets, WAYS)
        unplaced = np.ones((n,), dtype=bool)
        for side in (b1, b2):
            for w in range(WAYS):
                idxs = np.nonzero(unplaced)[0]
                if len(idxs) == 0:
                    break
                bb = side[idxs]
                free = flags[bb, w] == 0
                idxs, bb = idxs[free], bb[free]
                if len(idxs) == 0:
                    continue
                uq_b, firsti = np.unique(bb, return_index=True)
                take = idxs[firsti]
                slots = uq_b * WAYS + w
                self.rows[slots, QW_KEY] = ips[take]
                self.rows[slots, QW_FLAGS] = 1
                self.rows[slots, QW_RATE_LO] = (rates[take] & 0xFFFFFFFF).astype(np.uint32)
                self.rows[slots, QW_RATE_HI] = (rates[take] >> 32).astype(np.uint32)
                self.rows[slots, QW_BURST] = bursts[take]
                self.rows[slots, QW_PRIORITY] = prios[take]
                self.rows[slots, QW_TOKENS] = (
                    bursts[take].astype(np.float32).view(np.uint32)
                    if start_full else _f2u(0.0))
                self.rows[slots, QW_LAST_US] = 0
                unplaced[take] = False
                self.count += len(take)
                if n <= 256:  # small batches stay on the bounded-delta path
                    self._dirty.update(int(s) for s in slots)

        for i in np.nonzero(unplaced)[0]:
            self.insert(int(ips[i]), int(rates[i]), int(bursts[i]), int(prios[i]),
                        start_full)

        if n > 256:
            self._dirty.clear()
            self._dirty_all = True

    # -- checkpoint (runtime/checkpoint.py) --
    def checkpoint_geom(self) -> dict:
        return {"nbuckets": self.nbuckets}

    def checkpoint_arrays(self) -> dict[str, np.ndarray]:
        """The packed way rows carry policy and token state: one array is
        the whole mirror."""
        return {"rows": self.rows}

    def restore_arrays(self, arrays: dict[str, np.ndarray], geom: dict) -> int:
        """Overwrite the mirror from a checkpoint (ValueError on a mismatch;
        a full upload must follow). Returns the restored policy count."""
        if geom != self.checkpoint_geom():
            raise ValueError(
                f"qos table {self.name!r}: checkpoint geometry {geom} != "
                f"live geometry {self.checkpoint_geom()}")
        src = arrays["rows"]
        if src.shape != self.rows.shape or src.dtype != self.rows.dtype:
            raise ValueError(
                f"qos table {self.name!r}: checkpoint rows are {src.dtype}{src.shape}, "
                f"expected {self.rows.dtype}{self.rows.shape}")
        self.rows[:] = src
        self.count = int(np.count_nonzero(self.rows[:, QW_FLAGS] & 1))
        self._dirty.clear()
        self._dirty_all = True
        return self.count

    # -- device synchronization --
    def device_state(self, device) -> QTableState:
        self._dirty.clear()
        self._dirty_all = False
        return QTableState(rows=words_to_device(self.rows, device))

    def dirty_count(self) -> int:
        return self.S if self._dirty_all else len(self._dirty)

    def mark_dirty(self, slots) -> int:
        """Queue way rows for the next bounded drain without touching them
        (see `HostTable.mark_dirty`). Returns the newly queued count."""
        before = len(self._dirty)
        self._dirty.update(int(s) for s in slots)
        return len(self._dirty) - before

    def make_update(self, max_slots: int, device) -> QTableUpdate:
        """Drain up to max_slots dirty way rows."""
        if self._dirty_all:
            raise RuntimeError(
                f"qos table {self.name!r}: bulk_insert invalidated delta sync; "
                "call device_state() for a full upload first")
        take = sorted(self._dirty)[:max_slots]
        self._dirty.difference_update(take)
        n = len(take)
        slot = np.full((max_slots,), self.S, dtype=np.int64)
        rows = np.zeros((max_slots, SLOT_W), dtype=np.uint32)
        if n:
            ss = np.asarray(take, dtype=np.int64)
            slot[:n] = ss
            rows[:n] = self.rows[ss]
        return QTableUpdate(slot=words_to_device(slot, device), rows=words_to_device(rows, device))

    def empty_update(self, max_slots: int, device) -> QTableUpdate:
        """An all-padding QTableUpdate (a no-op scatter), built without
        touching dirty tracking and kept per (size, device) (see
        `HostTable.empty_update`)."""
        key = (max_slots, str(device))
        upd = self._empty_updates.get(key)
        if upd is None:
            upd = self._empty_updates[key] = QTableUpdate(
                slot=words_to_device(np.full((max_slots,), self.S, dtype=np.int64), device),
                rows=words_to_device(np.zeros((max_slots, SLOT_W), dtype=np.uint32), device))
        return upd
