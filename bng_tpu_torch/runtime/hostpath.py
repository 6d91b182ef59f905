"""Vectorized host serving path (copy of `bng_tpu/runtime/hostpath.py`).

Every per-frame classifier and field extractor on the
ring -> dispatch -> reply path, re-expressed as numpy over a [n, L] uint8
frame matrix with length and flag columns. Two rules, as in the reference:

1. **The scalar functions stay the oracle.** Each kernel here mirrors its
   scalar twin (`ring.classify_dhcp`, `ring.shard_of`, the reference's
   `admission.peek_dhcp`, `utils.net.fnv1a32`) guard for guard, pinned
   bit-identical over a frame corpus by tests/test_torch_hostpath.py.
2. **Vector handles the common case; pressure falls back to scalar.**
   Decisions with sequential coupling across frames (ring free-frame
   exhaustion or per-shard backpressure mid-batch) are taken by the
   scalar oracle.

`BNG_HOST_PATH=scalar|vector` (default `scalar`) selects the path; each
consumer (`PyRing`, `Engine`, `TieredScheduler`) resolves it once, at
construction.

`StagingPool` is the engine's frame staging: on the card its buffers are
pinned and each dispatch's upload is an async copy straight from them
(`upload`), guarded by the event recorded behind the copy, so a buffer is
rewritten only after the copy that read it has run, whatever the cycle
count. Lengths are staged as int64 (the port's lane-integer type).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import torch

    from bng_tpu_torch.ops.table import PinnedStage

# keep in sync with runtime.ring (redeclared here to avoid a circular
# import; ring.py asserts they agree)
FLAG_FROM_ACCESS = 0x1
FLAG_DHCP_CTRL = 0x2

HOST_PATHS = ("scalar", "vector")

# the default, from BNG_HOST_PATH (the reference's default: scalar)
HOST_PATH = os.environ.get("BNG_HOST_PATH", "scalar")


def resolved_host_path() -> str:
    """The host path that ring, engine and scheduler constructions take.
    Each instance keeps the path it resolved at construction: a later
    change of the variable needs new instances."""
    if HOST_PATH not in HOST_PATHS:
        raise ValueError(
            f"BNG_HOST_PATH={HOST_PATH!r}: expected one of {HOST_PATHS}")
    return HOST_PATH


# ---------------------------------------------------------------------------
# frame staging: list[bytes] -> [n, L] matrix (the SoA entry point)
# ---------------------------------------------------------------------------

def frame_lens(frames: list[bytes]) -> np.ndarray:
    return np.fromiter(map(len, frames), dtype=np.int64,
                       count=len(frames))


def pack_into(frames: list[bytes], out: np.ndarray, out_len: np.ndarray,
              lens: np.ndarray | None = None) -> int:
    """Stage a frame list into caller-owned [B, L] uint8 + length
    columns with ONE ragged gather instead of a per-frame copy loop.
    Rows [0, n) are fully written (zero beyond each frame's length:
    staging buffers are reused, stale bytes must never reach the
    device); rows beyond n are left untouched (callers track n).
    Frames longer than L raise (never truncate silently). Returns n."""
    n = len(frames)
    if n == 0:
        return 0
    L = out.shape[1]
    if lens is None:
        lens = frame_lens(frames)
    if int(lens.max()) > L:
        raise ValueError(
            f"frame of {int(lens.max())} bytes exceeds staging slot {L}")
    if int(lens.max()) == 0:
        # all-empty batch: nothing to gather (flat would be size 0 and
        # the clamped index crash) — the scalar oracle accepts
        # zero-length frames, so the packed rows are simply all zeros
        out[:n] = 0
        out_len[:n] = 0
        return n
    flat = np.frombuffer(b"".join(frames), dtype=np.uint8)
    cols = np.arange(L, dtype=np.int64)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    # single-pass ragged unpack: gather (clipped) then mask-select — a
    # boolean fancy scatter here costs 3-4x (nonzero scans)
    idx = starts[:, None] + cols[None, :]
    np.minimum(idx, flat.size - 1, out=idx)
    out[:n] = np.where(cols[None, :] < lens[:, None], flat[idx], 0)
    out_len[:n] = lens
    return n


def pack_rows(frames: list[bytes], width: int | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Fresh-matrix convenience wrapper over pack_into (corpus tests,
    one-shot callers). Width defaults to the longest frame."""
    lens = frame_lens(frames)
    w = width if width is not None else (int(lens.max()) if len(frames) else 0)
    buf = np.empty((len(frames), max(w, 1)), dtype=np.uint8)
    out_len = np.zeros((len(frames),), dtype=np.uint32)
    pack_into(frames, buf, out_len, lens=lens)
    return buf, out_len


class StagingPool:
    """Cycling pool of preallocated (pkt, length) staging pairs: no
    per-dispatch allocation and no per-frame copy loop. `depth` should
    cover the dispatches in flight plus one being staged, so that a buffer
    comes round only after its upload has run (on the card each buffer
    also waits for the event behind its last upload before it is
    rewritten). Buffers larger than `max_bytes` are not pooled: a rare
    oversized batch gets fresh arrays."""

    def __init__(self, width: int, depth: int = 4, max_bytes: int = 8 << 20,
                 device="cpu"):
        # torch only here: a slow-path fleet worker imports this module's
        # numpy kernels and must not pay a torch import
        import torch

        self.width = width
        self.depth = max(2, depth)
        self.max_bytes = max_bytes
        self.device = torch.device(device)
        self._bufs: dict[int, list] = {}
        self._next: dict[int, int] = {}
        self._owner: dict[int, PinnedStage] = {}  # id(host view) -> its buffer

    def _pair(self, B: int) -> list:
        from bng_tpu_torch.ops.table import PinnedStage

        pkt = PinnedStage((B, self.width), np.uint8, self.device)
        length = PinnedStage((B,), np.int64, self.device)
        for st in (pkt, length):
            self._owner[id(st.host)] = st
        return [pkt, length, 0]

    def ensure_depth(self, depth: int) -> None:
        """Raise the cycle length (never shrink): a consumer that keeps
        more dispatches in flight than the default declares its worst
        case. Existing rings grow in place."""
        if depth <= self.depth:
            return
        for B, ring in self._bufs.items():
            ring.extend(self._pair(B) for _ in range(depth - len(ring)))
        self.depth = depth

    def stage(self, frames: list, B: int,
              lens: np.ndarray | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
        """Pack `frames` into a pooled [B, width] pair with the rows beyond
        len(frames) zero (stale rows of the buffer's previous batch are
        cleared up to its high-water mark)."""
        n = len(frames)
        if B * self.width > self.max_bytes:
            pkt = np.zeros((B, self.width), dtype=np.uint8)
            length = np.zeros((B,), dtype=np.int64)
            pack_into(frames, pkt, length, lens=lens)
            return pkt, length
        ring = self._bufs.get(B)
        if ring is None:
            ring = self._bufs[B] = [self._pair(B) for _ in range(self.depth)]
            self._next[B] = 0
        i = self._next[B]
        self._next[B] = (i + 1) % self.depth
        pkt_st, len_st, high = ring[i]
        pkt, length = pkt_st.acquire(), len_st.acquire()
        pack_into(frames, pkt, length, lens=lens)
        if high > n:
            pkt[n:high] = 0
            length[n:high] = 0
        ring[i][2] = n
        return pkt, length

    def upload(self, a: np.ndarray) -> torch.Tensor | None:
        """A staged array on the pool's device (an async copy from its
        pinned buffer on the card), or None when `a` is not one of the
        pool's buffers."""
        st = self._owner.get(id(a))
        return st.upload() if st is not None and st.host is a else None

    @property
    def waits(self) -> int:
        """Restagings that had to wait for their buffer's last upload."""
        return sum(st.waits for st in self._owner.values())


# ---------------------------------------------------------------------------
# vectorized primitives
# ---------------------------------------------------------------------------

FNV1A32_OFFSET = np.uint32(2166136261)
FNV1A32_PRIME = np.uint32(16777619)


def fnv1a32_cols(rows: np.ndarray) -> np.ndarray:
    """FNV-1a32 over fixed-width uint8 columns ([n, K] -> [n] uint32) —
    bit-identical to utils.net.fnv1a32 on each row. K is small (6-byte
    MAC, 4-byte IP), so the byte recurrence unrolls into K vectorized
    xor/multiply steps; uint32 wraparound matches the scalar mask."""
    h = np.full(rows.shape[0], FNV1A32_OFFSET, dtype=np.uint32)
    for k in range(rows.shape[1]):
        h ^= rows[:, k]
        h *= FNV1A32_PRIME
    return h


def _gather(buf: np.ndarray, off: np.ndarray) -> np.ndarray:
    """buf[i, off[i]] with out-of-range offsets clipped (the scalar
    oracles guard every read with a length check FIRST; clipped lanes
    are always masked dead by the same guard here)."""
    return buf[np.arange(buf.shape[0]), np.minimum(off, buf.shape[1] - 1)]


def _u16g(buf: np.ndarray, off: np.ndarray) -> np.ndarray:
    return ((_gather(buf, off).astype(np.uint32) << 8)
            | _gather(buf, off + 1))


def _u32g(buf: np.ndarray, off: np.ndarray) -> np.ndarray:
    return ((_u16g(buf, off).astype(np.uint64) << 16) | _u16g(buf, off + 2))


def _l3_walk(buf: np.ndarray, lens: np.ndarray, strict: bool
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The shared 0-2-VLAN-tag walk. Returns (l3_off, ethertype, alive).

    `strict` mirrors the two scalar spellings of the truncated-tag edge:
    classify_dhcp/_bootp_off `return 0/None` when a tag's inner
    ethertype is cut off (lane dead), while shard_of `break`s with the
    tag ethertype still in hand (lane alive, falls through to the MAC
    hash because a tag value never matches 0x0800/0x8864)."""
    n = buf.shape[0]
    off = np.full(n, 12, dtype=np.int64)
    alive = lens >= 14
    et = np.where(alive, _u16g(buf, off), 0).astype(np.uint32)
    done = ~alive
    for _ in range(2):
        is_tag = ~done & ((et == 0x8100) | (et == 0x88A8))
        done |= ~is_tag
        off = np.where(is_tag, off + 4, off)
        short = is_tag & (lens < off + 2)
        if strict:
            alive &= ~short
        done |= short
        rd = is_tag & ~short
        et = np.where(rd, _u16g(buf, off), et)
    return off + 2, et, alive


def classify_dhcp_batch(buf: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized ring.classify_dhcp: [n] uint32 of {0, FLAG_DHCP_CTRL}.
    Guard-for-guard the scalar classifier — strict IPv4 non-fragment
    UDP dst:67 BOOTREQUEST with the DHCP magic; every scalar `return 0`
    is a mask term here."""
    lens = np.asarray(lens, dtype=np.int64)
    off, et, ok = _l3_walk(buf, lens, strict=True)
    ok = ok & (et == 0x0800) & (lens >= off + 20)
    first = _gather(buf, off)
    ok &= (first >> 4) == 4
    ihl = (first & 0x0F).astype(np.int64) * 4
    ok &= (ihl >= 20) & (_gather(buf, off + 9) == 17)
    ok &= (_u16g(buf, off + 6) & 0x3FFF) == 0  # fragmented: no L4
    l4 = off + ihl
    ok &= lens >= l4 + 8
    ok &= _u16g(buf, l4 + 2) == 67
    bootp = l4 + 8
    ok &= (lens >= bootp + 240) & (_gather(buf, bootp) == 1)
    ok &= _u32g(buf, bootp + 236) == 0x63825363
    return np.where(ok, np.uint32(FLAG_DHCP_CTRL), np.uint32(0))


def shard_of_batch(buf: np.ndarray, lens: np.ndarray, flags: np.ndarray,
                   n_shards: int,
                   pub_keys: np.ndarray | None = None,
                   pub_vals: np.ndarray | None = None) -> np.ndarray:
    """Vectorized ring.shard_of: [n] int64 owner shards. pub_keys must
    be SORTED host-order NAT public IPs with pub_vals their owner
    shards (PyRing keeps the sorted mirror of its steer map)."""
    n = buf.shape[0]
    lens = np.asarray(lens, dtype=np.int64)
    flags = np.asarray(flags, dtype=np.uint32)
    shard = np.zeros(n, dtype=np.int64)
    if n_shards == 1 or n == 0:
        return shard
    alive = lens >= 14
    # sticky MAC hash — the DHCP-control / non-IPv4 / PPPoE-control fall
    # line (shard stays 0 for runts, like the scalar early return)
    mac_hash = (fnv1a32_cols(buf[:, 6:12]) % np.uint32(n_shards)
                ).astype(np.int64)
    shard[alive] = mac_hash[alive]

    walk = alive & ((flags & FLAG_DHCP_CTRL) == 0)
    off, et, _ = _l3_walk(buf, lens, strict=False)
    first = _gather(buf, off)
    ip4 = walk & (et == 0x0800) & (lens >= off + 20) & ((first >> 4) == 4)
    from_access = (flags & FLAG_FROM_ACCESS) != 0

    # upstream IPv4: FNV of src IP
    up = ip4 & from_access
    if up.any():
        src = _ip_cols(buf, off + 12)
        shard[up] = (fnv1a32_cols(src) % np.uint32(n_shards)
                     ).astype(np.int64)[up]
    # downstream IPv4: NAT pub-IP ownership, else FNV of dst IP
    down = ip4 & ~from_access
    if down.any():
        dst = _ip_cols(buf, off + 16)
        dfnv = (fnv1a32_cols(dst) % np.uint32(n_shards)).astype(np.int64)
        shard[down] = dfnv[down]
        if pub_keys is not None and len(pub_keys):
            dst_u32 = ((dst[:, 0].astype(np.uint64) << 24)
                       | (dst[:, 1].astype(np.uint64) << 16)
                       | (dst[:, 2].astype(np.uint64) << 8)
                       | dst[:, 3])
            pos = np.searchsorted(pub_keys, dst_u32)
            pos_c = np.minimum(pos, len(pub_keys) - 1)
            hit = down & (pub_keys[pos_c] == dst_u32)
            owner = pub_vals[pos_c]
            hit &= owner < n_shards  # scalar: out-of-range owner ignored
            shard[hit] = owner[hit].astype(np.int64)

    # PPPoE session DATA (PPP proto IPv4): inner src IP affinity. The
    # proto check is the full 16-bit compare against 0x0021, never
    # `hi<<8 | (lo==0x0021)` (LCP/IPCP control frames must fall through
    # to the sticky MAC hash).
    ppp = (walk & ~ip4 & (et == 0x8864) & from_access
           & (lens >= off + 8 + 20))
    if ppp.any():
        ppp &= (_gather(buf, off) == 0x11) & (_gather(buf, off + 1) == 0)
        ppp &= _u16g(buf, off + 6) == 0x0021
        ppp &= (_gather(buf, off + 8) >> 4) == 4
        if ppp.any():
            isrc = _ip_cols(buf, off + 8 + 12)
            shard[ppp] = (fnv1a32_cols(isrc) % np.uint32(n_shards)
                          ).astype(np.int64)[ppp]
    return shard


def _ip_cols(buf: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Gather 4 consecutive bytes per lane -> [n, 4] (clipped reads —
    callers mask dead lanes)."""
    ar = np.arange(buf.shape[0])
    cap = buf.shape[1] - 1
    return np.stack([buf[ar, np.minimum(off + k, cap)] for k in range(4)],
                    axis=1)


def bootp_off_batch(buf: np.ndarray, lens: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized admission._bootp_off: (bootp_off, valid). Accepts
    either UDP port pair exactly like the scalar (it peeks replies
    too — no dport guard)."""
    lens = np.asarray(lens, dtype=np.int64)
    off, et, ok = _l3_walk(buf, lens, strict=True)
    ok = ok & (et == 0x0800) & (lens >= off + 20)
    first = _gather(buf, off)
    ok &= (first >> 4) == 4
    ihl = (first & 0x0F).astype(np.int64) * 4
    ok &= (ihl >= 20) & (_gather(buf, off + 9) == 17)
    ok &= (_u16g(buf, off + 6) & 0x3FFF) == 0
    bootp = off + ihl + 8
    ok &= lens >= bootp + 240
    return bootp, ok


def peek_dhcp_batch(buf: np.ndarray, lens: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized admission.peek_dhcp: (msg_type, mac_u64, parsed).
    parsed=False lanes mirror the scalar None (admitted as-is — the
    worker's per-frame isolation owns malformed input). The option-53
    scan runs the scalar's bounded 64-TLV walk with a per-lane cursor;
    lanes that exhaust the walk report msg_type 0 like the scalar
    fallthrough."""
    lens = np.asarray(lens, dtype=np.int64)
    bootp, parsed = bootp_off_batch(buf, lens)
    magic_ok = _u32g(buf, bootp + 236) == 0x63825363
    parsed = parsed & magic_ok
    mac = ((_u16g(buf, bootp + 28).astype(np.uint64) << 32)
           | _u32g(buf, bootp + 30))
    # bounded TLV scan for option 53
    n = buf.shape[0]
    cur = bootp + 240
    msg = np.zeros(n, dtype=np.int64)
    scanning = parsed.copy()
    OPT_PAD, OPT_END, OPT_MSG = 0, 255, 53
    for _ in range(64):
        if not scanning.any():
            break
        in_range = scanning & (cur < lens)
        scanning &= in_range
        code = _gather(buf, cur)
        scanning &= code != OPT_END
        pad = scanning & (code == OPT_PAD)
        has_len = scanning & ~pad & (cur + 1 < lens)
        scanning &= pad | has_len
        ln = _gather(buf, cur + 1).astype(np.int64)
        found = (has_len & (code == OPT_MSG) & (ln >= 1)
                 & (cur + 2 < lens))
        msg[found] = _gather(buf, cur + 2)[found]
        scanning &= ~found
        cur = np.where(pad, cur + 1, np.where(scanning, cur + 2 + ln, cur))
    return msg, mac, parsed
