"""Packet ring for the engine's ring loops (port of the scalar host path of
`bng_tpu/runtime/ring.py`'s `PyRing`, one shard).

A pure-Python ring with the reference's API: RX frames are pushed
(classified on the way in: `FLAG_DHCP_CTRL` marks genuine DHCP requests
from the access side), `assemble` stages up to B of them into a [B, L]
batch, `complete` demuxes the verdicts FIFO (TX and FWD payloads to
their rings, PASS frames to the slow ring, DROP freed), and the
consumers pop TX/FWD/slow frames. Up to two assemble..complete windows
may be open at once, which the double-buffered loop needs.
"""

from __future__ import annotations

from collections import deque

import numpy as np

FLAG_FROM_ACCESS = 0x1
# set on RX when the frame is a genuine DHCP request to UDP:67: an
# all-control batch may take the DHCP-only device program
FLAG_DHCP_CTRL = 0x2

VERDICT_PASS, VERDICT_DROP, VERDICT_TX, VERDICT_FWD = 0, 1, 2, 3

STAT_NAMES = ("rx", "tx", "fwd", "drop", "slow", "fill_empty", "rx_full", "tx_full", "bad_desc")


def classify_dhcp(frame: bytes) -> int:
    """FLAG_DHCP_CTRL for an IPv4 non-fragment UDP dst:67 BOOTREQUEST with
    the DHCP magic cookie (0-2 VLAN tags), else 0. Strict on purpose:
    port-67 transit and floods stay on the fused step."""
    if len(frame) < 14:
        return 0
    off = 12
    et = (frame[off] << 8) | frame[off + 1]
    for _ in range(2):
        if et not in (0x8100, 0x88A8):
            break
        off += 4
        if len(frame) < off + 2:
            return 0
        et = (frame[off] << 8) | frame[off + 1]
    off += 2  # L3 start
    if et != 0x0800 or len(frame) < off + 20 or (frame[off] >> 4) != 4:
        return 0
    ihl = (frame[off] & 0x0F) * 4
    if ihl < 20 or frame[off + 9] != 17:
        return 0
    if ((frame[off + 6] << 8) | frame[off + 7]) & 0x3FFF:
        return 0  # fragmented: no parseable L4
    l4 = off + ihl
    if len(frame) < l4 + 8:
        return 0
    if ((frame[l4 + 2] << 8) | frame[l4 + 3]) != 67:
        return 0
    bootp = l4 + 8
    if len(frame) < bootp + 240 or frame[bootp] != 1:
        return 0
    magic = int.from_bytes(frame[bootp + 236: bootp + 240], "big")
    return FLAG_DHCP_CTRL if magic == 0x63825363 else 0


class PyRing:
    """One-shard packet ring over Python deques (frames held as bytes)."""

    MAX_INFLIGHT = 2  # two assemble..complete windows (double buffering)

    def __init__(self, nframes: int = 4096, frame_size: int = 2048, depth: int = 1024):
        self.frame_size = frame_size
        self.depth = depth
        self.nframes = nframes
        self._free = nframes
        self._rx: deque = deque()
        self._tx: deque = deque()
        self._fwd: deque = deque()
        self._slow: deque = deque()
        self._inflight: list = []  # FIFO of assembled batches [(frame, flags)]
        self._stats = {k: 0 for k in STAT_NAMES}

    def close(self) -> None:
        pass

    # -- producer --
    def rx_push(self, frame: bytes, from_access: bool = True) -> bool:
        if len(frame) > self.frame_size:
            self._stats["bad_desc"] += 1
            return False
        fl = FLAG_FROM_ACCESS if from_access else 0
        if from_access:  # the fused path answers access-side DHCP only
            fl |= classify_dhcp(frame)
        if self._free == 0 or len(self._rx) >= self.depth:
            self._stats["fill_empty" if self._free == 0 else "rx_full"] += 1
            return False
        self._free -= 1
        self._rx.append((frame, fl))
        return True

    def rx_push_batch(self, frames: list[bytes], from_access: bool = True) -> int:
        """Push in order, stopping at the first refusal; returns frames taken."""
        n = 0
        for f in frames:
            if not self.rx_push(f, from_access=from_access):
                break
            n += 1
        return n

    def tx_inject(self, frame: bytes, from_access: bool = True) -> bool:
        """Queue a host-built frame (a slow-path reply) on the TX ring."""
        if len(frame) > self.frame_size or self._free == 0 or len(self._tx) >= self.depth:
            return False
        self._free -= 1
        self._tx.append((frame, FLAG_FROM_ACCESS if from_access else 0))
        self._stats["tx"] += 1
        return True

    # -- consumer --
    def assemble(self, out: np.ndarray, out_len: np.ndarray, out_flags: np.ndarray) -> int:
        """Stage up to B RX frames into out [B, L] (zero past each frame),
        out_len and out_flags; opens a window that `complete` retires."""
        if len(self._inflight) >= self.MAX_INFLIGHT:
            return 0
        B, slot = out.shape
        batch = []
        while len(batch) < B and self._rx:
            frame, fl = self._rx.popleft()
            i = len(batch)
            copy = min(len(frame), slot)
            out[i, :copy] = np.frombuffer(frame[:copy], dtype=np.uint8)
            out[i, copy:] = 0
            out_len[i] = copy
            out_flags[i] = fl
            batch.append((frame, fl))
        if batch:
            self._inflight.append(batch)
        self._stats["rx"] += len(batch)
        return len(batch)

    def complete(self, verdict: np.ndarray, out: np.ndarray, out_len: np.ndarray,
                 n: int) -> None:
        """Retire the OLDEST open window: TX/FWD lanes queue their rewritten
        bytes, PASS lanes their original frame on the slow ring, DROP
        lanes free their frame; a full destination ring drops (tx_full)."""
        if not self._inflight or n != len(self._inflight[0]):
            raise RuntimeError("batch_complete: n mismatch")
        batch = self._inflight.pop(0)
        for i, (frame, fl) in enumerate(batch):
            v = int(verdict[i])
            if v in (VERDICT_TX, VERDICT_FWD):
                payload = bytes(out[i, : int(out_len[i])])
                dst, stat = (self._tx, "tx") if v == VERDICT_TX else (self._fwd, "fwd")
            elif v == VERDICT_PASS:
                payload, dst, stat = frame, self._slow, "slow"
            else:
                self._stats["drop"] += 1
                self._free += 1
                continue
            if len(dst) < self.depth:
                dst.append((payload, fl))  # the frame stays held until popped
                self._stats[stat] += 1
            else:
                self._stats["tx_full"] += 1
                self._free += 1

    def _pop(self, q: deque):
        if not q:
            return None
        self._free += 1
        return q.popleft()

    def tx_pop(self):
        return self._pop(self._tx)

    def fwd_pop(self):
        return self._pop(self._fwd)

    def slow_pop(self):
        return self._pop(self._slow)

    def rx_pending(self) -> int:
        return len(self._rx)

    def tx_pending(self) -> int:
        return len(self._tx)

    def fwd_pending(self) -> int:
        return len(self._fwd)

    def slow_pending(self) -> int:
        return len(self._slow)

    def free_frames(self) -> int:
        return self._free

    def stats(self) -> dict:
        return dict(self._stats)
