"""Latency-class lanes for the tiered scheduler (copy of
`bng_tpu/runtime/lanes.py`).

A lane is a host-side staging queue with a batch-close policy and a
bounded completion ring; `runtime/scheduler.py` composes two of them, the
express (DHCP) lane and the bulk (fused step) lane. A lane closes a batch:

- CLOSE_FULL: the batch reached the lane's device batch size;
- CLOSE_DEADLINE: the oldest queued frame waited max_wait_us, so a partial
  batch ships rather than letting the tail latency grow;
- CLOSE_FLUSH: the caller forced a partial batch out.

The completion ring bounds how many dispatches are in flight: `push`
hands back the entry that overflowed it, which the caller must retire
(wait for); that is the only place a lane waits on the device.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, NamedTuple

LANE_EXPRESS = "express"
LANE_BULK = "bulk"

CLOSE_FULL = "full"
CLOSE_DEADLINE = "deadline"
CLOSE_FLUSH = "flush"


@dataclass
class LaneConfig:
    name: str
    batch: int  # lanes per device dispatch
    max_wait_us: float  # oldest-frame age that forces a partial close
    depth: int  # max in-flight dispatches (completion ring size)
    max_queue: int = 1 << 16  # backpressure bound; beyond it push() drops


class PendingFrame(NamedTuple):
    frame: bytes
    from_access: bool
    enq_t: float  # lane clock at submit (the latency origin)
    tag: object  # the caller's correlation token (e.g. submission index)
    # express descriptor (ops/express.ExpressDesc), extracted once at
    # admission; None on the bulk lane and on the DHCP-only express rung
    desc: object = None


@dataclass
class LaneStats:
    enqueued: int = 0
    dropped_overflow: int = 0
    frames_dispatched: int = 0
    batches: int = 0
    batches_full: int = 0
    batches_deadline: int = 0
    batches_flush: int = 0
    occupancy_sum: float = 0.0  # sum of n/batch over dispatches

    def occupancy_avg(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0


class Lane:
    """One latency class: staging queue, close policy and counters."""

    def __init__(self, cfg: LaneConfig, clock: Callable[[], float] = time.time):
        self.cfg = cfg
        self.clock = clock
        self.q: deque[PendingFrame] = deque()
        self.stats = LaneStats()

    def __len__(self) -> int:
        return len(self.q)

    def push(self, frame: bytes, from_access: bool, now: float | None = None,
             tag: object = None, desc: object = None) -> bool:
        """Queue a frame; False = the lane is at max_queue (the frame is
        dropped and counted, like an RX ring overflow)."""
        if len(self.q) >= self.cfg.max_queue:
            self.stats.dropped_overflow += 1
            return False
        now = now if now is not None else self.clock()
        self.q.append(PendingFrame(frame, from_access, now, tag, desc))
        self.stats.enqueued += 1
        return True

    def oldest_age_us(self, now: float) -> float:
        return (now - self.q[0].enq_t) * 1e6 if self.q else 0.0

    def close_reason(self, now: float) -> str | None:
        """Why a batch should close now (None = keep filling)."""
        if len(self.q) >= self.cfg.batch:
            return CLOSE_FULL
        if self.q and self.oldest_age_us(now) >= self.cfg.max_wait_us:
            return CLOSE_DEADLINE
        return None

    def close_batch(self, now: float,
                    reason: str | None = None) -> tuple[list[PendingFrame], str]:
        """Pop up to `batch` frames and count the close. With no reason the
        close policy decides; CLOSE_FLUSH ships a partial batch regardless."""
        reason = reason or self.close_reason(now)
        if reason is None or not self.q:
            return [], reason or CLOSE_FLUSH
        n = min(len(self.q), self.cfg.batch)
        out = [self.q.popleft() for _ in range(n)]
        st = self.stats
        st.batches += 1
        st.frames_dispatched += n
        st.occupancy_sum += n / self.cfg.batch
        if reason == CLOSE_FULL:
            st.batches_full += 1
        elif reason == CLOSE_DEADLINE:
            st.batches_deadline += 1
        else:
            st.batches_flush += 1
        return out, reason


@dataclass
class InflightEntry:
    """One dispatched, not yet retired, device batch."""

    res: object  # the batch's outputs on their way to the host
    pending: list[PendingFrame]
    dispatch_t: float
    close_reason: str
    # a dispatch-time snapshot the retire must read instead of the live
    # host mirrors (the express retire renders from the pool and server
    # config the device verdict was computed against)
    meta: object = None


class CompletionRing:
    """Bounded in-flight window (depth-N pipelining). `push` returns the
    entry that overflowed the ring; `pop_ready` retires the finished FIFO
    prefix without waiting."""

    def __init__(self, depth: int):
        self.depth = max(1, depth)
        self._ring: deque[InflightEntry] = deque()

    def __len__(self) -> int:
        return len(self._ring)

    def push(self, entry: InflightEntry) -> InflightEntry | None:
        self._ring.append(entry)
        if len(self._ring) > self.depth:
            return self._ring.popleft()
        return None

    def pop_oldest(self) -> InflightEntry | None:
        return self._ring.popleft() if self._ring else None

    def pop_ready(self, is_ready: Callable[[InflightEntry], bool]) -> list[InflightEntry]:
        """The FIFO prefix whose device results are done (retire order stays
        dispatch order)."""
        out = []
        while self._ring and is_ready(self._ring[0]):
            out.append(self._ring.popleft())
        return out

    def drain(self) -> list[InflightEntry]:
        out = list(self._ring)
        self._ring.clear()
        return out
