"""The devloop host pump (port of `bng_tpu/devloop/host.py`): k express
batches, one dispatch.

When the scheduler's express loop resolves to `devloop`, it hands every
closed express batch to the pump, which stages the batch's descriptor
rows into the next slot of a `DescriptorRing` instead of dispatching it.
The device is touched once per ring: when the ring fills, on the ring
deadline, or at flush with a partial fill, through the ring program
(`devloop/kernel.py`). Completions retire per slot through the
scheduler's own express retire (`TieredScheduler._retire_express`: the
wire-template patch-in and the slow path), so the reply bytes are the
per-batch lane's by construction; the ring's stats fold once.

Dispatch: the reference runs the executable on a one-thread worker,
which CPU XLA needed. Here a graph replay is already asynchronous, so
the serving thread replays on the engine's stream, and readiness is an
event query, as for the per-batch lane's `_InFlight`.

Fallbacks are loud: a geometry miss or an injected `devloop.dispatch`
fault serves every staged slot through the per-batch express path and
counts `express_fallbacks["devloop_miss"]`. Two barriers keep the
reference's order of table writes: before any per-batch dispatch writes
the published tables (`_barrier`), and before a resync seeds a new chain
(the update slots would overflow, or a resync already happened).

Quiesce contract: `flush()` ships any partial ring and retires every
ring in flight; afterwards `audit()` can prove the device cursors agree
with the host's slot accounting.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from bng_tpu_torch.chaos.faults import fault_point
from bng_tpu_torch.devloop.ring import CUR_SEQ, DescriptorRing
from bng_tpu_torch.ops.dhcp import NSTATS
from bng_tpu_torch.runtime.engine import ExpressAotResult, _InFlight
from bng_tpu_torch.runtime.lanes import CLOSE_DEADLINE, CLOSE_FLUSH, CompletionRing, InflightEntry


class _RingInflight(NamedTuple):
    """One ring in flight: its outputs on their way to the host, and the
    per-slot retire metadata the device never sees."""

    fl: _InFlight     # the ring's blocks [k, B, XD_WORDS] and summed stats
    cursors: object   # the ring program's cursor tensor
    upd: object       # the fastpath deltas drained for this ring (or None)
    published: object  # the published DHCP tables it was dispatched against
    slots: list       # [n_slots] lists of PendingFrame
    reason: str       # why the ring was dispatched (full, deadline, flush)
    dispatch_t: float
    meta: tuple       # the dispatch's (pools, server) snapshot


class _SlotResult:
    """One slot of a retired ring, shaped like `_InFlight` for the
    scheduler's express retire: its verdict block and the ring's stats
    (on the first non-empty slot; zeros on the others)."""

    stat_names = ["dhcp"]

    def __init__(self, block: np.ndarray, stats: np.ndarray):
        self._host = {"block": block, "stats": stats}

    def ready(self) -> bool:
        return True

    def wait(self) -> dict:
        return self._host


class DevloopPump:
    """Owns one DescriptorRing and its in-flight rings for a
    TieredScheduler's express lane."""

    def __init__(self, sched, k: int, depth: int = 2):
        self.sched = sched
        self.ring = DescriptorRing(k, sched.express.cfg.batch, depth,
                                   device=sched.engine.device)
        self._inflight = CompletionRing(depth)
        # a partial ring waits at most this long after its oldest slot was
        # staged: the express lane's own close deadline
        self.max_wait_us = sched.cfg.express_max_wait_us
        self.dispatches = 0
        self.batches = 0
        self.fallback_slots = 0
        # the program whose leading copy holds the published tables plus the
        # deltas of every ring in flight, and the resync it was seeded after
        # (None: seed at the next dispatch)
        self._seeded = None
        self._seed_resync = -1

    # -- fill (one closed express batch -> one ring slot) -------------------

    def add_batch(self, pend: list, now: float, reason: str) -> int:
        """Stage one closed express batch; dispatches when the ring fills.
        Returns frames retired because the in-flight rings overflowed."""
        rows = [p.desc.words for p in pend if p.desc is not None]
        idxs = [i for i, p in enumerate(pend) if p.desc is not None] if rows else []
        self.ring.fill_slot(rows, idxs, pend, now)
        self.batches += 1
        if self.ring.head >= self.ring.k:
            return self._dispatch(now, reason)
        return 0

    # -- the beat -------------------------------------------------------------

    def poll(self, now: float) -> int:
        """Retire the finished rings, and close a partial ring past its
        deadline."""
        retired = 0
        for entry in self._inflight.pop_ready(lambda e: e.fl.ready()):
            retired += self._retire(entry)
        oldest = self.ring.oldest_fill_t
        if oldest is not None and (now - oldest) * 1e6 >= self.max_wait_us:
            retired += self._dispatch(now, CLOSE_DEADLINE)
        return retired

    def flush(self, now: float) -> int:
        """Ship the partial ring and retire everything in flight (the
        scheduler's flush and quiesce barrier)."""
        retired = 0
        if self.ring.head:
            retired += self._dispatch(now, CLOSE_FLUSH)
        return retired + self._barrier()

    # -- dispatch -------------------------------------------------------------

    def _barrier(self) -> int:
        """Retire every ring in flight: past this point the published tables
        are the newest and no ring's deltas are still to come. Required
        before any other writer of the published tables runs (a per-batch
        dispatch, a resync)."""
        retired = 0
        while (entry := self._inflight.pop_oldest()) is not None:
            retired += self._retire(entry)
        return retired

    def _dispatch(self, now: float, reason: str) -> int:
        sched = self.sched
        eng = sched.engine
        stage, n_slots, slots = self.ring.take()
        if n_slots == 0:
            return 0
        prog = (eng.devloop_aot(self.ring.k, self.ring.batch, sched._express_dev)
                if sched._aot_ready else None)
        fp = fault_point("devloop.dispatch")
        if fp is not None and fp.kind == "fail":
            prog = None  # chaos: an injected loop fallback
        if prog is None:
            # loud fallback: every staged slot through the per-batch express
            # path, which writes the published tables itself, so every ring
            # in flight publishes first
            retired = self._barrier()
            self._seeded = None
            sched._note_fallback(
                "devloop_miss",
                f"no ring program for k={self.ring.k} batch={self.ring.batch}"
                + (" (injected)" if fp is not None else "")
                + f": {n_slots} slot(s) served per batch")
            self.fallback_slots += n_slots
            for pend in slots:
                retired += sched._dispatch_express_direct(pend, now, reason)
            return retired
        retired = 0
        # resync barrier: a drain that would overflow the update slots (or a
        # resync since the seed) rebuilds the published tables from the full
        # host state; every ring in flight publishes before that
        if self._seeded is not None and (
                eng.fastpath.dirty_count() > eng.fastpath.update_slots
                or self._seed_resync != eng.resync_count):
            retired += self._barrier()
            self._seeded = None
        upd, resynced = eng.prepare_devloop_dispatch()
        if resynced and self._seeded is not None:
            # the pre-check missed a resync: the rings in flight retire
            # against the replaced tables (their deltas are already in the
            # fresh upload), then the leading copy re-seeds
            retired += self._barrier()
            self._seeded = None
        if self._seeded is not prog:
            prog.seed(eng.tables.dhcp)
            prog.seed_cursors(self.ring.cursors)
            self._seeded, self._seed_resync = prog, eng.resync_count
        res = eng.call_devloop_aot(prog, upd, stage, n_slots, now)
        fl = _InFlight(ExpressAotResult(block=res.blocks, dhcp_stats=res.dhcp_stats))
        # the retire renders from the pool and server rows this ring saw
        cfg_epoch = (eng.fastpath.pools.copy(), eng.fastpath.server.copy())
        self.dispatches += 1
        sched.express_aot_dispatches += n_slots
        over = self._inflight.push(_RingInflight(
            fl, res.cursors, upd, eng.tables.dhcp, slots, reason, now, cfg_epoch))
        if over is not None:
            retired += self._retire(over)
        return retired

    # -- retire ---------------------------------------------------------------

    def _retire(self, entry: _RingInflight) -> int:
        """Wait for one ring's outputs, publish its deltas and cursors, and
        retire each slot through the scheduler's express retire (the reply
        path is shared, not cloned)."""
        h = entry.fl.wait()
        self.ring.adopt_cursors(entry.cursors)
        self.sched.engine.adopt_devloop_chain(entry.upd, entry.published)
        zero = np.zeros((NSTATS,), dtype=h["stats"].dtype)
        retired, folded = 0, False
        for s, pend in enumerate(entry.slots):
            if not pend:
                continue
            res = _SlotResult(h["block"][s], zero if folded else h["stats"])
            folded = True
            retired += self.sched._retire_express(InflightEntry(
                res, pend, entry.dispatch_t, entry.reason, meta=entry.meta))
        return retired

    # -- quiesce audit and counters -------------------------------------------

    def audit(self) -> dict:
        """Cursor words against the host's slot accounting; legal only after
        flush() (nothing in flight)."""
        seq = int(self.ring.read_cursors()[CUR_SEQ])
        taken = self.ring.slots_taken - self.fallback_slots
        return {
            "seq": seq,
            "slots_taken": taken,
            "staged": self.ring.head,
            "inflight": len(self._inflight),
            "consistent": (seq == taken and self.ring.head == 0
                           and len(self._inflight) == 0),
        }

    def stats(self) -> dict:
        return {
            "k": self.ring.k,
            "dispatches": self.dispatches,
            "batches": self.batches,
            "fallback_slots": self.fallback_slots,
            "staged": self.ring.head,
            "inflight": len(self._inflight),
            "occupancy_avg": round(self.ring.occupancy_avg(), 4),
        }
