"""Latency-tiered scheduler: the express DHCP lane over the bulk lane (port
of `bng_tpu/runtime/scheduler.py`).

- **Express lane**: frames that classify as access-side DHCP requests
  (`runtime/ring.classify_dhcp`) are parsed once at admission into
  express descriptors (`ops/express.parse_express`) and dispatched in a
  small fixed batch, closed when full or when the oldest frame has
  waited `express_max_wait_us`. The dispatch drains the fastpath deltas
  into the authoritative DHCP tables (an OFFER sees the newest lease) and
  runs the engine's express program: on the card a CUDA graph of three K1
  probes and a few selects, captured at init (`Engine.compile_express_aot`).
  The retire patches the device-answered lanes into preassembled wire
  templates and hands the rest to the slow path. A geometry miss (no
  program for the lane's batch) is served by the DHCP-only program
  instead, and counted as a miss and a fallback.
- **Bulk lane**: everything else runs the fused step at a large batch,
  up to `bulk_depth` dispatches in flight; the lane waits on the device
  only when its completion ring overflows. The bulk step reads a replica
  of the DHCP tables refreshed every `dhcp_refresh_every` dispatches (and
  after a resync), and ships the other tables' deltas every `drain_every`
  dispatches (with `overlap_drain`, built and uploaded right after the
  previous dispatch) and empty deltas in between.

- **Express loop** (`express_loop`, overridden by `BNG_EXPRESS_LOOP`):
  `aot` dispatches each express batch; `devloop` stages k of them
  (`devloop_k`, `BNG_DEVLOOP_K`) in a descriptor ring that one dispatch of
  the ring program serves (`devloop/`), with up to `devloop_depth` rings
  in flight; `auto` takes the devloop when its program builds and `aot`
  otherwise. An explicit `devloop` that cannot arm degrades to `aot`
  loudly (counted in `express_fallbacks`), `auto` quietly.

Telemetry is the reference's: each dispatched batch opens a flight
record (`telemetry/spans.begin_batch`) with its lane wait, its dispatch,
its `device_wait` (the event wait behind its output copies, the only
wait the lanes make) and its reply laps; an express batch served by the
express program's graph while armed on the card also observes the
replay's CUDA-event time into `device` at its retire (the `device` SLO's
samples). An express geometry miss and every express fallback fire
their flight-recorder triggers. With
`metrics` (BNGMetrics, set by the composition root) each dispatch and
retire also feeds the `bng_sched_*` histograms and counters. No hook
reads a device tensor.

- **Express card** (`express_device_index`, the reference's
  `_pick_express_device`): on a host with a second visible card the
  express lane takes it, so an express dispatch queues on a stream of its
  own card and never behind a bulk step. The engine moves the
  authoritative DHCP tables there (`Engine._place_dhcp_chain`), the
  express and ring programs are captured there, and the bulk lane reads a
  replica transferred to the engine's card at each refresh. With one card
  the lane shares the engine's card and stream.

Single-threaded and poll-driven: `submit()` frames and `poll()` each
beat, or call `process()`, the batch-synchronous facade.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from bng_tpu_torch.control.dhcp_codec import ACK, DISCOVER, OFFER, ExpressTemplateCache
from bng_tpu_torch.devloop.host import DevloopPump
from bng_tpu_torch.ops.dhcp import (
    PV_DNS1, PV_DNS2, PV_GATEWAY, PV_PREFIX, SC_IP, SC_MAC_HI, SC_MAC_LO,
)
from bng_tpu_torch.ops.express import (
    VB_LEASE_T, VB_POOL, VB_VERDICT, VB_YIADDR, XD_WORDS, parse_express,
)
from bng_tpu_torch.ops.pipeline import VERDICT_DROP, VERDICT_FWD, VERDICT_TX
from bng_tpu_torch.runtime.engine import _InFlight
from bng_tpu_torch.runtime.lanes import (
    CLOSE_FLUSH, LANE_BULK, LANE_EXPRESS, CompletionRing, InflightEntry, Lane, LaneConfig,
)
from bng_tpu_torch.runtime.ring import classify_dhcp
from bng_tpu_torch.runtime.tables import dhcp_to
from bng_tpu_torch.telemetry import spans as tele
from bng_tpu_torch.telemetry.recorder import TRIG_EXPRESS_AOT_MISS, TRIG_EXPRESS_FALLBACK
from bng_tpu_torch.utils.net import prefix_to_mask

log = logging.getLogger("bng.scheduler")


def pick_express_device(index: int | None, n_cards: int):
    """The express lane's card (the reference's `_pick_express_device`):
    None shares the engine's card. `index` None takes the second of
    `n_cards` visible cards when there is one; -1 (any negative) shares;
    i pins `cuda:i` and raises when no such card is visible."""
    if index is None:
        return torch.device("cuda", 1) if n_cards > 1 else None
    if index < 0:
        return None
    if index >= n_cards:
        raise ValueError(f"express_device_index {index} names no card: {n_cards} visible")
    return torch.device("cuda", index)


@dataclass
class SchedulerConfig:
    """Knobs of the two lanes and of the drain and replica cadences."""

    express_batch: int = 64
    express_max_wait_us: float = 200.0
    express_depth: int = 2  # express dispatches in flight inside one poll
    # descriptors at admission and the express program; False = every
    # express batch takes the DHCP-only program
    express_aot: bool = True
    bulk_batch: int | None = None  # None = engine.B
    bulk_max_wait_us: float = 2000.0
    bulk_depth: int = 2  # completion-ring depth (>= 2: never wait per step)
    drain_every: int = 1  # bulk host-update drain cadence (1 = every step)
    # build and upload the next drain right after dispatching a step, so it
    # overlaps that step instead of delaying the next dispatch
    overlap_drain: bool = True
    dhcp_refresh_every: int = 16  # bulk DHCP-replica refresh cadence
    express_max_queue: int = 1 << 14
    bulk_max_queue: int = 1 << 16
    # None: the second visible card when there is one, else share the
    # engine's; -1: share; i: cuda:i (the engine's own card shares too)
    express_device_index: int | None = None
    # "aot" = the per-batch express program, "devloop" = k batches per ring
    # dispatch (devloop/), "auto" = devloop when its program builds, else
    # aot. BNG_EXPRESS_LOOP overrides.
    express_loop: str = "aot"
    devloop_k: int = 8  # ring slots per dispatch (BNG_DEVLOOP_K overrides)
    devloop_depth: int = 2  # rings in flight


class Completion(NamedTuple):
    """One frame's outcome, delivered at retire."""

    tag: object
    lane: str
    verdict: str  # "tx" | "fwd" | "drop" | "slow"
    frame: bytes | None  # device output (tx/fwd) or slow-path reply
    from_access: bool
    latency_s: float  # submit -> retire (queue wait + device + demux)


class TieredScheduler:
    """The steady-state device loop over an Engine's programs."""

    _COMPLETIONS_CAP = 1 << 17
    is_scheduler = True  # what DHCPBenchmark reads to route its batches here

    def __init__(self, engine, cfg: SchedulerConfig | None = None, metrics=None,
                 clock: Callable[[], float] | None = None):
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        self.metrics = metrics
        self.clock = clock or engine.clock
        bulk_batch = self.cfg.bulk_batch or engine.B
        self.express = Lane(LaneConfig(LANE_EXPRESS, self.cfg.express_batch,
                                       self.cfg.express_max_wait_us, self.cfg.express_depth,
                                       self.cfg.express_max_queue), self.clock)
        self.bulk = Lane(LaneConfig(LANE_BULK, bulk_batch, self.cfg.bulk_max_wait_us,
                                    self.cfg.bulk_depth, self.cfg.bulk_max_queue), self.clock)
        self._express_ring = CompletionRing(self.cfg.express_depth)
        self._bulk_ring = CompletionRing(self.cfg.bulk_depth)
        self.completions: deque[Completion] = deque()
        self.completions_dropped = 0
        self.oversize_dropped = 0
        # what the dispatch and retire hooks count, per lane: dispatches,
        # frames dispatched, frames retired (kept beside the bng_sched_*
        # families they also feed)
        self.observed = {lane: {"dispatches": 0, "frames": 0, "retired": 0}
                         for lane in (LANE_EXPRESS, LANE_BULK)}
        self._seq = 0
        # the bulk lane's DHCP read replica (refreshed on cadence and resync)
        self._bulk_dhcp = None
        self._replica_resync = -1
        self._bulk_seq = 0
        self._drains_applied = 0
        self._drains_prefetched = 0
        # overlap drain: the batch built for the next drain-due bulk step;
        # _flush_prefetched() ships it when no step comes
        self._prefetched_upd = None
        self._replica_refreshes = 0
        n_cards = torch.cuda.device_count() if engine.device.type == "cuda" else 0
        self._express_dev = pick_express_device(self.cfg.express_device_index, n_cards)
        # the express program is built here (never on the dispatch path); a
        # failure to build it counts, logs, and leaves the DHCP-only rung
        # serving every express batch as a counted miss
        self.express_aot_misses = 0
        self.express_aot_dispatches = 0
        self.express_jit_dispatches = 0
        self._aot_enabled = self.cfg.express_aot
        self.express_fallbacks: dict[str, int] = {}  # reason -> count
        self._devloop = None  # the DevloopPump while the loop is live
        self.express_loop = "aot"  # the resolved loop
        # whether submit() parses descriptors: only while a program exists
        self._aot_ready = False
        self._express_templates = ExpressTemplateCache()
        # descriptor staging: the express program copies it into its own
        # pinned buffer before it returns, so one buffer serves every dispatch
        self._desc_buf = np.zeros((self.cfg.express_batch, XD_WORDS), dtype=np.uint32)
        if self._aot_enabled:
            self._compile_express_aot()
        self._setup_devloop()

    def _compile_express_aot(self) -> None:
        self._aot_ready = False
        try:
            self.engine.compile_express_aot(self.express.cfg.batch, self._express_dev)
            self._aot_ready = True
        except Exception as e:  # noqa: BLE001 — the DHCP-only rung serves, counted
            self._note_fallback("compile_failed",
                                f"express program build failed, the DHCP-only program will "
                                f"serve: {type(e).__name__}: {e}")

    def _setup_devloop(self) -> None:
        """Resolve and arm the express loop. The ring program is built here
        (init or engine adoption), never on the dispatch path; an explicit
        devloop that cannot arm falls back to the per-batch lane loudly."""
        self._devloop = None
        want = os.environ.get("BNG_EXPRESS_LOOP", self.cfg.express_loop)
        if want not in ("aot", "devloop", "auto"):
            raise ValueError(
                f"BNG_EXPRESS_LOOP/express_loop must be aot|devloop|auto, got {want!r}")
        self.express_loop = "aot"
        if want == "aot":
            return
        if not (self._aot_enabled and self._aot_ready):
            # no descriptors at admission: nothing to stage in a ring
            if want == "devloop":
                self._note_fallback("devloop_unavailable",
                                    "the devloop needs the express program (descriptor "
                                    "admission); serving per batch")
            return
        k = int(os.environ.get("BNG_DEVLOOP_K", self.cfg.devloop_k))
        try:
            self.engine.compile_devloop_aot(k, self.express.cfg.batch, self._express_dev)
        except Exception as e:  # noqa: BLE001 — the per-batch lane serves, counted
            self._note_fallback("devloop_compile_failed",
                                f"ring program k={k} batch={self.express.cfg.batch} failed to "
                                f"build, the per-batch express program will serve: "
                                f"{type(e).__name__}: {e}")
            return
        self._devloop = DevloopPump(self, k, self.cfg.devloop_depth)
        self.express_loop = "devloop"

    def _note_fallback(self, reason: str, detail: str) -> None:
        """One express fallback: counted per reason (for
        bng_express_fallback_total), flight-recorded and logged. Serving
        goes on at the lower rung either way, never silently."""
        self.express_fallbacks[reason] = self.express_fallbacks.get(reason, 0) + 1
        tele.trigger(TRIG_EXPRESS_FALLBACK, f"express fallback ({reason}): {detail}")
        log.warning("express fallback (%s): %s", reason, detail)

    # -- ingress --

    def classify(self, frame: bytes, from_access: bool) -> str:
        """An access-side DHCP discover/request -> express; the rest -> bulk."""
        if from_access and classify_dhcp(frame):
            return LANE_EXPRESS
        return LANE_BULK

    def submit(self, frame: bytes, from_access: bool = True, now: float | None = None,
               tag: object = None, lane: str | None = None) -> str | None:
        """Classify and queue one frame. Returns the lane, or None when the
        frame is dropped (lane over its bound, or larger than the engine's
        packet slot). A caller that already classified passes `lane`."""
        now = now if now is not None else self.clock()
        if tag is None:
            tag = self._seq
        self._seq += 1
        if len(frame) > self.engine.L:
            self.oversize_dropped += 1
            return None
        lane_name = lane or self.classify(frame, from_access)
        if lane_name == LANE_EXPRESS:
            # the descriptor is extracted once, here; None (no program, or a
            # frame the device would PASS anyway) retires through the slow path
            desc = parse_express(frame) if self._aot_ready else None
            ok = self.express.push(frame, from_access, now, tag, desc=desc)
            return LANE_EXPRESS if ok else None
        return lane_name if self.bulk.push(frame, from_access, now, tag) else None

    # -- the beat --

    def poll(self, now: float | None = None) -> int:
        """One beat: express first, then the bulk ring. Returns frames retired."""
        now = now if now is not None else self.clock()
        return self._pump_express(now) + self._pump_bulk(now)

    def flush(self, now: float | None = None) -> int:
        """Ship every queued frame (partial batches close at once) and
        retire everything in flight."""
        now = now if now is not None else self.clock()
        retired = 0
        while len(self.express):
            reason = self.express.close_reason(now) or CLOSE_FLUSH
            pend, reason = self.express.close_batch(now, reason)
            retired += self._dispatch_express(pend, now, reason)
        if self._devloop is not None:
            # the partial ring ships and every ring retires before the
            # per-batch ring drains: a devloop miss dispatches slots there
            retired += self._devloop.flush(now)
        retired += self._retire_express_all()
        while len(self.bulk):
            reason = self.bulk.close_reason(now) or CLOSE_FLUSH
            pend, reason = self.bulk.close_batch(now, reason)
            over = self._dispatch_bulk(pend, now, reason)
            if over is not None:
                retired += self._retire_bulk(over)
        for entry in self._bulk_ring.drain():
            retired += self._retire_bulk(entry)
        self._flush_prefetched()
        return retired

    def _flush_prefetched(self) -> None:
        """Apply a prefetched drain no bulk step consumed: its dirty slots
        are already drained on the host, so it must reach the device."""
        upd = self._prefetched_upd
        if upd is None:
            return
        self._prefetched_upd = None
        self.engine.apply_updates_now(upd)
        self._drains_applied += 1

    def quiesce(self, now: float | None = None) -> int:
        """Flush, then wait until the device has applied every table write
        queued so far (the engine's card and the DHCP tables' card)."""
        retired = self.flush(now)
        self.engine.quiesce()
        return retired

    def adopt_engine(self, engine) -> int:
        """Retire everything in flight against the old engine, then point
        both lanes at `engine`: the bulk replica is rebuilt from the new
        engine's tables and the express program built for it. Returns the
        frames the flush retired."""
        retired = self.flush()
        self.engine = engine
        self._bulk_dhcp = None
        self._replica_resync = -1
        if self._aot_enabled:
            self._compile_express_aot()
        self._setup_devloop()  # the ring program for the new engine, built here
        return retired

    # -- express lane --

    def _pump_express(self, now: float) -> int:
        retired = 0
        while True:
            reason = self.express.close_reason(now)
            if reason is None:
                break
            pend, reason = self.express.close_batch(now, reason)
            retired += self._dispatch_express(pend, now, reason)
        if self._devloop is not None:
            # the loop's own beat: retire finished rings, close a partial
            # ring past its deadline
            retired += self._devloop.poll(now)
        return retired + self._retire_express_all()

    def _dispatch_express(self, pend, now: float, reason: str) -> int:
        """Route one closed express batch: the devloop stages it as a ring
        slot, the per-batch lane dispatches it now. Returns frames retired
        as a side effect (a ring overflowing its depth)."""
        if not pend:
            return 0
        if self._devloop is not None:
            return self._devloop.add_batch(pend, now, reason)
        return self._dispatch_express_direct(pend, now, reason)

    def _dispatch_express_direct(self, pend, now: float, reason: str) -> int:
        """Dispatch one express batch; returns frames retired because the
        completion ring overflowed its depth."""
        if not pend:
            return 0
        eng = self.engine
        tok = tele.begin_batch(tele.LANE_EXPRESS_L, len(pend))
        if tok is not None:
            # the lane wait of the batch's oldest frame, from enqueue stamps
            # (the per-frame submit path pays no telemetry cost)
            tele.observe(tele.LANE_WAIT, (now - pend[0].enq_t) * 1e6, tok)
        prog = None
        if self._aot_enabled:
            if self._aot_ready:
                prog = eng.express_aot(self.express.cfg.batch, self._express_dev)
            if prog is None:
                self.express_aot_misses += 1
                self.express_fallbacks["geometry_miss"] = (
                    self.express_fallbacks.get("geometry_miss", 0) + 1)
                tele.trigger(TRIG_EXPRESS_AOT_MISS,
                             f"no express program for batch={self.express.cfg.batch}: "
                             f"the DHCP-only program served")
        t0 = tele.t()
        cfg_epoch = None
        try:
            if prog is not None:
                desc = self._desc_buf
                desc[:] = 0
                idxs = [i for i, p in enumerate(pend) if p.desc is not None]
                if idxs:
                    desc[idxs] = [pend[i].desc.words for i in idxs]
                res = _InFlight(eng.run_express_aot(prog, desc, now, device=self._express_dev))
                # the pool and server config of this dispatch: the retire
                # renders from the rows the device verdict saw, not from
                # later mirrors
                cfg_epoch = (eng.fastpath.pools.copy(), eng.fastpath.server.copy())
                self.express_aot_dispatches += 1
                tele.set_meta("express_program", "aot-express")
            else:
                pkt, length = eng._pack_frames([p.frame for p in pend], self.express.cfg.batch)
                res = _InFlight(eng._run_dhcp_batch(pkt, length, now, self._express_dev))
                self.express_jit_dispatches += 1
                tele.set_meta("express_program", "jit-full")
        except BaseException:
            tele.cancel_batch(tok)  # a failed dispatch must not leak a slot
            raise
        tele.lap(tele.DISPATCH, t0, tok)
        self._observe_dispatch(LANE_EXPRESS, len(pend), reason)
        over = self._express_ring.push(InflightEntry(res, pend, now, reason, trace=tok,
                                                     meta=cfg_epoch))
        return self._retire_express(over) if over is not None else 0

    def _retire_express_all(self) -> int:
        n = 0
        while (entry := self._express_ring.pop_oldest()) is not None:
            n += self._retire_express(entry)
        return n

    def _retire_express(self, entry: InflightEntry) -> int:
        """Wait for one express batch and demux it: lanes answered on the
        device complete as TX (the express program's through preassembled
        wire templates, the DHCP-only program's with its own bytes); the
        rest go to the slow path."""
        eng = self.engine
        n = len(entry.pending)
        tele.focus(entry.trace)
        t0 = tele.t()
        h = entry.res.wait()
        tele.lap(tele.DEVICE_WAIT, t0, entry.trace)
        ev = getattr(entry.res, "device_events", None)  # a devloop slot has none
        if ev is not None:
            # the graph replay's own time, from its CUDA event pair (armed,
            # on the card): done once the copies queued behind it are
            tele.observe(tele.DEVICE, ev[0].elapsed_time(ev[1]) * 1e3, entry.trace)
        eng._fold_stats(entry.res.stat_names, h["stats"])
        if entry.meta is not None:  # the express program's verdict block
            block = h["block"][:n].view(np.uint32)
            answered = block[:, VB_VERDICT] != 0
            pools, server = entry.meta

            def reply(i, p):
                return self._express_reply(p, block[i], pools, server)
        else:  # the DHCP-only program's reply frames
            answered = h["verdict"][:n] == VERDICT_TX

            def reply(i, p):
                return bytes(h["out_pkt"][i, : int(h["out_len"][i])])
        now = self.clock()
        slow_items = [(i, p.frame, p.enq_t) for i, p in enumerate(entry.pending)
                      if not answered[i]]
        replies = dict(eng._handle_slow_lanes(slow_items, "sched_express"))
        t0 = tele.t()
        for i, p in enumerate(entry.pending):
            if answered[i]:
                eng.stats.tx += 1
                self._complete(p, LANE_EXPRESS, "tx", reply(i, p), now)
            else:
                eng.stats.passed += 1
                self._complete(p, LANE_EXPRESS, "slow", replies.get(i), now)
        tele.lap(tele.REPLY, t0, entry.trace)
        tele.end_batch(entry.trace)
        self._observe_retire(LANE_EXPRESS, entry, now)
        return n

    def _express_reply(self, p, row: np.ndarray, pools: np.ndarray, server: np.ndarray) -> bytes:
        """One verdict row -> reply bytes, from the dispatch's pool and
        server snapshot and the device-reported lease seconds."""
        prow = pools[int(row[VB_POOL])]
        server_ip = int(server[SC_IP]) or int(prow[PV_GATEWAY])
        server_mac = (int(server[SC_MAC_HI]).to_bytes(2, "big")
                      + int(server[SC_MAC_LO]).to_bytes(4, "big"))
        d = p.desc
        tmpl = self._express_templates.get(
            server_mac, server_ip, int(prow[PV_GATEWAY]), int(prow[PV_DNS1]), int(prow[PV_DNS2]),
            int(row[VB_LEASE_T]), prefix_to_mask(int(prow[PV_PREFIX])),
            OFFER if d.msg_type == DISCOVER else ACK)
        return tmpl.render(p.frame, d.vlan_off, d.dhcp_off, d.relayed, d.use_bcast,
                           int(row[VB_YIADDR]))

    # -- bulk lane --

    def _pump_bulk(self, now: float) -> int:
        retired = 0
        for entry in self._bulk_ring.pop_ready(self._entry_ready):
            retired += self._retire_bulk(entry)
        while True:
            reason = self.bulk.close_reason(now)
            if reason is None:
                break
            pend, reason = self.bulk.close_batch(now, reason)
            over = self._dispatch_bulk(pend, now, reason)
            if over is not None:
                # the ring overflowed its depth: the one place the bulk lane waits
                retired += self._retire_bulk(over)
        return retired

    @staticmethod
    def _entry_ready(entry: InflightEntry) -> bool:
        """Whether a batch's outputs have landed (its event, never a sync)."""
        return entry.res.ready()

    def _ensure_bulk_replica(self) -> None:
        eng = self.engine
        refresh_due = (self.cfg.dhcp_refresh_every > 0
                       and self._bulk_seq % self.cfg.dhcp_refresh_every == 0)
        if (self._bulk_dhcp is not None and not refresh_due
                and self._replica_resync == eng.resync_count):
            return
        # the reference's `_copy_to_bulk`: a transfer to the engine's card
        # when the authority lives on the express card (behind the express
        # lane's writes, ordered by events between the cards' streams), a
        # fresh copy otherwise; never a tensor the express chain holds
        self._bulk_dhcp = dhcp_to(eng.tables.dhcp, eng.device)
        self._replica_resync = eng.resync_count
        self._replica_refreshes += 1

    def _dispatch_bulk(self, pend, now: float, reason: str) -> InflightEntry | None:
        """Dispatch one bulk batch; returns the completion-ring overflow
        entry the caller must retire, if any."""
        if not pend:
            return None
        eng = self.engine
        tok = tele.begin_batch(tele.LANE_BULK_L, len(pend))
        if tok is not None:
            tele.observe(tele.LANE_WAIT, (now - pend[0].enq_t) * 1e6, tok)
        B = self.bulk.cfg.batch
        pkt, length = eng._pack_frames([p.frame for p in pend], B)
        fa = np.zeros((B,), dtype=bool)
        fa[: len(pend)] = [p.from_access for p in pend]
        t0 = tele.t()
        try:
            self._ensure_bulk_replica()
            # a prefetched drain ships with the next step whatever the
            # cadence says: its dirty slots are already drained on the host
            upd, self._prefetched_upd = self._prefetched_upd, None
            drain = (upd is not None or self.cfg.drain_every <= 1
                     or self._bulk_seq % self.cfg.drain_every == 0)
            before = eng.resync_count
            try:
                res, self._bulk_dhcp = eng.dispatch_scheduled_bulk(
                    pkt, length, fa, now, self._bulk_dhcp, drain=drain, upd=upd)
            except BaseException:
                # the batch is lost, the prefetched drain must not be
                self._prefetched_upd = upd
                raise
        except BaseException:
            tele.cancel_batch(tok)  # a failed dispatch must not leak a slot
            raise
        tele.lap(tele.DISPATCH, t0, tok)
        if eng.resync_count != before:
            # a resync inside the drain: rebuild the replica next dispatch
            self._replica_resync = -1
        self._bulk_seq += 1
        if drain:
            self._drains_applied += 1
        if self.cfg.overlap_drain and (self.cfg.drain_every <= 1
                                       or self._bulk_seq % self.cfg.drain_every == 0):
            self._prefetched_upd = eng.prefetch_bulk_updates()
            self._drains_prefetched += 1
        self._observe_dispatch(LANE_BULK, len(pend), reason)
        return self._bulk_ring.push(InflightEntry(_InFlight(res), pend, now, reason, trace=tok))

    def _retire_bulk(self, entry: InflightEntry) -> int:
        """Wait for one bulk batch and demux its verdicts."""
        eng = self.engine
        n = len(entry.pending)
        tele.focus(entry.trace)
        t0 = tele.t()
        h = entry.res.wait()
        tele.lap(tele.DEVICE_WAIT, t0, entry.trace)
        eng._fold_stats(entry.res.stat_names, h["stats"])
        vv, out_len, out_rows = h["verdict"][:n], h["out_len"], h["out_pkt"]
        punt, viol = h["nat_punt"][:n], h["spoof_violation"][:n]
        now = self.clock()
        # NAT punts stay inline; everything else drains through the slow
        # path in one batch
        slow_items = []
        punts = 0
        for i, p in enumerate(entry.pending):
            if int(vv[i]) in (VERDICT_TX, VERDICT_FWD, VERDICT_DROP):
                continue
            if punt[i]:
                punts += 1
                eng._punt(p.frame, entry.dispatch_t, i, path="sched_bulk")
            else:
                slow_items.append((i, p.frame, p.enq_t))
        replies = dict(eng._handle_slow_lanes(slow_items, "sched_bulk"))
        t0 = tele.t()
        for i, p in enumerate(entry.pending):
            v = int(vv[i])
            if v == VERDICT_TX or v == VERDICT_FWD:
                frame = bytes(out_rows[i, : int(out_len[i])])
                if v == VERDICT_TX:
                    eng.stats.tx += 1
                    self._complete(p, LANE_BULK, "tx", frame, now)
                else:
                    eng.stats.fwd += 1
                    self._complete(p, LANE_BULK, "fwd", frame, now)
            elif v == VERDICT_DROP:
                eng.stats.dropped += 1
                self._complete(p, LANE_BULK, "drop", None, now)
            else:
                eng.stats.passed += 1
                self._complete(p, LANE_BULK, "slow", replies.get(i), now)
            if viol[i] and eng.violation_sink is not None:
                eng.violation_sink(i, p.frame)
        tele.lap(tele.REPLY, t0, entry.trace)
        tele.end_batch(entry.trace, punt=punts)
        self._observe_retire(LANE_BULK, entry, now)
        return n

    # -- completions and counters --

    def _complete(self, p, lane: str, verdict: str, frame, now: float) -> None:
        if len(self.completions) >= self._COMPLETIONS_CAP:
            self.completions.popleft()
            self.completions_dropped += 1
        self.completions.append(Completion(p.tag, lane, verdict, frame, p.from_access,
                                           now - p.enq_t))

    def drain_completions(self) -> list[Completion]:
        out = list(self.completions)
        self.completions.clear()
        return out

    def _observe_dispatch(self, lane: str, n: int, reason: str) -> None:
        """The metrics hook at a dispatch: the lane's counts, and with
        `metrics` the dispatch counter and the batch occupancy histogram."""
        obs = self.observed[lane]
        obs["dispatches"] += 1
        obs["frames"] += n
        m = self.metrics
        if m is None:
            return
        batch = (self.express if lane == LANE_EXPRESS else self.bulk).cfg.batch
        m.sched_dispatches.inc(lane=lane, close=reason)
        m.sched_batch_occupancy.observe(n / batch, lane=lane)

    def _observe_retire(self, lane: str, entry: InflightEntry, now: float) -> None:
        """The metrics hook at a retire: the lane's count, and with
        `metrics` the batch's latency (its oldest frame's, the worst case)
        and the frames counter."""
        self.observed[lane]["retired"] += len(entry.pending)
        m = self.metrics
        if m is None:
            return
        if entry.pending:
            m.sched_dispatch_latency.observe(now - entry.pending[0].enq_t, lane=lane)
        m.sched_frames.inc(len(entry.pending), lane=lane)

    def stats_snapshot(self) -> dict:
        """The lanes' counters."""
        out = {}
        for name, lane, ring in ((LANE_EXPRESS, self.express, self._express_ring),
                                 (LANE_BULK, self.bulk, self._bulk_ring)):
            s = lane.stats
            out[name] = {
                "queue_depth": len(lane),
                "inflight": len(ring),
                "enqueued": s.enqueued,
                "dropped_overflow": s.dropped_overflow,
                "frames_dispatched": s.frames_dispatched,
                "batches": s.batches,
                "batches_full": s.batches_full,
                "batches_deadline": s.batches_deadline,
                "batches_flush": s.batches_flush,
                "occupancy_avg": round(s.occupancy_avg(), 4),
            }
        out["bulk"]["drains_applied"] = self._drains_applied
        out["bulk"]["drains_prefetched"] = self._drains_prefetched
        out["bulk"]["replica_refreshes"] = self._replica_refreshes
        dev = self._express_dev
        out["express"]["own_device"] = str(dev) if dev is not None else None
        out["express"]["aot_enabled"] = self._aot_enabled
        out["express"]["aot_dispatches"] = self.express_aot_dispatches
        out["express"]["jit_dispatches"] = self.express_jit_dispatches
        out["express"]["aot_misses"] = self.express_aot_misses
        out["express"]["loop"] = self.express_loop
        out["express"]["fallbacks"] = dict(self.express_fallbacks)
        if self._devloop is not None:
            out["express"]["devloop"] = self._devloop.stats()
        out["completions_dropped"] = self.completions_dropped
        out["oversize_dropped"] = self.oversize_dropped
        return out

    # -- the batch-synchronous facade --

    # Engine.process-shaped surface so DHCPBenchmark can drive the
    # scheduler unmodified (it reads .stats and .fastpath for counters)
    @property
    def stats(self):
        return self.engine.stats

    @property
    def fastpath(self):
        return self.engine.fastpath

    def process(self, frames: list[bytes], from_access: list[bool] | bool = True,
                now: float | None = None) -> dict:
        """Submit a frame list, flush, and return Engine.process-shaped
        verdict lists keyed by submission index (a mixed list still fans
        out to both lanes)."""
        out = {"tx": [], "fwd": [], "dropped": [], "slow": []}
        start = self._seq
        for i, f in enumerate(frames):
            fa = from_access if isinstance(from_access, bool) else from_access[i]
            if self.submit(f, fa, now=now) is None:
                out["dropped"].append(i)
        self.flush(now=now)
        for c in self.drain_completions():
            if not isinstance(c.tag, int) or c.tag < start:
                continue  # a completion from earlier poll-mode use
            i = c.tag - start
            if c.verdict in ("tx", "fwd"):
                out[c.verdict].append((i, c.frame))
            elif c.verdict == "drop":
                out["dropped"].append(i)
            else:
                out["slow"].append((i, c.frame))
        for k in ("tx", "fwd", "slow"):
            out[k].sort(key=lambda t: t[0])
        out["dropped"].sort()
        return out
