"""Near-zero-overhead span tracing: the telemetry hook API (a copy of
`bng_tpu/telemetry/spans.py`).

Design constraints, in order:

1. **Disarmed cost ~ zero.** Every instrumented call site pays one
   function call, one module-global load and one `is None` compare when
   no tracer is armed. No locks, no dict lookups, no allocation on the
   disarmed path.
2. **Stages, not free-form names.** The packet lifecycle is a fixed
   stage vocabulary (small-int indexes into preallocated arrays), so an
   armed stamp costs array stores, not string hashing:

       ring        ring pop / assemble into the staging batch
       admit       admission verdicts
       lane_wait   scheduler lane enqueue -> dispatch (oldest frame)
       dispatch    host-side dispatch (update drain + enqueue on the stream)
       device      device execution, fed only from CUDA events, never
                   from host wall time: the event pair around the
                   express program's graph replay, observed at the
                   express lane's retire (armed, on the card; the CPU
                   has no graph and gives no sample)
       device_wait host blocked on the device's outputs (the event wait
                   behind a batch's copies; report next to `device`,
                   never as it)
       fleet       slow-path fleet scatter/gather
       worker      per-frame worker handler time
       slow_path   slow-path drain total (engine._handle_slow_lanes)
       reply       verdict demux + reply encode/inject
       wire_rx     wire pump ingress
       wire_tx     wire pump egress
       drain       inside a dispatch: the DHCP chain's placement, the
                   host->device update drain and its apply
       upload      inside a dispatch: the staged batch, lane flags,
                   `now` and descriptors onto the device
       issue       inside a dispatch: the device program's ops issued
                   (the fused step, the DHCP-only program, the express
                   graph's replay); its stages below lap inside it
       collect     the batch's output copies and their events queued
                   (engine._InFlight)
       parse .. nat_accounting
                   the device program's stages, host time issuing each
                   (ops/pipeline.py; the DHCP-only program laps parse,
                   dhcp and verdict)
       ring_dma    inside `upload`: the zero-copy ring loop's gather of a
                   batch's frames from the mapped UMEM (its launch)
       total       batch begin -> end (the client-visible wall time)

3. **Tracing is observation.** A span never mutates subsystem state;
   arming swaps one module global; telemetry failures never fault the
   dataplane (the recorder swallows its own I/O errors). A hook reads the
   host clock (`time.perf_counter_ns`) only, never a device tensor, so it
   never synchronizes the stream.

Three granularities:

- `t()` / `lap(stage, t0)`: the hot-path pair: `t()` returns None when
  disarmed, `lap` no-ops on a None origin. Two hook calls per
  instrumented region.
- `span(stage)`: context-manager sugar for coarse paths (CLI, tests).
- `region(stage)`: the program's stage hook, one `with` around a region
  of the engine or the device program. Armed, it laps the stage on the
  current record (the batch being dispatched or retired); while a torch
  profiler records (`torch.autograd.profiler._is_profiler_enabled`), it
  also opens the range `bng::<stage>`, so a profiler trace shows the
  program's own stages. While a ring program records
  (`runtime/ringprog.py`), its recorder listens to every region's bounds
  (`listen`), where the program's captured segments end. None of these,
  it is two global loads, a flag read and the shared no-op. This module
  imports no torch: the flag's module is bound at the first `region`
  call.

Per-batch flight records: `begin_batch(lane, n)` opens a record slot
(preallocated pool, allocation-free), `stamp`/`lap`/`add` fill it, and
`end_batch(tok)` finalizes it into the FlightRecorder ring where the
anomaly triggers live (recorder.py).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from bng_tpu_torch.telemetry.hist import LatencyHist

# stage ids — array indexes; keep STAGE_NAMES in lockstep (and TOTAL
# LAST — the recorder indexes it as NSTAGES-1). `ops` is the
# zero-downtime-transition stage (blue/green engine swap phases,
# runtime/ops.py):
# each transition phase records one lap, so the histogram answers "how
# long do operational state moves stall the dataplane". The loop_*
# stages attribute the devloop ring pump (devloop/host.py): fill = rows
# into the ring slot, wait = slot staged -> ring dispatch (the latency
# the k-amortization trades away), retire = ring force + per-slot demux.
# The stages after wire_tx are the port's own (the reference has none of
# them): the dispatch's parts and the device program's stages, each lapped
# by `region`. Their ids come after the reference's and before TOTAL, so
# every id the reference has but TOTAL's is the same in both.
(RING, ADMIT, LANE_WAIT, DISPATCH, LOOP_FILL, LOOP_WAIT, LOOP_RETIRE,
 DEVICE, DEVICE_WAIT, FLEET, WORKER, SLOW, REPLY, OPS, WIRE_RX, WIRE_TX,
 DRAIN, UPLOAD, ISSUE, COLLECT, PARSE, ANTISPOOF, DHCP, GARDEN, NAT44, QOS,
 EDGE, PPPOE_DECAP, PPPOE_ENCAP, VERDICT, NAT_ACCOUNTING, RING_DMA,
 TOTAL) = range(33)
STAGE_NAMES = ("ring", "admit", "lane_wait", "dispatch", "loop_fill",
               "loop_wait", "loop_retire", "device", "device_wait",
               "fleet", "worker", "slow_path", "reply", "ops", "wire_rx",
               "wire_tx", "drain", "upload", "issue", "collect", "parse",
               "antispoof", "dhcp", "garden", "nat44", "qos", "edge",
               "pppoe_decap", "pppoe_encap", "verdict", "nat_accounting",
               "ring_dma", "total")
# the torch profiler range each stage's region opens
RANGE_NAMES = tuple(f"bng::{name}" for name in STAGE_NAMES)
NSTAGES = len(STAGE_NAMES)

# lane ids for batch records
LANE_ENGINE, LANE_EXPRESS_L, LANE_BULK_L, LANE_RING_L, LANE_BENCH = range(5)
LANE_NAMES = ("engine", "express", "bulk", "ring", "bench")


class Tracer:
    """Armed runtime: per-stage histograms + open-batch record slots +
    (optionally) a bounded span-event log for Chrome-trace export."""

    OPEN_SLOTS = 16  # > max in-flight batches (sched depth + pipelined)

    def __init__(self, recorder=None, keep_events: int = 0,
                 clock=time.perf_counter_ns):
        self.recorder = recorder
        self.clock = clock
        self.hists = [LatencyHist() for _ in range(NSTAGES)]
        k = self.OPEN_SLOTS
        self._open_dur = np.zeros((k, NSTAGES), dtype=np.float64)  # us
        self._open_stamp = np.zeros((k, NSTAGES), dtype=np.int64)  # ns rel t0
        self._open_meta = np.zeros((k, 4), dtype=np.int64)  # lane,n,shed,punt
        self._open_t0 = np.zeros(k, dtype=np.int64)
        self._free = list(range(k))
        self._cur: int | None = None
        self.seq = 0
        self.records_dropped = 0
        # (stage, lane, t0_ns, dur_ns) span events for trace export
        self.events: deque | None = (deque(maxlen=keep_events)
                                     if keep_events else None)
        # one anchor pair, read together: the spans' clock
        # (perf_counter_ns) and the wall clock a torch profiler stamps its
        # trace with (time.time_ns()), so an export lays the spans on the
        # profiler's timebase (recorder.chrome_trace)
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def wall_ns(self, t_ns: int) -> int:
        """A span-clock reading on the wall clock (ns since the epoch),
        through the anchor pair; durations stay on the span clock."""
        return self.anchor[1] + (int(t_ns) - self.anchor[0])

    # -- batch records ----------------------------------------------------

    def begin(self, lane: int, size: int) -> int | None:
        if not self._free:
            self.records_dropped += 1
            return None
        tok = self._free.pop()
        self._open_dur[tok] = 0.0
        self._open_stamp[tok] = 0
        self._open_meta[tok] = (lane, size, 0, 0)
        self._open_t0[tok] = self.clock()
        self._cur = tok
        return tok

    def end(self, tok: int, punt: int = 0, shed: int = 0) -> None:
        now = self.clock()
        total_us = (now - self._open_t0[tok]) / 1000.0
        self._open_dur[tok, TOTAL] = total_us
        self.hists[TOTAL].record(total_us)
        if punt:
            self._open_meta[tok, 3] += punt
        if shed:
            self._open_meta[tok, 2] += shed
        if self.events is not None:
            self.events.append((TOTAL, int(self._open_meta[tok, 0]),
                                int(self._open_t0[tok]),
                                now - int(self._open_t0[tok])))
        if self.recorder is not None:
            lane, n, rshed, rpunt = (int(x) for x in self._open_meta[tok])
            self.recorder.push(lane, n, rshed, rpunt, self.seq,
                               self._open_dur[tok], self._open_stamp[tok])
        self.seq += 1
        self._free.append(tok)
        if self._cur == tok:
            self._cur = None

    def cancel(self, tok: int) -> None:
        """Release an open slot without recording (dispatch crashed)."""
        if tok not in self._free:
            self._free.append(tok)
        if self._cur == tok:
            self._cur = None

    def focus(self, tok) -> None:
        """Make `tok` the target of token-less laps (the retire path of a
        pipelined batch, where helpers don't thread the token)."""
        if tok is not None and tok not in self._free:
            self._cur = tok

    # -- span primitives --------------------------------------------------

    def lap(self, stage: int, t0: int, tok: int | None = None) -> None:
        now = self.clock()
        dur_us = (now - t0) / 1000.0
        self.hists[stage].record(dur_us)
        tok = tok if tok is not None else self._cur
        if tok is not None:
            self._open_dur[tok, stage] += dur_us
        if self.events is not None:
            lane = int(self._open_meta[tok, 0]) if tok is not None else 0
            self.events.append((stage, lane, t0, now - t0))

    def stamp(self, stage: int, tok: int | None = None) -> None:
        """Point event: ns offset of reaching `stage` within the open
        batch record (flight records carry stage timestamps AND stage
        durations)."""
        tok = tok if tok is not None else self._cur
        if tok is None:
            return
        self._open_stamp[tok, stage] = self.clock() - self._open_t0[tok]

    def observe(self, stage: int, dur_us: float,
                tok: int | None = None) -> None:
        """Feed an externally measured duration (lane wait computed from
        enqueue timestamps, profiler-fenced device time)."""
        self.hists[stage].record(dur_us)
        tok = tok if tok is not None else self._cur
        if tok is not None:
            self._open_dur[tok, stage] += dur_us
        if self.events is not None:
            lane = int(self._open_meta[tok, 0]) if tok is not None else 0
            now = self.clock()
            self.events.append((stage, lane, now - int(dur_us * 1000),
                                int(dur_us * 1000)))

    def observe_many(self, stage: int, us_values) -> None:
        """Bulk histogram feed (bench's profiler distributions)."""
        self.hists[stage].record_many(us_values)

    def add(self, tok: int | None = None, shed: int = 0,
            punt: int = 0) -> None:
        """Count sheds/punts against the open record; shed counts with no
        open record still reach the recorder's burst detector."""
        tok = tok if tok is not None else self._cur
        if tok is not None:
            self._open_meta[tok, 2] += shed
            self._open_meta[tok, 3] += punt
        elif shed and self.recorder is not None:
            self.recorder.note_shed(shed)

    # -- queries ----------------------------------------------------------

    def merge_stage(self, stage: int, hist_dict: dict) -> None:
        """Fold a serialized worker/shard histogram into a stage (the
        cross-process merge — control/fleet.py ships these in worker
        stats payloads)."""
        self.hists[stage].merge(LatencyHist.from_dict(hist_dict))

    def breakdown(self) -> dict:
        """{stage: {count, p50_us, p99_us, p999_us, mean_us, max_us}} for
        every stage with samples — the BENCH JSON `stage_breakdown`."""
        return {STAGE_NAMES[i]: h.summary()
                for i, h in enumerate(self.hists) if h.n}

    def snapshot(self) -> dict:
        return {
            "records": self.seq,
            "records_dropped": self.records_dropped,
            "stages": self.breakdown(),
            "recorder": (self.recorder.snapshot_meta()
                         if self.recorder is not None else None),
        }


# ---------------------------------------------------------------------------
# the hot-path hooks (module-level no-ops when disarmed)
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def enabled() -> bool:
    return _ACTIVE is not None


def tracer() -> Tracer | None:
    return _ACTIVE


def t() -> int | None:
    """Span origin. Disarmed (the production state) this is a global
    load + None compare — nothing else."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.clock()


def lap(stage: int, t0: int | None, tok: int | None = None) -> None:
    """Close a span opened with t(). No-ops when disarmed at open time
    (t0 None) or now."""
    if _ACTIVE is None or t0 is None:
        return
    _ACTIVE.lap(stage, t0, tok)


def stamp(stage: int, tok: int | None = None) -> None:
    if _ACTIVE is None:
        return
    _ACTIVE.stamp(stage, tok)


def observe(stage: int, dur_us: float, tok: int | None = None) -> None:
    if _ACTIVE is None:
        return
    _ACTIVE.observe(stage, dur_us, tok)


def begin_batch(lane: int, size: int) -> int | None:
    if _ACTIVE is None:
        return None
    return _ACTIVE.begin(lane, size)


def end_batch(tok: int | None, punt: int = 0, shed: int = 0) -> None:
    if _ACTIVE is None or tok is None:
        return
    _ACTIVE.end(tok, punt=punt, shed=shed)


def cancel_batch(tok: int | None) -> None:
    if _ACTIVE is None or tok is None:
        return
    _ACTIVE.cancel(tok)


def focus(tok: int | None) -> None:
    if _ACTIVE is None:
        return
    _ACTIVE.focus(tok)


def add(tok: int | None = None, shed: int = 0, punt: int = 0) -> None:
    if _ACTIVE is None:
        return
    _ACTIVE.add(tok, shed=shed, punt=punt)


def trigger(reason: str, detail: str = "") -> str | None:
    """Anomaly hook: asks the armed recorder to dump the flight ring.
    Disarmed: global load + None compare (instrumented at worker death,
    invariant violations, backend fallback)."""
    if _ACTIVE is None or _ACTIVE.recorder is None:
        return None
    return _ACTIVE.recorder.trigger(reason, detail)


def set_meta(key: str, value) -> None:
    """Stamp a fact into the flight-record ring metadata — the
    backend-identity discipline (recorder.set_backend) generalized: the
    serving identity is per-process/per-path state, not per-batch, so
    it rides `meta` and lands in every dump. Used by the scheduler to
    record which express program (aot-express vs jit-full) served the
    last dispatch, so a fallback storm is diagnosable from one dump.
    Disarmed: global load + None compare."""
    if _ACTIVE is None or _ACTIVE.recorder is None:
        return
    _ACTIVE.recorder.meta[key] = value


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def discard(self) -> None:
        pass

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("stage", "tok", "t0")

    def __init__(self, stage: int, tok: int | None):
        self.stage = stage
        self.tok = tok

    def __enter__(self):
        self.t0 = _ACTIVE.clock() if _ACTIVE is not None else None
        return self

    def __exit__(self, *exc):
        lap(self.stage, self.t0, self.tok)
        return False


def span(stage: int, tok: int | None = None):
    """Context-manager span for coarse paths. Disarmed: returns a shared
    no-op singleton (global load + compare + attribute-free enter/exit)."""
    if _ACTIVE is None:
        return _NOOP
    return _Span(stage, tok)


# torch.autograd.profiler once the first region() has bound it: this module
# imports no torch (a spawned slow-path worker imports telemetry alone)
_profiler = None


def _bind_profiler():
    global _profiler
    import torch.autograd.profiler as prof

    _profiler = prof
    return prof


# a ring program's recorder while it records (`runtime/ringprog.Tape`): told
# where each region opens and closes, so its segments end at stage bounds
_LISTENER = None


def listen(listener) -> None:
    """Tell `listener` (`.enter(stage)` / `.exit(stage)`) of every region's
    bounds until `listen(None)`."""
    global _LISTENER
    _LISTENER = listener


class _Region:
    __slots__ = ("stage", "t0", "rf")

    def __init__(self, stage: int):
        self.stage = stage

    def __enter__(self):
        ls = _LISTENER  # read once: `listen(None)` may run in another thread
        if ls is not None:
            ls.enter(self.stage)
        self.rf = None
        prof = _profiler or _bind_profiler()
        if prof._is_profiler_enabled:
            self.rf = prof.record_function(RANGE_NAMES[self.stage])
            self.rf.__enter__()
        # timed inside the range: the range's own cost is not the stage's
        self.t0 = _ACTIVE.clock() if _ACTIVE is not None else None
        return self

    def discard(self) -> None:
        """Leave this region out of its stage (an empty ring poll holds no
        batch); a profiler range still closes."""
        self.t0 = None

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:  # a failed region is not timed
            lap(self.stage, self.t0)
            ls = _LISTENER
            if ls is not None:
                ls.exit(self.stage)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


def region(stage: int):
    """The program's stage hook: `with tele.region(tele.DHCP): ...`.

    Armed, the region laps `stage` on the current record (the batch being
    dispatched or retired: `begin_batch` and `focus` set it, so no token
    is threaded through). While a torch profiler records, it also opens
    the range `bng::<stage>`. A listener (`listen`) is told of its bounds.
    None of these: two global loads, a flag read and the shared no-op,
    with no allocation and no profiler call."""
    if (_ACTIVE is None and _LISTENER is None
            and not (_profiler or _bind_profiler())._is_profiler_enabled):
        return _NOOP
    return _Region(stage)


def arm(tr: Tracer) -> Tracer:
    global _ACTIVE
    _ACTIVE = tr
    return tr


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


class armed:
    """Context manager: arm a tracer for the block, disarm on exit —
    exceptions included (a failed bench can never leak an armed tracer
    into the next test)."""

    def __init__(self, tr: Tracer | None = None, recorder=None,
                 keep_events: int = 0):
        self.tracer = tr if tr is not None else Tracer(
            recorder=recorder, keep_events=keep_events)

    def __enter__(self) -> Tracer:
        return arm(self.tracer)

    def __exit__(self, *exc) -> None:
        disarm()
