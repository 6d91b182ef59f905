"""Per-batch flight recorder: last-N ring + anomaly-triggered dumps (a copy
of `bng_tpu/telemetry/recorder.py`).

When every aggregate metric looks healthy but the system is quietly
degraded, the evidence of what the last milliseconds looked like must
already have been recorded. So:

- a FIXED-SIZE, allocation-free ring of the last N batch records (stage
  timestamps + stage durations, lane, batch size, shed/punt counts;
  backend identity rides the ring metadata: it is per-process, not
  per-batch, and the composition root sets it to "gpu" when the engine
  serves on a CUDA device and "cpu" otherwise), written by Tracer.end on
  every finalized batch;
- ANOMALY TRIGGERS that dump the ring to a bounded JSON file the moment
  something crosses a line, not at the end of a run:
    latency_excursion    batch total over the configured budget
    shed_burst           admission shed count over the burst threshold
    worker_death         a slow-path worker died
    invariant_violation  the cross-authority auditor found one (chaos/)
    backend_fallback     a run served on another backend than expected
    slo_breach           a per-stage latency budget was burned
    express_aot_miss     an express dispatch found no express program
    express_fallback     the express lane fell back a rung
- dump volume is bounded twice: a min interval between dumps and a hard
  per-process dump cap, so a flapping trigger can't fill a disk.

Telemetry never faults the dataplane: every filesystem error is
swallowed and counted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from bng_tpu_torch.telemetry.spans import LANE_NAMES, NSTAGES, STAGE_NAMES

TRIG_LATENCY = "latency_excursion"
TRIG_SHED = "shed_burst"
TRIG_WORKER = "worker_death"
TRIG_INVARIANT = "invariant_violation"
TRIG_BACKEND = "backend_fallback"
# an SLO burn-rate window (telemetry/slo.py SLOMonitor) or a storm
# budget (slo.check_budget) crossed its per-stage latency budget
TRIG_SLO = "slo_breach"
# an express dispatch found no express program for its batch geometry
# and fell back to the DHCP-only program: the gray-failure class where a
# fallback storm serves every OFFER through the slow architecture while
# the aggregate counters look healthy
TRIG_EXPRESS_AOT_MISS = "express_aot_miss"
# a requested NIC attach (run --wire-if) landed on the memory rung: the
# in-memory ring keeps serving, so every aggregate
# counter looks healthy while zero packets touch the wire — the silent
# fallback must dump the flight ring and flip bng_wire_rung, never
# masquerade as wire serving
TRIG_WIRE_FALLBACK = "wire_rung_fallback"
# the express lane fell back a rung: a ring program miss or build
# failure re-dispatching per batch, or the express program's own build
# failing back to the DHCP-only program. Without this trigger a node
# could serve every OFFER through the slow architecture with
# healthy-looking aggregate counters and no flight-record evidence
TRIG_EXPRESS_FALLBACK = "express_fallback"
# the cluster fabric's failure detector changed a member's verdict:
# suspect (beats stopped — possible partition), gray (beats
# flowing but the serving-health word stalled — Huang HotOS'17), or
# down (quorum of observers accused it). Suspicion transitions are the
# earliest cluster-failure evidence; the ring around one shows whether
# the beats died, the datagrams were rejected (bad sig / replay / skew
# counters) or the member wedged while still answering
TRIG_MEMBER_SUSPECT = "member_suspect"
# every fabric member on one host went DOWN by accusation quorum: the
# box vanished with both of its HA halves' state, so the surviving
# host's standbys promote as a group. The ring around the trigger shows
# the detection-to-promotion timeline
TRIG_HOST_LOSS = "host_loss"


def default_trace_dir() -> str:
    return (os.environ.get("BNG_TRACE_DIR")
            or os.path.join(tempfile.gettempdir(), "bng-flightrec"))


@dataclass
class RecorderConfig:
    capacity: int = 256  # last-N batch records kept
    latency_budget_us: float = 0.0  # batch-total excursion trigger; 0=off
    shed_burst: int = 64  # sheds in one batch (or one shed report)
    min_dump_interval_s: float = 1.0
    max_dumps: int = 16  # hard per-process cap
    out_dir: str = ""  # "" -> $BNG_TRACE_DIR or <tmp>/bng-flightrec


class FlightRecorder:
    def __init__(self, cfg: RecorderConfig | None = None,
                 clock=time.time):
        self.cfg = cfg or RecorderConfig()
        self.clock = clock
        n = self.cfg.capacity
        self._dur = np.zeros((n, NSTAGES), dtype=np.float64)
        self._stamp = np.zeros((n, NSTAGES), dtype=np.int64)
        self._meta = np.zeros((n, 5), dtype=np.int64)  # lane,n,shed,punt,seq
        self._t = np.zeros(n, dtype=np.float64)  # unix ts at finalize
        self._valid = np.zeros(n, dtype=bool)
        self._w = 0
        self.meta: dict = {"backend": "unknown"}
        self.triggers: dict[str, int] = {}
        self.dump_paths: list[str] = []
        self.dump_errors = 0
        self._last_dump_t = 0.0

    def set_backend(self, backend: str) -> None:
        self.meta["backend"] = backend

    # -- the ring (called by Tracer.end — must stay allocation-free) ------

    def push(self, lane: int, size: int, shed: int, punt: int, seq: int,
             dur_row: np.ndarray, stamp_row: np.ndarray) -> None:
        w = self._w
        self._dur[w] = dur_row  # row copy into preallocated storage
        self._stamp[w] = stamp_row
        self._meta[w, 0] = lane
        self._meta[w, 1] = size
        self._meta[w, 2] = shed
        self._meta[w, 3] = punt
        self._meta[w, 4] = seq
        self._t[w] = self.clock()
        self._valid[w] = True
        self._w = (w + 1) % self.cfg.capacity
        # anomaly checks on the record just written
        budget = self.cfg.latency_budget_us
        if budget > 0 and dur_row[NSTAGES - 1] > budget:  # TOTAL is last
            self.trigger(TRIG_LATENCY,
                         f"batch total {dur_row[NSTAGES - 1]:.1f}us > "
                         f"budget {budget:.1f}us")
        if shed >= self.cfg.shed_burst > 0:
            self.trigger(TRIG_SHED, f"{shed} sheds in one batch")

    def note_shed(self, n: int) -> None:
        """Shed report with no open batch record (fleet driven outside a
        traced batch): burst detection still applies."""
        if n >= self.cfg.shed_burst > 0:
            self.trigger(TRIG_SHED, f"{n} sheds in one report")

    # -- dumps ------------------------------------------------------------

    def trigger(self, reason: str, detail: str = "") -> str | None:
        """Record the trigger; dump unless rate-limited/capped. Returns
        the dump path (None when suppressed or the write failed)."""
        self.triggers[reason] = self.triggers.get(reason, 0) + 1
        now = self.clock()
        if len(self.dump_paths) >= self.cfg.max_dumps:
            return None
        if now - self._last_dump_t < self.cfg.min_dump_interval_s:
            return None
        self._last_dump_t = now
        return self.dump(reason, detail)

    def records(self) -> list[dict]:
        """Valid records, oldest first (the dump body)."""
        n = self.cfg.capacity
        order = [(self._w + i) % n for i in range(n)]
        out = []
        for i in order:
            if not self._valid[i]:
                continue
            stages = {STAGE_NAMES[s]: round(float(self._dur[i, s]), 2)
                      for s in range(NSTAGES) if self._dur[i, s] > 0.0}
            stamps = {STAGE_NAMES[s]: int(self._stamp[i, s])
                      for s in range(NSTAGES) if self._stamp[i, s] > 0}
            lane = int(self._meta[i, 0])
            out.append({
                "seq": int(self._meta[i, 4]),
                "t": round(float(self._t[i]), 6),
                "lane": (LANE_NAMES[lane] if lane < len(LANE_NAMES)
                         else str(lane)),
                "n": int(self._meta[i, 1]),
                "shed": int(self._meta[i, 2]),
                "punt": int(self._meta[i, 3]),
                "stages_us": stages,
                "stamps_ns": stamps,
            })
        return out

    def dump(self, reason: str, detail: str = "",
             path: str | None = None) -> str | None:
        """Write the ring to a bounded JSON file (capacity is fixed, so
        the file is ~O(100 KB) worst case). Never raises."""
        body = {
            "reason": reason,
            "detail": detail,
            "t": self.clock(),
            "meta": dict(self.meta),
            "triggers": dict(self.triggers),
            "records": self.records(),
        }
        try:
            if path is None:
                out_dir = self.cfg.out_dir or default_trace_dir()
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(
                    out_dir,
                    f"flight-{int(self.clock() * 1000)}-{reason}.json")
            elif os.path.dirname(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f)
            os.replace(tmp, path)
        except OSError:
            self.dump_errors += 1
            return None
        self.dump_paths.append(path)
        return path

    def snapshot_meta(self) -> dict:
        return {
            "backend": self.meta.get("backend", "unknown"),
            "valid_records": int(self._valid.sum()),
            "capacity": self.cfg.capacity,
            "triggers": dict(self.triggers),
            "dumps": list(self.dump_paths),
            "dump_errors": self.dump_errors,
        }


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

def chrome_trace(tracer, label: str = "bng-tpu", base_ns: int | None = None) -> dict:
    """Convert a Tracer's span-event log (built with keep_events > 0)
    into Chrome Trace Event JSON — loads in chrome://tracing and
    Perfetto. One pid (this process), one tid per lane, "X" complete
    events with ts/dur in microseconds (the format's unit).

    The events sit on a torch profiler trace's timebase: each event's
    wall-clock time (the tracer's anchor pair) is `baseTimeNanoseconds +
    ts * 1000` ns since the epoch, as in torch's `export_chrome_trace`.
    `base_ns` is that base: give a profiler trace's `baseTimeNanoseconds`
    and the two files' `ts` agree, so they open together in Perfetto;
    by default it is the first event's wall-clock second. Durations are
    the span clock's."""
    if tracer.events is None:
        raise ValueError("tracer was built without keep_events — "
                         "no span events to export")
    events = list(tracer.events)
    if base_ns is None:
        first = min((t0 for _s, _l, t0, _d in events), default=tracer.anchor[0])
        base_ns = tracer.wall_ns(first) // 10**9 * 10**9
    shift = tracer.wall_ns(0) - base_ns  # span clock -> ns since the base
    out = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": label}}]
    lanes = sorted({lane for _s, lane, _t, _d in events})
    for lane in lanes:
        out.append({"ph": "M", "name": "thread_name", "pid": 0,
                    "tid": int(lane),
                    "args": {"name": f"lane:{LANE_NAMES[lane]}"
                             if lane < len(LANE_NAMES) else f"lane:{lane}"}})
    for stage, lane, t0, dur_ns in events:
        out.append({
            "name": STAGE_NAMES[stage],
            "cat": "bng",
            "ph": "X",
            "pid": 0,
            "tid": int(lane),
            "ts": (int(t0) + shift) / 1000.0,
            "dur": max(dur_ns, 1) / 1000.0,
        })
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": int(base_ns),
        "otherData": {"tool": label,
                      "stages": list(STAGE_NAMES),
                      "records": tracer.seq},
    }
