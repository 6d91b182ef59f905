"""Span tracing hooks (the part of `bng_tpu/telemetry/spans.py` the port calls).

The blue/green swap times each of its phases with `t()` / `lap(OPS, t0)`,
and the invariant audit calls `trigger(reason)` on a violation. Disarmed
(the production state) every hook is one module-global load and one
`is None` compare. Armed (`with armed() as tr:`), a `Tracer` keeps one
latency histogram per stage, and `tr.breakdown()` reads them. The stage
ids are the reference's. Its batch records, span-event log, `span`
context manager and flight recorder come with the scheduler's telemetry;
`trigger` reaches a recorder only when the caller hands the `Tracer` one.
"""

from __future__ import annotations

import time

from bng_tpu_torch.telemetry.hist import LatencyHist

# stage ids — array indexes, in lockstep with STAGE_NAMES. `ops` is the
# zero-downtime-transition stage: each blue/green swap phase records one
# lap, so its histogram answers "how long do state moves stall the
# dataplane".
(RING, ADMIT, LANE_WAIT, DISPATCH, LOOP_FILL, LOOP_WAIT, LOOP_RETIRE,
 DEVICE, DEVICE_WAIT, FLEET, WORKER, SLOW, REPLY, OPS, WIRE_RX, WIRE_TX,
 TOTAL) = range(17)
STAGE_NAMES = ("ring", "admit", "lane_wait", "dispatch", "loop_fill",
               "loop_wait", "loop_retire", "device", "device_wait",
               "fleet", "worker", "slow_path", "reply", "ops", "wire_rx",
               "wire_tx", "total")
NSTAGES = len(STAGE_NAMES)


class Tracer:
    """Armed runtime: one latency histogram per stage."""

    def __init__(self, recorder=None, clock=time.perf_counter_ns):
        self.recorder = recorder
        self.clock = clock
        self.hists = [LatencyHist() for _ in range(NSTAGES)]

    def lap(self, stage: int, t0: int) -> None:
        self.hists[stage].record((self.clock() - t0) / 1000.0)

    def breakdown(self) -> dict:
        """{stage: {count, p50_us, p99_us, p999_us, mean_us, max_us}} for
        every stage with samples."""
        return {STAGE_NAMES[i]: h.summary()
                for i, h in enumerate(self.hists) if h.n}


_ACTIVE: Tracer | None = None


def t() -> int | None:
    """Span origin; None when disarmed."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.clock()


def lap(stage: int, t0: int | None) -> None:
    """Close a span opened with t(). No-ops when disarmed at open time
    (t0 None) or now."""
    if _ACTIVE is None or t0 is None:
        return
    _ACTIVE.lap(stage, t0)


def trigger(reason: str, detail: str = "") -> str | None:
    """Anomaly hook: asks the armed tracer's recorder to dump its ring."""
    if _ACTIVE is None or _ACTIVE.recorder is None:
        return None
    return _ACTIVE.recorder.trigger(reason, detail)


class armed:
    """Context manager: arm a tracer for the block, disarm on exit —
    exceptions included."""

    def __init__(self, tr: Tracer | None = None, recorder=None):
        self.tracer = tr if tr is not None else Tracer(recorder=recorder)

    def __enter__(self) -> Tracer:
        global _ACTIVE
        _ACTIVE = self.tracer
        return self.tracer

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None
