"""Telemetry subsystem: span tracing, flight recorder, mergeable
stage-latency histograms (see spans.py / recorder.py / hist.py); the
port's copy of `bng_tpu/telemetry/`.

Import surface: `from bng_tpu_torch.telemetry import spans` at
instrumented call sites (module-level hooks, fault_point-style disarmed
cost); Tracer/FlightRecorder/LatencyHist here for composition roots. The
SLO engine (slo.py) and the perf ledger/gate (ledger.py) are imported
as submodules by their consumers: importing the ledger loads no device
runtime.
"""

from bng_tpu_torch.telemetry.hist import LatencyHist, NBUCKETS
from bng_tpu_torch.telemetry.recorder import (FlightRecorder, RecorderConfig,
                                              chrome_trace, default_trace_dir)
from bng_tpu_torch.telemetry.slo import (DEFAULT_SLOS, HEADLINE_TARGETS,
                                         BudgetLine, SLOMonitor, SLOSpec,
                                         check_budget)
from bng_tpu_torch.telemetry.spans import (NSTAGES, STAGE_NAMES, Tracer, arm,
                                           armed, disarm)

__all__ = [
    "LatencyHist", "NBUCKETS", "FlightRecorder", "RecorderConfig",
    "chrome_trace", "default_trace_dir", "NSTAGES", "STAGE_NAMES",
    "Tracer", "arm", "armed", "disarm", "SLOSpec", "SLOMonitor",
    "DEFAULT_SLOS", "HEADLINE_TARGETS", "BudgetLine", "check_budget",
]
