"""Per-stage SLO engine (a copy of `bng_tpu/telemetry/slo.py`):
declarative latency budgets over the fixed stage vocabulary, evaluated
everywhere a stage histogram exists.

- ``SLOSpec``: a per-stage p99 budget (stage name validated against
  spans.STAGE_NAMES at construction: an SLO on a stage that does not
  exist is a configuration bug, not a silent no-op).
- ``DEFAULT_SLOS`` / ``HEADLINE_TARGETS``: the reference's default
  budgets, value for value, so both packages give the same verdict on
  the same breakdown. No budget here was derived on an H100.
- ``evaluate(breakdown)``: one-shot p99 verdict over a
  Tracer.breakdown() dict (loadtest reports).
- ``SLOMonitor``: the live half for `run`: rolling burn-rate windows
  over the armed tracer's stage histograms (windowed p99 from
  bucket-count deltas), breach -> ``slo_breach`` flight-recorder
  trigger + the bng_slo_* metric families (control/metrics.py).
- ``BudgetLine`` / ``check_budget``: the storm-suite budget checker
  (mean-based, `per` amortization, required stages with zero samples
  FAIL as coverage holes).

Thread model: SLOMonitor.tick runs on the `run` loop (under the app's
_ctl, like every other 1 Hz sweep); snapshot() is called from the
metrics scrape thread; both serialize on the monitor's own lock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from bng_tpu_torch.telemetry import spans as tele
from bng_tpu_torch.telemetry.hist import counts_percentile
from bng_tpu_torch.telemetry.spans import STAGE_NAMES

# the reference's default headline targets, kept value for value so the
# trend gate (telemetry/ledger.py) reads the same constants in both
# packages. Neither was measured or derived on an H100.
HEADLINE_TARGETS = {
    # p99 budget of the device-only OFFER program (the reference's default)
    "offer_device_only_p99_us": 50.0,
    # per-device packet-rate floor (the reference's default)
    "mpps_per_chip_floor": 12.5,
}


def _valid_stage(stage: str) -> None:
    if stage not in STAGE_NAMES:
        raise ValueError(
            f"unknown stage {stage!r}: SLOs bind to the fixed span "
            f"vocabulary {STAGE_NAMES}")


@dataclass(frozen=True)
class SLOSpec:
    """One per-stage p99 latency budget.

    ``per`` amortizes batch-scoped laps over the units of work one lap
    covers (frames per batch), mirroring BudgetLine. ``required=False``
    stages are skipped when they recorded nothing: in `run` the
    `device` stage is fed only by a profiling caller, and a
    live monitor must not page on absent traffic.
    """

    stage: str
    p99_limit_us: float
    per: float = 1.0
    required: bool = False
    description: str = ""

    def __post_init__(self):
        _valid_stage(self.stage)
        if self.p99_limit_us <= 0 or self.per <= 0:
            raise ValueError(
                f"SLOSpec({self.stage}): limit and per must be positive")


# The reference's default per-stage budgets, value for value. Envelopes
# sit far above a healthy run's stage times so a healthy run never
# flaps, while an order-of-magnitude excursion pages within burn_windows
# windows. `device` carries the reference's default headline budget: it
# is only ever fed device time from CUDA events (spans.py), never host
# wall time.
DEFAULT_SLOS: tuple[SLOSpec, ...] = (
    SLOSpec("ring", 5_000.0, description="ring pop + staging, per batch"),
    SLOSpec("admit", 2_000.0, description="admission verdicts, per batch"),
    SLOSpec("lane_wait", 50_000.0,
            description="scheduler enqueue -> dispatch (oldest frame)"),
    SLOSpec("dispatch", 50_000.0, description="host-side jitted dispatch"),
    SLOSpec("loop_fill", 2_000.0,
            description="devloop: descriptor rows -> ring slot, per batch"),
    SLOSpec("loop_wait", 100_000.0,
            description="devloop: slot staged -> ring dispatch (bounded "
                        "by the ring deadline)"),
    SLOSpec("loop_retire", 50_000.0,
            description="devloop: ring force + per-slot demux, amortized "
                        "per batch"),
    SLOSpec("device", HEADLINE_TARGETS["offer_device_only_p99_us"],
            description="device execution from CUDA events (the reference's "
                        "default budget)"),
    SLOSpec("device_wait", 200_000.0,
            description="host blocked forcing device outputs"),
    SLOSpec("fleet", 100_000.0, description="slow-path scatter/gather"),
    SLOSpec("worker", 20_000.0, description="per-frame worker handler"),
    SLOSpec("slow_path", 200_000.0, description="slow-path drain total"),
    SLOSpec("reply", 20_000.0, description="verdict demux + reply encode"),
    SLOSpec("ops", 2_000_000.0,
            description="zero-downtime transition phases"),
    SLOSpec("wire_rx", 5_000.0,
            description="wire pump ingress: kernel fill+RX -> ring "
                        "submit, per pump round"),
    SLOSpec("wire_tx", 5_000.0,
            description="wire pump egress: ring verdicts -> kernel TX "
                        "+ completion reap, per pump round"),
    SLOSpec("total", 500_000.0, description="batch begin -> end"),
)


def parse_budgets(specs: list[str]) -> tuple[SLOSpec, ...]:
    """Parse `stage:limit_us[:per]` strings into SLOSpecs — the
    `run --slo-budgets` / config-file `slo_budgets:` override
    surface. Unknown stages raise loudly."""
    out = []
    for s in specs:
        parts = s.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad SLO budget {s!r}: want stage:limit_us[:per]")
        stage, limit = parts[0], float(parts[1])
        per = float(parts[2]) if len(parts) == 3 else 1.0
        out.append(SLOSpec(stage, limit, per=per))
    return tuple(out)


def evaluate(breakdown: dict, slos: tuple[SLOSpec, ...] = DEFAULT_SLOS) -> dict:
    """One-shot p99 verdict over a Tracer.breakdown() dict.

    Same report shape as check_budget (ok + sorted breach names, with
    `stage:missing` for required stages that recorded nothing) so
    loadtest JSON and storm reports stay diffable with one vocabulary."""
    breaches = []
    for spec in slos:
        s = breakdown.get(spec.stage)
        if s is None:
            if spec.required:
                breaches.append(f"{spec.stage}:missing")
            continue
        if s["p99_us"] / spec.per > spec.p99_limit_us:
            breaches.append(spec.stage)
    return {"ok": not breaches, "breaches": sorted(breaches)}


# ---------------------------------------------------------------------------
# storm budgets: the mean-based envelope checker the deterministic storm
# reports embed. Kept verbatim: storm reports are compared byte for byte,
# so the verdict dict must not change by a byte.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BudgetLine:
    """One stage envelope: the stage's mean lap, divided by `per` (the
    units of work one lap covers — frames per batch for batch-scoped
    stages), must stay under `limit_us`. `required` stages must have
    samples at all: a storm whose instrumented stage recorded NOTHING
    is a coverage hole, not a pass."""

    stage: str
    limit_us: float
    per: float = 1.0
    required: bool = True

    def __post_init__(self):
        _valid_stage(self.stage)


def check_budget(tracer, lines: tuple[BudgetLine, ...]) -> dict:
    """Evaluate the envelope. Only deterministic facts reach the report:
    the verdict and WHICH stages breached — measured values go to the
    flight recorder, never into the bit-compared bytes."""
    bd = tracer.breakdown() if tracer is not None else {}
    breaches = []
    for ln in lines:
        s = bd.get(ln.stage)
        if s is None:
            if ln.required:
                breaches.append(f"{ln.stage}:missing")
            continue
        if s["mean_us"] / ln.per > ln.limit_us:
            breaches.append(ln.stage)
    if breaches:
        tele.trigger("slo_breach",
                     f"storm budget breached: {sorted(breaches)}")
    return {"ok": not breaches, "breaches": sorted(breaches)}


# ---------------------------------------------------------------------------
# live burn-rate monitor (`run`)
# ---------------------------------------------------------------------------

# windowed percentiles evaluate hist.py's shared rank/cumsum/midpoint
# core directly on bucket-count DELTAS (counts_now - window_start) —
# one implementation, so the monitor's p99 can never drift from every
# other p99 in the system
_counts_percentile = counts_percentile


class SLOMonitor:
    """Rolling burn-rate evaluation of per-stage SLOs over the armed
    tracer's histograms.

    Every `window_s` seconds the monitor diffs each budgeted stage's
    bucket counts against the previous window boundary (mergeable
    histograms subtract as cleanly as they add) and computes the
    WINDOWED p99 — not the since-boot p99, which dilutes a fresh
    regression under hours of healthy history. A stage whose windowed
    p99 exceeds its budget for `burn_windows` consecutive windows is a
    breach: the `slo_breach` flight-recorder trigger fires (the last-N
    batch records around the breach are the evidence) and the breach
    counter increments (bng_slo_breaches_total). Windows with fewer
    than `min_samples` laps are skipped — no traffic is not a breach.
    """

    min_samples = 16

    def __init__(self, tracer, slos: tuple[SLOSpec, ...] = DEFAULT_SLOS,
                 window_s: float = 30.0, burn_windows: int = 2,
                 clock=time.monotonic):
        self.tracer = tracer
        self.slos = tuple(slos)
        self.window_s = float(window_s)
        self.burn_windows = max(1, int(burn_windows))
        self.clock = clock
        self._lock = threading.Lock()
        self._win_start: float | None = None
        self._snap: dict[int, np.ndarray] = {}
        self._burning: dict[str, int] = {s.stage: 0 for s in self.slos}
        self._window_p99: dict[str, float] = {}
        self.breaches: dict[str, int] = {s.stage: 0 for s in self.slos}
        self.windows_evaluated = 0

    def _stage_idx(self, stage: str) -> int:
        return STAGE_NAMES.index(stage)

    def tick(self, now: float | None = None) -> list[str]:
        """Evaluate the window if it elapsed; returns the stages that
        breached this tick (empty most of the time). Called from the
        run loop's 1 Hz heartbeat."""
        now = now if now is not None else self.clock()
        with self._lock:
            breached = self._tick_locked(now)
        if breached:
            tele.trigger("slo_breach",
                         f"burn-rate breach ({self.burn_windows} windows "
                         f"x {self.window_s:.0f}s): {sorted(breached)}")
        return breached

    def _tick_locked(self, now: float) -> list[str]:
        if self._win_start is None:
            self._win_start = now
            for spec in self.slos:
                i = self._stage_idx(spec.stage)
                self._snap[i] = self.tracer.hists[i].counts.copy()
            return []
        if now - self._win_start < self.window_s:
            return []
        self._win_start = now
        self.windows_evaluated += 1
        breached = []
        for spec in self.slos:
            i = self._stage_idx(spec.stage)
            counts = self.tracer.hists[i].counts
            prev = self._snap.get(i)
            delta = counts - prev if prev is not None else counts.copy()
            self._snap[i] = counts.copy()
            n = int(delta.sum())
            if n < self.min_samples:
                self._burning[spec.stage] = 0
                self._window_p99.pop(spec.stage, None)
                continue
            p99 = _counts_percentile(delta, 99.0)
            self._window_p99[spec.stage] = p99
            if p99 / spec.per > spec.p99_limit_us:
                self._burning[spec.stage] += 1
            else:
                self._burning[spec.stage] = 0
            if self._burning[spec.stage] >= self.burn_windows:
                self.breaches[spec.stage] += 1
                self._burning[spec.stage] = 0  # re-arm for the next burn
                breached.append(spec.stage)
        return breached

    def snapshot(self) -> dict:
        """Scrape-thread view (control/metrics.py collect_slo)."""
        with self._lock:
            return {
                "windows": self.windows_evaluated,
                "window_s": self.window_s,
                "burn_windows": self.burn_windows,
                "budgets_us": {s.stage: s.p99_limit_us for s in self.slos},
                "window_p99_us": dict(self._window_p99),
                "burning": dict(self._burning),
                "breaches": dict(self.breaches),
                "ok": not any(self._burning.values()),
            }
