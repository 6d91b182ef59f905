"""Op-level and per-step device profiling (port of
`bng_tpu/utils/profiling.py`).

The reference captures a `jax.profiler` trace and parses its Chrome-trace
export. The port asks `torch.profiler` for the same two answers:

    from bng_tpu_torch.utils.profiling import profile_op_times, format_report
    report = profile_op_times(lambda: step(), iters=10)
    print(format_report(report))

- `profile_op_times`: the ops of a callable by device time per iteration
  (`key_averages()`; on the CPU, where there is no device track, by host
  time), with the device's and the host's totals.
- `profile_step_durations`: the distribution of one callable's
  per-iteration time. On the card each call is bracketed by CUDA events
  (`source="device"`: the time the card spent, host queueing excluded
  once the stream is busy); on the CPU by the host clock
  (`source="host"`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable


@dataclass
class OpTime:
    name: str
    us_per_iter: float
    calls_per_iter: float


@dataclass
class ProfileReport:
    device_total_us: float  # summed self device time of every op, per iter
    host_total_us: float  # summed self host time of every op, per iter
    ops: list[OpTime]  # descending by device time (host time on the CPU)
    trace_dir: str  # the reference keeps its trace there; here always "(discarded)"


def profile_op_times(fn: Callable[[], object], iters: int = 10) -> ProfileReport:
    """Run fn() `iters` times under `torch.profiler`; aggregate per op.
    fn should have run once already so the trace holds steady-state calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
    ka = prof.key_averages()
    dev = {e.key: (e.self_device_time_total, e.count) for e in ka}
    host = {e.key: (e.self_cpu_time_total, e.count) for e in ka}
    by = dev if cuda and any(t for t, _ in dev.values()) else host
    ops = [OpTime(k, t / iters, n / iters)
           for k, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0]) if t > 0]
    return ProfileReport(device_total_us=sum(t for t, _ in dev.values()) / iters,
                         host_total_us=sum(t for t, _ in host.values()) / iters,
                         ops=ops, trace_dir="(discarded)")


@dataclass
class StepDurations:
    """Per-call durations of one profiled run.

    source: "device" (CUDA events around each call on the card) or
    "host" (the host clock around each call on the CPU)."""

    us: list[float]
    source: str

    def __post_init__(self):
        self._sorted = None

    def percentile(self, q: float) -> float:
        """Linearly interpolated percentile (numpy.percentile's default)."""
        if not self.us:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        if self._sorted is None:
            import numpy as np

            self._sorted = np.sort(np.asarray(self.us, dtype=np.float64))
        s = self._sorted
        pos = (len(s) - 1) * (q / 100.0)
        lo = int(pos)
        frac = pos - lo
        if frac == 0.0 or lo + 1 >= len(s):
            return float(s[lo])
        return float(s[lo] + (s[lo + 1] - s[lo]) * frac)


def profile_step_durations(fn: Callable[[], object], iters: int = 50,
                           device=None) -> StepDurations:
    """Per-call durations of fn (one device step per call) on `device`:
    the card by default (CUDA events), or the CPU when asked (host
    clock). fn should have run once already."""
    import torch

    from bng_tpu_torch.utils.devenv import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        us = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            us.append((time.perf_counter() - t) * 1e6)
        return StepDurations(us, "host")
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in evs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return StepDurations([s.elapsed_time(e) * 1e3 for s, e in evs], "device")


def format_report(r: ProfileReport, top: int = 15) -> str:
    lines = [f"device: {r.device_total_us:9.1f} us/iter   "
             f"(host {r.host_total_us:.1f} us)   trace: {r.trace_dir}"]
    for op in r.ops[:top]:
        lines.append(f"  {op.us_per_iter:9.1f} us  x{op.calls_per_iter:4.1f}  {op.name}")
    return "\n".join(lines)
