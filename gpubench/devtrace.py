"""A profiled slice of a run, read from torch.profiler's trace.

The slice runs with the profiler on (host and device activity). Its
Chrome trace is written to the run's temporary directory, read back and
deleted. From it come the device's busy seconds (the union of kernel,
copy and set intervals inside the slice), the slice's length, kernel time
by name, and the idle gaps of the device, each labelled with the
innermost `bench::` or `bng::` range the host was in at the gap.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "bench::slice"


class Profile:
    def __init__(self, events: list[dict]):
        self.slice = next((e for e in events if e.get("name") == SLICE
                           and e.get("cat") == "user_annotation"), None)
        t0 = self.slice["ts"] if self.slice else 0.0
        t1 = t0 + (self.slice["dur"] if self.slice else 0.0)
        self.t0, self.t1 = t0, t1
        self.device = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                              and e.get("ph") == "X" and t0 <= e["ts"] <= t1),
                             key=lambda e: e["ts"])
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                              and e.get("ph") == "X" and e is not self.slice
                              and str(e.get("name", "")).startswith(("bench::", "bng::"))),
                             key=lambda e: e["ts"])
        self.graph_corr = {e["args"]["correlation"] for e in events
                           if e.get("cat") == "cuda_runtime" and "Graph" in e.get("name", "")
                           and "correlation" in e.get("args", {})}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def cards(self) -> list:
        return sorted({e.get("pid") for e in self.device}, key=str)

    def merged(self, card=None) -> list[tuple[float, float]]:
        """The busy intervals of one card (all cards' together by default)."""
        out: list[list[float]] = []
        evs = self.device if card is None else [e for e in self.device if e.get("pid") == card]
        for e in sorted(evs, key=lambda e: e["ts"]):
            a, b = max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        """Seconds some operation ran, averaged over the cards that ran any."""
        cards = self.cards
        if not cards:
            return 0.0
        return sum(sum(b - a for a, b in self.merged(c)) for c in cards) / len(cards) / 1e6

    def kernel_time_s(self, name_part: str) -> list[float]:
        return [e["dur"] / 1e6 for e in self.kernels if name_part in e["name"]]

    def graph_kernels(self) -> list[dict]:
        return [e for e in self.kernels if e.get("args", {}).get("correlation") in self.graph_corr]

    def label_at(self, t: float) -> str:
        """The innermost annotated host range open at time t."""
        best = None
        for r in self.ranges:
            if r["ts"] > t:
                break
            if r["ts"] + r["dur"] >= t and (best is None or r["dur"] <= best["dur"]):
                best = r
        return best["name"] if best else "(no range)"

    def breakdown(self) -> dict:
        by_op: dict[str, float] = {}
        for e in self.device:
            key = e["name"][:96]
            by_op[key] = by_op.get(key, 0.0) + e["dur"] / 1e6
        gaps: dict[str, float] = {}
        prev = self.t0
        for a, b in self.merged() + [(self.t1, self.t1)]:
            if a > prev:
                lab = self.label_at(prev + (a - prev) / 2)
                gaps[lab] = gaps.get(lab, 0.0) + (a - prev) / 1e6
            prev = max(prev, b)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


@contextmanager
def profiled(cuda: bool):
    """with profiled(cuda) as holder: ...; holder[0] is the Profile after."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    holder: list = []
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            yield holder
            for d in range(torch.cuda.device_count() if cuda else 0):
                torch.cuda.synchronize(d)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    holder.append(Profile(events))


def annotate(obj, attr: str, label: str):
    """Wrap obj.attr in a `bench::<label>` range (an instance attribute
    shadowing the method); returns the undo."""
    from torch.profiler import record_function

    fn = getattr(obj, attr)
    had, orig = attr in vars(obj), vars(obj).get(attr)

    def wrapped(*a, **kw):
        with record_function(f"bench::{label}"):
            return fn(*a, **kw)

    def undo():
        if had:
            setattr(obj, attr, orig)
        else:
            delattr(obj, attr)

    setattr(obj, attr, wrapped)
    return undo
