"""The port's span tracer and flight recorder against the JAX package's.

- A seeded sequence of hook calls (`begin_batch`, `lap`, `stamp`,
  `observe`, `Tracer.observe_many`, `add`, `focus`, `end_batch`, `cancel_batch`,
  `set_meta`, `trigger`, `span`) on the reference's stages, under one
  injected nanosecond clock and one injected wall clock, gives the same
  `breakdown()`, tracer snapshot, span-event log (stages by name: the
  port's `total` has another id), flight-record ring, trigger counts and
  dump JSON in both packages (the backend name is masked: each process
  names its own).
- The ring keeps the last `capacity` records, oldest first, after it
  wraps; dumps are rate-limited by `min_dump_interval_s` and capped at
  `max_dumps`; an unwritable dump directory is counted, never raised.
- `chrome_trace` gives the same Chrome Trace Event JSON, with one thread
  per lane and "X" events carrying ts/dur in microseconds; the port's
  `ts` sit on a torch profiler trace's timebase (each event's wall-clock
  ns is `baseTimeNanoseconds + ts * 1000`): exported on the base of the
  first event's wall time they are the reference's, and by default the
  base is a whole second.
- The port's vocabulary is the reference's with its own stages (the
  dispatch's parts and the device program's stages) before `total`.
- Disarmed, every hook is a no-op that returns None (`span` the shared
  no-op), and a tracer whose open-slot pool is full counts the drop.

Tolerance: exact (dicts, lists, JSON).
"""

import json

import numpy as np
import pytest

from bng_tpu.telemetry import recorder as j_rec
from bng_tpu.telemetry import spans as j_sp
from bng_tpu_torch.telemetry import recorder as t_rec
from bng_tpu_torch.telemetry import spans as t_sp

pytestmark = pytest.mark.torch_port

PKGS = (("jax", j_sp, j_rec), ("port", t_sp, t_rec))
# the port's own stages, between the reference's and `total`
PORT_STAGES = ("drain", "upload", "issue", "collect", "parse", "antispoof", "dhcp", "garden",
               "nat44", "qos", "edge", "pppoe_decap", "pppoe_encap", "verdict", "nat_accounting",
               "ring_dma")


def split_stages(counts: dict) -> tuple[dict, dict]:
    """A breakdown's per-stage counts split into the reference's stages and
    the port's own: the reference records none of the latter."""
    ref = {s: n for s, n in counts.items() if s in j_sp.STAGE_NAMES}
    return ref, {s: n for s, n in counts.items() if s not in j_sp.STAGE_NAMES}


def first_wall_ns(tr) -> int:
    """The wall-clock ns of a tracer's earliest span event."""
    return tr.wall_ns(min(t0 for _s, _l, t0, _d in tr.events))


class StepClock:
    """A clock stepping by seeded increments, one per call."""

    def __init__(self, seed: int, scale: float, start: float):
        self.steps = np.random.default_rng(seed).integers(1, 2000, size=1 << 14) * scale
        self.i, self.t = 0, start

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return int(self.t) if isinstance(self.t, (int, np.integer)) else self.t


def _drive(sp, rec_mod, seed: int, out_dir, capacity: int = 8):
    rng = np.random.default_rng(seed)
    ns = StepClock(seed + 1, 1000, 10**12)
    ns.t = int(ns.t)
    ns.steps = ns.steps.astype(np.int64)
    wall = StepClock(seed + 2, 0.001, 1_753_000_000.0)
    rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(
        capacity=capacity, latency_budget_us=900.0, shed_burst=5, min_dump_interval_s=0.4,
        max_dumps=6, out_dir=str(out_dir)), clock=wall)
    tr = sp.Tracer(recorder=rec, keep_events=256, clock=ns)
    toks = []
    with sp.armed(tr):
        for _ in range(400):
            op = int(rng.integers(12))
            tok = toks[int(rng.integers(len(toks)))] if toks and rng.random() < 0.7 else None
            stage = int(rng.integers(j_sp.NSTAGES - 1))  # the stages both packages have
            if op in (0, 1):
                got = sp.begin_batch(int(rng.integers(len(sp.LANE_NAMES))),
                                     int(rng.integers(1, 64)))
                if got is not None:
                    toks.append(got)
            elif op == 2:
                t0 = sp.t()
                sp.lap(stage, t0, tok)
            elif op == 3:
                sp.stamp(stage, tok)
            elif op == 4:
                sp.observe(stage, float(rng.integers(1, 5000)) / 7.0, tok)
            elif op == 5:
                sp.add(tok, shed=int(rng.integers(4)), punt=int(rng.integers(3)))
            elif op in (6, 7) and toks:
                done = toks.pop(int(rng.integers(len(toks))))
                sp.end_batch(done, punt=int(rng.integers(2)), shed=int(rng.integers(7)))
            elif op == 8 and toks:
                sp.cancel_batch(toks.pop(int(rng.integers(len(toks)))))
            elif op == 9:
                sp.focus(tok)
            elif op == 10:
                sp.set_meta("express_program", ("aot-express", "jit-full")[int(rng.integers(2))])
                if rng.random() < 0.3:
                    sp.trigger(j_rec.TRIG_SLO, f"seeded {seed}")
            else:
                sp.tracer().observe_many(stage, rng.integers(1, 10_000, size=5).astype(float))
                with sp.span(stage, tok):
                    pass
    dumps = []
    for path in rec.dump_paths:
        with open(path) as f:
            d = json.load(f)
        d["meta"].pop("backend")
        dumps.append((path.rsplit("/", 1)[-1], d))
    snap = tr.snapshot()
    snap["recorder"]["dumps"] = [p.rsplit("/", 1)[-1] for p in snap["recorder"]["dumps"]]
    snap["recorder"].pop("backend")
    # the port's export on the base of its first event: the reference's ts
    chrome = (rec_mod.chrome_trace(tr, label="seeded") if sp is j_sp else
              rec_mod.chrome_trace(tr, label="seeded", base_ns=first_wall_ns(tr)))
    if sp is t_sp:
        assert chrome.pop("baseTimeNanoseconds") == first_wall_ns(tr)
    assert chrome["otherData"].pop("stages") == list(sp.STAGE_NAMES)
    return {"breakdown": tr.breakdown(), "snapshot": snap,
            "events": [(sp.STAGE_NAMES[s], lane, t0, d) for s, lane, t0, d in tr.events],
            "records": rec.records(), "triggers": dict(rec.triggers), "dumps": dumps,
            "dump_errors": rec.dump_errors, "chrome": chrome, "free": sorted(tr._free)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hook_sequence_matches_reference(seed, tmp_path):
    ref = _drive(j_sp, j_rec, seed, tmp_path / "jax")
    got = _drive(t_sp, t_rec, seed, tmp_path / "port")
    assert got == ref
    assert got["snapshot"]["records"] > 0 and got["records"]
    assert got["breakdown"] and got["events"]
    assert j_sp._ACTIVE is None and t_sp._ACTIVE is None  # armed() disarmed on exit


def test_ring_wraps_to_the_last_capacity_records(tmp_path):
    out = []
    for _name, sp, rec_mod in PKGS:
        rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(capacity=4, out_dir=str(tmp_path)),
                                     clock=StepClock(7, 0.5, 100.0))
        tr = sp.Tracer(recorder=rec, clock=StepClock(8, 1000, 0))
        with sp.armed(tr):
            for k in range(11):
                tok = sp.begin_batch(sp.LANE_BULK_L, k + 1)
                sp.lap(sp.DISPATCH, sp.t(), tok)
                sp.end_batch(tok, punt=k % 3)
        out.append(rec.records())
    assert out[1] == out[0]
    assert [r["seq"] for r in out[1]] == [7, 8, 9, 10]  # oldest first
    assert [r["n"] for r in out[1]] == [8, 9, 10, 11] and out[1][0]["lane"] == "bulk"


def test_dump_rate_limit_and_cap(tmp_path):
    out = []
    for name, _sp, rec_mod in PKGS:
        wall = iter(np.arange(0.0, 100.0, 0.25))
        rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(
            min_dump_interval_s=1.0, max_dumps=3, out_dir=str(tmp_path / name)),
            clock=lambda: 1000.0 + float(next(wall)))
        paths = [rec.trigger(rec_mod.TRIG_LATENCY, str(k)) for k in range(20)]
        out.append(([p is not None for p in paths], dict(rec.triggers), len(rec.dump_paths)))
    assert out[1] == out[0]
    made, triggers, n = out[1]
    assert triggers == {"latency_excursion": 20} and n == 3 == sum(made)
    assert made[0] and not made[1]  # the second trigger came 0.5 s after the first


def test_unwritable_dump_dir_is_counted_not_raised(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    for _name, _sp, rec_mod in PKGS:
        rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(out_dir=str(blocker / "sub")))
        assert rec.trigger(rec_mod.TRIG_INVARIANT, "x") is None
        assert rec.dump_errors == 1 and rec.triggers == {"invariant_violation": 1}


def test_chrome_trace_schema(tmp_path):
    traces = []
    for _name, sp, rec_mod in PKGS:
        tr = sp.Tracer(keep_events=64, clock=StepClock(3, 1000, 0))
        with sp.armed(tr):
            for lane in (sp.LANE_EXPRESS_L, sp.LANE_BULK_L, sp.LANE_EXPRESS_L):
                tok = sp.begin_batch(lane, 8)
                sp.lap(sp.DISPATCH, sp.t(), tok)
                sp.lap(sp.DEVICE_WAIT, sp.t(), tok)
                sp.end_batch(tok)
        if sp is j_sp:
            traces.append(rec_mod.chrome_trace(tr, label="dora"))
            continue
        port_tr = tr
        t = rec_mod.chrome_trace(tr, label="dora", base_ns=first_wall_ns(tr))
        assert t.pop("baseTimeNanoseconds") == first_wall_ns(tr)
        traces.append(t)
    assert traces[1]["otherData"].pop("stages") == list(t_sp.STAGE_NAMES)
    assert traces[0]["otherData"].pop("stages") == list(j_sp.STAGE_NAMES)
    assert traces[1] == traces[0]
    t = traces[1]
    meta = [e for e in t["traceEvents"] if e["ph"] == "M"]
    assert [e["args"]["name"] for e in meta] == ["dora", "lane:express", "lane:bulk"]
    xs = [e for e in t["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 9 and {e["name"] for e in xs} == {"dispatch", "device_wait", "total"}
    assert all(set(e) == {"name", "cat", "ph", "pid", "tid", "ts", "dur"} for e in xs)
    assert min(e["ts"] for e in xs) == 0.0 and all(e["dur"] > 0 for e in xs)
    assert t["otherData"]["records"] == 3 and t["displayTimeUnit"] == "ms"
    # by default the base is the first event's wall-clock second
    own = t_rec.chrome_trace(port_tr, label="dora")
    base = own["baseTimeNanoseconds"]
    assert base == first_wall_ns(port_tr) // 10**9 * 10**9
    assert [e["ts"] for e in own["traceEvents"] if e["ph"] == "X"] == \
        [(port_tr.wall_ns(t0) - base) / 1000.0 for _s, _l, t0, _d in port_tr.events]
    with pytest.raises(ValueError, match="keep_events"):
        t_rec.chrome_trace(t_sp.Tracer())


def test_disarmed_hooks_are_noops_and_full_slot_pool_counts_drops():
    assert t_sp.tracer() is None and not t_sp.enabled()
    assert t_sp.t() is None and t_sp.begin_batch(0, 1) is None
    assert t_sp.trigger("x") is None and t_sp.span(t_sp.REPLY) is t_sp._NOOP
    for fn in (lambda: t_sp.lap(0, 5), lambda: t_sp.stamp(0), lambda: t_sp.observe(0, 1.0),
               lambda: t_sp.end_batch(0), lambda: t_sp.cancel_batch(0), lambda: t_sp.focus(0),
               lambda: t_sp.add(0, shed=1), lambda: t_sp.set_meta("k", 1)):
        assert fn() is None
    drops = []
    for _name, sp, _rec in PKGS:
        with sp.armed() as tr:
            toks = [sp.begin_batch(0, 1) for _ in range(tr.OPEN_SLOTS + 3)]
            drops.append((tr.records_dropped, toks.count(None)))
            for tok in toks:
                sp.end_batch(tok)
            drops.append((tr.seq, len(tr._free)))
    assert drops[2:] == drops[:2] == [(3, 3), (16, 16)]


def test_stage_and_lane_vocabulary_matches():
    assert t_sp.STAGE_NAMES == j_sp.STAGE_NAMES[:-1] + PORT_STAGES + ("total",)
    assert t_sp.LANE_NAMES == j_sp.LANE_NAMES
    assert (t_sp.DEVICE, t_sp.LANE_BENCH) == (j_sp.DEVICE, j_sp.LANE_BENCH)
    assert t_sp.TOTAL == t_sp.NSTAGES - 1 == j_sp.TOTAL + len(PORT_STAGES)
    for name in dir(j_rec):
        if name.startswith("TRIG_"):
            assert getattr(t_rec, name) == getattr(j_rec, name)
