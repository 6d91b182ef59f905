"""The program's stage hook (`telemetry/spans.region`) and the spans it lays.

- The hook's three states: disarmed with no profiler it is the shared
  no-op and enters no profiler range; under a torch profiler it opens
  `bng::<stage>`; armed it laps the stage (both when both hold).
- One armed batch of each device program (the IPoE fused step, the fused
  step with every optional stage, the DHCP-only program) laps each of its
  stages exactly once, on the batch's flight record.
- In both ring loops, `drain` + `upload` + `issue` + `collect` fit inside
  `dispatch` on every batch's record, and an empty poll laps no `ring`.
- A `chrome_trace` export and a profiler trace of one block start within
  1 ms of each other on their timebases (`baseTimeNanoseconds + ts`).
- The ids the benchmark's readers hard-code (`lane_wait` 2, `dispatch` 3,
  the lanes) stay, and the reference's stages keep their ids.
- The express lane's retire observes its graph's event time into
  `device`; on the CPU there is no graph and no sample.

Tolerance: exact counts; the timebase within 1 ms.
"""

import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bng_tpu.telemetry import spans as j_sp
from bng_tpu_torch import frames as F
from bng_tpu_torch.runtime.engine import Engine, _InFlight
from bng_tpu_torch.runtime.ring import PyRing
from bng_tpu_torch.telemetry import recorder as t_rec
from bng_tpu_torch.telemetry import spans as tele

from test_torch_entry import PORT_FULL, deploy_full, full_batch
from test_torch_stages import NOW, PORT_PKG, deploy, frame_mix, mac

pytestmark = pytest.mark.torch_port

B, L = 48, 512
DISPATCH_PARTS = ("drain", "upload", "issue", "collect")
IPOE_STAGES = ("parse", "antispoof", "dhcp", "nat44", "qos", "verdict", "nat_accounting")
OPTIONAL_STAGES = ("garden", "edge", "pppoe_decap", "pppoe_encap")
DHCP_ONLY_STAGES = ("parse", "dhcp", "verdict")


def profiled_ranges(fn) -> list[str]:
    """The `bng::` ranges a torch profiler saw while fn ran."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("bng::")]


def engine(full: bool) -> Engine:
    if full:
        d = deploy_full(PORT_FULL)
        return Engine(d.fp, d.nat, d.qos, d.spoof, d.garden, d.pppoe, edge=d.edge,
                      batch_size=B, pkt_slot=L, device="cpu"), d
    d = deploy(PORT_PKG)
    return Engine(d.fp, d.nat, d.qos, d.spoof, batch_size=B, pkt_slot=L, device="cpu"), d


def traced():
    rec = t_rec.FlightRecorder(t_rec.RecorderConfig(capacity=64))
    return tele.armed(tele.Tracer(recorder=rec, keep_events=4096))


def counts(tr) -> dict:
    return {s: v["count"] for s, v in tr.breakdown().items()}


# ---- the hook's states -----------------------------------------------------

@pytest.mark.parametrize("state", ["disarmed", "profiler", "armed", "armed_profiler"])
def test_region_states(state, monkeypatch):
    import torch.autograd.profiler as prof

    entered = []
    real = prof.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(prof, "record_function", counting)
    armed = state.startswith("armed")
    tr = tele.Tracer() if armed else None

    def block():
        with tele.region(tele.DHCP):
            with tele.region(tele.NAT44):
                pass

    if armed:
        tele.arm(tr)
    try:
        if state == "disarmed":
            assert tele.region(tele.DHCP) is tele._NOOP
            block()
            ranges = []
        elif "profiler" in state:
            ranges = profiled_ranges(block)
        else:
            assert tele.region(tele.DHCP) is not tele._NOOP
            block()
            ranges = []
    finally:
        tele.disarm()
    if "profiler" in state:
        assert ranges == ["bng::dhcp", "bng::nat44"] and entered == ranges
    else:
        assert ranges == [] and entered == []  # no profiler: no range entered
    if armed:
        assert counts(tr) == {"dhcp": 1, "nat44": 1}


def test_a_region_that_raises_is_not_timed_and_discard_drops_a_lap():
    with tele.armed() as tr:
        with pytest.raises(ZeroDivisionError):
            with tele.region(tele.DISPATCH):
                1 / 0
        with tele.region(tele.RING) as span:
            span.discard()
        with tele.region(tele.REPLY):
            pass
    assert counts(tr) == {"reply": 1}
    tele.region(tele.RING).discard()  # the disarmed no-op takes it too


# ---- the programs' stages ----------------------------------------------------

@pytest.mark.parametrize("program", ["fused_ipoe", "fused_full", "dhcp_only"])
def test_each_stage_laps_once_per_batch(program):
    eng, d = engine(program == "fused_full")
    if program == "dhcp_only":
        frames = [F.discover_frame(mac(k), 0x700 + k) for k in (1, 2, 7)]
        want = DISPATCH_PARTS + DHCP_ONLY_STAGES
        run = lambda: eng.process_dhcp(frames, now=NOW)  # noqa: E731
    else:
        frames, fa = full_batch(d) if program == "fused_full" else frame_mix(d.tcp_nat)
        want = DISPATCH_PARTS + IPOE_STAGES + (OPTIONAL_STAGES if program == "fused_full" else ())
        run = lambda: eng.process(frames, from_access=fa, now=NOW)  # noqa: E731
    with traced() as tr:
        run()
        run()
    got = counts(tr)
    assert {s: got.get(s, 0) for s in want} == {s: 2 for s in want}
    left_out = set(IPOE_STAGES + OPTIONAL_STAGES) - set(want)
    assert not left_out & set(got), got
    assert got["dispatch"] == got["device_wait"] == got["reply"] == got["total"] == 2
    # every lap landed on its batch's flight record
    for rec in tr.recorder.records():
        assert set(want) <= set(rec["stages_us"]), rec["stages_us"]
    # the stage ranges sit under the issue range in a profiler trace
    ranges = profiled_ranges(run)
    assert ranges[:4] == ["bng::dispatch", "bng::drain", "bng::upload", "bng::issue"]
    assert sorted(ranges) == sorted(["bng::dispatch", "bng::device_wait", "bng::reply"]
                                    + [f"bng::{s}" for s in want]
                                    + (["bng::slow_path"] if "bng::slow_path" in ranges else []))


def _ring_batches(d):
    frames, fa = frame_mix(d.tcp_nat)
    ctrl = [F.discover_frame(mac(k), 0x600 + k) for k in (1, 2, 3)]
    return [list(zip(frames, fa)), [(f, True) for f in ctrl], list(zip(frames, fa))]


@pytest.mark.parametrize("loop", ["sync", "pipelined"])
def test_dispatch_parts_fit_inside_dispatch_on_each_batch(loop):
    eng, d = engine(False)
    ring = PyRing(nframes=256, frame_size=L, depth=128)
    step = eng.process_ring if loop == "sync" else eng.process_ring_pipelined
    with traced() as tr:
        assert step(ring, now=NOW) == 0  # an empty poll: no record, no ring lap
        for batch in _ring_batches(d):
            for f, fa in batch:
                assert ring.rx_push(f, from_access=fa)
            step(ring, now=NOW)
        eng.flush_pipeline(ring)
    records = tr.recorder.records()
    assert len(records) == 3 and counts(tr)["ring"] == 3
    for rec in records:
        st = rec["stages_us"]
        assert all(st[p] > 0 for p in DISPATCH_PARTS), st
        assert sum(st[p] for p in DISPATCH_PARTS) <= st["dispatch"]
        assert st["issue"] >= st["dhcp"] and rec["lane"] == "ring"
    # the all-control batch took the DHCP-only program: no NAT44 on its record
    assert "nat44" in records[0]["stages_us"] and "nat44" not in records[1]["stages_us"]
    # span events: each part starts and ends inside its batch's dispatch
    ev = list(tr.events)
    disp = [(t0, t0 + dur) for s, _l, t0, dur in ev if s == tele.DISPATCH]
    for s, _l, t0, dur in ev:
        if tele.STAGE_NAMES[s] in DISPATCH_PARTS:
            assert any(a <= t0 and t0 + dur <= b for a, b in disp)


# ---- one timebase with the profiler --------------------------------------------

@pytest.mark.parametrize("base", ["own", "profilers"])
def test_chrome_trace_lines_up_with_a_profiler_trace(base, tmp_path):
    tr = tele.Tracer(keep_events=64)
    path = tmp_path / "torch.json"
    with tele.armed(tr), profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with tele.region(tele.ISSUE):
            time.sleep(0.003)
    prof.export_chrome_trace(str(path))
    torch_trace = json.loads(path.read_text())
    t_base = torch_trace["baseTimeNanoseconds"]
    rng = next(e for e in torch_trace["traceEvents"] if e.get("name") == "bng::issue")
    ours = t_rec.chrome_trace(tr, base_ns=t_base if base == "profilers" else None)
    span = next(e for e in ours["traceEvents"] if e.get("name") == "issue")
    wall_torch = t_base + rng["ts"] * 1e3
    wall_ours = ours["baseTimeNanoseconds"] + span["ts"] * 1e3
    assert abs(wall_ours - wall_torch) < 1e6  # ns: within 1 ms
    assert abs(span["dur"] - rng["dur"]) < 1e3  # us
    if base == "profilers":
        assert ours["baseTimeNanoseconds"] == t_base and abs(span["ts"] - rng["ts"]) < 1e3
    else:
        assert ours["baseTimeNanoseconds"] % 10**9 == 0 and 0 <= span["ts"] < 2e6


# ---- the vocabulary ---------------------------------------------------------------

@pytest.mark.parametrize("name, want", [
    ("LANE_WAIT", 2), ("DISPATCH", 3), ("LANE_ENGINE", 0), ("LANE_EXPRESS_L", 1),
    ("LANE_BULK_L", 2), ("LANE_RING_L", 3), ("LANE_BENCH", 4), ("TOTAL", tele.NSTAGES - 1),
])
def test_ids_the_readers_hard_code_are_pinned(name, want):
    assert getattr(tele, name) == want


def test_the_references_stages_keep_their_ids_and_the_ports_follow():
    shared = j_sp.STAGE_NAMES[:-1]
    assert tele.STAGE_NAMES[:len(shared)] == shared and tele.STAGE_NAMES[-1] == "total"
    assert tele.STAGE_NAMES[len(shared):-1] == DISPATCH_PARTS + (
        "parse", "antispoof", "dhcp", "garden", "nat44", "qos", "edge", "pppoe_decap",
        "pppoe_encap", "verdict", "nat_accounting", "ring_dma")
    for name in ("RING", "LANE_WAIT", "DISPATCH", "DEVICE", "DEVICE_WAIT", "REPLY", "WIRE_TX"):
        assert getattr(tele, name) == getattr(j_sp, name)
    assert tele.RANGE_NAMES[tele.NAT_ACCOUNTING] == "bng::nat_accounting"
    assert all(r == f"bng::{n}" for r, n in zip(tele.RANGE_NAMES, tele.STAGE_NAMES))


# ---- the device stage ----------------------------------------------------------------

class _Event:
    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, end) -> float:
        return end.ms - self.ms


def test_express_retire_observes_the_graph_time_into_device():
    """The scheduler observes an express batch's event pair into `device`
    after its `device_wait`; the CPU's express program records none."""
    from bng_tpu_torch.runtime.engine import ExpressAotResult
    from bng_tpu_torch.runtime.lanes import InflightEntry
    from bng_tpu_torch.runtime.scheduler import TieredScheduler

    block = torch.zeros((2, 8), dtype=torch.int32)
    stats = torch.zeros((4,), dtype=torch.int64)
    fake = SimpleNamespace(_fold_stats=lambda *a: None, stats=SimpleNamespace(tx=0, passed=0),
                           _handle_slow_lanes=lambda items, path: [])
    sched = SimpleNamespace(engine=fake, clock=lambda: 0.0, _vec=False,
                            _complete=lambda *a: None, _observe_retire=lambda *a: None)
    out = []
    for events in ((_Event(1.0), _Event(1.25)), None):
        res = _InFlight(ExpressAotResult(block=block, dhcp_stats=stats, device_events=events))
        with tele.armed() as tr:
            tok = tele.begin_batch(tele.LANE_EXPRESS_L, 0)
            TieredScheduler._retire_express(sched, InflightEntry(res, [], 0.0, "full",
                                                                 trace=tok, meta=(None, None)))
        out.append(tr.breakdown().get("device"))
    assert out[0]["count"] == 1 and out[0]["mean_us"] == pytest.approx(250.0, rel=0.05)
    assert out[1] is None
