"""The ring loops' device programs replayed from a tape (runtime/ringprog.py).

On the CPU (the tape's capture stubbed):
- the recorder cuts its segments at every stage bound and kernel call:
  the fused step's stages in order, each K1 and K2 call an eager entry
  inside its stage, for the IPoE step, the step with every optional stage
  and the DHCP-only program;
- the engine's program cache: one program per kind (the fused step, the
  DHCP-only program), built on its first ring batch and replayed after
  it; kept across lease and QoS drains, dropped by whatever rebinds the
  tables (a resync, an adoption; the stale program never replays
  again); `ring_captures`, `ring_replays` and `ring_eager`; `step`,
  `process` and `process_dhcp` stay plain calls; the CPU never replays.

On a card (marker `card`; this file imports no JAX, so it runs there with
`python -m pytest --noconftest -m card tests/test_torch_ring_program.py`):
replayed ring batches against the eager program on a twin engine, bit for
bit (verdicts, bytes, lengths, stats, every table word), over mixed and
then all-control batches, a lease and a QoS delta drained between
batches, a resync, the pipelined order (a batch dispatched before the
last one's outputs are read) and every optional stage; building a program
leaves every table word as it was; a replayed step launches 8 K1 and 4 K2
(13 and 4 with every stage), a DHCP-only one 3 K1; a replayed dispatch
makes no synchronising CUDA call. A tape whose bounds leave captures with
no work between them leaves those out, keeps them alive (the shared
pool's count), and replays what the eager code computes.

The zero-copy ring loop on a card (a `NativeRing` whose UMEM the card
maps; `ops/umem.py`): bit for bit the copying loop over the same full
batches, both programs, every optional stage, and L = 1,536 with
line-bound PPPoE sessions (verdicts, every TX/FWD frame's UMEM bytes, the
slow ring's frames, the counts, every table word); `ring_zero_copy`
counts its batches and `ring_copied` none; a sink-bearing engine copies;
the UMEM is registered at the first zero-copy bind and unregistered by
`close`; the gather and scatter kernels equal their plain versions.
"""

import ctypes
import warnings

import numpy as np
import pytest
import torch

from bng_tpu_torch import frames as F
from bng_tpu_torch import kernels
from bng_tpu_torch.ops import qos as qos_mod
from bng_tpu_torch.ops import table as table_mod
from bng_tpu_torch.ops.pipeline import pipeline_step, step_writes
from bng_tpu_torch.runtime import engine as engine_mod
from bng_tpu_torch.runtime import ringprog
from bng_tpu_torch.runtime.engine import Engine, _InFlight, dhcp_program
from bng_tpu_torch.runtime.ring import FLAG_DHCP_CTRL, FLAG_FROM_ACCESS, NativeRing, PyRing
from bng_tpu_torch.telemetry import spans as tele
from bng_tpu_torch.utils.net import ip_to_u32

from torch_deploy import (NOW, PORT_FULL, PORT_PKG, batch, deploy, deploy_full, frame_mix,
                          full_batch, mac)

pytestmark = pytest.mark.torch_port

B, L = 256, 512
STACKS = ("ipoe", "full")
IPOE_STAGES = [tele.PARSE, tele.ANTISPOOF, tele.DHCP, tele.NAT44, tele.QOS, tele.VERDICT,
               tele.NAT_ACCOUNTING]
FULL_STAGES = [tele.PPPOE_DECAP, tele.PARSE, tele.ANTISPOOF, tele.DHCP, tele.GARDEN, tele.NAT44,
               tele.QOS, tele.EDGE, tele.PPPOE_ENCAP, tele.VERDICT, tele.NAT_ACCOUNTING]
DHCP_STAGES = [tele.PARSE, tele.DHCP, tele.VERDICT]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", torch.cuda.current_device())


def build(stack: str, device):
    """(engine, deployment) over a fresh deployment of `stack`."""
    if stack == "full":
        d = deploy_full(PORT_FULL)
        eng = Engine(d.fp, d.nat, d.qos, d.spoof, d.garden, d.pppoe, edge=d.edge,
                     batch_size=B, pkt_slot=L, device=device)
    else:
        d = deploy(PORT_PKG)
        eng = Engine(d.fp, d.nat, d.qos, d.spoof, batch_size=B, pkt_slot=L, device=device)
    return eng, d


def mixed(d, stack: str):
    """(pkt, length, flags, n) of one mixed ring batch."""
    frames, fa = full_batch(d) if stack == "full" else frame_mix(d.tcp_nat)
    pkt, length = batch(frames, B)
    flags = np.zeros((B,), dtype=np.uint32)
    flags[: len(fa)] = np.where(fa, FLAG_FROM_ACCESS, 0)
    return pkt, length, flags, len(frames)


def control(macs, xid: int):
    """(pkt, length, flags, n) of one all-control ring batch: a DISCOVER per MAC."""
    frames = [F.discover_frame(m, xid + i) for i, m in enumerate(macs)]
    pkt, length = batch(frames, B)
    flags = np.zeros((B,), dtype=np.uint32)
    flags[: len(frames)] = FLAG_FROM_ACCESS | FLAG_DHCP_CTRL
    return pkt, length, flags, len(frames)


def table_tensors(t, path="tables"):
    if isinstance(t, torch.Tensor):
        yield path, t
    elif t is not None:
        for f in t._fields:
            yield from table_tensors(getattr(t, f), f"{path}.{f}")


def snapshot(eng) -> dict:
    return {k: v.to("cpu", copy=True) for k, v in table_tensors(eng.tables)}


def assert_same(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), f"{what}: {k}"


class EagerTape:
    """The tape with its capture stubbed: `record` runs the program and
    `replay` runs it again, counting the replays."""

    made: list = []

    def __init__(self, dev):
        self.device, self.replays = dev, 0
        EagerTape.made.append(self)

    def record(self, run):
        self.run = run
        return run()

    def replay(self):
        self.replays += 1
        return self.run()


@pytest.fixture
def stub_capture(monkeypatch):
    """On the CPU: programs build and replay over `EagerTape`; an engine
    replays its ring batches once `replaying` says so."""
    EagerTape.made = []
    monkeypatch.setattr(ringprog, "Tape", EagerTape)
    return EagerTape.made


def replaying(eng):
    eng._replay_ring = True  # as on a card
    return eng


# ---- the recorder, its capture stubbed ---------------------------------------

class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def _fake_begin(self):
    self._graph = _FakeGraph()


def _fake_end(self):
    graph, self._graph = self._graph, None
    return graph


@pytest.mark.parametrize("program", ["ipoe", "full", "dhcp"])
def test_tape_cuts_at_stage_bounds_and_kernel_calls(monkeypatch, program):
    monkeypatch.setattr(ringprog.Tape, "_begin", _fake_begin)
    monkeypatch.setattr(ringprog.Tape, "_end", _fake_end)
    stack = "full" if program == "full" else "ipoe"
    eng, d = build(stack, "cpu")
    twin, _ = build(stack, "cpu")
    pkt, length, flags, _ = mixed(d, stack)
    args = (torch.from_numpy(pkt), torch.from_numpy(length.astype(np.int64)),
            torch.from_numpy((flags & FLAG_FROM_ACCESS) != 0))
    now_s, now_us = torch.tensor(NOW + 1), torch.tensor((NOW + 1) * 10**6 & 0xFFFFFFFF)
    if program == "dhcp":
        def run(e):
            return dhcp_program(e.tables.dhcp, e.geom.dhcp, args[0], args[1], now_s)
    else:
        def run(e):
            return pipeline_step(e.tables, *args, e.geom, now_s, now_us)
    sites = (table_mod.probe, qos_mod.seg_prefix_total)
    tape = ringprog.Tape(torch.device("cpu"))
    out = tape.record(lambda: run(eng))
    ref = run(twin)
    for f in ("verdict", "out_pkt", "out_len"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert (table_mod.probe, qos_mod.seg_prefix_total) == sites and tele._LISTENER is None

    stages, depth, kernel_at = [], 0, []
    for prev, op in zip([None] + tape.ops, tape.ops):
        if op[0] == ringprog.ENTER:
            stages.append(op[1])
            depth += 1
        elif op[0] == ringprog.EXIT:
            assert op[1] == stages[-1]
            depth -= 1
        elif op[0] == ringprog.KERNEL:
            assert depth == 1
            kernel_at.append((stages[-1], op[2]))
        else:
            assert depth <= 1 and (prev is None or prev[0] != ringprog.GRAPH)
    assert depth == 0
    assert stages == {"ipoe": IPOE_STAGES, "full": FULL_STAGES, "dhcp": DHCP_STAGES}[program]
    probes = {"ipoe": 8, "full": 13, "dhcp": 3}[program]
    assert [n for _, n in kernel_at].count("probe") == probes
    assert [n for _, n in kernel_at].count("seg_prefix_total") == (0 if program == "dhcp" else 4)
    assert all(s == tele.QOS for s, n in kernel_at if n == "seg_prefix_total")
    # every stage's ops were captured: one graph at least between its bounds
    assert sum(op[0] == ringprog.GRAPH for op in tape.ops) >= len(stages)


# ---- the engine's program cache, capture stubbed -------------------------------

def _ring_out(eng, pkt, length, flags, n, now):
    return _InFlight(eng._dispatch_ring_batch(pkt, length, flags, n, now)).wait()


def test_plain_cpu_ring_batches_run_eager():
    eng, d = build("ipoe", "cpu")
    _ring_out(eng, *mixed(d, "ipoe"), NOW + 1)
    _ring_out(eng, *control([mac(1), mac(2)], 0x700), NOW + 1)
    assert (eng.ring_eager, eng.ring_replays, eng.ring_captures) == (2, 0, 0)
    assert eng._ring_programs == {} and not eng._replay_ring


@pytest.mark.parametrize("stack", STACKS)
def test_program_cache_keys_builds_replays_and_drops(stub_capture, stack):
    tapes = stub_capture
    eng, d = build(stack, "cpu")
    replaying(eng)
    ref, rd = build(stack, "cpu")  # the twin runs every ring batch as a plain call

    def both(make, now):
        got = _ring_out(eng, *make(d), now)
        want = _ring_out(ref, *make(rd), now)
        assert_same(got, want, f"ring batch at {now}")

    both(lambda x: mixed(x, stack), NOW + 1)
    assert list(eng._ring_programs) == ["step"]
    assert (eng.ring_captures, eng.ring_replays, eng.ring_eager) == (1, 1, 0)
    both(lambda x: mixed(x, stack), NOW + 2)
    both(lambda x: control([mac(1), mac(2), mac(3)], 0x710), NOW + 2)
    assert set(eng._ring_programs) == {"step", "dhcp"}
    assert (eng.ring_captures, eng.ring_replays) == (2, 3)
    assert [t.replays for t in tapes] == [2, 1]  # a key's first batch replays after its build

    # a lease and a QoS delta drain in place: the programs are kept
    for x in (d, rd):
        x.fp.add_subscriber(mac(0x30), pool_id=1, ip=ip_to_u32("10.0.0.40"),
                            lease_expiry=NOW + 900)
        x.qos.set_subscriber(ip_to_u32("10.0.0.12"), down_bps=8_000, up_bps=8_000,
                             up_burst=100, down_burst=100)
    both(lambda x: control([mac(0x30)], 0x720), NOW + 3)
    both(lambda x: mixed(x, stack), NOW + 3)
    assert eng.ring_captures == 2 and len(tapes) == 2

    # a resync: new tensors; the stale programs never replay again
    before = [t.replays for t in tapes]
    eng.resync_tables()
    ref.resync_tables()
    assert eng._ring_programs == {}
    both(lambda x: mixed(x, stack), NOW + 4)
    assert list(eng._ring_programs) == ["step"]
    assert eng.ring_captures == 3 and [t.replays for t in tapes[:2]] == before
    assert_same(snapshot(eng), snapshot(ref), "tables")

    # an adoption rebinds the tables too: the programs go with them
    eng.adopt_device_tables(eng.tables)
    ref.adopt_device_tables(ref.tables)
    assert eng._ring_programs == {}
    both(lambda x: control([mac(2)], 0x728), NOW + 4)
    assert list(eng._ring_programs) == ["dhcp"] and eng.ring_captures == 4
    assert tapes[2].replays == 1

    # the other ways in stay plain calls
    counts = (eng.ring_captures, eng.ring_replays, eng.ring_eager)
    pkt, length, flags, n = mixed(d, stack)
    eng.step(pkt, length.astype(np.int64), (flags & FLAG_FROM_ACCESS) != 0, NOW + 5)
    frames = [F.discover_frame(mac(1), 0x730)]
    eng.process(frames, now=NOW + 5)
    eng.process_dhcp(frames, now=NOW + 5)
    assert (eng.ring_captures, eng.ring_replays, eng.ring_eager) == counts
    assert [t.replays for t in tapes[2:]] == [1, 1]


def test_ring_loops_replay_through_the_cache(stub_capture):
    eng, d = build("ipoe", "cpu")
    replaying(eng)
    ring = PyRing(nframes=4 * B, frame_size=L, depth=2 * B)
    frames, fa = frame_mix(d.tcp_nat)
    for k in range(3):
        for f, a in zip(frames, fa):
            assert ring.rx_push(f, from_access=a)
        eng.process_ring_pipelined(ring, now=NOW + 1 + k)
    eng.flush_pipeline()
    ring.rx_push(F.discover_frame(mac(1), 0x740), from_access=True)
    eng.process_ring(ring, now=NOW + 4)
    assert (eng.ring_captures, eng.ring_replays, eng.ring_eager) == (2, 4, 0)


def test_building_a_program_restores_what_its_runs_write(stub_capture, monkeypatch):
    eng, _ = build("ipoe", "cpu")
    before = snapshot(eng)
    written = []

    def run_and_write(p):
        for t in step_writes(eng.tables):
            t.add_(1)  # what a step's writes do to the saved tensors
        written.append(1)
        return dhcp_program(eng.tables.dhcp, eng.geom.dhcp, p.pkt, p.length, p.now_s)

    ringprog.RingProgram(torch.device("cpu"), run_and_write,
                         step_writes(eng.tables), B, L, fused=True)
    assert len(written) == ringprog.RingProgram.WARMUPS + 1
    assert_same(snapshot(eng), before, "tables after a build")


# ---- on the card -------------------------------------------------------------

def _flight(eng, pkt, length, flags, n, now) -> _InFlight:
    return _InFlight(eng._dispatch_ring_batch(pkt, length, flags, n, now))


@pytest.mark.card
@pytest.mark.parametrize("stack", STACKS)
def test_replay_equals_the_eager_program_bit_for_bit(card, stack):
    eng, d = build(stack, card)
    ref, rd = build(stack, card)
    ref._replay_ring = False
    probes = 13 if stack == "full" else 8

    # building the fused program leaves every table word as it was
    before = snapshot(eng)
    eng._ring_program(engine_mod._STEP)
    torch.cuda.synchronize()
    assert_same(snapshot(eng), before, "tables after the fused program's build")
    assert eng.ring_captures == 1

    def check(makes, now):
        """Dispatch each batch before the last one's outputs are read (the
        pipelined order), then compare each with the eager twin."""
        flights = [_flight(eng, *make(d), now + k) for k, make in enumerate(makes)]
        for k, (make, fl) in enumerate(zip(makes, flights)):
            assert_same(fl.wait(), _flight(ref, *make(rd), now + k).wait(), f"batch {now + k}")
        torch.cuda.synchronize()
        assert_same(snapshot(eng), snapshot(ref), f"tables after {now}")

    mix = [lambda x: mixed(x, stack)] * 3
    ctrl = [lambda x, j=j: control([mac(1), mac(2), mac(3), mac(9)][: 1 + j], 0x800 + 16 * j)
            for j in range(3)]
    check(mix, NOW + 1)
    check(ctrl, NOW + 10)
    assert eng.ring_captures == 2

    for make, launches in ((lambda x: mixed(x, stack), {"probe": probes, "seg_prefix": 4}),
                           (lambda x: control([mac(1)], 0x900), {"probe": 3, "seg_prefix": 0})):
        kernels.reset_launches()
        _flight(eng, *make(d), NOW + 20).wait()
        assert kernels.LAUNCHES == launches
        _flight(ref, *make(rd), NOW + 20).wait()  # the twin takes the same batches

    # a lease and a QoS delta drain in place: the programs are kept
    for x in (d, rd):
        x.fp.add_subscriber(mac(0x30), pool_id=1, ip=ip_to_u32("10.0.0.40"),
                            lease_expiry=NOW + 900)
        x.qos.set_subscriber(ip_to_u32("10.0.0.10"), down_bps=8_000, up_bps=8_000,
                             up_burst=100, down_burst=100)
    check([lambda x: control([mac(0x30)], 0x910)] + mix, NOW + 30)
    assert eng.ring_captures == 2

    # a resync re-keys: both programs are built again
    eng.resync_tables()
    ref.resync_tables()
    check(mix + ctrl, NOW + 40)
    assert eng.ring_captures == 4

    # a replayed dispatch makes no synchronising CUDA call
    pkt, length, flags, n = mixed(d, stack)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fl = _flight(eng, pkt, length, flags, n, NOW + 50)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    fl.wait()
    syncs = [str(w.message) for w in seen if "called a synchronizing" in str(w.message)]
    assert not syncs, syncs[:3]


@pytest.mark.card
def test_empty_segments_between_bounds(card):
    x = torch.arange(B, dtype=torch.int64, device=card)
    (x * 2 + 1).sum()  # eager first: nothing lazy left for the capture

    def run():
        with tele.region(tele.PARSE):  # no op before the first bound: an empty capture
            y = x * 2
        with tele.region(tele.DHCP):  # nothing between the bounds: empty ones
            pass
        with tele.region(tele.VERDICT):
            z = y + 1
        return z  # nothing after the last bound: another

    tape = ringprog.Tape(card)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = tape.record(run)
    assert not [w for w in seen if ringprog._EMPTY_GRAPH in str(w.message)]
    kinds = [op[0] for op in tape.ops]
    # torch's warning still names an empty capture: each is left out, and kept
    assert kinds.count(ringprog.GRAPH) == 2 and len(tape._empty) == 5, kinds
    assert [op[1] for op in tape.ops if op[0] == ringprog.ENTER] == [
        tele.PARSE, tele.DHCP, tele.VERDICT]
    # the pool outlives the empty captures: more captures into it, and replays
    again = ringprog.Tape(card)
    again.pool = tape.pool
    again._stream = tape._stream
    out2 = again.record(run)
    for k in range(3):
        x.add_(k + 1)
        assert tape.replay() is out and again.replay() is out2
        assert torch.equal(out, x * 2 + 1) and torch.equal(out2, x * 2 + 1)


# ---- the zero-copy ring loop on the card --------------------------------------

def _zc_engine(stack: str, device, **kw):
    """(engine, ring batches [(frames, flags)]) of a stack whose batches are
    all full: the engine's batch is the mix's width (the copying loop re-runs
    a partial batch's stale tail lanes, the zero-copy loop runs them empty:
    PERF.md, open questions)."""
    if stack == "pppoe":
        from test_torch_pppoe_qinq import B as PB
        from test_torch_pppoe_qinq import L as PL
        from test_torch_pppoe_qinq import stack as pppoe_stack

        _, traffic, _, eng = pppoe_stack(17, device=device)
        for k, v in kw.items():
            setattr(eng, k, v)
        batches = [([traffic.rows[i, : traffic.lens[i]].tobytes() for i in range(g, g + PB)],
                    traffic.flags[g: g + PB].astype(np.uint32))
                   for g in range(0, len(traffic.lens), PB)]
        assert eng.L == PL == 1536
        return eng, batches
    d = deploy_full(PORT_FULL) if stack == "full" else deploy(PORT_PKG)
    frames, fa = full_batch(d) if stack == "full" else frame_mix(d.tcp_nat)
    opt = dict(garden=d.garden, pppoe=d.pppoe, edge=d.edge) if stack == "full" else {}
    eng = Engine(d.fp, d.nat, d.qos, d.spoof, batch_size=len(frames), pkt_slot=L,
                 device=device, **opt, **kw)
    mix = (frames, np.where(fa, FLAG_FROM_ACCESS, 0).astype(np.uint32))
    ctrl = ([F.discover_frame(mac(0x80 + k), 0x800 + k) for k in range(len(frames))],
            np.full(len(frames), FLAG_FROM_ACCESS, np.uint32))
    return eng, [mix, ctrl, mix, mix]


def _zc_serve(eng, ring, batches, loop: str) -> dict:
    """Each batch pushed with its frames' own directions and served; the
    verdicts, the TX/FWD frames as the ring hands them out (their UMEM
    bytes), the slow ring's frames, the ring's and the engine's counts."""
    got = {"verdicts": [], "out": [], "slow": []}
    apply, slow_pop = eng._apply_ring_verdicts, ring.slow_pop

    def spy(ring_, fl, pkt, length, n, now):
        h = apply(ring_, fl, pkt, length, n, now)
        got["verdicts"].append(h["verdict"][:n].copy())
        return h

    def tap():
        item = slow_pop()
        if item is not None:
            got["slow"].append(item)
        return item

    eng._apply_ring_verdicts, ring.slow_pop = spy, tap
    umem = ring.umem_view()
    run = eng.process_ring if loop == "sync" else eng.process_ring_pipelined
    for k, (frames, flags) in enumerate(batches):
        addrs = np.zeros(len(frames), dtype=np.uint64)
        assert ring.rx_reserve_batch(addrs) == len(frames)
        lens = np.array([len(f) for f in frames], dtype=np.uint32)
        for a, f in zip(addrs, frames):
            umem[int(a): int(a) + len(f)] = np.frombuffer(f, dtype=np.uint8)
        ok = np.zeros(len(frames), dtype=np.uint8)
        assert ring.rx_submit_batch(addrs, lens, flags, ok, len(frames)) == len(frames)
        run(ring, now=NOW + 1 + k)
        for pop in (ring.tx_pop, ring.fwd_pop):
            while (item := pop()) is not None:
                got["out"].append(item)
    eng.flush_pipeline()
    for pop in (ring.tx_pop, ring.fwd_pop):
        while (item := pop()) is not None:
            got["out"].append(item)
    torch.cuda.synchronize()
    got["counts"] = (ring.stats(), [getattr(eng.stats, f).tolist()
                                    if isinstance(getattr(eng.stats, f), np.ndarray)
                                    else getattr(eng.stats, f) for f in vars(eng.stats)])
    return got


@pytest.mark.card
@pytest.mark.parametrize("stack, loop", [("ipoe", "sync"), ("ipoe", "pipelined"),
                                         ("full", "pipelined"), ("pppoe", "pipelined")])
def test_zero_copy_loop_equals_the_copying_loop_bit_for_bit(card, stack, loop):
    """Both programs, every stage, and L = 1,536 with line-bound PPPoE
    sessions: verdicts, every TX/FWD frame's UMEM bytes, the slow ring's
    frames, the counts and every table word, the copying loop against the
    zero-copy loop."""
    got, engines = {}, {}
    for path in ("copy", "zero_copy"):
        eng, batches = _zc_engine(stack, card)
        nb = len(batches)
        ring = NativeRing(nframes=1024, frame_size=2048, depth=512)
        if path == "copy":
            ring.map_umem = lambda device: None  # the copying loop, held against the other
        got[path] = _zc_serve(eng, ring, batches, loop)
        engines[path] = eng
        ring.close()
    for key in ("verdicts", "out", "slow", "counts"):
        assert len(got["zero_copy"][key]) == len(got["copy"][key]), key
        for a, b in zip(got["zero_copy"][key], got["copy"][key]):
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, key
    assert_same(snapshot(engines["zero_copy"]), snapshot(engines["copy"]), "tables")
    zc, cp = engines["zero_copy"], engines["copy"]
    assert (zc.ring_zero_copy, zc.ring_copied, cp.ring_copied, cp.ring_zero_copy) == (nb, 0, nb, 0)
    verdicts = np.concatenate(got["copy"]["verdicts"])
    assert (verdicts == engine_mod.VERDICT_FWD).any() and got["copy"]["out"]
    if stack == "pppoe":
        assert zc.stats.pppoe_line[0] > 0 and zc.stats.pppoe_line[1] > 0


def _registered(ring, card) -> bool:
    """Whether the driver holds the ring's UMEM as registered host memory:
    registering it again is then refused (cudaErrorHostMemoryAlreadyRegistered,
    712); else the probe's own registration is undone."""
    from bng_tpu_torch.ops import umem as umem_ops

    ptr = ctypes.cast(ring.umem_ptr, ctypes.c_void_p).value
    size = (ring.umem_size + 4095) & ~4095
    try:
        umem_ops.register(ptr, size, torch.device(card))
    except RuntimeError as e:
        assert "CUDA error 712" in str(e), e
        return True
    umem_ops.unregister(ptr)
    return False


class _WatchDestroy:
    """A ring's library, calling `before` ahead of `bng_ring_destroy`."""

    def __init__(self, lib, before):
        self._lib, self._before = lib, before

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def bng_ring_destroy(self, h):
        self._before()
        return self._lib.bng_ring_destroy(h)


@pytest.mark.card
def test_zero_copy_engages_only_where_it_can_and_close_unregisters(card):
    # a sink reads the arriving frames from the staged batch: the copying path
    eng, batches = _zc_engine("ipoe", card, violation_sink=lambda lane, frame: None)
    ring = NativeRing(nframes=1024, frame_size=2048, depth=512)
    _zc_serve(eng, ring, batches[:2], "pipelined")
    assert (eng.ring_copied, eng.ring_zero_copy) == (2, 0)
    # the UMEM is registered at the first zero-copy bind and let go at close,
    # before the ring frees it; the engine names its card as the benchmark
    # does, without an index
    assert not _registered(ring, card)
    eng2, _ = _zc_engine("ipoe", "cuda")
    _zc_serve(eng2, ring, batches[:2], "pipelined")
    assert (eng2.ring_zero_copy, eng2.ring_copied) == (2, 0)
    assert _registered(ring, card)
    at_free = []
    ring._lib = _WatchDestroy(ring._lib, lambda: at_free.append(_registered(ring, card)))
    ring.close()
    assert at_free == [False]


@pytest.mark.card
@pytest.mark.parametrize("frame_size, L, offs", [(512, 512, (0,)), (2048, 1536, (0,)),
                                                 (2048, 1536, (0, 3, 17, 256)),
                                                 (512, 500, (0, 5))])
def test_umem_kernels_equal_their_plain_versions(card, frame_size, L, offs):
    """The gather and the scatter on the card against `ops/umem.py`'s plain
    versions: full and partial batches, headroom offsets, frames longer
    than the slot, a ragged slot, every verdict."""
    from bng_tpu_torch.ops import umem as umem_ops

    rng = np.random.default_rng(frame_size + L + len(offs))
    Bk = 512
    ring = NativeRing(nframes=1024, frame_size=frame_size, depth=512)
    umem = ring.map_umem(card)
    host = ring.umem_view()
    host[:] = rng.integers(0, 256, host.shape, dtype=np.uint8)
    for n in (Bk, Bk - 37):
        chunks = rng.permutation(1024)[:Bk].astype(np.uint64)
        off = rng.choice(np.array(offs, dtype=np.uint64), Bk)
        desc = umem_ops.DescStage(Bk, card).acquire()
        desc.addrs[:] = chunks * np.uint64(frame_size) + off
        desc.lens[:] = np.minimum(rng.integers(0, frame_size + 1, Bk),
                                  frame_size - off.astype(np.int64))
        desc.flags[:] = rng.integers(0, 4, Bk)
        outs = {}
        for dev in ("cpu", card):
            pkt = torch.full((Bk, L), 0xEE, dtype=torch.uint8, device=dev)
            length = torch.full((Bk,), 7, dtype=torch.int64, device=dev)
            fa = torch.ones((Bk,), dtype=torch.bool, device=dev)
            d = torch.full((umem_ops.DESC_BYTES * Bk,), 9, dtype=torch.uint8, device=dev)
            now_s = torch.zeros((), dtype=torch.int64, device=dev)
            now_us = torch.zeros((), dtype=torch.int64, device=dev)
            umem_ops.gather(umem, desc, d, n, pkt, length, fa, now_s, 1_753_000_001,
                            now_us, 3_000_000_017)
            outs[str(dev)] = [t.cpu() for t in (pkt, length, fa, d, now_s, now_us)]
            desc.acquire()  # the copy on the card has read the descriptors
        for a, b in zip(outs["cpu"], outs[str(card)]):
            assert torch.equal(a, b), n
        verdict = torch.from_numpy(rng.integers(0, 4, Bk).astype(np.int32))
        out_pkt = torch.from_numpy(rng.integers(0, 256, (Bk, L), dtype=np.uint8))
        out_len = torch.from_numpy(rng.integers(0, frame_size + 64, Bk).astype(np.int64))
        want = torch.from_numpy(host.copy())
        kept = umem_ops.desc_addrs(outs["cpu"][3], Bk)
        umem_ops.scatter_plain(want, kept, n, frame_size, verdict, out_pkt, out_len)
        umem_ops.scatter(umem, kept.to(card), n, verdict.to(card), out_pkt.to(card),
                         out_len.to(card))
        torch.cuda.synchronize()
        assert np.array_equal(host, want.numpy()), n
    ring.close()
