"""The zero-copy ring's host side and the plain versions of its movers
(`ops/umem.py`, `csrc/ringdesc.cpp`, the engine's zero-copy ring loop).

- Ring level, on two `NativeRing`s given the same frames: the descriptor
  assemble (`assemble_desc`) and the gather give the `pkt`, `length` and
  flags the copying assemble stages, and the scatter with
  `complete(out=None)` leaves the UMEM, the TX/FWD/slow rings, the stats
  and the free pool as `complete(out)` leaves them. Cases: a full batch,
  a partial one (tail lanes length 0 and zero), headroom-offset
  descriptors (the room clamp), frames longer than the slot, a slot that
  is no multiple of 16, and the PPPoE cell's geometry (frame 2,048, slot
  1,536); every verdict, output lengths past the slot and past the room.
- Engine level, on the CPU with the ring programs' capture stubbed (the
  tape runs the program eagerly): the zero-copy loop over a `NativeRing`
  gives the frames, stats and table words the copying loop gives, both
  loops, both stacks; `ring_zero_copy` counts its batches and
  `ring_copied` the copying loop's; a sink-bearing engine and a `PyRing`
  take the copying path; the plain CPU engine never maps a UMEM; a card
  that refuses the UMEM's registration raises, with its CUDA error, and
  the ring maps nothing.
- The copying pipelined loop re-runs the stale tail lanes of a partial
  batch (its ping-pong staging keeps the rows of the batch two back, and
  the step advances their NAT counters again); the zero-copy loop runs
  empty tail lanes and ends as a copying loop over fresh staging does
  (PERF.md, open questions).

No JAX here: on a card, tests/test_torch_ring_program.py holds the CUDA
movers to these plain versions.
"""

import numpy as np
import pytest
import torch

from bng_tpu_torch import frames as F
from bng_tpu_torch import kernels
from bng_tpu_torch.ops import umem as umem_ops
from bng_tpu_torch.ops.pipeline import VERDICT_DROP, VERDICT_FWD, VERDICT_PASS, VERDICT_TX
from bng_tpu_torch.runtime import ringprog
from bng_tpu_torch.runtime import ring as t_ring
from bng_tpu_torch.runtime.engine import Engine

from test_torch_ring_program import EagerTape, snapshot
from torch_deploy import NOW, PORT_FULL, PORT_PKG, deploy, deploy_full, frame_mix, full_batch

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")

# name: (frame_size, slot, batch, frames pushed, headroom offsets, longest frame)
GEOMETRIES = {
    "full": (512, 512, 32, 32, (0,), 500),
    "partial": (512, 512, 32, 13, (0,), 500),
    "headroom": (2048, 1536, 32, 32, (0, 3, 17, 256, 1000), 1000),
    "longer_than_slot": (2048, 1536, 16, 16, (0,), 2048),
    "ragged_slot": (512, 500, 16, 11, (0, 5), 507),
    "pppoe": (2048, 1536, 32, 29, (0,), 1522),
}


def _frames(rng, count: int, longest: int) -> list[bytes]:
    """Random frames of 1..longest bytes, with DHCP DISCOVERs among them."""
    out = []
    for i in range(count):
        if i % 5 == 0:
            out.append(F.discover_frame(bytes([2, 0, 0, 0, 1, i]), 0x700 + i))
        else:
            out.append(rng.integers(0, 256, int(rng.integers(1, longest + 1)),
                                    dtype=np.uint8).tobytes())
    return out


def _twin_rings(geom: str, seed: int):
    """Two native rings given the same frames; returns (rings, batch, slot)."""
    fsz, L, B, count, offs, longest = GEOMETRIES[geom]
    rng = np.random.default_rng(seed)
    frames = _frames(rng, count, longest)
    off = np.array([offs[i % len(offs)] for i in range(count)], dtype=np.uint64)
    lens = np.array([min(len(f), fsz - int(o)) for f, o in zip(frames, off)], dtype=np.uint32)
    fa = np.where(rng.random(count) < 0.7, t_ring.FLAG_FROM_ACCESS, 0).astype(np.uint32)
    rings = []
    for _ in range(2):
        r = t_ring.NativeRing(nframes=64, frame_size=fsz, depth=64)
        umem = r.umem_view()
        addrs = np.zeros(count, dtype=np.uint64)
        assert r.rx_reserve_batch(addrs) == count
        addrs += off
        for a, f, n in zip(addrs, frames, lens):
            umem[int(a): int(a) + int(n)] = np.frombuffer(f[:n], dtype=np.uint8)
        ok = np.zeros(count, dtype=np.uint8)
        if len(offs) > 1:  # headroom descriptors: the batch submit, one direction
            assert r.rx_submit_batch(addrs, lens, t_ring.FLAG_FROM_ACCESS, ok, count) == count
        else:  # a direction a frame: the per-frame submit
            assert r.rx_submit_batch(addrs, lens, fa, ok, count) == count
        rings.append(r)
    return rings, B, L


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_desc_gather_and_scatter_equal_the_copying_ring(geom):
    (ra, rb), B, L = _twin_rings(geom, seed=len(geom))
    # the copying ring: assemble into fresh staging
    pkt = np.zeros((B, L), dtype=np.uint8)
    length = np.zeros((B,), dtype=np.uint32)
    flags = np.zeros((B,), dtype=np.uint32)
    n = ra.assemble(pkt, length, flags)
    # the zero-copy ring: descriptors, then the gather from the UMEM
    desc = umem_ops.DescStage(B, CPU).acquire()
    assert rb.assemble_desc(desc.addrs, desc.lens, desc.flags) == n > 0
    umem = rb.map_umem(CPU)
    g_pkt = torch.full((B, L), 0xEE, dtype=torch.uint8)  # stale bytes the gather must clear
    g_len = torch.full((B,), 7, dtype=torch.int64)
    g_fa = torch.ones((B,), dtype=torch.bool)
    d = torch.zeros((umem_ops.DESC_BYTES * B,), dtype=torch.uint8)
    now_s, now_us = torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.int64)
    umem_ops.gather(umem, desc, d, n, g_pkt, g_len, g_fa, now_s, 17, now_us, 17_000_001)
    addrs = umem_ops.desc_addrs(d, B)
    assert np.array_equal(g_pkt.numpy(), pkt)
    assert np.array_equal(g_len.numpy(), length.astype(np.int64))
    assert np.array_equal(desc.flags[:n], flags[:n])
    assert np.array_equal(g_fa.numpy(), (flags & t_ring.FLAG_FROM_ACCESS) != 0)
    assert np.array_equal(addrs.numpy()[:n], desc.addrs[:n])
    assert (int(now_s), int(now_us)) == (17, 17_000_001)
    assert ra.stats() == rb.stats() and ra.rx_pending() == rb.rx_pending()

    # every verdict; output lengths past the slot and past a chunk's room
    rng = np.random.default_rng(n)
    verdict = rng.choice([VERDICT_PASS, VERDICT_DROP, VERDICT_TX, VERDICT_FWD], size=B)
    verdict[:4] = [VERDICT_PASS, VERDICT_DROP, VERDICT_TX, VERDICT_FWD]
    out = rng.integers(0, 256, (B, L), dtype=np.uint8)
    out_len = rng.integers(0, ra.frame_size + 64, B).astype(np.int64)
    ra.complete(verdict.astype(np.uint8), out, out_len.astype(np.uint32), n)
    umem_ops.scatter(umem, addrs, n, torch.from_numpy(verdict.astype(np.int32)),
                     torch.from_numpy(out), torch.from_numpy(out_len))
    rb.complete(verdict.astype(np.uint8), None, out_len.astype(np.uint32), n)
    assert np.array_equal(ra.umem_view(), rb.umem_view())
    assert ra.stats() == rb.stats() and ra.free_frames() == rb.free_frames()
    for which in ("tx", "fwd", "slow"):
        pop_a, pop_b = getattr(ra, f"{which}_pop"), getattr(rb, f"{which}_pop")
        while (got := pop_a()) is not None:
            assert pop_b() == got, which
        assert pop_b() is None, which
    for r in (ra, rb):
        r.close()


def test_desc_assemble_opens_the_copying_windows():
    """Two windows at most, FIFO, as `assemble` opens them; nothing pending
    opens none."""
    (ra, rb), B, L = _twin_rings("full", seed=3)
    desc = umem_ops.DescStage(8, CPU)
    pkt = np.zeros((8, L), np.uint8)
    lens, fl = np.zeros(8, np.uint32), np.zeros(8, np.uint32)
    got_a = [ra.assemble(pkt, lens, fl) for _ in range(3)]
    got_b = [rb.assemble_desc(desc.addrs, desc.lens, desc.flags) for _ in range(3)]
    assert got_a == got_b == [8, 8, 0]
    v = np.full(8, VERDICT_DROP, np.uint8)
    for r in (ra, rb):
        r.complete(v, None, lens, 8)
    assert ra.assemble(pkt, lens, fl) == rb.assemble_desc(desc.addrs, desc.lens, desc.flags) == 8
    assert ra.stats() == rb.stats()
    empty = t_ring.NativeRing(nframes=64, frame_size=512, depth=64)
    assert empty.assemble_desc(desc.addrs, desc.lens, desc.flags) == 0
    for r in (ra, rb, empty):
        r.close()
    assert umem_ops.DESC_FROM_ACCESS == t_ring.FLAG_FROM_ACCESS


@pytest.fixture
def stub_capture(monkeypatch):
    """The ring programs' capture stubbed: their tape runs the program."""
    EagerTape.made = []
    monkeypatch.setattr(ringprog, "Tape", EagerTape)


def _engine(stack: str, B: int, sink=None):
    if stack == "full":
        d = deploy_full(PORT_FULL)
        eng = Engine(d.fp, d.nat, d.qos, d.spoof, d.garden, d.pppoe, edge=d.edge,
                     batch_size=B, pkt_slot=512, device="cpu", violation_sink=sink)
        frames, fa = full_batch(d)
    else:
        d = deploy(PORT_PKG)
        eng = Engine(d.fp, d.nat, d.qos, d.spoof, batch_size=B, pkt_slot=512, device="cpu",
                     violation_sink=sink)
        frames, fa = frame_mix(d.tcp_nat)
    eng._replay_ring = True  # as on a card; the tape is stubbed
    return eng, list(zip(frames, fa))


def _serve(eng, ring, batches, loop: str) -> list:
    """Push each batch, run the loop, then drain what came out."""
    run = eng.process_ring if loop == "sync" else eng.process_ring_pipelined
    rec = []
    for k, batch in enumerate(batches):
        for f, a in batch:
            assert ring.rx_push(f, from_access=a)
        rec.append(run(ring, now=NOW + 1 + k))
    rec.append(eng.flush_pipeline())
    for pop in (ring.tx_pop, ring.fwd_pop, ring.slow_pop):
        while (item := pop()) is not None:
            rec.append(item)
    rec.append((ring.stats(), eng.stats.tx, eng.stats.fwd, eng.stats.dropped, eng.stats.passed,
                eng.stats.dhcp.tolist(), eng.stats.nat.tolist(), eng.stats.qos.tolist()))
    return rec


def _control(n: int) -> list:
    return [(F.discover_frame(bytes([2, 0, 0, 0, k >> 8, k & 0xFF]), 0x600 + k), True)
            for k in range(n)]


def _ring(copying: bool = False):
    ring = t_ring.NativeRing(nframes=256, frame_size=512, depth=128)
    if copying:
        ring.map_umem = lambda device: None  # the copying loop, held against the other
    return ring


@pytest.mark.parametrize("loop", ["sync", "pipelined"])
@pytest.mark.parametrize("stack", ["ipoe", "full"])
def test_zero_copy_loop_equals_the_copying_loop(stub_capture, stack, loop):
    """Full batches (the engine's batch is the mix's width), mixed and all-control."""
    recs, engines = {}, {}
    for path in ("copy", "zero_copy"):
        eng, mix = _engine(stack, B=len(_engine(stack, 1)[1]))
        ring = _ring(copying=path == "copy")
        recs[path] = _serve(eng, ring, [mix, _control(len(mix)), mix, mix], loop)
        engines[path] = eng
        ring.close()
    assert recs["zero_copy"] == recs["copy"]
    assert_tables_equal(engines["zero_copy"], engines["copy"])
    zc, cp = engines["zero_copy"], engines["copy"]
    assert zc.ring_zero_copy == zc.ring_replays == 4 and zc.ring_copied == 0
    assert cp.ring_copied == cp.ring_replays == 4 and cp.ring_zero_copy == 0
    assert recs["copy"][-1][0]["fwd"] > 0 and recs["copy"][-1][0]["tx"] > 0


@pytest.mark.parametrize("case", ["violation_sink", "mirror_sink", "py_ring", "plain_cpu"])
def test_paths_that_keep_copying(stub_capture, case):
    """Sinks read the arriving frames from the staged batch, a `PyRing` has
    no UMEM, and the plain CPU engine replays nothing: all copy."""
    eng, mix = _engine("ipoe", B=64, sink=(lambda lane, frame: None)
                       if case == "violation_sink" else None)
    if case == "mirror_sink":
        eng.mirror_sink = lambda lane, frame, warrant: None
    if case == "plain_cpu":
        eng._replay_ring = False
    ring = (t_ring.PyRing(256, 512, 128) if case == "py_ring" else _ring())
    _serve(eng, ring, [mix, mix], "pipelined")
    assert eng.ring_zero_copy == 0
    if case == "plain_cpu":
        assert eng.ring_eager == 2 and eng.ring_copied == 0
    else:
        assert eng.ring_copied == eng.ring_replays == 2
    ring.close()


def test_refused_registration_raises(monkeypatch):
    """No copying fallback: a card that refuses the registration raises with
    the CUDA error, and the ring holds no map (so `close` unregisters
    nothing)."""
    calls = []

    def entry(name):
        assert name == "umem_register", name
        return lambda host, size, dev_ptr, device: calls.append((host, size, device)) or 1

    monkeypatch.setattr(kernels, "entry", entry)
    ring = t_ring.NativeRing(nframes=256, frame_size=512, depth=128)
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        ring.map_umem(torch.device("cuda", 0))
    assert calls == [(ring.umem_view().ctypes.data, 256 * 512, 0)] and ring._umem_map is None
    ring.close()


def test_copying_loop_reruns_stale_tail_lanes(stub_capture):
    """The copying pipelined loop's ping-pong staging keeps the rows of the
    batch two back beyond a partial batch's n, with their lengths and
    flags, and the step runs those frames again: their NAT counters
    advance. The zero-copy loop's tail lanes are empty (length 0), and it
    ends as the copying loop does over fresh staging."""
    runs = {}
    for path in ("copy", "fresh", "zero_copy"):
        eng, mix = _engine("ipoe", B=len(_engine("ipoe", 1)[1]))
        ring = _ring(copying=path != "zero_copy")
        part = mix[9:14]  # established flows: the fused step
        for k, batch in enumerate([mix, mix, part]):
            if k == 2 and path == "fresh":
                eng._stage_bufs[1 - eng._stage_idx] = None  # fresh zero staging
            for f, a in batch:
                assert ring.rx_push(f, from_access=a)
            eng.process_ring_pipelined(ring, now=NOW + 1 + k)
        if path == "copy":
            pkt, length, _ = eng._stage_bufs[eng._stage_idx]  # the partial batch's staging
            first, _, _ = eng._stage_bufs[1 - eng._stage_idx]
            assert (length[5:] > 0).all()
            assert np.array_equal(pkt[5:], first[5:])  # batch 2's rows == batch 1's
        eng.flush_pipeline()
        runs[path] = eng
        ring.close()
    vals = {k: snapshot(e)["tables.nat.sessions.vals"] for k, e in runs.items()}
    assert not torch.equal(vals["copy"], vals["zero_copy"])
    assert runs["copy"].stats.nat[0] > runs["zero_copy"].stats.nat[0]
    assert_tables_equal(runs["zero_copy"], runs["fresh"])
    assert runs["zero_copy"].stats.nat.tolist() == runs["fresh"].stats.nat.tolist()


def assert_tables_equal(a, b):
    sa, sb = snapshot(a), snapshot(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
