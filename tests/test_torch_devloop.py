"""The port's devloop against the JAX package's.

- Two fresh serving stacks, one per package (tables, pool, DHCP server as
  the slow path, engine, scheduler; the geometry of
  tests/test_torch_scheduler.py), with `express_loop="devloop"`: a burst
  sequence over several rings (full rings and a partial flush ring) gives
  the same reply bytes per frame, the same scheduler and pump counters,
  the same cursor words after `quiesce` and the same DHCP table words. The
  reference runs under its `xla` probe and its Pallas probe (interpret
  mode). The port's devloop gives its own per-batch `aot` lane's bytes.
- A multi-round lease case: DISCOVERs and REQUESTs of new clients go to
  the slow path between rings, and their renewals are answered by a ring.
- The published-chain lag: a bulk dispatch whose DHCP replica refresh
  falls while a ring is in flight reads the same DHCP words in both
  packages (the ring's lease is not yet published), and the lease serves
  on the bulk lane only after a later refresh.
- A resync with a ring in flight: both pumps publish their pre-resync
  chain over the fresh upload, so the published tables equal the
  reference's word for word and lack the row the resync brought.
- Fallbacks, each with the reference's counters and bytes: an injected
  `devloop.dispatch` fail mid-storm, a geometry miss, `express_loop=
  "auto"` with the express program disabled, the devloop asked for with
  it disabled, an invalid spelling, and `BNG_EXPRESS_LOOP` over the
  config.
- The pump's telemetry with a tracer armed (clean rings, and an injected
  fallback): the same stage counts, flight records, triggers and ring
  metadata in both packages.
- The ring mechanics of tests/test_devloop.py::TestRing: the overfill
  guard, k validation, stale-tail zeroing and the cursor audit after
  quiesce; the program is built once per key and holds no graph on the
  CPU.

Tolerance: bit-exact.
"""

import jax
import numpy as np
import pytest

from bng_tpu.chaos import faults as jf
from bng_tpu.devloop import kernel as j_kernel
from bng_tpu.ops import table as j_table
from bng_tpu.runtime.lanes import CLOSE_FLUSH
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import faults as tf
from bng_tpu_torch.devloop import CUR_EPOCH, CUR_SEQ, CUR_TAIL, DescriptorRing
from bng_tpu_torch.devloop import kernel as t_kernel
from bng_tpu_torch.ops.express import XD_WORDS
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_scheduler import (
    JAX, PORT, SERVER_IP, T0, FakeClock, build_stack, data_frame, dhcp, engines_equal, mac,
)
from test_torch_stages import assert_tuple_equal
from test_torch_telemetry import split_stages

pytestmark = pytest.mark.torch_port

BATCH = 8


def _stack(mods, impl="xla", **cfg):
    cfg = {"express_loop": "devloop", "devloop_k": 3, **cfg}
    if mods is JAX:
        with j_table.forced_impl(impl):
            return build_stack(mods, FakeClock(), **cfg) + (mods,)
    return build_stack(mods, FakeClock(), **cfg) + (mods,)


def _burst(n: int, base: int = 0) -> list:
    """Cached DISCOVERs and REQUESTs of subscribers 0..3 (broadcast and
    unicast) with one newcomer DISCOVER every 8 frames (the slow path)."""
    out = []
    for i in range(n):
        if i % 8 == 7:
            out.append(dhcp(mac(0x40 + base + i), F.DISCOVER, 0x1000 + base + i))
        else:
            out.append(dhcp(mac(i % 4), F.DISCOVER if i % 3 else F.REQUEST, 0x2000 + base + i,
                            broadcast=bool(i % 2)))
    return out


def _cursors(sched):
    return sched._devloop.ring.read_cursors().tolist()


@pytest.mark.parametrize("impl,k", [("xla", 3), ("pallas", 1)])
def test_two_stacks_match_reference_and_the_aot_lane(impl, k):
    j, t = _stack(JAX, impl, devloop_k=k), _stack(PORT, devloop_k=k)
    aot = _stack(PORT, express_loop="aot")
    for sched, *_ in (j, t):
        assert sched.express_loop == "devloop"
    frames = _burst(BATCH * (2 * k + 1) + 3)  # full rings, then a partial flush ring
    outs = [s.process(frames, now=T0) for s, *_ in (j, t, aot)]
    assert outs[1] == outs[0] == outs[2]
    for sched, *_ in (j, t):
        sched.quiesce(now=T0)
    assert _cursors(t[0]) == _cursors(j[0])
    assert t[0]._devloop.audit() == j[0]._devloop.audit()
    assert t[0]._devloop.audit()["consistent"]
    engines_equal(j[:3] + (None,), t[:3] + (None,))
    dl = t[0].stats_snapshot()["express"]["devloop"]
    assert dl["dispatches"] >= 3 and dl["fallback_slots"] == 0
    assert len(outs[1]["tx"]) > len(frames) // 2 and any(r for _, r in outs[1]["slow"])


def test_multi_round_lease_state():
    """Rounds of rings with the slow path leasing between them: OFFERs and
    ACKs from the server, then renewals the rings answer on the device."""
    stacks = [_stack(JAX), _stack(PORT), _stack(PORT, express_loop="aot")]
    newcomers = [mac(0x80 + i) for i in range(6)]
    rounds = []
    offers = {}
    for r in range(3):
        frames = _burst(BATCH * 2, base=r * 100)
        for i, m in enumerate(newcomers):
            if r == 0:
                frames.append(dhcp(m, F.DISCOVER, 0x3000 + i))
            elif r == 1:
                frames.append(dhcp(m, F.REQUEST, 0x3100 + i, requested_ip=offers[i],
                                   server_id=SERVER_IP))
            else:
                frames.append(dhcp(m, F.REQUEST, 0x3200 + i, ciaddr=offers[i]))
        outs = [s.process(frames, now=T0 + r) for s, *_ in stacks]
        assert outs[1] == outs[0] == outs[2]
        if r == 0:
            slow = dict(outs[1]["slow"])
            base = len(frames) - len(newcomers)
            offers = {i: F.decode_dhcp(F.decode(slow[base + i]).payload).yiaddr
                      for i in range(len(newcomers))}
        rounds.append(outs[1])
    renewals = {i for i, _ in rounds[2]["tx"]} & set(range(len(frames) - 6, len(frames)))
    assert len(renewals) == 6  # answered by a ring, from leases the slow path wrote
    for sched, *_ in stacks:
        sched.quiesce(now=T0 + 3)
    assert _cursors(stacks[1][0]) == _cursors(stacks[0][0])
    engines_equal(stacks[0][:3] + (None,), stacks[1][:3] + (None,))


def test_published_chain_lags_the_ring_in_flight():
    """A lease cached and drained into a ring that is still in flight: a
    bulk dispatch refreshing its DHCP replica then reads the published
    tables without it, in both packages."""
    x = mac(0x70)
    rec = []
    for sched, server, fp, mods in (_stack(JAX), _stack(PORT)):
        now = T0
        # a first ring round trip: the reference's published tables are then
        # its ring's output, no longer the CPU upload that may alias the host
        # mirror (ROADMAP Queue 3)
        sched.process(_burst(BATCH * 3), now=now)
        fp.add_subscriber(x, 1, ip_to_u32("10.0.0.77"), int(T0) + 900)
        for i in range(BATCH * 3):  # one full ring (k = 3): its dispatch drains x's lease
            sched.submit(dhcp(mac(i % 4), F.DISCOVER, 0x4000 + i), True, now=now)
        for _ in range(3):
            pend, reason = sched.express.close_batch(now)
            assert sched._dispatch_express(pend, now, reason) == 0
        assert len(sched._devloop._inflight) == 1 and fp.dirty_count() == 0
        sched.submit(dhcp(x, F.DISCOVER, 0x4100), True, now=now, lane="bulk")
        sched.submit(data_frame(1), True, now=now)
        pend, reason = sched.bulk.close_batch(now, CLOSE_FLUSH)
        assert sched._dispatch_bulk(pend, now, reason) is None
        replica = sched._bulk_dhcp
        if mods is JAX:
            replica = jax.tree_util.tree_map(lambda a: np.array(a), replica)
        sched.flush(now=now)
        done = sched.drain_completions()
        bulk_x = [c.verdict for c in done if c.lane == "bulk"]
        late = sched.process([dhcp(x, F.DISCOVER, 0x4200)], now=now)  # express: the ring's lease
        rec.append((replica, bulk_x, [(c.tag, c.verdict, c.frame) for c in done], late))
    (jrep, *jrest), (trep, *trest) = rec
    assert_tuple_equal(convert.tables_to_numpy(trep), jrep, "bulk replica")
    assert trest == jrest
    assert trest[0][0] == "slow" and [i for i, _ in trest[2]["tx"]] == [0]


def _host_dhcp_words(fp) -> list:
    """The full host state of the three DHCP tables, packed as the device
    holds it (read without touching dirty tracking)."""
    out = []
    for t in (fp.sub, fp.vlan, fp.cid):
        out += [t._pack_bucket_rows(np.arange(t.nbuckets)), t._pack_stash_rows(np.arange(t.stash)),
                t.vals.copy()]
    return out


def _published_dhcp_words(sched, mods) -> list:
    d = sched.engine.tables.dhcp
    if mods is JAX:
        d = jax.tree_util.tree_map(lambda a: np.array(a), d)
    else:
        d = convert.tables_to_numpy(d)
    return [np.asarray(a) for t in (d.sub, d.vlan, d.cid) for a in t]


def test_resync_with_a_ring_in_flight():
    """The engine resyncs (a full upload from the host mirrors) while a ring
    is in flight, then one more ring runs. Both pumps keep threading their
    pre-resync chain and publish it over the fresh upload at retire: the
    published tables equal the reference's word for word, the lease written
    just before the resync is missing from the published MAC table, and y's
    DISCOVER goes to the slow path in both packages."""
    x, y = mac(0x71), mac(0x72)
    got = {}
    for sched, server, fp, mods in (_stack(JAX), _stack(PORT)):
        now = T0
        sched.process(_burst(BATCH * 3), now=now)  # a first ring round trip
        fp.add_subscriber(x, 1, ip_to_u32("10.0.0.71"), int(T0) + 900)
        for i in range(BATCH * 3):  # a full ring: its dispatch drains x's lease
            sched.submit(dhcp(mac(i % 4), F.DISCOVER, 0x4300 + i), True, now=now)
        for _ in range(3):
            pend, reason = sched.express.close_batch(now)
            assert sched._dispatch_express(pend, now, reason) == 0
        assert len(sched._devloop._inflight) == 1 and fp.dirty_count() == 0
        fp.add_subscriber(y, 1, ip_to_u32("10.0.0.72"), int(T0) + 900)
        sched.engine.resync_tables()  # y reaches the device only through this upload
        assert fp.dirty_count() == 0
        out = sched.process(_burst(BATCH * 3, base=0x100) + [dhcp(y, F.DISCOVER, 0x4400)],
                            now=now)
        sched.quiesce(now=now)
        host, pub = _host_dhcp_words(fp), _published_dhcp_words(sched, mods)
        lane_y = BATCH * 3
        got[mods is JAX] = (pub, [np.array_equal(h, p) for h, p in zip(host, pub)],
                            lane_y in [i for i, _ in out["tx"]],
                            lane_y in [i for i, _ in out["slow"]], out)
    ref, port = got[True], got[False]
    assert all(np.array_equal(a, b) for a, b in zip(port[0], ref[0]))
    # the published MAC table lacks y (its bucket rows and value row); VLAN
    # and circuit-ID tables are untouched
    assert port[1] == ref[1] == [False, True, False, True, True, True, True, True, True]
    # the ring that ran after the resync missed y (its chain lacks y) and
    # sent it to the slow path
    assert port[2:4] == ref[2:4] == (False, True)
    assert port[4] == ref[4]


def _storm_pair(**cfg):
    return [_stack(JAX, **cfg), _stack(PORT, **cfg)]


def _counters(sched):
    return (sched.stats_snapshot(), sched.engine.stats.batches, sched.engine.stats.dhcp.tolist())


def test_injected_dispatch_fault_mid_storm():
    frames = _burst(BATCH * 3 * 2)  # two full rings
    clean = _stack(PORT)[0].process(frames, now=T0)
    got = []
    for (sched, *_rest), m in zip(_storm_pair(), (jf, tf)):
        plan = m.FaultPlan(0, [m.FaultSpec("devloop.dispatch", m.FAIL, at_hit=2)])
        with m.armed(plan, log=False) as inj:
            out = sched.process(frames, now=T0)
        sched.quiesce(now=T0)
        got.append((out, inj.injected, _counters(sched), sched._devloop.audit(), _cursors(sched)))
    assert got[1] == got[0]
    out, injected, (snap, *_), audit, _ = got[1]
    assert out == clean and injected == [("devloop.dispatch", "fail", 2)]
    assert snap["express"]["fallbacks"] == {"devloop_miss": 1}
    assert snap["express"]["devloop"]["fallback_slots"] == 3 and audit["consistent"]


def test_geometry_miss_serves_per_batch():
    frames = _burst(BATCH * 3)
    got = []
    for sched, *_rest, mods in _storm_pair():
        if mods is JAX:
            key = j_kernel.devloop_key(sched.engine, 3, BATCH, sched._express_dev)
            saved = j_kernel._DEVLOOP_AOT.pop(key)
            try:
                out = sched.process(frames, now=T0)
            finally:
                j_kernel._DEVLOOP_AOT[key] = saved
        else:
            key = t_kernel.devloop_key(sched.engine, 3, BATCH)
            saved = sched.engine._devloop_programs.pop(key)
            assert sched.engine.devloop_aot(3, BATCH) is None
            out = sched.process(frames, now=T0)
            sched.engine._devloop_programs[key] = saved
        got.append((out, _counters(sched), sched._devloop.audit()))
    assert got[1] == got[0]
    snap = got[1][1][0]["express"]
    assert snap["fallbacks"] == {"devloop_miss": 1} and snap["devloop"]["fallback_slots"] == 3


@pytest.mark.parametrize("loop,aot,fallbacks", [("auto", False, {}),
                                                ("devloop", False, {"devloop_unavailable": 1}),
                                                ("auto", True, {})])
def test_loop_resolution(loop, aot, fallbacks):
    frames = _burst(BATCH * 2)
    got = []
    for sched, *_ in _storm_pair(express_loop=loop, express_aot=aot):
        got.append((sched.express_loop, sched.process(frames, now=T0), _counters(sched)))
    assert got[1] == got[0]
    assert got[1][0] == ("devloop" if aot else "aot")
    assert got[1][2][0]["express"]["fallbacks"] == fallbacks


def test_invalid_spelling_and_env_override(monkeypatch):
    for mods in (JAX, PORT):
        with pytest.raises(ValueError):
            _stack(mods, express_loop="turbo")
    monkeypatch.setenv("BNG_EXPRESS_LOOP", "devloop")
    monkeypatch.setenv("BNG_DEVLOOP_K", "3")
    pair = _storm_pair(express_loop="aot", devloop_k=1)
    assert [s.express_loop for s, *_ in pair] == ["devloop", "devloop"]
    assert [s._devloop.ring.k for s, *_ in pair] == [3, 3]


class TestRing:
    def test_overfill_guard_and_k_validation(self):
        ring = DescriptorRing(k=2, batch=4)
        for _ in range(2):
            ring.fill_slot([], [], [], 0.0)
        with pytest.raises(IndexError):
            ring.fill_slot([], [], [], 0.0)
        with pytest.raises(ValueError):
            DescriptorRing(k=0, batch=4)

    def test_take_zeroes_stale_tail(self):
        ring = DescriptorRing(k=2, batch=2, depth=1)
        row = np.full((XD_WORDS,), 7, dtype=np.uint32)
        for _ in range(ring.depth + 2):  # cycle every buffer, full
            ring.fill_slot([row, row], [0, 1], [], 0.0)
            ring.fill_slot([row, row], [0, 1], [], 0.0)
            ring.take()
        ring.fill_slot([row], [0], [], 0.0)  # partial refill
        stage, n, _ = ring.take()
        assert n == 1 and stage.host[1].sum() == 0, "stale slot survived take()"
        assert stage.host[0, 0].tolist() == [7] * XD_WORDS and ring.staging_waits == 0

    def test_cursor_audit_after_quiesce_and_one_program_per_key(self):
        sched, *_ = _stack(PORT)
        eng = sched.engine
        for r in range(3):
            sched.process(_burst(BATCH * 3 + 3, base=r), now=T0)
        sched.quiesce(now=T0)
        audit = sched._devloop.audit()
        assert audit["consistent"] and audit["staged"] == 0 and audit["inflight"] == 0
        assert audit["seq"] == sched._devloop.ring.slots_taken == 12
        cur = sched._devloop.ring.read_cursors()
        assert cur[CUR_SEQ] == 12 and cur[CUR_EPOCH] == 6 and cur[CUR_TAIL] == 1
        prog = eng.devloop_aot(3, BATCH)
        assert eng.compile_devloop_aot(3, BATCH) is prog and eng.devloop_captures == 1
        assert prog.graph is None and prog.launches == {}  # the CPU runs the plain loop


@pytest.mark.parametrize("fault", [False, True], ids=["rings", "injected-fallback"])
def test_pump_telemetry_matches_reference(fault, tmp_path):
    """The pump's telemetry with a tracer armed: each staged batch laps
    loop_fill, loop_wait, its share of the ring's dispatch and of the
    retire's wait (loop_retire), then device_wait, reply and total through
    the express retire; the ring's shape rides the recorder's metadata. An
    injected `devloop.dispatch` fail cancels the staged records (the
    per-batch path opens its own) and fires express_fallback. The same
    stage counts, flight records, triggers and metadata in both."""
    from bng_tpu.telemetry import recorder as j_rec
    from bng_tpu.telemetry import spans as j_sp
    from bng_tpu_torch.telemetry import recorder as t_rec
    from bng_tpu_torch.telemetry import spans as t_sp

    frames = _burst(BATCH * 3 * 2 + 5)  # two full rings, then a partial flush ring
    got = []
    for (sched, *_rest), m, sp, rec_mod in zip(_storm_pair(), (jf, tf), (j_sp, t_sp),
                                               (j_rec, t_rec)):
        rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(min_dump_interval_s=0.0,
                                                            out_dir=str(tmp_path / sp.__name__)))
        plan = m.FaultPlan(0, [m.FaultSpec("devloop.dispatch", m.FAIL, at_hit=2)] if fault else [])
        with sp.armed(sp.Tracer(recorder=rec)) as tr, m.armed(plan, log=False):
            out = sched.process(frames, now=T0)
            sched.quiesce(now=T0)
        records = [(r["seq"], r["lane"], r["n"], r["shed"], r["punt"]) for r in rec.records()]
        got.append((out, {s: v["count"] for s, v in tr.breakdown().items()}, records,
                    dict(rec.triggers), rec.meta.get("express_program"),
                    rec.meta.get("devloop_ring"), len(tr._free)))
    stages, own = split_stages(got[1][1])
    assert (got[1][0], stages) + got[1][2:] == got[0]
    out, _, records, triggers, program, ring, free = got[1]
    n_batches, fallen = 7, 3 if fault else 0
    # the ring program laps none of the port's own stages; a fallen-back
    # batch's express program laps its dispatch's parts
    assert own == ({s: fallen for s in ("drain", "upload", "issue")} if fault else {})
    assert stages["total"] == len(records) == n_batches and free == t_sp.Tracer.OPEN_SLOTS
    assert stages["loop_fill"] == stages["dispatch"] == stages["device_wait"] == n_batches
    # a fallen-back slot's second record laps its own lane wait, and no ring
    assert stages["lane_wait"] == n_batches + fallen
    assert stages["loop_wait"] == stages["loop_retire"] == n_batches - fallen
    assert triggers == ({"express_fallback": 1} if fault else {})
    assert program == "devloop" and ring["k"] == 3 and ring["slots"] == 1
