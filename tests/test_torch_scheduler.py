"""The port's tiered scheduler against the JAX package's.

- `Lane` and `CompletionRing` give the reference's closes, counters and
  retire order on the same pushes and clock.
- Two serving stacks (fast-path tables, pool, DHCP server as the slow
  path, engine, scheduler), one per package, built by the same host calls
  under a fake clock (the geometry of `tests/test_scheduler.py`), give
  identical completions (tag, lane, verdict, bytes, latency): from the
  `process` facade on a mixed batch, and from a submit/poll DORA whose
  batches close on the deadline, with the renewal answered on the device.
- After flushes with `drain_every=2` and the overlap drain on, both
  engines hold the same table words and report the same counters.
- The bulk lane's DHCP replica: a lease cached mid-run reaches the bulk
  lane at the same dispatch in both stacks (the refresh cadence).
- A geometry miss takes the DHCP-only rung in both, counted the same way,
  and a second `compile_express_aot` on the same key builds nothing new.
- Telemetry and metrics: with a tracer armed and `metrics` set, the same
  stage counts, flight records, triggers (`express_aot_miss` on a
  geometry miss, `express_fallback` when the express program fails to
  build) and bng_sched_* / bng_express_* families in both packages.

Tolerance: bit-exact (the same bytes, counts and table words).
"""

import dataclasses

import jax
import numpy as np
import pytest

from bng_tpu.control.dhcp_server import DHCPServer as JServer
from bng_tpu.control.nat import NATManager as JNAT
from bng_tpu.control.pool import Pool as JPool
from bng_tpu.control.pool import PoolManager as JPools
from bng_tpu.ops import express as j_ex
from bng_tpu.runtime import lanes as j_lanes
from bng_tpu.runtime.engine import AntispoofTables as JSpoof
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu.runtime.engine import QoSTables as JQoS
from bng_tpu.runtime.scheduler import SchedulerConfig as JConfig
from bng_tpu.runtime.scheduler import TieredScheduler as JSched
from bng_tpu.runtime.tables import FastPathTables as JFastPath
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.dhcp_server import DHCPServer as TServer
from bng_tpu_torch.control.nat import NATManager as TNAT
from bng_tpu_torch.control.pool import Pool as TPool
from bng_tpu_torch.control.pool import PoolManager as TPools
from bng_tpu_torch.runtime import lanes as t_lanes
from bng_tpu_torch.runtime.engine import AntispoofTables as TSpoof
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.runtime.engine import QoSTables as TQoS
from bng_tpu_torch.runtime.scheduler import SchedulerConfig as TConfig
from bng_tpu_torch.runtime.scheduler import TieredScheduler as TSched
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPath
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_stages import assert_tuple_equal
from test_torch_telemetry import split_stages

pytestmark = pytest.mark.torch_port

SERVER_MAC = bytes.fromhex("02aabbccdd01")
SERVER_IP = ip_to_u32("10.0.0.1")
T0 = 1_700_000_000.0
JAX = (JFastPath, JPools, JPool, JNAT, JQoS, JSpoof, JServer, JEngine, JSched, JConfig)
PORT = (TFastPath, TPools, TPool, TNAT, TQoS, TSpoof, TServer, TEngine, TSched, TConfig)


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def mac(i: int) -> bytes:
    return (0x02B0 << 32 | i).to_bytes(6, "big")


def dhcp(m, msg_type, xid, **kw) -> bytes:
    p = F.build_request(m, msg_type, xid=xid, **kw)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(m, b"\xff" * 6, kw.get("ciaddr", 0), 0xFFFFFFFF, 68, 67,
                        p.encode().ljust(320, b"\x00"))


def data_frame(i: int) -> bytes:
    m = (0x02C0 << 32 | i).to_bytes(6, "big")
    return F.udp_packet(m, SERVER_MAC, ip_to_u32("10.0.0.9") + i, ip_to_u32("93.184.216.34"),
                        40000 + i, 443, b"x" * 64)


def build_stack(mods, clock, **cfg):
    """Tables, pool, server, engine and scheduler of one package (the
    geometry of tests/test_scheduler.py); cached subscribers 0..3."""
    fp_cls, pools_cls, pool_cls, nat_cls, qos_cls, spoof_cls, srv_cls, eng_cls, sched_cls, cfg_cls = mods
    fp = fp_cls(sub_nbuckets=512, vlan_nbuckets=64, cid_nbuckets=64, max_pools=16)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    pools = pools_cls(fp)
    pools.add_pool(pool_cls(pool_id=1, network=ip_to_u32("10.0.0.0"), prefix_len=24,
                            gateway=SERVER_IP, dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    for i in range(4):
        fp.add_subscriber(mac(i), pool_id=1, ip=ip_to_u32("10.0.0.100") + i,
                          lease_expiry=int(T0) + 3600)
    nat = nat_cls(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=256, sub_nat_nbuckets=64)
    server = srv_cls(SERVER_MAC, SERVER_IP, pools, fastpath_tables=fp, clock=clock)
    kw = {} if eng_cls is JEngine else {"device": "cpu"}
    engine = eng_cls(fp, nat, qos_cls(nbuckets=256), spoof_cls(nbuckets=256), batch_size=8,
                     pkt_slot=512, slow_path=server.handle_frame, clock=clock, **kw)
    cfg = cfg_cls(**{"express_batch": 8, "bulk_batch": 8, "express_device_index": -1, **cfg})
    return sched_cls(engine, cfg, clock=clock), server, fp


def stacks(**cfg):
    clocks = (FakeClock(), FakeClock())
    return [build_stack(mods, c, **cfg) + (c,) for mods, c in zip((JAX, PORT), clocks)]


def engines_equal(j, t):
    jsched, jsrv, jfp, _ = j
    tsched, tsrv, tfp, _ = t
    je, te = jsched.engine, tsched.engine
    for f in ("dhcp", "nat", "qos", "spoof"):
        assert np.array_equal(getattr(te.stats, f), getattr(je.stats, f)), f
    for f in ("batches", "tx", "fwd", "dropped", "passed", "slow_errors"):
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    assert tsched.stats_snapshot() == jsched.stats_snapshot()
    assert dataclasses.asdict(tsrv.stats) == dataclasses.asdict(jsrv.stats)
    assert tsrv.export_leases() == jsrv.export_leases()
    jt = jax.tree_util.tree_map(lambda a: np.array(a), je.tables)
    assert_tuple_equal(convert.tables_to_numpy(te.tables), jt, "engine tables")
    assert tfp.dirty_count() == jfp.dirty_count()


def test_lanes_match_reference():
    out = []
    for mod in (j_lanes, t_lanes):
        clock = FakeClock(100.0)
        lane = mod.Lane(mod.LaneConfig("x", batch=4, max_wait_us=200, depth=2, max_queue=6), clock)
        rec = []
        for i in range(7):
            rec.append(lane.push(b"f%d" % i, bool(i % 2), tag=i))
            clock.advance(60e-6)
        rec.append((lane.close_reason(clock()), len(lane), lane.oldest_age_us(clock())))
        for reason in (None, None, mod.CLOSE_FLUSH):
            pend, why = lane.close_batch(clock(), reason)
            rec.append(([tuple(p[:4]) for p in pend], why))
        lane.push(b"late", True, tag=9)
        clock.advance(250e-6)
        rec.append(lane.close_reason(clock()))
        rec.append(lane.close_batch(clock())[1])
        rec.append((dataclasses.asdict(lane.stats), lane.stats.occupancy_avg()))
        ring = mod.CompletionRing(depth=2)
        entries = [mod.InflightEntry(k, [], float(k), "full") for k in range(5)]
        rec.append([None if (o := ring.push(e)) is None else o.res for e in entries[:4]])
        ring.push(entries[4])
        rec.append([e.res for e in ring.pop_ready(lambda e: e.res < 4)])
        rec.append((len(ring), [e.res for e in ring.drain()], ring.pop_oldest()))
        out.append(rec)
    assert out[1] == out[0]


def test_process_facade_mixed_batch():
    both = stacks()
    newcomer = mac(0x31)
    batches = [
        [dhcp(mac(0), F.DISCOVER, 0x100), dhcp(newcomer, F.DISCOVER, 0x101), data_frame(1),
         dhcp(mac(1), F.REQUEST, 0x102), data_frame(2), dhcp(mac(2), F.DISCOVER, 0x103,
                                                               broadcast=True)],
        [dhcp(newcomer, F.REQUEST, 0x104, requested_ip=ip_to_u32("10.0.0.2"),
              server_id=SERVER_IP), data_frame(1), dhcp(mac(3), F.DISCOVER, 0x105)],
        [dhcp(newcomer, F.REQUEST, 0x106, ciaddr=ip_to_u32("10.0.0.2")), data_frame(1)],
    ]
    fa = [[True] * len(b) for b in batches]
    fa[0][4] = False  # a core-side frame
    outs = []
    for k, frames in enumerate(batches):
        outs.append([s.process(frames, from_access=fa[k], now=T0 + k) for s, *_ in both])
    for jo, to in outs:
        assert to == jo
    engines_equal(*both)
    (o1, _), (o2, _), (o3, _) = [(o[1], None) for o in outs]
    assert [i for i, _ in o1["tx"]] == [0, 3, 5] and 1 in dict(o1["slow"])
    assert dict(o1["slow"])[1] is not None  # the newcomer's OFFER from the slow path
    assert [i for i, _ in o2["tx"]] == [2] and dict(o2["slow"])[0] is not None  # ACK, slow path
    assert [i for i, _ in o3["tx"]] == [0]  # the renewal, answered on the device
    snap = both[1][0].stats_snapshot()
    assert snap["express"]["aot_dispatches"] == 3 and snap["express"]["fallbacks"] == {}


def test_submit_poll_dora_with_deadline_close():
    both = stacks(express_max_wait_us=200.0)
    m = mac(0x41)
    steps = [dhcp(m, F.DISCOVER, 0x200),
             dhcp(m, F.REQUEST, 0x201, requested_ip=ip_to_u32("10.0.0.2"), server_id=SERVER_IP),
             dhcp(m, F.REQUEST, 0x202, ciaddr=ip_to_u32("10.0.0.2"))]
    done = [[], []]
    for k, frame in enumerate(steps):
        for side, (sched, _, _, clock) in enumerate(both):
            assert sched.submit(frame, True, tag=("dora", k)) == "express"
            assert sched.submit(data_frame(k), True, tag=("data", k)) == "bulk"
            assert sched.poll() == 0  # neither batch full nor aged
            clock.advance(150e-6)
            sched.poll()
            clock.advance(100e-6)  # 250 us: the express batch is past its deadline
            sched.poll()
            clock.advance(2e-3)  # past the bulk deadline too
            sched.poll()
            sched.flush()
            done[side].append(sched.drain_completions())
    assert done[1] == done[0]
    engines_equal(*both)
    dora = [[c for c in d if c.tag[0] == "dora"] for d in done[1]]
    assert [(c[0].lane, c[0].verdict) for c in dora] == [("express", "slow"), ("express", "slow"),
                                                         ("express", "tx")]
    ack = F.decode_dhcp(F.decode(dora[2][0].frame).payload)
    assert ack.msg_type == F.ACK and ack.yiaddr == ip_to_u32("10.0.0.2")
    assert both[1][0].express.stats.batches_deadline == 3


def test_drain_cadence_and_overlap_drain_leave_identical_tables():
    both = stacks(drain_every=2, overlap_drain=True)
    for k in range(5):
        frames = [data_frame(k * 3 + j) for j in range(3)] + [dhcp(mac(0x50 + k), F.DISCOVER, k)]
        outs = [s.process(frames, now=T0 + k) for s, *_ in both]
        assert outs[1] == outs[0]
        for sched, srv, fp, _ in both:
            fp.add_subscriber(mac(0x60 + k), 1, ip_to_u32("10.0.0.200") + k, int(T0) + 900)
    engines_equal(*both)
    snap = both[1][0].stats_snapshot()["bulk"]
    assert snap["drains_applied"] >= 3 and snap["drains_prefetched"] >= 2


def test_bulk_replica_refresh_cadence():
    both = stacks(dhcp_refresh_every=3, overlap_drain=False)
    x = mac(0x70)
    verdicts = [[], []]
    for k in range(8):
        if k == 2:  # cache a lease, and let an express dispatch drain it
            for side, (sched, _, fp, _) in enumerate(both):
                fp.add_subscriber(x, 1, ip_to_u32("10.0.0.77"), int(T0) + 900)
                out = sched.process([dhcp(x, F.DISCOVER, 0x300)], now=T0 + k)
                assert [i for i, _ in out["tx"]] == [0]  # the authoritative tables have it
        for side, (sched, _, _, _) in enumerate(both):
            assert sched.submit(dhcp(x, F.DISCOVER, 0x310 + k), True, now=T0 + k,
                                lane="bulk") == "bulk"
            sched.flush(now=T0 + k)
            (c,) = sched.drain_completions()
            verdicts[side].append((c.verdict, c.frame))
    assert verdicts[1] == verdicts[0]
    # bulk dispatches 0..7: the replica refreshes at 0, 3 and 6
    assert [v for v, _ in verdicts[1]] == ["slow"] * 3 + ["tx"] * 5
    engines_equal(*both)


def test_geometry_miss_takes_the_dhcp_only_rung():
    both = stacks()
    traces = j_ex.TRACE_COUNT
    for sched, *_ in both:
        sched.engine.compile_express_aot(8)
    assert j_ex.TRACE_COUNT == traces and both[1][0].engine.express_captures == 1
    frames = [dhcp(mac(0), F.DISCOVER, 0x400), dhcp(mac(0x80), F.DISCOVER, 0x401)]
    for sched, *_ in both:
        sched.express.cfg.batch = 16  # the lane's geometry changed under a live scheduler
    outs = [s.process(frames, now=T0) for s, *_ in both]
    assert outs[1] == outs[0] and [i for i, _ in outs[1]["tx"]] == [0]
    engines_equal(*both)
    snap = both[1][0].stats_snapshot()["express"]
    assert (snap["aot_misses"], snap["jit_dispatches"], snap["fallbacks"]) == (1, 1,
                                                                               {"geometry_miss": 1})


def test_resync_rekeys_the_express_program():
    """A bulk build makes the next express drain re-upload every table: the
    port re-keys its express program (built again over the new tensors) and
    both packages keep serving on the device, with no miss."""
    both = stacks()
    macs = np.arange(100, dtype=np.uint64) + np.uint64(0x02D000000000)  # more than the stash
    for sched, _, fp, _ in both:
        fp.add_subscribers_bulk(macs, pool_ids=1, ips=ip_to_u32("10.0.0.150") + np.arange(100),
                                lease_expiries=int(T0) + 900)
    first = (0x02D000000000).to_bytes(6, "big")
    outs = [s.process([dhcp(first, F.DISCOVER, 0x500), dhcp(mac(1), F.DISCOVER, 0x501)], now=T0)
            for s, *_ in both]
    assert outs[1] == outs[0] and [i for i, _ in outs[1]["tx"]] == [0, 1]
    engines_equal(*both)
    eng = both[1][0].engine
    assert eng.resync_count == both[0][0].engine.resync_count == 1
    assert eng.express_captures == 2 and list(eng._express_programs) == [eng._express_aot_key(8)]


def test_quiesce_and_adopt_engine():
    """`quiesce` ships and retires everything; `adopt_engine` retires the old
    engine's work, then serves from the new engine (its own express
    program, a fresh bulk replica) in both packages alike."""
    both = stacks()
    frames = [dhcp(mac(0), F.DISCOVER, 0x600), data_frame(4), dhcp(mac(0x90), F.DISCOVER, 0x601)]
    got = []
    for mods, (sched, server, fp, clock) in zip((JAX, PORT), both):
        for f in frames:
            sched.submit(f, True, now=T0)
        quiesced = sched.quiesce(now=T0)
        old = sched.engine
        kw = {} if mods is JAX else {"device": "cpu"}
        standby = mods[7](fp, old.nat, old.qos, old.antispoof, batch_size=8, pkt_slot=512,
                          slow_path=server.handle_frame, clock=clock, **kw)
        sched.submit(dhcp(mac(1), F.DISCOVER, 0x602), True, now=T0)  # in flight at the flip
        flipped = sched.adopt_engine(standby)
        before = sched.drain_completions()
        got.append((quiesced, flipped, before, sched.process(frames, now=T0 + 1)))
    assert got[1] == got[0]
    assert got[1][:2] == (3, 1) and [i for i, _ in got[1][3]["tx"]] == [0]
    engines_equal(*both)
    assert both[1][0].engine.express_captures == 1


def test_scheduler_config_matches_reference():
    """The same knobs with the same defaults, the devloop's included."""
    fields = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert dict(fields)["express_loop"] == "aot" and dict(fields)["devloop_k"] == 8


# ---- telemetry and metrics: the spans, triggers and bng_sched_* families ----


def observed_state(sched, tr, met) -> tuple:
    """What the scheduler's hooks recorded: the stage sample counts, the
    flight records (without times), the recorder's triggers and serving
    program, and the bng_sched_* / bng_express_* samples (each histogram
    by its `_count`)."""
    met.collect_scheduler(sched)
    samples = {}
    for line in met.expose().splitlines():
        name = line.split("{")[0].split(" ")[0]
        if name.startswith(("bng_sched_", "bng_express_")) and \
                not name.endswith(("_bucket", "_sum")):
            key, val = line.rsplit(" ", 1)
            samples[key] = val
    records = [(r["seq"], r["lane"], r["n"], r["shed"], r["punt"]) for r in tr.recorder.records()]
    return ({s: v["count"] for s, v in tr.breakdown().items()}, records,
            dict(tr.recorder.triggers), tr.recorder.meta.get("express_program"), samples)


def traced(sp_mod, rec_mod, tmp):
    rec = rec_mod.FlightRecorder(rec_mod.RecorderConfig(min_dump_interval_s=0.0, out_dir=tmp))
    return sp_mod.armed(sp_mod.Tracer(recorder=rec))


@pytest.mark.parametrize("geometry_miss", [False, True], ids=["express", "geometry-miss"])
def test_traced_serving_and_metrics_match_reference(geometry_miss, tmp_path):
    """The submit/poll DORA with data frames, a tracer armed and `metrics`
    set: the same stage counts (lane_wait, dispatch, device_wait, reply,
    slow_path, total), flight records and bng_sched_* / bng_express_*
    families in both packages; a geometry miss fires the express_aot_miss
    trigger and serves through the DHCP-only program in both."""
    from bng_tpu.control.metrics import BNGMetrics as JMetrics
    from bng_tpu.telemetry import recorder as j_rec
    from bng_tpu.telemetry import spans as j_sp
    from bng_tpu_torch.control.metrics import BNGMetrics as TMetrics
    from bng_tpu_torch.telemetry import recorder as t_rec
    from bng_tpu_torch.telemetry import spans as t_sp

    both = stacks(express_max_wait_us=200.0)
    got = []
    for (sched, _, _, clock), sp, rec_mod, met in zip(both, (j_sp, t_sp), (j_rec, t_rec),
                                                      (JMetrics(), TMetrics())):
        sched.metrics = met
        if geometry_miss:
            sched.express.cfg.batch = 16
        with traced(sp, rec_mod, str(tmp_path / sp.__name__)) as tr:
            m = mac(0x41)
            for k, frame in enumerate([dhcp(m, F.DISCOVER, 0x200), dhcp(mac(1), F.DISCOVER, 0x201),
                                       dhcp(m, F.REQUEST, 0x202, requested_ip=ip_to_u32("10.0.0.2"),
                                            server_id=SERVER_IP)]):
                sched.submit(frame, True, tag=("dhcp", k))
                for j in range(3):
                    sched.submit(data_frame(3 * k + j), True, tag=("data", k, j))
                clock.advance(250e-6)
                sched.poll()
                clock.advance(2e-3)
                sched.poll()
            sched.flush()
            sched.drain_completions()
        got.append(observed_state(sched, tr, met))
    stages, own = split_stages(got[1][0])
    assert (stages,) + got[1][1:] == got[0]
    _, records, triggers, program, samples = got[1]
    # the port's own stages: the express program's dispatch parts (a
    # geometry miss: the DHCP-only program's, and its parse, dhcp and
    # verdict) and each bulk step's fused-step stages
    n_ex, n_bulk = (sum(r[1] == lane for r in records) for lane in ("express", "bulk"))
    want = {s: n_ex for s in ("drain", "upload", "issue")}
    want.update({s: n_bulk for s in ("antispoof", "nat44", "qos", "nat_accounting")})
    want.update({s: n_bulk + (n_ex if geometry_miss else 0) for s in ("parse", "dhcp", "verdict")})
    assert own == want
    assert {"lane_wait", "dispatch", "device_wait", "reply", "slow_path", "total"} <= set(stages)
    assert {r[1] for r in records} == {"express", "bulk"} and stages["total"] == len(records)
    assert samples['bng_sched_frames_total{lane="express"}'] == "3"
    assert samples['bng_sched_dispatch_latency_seconds_count{lane="bulk"}'] == "3"
    if geometry_miss:
        assert triggers == {"express_aot_miss": 3} and program == "jit-full"
        assert samples["bng_express_aot_miss_total"] == "3"
    else:
        assert triggers == {} and program == "aot-express"


def test_express_fallback_fires_its_trigger(tmp_path, monkeypatch):
    """An express program that fails to build serves through the DHCP-only
    program, counted `compile_failed` and flight-recorded, in both."""
    from bng_tpu.telemetry import recorder as j_rec
    from bng_tpu.telemetry import spans as j_sp
    from bng_tpu_torch.telemetry import recorder as t_rec
    from bng_tpu_torch.telemetry import spans as t_sp

    def refuse(self, *a, **kw):
        raise RuntimeError("refused")

    monkeypatch.setattr(JEngine, "compile_express_aot", refuse)
    monkeypatch.setattr(TEngine, "compile_express_aot", refuse)
    got = []
    for mods, sp, rec_mod in ((JAX, j_sp, j_rec), (PORT, t_sp, t_rec)):
        with traced(sp, rec_mod, str(tmp_path / sp.__name__)) as tr:
            sched, *_ = build_stack(mods, FakeClock())
            out = sched.process([dhcp(mac(0), F.DISCOVER, 0x700)], now=T0)
        got.append((out, dict(tr.recorder.triggers), sched.stats_snapshot()["express"]["fallbacks"],
                    tr.recorder.meta.get("express_program")))
    assert got[1] == got[0]
    assert got[1][1:] == ({"express_fallback": 1, "express_aot_miss": 1},
                          {"compile_failed": 1, "geometry_miss": 1}, "jit-full")
