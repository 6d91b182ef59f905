"""The port's AF_XDP wire (`runtime/xsk.py`, `runtime/xdp_redirect.py`,
`csrc/bngxsk.cpp`, `loadtest.WireLoopTarget`, `collect_wire`, `run
--wire-if`, `loadtest --wire`) against the JAX package's.

- the attach ladder's unprivileged cases (tests/test_xsk.py);
- the pump's edge-case corpus (tests/test_wire_pump.py): the port's
  vector pump equals its scalar pump and the reference's trace, step for
  step; the frame-accounting cases on both packages;
- the four serving scenarios (DORA, the NAT punt then SNAT, QoS drops,
  PPPoE decap + SNAT) through SimKernelRings -> WirePump -> NativeRing ->
  `Engine.process_ring_pipelined` -> pump -> far end: the port's far-end
  bytes equal the reference's, under both pumps;
- `collect_wire`'s exposition, `WireLoopTarget`'s xid matching, `loadtest
  --wire`'s counts under one fake clock, and `run --wire-if nosuchif` on
  both packages (the memory rung, the fallback dump, the wire lines of
  `/metrics`).

Tolerance: exact (bytes, counts, exposition lines).
"""

import dataclasses
import ipaddress
from types import SimpleNamespace

import numpy as np
import pytest

from bng_tpu import loadtest as j_lt
from bng_tpu.chaos import faults as j_faults
from bng_tpu.control import dhcp_codec as j_codec
from bng_tpu.control import packets as j_packets
from bng_tpu.control.metrics import BNGMetrics as JMetrics
from bng_tpu.runtime import ring as j_ring
from bng_tpu.runtime import xsk as j_xsk
from bng_tpu_torch import frames as t_packets
from bng_tpu_torch import loadtest as t_lt
from bng_tpu_torch.chaos import faults as t_faults
from bng_tpu_torch.control import dhcp_codec as t_codec
from bng_tpu_torch.control.metrics import BNGMetrics as TMetrics
from bng_tpu_torch.runtime import ring as t_ring
from bng_tpu_torch.runtime import xsk as t_xsk
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(name="bng_tpu", xsk=j_xsk, ring=j_ring, packets=j_packets, codec=j_codec,
                      faults=j_faults, lt=j_lt, Metrics=JMetrics, kw={})
PORT = SimpleNamespace(name="bng_tpu_torch", xsk=t_xsk, ring=t_ring, packets=t_packets,
                       codec=t_codec, faults=t_faults, lt=t_lt, Metrics=TMetrics,
                       kw={"device": "cpu"})
BOTH = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]

SERVER_MAC = bytes.fromhex("02aabbccdd01")
SERVER_IP = ip_to_u32("10.0.0.1")
T0 = 1_753_000_000


# ---------------------------------------------------------------------------
# the attach ladder (unprivileged cases)
# ---------------------------------------------------------------------------

def test_the_native_xsk_library_builds_into_the_build_dir():
    from bng_tpu_torch.runtime import nativelib

    assert t_xsk.load_native() is not None
    assert nativelib.lib_path("bngxsk").exists()
    assert t_xsk.probe() in (t_xsk.MODE_COPY, t_xsk.MODE_MEMORY)
    assert t_xsk.probe() == j_xsk.probe()


def test_no_interface_is_the_memory_rung():
    att = t_xsk.open_wire(t_ring.PyRing(nframes=64, frame_size=256, depth=32), ifname="")
    assert (att.mode, att.xsk, att.detail) == (t_xsk.MODE_MEMORY, None, "no interface requested")


@pytest.mark.parametrize("m", BOTH)
def test_nonexistent_interface_falls_back_with_the_same_detail(m):
    ring = m.ring.NativeRing(nframes=64, frame_size=2048, depth=32)
    try:
        att = m.xsk.open_wire(ring, ifname="bng-does-not-exist0")
        assert att.mode == m.xsk.MODE_MEMORY and att.xsk is None
        assert att.detail == ("AF_XDP open on 'bng-does-not-exist0' failed: "
                              "interface not found")
    finally:
        ring.close()


def test_pyring_has_no_umem_rung():
    att = t_xsk.open_wire(t_ring.PyRing(nframes=64, frame_size=256, depth=32), ifname="lo")
    assert att.mode == t_xsk.MODE_MEMORY and "UMEM" in att.detail


def test_real_interface_ladder_never_crashes():
    """On 'lo': a rung binds (a privileged kernel) or the ladder lands on
    memory with a diagnostic; both conform."""
    ring = t_ring.NativeRing(nframes=64, frame_size=2048, depth=32)
    att = t_xsk.open_wire(ring, ifname="lo")
    assert att.mode in (t_xsk.MODE_ZEROCOPY, t_xsk.MODE_COPY, t_xsk.MODE_MEMORY)
    if att.xsk is not None:
        assert att.xsk.fd >= 0
        att.xsk.close()
    ring.close()


def test_memory_rung_ring_still_serves():
    ring = t_ring.PyRing(nframes=64, frame_size=256, depth=32)
    assert t_xsk.open_wire(ring, ifname="").mode == t_xsk.MODE_MEMORY
    ring.rx_push(b"\x02" * 60)
    out = np.zeros((4, 256), dtype=np.uint8)
    ln = np.zeros((4,), dtype=np.uint32)
    fl = np.zeros((4,), dtype=np.uint32)
    assert ring.assemble(out, ln, fl) == 1


def test_selector_validates_and_the_label_never_raises(monkeypatch):
    monkeypatch.setattr(t_xsk, "WIRE_PUMP", "bogus")
    with pytest.raises(ValueError, match="BNG_WIRE_PUMP"):
        t_xsk.resolved_wire_pump()
    assert t_xsk.current_wire_pump_label() == "bogus"
    ring = t_ring.NativeRing(nframes=16, frame_size=256, depth=8)
    with pytest.raises(ValueError, match="unknown wire pump"):
        t_xsk.WirePump(ring, t_xsk.SimKernelRings(ring, ring_size=8), path="turbo")
    ring.close()


def test_xdp_redirect_program_is_the_references():
    from bng_tpu.runtime import xdp_redirect as j_xdp
    from bng_tpu_torch.runtime import xdp_redirect as t_xdp

    consts = [k for k in vars(j_xdp) if k.isupper()]
    assert consts and all(getattr(t_xdp, k) == getattr(j_xdp, k) for k in consts)
    for insn in ((0x61, 2, 1, 16, 0), (0x18, 1, 1, 0, 9), (0xB7, 3, 0, 0, 2), (0x95, 0, 0, 0, 0)):
        assert t_xdp._insn(*insn) == j_xdp._insn(*insn)
    assert t_xdp.probe() == j_xdp.probe()
    with pytest.raises(OSError):
        t_xdp.XdpRedirect("bng-does-not-exist0", {})


# ---------------------------------------------------------------------------
# the pump's corpus (tests/test_wire_pump.py), on both packages
# ---------------------------------------------------------------------------

def _discover(m, i):
    mac = (0x02C0FFEE0000 + i).to_bytes(6, "big")
    p = m.codec.build_request(mac, m.codec.DISCOVER, xid=0x1000 + i)
    return m.packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                                p.encode().ljust(300, b"\x00"))


def _data(m, i, size=96):
    return m.packets.udp_packet(b"\x02" * 6, b"\x04" * 6, 0x0A000000 + i, 0x08080808,
                                1024 + i, 443, bytes([i % 256]) * size)


def _mixed(m, n, seed=0):
    return [(_discover(m, seed + i) if i % 3 == 0 else _data(m, seed + i)) for i in range(n)]


def _mk(m, path, *, nframes=64, frame_size=512, depth=32, headroom=128, ring_size=32,
        tx_room=None, tx_pending_cap=4096):
    ring = m.ring.NativeRing(nframes=nframes, frame_size=frame_size, depth=depth)
    kern = m.xsk.SimKernelRings(ring, headroom=headroom, ring_size=ring_size, tx_room=tx_room)
    return ring, kern, m.xsk.WirePump(ring, kern, path=path, tx_pending_cap=tx_pending_cap)


def _reflect(ring, budget=32, slot=512, pattern=(2,)):
    """Assemble, stamp verdicts from `pattern` by lane (2 TX, 3 FWD, 1
    DROP, 0 PASS), complete; the assembled rows in order."""
    out = np.zeros((budget, slot), dtype=np.uint8)
    ln = np.zeros(budget, dtype=np.uint32)
    fl = np.zeros(budget, dtype=np.uint32)
    n = ring.assemble(out, ln, fl)
    rows = []
    if n:
        verdict = np.array([pattern[i % len(pattern)] for i in range(n)], dtype=np.uint8)
        ring.complete(verdict, out[:n], ln[:n], n)
        rows = [(bytes(out[i, :ln[i]]), int(fl[i]), int(verdict[i])) for i in range(n)]
        while ring.slow_pop() is not None:
            pass
    return rows


def _round(n=8, budget=16, pattern=(2, 3, 1), seed=0):
    return [("inject", n, seed), ("pump", budget), ("deliver",), ("pump", budget),
            ("reflect", pattern), ("pump", budget), ("drain",)]


CORPUS = {
    "steady_state": ({}, _round(8, seed=0) + _round(8, seed=8) + _round(8, seed=16)),
    "partial_fill": ({}, _round(3, seed=0) + _round(1, seed=3) + _round(0, seed=4)),
    "full_fill_ring": ({"ring_size": 8, "nframes": 64},
                       _round(6, budget=32, seed=0) + _round(6, budget=32, seed=6)),
    "tx_stall_retry": ({"tx_room": 3}, _round(6, pattern=(2,), seed=0)
                       + _round(6, pattern=(2,), seed=6) + _round(0, pattern=(2,), seed=12)),
    "headroom_zero": ({"headroom": 0}, _round(8, seed=0) + _round(8, seed=8)),
    "headroom_deep": ({"headroom": 256}, _round(6, seed=0) + _round(6, seed=6)),
    "forged_rx_len": ({}, [("inject", 2, 0), ("inject_claim", b"z" * 64, 500),
                           ("inject_claim", b"y" * 64, 384), ("inject_claim", b"x" * 64, 385),
                           ("pump", 16), ("deliver",), ("pump", 16), ("reflect", (2,)),
                           ("pump", 16), ("drain",)]),
    "rx_ring_full": ({"depth": 8, "ring_size": 32},
                     [("inject", 14, 0), ("pump", 16), ("deliver",), ("pump", 16),
                      ("reflect", (2,)), ("pump", 16), ("drain",)] + _round(4, seed=20)),
}


def _run(m, path, cfg, script):
    ring, kern, pump = _mk(m, path, **cfg)
    trace = []
    for op in script:
        kind = op[0]
        if kind == "inject":
            kern.inject_many(_mixed(m, op[1], seed=op[2]))
        elif kind == "inject_claim":
            kern.inject(op[1], claim_len=op[2])
        elif kind == "pump":
            trace.append(("moved", pump.pump(budget=op[1])))
        elif kind == "deliver":
            kern.deliver()
        elif kind == "reflect":
            trace.append(("rows", _reflect(ring, pattern=op[1])))
        else:
            trace.append(("egress", kern.drain_egress()))
    trace += [("stats", dict(pump.pump_stats)), ("ring", ring.stats()),
              ("free", ring.free_frames()), ("pending", pump.tx_pending())]
    last = pump.last_path
    ring.close()
    return trace, last


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_vector_equals_scalar_equals_reference(name):
    cfg, script = CORPUS[name]
    ref, _ = _run(JAX, "scalar", cfg, script)
    scalar, last_s = _run(PORT, "scalar", cfg, script)
    vector, last_v = _run(PORT, "vector", cfg, script)
    assert (last_s, last_v) == ("scalar", "vector")
    assert scalar == ref
    assert vector == ref


def test_corpus_hits_its_edges():
    stats = dict(_run(PORT, "vector", *CORPUS["forged_rx_len"])[0])["stats"]
    assert stats["rx_submit_fail"] == 2  # 500 and 385, not 384
    assert dict(_run(PORT, "vector", *CORPUS["rx_ring_full"])[0])["ring"]["rx_full"] >= 1
    assert dict(_run(PORT, "vector", *CORPUS["tx_stall_retry"])[0])["stats"]["tx"] == 12
    assert dict(_run(PORT, "vector", *CORPUS["full_fill_ring"])[0])["free"] > 0


def _forged_len_storm(m, path):
    """A dropped RX frame returns to the fill pool: 50 forged lengths on a
    16-frame pool, then a good frame still goes through end to end."""
    ring, kern, pump = _mk(m, path, nframes=16, ring_size=16)
    for _ in range(50):
        kern.inject(b"q" * 64, claim_len=500)
        pump.pump(budget=8)
        kern.deliver()
    fails = pump.pump_stats["rx_submit_fail"]
    good = _data(m, 7)
    kern.inject(good)
    pump.pump(budget=8)
    kern.deliver()
    pump.pump(budget=8)
    rows = [r[0] for r in _reflect(ring)]
    pump.pump(budget=8)
    out = (fails, rows == [good], kern.drain_egress() == [good], dict(pump.pump_stats))
    ring.close()
    return out


def _garbage_rx_addr(m, path):
    """An RX descriptor past the UMEM's end is dropped without touching
    memory or recycling a frame that was never ours."""
    ring, kern, pump = _mk(m, path)
    bad, badl = np.zeros(1, np.uint64), np.zeros(1, np.uint32)
    bad[0], badl[0] = ring.umem_size + 4096, 64
    kern._rx_a.push(bad, 1)
    kern._rx_l.push(badl, 1)
    free_before = ring.free_frames()
    pump.pump(budget=8)
    out = [pump.pump_stats["rx_submit_fail"], ring.stats()["bad_desc"],
           ring.free_frames() == free_before - pump.pump_stats["filled"]]
    good = _data(m, 9)
    kern.inject(good)
    pump.pump(budget=8)
    kern.deliver()
    pump.pump(budget=8)
    out.append([r[0] for r in _reflect(ring)] == [good])
    ring.close()
    return out


def _tx_pending_bound(m, path):
    """A stalled kernel TX ring drops (counts and recycles) beyond the cap;
    un-stalled, the 4 retained oldest descriptors go out, then serving
    continues."""
    ring, kern, pump = _mk(m, path, tx_room=0, tx_pending_cap=4)
    sent, pend = [], []
    for rnd in range(3):
        frames = [_data(m, rnd * 8 + i) for i in range(8)]
        sent.append(frames)
        kern.inject_many(frames)
        pump.pump(budget=16)
        kern.deliver()
        pump.pump(budget=16)
        _reflect(ring, pattern=(2,))
        pump.pump(budget=16)
        pend.append(pump.tx_pending())
    out = [pend, pump.pump_stats["tx_overflow"], pump.pump_stats["tx"]]
    kern.tx_room = None
    pump.pump(budget=16)
    out += [kern.drain_egress() == sent[0][:4], pump.tx_pending()]
    good = _data(m, 99)
    kern.inject(good)
    pump.pump(budget=16)
    kern.deliver()
    pump.pump(budget=16)
    _reflect(ring, pattern=(2,))
    pump.pump(budget=16)
    out.append(kern.drain_egress() == [good])
    ring.close()
    return out


@pytest.mark.parametrize("path", ["scalar", "vector"])
@pytest.mark.parametrize("case", [_forged_len_storm, _garbage_rx_addr, _tx_pending_bound],
                         ids=["forged_len_storm", "garbage_rx_addr", "tx_pending_bound"])
def test_frame_accounting_equals_reference(case, path):
    got = case(PORT, path)
    assert got == case(JAX, path)
    if case is _forged_len_storm:
        assert got[:3] == (50, True, True)
    elif case is _garbage_rx_addr:
        assert got == [1, 1, True, True]
    else:
        assert got == [[4, 4, 4], 3 * 8 - 4, 0, True, 0, True]


@pytest.mark.parametrize("m", BOTH)
def test_chaos_armed_rounds_take_the_scalar_path(m):
    ring, kern, pump = _mk(m, "vector")
    kern.inject_many(_mixed(m, 4))
    seen = [pump.pump(budget=8) >= 0 and pump.last_path]
    with m.faults.armed(m.faults.FaultPlan(seed=1), log=False):
        pump.pump(budget=8)
        seen.append(pump.last_path)
    pump.pump(budget=8)
    seen += [pump.last_path, pump.path]
    ring.close()
    assert seen == ["vector", "scalar", "vector", "vector"]


def test_pump_laps_the_wire_stages():
    from bng_tpu_torch.telemetry import FlightRecorder, RecorderConfig
    from bng_tpu_torch.telemetry import spans as tele

    ring, kern, pump = _mk(PORT, "vector")
    tr = tele.Tracer(recorder=FlightRecorder(RecorderConfig()))
    tele.arm(tr)
    try:
        kern.inject_many(_mixed(PORT, 4))
        pump.pump(budget=8)
        kern.deliver()
        pump.pump(budget=8)
    finally:
        tele.disarm()
    bd = tr.breakdown()
    assert bd["wire_rx"]["count"] == 2 and bd["wire_tx"]["count"] == 2
    ring.close()


def test_collect_wire_exposition_equals_reference():
    texts = []
    for m in (JAX, PORT):
        ring, kern, pump = _mk(m, "vector")
        kern.inject_many(_mixed(m, 4))
        pump.pump(budget=8)
        kern.deliver()
        pump.pump(budget=8)
        met = m.Metrics()
        met.collect_wire(m.xsk.WireAttachment(m.xsk.MODE_MEMORY, None, "no iface"), pump=pump)
        met.collect_wire(None)  # the wire never asked for: no change
        texts.append(met.registry.expose())
        ring.close()
    assert texts[1] == texts[0]
    assert 'bng_wire_rung{mode="memory"} 1' in texts[1]
    assert 'bng_wire_pump_path{path="vector"} 1' in texts[1]
    assert 'bng_wire_frames_total{dir="rx"} 4' in texts[1]


def test_wire_loop_target_matches_replies_by_xid():
    mac = bytes.fromhex("02c0ffee0030")
    p = t_codec.build_request(mac, t_codec.DISCOVER, xid=0xABCD1234)
    req = t_packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                               p.encode().ljust(320, b"\x00"))
    W, JW = t_lt.WireLoopTarget, j_lt.WireLoopTarget
    tagged = req[:12] + b"\x81\x00\x00\x64" + req[12:]
    qinq = req[:12] + b"\x88\xa8\x00\x0a\x81\x00\x00\x64" + req[12:]
    for f, reply in ((req, False), (req, True), (tagged, False), (qinq, False),
                     (b"\x00" * 13, False), (_data(PORT, 0), False)):
        assert W._xid(f, reply=reply) == JW._xid(f, reply=reply)
    assert W._xid(req, reply=False) == W._xid(qinq, reply=False) == 0xABCD1234
    assert W._xid(req, reply=True) is None


# ---------------------------------------------------------------------------
# the four serving scenarios through the full wire loop (memory rung)
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=T0):
        self.t = float(t)

    def __call__(self):
        return self.t


class _Sess:
    session_id = 0x0042
    client_mac = bytes.fromhex("02c0ffee0101")
    assigned_ip = ip_to_u32("10.0.0.50")


def _serving_stack(pkg: str, kw: dict):
    """DHCP + NAT + QoS + PPPoE behind one Engine (tests/test_wire_pump.py's
    stack)."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    Server = mod("control.dhcp_server").DHCPServer
    NAT = mod("control.nat").NATManager
    Pool, Pools = mod("control.pool").Pool, mod("control.pool").PoolManager
    eng_mod, tables = mod("runtime.engine"), mod("runtime.tables")
    clock = _Clock()
    fastpath = tables.FastPathTables(sub_nbuckets=512, vlan_nbuckets=64, cid_nbuckets=64,
                                     max_pools=16)
    fastpath.set_server_config(SERVER_MAC, SERVER_IP)
    pools = Pools(fastpath)
    pools.add_pool(Pool(pool_id=1, network=ip_to_u32("10.0.0.0"), prefix_len=24,
                        gateway=SERVER_IP, dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    nat = NAT(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=256, sub_nat_nbuckets=64)
    qos = eng_mod.QoSTables(nbuckets=256)
    pp = tables.PPPoEFastPathTables(nbuckets=64, stash=8, server_mac=SERVER_MAC)
    server = Server(SERVER_MAC, SERVER_IP, pools, fastpath_tables=fastpath, clock=clock)
    engine = eng_mod.Engine(fastpath, nat, qos, pppoe=pp, batch_size=8,
                            slow_path=server.handle_frame, clock=clock, **kw)
    pp.session_up(_Sess())
    nat.allocate_nat(_Sess.assigned_ip, T0)
    nat.allocate_nat(ip_to_u32("10.0.0.55"), T0)
    nat.allocate_nat(ip_to_u32("10.0.0.60"), T0)
    qos.set_subscriber(ip_to_u32("10.0.0.60"), down_bps=8000, up_bps=8000,
                       up_burst=1500, down_burst=1500)
    return engine


def _pppoe_data():
    from bng_tpu_torch.control.pppoe import codec
    from bng_tpu_torch.ops.pppoe import PPP_IPV4

    inner = t_packets.udp_packet(_Sess.client_mac, SERVER_MAC, _Sess.assigned_ip,
                                 ip_to_u32("8.8.8.8"), 40000, 53, b"q" * 32)[14:]
    pppoe = codec.PPPoEPacket(code=0, session_id=_Sess.session_id,
                              payload=codec.ppp_frame(PPP_IPV4, inner)).encode()
    return codec.eth_frame(SERVER_MAC, _Sess.client_mac, codec.ETH_PPPOE_SESSION, pppoe)


def _dhcp(mac, msg_type, xid, **kw):
    p = t_codec.build_request(mac, msg_type, xid=xid, **kw)
    p.options.append((t_codec.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return t_packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                                p.encode().ljust(320, b"\x00"))


def drive_wire_scenarios(engine, ring, kern, pump):
    """The four scenarios through the full wire loop; {scenario: [far-end
    egress frames]} and the engine's tx/dropped counters after each."""

    def roundtrip(frames, rounds=6):
        kern.inject_many(frames)
        got = []
        for _ in range(rounds):
            pump.pump(budget=16)
            kern.deliver()
            engine.process_ring_pipelined(ring)
            engine.flush_pipeline(ring)
            pump.pump(budget=16)
            got.extend(kern.drain_egress())
        return got

    out = {}
    mac = bytes.fromhex("02c0ffee0001")
    offers = roundtrip([_dhcp(mac, t_codec.DISCOVER, xid=0x11)])
    offer = t_codec.decode(t_packets.decode(offers[0]).payload)
    acks = roundtrip([_dhcp(mac, t_codec.REQUEST, xid=0x12, requested_ip=offer.yiaddr,
                            server_id=SERVER_IP)])
    tx_before = int(engine.stats.tx)
    offers2 = roundtrip([_dhcp(mac, t_codec.DISCOVER, xid=0x13)])
    out["dora"] = (offers + acks + offers2, int(engine.stats.tx) - tx_before)
    f = t_packets.udp_packet(bytes.fromhex("02c0ffee0010"), SERVER_MAC, ip_to_u32("10.0.0.55"),
                             ip_to_u32("93.184.216.34"), 40000, 443, b"nat-payload")
    out["nat"] = (roundtrip([f]), roundtrip([f]))
    qf = t_packets.udp_packet(bytes.fromhex("02c0ffee0020"), SERVER_MAC, ip_to_u32("10.0.0.60"),
                              ip_to_u32("8.8.8.8"), 1111, 9999, b"x" * 400)
    punt = roundtrip([qf])
    dropped_before = int(engine.stats.dropped)
    out["qos"] = (punt, roundtrip([qf] * 4), int(engine.stats.dropped) - dropped_before)
    up = _pppoe_data()
    out["pppoe"] = (roundtrip([up]), roundtrip([up]))
    return out


def _scenarios(m, path):
    engine = _serving_stack(m.name, m.kw)
    ring = m.ring.NativeRing(nframes=256, frame_size=2048, depth=64)
    kern = m.xsk.SimKernelRings(ring, headroom=256, ring_size=128)
    pump = m.xsk.WirePump(ring, kern, path=path)
    try:
        out = drive_wire_scenarios(engine, ring, kern, pump)
        st = dict(pump.pump_stats)
        return out, (pump.last_path, st["rx_submit_fail"], st["tx_overflow"])
    finally:
        ring.close()


@pytest.fixture(scope="module")
def reference_scenarios():
    return _scenarios(JAX, "vector")[0]


@pytest.mark.parametrize("path", ["scalar", "vector"])
def test_four_scenarios_far_end_bytes_equal_reference(path, reference_scenarios):
    got, (last, fails, overflow) = _scenarios(PORT, path)
    assert got == reference_scenarios
    assert (last, fails, overflow) == (path, 0, 0)
    dora, on_device = got["dora"]
    assert len(dora) == 3 and on_device == 1  # the second OFFER came from the device
    punted, natted = got["nat"]
    assert punted == [] and len(natted) == 1
    assert t_packets.decode(natted[0]).src_ip == ip_to_u32("203.0.113.1")
    punt, shaped, dropped = got["qos"]
    assert punt == [] and dropped >= 1 and len(shaped) == 4 - dropped
    punt, fwd = got["pppoe"]
    assert punt == [] and len(fwd) == 1 and t_packets.decode(fwd[0]).ethertype == 0x0800


# ---------------------------------------------------------------------------
# loadtest --wire and run --wire-if
# ---------------------------------------------------------------------------

class FakeClock:
    """Each read advances 1 ms; sleep advances by what it is asked."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.001
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _wire_bench(pkg: str, kw: dict, lt, xsk_mod, ring_mod, path: str):
    """`loadtest --wire`'s memory-rung stack at 64 MACs, batch 16, driven
    by `DHCPBenchmark` under one fake clock (the target's too)."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    net = ipaddress.ip_network("10.0.0.0/24")
    fp = mod("runtime.tables").FastPathTables(sub_nbuckets=1 << 10, vlan_nbuckets=64,
                                              cid_nbuckets=64, max_pools=16, stash=64,
                                              update_slots=256)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    pools = mod("control.pool").PoolManager(fp)
    pools.add_pool(mod("control.pool").Pool(pool_id=1, network=int(net.network_address),
                                            prefix_len=24, gateway=SERVER_IP,
                                            dns_primary=ip_to_u32("1.1.1.1"), lease_time=86400))
    nat = mod("control.nat").NATManager(public_ips=[ip_to_u32("203.0.113.1")],
                                        sessions_nbuckets=256, sub_nat_nbuckets=64)
    server = mod("control.dhcp_server").DHCPServer(SERVER_MAC, SERVER_IP, pools,
                                                   fastpath_tables=fp)
    engine = mod("runtime.engine").Engine(fp, nat, batch_size=16,
                                          slow_path=server.handle_frame, **kw)
    ring = ring_mod.NativeRing(nframes=4096, frame_size=2048, depth=1024)
    kern = xsk_mod.SimKernelRings(ring, headroom=256, ring_size=1024)
    pump = xsk_mod.WirePump(ring, kern, path=path)
    clk = FakeClock()
    target = lt.WireLoopTarget(engine, ring, pump, kern.inject_many, kern.drain_egress,
                               tick=kern.deliver, clock=clk)
    cfg = lt.BenchmarkConfig(batch_size=16, duration_s=0.3, warmup_s=0.2, unique_macs=64,
                             renewal_ratio=0.5)
    b = lt.DHCPBenchmark(target, cfg, clock=clk, sleep=clk.sleep)
    try:
        res = dataclasses.asdict(b.run())
    finally:
        ring.close()
    times = {k for k in res if k.endswith(("_us", "_s")) or k in ("rps", "est_fastpath_hits",
                                                                   "est_cache_hit_rate")}
    return ({k: v for k, v in res.items() if k not in times}, dict(b._leased),
            dict(pump.pump_stats), target.unmatched)


@pytest.mark.parametrize("path", ["scalar", "vector"])
def test_loadtest_wire_counts_equal_reference_under_one_fake_clock(path):
    ref = _wire_bench("bng_tpu", {}, j_lt, j_xsk, j_ring, path)
    got = _wire_bench("bng_tpu_torch", {"device": "cpu"}, t_lt, t_xsk, t_ring, path)
    assert got == ref
    res, leased, stats, unmatched = got
    assert len(leased) == 64 and res["errors"] == 0 and res["responses"] == res["requests"]
    assert res["fastpath_hits"] > 0 and stats["rx"] == stats["tx"] > 0 and unmatched == 0


def test_cli_loadtest_wire_on_cpu(capsys):
    import json

    from bng_tpu_torch import cli

    rc = cli.main(["--device", "cpu", "loadtest", "--duration", "0.3", "--warmup", "0.2",
                   "--macs", "64", "--batch-size", "16", "--json", "--wire",
                   "--wire-pump", "vector"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["wire"]["mode"] == "memory" and out["wire"]["pump_path"] == "vector"
    assert out["wire"]["pump_stats"]["tx"] > 0 and out["served"]["dispatches"] > 0
    assert cli.main(["--device", "cpu", "loadtest", "--wire", "--scheduler"]) == 2
    assert "incompatible" in capsys.readouterr().err


def _wire_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("bng_wire_")]


def _run_wire_if(m_cli, kw, tmp_path):
    cfg = m_cli.BNGConfig(wire_if="nosuchif", telemetry_enabled=True,
                          trace_dir=str(tmp_path), metrics_port=0)
    app = m_cli.BNGApp(cfg, **kw)
    try:
        c = app.components
        att = c["wire_attachment"]
        from importlib import import_module

        rec_mod = import_module(m_cli.__name__.rsplit(".", 1)[0] + ".telemetry.recorder")
        dumps = c["telemetry"].recorder.triggers.get(rec_mod.TRIG_WIRE_FALLBACK)
        app.drive_once()
        c["collector"].collect_once()
        return (att.mode, att.detail, type(c["ring"]).__name__, dumps,
                _wire_lines(c["metrics"].expose()))
    finally:
        app.close()


def test_run_wire_if_missing_lands_on_the_memory_rung_like_reference(tmp_path):
    from bng_tpu import cli as j_cli
    from bng_tpu_torch import cli as t_cli

    ref = _run_wire_if(j_cli, {}, tmp_path / "j")
    got = _run_wire_if(t_cli, {"device": "cpu"}, tmp_path / "t")
    assert got == ref
    assert got[0] == "memory" and got[2] == "NativeRing" and got[3] == 1
    assert 'bng_wire_rung{mode="memory"} 1' in got[4]
