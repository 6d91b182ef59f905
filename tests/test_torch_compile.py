"""The port's edge compile programs against the JAX package's.

- `InterceptTapProgram`: warrants (one without filters, one with a port,
  protocol and peer filter, one without a target address) armed through
  `sync()` give the same `EdgeTables` words (tap rows, filter rows, the
  armed count) and the same sync reports; a revoked warrant and expired
  ones are reaped with the same words again.
- `MirrorPump` as the engine's `mirror_sink`: the full-stack deployment
  of tests/test_torch_entry.py with its taps compiled from warrants, one
  batch through each package's `Engine.process`, gives the same
  mirror-sink calls, the same ETSI HI3 PDUs and the same pump and
  manager stats; after the reap the same batch mirrors nothing in both.
- `RouteProgram`: per-class ECMP over two upstreams, bound subscribers of
  every class, then an upstream down and up again through the routing
  manager's health checks: the same route rows and recompile reports at
  each step.

Tolerance: bit-exact (uint32 words, bytes, dicts).
"""

from types import SimpleNamespace

import numpy as np
import pytest

from bng_tpu.control import intercept as j_intercept
from bng_tpu.control import routing as j_routing
from bng_tpu.edge import compile as j_compile
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu_torch.control import intercept as t_intercept
from bng_tpu_torch.control import routing as t_routing
from bng_tpu_torch.edge import compile as t_compile
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_entry import JAX_FULL, PORT_FULL, deploy_full, full_batch
from test_torch_stages import NOW

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(name="jax", intercept=j_intercept, routing=j_routing, compile=j_compile,
                      full=JAX_FULL, Engine=JEngine, kw={})
PORT = SimpleNamespace(name="port", intercept=t_intercept, routing=t_routing, compile=t_compile,
                       full=PORT_FULL, Engine=TEngine, kw={"device": "cpu"})
PKGS = (JAX, PORT)
REMOTE = "93.184.216.34"
NH = [bytes.fromhex("02dd0000000a"), bytes.fromhex("02dd0000000b")]


def warrants(m, t0: float):
    W = m.intercept.Warrant
    return [
        W(id="W-A", liid="liid-A", target_ipv4="10.0.0.10", valid_from=t0 - 1,
          valid_until=t0 + 100),
        W(id="W-B", liid="liid-B", target_ipv4="10.0.0.11", valid_from=t0 - 1,
          valid_until=t0 + 1000, filter_dest_ports=[80, 53], filter_protocols=[6, 17],
          filter_dest_ips=[REMOTE]),
        W(id="W-C", liid="liid-C", target_subscriber_id="sub-9", valid_from=t0 - 1,
          valid_until=t0 + 1000),
        W(id="W-D", liid="liid-D", target_ipv4="10.0.0.13", valid_from=t0 - 1,
          valid_until=t0 + 1000),
    ]


def edge_words(e):
    return [np.array(a) for a in (e.tap.keys, e.tap.vals, e.tap.used, e.tap_filters,
                                  e.tap_config, e.route.keys, e.route.vals, e.route.used)]


def assert_words_equal(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x, y), f"{what}: edge array {i}"


def tap_stack(m, clk, edge=None):
    im = m.intercept.InterceptManager(clock=lambda: clk[0])
    pdus = []
    im.add_exporter(m.intercept.DeliveryMethod.ETSI, m.intercept.ETSIExporter(pdus.append))
    edge = edge if edge is not None else m.full.EdgeTables(nbuckets=64, stash=8,
                                                             update_slots=16, max_filters=8)
    prog = m.compile.InterceptTapProgram(edge, im, clock=lambda: clk[0])
    for w in warrants(m, clk[0]):
        im.add_warrant(w)
    return im, edge, prog, pdus


def test_warrants_arm_sync_and_reap_to_the_same_words():
    got = []
    for m in PKGS:
        clk = [1000.0]
        im, edge, prog, _ = tap_stack(m, clk)
        steps = [(prog.sync(), edge_words(edge))]
        steps.append((prog.sync(), edge_words(edge)))  # idempotent
        edge.disarm_tap(ip_to_u32("10.0.0.13"))  # a row lost behind the program's back
        steps.append((prog.sync(), edge_words(edge)))
        im.update_warrant_status("W-D", m.intercept.WarrantStatus.REVOKED)
        steps.append((prog.sync(), edge_words(edge)))
        clk[0] = 1500.0  # W-A's window closed
        steps.append((im.expire_warrants(max_reaps=8), prog.sync(), edge_words(edge)))
        got.append((steps, dict(prog.stats), prog.wid_for("W-B"), prog.armed_ips(2),
                    m.compile.InterceptTapProgram.compile_filters(im.get_warrant("W-B"))))
    (jsteps, *jrest), (tsteps, *trest) = got
    assert trest == jrest
    for k, (j, t) in enumerate(zip(jsteps, tsteps)):
        assert t[:-1] == j[:-1], k
        assert_words_equal(t[-1], j[-1], f"step {k}")
    assert tsteps[0][0] == {"armed": 3, "reaped": 0, "rows": 3}
    assert tsteps[-1][-2]["rows"] == 1  # only W-B's row is left


def test_mirror_pump_feeds_the_same_records_through_the_engine():
    got = []
    for m in PKGS:
        d = deploy_full(m.full)
        clk = [float(NOW)]
        im, edge, prog, pdus = tap_stack(
            m, clk, m.full.EdgeTables(nbuckets=64, stash=8, update_slots=16, max_filters=8))
        for ip in ("10.0.0.10", "10.0.0.11", "10.0.0.12", "10.0.0.77"):
            edge.set_route(ip_to_u32(ip), bytes.fromhex("02475700000a"), table_id=100)
        prog.sync()
        pump = m.compile.MirrorPump(prog)
        calls = []

        def sink(lane, frame, wid, _pump=pump, _calls=calls):
            _calls.append((lane, bytes(frame), wid))
            _pump(lane, frame, wid)

        eng = m.Engine(d.fp, d.nat, d.qos, d.spoof, d.garden, d.pppoe, edge=edge,
                       batch_size=64, mirror_sink=sink, **m.kw)
        frames, fa = full_batch(d)
        out1 = eng.process(frames, from_access=fa, now=NOW + 1)
        first = (list(calls), list(pdus), dict(pump.stats), im.stats())
        clk[0] = float(NOW + 5000)  # every window closed
        im.expire_warrants()
        prog.sync()
        calls.clear()
        out2 = eng.process(frames, from_access=fa, now=NOW + 2)
        got.append((out1, first, out2, list(calls), edge_words(edge)))
    (j1, jfirst, j2, jcalls, jw), (t1, tfirst, t2, tcalls, tw) = got
    assert (t1, tfirst, t2, tcalls) == (j1, jfirst, j2, jcalls)
    assert_words_equal(tw, jw, "after the reap")
    calls, pdus, stats, _ = tfirst
    assert calls and stats["cc_records"] > 0 and len(pdus) > stats["cc_records"]  # HI2 + HI3
    assert {wid for _, _, wid in calls} <= {1, 2}
    assert tcalls == []


def route_stack(m):
    platform = m.routing.StubPlatform()
    rman = m.routing.RoutingManager(None, platform)
    for k, name in enumerate(("ispA", "ispB")):
        gw = f"192.0.2.{k + 1}"
        rman.add_upstream(m.routing.Upstream(name=name, interface=f"eth{k + 1}", gateway=gw,
                                             table=100 + k, health_target=gw, weight=k + 1))
        platform.reachable[gw] = 0.01
    edge = m.full.EdgeTables(nbuckets=64, stash=8, update_slots=16, max_filters=8)
    rp = m.compile.RouteProgram(edge, rman, class_tables={"business": (101,)})
    rp.attach()
    rman.check_health()
    for k in range(2):
        rp.set_neighbor(f"192.0.2.{k + 1}", NH[k])
    return platform, rman, edge, rp


def test_route_program_follows_upstream_flaps():
    got = []
    for m in PKGS:
        platform, rman, edge, rp = route_stack(m)
        steps = []
        for i in range(24):
            klass = ("residential", "business", "wholesale")[i % 3]
            steps.append(rp.bind_subscriber(f"10.0.1.{i}", klass))
        steps.append(edge_words(edge))
        del platform.reachable["192.0.2.2"]  # ispB stops answering
        for _ in range(rman.config.failure_threshold):
            rman.check_health()
        steps.append((rman.list_upstreams()[1].state.value, edge_words(edge)))
        platform.reachable["192.0.2.2"] = 0.02
        rman.check_health()
        steps.append((rman.list_upstreams()[1].state.value, edge_words(edge)))
        steps.append(rp.unbind_subscriber("10.0.1.0"))
        got.append((steps, dict(rp.stats), rp.expected_row(ip_to_u32("10.0.1.5"))))
    (jsteps, *jrest), (tsteps, *trest) = got
    assert trest == jrest
    for k, (j, t) in enumerate(zip(jsteps, tsteps)):
        if isinstance(j, list):
            assert_words_equal(t, j, f"step {k}")
        elif isinstance(j, tuple):
            assert t[0] == j[0]
            assert_words_equal(t[1], j[1], f"step {k}")
        else:
            assert t == j, k
    assert tsteps[25][0] == "down" and tsteps[26][0] == "up"
    stats = trest[0]
    assert stats["flaps"] == 4 and stats["deltas"] > 24  # two first ups, a down, an up
