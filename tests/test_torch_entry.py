"""The port's flagship program and its full fused step against the JAX
package, bit for bit.

- `bng_tpu_torch.entry.entry(device="cpu")` against `__graft_entry__.entry()`:
  the same PPPoE-enabled step on the same three-frame batch gives
  identical PipelineResult leaves and tables.
- `pipeline_step` with every stage (PPPoE decap and encap, walled
  garden, intercept taps, next-hop routes) on tables carried over with
  `convert.tables_from_numpy` gives identical leaves and tables.

The full-stack deployment and batch here are shared with
tests/test_torch_ring.py. Tolerance: bit-exact.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from bng_tpu.edge.tables import EdgeTables as JEdgeTables
from bng_tpu.ops.pipeline import PipelineGeom as JGeom
from bng_tpu.ops.pipeline import PipelineTables as JTables
from bng_tpu.ops.pipeline import pipeline_step as j_step
from bng_tpu.runtime.engine import GardenTables as JGardenTables
from bng_tpu.runtime.tables import PPPoEFastPathTables as JPPPoETables
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.edge.tables import EdgeTables as TEdgeTables
from bng_tpu_torch.entry import entry as t_entry
from bng_tpu_torch.ops.pipeline import PipelineGeom as TGeom
from bng_tpu_torch.ops.pipeline import pipeline_step as t_step
from bng_tpu_torch.ops.table import TableGeom
from bng_tpu_torch.runtime.engine import GardenTables as TGardenTables
from bng_tpu_torch.runtime.tables import PPPoEFastPathTables as TPPPoETables
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_pipeline import PORT_PKG_GEOM
from test_torch_stages import (JAX_PKG, NOW, PORT_PKG, REMOTE, assert_tuple_equal, batch,
                               bits, deploy, frame_mix, mac)

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
AC_MAC = bytes.fromhex("02aabbccdd01")
PORTAL, DNS = ip_to_u32("10.9.9.9"), ip_to_u32("10.9.9.53")
GW = bytes.fromhex("02475700000a")
# PPPoE sessions: (session id, client MAC, address)
SESSIONS = [(0x42, bytes.fromhex("02c0ffee0007"), ip_to_u32("10.0.0.77")),
            (0x43, bytes.fromhex("02c0ffee0008"), ip_to_u32("10.0.0.78"))]
GARDENED = ip_to_u32("10.0.0.12")
TAPPED = {ip_to_u32("10.0.0.10"): 7, ip_to_u32("10.0.0.11"): 9}

JAX_FULL = SimpleNamespace(**vars(JAX_PKG), GardenTables=JGardenTables,
                           PPPoEFastPathTables=JPPPoETables, EdgeTables=JEdgeTables)
PORT_FULL = SimpleNamespace(**vars(PORT_PKG), GardenTables=TGardenTables,
                            PPPoEFastPathTables=TPPPoETables, EdgeTables=TEdgeTables)


def deploy_full(pkg):
    """The IPoE deployment of test_torch_stages plus every optional stage."""
    d = deploy(pkg)
    d.garden = pkg.GardenTables(nbuckets=64, stash=8, update_slots=16)
    d.garden.set_gardened(GARDENED, True)
    d.garden.allow_destination(PORTAL, 80, 6)
    d.garden.allow_destination(PORTAL, 443, 6)
    d.garden.allow_destination(DNS, 53, 17)
    d.garden.allow_destination(DNS, 53, 6)
    d.pppoe = pkg.PPPoEFastPathTables(nbuckets=64, stash=8, update_slots=16, server_mac=AC_MAC)
    for sid, m, ip in SESSIONS:
        d.pppoe.session_up(SimpleNamespace(session_id=sid, client_mac=m, assigned_ip=ip))
        d.nat.allocate_nat(ip, NOW)
    # one established flow of the first PPPoE subscriber (downstream encap)
    d.pppoe_nat = d.nat.handle_new_flow(SESSIONS[0][2], ip_to_u32(REMOTE), 6000, 53, 17, 80, NOW)
    d.edge = pkg.EdgeTables(nbuckets=64, stash=8, update_slots=16, max_filters=8)
    d.edge.arm_tap(ip_to_u32("10.0.0.10"), 7)
    d.edge.arm_tap(ip_to_u32("10.0.0.11"), 9, [(80, 6, 0)])
    for ip in ("10.0.0.10", "10.0.0.11", "10.0.0.12", "10.0.0.77"):
        d.edge.set_route(ip_to_u32(ip), GW, table_id=100)
    return d


def pppoe_frames(d):
    """(frames, from_access) exercising the PPPoE and garden stages."""
    (sid, m, ip), (sid2, m2, ip2) = SESSIONS
    rem = ip_to_u32(REMOTE)

    def inner(src, dst, sport, dport, n):
        return F.udp_packet(m, AC_MAC, src, dst, sport, dport, b"p" * n)[14:]

    lcp = F.CPPacket(F.CP_ECHO_REQ, 1, data=b"\x00\x00\x00\x01").encode()
    return [
        (F.pppoe_session_frame(AC_MAC, m, sid, F.PROTO_IPV4, inner(ip, rem, 6000, 53, 40)),
         True),  # established PPPoE flow: decap, SNAT
        (F.pppoe_session_frame(AC_MAC, m2, sid2, F.PROTO_IPV4, inner(ip2, rem, 6001, 53, 30),
                               vlans=[100, 200]), True),  # QinQ, new flow, no route: punt
        (F.pppoe_session_frame(AC_MAC, m, sid, F.PROTO_LCP, lcp), True),  # control: PASS
        (F.pppoe_padi_frame(m, host_uniq=b"u1"), True),  # discovery: PASS
        (F.pppoe_session_frame(AC_MAC, m, 0x99, F.PROTO_IPV4, inner(ip, rem, 6000, 53, 8)),
         True),  # unknown session: PASS
        (F.pppoe_session_frame(AC_MAC, m, sid, F.PROTO_IPV4, inner(ip, rem, 6000, 53, 8)),
         False),  # session ethertype from the core: untouched
        (F.udp_packet(b"\x04" * 6, b"\x06" * 6, rem, d.pppoe_nat[0], 53, d.pppoe_nat[1],
                      b"answer" * 4), False),  # downstream: DNAT, then encap
        (F.tcp_packet(mac(0x12), b"\x04" * 6, GARDENED, PORTAL, 33000, 80, b"GET"),
         True),  # gardened, allowed destination
        (F.udp_packet(mac(0x12), b"\x04" * 6, GARDENED, rem, 33001, 443, b"q" * 20),
         True),  # gardened, not allowed: DROP
    ]


def full_batch(d):
    frames, fa = frame_mix(d.tcp_nat)
    extra = pppoe_frames(d)
    return frames + [f for f, _ in extra], fa + [a for _, a in extra]


def jax_tables_numpy_full(d):
    t = JTables(
        dhcp=d.fp.device_tables(), nat=d.nat.device_tables(),
        qos_up=d.qos.up.device_state(), qos_down=d.qos.down.device_state(),
        spoof=d.spoof.bindings.device_state(),
        spoof_ranges=jnp.asarray(d.spoof.ranges), spoof_config=jnp.asarray(d.spoof.config),
        garden=d.garden.subscribers.device_state(), garden_allowed=jnp.asarray(d.garden.allowed),
        pppoe_by_sid=d.pppoe.by_sid.device_state(), pppoe_by_ip=d.pppoe.by_ip.device_state(),
        pppoe_server_mac=jnp.asarray(d.pppoe.server_mac),
        tap=d.edge.tap.device_state(), tap_filters=jnp.asarray(d.edge.tap_filters),
        tap_config=jnp.asarray(d.edge.tap_config), route=d.edge.route.device_state())
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def geoms_full(jd):
    jgeom = JGeom(dhcp=jd.fp.geom, nat=jd.nat.geom, qos=jd.qos.geom, spoof=jd.spoof.geom,
                  garden=jd.garden.geom, pppoe=jd.pppoe.geom, tap=jd.edge.geom,
                  route=jd.edge.geom)

    def tg(g):
        return TableGeom(g.nbuckets, g.stash)

    tgeom = TGeom(*PORT_PKG_GEOM(jd), garden=tg(jd.garden.geom), pppoe=tg(jd.pppoe.geom),
                  tap=tg(jd.edge.geom), route=tg(jd.edge.geom))
    return jgeom, tgeom


def assert_results_equal(got, ref):
    for f in ref._fields:
        r = getattr(ref, f)
        if f == "tables":
            continue
        if r is None:
            assert getattr(got, f) is None, f
            continue
        assert np.array_equal(bits(getattr(got, f)), bits(r)), f


def test_entry_matches_reference_entry():
    jfn, jargs = __graft_entry__.entry()
    ref = jax.jit(jfn)(*jargs)
    tfn, targs = t_entry(device="cpu")
    got = tfn(*targs)
    assert targs[1].device == CPU and got.tables is targs[0]
    assert_results_equal(got, ref)
    assert_tuple_equal(convert.tables_to_numpy(got.tables), ref.tables, "tables")
    v = np.asarray(ref.verdict)
    assert v[0] == 2  # the cached DISCOVER answered on the device
    assert int(np.asarray(ref.pppoe_stats)[0]) == 1  # the session frame decapped


def test_full_stack_step_on_converted_tables():
    jd = deploy_full(JAX_FULL)
    frames, fa = full_batch(jd)
    B = 48
    pkt, length = batch(frames, B)
    fa_arr = np.zeros(B, dtype=bool)
    fa_arr[: len(fa)] = fa
    np_tables = jax_tables_numpy_full(jd)
    tt = convert.tables_from_numpy(np_tables, CPU)
    jgeom, tgeom = geoms_full(jd)
    now_us = 0x12345678
    ref = jax.jit(j_step, static_argnums=(4,))(
        jax.tree_util.tree_map(jnp.asarray, np_tables), jnp.asarray(pkt), jnp.asarray(length),
        jnp.asarray(fa_arr), jgeom, jnp.uint32(NOW), jnp.uint32(now_us))
    got = t_step(tt, torch.from_numpy(pkt), torch.from_numpy(length.astype(np.int64)),
                 torch.from_numpy(fa_arr), tgeom, torch.tensor(NOW), torch.tensor(now_us))
    assert got.tables is tt
    assert_results_equal(got, ref)
    assert_tuple_equal(convert.tables_to_numpy(tt), ref.tables, "tables")

    # every stage did work on this batch
    v = np.asarray(ref.verdict)
    assert {0, 1, 2, 3} <= set(v.tolist())
    ps, gs, es = (np.asarray(ref.pppoe_stats), np.asarray(ref.garden_stats),
                  np.asarray(ref.edge_stats))
    assert ps[0] >= 2 and ps[1] == 1 and ps[2] >= 2 and ps[4] >= 1  # decap, encap, ctrl, miss
    assert gs[0] >= 1 and gs[1] >= 1  # gated drop, allowed hit
    assert es[0] >= 1 and es[2] >= 1  # mirrored, routed
    mirror = np.asarray(ref.mirror)
    assert set(mirror.tolist()) - {0} <= set(TAPPED.values()) and mirror.any()
    # the downstream PPPoE lane left encapsulated with the AC's MAC as source
    lane = len(frame_mix(jd.tcp_nat)[0]) + 6
    out = bytes(np.asarray(ref.out_pkt)[lane, : int(np.asarray(ref.out_len)[lane])])
    assert v[lane] == 3 and out[6:12] == AC_MAC and out[12:14] == b"\x88\x64"
    assert out[:6] == SESSIONS[0][1]


def test_tables_round_trip_every_stage():
    jd = deploy_full(JAX_FULL)
    np_tables = jax_tables_numpy_full(jd)
    back = convert.tables_to_numpy(convert.tables_from_numpy(np_tables, CPU))
    assert_tuple_equal(back, np_tables, "tables")
    assert back.pppoe_server_mac is not None and back.route is not None
