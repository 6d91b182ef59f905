"""The port's fused step and engine against the JAX package.

- `pipeline_step` on tables carried over with `convert.tables_from_numpy`
  gives identical PipelineResult leaves and identical updated tables.
- The JAX `Engine` and the port's `Engine(device="cpu")`, built by the
  same host calls, give identical `process` output for a cached DISCOVER
  answered on the device, an established flow SNAT'd, a new flow punted
  and forwarded on the next batch, and a QoS drop; their tables are
  equal afterwards.
- `frames.py` builds the same bytes as the JAX package's codecs.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bng_tpu.control import dhcp_codec, packets
from bng_tpu.ops.pipeline import PipelineGeom as JGeom
from bng_tpu.ops.pipeline import PipelineTables as JTables
from bng_tpu.ops.pipeline import pipeline_step as j_step
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.ops.pipeline import PipelineGeom as TGeom
from bng_tpu_torch.ops.pipeline import pipeline_step as t_step
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_stages import (JAX_PKG, NOW, PORT_PKG, REMOTE, assert_tuple_equal, batch,
                               bits, deploy, frame_mix, mac)

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _jax_tables_numpy(d):
    """The JAX package's device tables, fetched as numpy uint32 leaves."""
    t = JTables(
        dhcp=d.fp.device_tables(), nat=d.nat.device_tables(),
        qos_up=d.qos.up.device_state(), qos_down=d.qos.down.device_state(),
        spoof=d.spoof.bindings.device_state(),
        spoof_ranges=jnp.asarray(d.spoof.ranges), spoof_config=jnp.asarray(d.spoof.config))
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def test_pipeline_step_on_converted_tables():
    jd = deploy(JAX_PKG)
    frames, fa = frame_mix(jd.tcp_nat)
    pkt, length = batch(frames, 32)
    fa_arr = np.zeros(32, dtype=bool)
    fa_arr[: len(fa)] = fa
    np_tables = _jax_tables_numpy(jd)
    tt = convert.tables_from_numpy(np_tables, CPU)
    jgeom = JGeom(dhcp=jd.fp.geom, nat=jd.nat.geom, qos=jd.qos.geom, spoof=jd.spoof.geom)
    tgeom = TGeom(*(PORT_PKG_GEOM(jd)))
    now_us = 0x12345678
    ref = j_step(jax.tree_util.tree_map(jnp.asarray, np_tables), jnp.asarray(pkt),
                 jnp.asarray(length), jnp.asarray(fa_arr), jgeom, jnp.uint32(NOW),
                 jnp.uint32(now_us))
    got = t_step(tt, torch.from_numpy(pkt), torch.from_numpy(length.astype(np.int64)),
                 torch.from_numpy(fa_arr), tgeom, torch.tensor(NOW), torch.tensor(now_us))
    assert got.tables is tt
    for f in ref._fields:
        r = getattr(ref, f)
        if r is None or f == "tables":
            continue
        assert np.array_equal(bits(getattr(got, f)), bits(r)), f
    assert_tuple_equal(convert.tables_to_numpy(tt), ref.tables, "tables")
    v = np.asarray(ref.verdict)
    assert {0, 1, 2, 3} <= set(v.tolist())  # PASS, DROP, TX and FWD all occur


def PORT_PKG_GEOM(jd):
    """The port's geometry tuples built from the same numbers as jd's."""
    from bng_tpu_torch.ops.dhcp import DHCPGeom
    from bng_tpu_torch.ops.nat44 import NATGeom
    from bng_tpu_torch.ops.qtable import QTableGeom
    from bng_tpu_torch.ops.table import TableGeom

    def tg(g):
        return TableGeom(g.nbuckets, g.stash)

    return (DHCPGeom(*(tg(g) for g in jd.fp.geom)), NATGeom(*(tg(g) for g in jd.nat.geom)),
            QTableGeom(jd.qos.geom.nbuckets), tg(jd.spoof.geom))


def test_tables_round_trip():
    jd = deploy(JAX_PKG)
    np_tables = _jax_tables_numpy(jd)
    back = convert.tables_to_numpy(convert.tables_from_numpy(np_tables, CPU))
    assert_tuple_equal(back, np_tables, "tables")


def _engine_flows(tcp_nat):
    """Three batches: (frames, from_access, now)."""
    rem = ip_to_u32(REMOTE)
    sub = ip_to_u32("10.0.0.10")

    def udp(sport, dport, n):
        return F.udp_packet(mac(0x10), b"\x04" * 6, sub, rem, sport, dport, b"q" * n)

    # a new flow of the second subscriber (no tight QoS bucket)
    new_flow = F.udp_packet(mac(0x11), b"\x04" * 6, ip_to_u32("10.0.0.11"), rem, 6000, 53,
                            b"n" * 40)

    b1 = [F.discover_frame(mac(1), 0xA1),  # cached DISCOVER -> TX
          udp(5000, 443, 300), udp(5000, 443, 300), udp(5000, 443, 300),  # 2nd, 3rd: QoS drop
          new_flow,  # new flow -> punt
          F.tcp_packet(mac(0x11), b"\x04" * 6, ip_to_u32("10.0.0.11"), rem, 40000, 80, b"x"),
          F.discover_frame(mac(7), 0xA2)]  # unknown client -> slow path
    b2 = [new_flow,  # the punted flow, now device-resident -> FWD
          F.tcp_packet(b"\x04" * 6, mac(0x11), rem, tcp_nat[0], 80, tcp_nat[1], b"",
                       flags=0x11),  # ingress FIN
          F.discover_frame(mac(2), 0xA3, vlans=[100])]
    b3 = [udp(5000, 443, 300), new_flow, F.discover_frame(mac(3), 0xA4),
          F.with_udp_checksum(new_flow)]  # SNAT must rewrite a real UDP checksum
    return [(b1, True, NOW + 0.25), (b2, [True, False, True], NOW + 1.5),
            (b3, True, NOW + 2.75)]


def test_engines_give_identical_process_output():
    jd, td = deploy(JAX_PKG), deploy(PORT_PKG)
    slow_seen = {"jax": [], "port": []}
    jeng = JEngine(jd.fp, jd.nat, jd.qos, jd.spoof, batch_size=16, pkt_slot=512,
                   slow_path=lambda f: slow_seen["jax"].append(f) and None)
    teng = TEngine(td.fp, td.nat, td.qos, td.spoof, batch_size=16, pkt_slot=512,
                   slow_path=lambda f: slow_seen["port"].append(f) and None, device="cpu")
    outs = []
    for frames, fa, now in _engine_flows(td.tcp_nat):
        jo = jeng.process(frames, from_access=fa, now=now)
        to = teng.process(frames, from_access=fa, now=now)
        assert to == jo
        outs.append(to)
    assert slow_seen["port"] == slow_seen["jax"]
    o1, o2, o3 = outs
    assert [i for i, _ in o1["tx"]] == [0]
    reply = F.decode_dhcp(F.decode(o1["tx"][0][1]).payload)
    assert reply.yiaddr == ip_to_u32("10.0.0.21") and reply.msg_type == F.OFFER
    assert [i for i, _ in o1["fwd"]] == [1, 5]
    snat = F.decode(o1["fwd"][0][1])
    assert snat.src_ip == jd.udp_nat[0] and snat.src_port == jd.udp_nat[1] and snat.ip_checksum_ok
    assert o1["dropped"] == [2, 3]  # QoS: 342-byte packets past a 600-byte burst
    assert 4 in [i for i, _ in o1["slow"]]  # the punted new flow
    assert 0 in [i for i, _ in o2["fwd"]]  # ... forwarded on the next batch
    assert F.l4_checksum_ok(dict(o1["fwd"])[5])  # TCP SNAT keeps the checksum valid
    udp_csum = F.decode(dict(o3["fwd"])[3])
    assert udp_csum.src_ip != ip_to_u32("10.0.0.11") and udp_csum.l4_checksum != 0
    assert F.l4_checksum_ok(dict(o3["fwd"])[3])
    for f in ("dhcp", "nat", "qos", "spoof"):
        assert np.array_equal(getattr(teng.stats, f), getattr(jeng.stats, f)), f
    for f in ("batches", "tx", "fwd", "dropped", "passed", "slow_errors"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    jt = jax.tree_util.tree_map(lambda a: np.array(a), jeng.tables)
    assert_tuple_equal(convert.tables_to_numpy(teng.tables), jt, "engine tables")


def test_frames_match_reference_codecs():
    m = mac(0x42)
    assert F.udp_packet(m, b"\xff" * 6, 1, 2, 3, 4, b"abc") == \
        packets.udp_packet(m, b"\xff" * 6, 1, 2, 3, 4, b"abc")
    assert F.udp_packet(m, b"\xff" * 6, 1, 2, 3, 4, b"abc", vlans=[5, 6]) == \
        packets.udp_packet(m, b"\xff" * 6, 1, 2, 3, 4, b"abc", vlans=[5, 6])
    assert F.tcp_packet(m, b"\x01" * 6, 7, 8, 9, 10, b"hi", flags=0x11, seq=5, vlans=[3]) == \
        packets.tcp_packet(m, b"\x01" * 6, 7, 8, 9, 10, b"hi", flags=0x11, seq=5, vlans=[3])
    kw = dict(xid=0xABCD, giaddr=ip_to_u32("10.1.0.254"), circuit_id=b"olt-1/2",
              remote_id=b"r", broadcast=True, requested_ip=5, server_id=6)
    jp = dhcp_codec.build_request(m, dhcp_codec.REQUEST, **kw)
    tp = F.build_request(m, F.REQUEST, **kw)
    assert tp.encode() == jp.encode()
    frame = F.discover_frame(m, 0x77, vlans=[100, 200])
    ref_payload = dhcp_codec.build_request(m, dhcp_codec.DISCOVER, xid=0x77)
    ref_payload.options.append((dhcp_codec.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    assert frame == packets.udp_packet(m, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                                       ref_payload.encode().ljust(300, b"\x00"),
                                       vlans=[100, 200])
    for raw in (frame, F.tcp_packet(m, m, 1, 2, 3, 4, b"xy")):
        a, b = F.decode(raw), packets.decode(raw)
        assert a.__dict__ == b.__dict__
    da, db = F.decode_dhcp(F.decode(frame).payload), dhcp_codec.decode(packets.decode(frame).payload)
    for f in ("op", "xid", "yiaddr", "flags", "chaddr", "options", "msg_type"):
        assert getattr(da, f) == getattr(db, f), f


@pytest.mark.parametrize("vlans", [None, [7], [5, 6]])
def test_l4_checksum_helpers(vlans):
    m = mac(0x43)
    # the TCP checksum is the reference codec's (the builders are byte-equal)
    tcp = packets.tcp_packet(m, m, 0x0A000001, 0x5DB80001, 40000, 443, b"abc", vlans=vlans)
    udp = F.udp_packet(m, m, 0x0A000001, 0x5DB80001, 40000, 443, b"abcde", vlans=vlans)
    filled = F.with_udp_checksum(udp)
    assert F.l4_checksum_ok(tcp) and F.l4_checksum_ok(udp) and F.l4_checksum_ok(filled)
    assert F.decode(udp).l4_checksum == 0 and F.decode(filled).l4_checksum != 0
    assert len(filled) == len(udp)
    assert sum(a != b for a, b in zip(udp, filled)) <= 2  # only the checksum field
    for raw in (tcp, filled):
        bad = raw[:-1] + bytes([raw[-1] ^ 0x01])  # one payload bit flipped
        assert not F.l4_checksum_ok(bad)
