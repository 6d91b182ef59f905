"""Each stage of the port's IPoE step against the JAX package on one mixed
batch, bit for bit: parse_batch, antispoof_kernel, dhcp_fastpath, and
nat44_kernel + nat44_update_sessions. Both packages get the same tables,
built by the same host calls, and the same frames. The batch covers
untagged, VLAN and QinQ DISCOVER/REQUEST, option 82, relayed, expired,
bad-pool and unknown clients, established and new NAT flows (one session
hit twice), an ICMP echo, ingress TCP with FIN beside ACK on one slot,
an IPv6 frame, a spoofed source and a truncated frame.

The deployment and frame builders (tests/torch_deploy.py) are shared with
tests/test_torch_pipeline.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bng_tpu.control.nat import NATManager as JNATManager
from bng_tpu.ops.antispoof import antispoof_kernel as j_antispoof
from bng_tpu.ops.dhcp import dhcp_fastpath as j_dhcp
from bng_tpu.ops.nat44 import nat44_kernel as j_nat, nat44_update_sessions as j_nat_upd
from bng_tpu.ops.parse import eth_vlan as j_eth_vlan, parse_batch as j_parse
from bng_tpu.runtime.engine import AntispoofTables as JAntispoofTables
from bng_tpu.runtime.engine import QoSTables as JQoSTables
from bng_tpu.runtime.tables import FastPathTables as JFastPathTables
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.nat import NATManager as TNATManager
from bng_tpu_torch.ops.antispoof import MODE_LOOSE, MODE_STRICT, antispoof_kernel as t_antispoof
from bng_tpu_torch.ops.dhcp import dhcp_fastpath as t_dhcp
from bng_tpu_torch.ops.nat44 import nat44_kernel as t_nat, nat44_update_sessions as t_nat_upd
from bng_tpu_torch.ops.parse import eth_vlan as t_eth_vlan, parse_batch as t_parse
from bng_tpu_torch.runtime.engine import AntispoofTables as TAntispoofTables
from bng_tpu_torch.runtime.engine import QoSTables as TQoSTables
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPathTables
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_words import bits
from torch_deploy import (FLOW_SUBS, L, NOW, PORT_PKG, REMOTE, SUB_MACS, batch, deploy,  # noqa: F401
                          frame_mix, mac)

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")

JAX_PKG = SimpleNamespace(FastPathTables=JFastPathTables, NATManager=JNATManager,
                          QoSTables=JQoSTables, AntispoofTables=JAntispoofTables)


def assert_tuple_equal(got, ref, what):
    for f in ref._fields:
        r = getattr(ref, f)
        if r is None:
            continue
        g = getattr(got, f)
        if hasattr(r, "_fields"):
            assert_tuple_equal(g, r, f"{what}.{f}")
            continue
        assert np.array_equal(bits(g), bits(r)), f"{what}.{f}"


def jax_tables(d):
    """The JAX package's uploads of each table set, copied: on the CPU
    `jnp.asarray` may alias a host mirror array (alignment-dependent)."""
    import jax

    def cp(tree):
        return jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), tree)

    return SimpleNamespace(dhcp=cp(d.fp.device_tables()), nat=cp(d.nat.device_tables()),
                           spoof=cp(d.spoof.bindings.device_state()))


@pytest.fixture(scope="module")
def stage_in():
    jd, td = deploy(JAX_PKG), deploy(PORT_PKG)
    assert jd.tcp_nat == td.tcp_nat and jd.udp_nat == td.udp_nat
    frames, fa = frame_mix(td.tcp_nat)
    pkt, length = batch(frames, 32)
    return SimpleNamespace(jd=jd, td=td, jpkt=jnp.asarray(pkt), jlen=jnp.asarray(length),
                           tpkt=torch.from_numpy(pkt),
                           tlen=torch.from_numpy(length.astype(np.int64)))


def test_parse_batch(stage_in):
    s = stage_in
    assert_tuple_equal(t_parse(s.tpkt, s.tlen), j_parse(s.jpkt, s.jlen), "parsed")
    for got, ref in zip(t_eth_vlan(s.tpkt), j_eth_vlan(s.jpkt)):
        assert np.array_equal(bits(got), bits(ref))


def test_antispoof_kernel(stage_in):
    jd, td = stage_in.jd, stage_in.td
    ref = j_antispoof(stage_in.jpkt, j_parse(stage_in.jpkt, stage_in.jlen),
                      jax_tables(jd).spoof, jd.spoof.geom,
                      jnp.asarray(jd.spoof.ranges), jnp.asarray(jd.spoof.config))
    got = t_antispoof(stage_in.tpkt, t_parse(stage_in.tpkt, stage_in.tlen),
                      td.spoof.bindings.device_state(CPU), td.spoof.geom,
                      torch.from_numpy(td.spoof.ranges.view(np.int32)),
                      torch.from_numpy(td.spoof.config.view(np.int32)))
    assert_tuple_equal(got, ref, "antispoof")
    assert bool(np.asarray(ref.dropped).any()) and bool(np.asarray(ref.violation).any())


def test_dhcp_fastpath(stage_in):
    jd, td = stage_in.jd, stage_in.td
    ref = j_dhcp(stage_in.jpkt, stage_in.jlen, j_parse(stage_in.jpkt, stage_in.jlen),
                 jax_tables(jd).dhcp, jd.fp.geom, jnp.uint32(NOW))
    got = t_dhcp(stage_in.tpkt, stage_in.tlen, t_parse(stage_in.tpkt, stage_in.tlen),
                 td.fp.device_tables(CPU), td.fp.geom, torch.tensor(NOW))
    assert_tuple_equal(got, ref, "dhcp")
    # the batch really exercises replies, misses, expiry and the pool error
    st = np.asarray(ref.stats)
    assert int(np.asarray(ref.is_reply).sum()) >= 8
    assert st[2] > 0 and st[3] > 0 and st[4] > 0 and st[5] > 0


def test_nat44_kernel_and_update_sessions(stage_in):
    jd, td = stage_in.jd, stage_in.td
    jtab = jax_tables(jd).nat
    ttab = td.nat.device_tables(CPU)
    jp, tp = j_parse(stage_in.jpkt, stage_in.jlen), t_parse(stage_in.tpkt, stage_in.tlen)
    ref = j_nat(stage_in.jpkt, stage_in.jlen, jp, jtab, jd.nat.geom, jnp.uint32(NOW + 7))
    got = t_nat(stage_in.tpkt, stage_in.tlen, tp, ttab, td.nat.geom, torch.tensor(NOW + 7))
    assert_tuple_equal(got, ref, "nat")
    assert int(np.asarray(ref.punted).sum()) >= 1
    assert int(np.asarray(ref.egress_hit).sum()) == 4  # UDP twice, TCP, ICMP
    assert int(np.asarray(ref.ingress_hit).sum()) == 2  # ACK and FIN|ACK, one slot
    keep = np.array(ref.translated)
    keep[10] = False  # one forwarded lane that a later stage dropped
    new_sessions = j_nat_upd(jtab.sessions, ref, jp, stage_in.jlen, jnp.asarray(keep),
                             jnp.uint32(NOW + 7))
    out = t_nat_upd(ttab.sessions, got, tp, stage_in.tlen, torch.from_numpy(keep),
                    torch.tensor(NOW + 7))
    assert out is ttab.sessions
    assert np.array_equal(bits(ttab.sessions.vals), np.asarray(new_sessions.vals))
