"""The port's walled-garden gate and edge stages against the JAX package,
bit for bit: `garden_kernel`, `tap_match` (armed and disarmed, warrants
with and without port/proto/peer filters, both directions) and
`route_rewrite`, on one seeded batch and tables built by the same host
calls in both packages. Also `GardenTables` and `EdgeTables` host rows.
Tolerance: bit-exact.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bng_tpu.edge import ops as je
from bng_tpu.edge.tables import EdgeTables as JEdge
from bng_tpu.ops.garden import garden_kernel as j_garden
from bng_tpu.ops.parse import parse_batch as j_parse
from bng_tpu.runtime.engine import GardenTables as JGarden
from bng_tpu_torch import frames as F
from bng_tpu_torch.edge import ops as te
from bng_tpu_torch.edge.tables import EdgeTables as TEdge
from bng_tpu_torch.ops.garden import garden_kernel as t_garden
from bng_tpu_torch.ops.parse import parse_batch as t_parse
from bng_tpu_torch.runtime.engine import GardenTables as TGarden
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_stages import assert_tuple_equal
from test_torch_words import bits

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
L = 512
SUBS = [ip_to_u32(f"10.0.0.{k}") for k in range(10, 26)]
PORTAL, DNS = ip_to_u32("10.9.9.9"), ip_to_u32("10.9.9.53")
REMOTE = ip_to_u32("93.184.216.34")
GW = [bytes([0x02, 0x47, 0x57, 0, 0, k]) for k in range(4)]


def _garden(cls):
    g = cls(nbuckets=64, stash=8, update_slots=16)
    for ip in SUBS[::2]:
        g.set_gardened(ip, True)
    g.set_gardened(SUBS[2], False)  # un-gardened again
    g.allow_destination(PORTAL, 80, 6)
    g.allow_destination(PORTAL, 443, 6)
    g.allow_destination(DNS, 53, 17)
    g.allow_destination(DNS, 53, 6)
    g.allow_destination(ip_to_u32("10.9.9.10"))  # any port, any proto
    return g


def _edge(cls, armed: bool):
    e = cls(nbuckets=64, stash=8, update_slots=16, max_filters=8)
    if armed:
        e.arm_tap(SUBS[1], 7)  # every flow of the subscriber
        e.arm_tap(SUBS[3], 9, [(80, 6, 0), (0, 17, REMOTE)])  # web, or UDP to REMOTE
        e.arm_tap(SUBS[5], 11, [(4444, 0, 0)])
        e.arm_tap(SUBS[7], 12)
        e.disarm_tap(SUBS[7])
    for k, ip in enumerate(SUBS[:12]):
        e.set_route(ip, GW[k % 4], table_id=100 + k % 4, klass=k % 3)
    e.clear_route(SUBS[11])
    return e


def frames_and_fa(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(40):
        sub = SUBS[int(rng.integers(len(SUBS)))]
        dst, dport, proto = [(PORTAL, 80, 6), (PORTAL, 443, 6), (DNS, 53, 17), (DNS, 53, 6),
                             (REMOTE, 443, 17), (REMOTE, 4444, 6), (ip_to_u32("10.9.9.10"), 9, 17),
                             (PORTAL, 8080, 6)][int(rng.integers(8))]
        up = bool(rng.random() < 0.7)
        src, dst_ip = (sub, dst) if up else (dst, sub)
        sport, dp = (int(rng.integers(1024, 60000)), dport) if up else (dport, 5000)
        if proto == 6:
            f = F.tcp_packet(b"\x02" * 6, b"\x04" * 6, src, dst_ip, sport, dp, b"x")
        else:
            f = F.udp_packet(b"\x02" * 6, b"\x04" * 6, src, dst_ip, sport, dp, b"y" * 8)
        out.append((f, up))
    out.append((F.discover_frame(b"\x02\x00\x00\x00\x00\x01", 5), True))
    out.append((b"\x02" * 6 + b"\x04" * 6 + b"\x86\xdd" + bytes(40), True))
    return [f for f, _ in out], np.array([a for _, a in out] + [False] * (48 - len(out)))


@pytest.fixture(scope="module")
def batch():
    frames, fa = frames_and_fa(11)
    pkt = np.zeros((48, L), dtype=np.uint8)
    length = np.zeros((48,), dtype=np.uint32)
    for i, fr in enumerate(frames):
        pkt[i, : len(fr)] = np.frombuffer(fr, dtype=np.uint8)
        length[i] = len(fr)
    jpkt, jlen = jnp.asarray(pkt), jnp.asarray(length)
    tpkt, tlen = torch.from_numpy(pkt), torch.from_numpy(length.astype(np.int64))
    return SimpleNamespace(jpkt=jpkt, jpar=j_parse(jpkt, jlen), jfa=jnp.asarray(fa),
                           tpkt=tpkt, tpar=t_parse(tpkt, tlen), tfa=torch.from_numpy(fa))


def _jcopy(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), tree)


def _words(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def test_garden_kernel(batch):
    j, t = _garden(JGarden), _garden(TGarden)
    assert np.array_equal(j.subscribers.vals, t.subscribers.vals)
    assert np.array_equal(j.allowed, t.allowed)
    b = batch
    jelig = b.jfa & b.jpar.is_ipv4
    telig = b.tfa & b.tpar.is_ipv4
    ref = j_garden(b.jpar, jelig, _jcopy(j.subscribers.device_state()), j.geom,
                   jnp.asarray(j.allowed))
    got = t_garden(b.tpar, telig, t.subscribers.device_state(CPU), t.geom, _words(t.allowed))
    assert_tuple_equal(got, ref, "garden")
    st = np.asarray(ref.stats)
    assert st[0] > 0 and st[1] > 0  # both gated drops and allowed hits


def _sub_peer(par, fa, torch_side: bool):
    """The pipeline's tap inputs: subscriber and peer address per lane."""
    where = torch.where if torch_side else jnp.where
    return (where(fa, par.src_ip, par.dst_ip), where(fa, par.dst_ip, par.src_ip))


@pytest.mark.parametrize("armed", [True, False])
def test_tap_match(batch, armed):
    j, t = _edge(JEdge, armed), _edge(TEdge, armed)
    assert np.array_equal(j.tap_filters, t.tap_filters)
    assert np.array_equal(j.tap_config, t.tap_config)
    b = batch
    js, jpeer = _sub_peer(b.jpar, b.jfa, False)
    ts, tpeer = _sub_peer(b.tpar, b.tfa, True)
    ref = je.tap_match(js, b.jpar.src_port, b.jpar.dst_port, b.jpar.proto, jpeer,
                       b.jpar.is_ipv4, _jcopy(j.tap.device_state()),
                       jnp.asarray(j.tap_filters), jnp.asarray(j.tap_config), j.geom)
    got = te.tap_match(ts, b.tpar.src_port, b.tpar.dst_port, b.tpar.proto, tpeer,
                       b.tpar.is_ipv4, t.tap.device_state(CPU), _words(t.tap_filters),
                       _words(t.tap_config), t.geom)
    assert_tuple_equal(got, ref, "tap")
    mirror, st = np.asarray(ref.mirror), np.asarray(ref.stats)
    if armed:
        # the filterless warrant, a filtered one that matches, one filtered out
        assert {7, 9} <= set(mirror.tolist()) and st[0] > 0 and st[1] > 0
    else:
        assert not mirror.any() and not st.any()


def test_tap_disarmed_table_with_rows_mirrors_nothing(batch):
    """A tap row whose armed word says 0 (rows present, config disarmed):
    the port's device-side select gives the reference's cond result."""
    j, t = _edge(JEdge, True), _edge(TEdge, True)
    j.tap_config[je.TC_ARMED] = 0
    t.tap_config[te.TC_ARMED] = 0
    b = batch
    js, jpeer = _sub_peer(b.jpar, b.jfa, False)
    ts, tpeer = _sub_peer(b.tpar, b.tfa, True)
    ref = je.tap_match(js, b.jpar.src_port, b.jpar.dst_port, b.jpar.proto, jpeer,
                       b.jpar.is_ipv4, _jcopy(j.tap.device_state()),
                       jnp.asarray(j.tap_filters), jnp.asarray(j.tap_config), j.geom)
    got = te.tap_match(ts, b.tpar.src_port, b.tpar.dst_port, b.tpar.proto, tpeer,
                       b.tpar.is_ipv4, t.tap.device_state(CPU), _words(t.tap_filters),
                       _words(t.tap_config), t.geom)
    assert_tuple_equal(got, ref, "tap")
    assert not bits(got.mirror).any()


def test_route_rewrite(batch):
    j, t = _edge(JEdge, True), _edge(TEdge, True)
    assert np.array_equal(j.route.vals, t.route.vals)
    b = batch
    js, _ = _sub_peer(b.jpar, b.jfa, False)
    ts, _ = _sub_peer(b.tpar, b.tfa, True)
    ref = je.route_rewrite(b.jpkt, js, b.jpar.is_ipv4 & b.jfa, _jcopy(j.route.device_state()),
                           j.geom)
    got = te.route_rewrite(b.tpkt, ts, b.tpar.is_ipv4 & b.tfa, t.route.device_state(CPU),
                           t.geom)
    assert_tuple_equal(got, ref, "route")
    hit = np.asarray(ref.hit)
    assert hit.any() and not hit.all()
    lane = int(np.nonzero(hit)[0][0])
    assert bytes(got.out_pkt[lane, :6].numpy()) in GW  # the gateway MAC stamped


def test_edge_table_updates_drain_alike():
    """The bounded deltas both packages drain from the same host calls."""
    j, t = _edge(JEdge, True), _edge(TEdge, True)
    j.tap.device_state(), t.tap.device_state(CPU)
    j.route.device_state(), t.route.device_state(CPU)
    for e in (j, t):
        e.arm_tap(SUBS[9], 21, [(53, 17, 0)])
        e.set_route(SUBS[9], GW[3], 9)
    assert j.dirty_count() == t.dirty_count() > 0
    jupd, tupd = j.make_updates(), t.make_updates(CPU)
    for jj, tt in zip(jupd, tupd):
        if hasattr(jj, "_fields"):
            assert_tuple_equal(tt, jj, "update")
        else:
            assert np.array_equal(bits(tt), bits(jj))
    assert j.dirty_count() == t.dirty_count() == 0
