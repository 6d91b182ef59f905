"""The port's sharded step against the JAX `ShardedCluster`, bit for bit.

The JAX clusters run on the virtual CPU devices tests/conftest.py forces;
the port's run its N shards on the CPU (`device="cpu"`). Both get the
same control-plane writes and frames; after every step the test compares
verdicts, reply bytes and lengths, the summed stats, `nat_punt` and
`violation`, the telemetry counters and every shard's table words.

- `sharded_lookup` for a balanced batch, a batch whose keys all have one
  owner (lanes past the exchange capacity punt) and the never-punting
  capacity factor N, at N = 2 and 8, against the reference's lookup
  under `shard_map`.
- Owner routing (DHCP keys, affinity, the bulk build, public IPs).
- N = 8 with the walled garden: DISCOVERs from every shard (VLAN,
  circuit-ID, expired, unknown and a skewed region that overflows the
  exchange), NAT, QoS, antispoof and garden lanes, a wrong-shard lane; a
  subscriber added after a step answered by every shard; the DHCP-only
  lane; the steering ring through `process_ring` with the wrong-shard
  PASS counted as a missteer; the pipelined loop and its fail-closed
  path on a dispatch error; `expire` per shard.
- N = 2 with PPPoE and edge: session data decapped on its shard, the
  downstream encap, a mirrored lane.
- The port's `dryrun_multichip(8, device="cpu")`.

Tolerance: bit-exact (the same words, bytes and counts).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bng_tpu.ops import table as j_table
from bng_tpu.ops.qos import qos_kernel as j_qos_kernel
from bng_tpu.ops.qtable import QTableGeom as JQGeom
from bng_tpu.parallel import sharded as j_sharded
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.ops import table as t_table
from bng_tpu_torch.ops.antispoof import MODE_STRICT
from bng_tpu_torch.ops.qos import qos_kernel as t_qos_kernel
from bng_tpu_torch.ops.qtable import QTableGeom as TQGeom
from bng_tpu_torch.parallel import sharded as t_sharded
from bng_tpu_torch.parallel.exchange import DeviceLocalExchange
from bng_tpu_torch.runtime.ring import FLAG_FROM_ACCESS
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_stages import assert_tuple_equal

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
NOW = 1_753_000_000
L = 512
B_SHARD = 16
SERVER_MAC = bytes.fromhex("02aabbccdd01")
REMOTE = ip_to_u32("93.184.216.34")
PORTAL = ip_to_u32("198.51.100.10")
N_MACS = 64
FS = [ip_to_u32(f"10.0.0.{10 + k}") for k in range(4)]  # flow subscribers (= mac(0..3)'s leases)
BULK_BASE = 0x02BB00000000


def mac(i: int) -> bytes:
    return bytes([0x02, 0xC0, 0xFF, 0xEE, i >> 8, i & 0xFF])


def bulk_mac(k: int) -> bytes:
    return (BULK_BASE + k).to_bytes(6, "big")


# ---------------------------------------------------------------- lookups

def _lookup_case(n: int, case: str):
    """Shards' host tables for both packages and the [n*b, 2] queries."""
    rng = np.random.default_rng(20 + n)
    factor = float(n) if case == "factor_n" else 2.0
    b = 32
    keys = np.unique(rng.integers(0, 2**32, size=(4000, 2), dtype=np.uint32), axis=0)
    owner = t_table.shard_owner([keys[:, 0], keys[:, 1]], n)
    assert np.array_equal(owner, np.asarray(j_table.shard_owner([keys[:, 0], keys[:, 1]], n)))
    if case == "balanced":
        pool = keys[:256]
    else:  # every key has one owner: the exchange overflows unless factor >= n
        pool = keys[owner == owner[0]][:64]
    jt = [j_table.HostTable(nbuckets=64, key_words=2, val_words=4, stash=8) for _ in range(n)]
    tt = [t_table.HostTable(nbuckets=64, key_words=2, val_words=4, stash=8) for _ in range(n)]
    for i, k in enumerate(pool[: len(pool) * 3 // 4]):  # a quarter stays a miss
        o = int(t_table.shard_owner([k[0:1], k[1:2]], n)[0])
        jt[o].insert(k, [i, i + 1, 0, 7])
        tt[o].insert(k, [i, i + 1, 0, 7])
    q = np.stack([pool[rng.integers(len(pool), size=b)] for _ in range(n)]).reshape(n * b, 2)
    return jt, tt, q, b, factor


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", ["balanced", "skew", "factor_n"])
def test_sharded_lookup_matches_reference(n, case):
    jt, tt, q, b, factor = _lookup_case(n, case)
    jg = j_table.TableGeom(64, 8, axis=j_sharded.AXIS, n_shards=n, capacity_factor=factor)
    tg = t_table.TableGeom(64, 8, axis=t_sharded.AXIS, n_shards=n, capacity_factor=factor)
    C = t_table.exchange_capacity(b, tg)
    assert C == j_table.exchange_capacity(b, jg)
    assert (C == b) == (factor >= n)

    def local(tabs1, qq):
        r = j_table.lookup(jax.tree.map(lambda x: x[0], tabs1), qq, jg)
        return r.found, r.slot, r.vals, r.punted

    f = jax.jit(j_sharded._shard_map(local, mesh=j_sharded.make_mesh(n),
                                     in_specs=(P(j_sharded.AXIS), P(j_sharded.AXIS)),
                                     out_specs=(P(j_sharded.AXIS),) * 4))
    ref = [np.asarray(a) for a in f(jax.tree.map(lambda *xs: jax.numpy.stack(xs),
                                                 *[s.device_state() for s in jt]),
                                    jax.numpy.asarray(q))]
    states = tuple(s.device_state(CPU) for s in tt)
    ex = DeviceLocalExchange([CPU] * n)
    qt = torch.from_numpy(q.view(np.int32))
    got = [t_table.lookup(t_table.ShardedTable(states, i, ex), qt[i * b: (i + 1) * b], tg)
           for i in range(n)]
    for k, name in enumerate(("found", "slot", "vals", "punted")):
        mine = torch.cat([getattr(r, name) for r in got]).numpy()
        assert np.array_equal(mine.view(np.uint32) if mine.dtype == np.int32 else mine,
                              ref[k].view(np.uint32) if ref[k].dtype == np.int32 else ref[k]), name
    # a lane punts iff C earlier lanes of its shard share its owner
    owner = np.asarray(t_table.shard_owner([q[:, 0], q[:, 1]], n)).reshape(n, b)
    pos = np.array([[(row[:k] == row[k]).sum() for k in range(b)] for row in owner])
    assert np.array_equal(ref[3].reshape(n, b), pos >= C)
    assert ref[3].any() == (case == "skew" and C < b) or case == "balanced"


def test_summed_stats_wrap_like_psum():
    parts = [torch.tensor([0xFFFFFFF0, 3], dtype=torch.int64),
             torch.tensor([0x20, 0xFFFFFFFF], dtype=torch.int64)]
    want = (np.array([0xFFFFFFF0, 3], np.uint32) + np.array([0x20, 0xFFFFFFFF], np.uint32))
    assert np.array_equal(t_sharded._sum_stats(parts).numpy(), want.astype(np.int64))


def test_qos_refuses_a_sharded_geometry():
    for kernel, geom, mk in ((t_qos_kernel, TQGeom(64, axis="shard", n_shards=2), torch.zeros),
                             (j_qos_kernel, JQGeom(64, axis="shard", n_shards=2), np.zeros)):
        with pytest.raises(ValueError, match="chip-local"):
            kernel(mk(4), mk(4), mk(4), None, geom, 0)


# ---------------------------------------------------------------- clusters

def deploy(cl, n: int, pppoe: bool = False):
    """The same control-plane writes on either package's cluster."""
    cl.set_server_config_all(SERVER_MAC, ip_to_u32("10.0.0.1"))
    cl.add_pool_all(1, ip_to_u32("10.0.0.0"), 24, ip_to_u32("10.0.0.1"), lease_time=3600)
    cl.add_pool_all(2, ip_to_u32("10.1.0.0"), 24, ip_to_u32("10.1.0.1"), lease_time=7200)
    for i in range(N_MACS):
        cl.add_subscriber(mac(i), pool_id=1, ip=ip_to_u32("10.0.0.10") + i,
                          lease_expiry=NOW + (-5 if i == N_MACS - 1 else 600))
    owners = cl.add_subscribers_bulk(BULK_BASE + np.arange(40, dtype=np.uint64), pool_ids=2,
                                     ips=ip_to_u32("10.1.0.10") + np.arange(40),
                                     lease_expiries=NOW + 900)
    cl.add_vlan_subscriber(100, 7, pool_id=1, ip=ip_to_u32("10.0.0.200"), lease_expiry=NOW + 600)
    cl.add_circuit_id_subscriber(b"olt-3/1/7", pool_id=1, ip=ip_to_u32("10.0.0.201"),
                                 lease_expiry=NOW + 600)
    flows = []
    for k, ip in enumerate(FS):
        cl.allocate_nat(ip, NOW)
        _, got = cl.handle_new_flow(ip, REMOTE, 40000 + k, 443, 17, 200, NOW)
        flows.append(got)
    cl.set_qos(FS[1], down_bps=8_000, up_bps=8_000, down_burst=300, up_burst=300)
    cl.add_spoof_binding(mac(2), FS[2], MODE_STRICT)
    cl.set_gardened(FS[3], True)
    cl.allow_garden_destination(PORTAL, 80, 6)
    if pppoe:
        cl.pppoe_session_up(SimpleNamespace(session_id=0x51, client_mac=mac(5),
                                            assigned_ip=ip_to_u32("10.32.0.5")))
        cl.allocate_nat(ip_to_u32("10.32.0.5"), NOW)
        cl.arm_tap(FS[0], 77)
        cl.set_route(FS[2], bytes.fromhex("024757000001"), 1)
    return SimpleNamespace(owners=np.asarray(owners), flows=flows)


def _pair(n: int, **kw):
    jc = j_sharded.ShardedCluster(n, batch_per_shard=B_SHARD, sub_nbuckets=64, vlan_nbuckets=64,
                                  cid_nbuckets=64, nat_sessions_nbuckets=64, qos_nbuckets=64,
                                  spoof_nbuckets=64, **kw)
    tc = t_sharded.ShardedCluster(n, batch_per_shard=B_SHARD, sub_nbuckets=64, vlan_nbuckets=64,
                                  cid_nbuckets=64, nat_sessions_nbuckets=64, qos_nbuckets=64,
                                  spoof_nbuckets=64, device="cpu", **kw)
    pppoe = kw.get("pppoe_enabled", False)
    dj, dt = deploy(jc, n, pppoe), deploy(tc, n, pppoe)
    assert np.array_equal(dj.owners, dt.owners) and dj.flows == dt.flows
    return SimpleNamespace(t=tc, j=jc, n=n, flows=dt.flows)


@pytest.fixture(scope="module")
def c8():
    return _pair(8)


@pytest.fixture(scope="module")
def c2():
    return _pair(2, pppoe_enabled=True, edge_enabled=True)


def assert_same_tables(p):
    ref = jax.tree_util.tree_map(np.asarray, p.j.tables)
    for i in range(p.n):
        assert_tuple_equal(convert.tables_to_numpy(p.t.tables[i]),
                           jax.tree_util.tree_map(lambda a: a[i], ref), f"shard{i}")


def assert_same_out(t: dict, j: dict):
    assert set(t) == set(j)
    for k, v in j.items():
        assert np.array_equal(np.asarray(t[k]).astype(np.int64),
                              np.asarray(v).astype(np.int64)), k


def telemetry_counts(cl) -> dict:
    s = cl.telemetry.snapshot()
    for shard in s["per_shard"]:
        del shard["stages"]
    del s["merged_stages"]
    return s


def both_step(p, pkt, length, fa, now_s, now_us):
    t = p.t.step(pkt, length, fa, now_s, now_us)
    j = p.j.step(pkt, length, fa, now_s, now_us)
    assert_same_out(t, j)
    assert_same_tables(p)
    assert telemetry_counts(p.t) == telemetry_counts(p.j)
    return t


def batch(p, lanes: dict):
    """{row: frame} -> pkt, length, from_access (all from the access side
    unless the frame is given as (frame, False))."""
    Bt = p.n * B_SHARD
    pkt = np.zeros((Bt, L), dtype=np.uint8)
    length = np.zeros((Bt,), dtype=np.uint32)
    fa = np.ones((Bt,), dtype=bool)
    for row, f in lanes.items():
        f, fa[row] = f if isinstance(f, tuple) else (f, True)
        pkt[row, : len(f)] = np.frombuffer(f, dtype=np.uint8)
        length[row] = len(f)
    return pkt, length, fa


def flow(k: int, size: int = 200, dst=REMOTE, sport=None, src=None) -> bytes:
    return F.udp_packet(mac(k), SERVER_MAC, FS[k] if src is None else src, dst,
                        40000 + k if sport is None else sport, 443, b"u" * (size - 42))


def aff(p, ip: int) -> int:
    o = p.t.affinity_shard_ip(ip)
    assert o == p.j.affinity_shard_ip(ip)
    return o


def test_owner_routing_matches_reference(c8):
    for cl_t, cl_j in ((c8.t, c8.j),):
        for i in range(N_MACS):
            assert cl_t.dhcp_sub_shard(mac(i)) == cl_j.dhcp_sub_shard(mac(i))
        for s, c in ((100, 7), (1, 2), (4095, 4095)):
            assert cl_t.dhcp_vlan_shard(s, c) == cl_j.dhcp_vlan_shard(s, c)
        for cid in (b"olt-3/1/7", b"x", b"z" * 40):
            assert cl_t.dhcp_cid_shard(cid) == cl_j.dhcp_cid_shard(cid)
        for ip in FS:
            assert cl_t.affinity_shard_ip(ip) == cl_j.affinity_shard_ip(ip)
        assert cl_t.pub_ip_map() == cl_j.pub_ip_map()
        assert cl_t.pending_dirty() == cl_j.pending_dirty()


def test_discover_answered_from_any_shard(c8):
    p = c8
    b = B_SHARD
    lanes = {}
    for s in range(p.n):  # every shard asks for subscribers of every owner
        for k in range(3):
            lanes[s * b + k] = F.discover_frame(mac((5 * s + k + 4) % (N_MACS - 1)), 0x100 + s)
        lanes[s * b + 3] = F.discover_frame(bulk_mac(s), 0x200 + s)
    lanes[1 * b + 4] = F.discover_frame(mac(200), 0x301, vlans=[100, 7])
    lanes[2 * b + 4] = F.discover_frame(mac(201), 0x302, giaddr=ip_to_u32("10.9.9.9"),
                                        circuit_id=b"olt-3/1/7", pad=320)
    lanes[3 * b + 4] = F.discover_frame(mac(N_MACS - 1), 0x303)  # lease expired
    lanes[3 * b + 5] = F.discover_frame(mac(250), 0x304)  # unknown client
    # shard 6's region asks 10 times for MACs of one owner: capacity 8 at
    # b = 16 over 8 shards, so its last two lanes punt (PASS)
    cached = [mac(i) for i in range(N_MACS - 1)] + [bulk_mac(k) for k in range(40)]
    by_owner = {}
    for m in cached:
        by_owner.setdefault(p.t.dhcp_sub_shard(m), []).append(m)
    same = max(by_owner.values(), key=len)[:10]
    assert len(same) == 10 and t_table.exchange_capacity(b, p.t.geom_sharded.dhcp.sub) == 8
    for k, m in enumerate(same):
        lanes[6 * b + k] = F.discover_frame(m, 0x400 + k)
    # flow lanes on each subscriber's affinity shard, one on a wrong shard
    o = [aff(p, ip) for ip in FS]
    lanes[o[0] * b + 10] = flow(0)  # SNAT
    lanes[o[1] * b + 11] = flow(1)  # QoS: the first passes
    lanes[o[1] * b + 12] = flow(1)  # ... the second drops
    lanes[o[2] * b + 13] = flow(2, src=FS[2] + 50)  # spoofed source: strict binding drops
    lanes[o[3] * b + 14] = flow(3)  # gardened, not an allowed destination
    lanes[o[0] * b + 15] = flow(0, sport=41000)  # a new flow punts
    wrong = (o[0] + 1) % p.n
    lanes[wrong * b + 15] = flow(0)  # wrong shard: PASS
    pkt, length, fa = batch(p, lanes)
    out = both_step(p, pkt, length, fa, NOW, 0)
    v = out["verdict"]
    assert (v[[s * b + k for s in range(p.n) for k in range(4)]] == 2).all()
    assert v[1 * b + 4] == 2 and v[2 * b + 4] == 2 and v[3 * b + 4] == 0 and v[3 * b + 5] == 0
    assert list(v[6 * b: 6 * b + 10]) == [2] * 8 + [0] * 2
    assert v[o[0] * b + 10] == 3 and v[o[1] * b + 11] == 3 and v[o[1] * b + 12] == 1
    assert v[o[2] * b + 13] == 1
    assert v[o[3] * b + 14] == 1
    assert v[o[0] * b + 15] == 0 and out["nat_punt"][o[0] * b + 15]
    assert v[wrong * b + 15] == 0


def test_late_subscriber_answered_by_every_shard(c8):
    """The drain of every shard comes before any shard's lookups: a row
    added on its owner is seen by all eight shards in the same step."""
    p = c8
    pkt, length, fa = batch(p, {})
    both_step(p, pkt, length, fa, NOW, 0)  # the tables are on the device before the write
    late = bytes.fromhex("02c0ffeeff99")
    for cl in (p.t, p.j):
        cl.add_subscriber(late, pool_id=1, ip=ip_to_u32("10.0.0.199"), lease_expiry=NOW + 600)
    pkt, length, fa = batch(p, {s * B_SHARD: F.discover_frame(late, 0x500 + s)
                                for s in range(p.n)})
    out = both_step(p, pkt, length, fa, NOW + 1, 100)
    assert int((out["verdict"] == 2).sum()) == p.n


def test_dhcp_only_lane(c8):
    p = c8
    for cl in (p.t, p.j):
        cl.touch_lease(mac(7), NOW + 9999)
        cl.remove_subscriber(mac(8))
    lanes = {s * B_SHARD + k: F.discover_frame(mac(7 + k), 0x600 + s) for s in range(p.n)
             for k in range(2)}
    pkt, length, _ = batch(p, lanes)
    t, j = p.t.dhcp_step(pkt, length, NOW + 2), p.j.dhcp_step(pkt, length, NOW + 2)
    assert_same_out(t, j)
    assert_same_tables(p)
    assert telemetry_counts(p.t) == telemetry_counts(p.j)
    assert t["is_reply"].sum() == p.n  # mac(8) is gone: its lanes miss


def _slow_path(frame: bytes):
    return b"\x02" * 64 if len(frame) > 300 else None


def _drain(ring) -> dict:
    out = {"tx": [], "fwd": [], "slow": []}
    for k, pop in (("tx", ring.tx_pop), ("fwd", ring.fwd_pop), ("slow", ring.slow_pop)):
        while (got := pop()) is not None:
            out[k].append(got)
    return out


def test_ring_steering_and_missteer_accounting(c8):
    p = c8
    rings = [cl.make_ring(nframes=512, frame_size=L, depth=64, prefer_native=False)
             for cl in (p.t, p.j)]
    pub_ip, pub_port = p.flows[0]
    down = F.udp_packet(SERVER_MAC, mac(0), REMOTE, pub_ip, 443, pub_port, b"r" * 32)
    frames = [(flow(0), True), (flow(1), True), (down, False), (flow(2), True),
              (F.discover_frame(mac(11), 0x700), True), (flow(0, sport=42000), True),
              (F.discover_frame(mac(251), 0x701), True)]
    outs = []
    for cl, ring in zip((p.t, p.j), rings):
        for f, a in frames:
            assert ring.rx_push(f, from_access=a)
        assert cl.process_ring(ring, NOW + 100, 100_000_000, pkt_slot=L,
                               slow_path=_slow_path) == len(frames)
        outs.append((_drain(ring), ring.stats(), dict(cl.stats)))
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
    assert {k: np.asarray(v).tolist() for k, v in outs[0][2].items()} == \
        {k: np.asarray(v).tolist() for k, v in outs[1][2].items()}
    assert_same_tables(p)
    assert telemetry_counts(p.t) == telemetry_counts(p.j)
    # SNAT x3 and a DNAT; the cached OFFER and the slow path's injected reply
    assert len(outs[0][0]["fwd"]) == 4 and len(outs[0][0]["tx"]) == 2
    # the punted new flow is now a session on its owner shard
    o = aff(p, FS[0])
    assert p.t.nat[o].sessions.lookup([FS[0], REMOTE, (42000 << 16) | 443, 17]) is not None
    # a steered frame assembled into another shard's region: a missteer
    o2 = aff(p, FS[2])
    before = telemetry_counts(p.t)["missteer_total"]
    for cl, ring in zip((p.t, p.j), rings):
        pkt, length, flags = cl._staging(0, L)
        pkt[:] = 0
        length[:] = 0
        flags[:] = 0
        f = flow(2)
        row = ((o2 + 1) % p.n) * B_SHARD
        pkt[row, : len(f)] = np.frombuffer(f, np.uint8)
        length[row], flags[row] = len(f), FLAG_FROM_ACCESS
        ring.rx_push(f, from_access=True)  # the window the retire completes
        got = ring.assemble_sharded(*cl._staging(1, L))
        assert got == 1
        entry = cl._dispatch_ring_batch(ring, pkt, length, flags, 1, NOW + 101, 101_000_000)
        cl._retire(entry, None, None)
    assert telemetry_counts(p.t) == telemetry_counts(p.j)
    assert telemetry_counts(p.t)["missteer_total"] == before + 1
    assert p.t.stats_summary() == p.j.stats_summary()


def test_pipelined_loop_and_fail_closed(c8):
    p = c8
    rings = [cl.make_ring(nframes=256, frame_size=L, depth=64, prefer_native=False)
             for cl in (p.t, p.j)]
    outs = []
    for cl, ring in zip((p.t, p.j), rings):
        got = []
        ring.rx_push(flow(0), from_access=True)
        got.append(cl.process_ring_pipelined(ring, NOW + 102, 102_000_000, pkt_slot=L))
        ring.rx_push(flow(0), from_access=True)
        ring.rx_push(F.discover_frame(mac(12), 0x800), from_access=True)
        got.append(cl.process_ring_pipelined(ring, NOW + 103, 103_000_000, pkt_slot=L,
                                             slow_path=_slow_path))
        # a dispatch error: the window in flight retires first, then the
        # failing window's frames drop, and the error reaches the caller
        ring.rx_push(flow(1), from_access=True)
        fused = cl._dispatch_fused

        def boom(*a, **kw):
            raise RuntimeError("injected dispatch failure")

        cl._dispatch_fused = boom
        try:
            with pytest.raises(RuntimeError, match="injected"):
                cl.process_ring_pipelined(ring, NOW + 104, 104_000_000, pkt_slot=L)
        finally:
            cl._dispatch_fused = fused
        ring.rx_push(flow(0), from_access=True)
        got.append(cl.process_ring_pipelined(ring, NOW + 105, 105_000_000, pkt_slot=L))
        got.append(cl.flush_pipeline())
        outs.append((got, _drain(ring), ring.stats()))
    assert outs[0] == outs[1]
    assert outs[0][0] == [0, 1, 0, 1] and outs[0][2]["drop"] >= 1
    assert_same_tables(p)
    assert telemetry_counts(p.t) == telemetry_counts(p.j)


def test_expire_per_shard(c8):
    p = c8
    now = NOW + 400  # the flows refreshed at +100..+105 are idle past 120 s
    for cl in (p.t, p.j):
        cl.quiesce()
    assert [p.t.nat[i].sessions.count for i in range(p.n)] == \
        [p.j.nat[i].sessions.count for i in range(p.n)]
    for i in range(p.n):
        assert np.array_equal(p.t.fetch_session_vals(i), np.asarray(p.j.fetch_session_vals(i)))
    got = p.t.expire(now), p.j.expire(now)
    assert got[0] == got[1] >= 4
    for i in range(p.n):
        for name in ("sessions", "reverse"):
            for a, b in zip((getattr(p.t.nat[i], name).keys, getattr(p.t.nat[i], name).used),
                            (getattr(p.j.nat[i], name).keys, getattr(p.j.nat[i], name).used)):
                assert np.array_equal(a, b)
        assert p.t.nat[i].eim == p.j.nat[i].eim
    assert p.t.pending_dirty() == p.j.pending_dirty() > 0
    # the deletions drain with the next step, on every shard
    pkt, length, fa = batch(p, {0: F.discover_frame(mac(3), 0x900)})
    both_step(p, pkt, length, fa, now + 1, 0)


def test_pppoe_and_edge_on_the_cluster(c2):
    p = c2
    b = B_SHARD
    sess_ip = ip_to_u32("10.32.0.5")
    inner = F.udp_packet(mac(5), SERVER_MAC, sess_ip, REMOTE, 41000, 53, b"q" * 40)[14:]
    up = F.pppoe_session_frame(SERVER_MAC, mac(5), 0x51, 0x0021, inner, vlans=[10, 20])
    lanes = {aff(p, sess_ip) * b + 0: up,
             aff(p, FS[0]) * b + 1: flow(0),  # mirrored
             aff(p, FS[2]) * b + 2: flow(2),  # routed
             0 * b + 3: F.discover_frame(mac(9), 0xA00), 1 * b + 3: F.discover_frame(mac(10), 0xA01),
             1 * b + 4: F.pppoe_padi_frame(mac(6))}
    pkt, length, fa = batch(p, lanes)
    out = both_step(p, pkt, length, fa, NOW, 0)
    assert out["mirror"][aff(p, FS[0]) * b + 1] == 77
    assert out["verdict"][aff(p, sess_ip) * b] == 0  # punted: its flow is new
    assert out["nat_punt"][aff(p, sess_ip) * b]
    # the punt made the session's flow on its shard: now it forwards
    for cl in (p.t, p.j):
        cl._punt_new_flow(up, NOW)
    out = both_step(p, pkt, length, fa, NOW + 1, 1000)
    assert out["verdict"][aff(p, sess_ip) * b] == 3
    # an existing session: handle_new_flow returns its mapping, changing nothing
    pub_ip, pub_port = p.t.nat[aff(p, sess_ip)].handle_new_flow(sess_ip, REMOTE, 41000, 53,
                                                                 17, 82, NOW)
    down = F.udp_packet(SERVER_MAC, mac(5), REMOTE, pub_ip, 53, pub_port, b"a" * 40)
    pkt, length, fa = batch(p, {aff(p, sess_ip) * b: (down, False)})
    out = both_step(p, pkt, length, fa, NOW + 2, 2000)
    assert out["verdict"][aff(p, sess_ip) * b] == 3  # DNAT + PPPoE encap


def test_dryrun_multichip_on_the_port():
    snap = __import__("bng_tpu_torch.entry", fromlist=["x"]).dryrun_multichip(8, device="cpu",
                                                                           nbuckets=64)
    # the reference's dryrun at the same settings: 7 steps, 32 summed hits,
    # one slow-path PASS (the wrong-shard lane), no missteer or NAT punt
    assert (snap["steps"], snap["psum_dhcp_hits"], snap["pass_total"], snap["missteer_total"],
            snap["nat_punt_total"]) == (7, 32, 1, 0, 0)
