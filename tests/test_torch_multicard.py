"""The BNG on several cards, held on the CPU.

The shards of a `ShardedCluster` go to the cards of its shard-to-device
map, and a map that names several devices takes the copying exchange
(`parallel/exchange.CopyingExchange`). The CPU stands in for the cards:
a map of `cpu:0 .. cpu:N-1` names N devices (every one the host memory),
so the cluster picks the copying exchange and runs every copy it would
run between cards. The JAX clusters run on the virtual CPU devices
tests/conftest.py forces.

- Placement (`place_shards`), checked on `torch.device("cuda", i)`
  objects without allocating: one card, at least N cards, 1 < C < N, an
  explicit list, and a list naming a card that is not visible (raises).
- The express lane's card (`pick_express_device`, the reference's
  `_pick_express_device`) for None / -1 / i at one and two cards, and an
  index past the cards (raises); the CLI shares the engine's card when
  `--device cuda:i` names one or `--wire-if` bypasses the scheduler.
- The bulk lane's replica of the DHCP tables shares no storage with the
  authoritative tables.
- `sharded_lookup` through the copying exchange at N = 2 and 4, a
  balanced batch and a skewed one whose lanes past the capacity punt,
  against the reference's lookup under `shard_map`.
- The sharded step and the DHCP-only step at N = 2 and 4 through the
  copying exchange: a balanced batch, a skewed batch (punts at N = 4: at
  N = 2 the capacity is the whole region), a subscriber added after the
  first step; outputs, summed stats, telemetry and every shard's table
  words equal the `DeviceLocalExchange` cluster's and the JAX mesh
  program's.
- A sharded checkpoint restores onto another device map (several
  devices to one, and back) with the same tables; the swap's standby and
  `clone_empty` keep the live cluster's map.

Tolerance: bit-exact (the same words, bytes and counts).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bng_tpu.ops import table as j_table
from bng_tpu.parallel import sharded as j_sharded
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.cli import _express_index
from bng_tpu_torch.control.nat import NATManager
from bng_tpu_torch.ops import table as t_table
from bng_tpu_torch.parallel import sharded as t_sharded
from bng_tpu_torch.parallel.exchange import CopyingExchange, DeviceLocalExchange, exchange_for
from bng_tpu_torch.parallel.sharded import place_shards
from bng_tpu_torch.runtime import checkpoint as ck
from bng_tpu_torch.runtime import ops
from bng_tpu_torch.runtime.engine import Engine
from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler, pick_express_device
from bng_tpu_torch.runtime.tables import FastPathTables
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_sharded import (
    B_SHARD, FS, N_MACS, NOW, _lookup_case, assert_same_out, batch, bulk_mac, deploy, flow, mac,
    telemetry_counts,
)
from test_torch_stages import assert_tuple_equal

pytestmark = pytest.mark.torch_port

CUDA = torch.device("cuda")


def cards(n: int) -> list:
    """n devices that are all the host memory: the CPU's stand-in for n cards."""
    return [torch.device("cpu", i) for i in range(n)]


# ------------------------------------------------------------ placement

@pytest.mark.parametrize("n, visible, want", [
    (8, 1, [CUDA] * 8),  # one card: every shard shares it
    (4, 8, [torch.device("cuda", i) for i in range(4)]),  # one shard a card
    (4, 4, [torch.device("cuda", i) for i in range(4)]),
    (8, 3, [torch.device("cuda", i % 3) for i in range(8)]),  # dealt round the cards
    (2, 0, [CUDA] * 2),
])
def test_placement_rule(n, visible, want):
    assert place_shards(n, CUDA, visible=visible) == want


def test_placement_of_a_named_card_the_cpu_and_an_explicit_list():
    one = torch.device("cuda", 1)
    assert place_shards(4, one, visible=4) == [one] * 4
    assert place_shards(3, "cpu", visible=8) == [torch.device("cpu")] * 3
    listed = [torch.device("cuda", 1), torch.device("cuda", 0)]
    assert place_shards(2, CUDA, devices=listed, visible=2) == listed
    assert place_shards(2, CUDA, devices=cards(2)) == cards(2)


def test_placement_refuses_an_absent_card_and_a_short_list():
    with pytest.raises(ValueError, match=r"cuda:2 for 2 shards, but 2 card\(s\) are visible"):
        place_shards(2, CUDA, devices=[torch.device("cuda", 0), torch.device("cuda", 2)],
                     visible=2)
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        place_shards(2, CUDA, devices=cards(3))


def test_exchange_follows_the_map():
    assert isinstance(exchange_for(["cpu"] * 4), DeviceLocalExchange)
    assert isinstance(exchange_for(cards(2)), CopyingExchange)
    with pytest.raises(ValueError, match="several devices"):
        DeviceLocalExchange(cards(2))
    cl = t_sharded.ShardedCluster(2, device="cpu", devices=cards(2))
    assert isinstance(cl.exchange, CopyingExchange) and cl.shard_devices == cards(2)
    assert isinstance(t_sharded.ShardedCluster(2, device="cpu").exchange, DeviceLocalExchange)
    # clone_empty keeps the map; a re-shard deals the same devices round
    assert cl.clone_empty().shard_devices == cards(2)
    assert cl.clone_empty(3).shard_devices == [torch.device("cpu", i % 2) for i in range(3)]


@pytest.mark.parametrize("index, n_cards, want", [
    (None, 1, None),  # one card: the lane shares it
    (None, 2, torch.device("cuda", 1)),  # the second card
    (None, 0, None),
    (-1, 1, None),  # share, forced
    (-1, 2, None),
    (0, 1, torch.device("cuda", 0)),
    (0, 2, torch.device("cuda", 0)),
    (1, 2, torch.device("cuda", 1)),
])
def test_express_device_pick(index, n_cards, want):
    assert pick_express_device(index, n_cards) == want


@pytest.mark.parametrize("index, n_cards", [(1, 1), (2, 2), (0, 0)])
def test_express_device_past_the_cards_raises(index, n_cards):
    with pytest.raises(ValueError, match=f"{n_cards} visible"):
        pick_express_device(index, n_cards)


@pytest.mark.parametrize("device, bypassed, want", [
    (CUDA, False, None),  # the bare card: the scheduler picks
    (torch.device("cuda", 0), False, -1),  # --device cuda:i: one card for everything
    (torch.device("cuda", 1), False, -1),
    (CUDA, True, -1),  # --wire-if: the drive loop bypasses the scheduler
    (torch.device("cpu"), False, None),
])
def test_cli_express_index(device, bypassed, want):
    assert _express_index(device, bypassed) == want


def _storages(dhcp) -> set:
    leaves = [*dhcp.sub, *dhcp.vlan, *dhcp.cid, dhcp.pools, dhcp.server]
    return {t.untyped_storage().data_ptr() for t in leaves}


def test_bulk_replica_is_a_fresh_copy():
    fp = FastPathTables(sub_nbuckets=64, vlan_nbuckets=16, cid_nbuckets=16, max_pools=4)
    fp.set_server_config(bytes.fromhex("02aabbccdd01"), ip_to_u32("10.0.0.1"))
    fp.add_pool(1, ip_to_u32("10.0.0.0"), 24, ip_to_u32("10.0.0.1"), lease_time=3600)
    fp.add_subscriber(mac(1), pool_id=1, ip=ip_to_u32("10.0.0.9"), lease_expiry=NOW + 600)
    eng = Engine(fp, NATManager(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=64,
                                sub_nat_nbuckets=16), batch_size=8, pkt_slot=512, device="cpu")
    sched = TieredScheduler(eng, SchedulerConfig(express_batch=8, bulk_batch=8))
    assert sched._express_dev is None  # a CPU engine: the lane shares its device
    for _ in range(2):  # at build, and after a resync rebuilt the authority
        sched._ensure_bulk_replica()
        rep, auth = sched._bulk_dhcp, eng.tables.dhcp
        assert not _storages(rep) & _storages(auth)
        for a, b in zip((*rep.sub, rep.pools), (*auth.sub, auth.pools)):
            assert torch.equal(a, b)
        eng.resync_tables()


# ------------------------------------------------------------- lookups

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["balanced", "skew"])
def test_copying_lookup_matches_reference(n, case):
    jt, tt, q, b, _ = _lookup_case(n, case)
    # capacity factor 1: the skewed lanes punt at N = 2 too
    factor = 1.0
    jg = j_table.TableGeom(64, 8, axis=j_sharded.AXIS, n_shards=n, capacity_factor=factor)
    tg = t_table.TableGeom(64, 8, axis=t_sharded.AXIS, n_shards=n, capacity_factor=factor)
    C = t_table.exchange_capacity(b, tg)
    assert C == j_table.exchange_capacity(b, jg) and C < b

    def local(tabs1, qq):
        r = j_table.lookup(jax.tree.map(lambda x: x[0], tabs1), qq, jg)
        return r.found, r.slot, r.vals, r.punted

    f = jax.jit(j_sharded._shard_map(local, mesh=j_sharded.make_mesh(n),
                                     in_specs=(P(j_sharded.AXIS), P(j_sharded.AXIS)),
                                     out_specs=(P(j_sharded.AXIS),) * 4))
    ref = [np.asarray(a) for a in f(jax.tree.map(lambda *xs: jax.numpy.stack(xs),
                                                 *[s.device_state() for s in jt]),
                                    jax.numpy.asarray(q))]
    devs = cards(n)
    states = tuple(s.device_state(d) for s, d in zip(tt, devs))
    sent = []

    class Watched(CopyingExchange):
        def send(self, src, req):
            rows = super().send(src, req)
            sent.append(all(r.untyped_storage().data_ptr() != req.untyped_storage().data_ptr()
                            for r in rows))
            return rows

    ex = Watched(devs)
    qt = torch.from_numpy(q.view(np.int32))
    got = [t_table.lookup(t_table.ShardedTable(states, i, ex), qt[i * b: (i + 1) * b], tg)
           for i in range(n)]
    assert sent == [True] * n  # one send a source shard, each a copy
    for k, name in enumerate(("found", "slot", "vals", "punted")):
        mine = torch.cat([getattr(r, name) for r in got]).numpy()
        assert np.array_equal(mine.view(np.uint32) if mine.dtype == np.int32 else mine,
                              ref[k].view(np.uint32) if ref[k].dtype == np.int32 else ref[k]), name
    if case == "skew":  # every key one owner: the lanes past C punt
        assert ref[3].reshape(n, b)[:, C:].all() and not ref[3].reshape(n, b)[:, :C].any()


# ------------------------------------------------------------ clusters

KW = dict(batch_per_shard=B_SHARD, sub_nbuckets=64, vlan_nbuckets=64, cid_nbuckets=64,
          nat_sessions_nbuckets=64, qos_nbuckets=64, spoof_nbuckets=64)


@pytest.fixture(scope="module", params=[2, 4])
def trio(request):
    """The reference's cluster, the port's on one device and the port's
    over n devices (the copying exchange), with the same writes."""
    n = request.param
    jc = j_sharded.ShardedCluster(n, **KW)
    one = t_sharded.ShardedCluster(n, device="cpu", **KW)
    spread = t_sharded.ShardedCluster(n, device="cpu", devices=cards(n), **KW)
    assert isinstance(one.exchange, DeviceLocalExchange)
    assert isinstance(spread.exchange, CopyingExchange)
    dj, do, ds = deploy(jc, n), deploy(one, n), deploy(spread, n)
    assert np.array_equal(dj.owners, do.owners) and np.array_equal(do.owners, ds.owners)
    assert dj.flows == do.flows == ds.flows
    return SimpleNamespace(j=jc, one=one, spread=spread, n=n)


def _same_tables(p) -> None:
    ref = jax.tree_util.tree_map(np.asarray, p.j.tables)
    for cl in (p.one, p.spread):
        for i in range(p.n):
            assert_tuple_equal(convert.tables_to_numpy(cl.tables[i]),
                               jax.tree_util.tree_map(lambda a: a[i], ref), f"shard{i}")


def step_all(p, pkt, length, fa, now_s, now_us) -> dict:
    j = p.j.step(pkt, length, fa, now_s, now_us)
    outs = [cl.step(pkt, length, fa, now_s, now_us) for cl in (p.one, p.spread)]
    for out in outs:
        assert_same_out(out, j)
    _same_tables(p)
    assert telemetry_counts(p.spread) == telemetry_counts(p.one) == telemetry_counts(p.j)
    return outs[1]


def aff(p, ip: int) -> int:
    o = p.spread.affinity_shard_ip(ip)
    assert o == p.j.affinity_shard_ip(ip) == p.one.affinity_shard_ip(ip)
    return o


def test_balanced_batch_over_cards(trio):
    p, b = trio, B_SHARD
    lanes = {}
    for s in range(p.n):  # every shard asks for subscribers of every owner
        for k in range(3):
            lanes[s * b + k] = F.discover_frame(mac((5 * s + k + 4) % (N_MACS - 1)), 0x100 + s)
        lanes[s * b + 3] = F.discover_frame(bulk_mac(s), 0x200 + s)
    lanes[1 * b + 4] = F.discover_frame(mac(200), 0x301, vlans=[100, 7])
    lanes[0 * b + 4] = F.discover_frame(mac(201), 0x302, giaddr=ip_to_u32("10.9.9.9"),
                                        circuit_id=b"olt-3/1/7", pad=320)
    lanes[1 * b + 5] = F.discover_frame(mac(N_MACS - 1), 0x303)  # lease expired
    lanes[0 * b + 5] = F.discover_frame(mac(250), 0x304)  # unknown client
    o = [aff(p, ip) for ip in FS]
    lanes[o[0] * b + 10] = flow(0)  # SNAT
    lanes[o[1] * b + 11] = flow(1)  # QoS: the first passes
    lanes[o[1] * b + 12] = flow(1)  # ... the second drops
    lanes[o[2] * b + 13] = flow(2, src=FS[2] + 50)  # spoofed: the strict binding drops
    lanes[o[3] * b + 14] = flow(3)  # gardened, not an allowed destination
    lanes[o[0] * b + 15] = flow(0, sport=41000)  # a new flow punts
    wrong = (o[0] + 1) % p.n
    lanes[wrong * b + 9] = flow(0)  # wrong shard: PASS
    pkt, length, fa = batch(p, lanes)
    out = step_all(p, pkt, length, fa, NOW, 0)
    v = out["verdict"]
    assert (v[[s * b + k for s in range(p.n) for k in range(4)]] == 2).all()
    assert v[1 * b + 4] == 2 and v[0 * b + 4] == 2 and v[1 * b + 5] == 0 and v[0 * b + 5] == 0
    assert v[o[0] * b + 10] == 3 and v[o[1] * b + 11] == 3 and v[o[1] * b + 12] == 1
    assert v[o[2] * b + 13] == 1 and v[o[3] * b + 14] == 1
    assert v[o[0] * b + 15] == 0 and out["nat_punt"][o[0] * b + 15]
    assert v[wrong * b + 9] == 0


def test_skewed_batch_over_cards(trio):
    """Every region asks 10 times for MACs of one owner: at N = 4 the
    exchange capacity is 8 of 16 lanes, so two lanes a region punt (PASS);
    at N = 2 it is the whole region."""
    p, b = trio, B_SHARD
    cached = [mac(i) for i in range(N_MACS - 1)] + [bulk_mac(k) for k in range(40)]
    by_owner = {}
    for m in cached:
        by_owner.setdefault(p.spread.dhcp_sub_shard(m), []).append(m)
    same = max(by_owner.values(), key=len)[:10]
    assert len(same) == 10
    lanes = {s * b + k: F.discover_frame(m, 0x400 + 16 * s + k)
             for s in range(p.n) for k, m in enumerate(same)}
    pkt, length, fa = batch(p, lanes)
    out = step_all(p, pkt, length, fa, NOW + 1, 10)
    C = t_table.exchange_capacity(b, p.spread.geom_sharded.dhcp.sub)
    assert C == (8 if p.n == 4 else 16)
    for s in range(p.n):
        v = list(out["verdict"][s * b: s * b + 10])
        assert v == [2] * min(C, 10) + [0] * (10 - min(C, 10)), (s, v)


def test_late_subscriber_over_cards(trio):
    p = trio
    pkt, length, fa = batch(p, {})
    step_all(p, pkt, length, fa, NOW + 2, 20)  # the tables are up before the write
    late = bytes.fromhex("02c0ffeeff98")
    for cl in (p.j, p.one, p.spread):
        cl.add_subscriber(late, pool_id=1, ip=ip_to_u32("10.0.0.198"), lease_expiry=NOW + 600)
    pkt, length, fa = batch(p, {s * B_SHARD: F.discover_frame(late, 0x500 + s)
                                for s in range(p.n)})
    out = step_all(p, pkt, length, fa, NOW + 3, 30)
    assert int((out["verdict"] == 2).sum()) == p.n


def test_dhcp_only_step_over_cards(trio):
    p = trio
    for cl in (p.j, p.one, p.spread):
        cl.touch_lease(mac(7), NOW + 9999)
        cl.remove_subscriber(mac(8))
    lanes = {s * B_SHARD + k: F.discover_frame(mac(7 + k), 0x600 + s) for s in range(p.n)
             for k in range(2)}
    pkt, length, _ = batch(p, lanes)
    j = p.j.dhcp_step(pkt, length, NOW + 4)
    for cl in (p.one, p.spread):
        assert_same_out(cl.dhcp_step(pkt, length, NOW + 4), j)
    _same_tables(p)
    assert telemetry_counts(p.spread) == telemetry_counts(p.one) == telemetry_counts(p.j)


# ------------------------------------------------- checkpoint and swap

def _driven(devices):
    cl = t_sharded.ShardedCluster(2, device="cpu", devices=devices, **KW)
    deploy(cl, 2)
    p = SimpleNamespace(n=2)
    lanes = {0: flow(0), 1: flow(1), B_SHARD: flow(2), B_SHARD + 1: flow(3),
             2: F.discover_frame(mac(3), 0x700)}
    pkt, length, fa = batch(p, lanes)
    cl.step(pkt, length, fa, NOW + 5, 50)  # NAT counters and QoS tokens written
    return cl


def _words(cl) -> list:
    return [convert.tables_to_numpy(t) for t in cl.tables]


@pytest.mark.parametrize("src, dst", [(cards(2), None), (None, cards(2))],
                         ids=["cards_to_one", "one_to_cards"])
def test_sharded_checkpoint_restores_onto_another_map(src, dst):
    live = _driven(src)
    data = ck.encode_checkpoint(ck.build_sharded_checkpoint(live, 1, NOW + 6))
    target = t_sharded.ShardedCluster(2, device="cpu", devices=dst, **KW)
    ck.restore_sharded_checkpoint(ck.decode_checkpoint(data), target, now=NOW + 6)
    assert target.shard_devices == (dst or [torch.device("cpu")] * 2)
    for i, (a, b) in enumerate(zip(_words(target), _words(live))):
        assert_tuple_equal(a, b, f"shard{i}")


def test_sharded_swap_standby_takes_the_live_map():
    live = _driven(cards(2))
    comps = {"cluster": live}
    rep = ops.sharded_blue_green_swap(comps, clock=lambda: float(NOW + 7))
    assert rep["outcome"] == "ok", rep
    standby = comps["cluster"]
    assert standby is not live and standby.shard_devices == cards(2)
    assert isinstance(standby.exchange, CopyingExchange)
    for i, (a, b) in enumerate(zip(_words(standby), _words(live))):
        assert_tuple_equal(a, b, f"shard{i}")
