"""The port's replicated store (`bng_tpu_torch/control/crdt.py`) and peer
pool (`bng_tpu_torch/control/peerpool.py`) against the JAX package's.

Both packages run the same operation script on pinned clocks (a
`CLSetStore` defaults to `time.time_ns` and a `DistributedStore` to
`time.time`, so every store here is given a clock that only the script
advances):

- `CLSetStore`: puts, re-puts, deletes, a delete of an absent key,
  concurrent writes at one timestamp broken by node id, digests,
  `missing_from` / `dominated_by_local`, merges in both directions, watch
  callbacks, tombstone pruning, and a three-node anti-entropy round give
  the same entries (causal length, timestamp, node, value) and the same
  callbacks.
- `DistributedStore`: the memory, read and write modes (a read node
  refuses writes with `ReadOnlyNodeError` and still takes merges), the
  heartbeats, `members()` with a TTL, `join_member_ring`, rendezvous
  ownership, and `tick()` against a dead peer give the same state.
- `PeerPool`: three peers over an in-process transport allocate, forward,
  fail over when an owner dies, health-check it back, reconcile a
  partition's double allocation and release, with the same addresses,
  stats and statuses.

Tolerance: exact (dicts and lists).
"""

from types import SimpleNamespace

import pytest

from bng_tpu.control import crdt as j_crdt
from bng_tpu.control import peerpool as j_pp
from bng_tpu_torch.control import crdt as t_crdt
from bng_tpu_torch.control import peerpool as t_pp

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(name="jax", crdt=j_crdt, pp=j_pp)
PORT = SimpleNamespace(name="port", crdt=t_crdt, pp=t_pp)


class Clock:
    def __init__(self, t: float = 1_753_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def ns(self) -> int:
        return int(self.t * 1e9)


def _entries(store) -> dict:
    return {k: (e.cl, e.ts, e.node, e.value) for k, e in sorted(store._entries.items())}


def _clset_script(p) -> list:
    clk = Clock()
    a = p.crdt.CLSetStore("node-a", clock_ns=clk.ns)
    b = p.crdt.CLSetStore("node-b", clock_ns=clk.ns)
    c = p.crdt.CLSetStore("node-c", clock_ns=clk.ns)
    seen = []
    a.watch("pool/", lambda k, v: seen.append(("a", k, v)))
    b.watch("", lambda k, v: seen.append(("b", k, v)))
    log = []
    for i in range(5):
        a.put(f"pool/{i}", f"sub-{i}".encode())
        clk.t += 0.001
    a.put("pool/1", "sub-1b")  # a str value is stored as bytes
    log.append(a.delete("pool/2"))
    log.append(a.delete("pool/2"))  # already a tombstone
    log.append(a.delete("nope"))
    # concurrent writes at one timestamp: the node id breaks the tie
    a.put("lease/x", b"from-a")
    b.put("lease/x", b"from-b")
    b.put("lease/y", b"only-b")
    clk.t += 0.001
    log.append((a.digest(), b.digest()))
    log.append((sorted(a.missing_from(b.digest())), sorted(a.dominated_by_local(b.digest()))))
    log.append(a.sync_with(b))
    log.append(b.sync_with(a))
    log.append(c.sync_with(a))
    log.append((_entries(a), _entries(b), _entries(c)))
    log.append((a.list("pool/"), b.get("lease/x"), c.get("pool/2")))
    # a delete on b wins over a's older put after a merge
    clk.t += 1.0
    b.delete("pool/3")
    log.append(a.merge_entries(b.entries_for(["pool/3", "lease/y", "absent"])))
    log.append((a.key_count(), a.tombstone_count(), b.tombstone_count()))
    clk.t += 10.0
    log.append(a.prune_tombstones(int(5e9), now_ns=clk.ns()))
    log.append(b.prune_tombstones(int(60e9), now_ns=clk.ns()))
    log.append((_entries(a), _entries(b)))
    log.append(seen)
    with pytest.raises(ValueError):
        p.crdt.CLSetStore("")
    return log


def test_clset_store_sequence_equals_reference():
    ref, got = _clset_script(JAX), _clset_script(PORT)
    assert got == ref
    assert ref[-4] >= 1 and ref[-3] == 0  # pruned past 5 s, kept inside 60 s


def _dstore_script(p) -> list:
    clk = Clock()
    m = p.crdt
    w1 = m.DistributedStore("bng-1", mode=m.MODE_WRITE, clock=clk, peer_ttl=30.0,
                            tombstone_ttl=60.0)
    w2 = m.DistributedStore("bng-2", mode=m.MODE_WRITE, clock=clk, peer_ttl=30.0,
                            tombstone_ttl=60.0)
    r = m.DistributedStore("olt-1", mode=m.MODE_READ, clock=clk, node_name="OLT")
    mem = m.DistributedStore("dev", clock=clk)

    class Dead:
        def digest(self):
            raise ConnectionError("peer down")

    w1.add_peer(w2)
    w1.add_peer(Dead())
    w2.add_peer(w1.store)
    r.add_peer(w1)
    log = []
    with pytest.raises(ValueError):
        m.DistributedStore("x", mode="bogus")
    for i in range(6):
        w1.put(f"pool/10.0.0.{i}", f"sub-{i}".encode())
        w2.put(f"pool/10.0.1.{i}", f"sub-{i}".encode())
        clk.t += 0.5
    mem.put("k", b"v")
    with pytest.raises(m.ReadOnlyNodeError):
        r.put("pool/10.0.9.9", b"nope")
    with pytest.raises(m.ReadOnlyNodeError):
        r.delete("pool/10.0.0.1")
    log.append(w1.delete("pool/10.0.0.0"))
    clk.t += 1.0
    log.append((w1.tick(), w2.tick(), r.tick(), mem.tick()))
    log.append((_entries(w1.store), _entries(w2.store), _entries(r.store), _entries(mem.store)))
    log.append({k: vars(v) for k, v in sorted(w1.members().items())})
    w1.join_member_ring()
    w2.join_member_ring()
    log.append((sorted(w1.ring), sorted(w2.ring), r.ring))
    keys = [f"pool/10.0.{i}.{j}" for i in range(2) for j in range(8)]
    log.append([(w1.owner_of(k), w1.owns(k), w2.owns(k), r.owner_of(k), mem.owner_of(k))
                for k in keys])
    # bng-2 falls silent past the TTL: it leaves w1's ring
    clk.t += 45.0
    w1.tick()
    w1.join_member_ring()
    log.append((sorted(w1.ring), {k: v.active for k, v in sorted(w1.members().items())}))
    clk.t += 120.0
    log.append((w1.tick(), w1.store.tombstone_count()))
    return log


def test_distributed_store_sequence_equals_reference():
    assert _dstore_script(PORT) == _dstore_script(JAX)


def _pool_script(p) -> list:
    PeerPool, PoolRange, PoolError = p.pp.PeerPool, p.pp.PoolRange, p.pp.PeerPoolError
    nodes = ["bng-a", "bng-b", "bng-c"]
    down: set[str] = set()
    pools: dict[str, object] = {}

    def transport(node):
        if node in down:
            raise ConnectionError(f"{node} down")
        return pools[node]

    rng = PoolRange(network=0x0A400000, size=40)
    for n in nodes:
        pools[n] = PeerPool(n, nodes, rng, transport=transport, health_failure_threshold=2)
    a, b, c = (pools[n] for n in nodes)
    log = []
    subs = [f"02:00:00:00:{i:02x}:01" for i in range(24)]
    log.append([a.owner_ranked(s) for s in subs[:6]])
    log.append([(a if i % 2 else b).allocate(s) for i, s in enumerate(subs[:12])])
    log.append([c.get(s) for s in subs[:12]])
    log.append([a.allocate(s) for s in subs[:4]])  # idempotent
    # bng-c dies: its subscribers fail over to the next ranked owner
    down.add("bng-c")
    log.append([a.allocate(s) for s in subs[12:18]])
    log.append({n: p_.status() for n, p_ in sorted(pools.items())})
    log.append({k: vars(v) for k, v in sorted(a.peers.items())})
    down.discard("bng-c")
    a.health_check(now=10.0)
    b.health_check(now=10.0)
    log.append({k: vars(v) for k, v in sorted(a.peers.items())})
    # a partition double-allocation: reconcile keeps the owner's
    victim = subs[20]
    ip = c._allocate_local(victim)
    a.allocations[ip] = "02:ff:ff:ff:ff:ff"
    a.by_subscriber["02:ff:ff:ff:ff:ff"] = ip
    log.append((a.reconcile(), c.reconcile()))
    log.append([b.release(s) for s in subs[:6]] + [b.release("nobody")])
    log.append({n: (sorted(p_.allocations.items()), p_.status()) for n, p_ in sorted(pools.items())})
    # every peer down: no owner
    down.update(["bng-a", "bng-b"])
    lone = PeerPool("bng-c", nodes, rng, transport=transport, health_failure_threshold=1)
    for s in subs[:40]:
        try:
            lone.allocate(s)
        except PoolError as e:
            log.append(str(e))
            break
    tiny = PeerPool("solo", ["solo"], PoolRange(network=0x0A500000, size=3))
    got = []
    for s in subs[:5]:
        try:
            got.append(tiny.allocate(s))
        except PoolError as e:
            got.append(str(e))
    log.append(got)
    return log


def test_peer_pool_sequence_equals_reference():
    ref, got = _pool_script(JAX), _pool_script(PORT)
    assert got == ref
