"""Peer-to-peer distributed IP pool — no central server (Demo G).

The port's copy of `bng_tpu/control/peerpool.py` (jax-free), its imports
renamed.

Parity: pkg/pool/peer.go — PeerPool (:23), Allocate owner-or-forward
(:230-368), rendezvous/HRW owner selection + ranked failover
(:723-776), health-check loop (:541-631), HTTP API /allocate /release
/status /get (:633-721; here the transport is injectable — production
rides DCN/HTTP, tests wire peers directly).

The same rendezvous placement decides which chip's HBM shard owns a
subscriber entry (bng_tpu_torch.parallel.hashring is the shared module).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from bng_tpu_torch.parallel.hashring import rendezvous_ranked


class PeerPoolError(Exception):
    pass


@dataclass
class PeerStatus:
    node_id: str
    healthy: bool = True
    last_seen: float = 0.0
    consecutive_failures: int = 0


@dataclass
class PoolRange:
    """The shared range every peer agrees on (peer.go config)."""

    network: int  # host-order base
    size: int  # usable addresses


class PeerPool:
    """One node's view of the shared pool.

    Allocation protocol (peer.go:230-368): the subscriber's owner node is
    the top rendezvous rank among HEALTHY peers; if we are the owner we
    allocate locally, otherwise we forward to the owner. On owner failure
    we fall through the ranked list.
    """

    def __init__(self, node_id: str, peers: list[str], pool: PoolRange,
                 transport: Callable[[str], "PeerPool"] | None = None,
                 health_failure_threshold: int = 3):
        self.node_id = node_id
        self.pool = pool
        self.transport = transport
        self.peers: dict[str, PeerStatus] = {
            p: PeerStatus(p) for p in peers if p != node_id}
        self.health_failure_threshold = health_failure_threshold
        # local slice of the shared pool: ip -> subscriber
        self.allocations: dict[int, str] = {}
        self.by_subscriber: dict[str, int] = {}
        self.stats = {"local_allocs": 0, "forwarded": 0, "failovers": 0,
                      "releases": 0, "conflicts": 0}

    # ---- membership ----
    def _healthy_nodes(self) -> list[str]:
        nodes = [self.node_id]
        nodes += [p.node_id for p in self.peers.values() if p.healthy]
        return sorted(nodes)

    def owner_ranked(self, subscriber_id: str) -> list[str]:
        """Ranked owner list over healthy nodes (peer.go:745-776)."""
        return rendezvous_ranked(self._healthy_nodes(), subscriber_id)

    # ---- the API surface (/allocate /release /get /status) ----
    def allocate(self, subscriber_id: str) -> int:
        """Owner-or-forward with ranked failover (peer.go:230-368)."""
        ranked = self.owner_ranked(subscriber_id)
        last_err: Exception | None = None
        for rank, node in enumerate(ranked):
            if rank > 0:
                self.stats["failovers"] += 1
            if node == self.node_id:
                return self._allocate_local(subscriber_id)
            try:
                peer = self._dial(node)
                self.stats["forwarded"] += 1
                return peer._allocate_local(subscriber_id)
            except (ConnectionError, PeerPoolError) as e:
                self._mark_failure(node)
                last_err = e
        raise PeerPoolError(f"no healthy owner for {subscriber_id}: {last_err}")

    def _allocate_local(self, subscriber_id: str) -> int:
        existing = self.by_subscriber.get(subscriber_id)
        if existing is not None:
            return existing
        # deterministic candidate scan from hash(subscriber), bounded
        # linear probe — the hashring allocation discipline
        # (pkg/nexus/client.go:544-577) applied to the peer's local slice
        from bng_tpu_torch.parallel.hashring import hashring_allocate

        idx = hashring_allocate(subscriber_id, self.pool.size,
                                lambda i: (self.pool.network + 1 + i)
                                not in self.allocations)
        if idx is None and len(self.allocations) < self.pool.size:
            # hash candidates exhausted but the pool isn't: linear sweep
            # (small pools can alias all 1024 hash candidates)
            idx = next((i for i in range(self.pool.size)
                        if (self.pool.network + 1 + i) not in self.allocations),
                       None)
        if idx is None:
            raise PeerPoolError("pool exhausted")
        ip = self.pool.network + 1 + idx
        self.allocations[ip] = subscriber_id
        self.by_subscriber[subscriber_id] = ip
        self.stats["local_allocs"] += 1
        return ip

    def release(self, subscriber_id: str) -> bool:
        ranked = self.owner_ranked(subscriber_id)
        for node in ranked:
            if node == self.node_id:
                return self._release_local(subscriber_id)
            try:
                return self._dial(node)._release_local(subscriber_id)
            except (ConnectionError, PeerPoolError):
                self._mark_failure(node)
        return False

    def _release_local(self, subscriber_id: str) -> bool:
        ip = self.by_subscriber.pop(subscriber_id, None)
        if ip is None:
            return False
        self.allocations.pop(ip, None)
        self.stats["releases"] += 1
        return True

    def get(self, subscriber_id: str) -> int | None:
        """Read from any node: check local, then the owner."""
        ip = self.by_subscriber.get(subscriber_id)
        if ip is not None:
            return ip
        for node in self.owner_ranked(subscriber_id):
            if node == self.node_id:
                continue
            try:
                got = self._dial(node).by_subscriber.get(subscriber_id)
                if got is not None:
                    return got
            except (ConnectionError, PeerPoolError):
                self._mark_failure(node)
        return None

    def status(self) -> dict:
        return {
            "node_id": self.node_id,
            "allocated": len(self.allocations),
            "pool_size": self.pool.size,
            "healthy_peers": len([p for p in self.peers.values() if p.healthy]),
            "stats": dict(self.stats),
        }

    # ---- health (peer.go:541-631) ----
    def _dial(self, node: str) -> "PeerPool":
        if self.transport is None:
            raise ConnectionError("no transport")
        return self.transport(node)

    def _mark_failure(self, node: str) -> None:
        st = self.peers.get(node)
        if st is None:
            return
        st.consecutive_failures += 1
        if st.consecutive_failures >= self.health_failure_threshold:
            st.healthy = False

    def health_check(self, now: float = 0.0) -> None:
        """Probe every peer; recover marks on success."""
        for st in self.peers.values():
            try:
                self._dial(st.node_id).status()
                st.healthy = True
                st.consecutive_failures = 0
                st.last_seen = now
            except (ConnectionError, PeerPoolError):
                st.consecutive_failures += 1
                if st.consecutive_failures >= self.health_failure_threshold:
                    st.healthy = False

    def reconcile(self) -> int:
        """After a heal, pull peers' allocations for our owned keys and
        drop double-allocations (newest loses; the CRDT-merge role)."""
        conflicts = 0
        for st in self.peers.values():
            if not st.healthy:
                continue
            try:
                peer = self._dial(st.node_id)
            except (ConnectionError, PeerPoolError):
                continue
            for ip, sub in list(peer.allocations.items()):
                mine = self.allocations.get(ip)
                if mine is not None and mine != sub:
                    # both handed out the same ip during a partition
                    owner = self.owner_ranked(sub)[0]
                    if owner == self.node_id:
                        peer._release_local(sub)
                    else:
                        self._release_local(mine)
                    conflicts += 1
                    self.stats["conflicts"] += 1
        return conflicts
