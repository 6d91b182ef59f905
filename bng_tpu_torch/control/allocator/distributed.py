"""Distributed allocator: deterministic hashring allocation over a store.

The port's copy of `bng_tpu/control/allocator/distributed.py` (jax-free).

Parity: pkg/allocator/distributed.go (:14-540). Combines the hashring
candidate sequence (pkg/nexus/client.go:487-577 — hash(subscriber+attempt)
with bounded probing) with a shared AllocationStore: two nodes allocating
for the same subscriber race toward the same candidate address, and the
store's put-if-absent is the tiebreaker. Lease epochs drive expiry.
"""

from __future__ import annotations

import time

from bng_tpu_torch.control.allocator.bitmap import IPAllocator
from bng_tpu_torch.control.allocator.store import AllocationRecord, AllocationStore
from bng_tpu_torch.parallel.hashring import hashring_allocate
from bng_tpu_torch.utils.net import fnv1a32


class DistributedAllocator:
    def __init__(
        self,
        cidr: str,
        store,  # AllocationStore
        node_id: str = "node0",
        lease_seconds: int = 3600,
        max_attempts: int = 1024,
        clock=time.time,
    ):
        self.bitmap = IPAllocator(cidr)
        self.store = store
        self.node_id = node_id
        self.lease_seconds = lease_seconds
        self.max_attempts = max_attempts
        self.clock = clock

    def allocate(self, subscriber_id: str) -> str | None:
        """Deterministic candidate sequence + store claim."""
        existing = self.store.find_by_subscriber(subscriber_id)
        now = self.clock()
        if existing is not None and (not existing.expires_at or existing.expires_at > now):
            self.bitmap.allocate_specific(existing.ip, subscriber_id)
            return existing.ip

        def is_free(idx: int) -> bool:
            ip = str(self.bitmap.ip_at(idx))
            rec = self.store.get(ip)
            if rec is not None and rec.expires_at and rec.expires_at < now:
                # lazy expiry: free both the shared record and our bitmap view
                self.store.delete(ip)
                try:
                    self.bitmap.release(ip)
                except ValueError:
                    pass
                rec = None
            return rec is None and self.bitmap.is_free(idx)

        idx = hashring_allocate(subscriber_id, self.bitmap.size, is_free, self.max_attempts)
        if idx is None:
            return None
        ip = str(self.bitmap.ip_at(idx))
        rec = AllocationRecord(
            ip=ip, subscriber_id=subscriber_id, allocated_at=now,
            expires_at=now + self.lease_seconds, node_id=self.node_id,
        )
        claim = getattr(self.store, "put_if_absent", self.store.put)
        if not claim(rec):
            # lost the race — retry once with the next candidates
            idx = hashring_allocate(subscriber_id + "#retry", self.bitmap.size,
                                    is_free, self.max_attempts)
            if idx is None:
                return None
            ip = str(self.bitmap.ip_at(idx))
            rec.ip = ip
            if not claim(rec):
                return None
        self.bitmap.allocate_at(self.bitmap.offset_of(ip), subscriber_id)
        return ip

    def renew(self, subscriber_id: str) -> bool:
        rec = self.store.find_by_subscriber(subscriber_id)
        if rec is None:
            return False
        rec.expires_at = self.clock() + self.lease_seconds
        return self.store.put(rec)

    def release(self, subscriber_id: str) -> bool:
        rec = self.store.find_by_subscriber(subscriber_id)
        if rec is None:
            return False
        self.store.delete(rec.ip)
        try:
            self.bitmap.release(rec.ip)
        except ValueError:
            pass
        return True

    def sync_from_store(self) -> int:
        """Rebuild the local bitmap from the shared store (remote-change
        watcher role, distributed.go:480-520). Returns live record count."""
        now = self.clock()
        self.bitmap = IPAllocator(str(self.bitmap.net))
        n = 0
        for rec in self.store.list_all():
            if rec.expires_at and rec.expires_at < now:
                continue
            try:
                self.bitmap.allocate_specific(rec.ip, rec.subscriber_id)
                n += 1
            except ValueError:
                continue
        return n
