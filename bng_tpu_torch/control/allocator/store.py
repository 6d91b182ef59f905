"""Allocation stores: the persistence/coordination boundary.

The port's copy of `bng_tpu/control/allocator/store.py` (jax-free).

Parity: pkg/allocator/store.go — AllocationStore interface (:86),
MemoryAllocationStore (:114), PoolAllocator (:381). The memory store is
the in-process fake the reference uses in tests (SURVEY.md §4.6); real
deployments back this with the Nexus store (bng_tpu_torch.control.nexus).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol


@dataclass
class AllocationRecord:
    ip: str
    subscriber_id: str
    allocated_at: float
    expires_at: float = 0.0
    node_id: str = ""
    meta: dict = field(default_factory=dict)


class AllocationStore(Protocol):
    def get(self, ip: str) -> AllocationRecord | None: ...

    def put(self, rec: AllocationRecord) -> bool: ...

    def delete(self, ip: str) -> bool: ...

    def list_all(self) -> list[AllocationRecord]: ...

    def find_by_subscriber(self, subscriber_id: str) -> AllocationRecord | None: ...


class MemoryAllocationStore:
    """In-memory AllocationStore (parity: store.go:114-310)."""

    def __init__(self):
        self._by_ip: dict[str, AllocationRecord] = {}
        self._by_sub: dict[str, str] = {}

    def get(self, ip: str) -> AllocationRecord | None:
        return self._by_ip.get(ip)

    def put(self, rec: AllocationRecord) -> bool:
        old = self._by_ip.get(rec.ip)
        if old is not None and old.subscriber_id != rec.subscriber_id:
            return False  # conflict: occupied by someone else
        self._by_ip[rec.ip] = rec
        self._by_sub[rec.subscriber_id] = rec.ip
        return True

    def put_if_absent(self, rec: AllocationRecord) -> bool:
        if rec.ip in self._by_ip:
            return self._by_ip[rec.ip].subscriber_id == rec.subscriber_id
        return self.put(rec)

    def delete(self, ip: str) -> bool:
        rec = self._by_ip.pop(ip, None)
        if rec is None:
            return False
        if self._by_sub.get(rec.subscriber_id) == ip:
            del self._by_sub[rec.subscriber_id]
        return True

    def list_all(self) -> list[AllocationRecord]:
        return list(self._by_ip.values())

    def find_by_subscriber(self, subscriber_id: str) -> AllocationRecord | None:
        ip = self._by_sub.get(subscriber_id)
        return self._by_ip.get(ip) if ip else None

    def expire(self, now: float | None = None) -> int:
        now = now if now is not None else time.time()
        dead = [ip for ip, r in self._by_ip.items() if r.expires_at and r.expires_at < now]
        for ip in dead:
            self.delete(ip)
        return len(dead)
