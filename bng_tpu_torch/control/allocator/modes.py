"""Allocation mode façades: local / hybrid (Nexus-primary, local-fallback).

The port's copy of `bng_tpu/control/allocator/modes.py` (jax-free).

Parity: pkg/allocator/modes.go — Allocator interface (:46), LocalAllocator
(:92), HybridAllocator with partition detection + reconcile (:344-510).
The hybrid mode is the partition-tolerance seam: while the central
allocator (Nexus) is unreachable, allocation falls back to a local range
and every fallback allocation is recorded for post-heal reconciliation
(bng_tpu_torch.control.resilience consumes that record).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol

from bng_tpu_torch.control.allocator.bitmap import IPAllocator
from bng_tpu_torch.utils.structlog import ErrorLog


class Allocator(Protocol):
    def allocate(self, subscriber_id: str) -> str | None: ...

    def release(self, subscriber_id: str) -> bool: ...


class LocalAllocator:
    """Purely local bitmap allocation (parity: modes.go:92-180)."""

    def __init__(self, cidr: str):
        self.bitmap = IPAllocator(cidr)
        self._by_sub: dict[str, str] = {}

    def allocate(self, subscriber_id: str) -> str | None:
        if subscriber_id in self._by_sub:
            return self._by_sub[subscriber_id]
        try:
            ip = str(self.bitmap.allocate(subscriber_id))
        except Exception:
            return None
        self._by_sub[subscriber_id] = ip
        return ip

    def release(self, subscriber_id: str) -> bool:
        ip = self._by_sub.pop(subscriber_id, None)
        if ip is None:
            return False
        return self.bitmap.release(ip)


@dataclass
class FallbackAllocation:
    subscriber_id: str
    ip: str
    at: float


class HybridAllocator:
    """Primary (remote/Nexus) with local fallback under partition.

    Parity: modes.go:344-510 — IsPartitionActive, fallback records,
    reconcile loop. `primary` is any Allocator (DistributedAllocator,
    HTTPAllocator...); failures flip partition state after
    `failure_threshold` consecutive errors.
    """

    def __init__(self, primary, fallback_cidr: str, failure_threshold: int = 3,
                 clock=time.time):
        self.primary = primary
        self.local = LocalAllocator(fallback_cidr)
        self.failure_threshold = failure_threshold
        self.clock = clock
        self._failures = 0
        self.partition_active = False
        self.fallback_allocations: list[FallbackAllocation] = []
        self.release_errors = 0
        self._release_err_log = ErrorLog(
            "allocator", "primary release failed (local release still "
            "applies)")

    def is_partition_active(self) -> bool:
        return self.partition_active

    def _primary_alloc(self, subscriber_id: str) -> str | None:
        try:
            ip = self.primary.allocate(subscriber_id)
            self._failures = 0
            if self.partition_active:
                pass  # healing is driven by reconcile(), not a lone success
            return ip
        except Exception:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self.partition_active = True
            return None

    def allocate(self, subscriber_id: str) -> str | None:
        if not self.partition_active:
            ip = self._primary_alloc(subscriber_id)
            if ip is not None:
                return ip
            if not self.partition_active:
                return None  # primary healthy but exhausted: no fallback
        ip = self.local.allocate(subscriber_id)
        if ip is not None:
            self.fallback_allocations.append(
                FallbackAllocation(subscriber_id, ip, self.clock())
            )
        return ip

    def release(self, subscriber_id: str) -> bool:
        ok = False
        try:
            ok = self.primary.release(subscriber_id)
        except Exception as e:
            # a leaked primary allocation is exactly what reconcile()
            # heals — but it must be visible, not silent (BNG020)
            self.release_errors += 1
            self._release_err_log.report(e, subscriber_id=subscriber_id)
        return self.local.release(subscriber_id) or ok

    def reconcile(self) -> tuple[int, list[tuple[FallbackAllocation, str]]]:
        """Post-heal: migrate fallback allocations to the primary.

        Returns (migrated_count, renumbered): every successfully migrated
        subscriber whose primary-assigned address differs from its fallback
        address appears in `renumbered` as (fallback, new_ip) — the caller
        (DHCP server via short leases, resilience.Manager) pushes the new
        address at next renewal (modes.go:344-510 / manager.go:342-528
        parity: the partition loser is force-renumbered).
        """
        migrated, renumbered = 0, []
        remaining = []
        for fb in self.fallback_allocations:
            try:
                ip = self.primary.allocate(fb.subscriber_id)
            except Exception:
                remaining.append(fb)
                continue
            if ip is None:
                remaining.append(fb)
                continue
            migrated += 1
            self.local.release(fb.subscriber_id)
            if ip != fb.ip:
                renumbered.append((fb, ip))
        self.fallback_allocations = remaining
        if not remaining:
            self.partition_active = False
            self._failures = 0
        return migrated, renumbered
