"""Local IPv4 pool allocation for the DHCP slow path (copy of
`bng_tpu/control/pool.py`: `Pool`, `PoolManager`, `PoolExhaustedError`).

`Pool` allocates sequentially, then from its free list; `PoolManager`
registers pools, mirrors each into the device pool table
(`FastPathTables.add_pool`) and classifies clients. `Pool.allocate`
carries the chaos point `pool.allocate` (kind `exhaust`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bng_tpu_torch.chaos.faults import fault_point
from bng_tpu_torch.utils.net import prefix_to_mask, u32_to_ip


class PoolExhaustedError(Exception):
    pass


@dataclass
class Pool:
    """One IPv4 pool: network/prefix with gateway, DNS and lease config."""

    pool_id: int
    network: int  # host-order network address
    prefix_len: int
    gateway: int
    dns_primary: int = 0
    dns_secondary: int = 0
    lease_time: int = 3600
    client_class: int = 0  # 0 = any
    _next: int = field(init=False, default=0)
    _free: list[int] = field(init=False, default_factory=list)
    _allocated: dict[int, str] = field(init=False, default_factory=dict)  # ip -> owner key
    _declined: set[int] = field(init=False, default_factory=set)

    def __post_init__(self):
        mask = prefix_to_mask(self.prefix_len)
        self.network &= mask
        self.first = self.network + 1
        self.last = (self.network | (~mask & 0xFFFFFFFF)) - 1
        self._next = self.first

    @property
    def size(self) -> int:
        reserved = 1 if self.first <= self.gateway <= self.last else 0
        return max(0, self.last - self.first + 1 - reserved)

    @property
    def used(self) -> int:
        return len(self._allocated)

    def utilization(self) -> float:
        return self.used / self.size if self.size else 1.0

    def allocate(self, owner: str) -> int:
        """Sequential, then free-list allocation."""
        fp = fault_point("pool.allocate")
        if fp is not None and fp.kind == "exhaust":
            # chaos: simulated exhaustion; every caller already handles it
            raise PoolExhaustedError(f"pool {self.pool_id}: chaos-injected exhaustion")
        while self._next <= self.last:
            ip = self._next
            self._next += 1
            if ip == self.gateway or ip in self._allocated or ip in self._declined:
                continue
            self._allocated[ip] = owner
            return ip
        while self._free:
            ip = self._free.pop()
            if ip in self._allocated or ip in self._declined:
                continue
            self._allocated[ip] = owner
            return ip
        raise PoolExhaustedError(
            f"pool {self.pool_id} ({u32_to_ip(self.network)}/{self.prefix_len}) exhausted")

    def allocate_specific(self, ip: int, owner: str) -> bool:
        if ip < self.first or ip > self.last or ip == self.gateway:
            return False
        if ip in self._declined:
            return False
        cur = self._allocated.get(ip)
        if cur is not None and cur != owner:
            return False
        self._allocated[ip] = owner
        return True

    def release(self, ip: int) -> bool:
        if ip in self._allocated:
            del self._allocated[ip]
            self._free.append(ip)
            return True
        return False

    def decline(self, ip: int) -> None:
        """Mark an address unusable (a client saw a conflict)."""
        self._allocated.pop(ip, None)
        self._declined.add(ip)

    def contains(self, ip: int) -> bool:
        return self.first <= ip <= self.last


class PoolManager:
    """Pool registry and client classification."""

    def __init__(self, fastpath_tables=None):
        self.pools: dict[int, Pool] = {}
        self.tables = fastpath_tables

    def add_pool(self, pool: Pool) -> None:
        self.pools[pool.pool_id] = pool
        if self.tables is not None:
            self.tables.add_pool(pool.pool_id, pool.network, pool.prefix_len, pool.gateway,
                                 pool.dns_primary, pool.dns_secondary, pool.lease_time)

    def classify(self, client_class: int = 0) -> Pool | None:
        """The pool for a client class (else the first class-0 pool)."""
        best = None
        for p in self.pools.values():
            if p.client_class == client_class:
                return p
            if p.client_class == 0 and best is None:
                best = p
        return best

    def pool_for_ip(self, ip: int) -> Pool | None:
        for p in self.pools.values():
            if p.contains(ip):
                return p
        return None

    def stats(self) -> dict:
        return {pid: {"size": p.size, "used": p.used, "utilization": p.utilization()}
                for pid, p in self.pools.items()}
