"""Nexus coordination client + embeddable store stack.

The port's copy of `bng_tpu/control/nexus.py` (jax-free).

Parity: pkg/nexus — Store interface (store.go:13), MemoryStore (:43),
TypedStore[T] (:129), entities (:211-291), Client with watchers +
deterministic hashring IP allocation (client.go:47-577), HTTPAllocator
REST client (http_allocator.go:95-541), VLANAllocator (vlan.go:46-270).

The HTTP transport is injectable (tests run against an in-memory server;
SURVEY.md §4.6 httpmock pattern). The hashring allocation is the same
algorithm the device uses for shard routing — one placement function
across the whole system.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Generic, TypeVar

from bng_tpu_torch.parallel.hashring import hashring_allocate


class ErrNoAllocation(Exception):
    """Parity: http_allocator.go:226."""


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------
class MemoryStore:
    """KV store with prefix listing and change watchers (store.go:13-120)."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._watchers: list[tuple[str, Callable[[str, bytes | None], None]]] = []

    def get(self, key: str) -> bytes | None:
        return self._data.get(key)

    def put(self, key: str, value: bytes) -> None:
        self._data[key] = value
        self._notify(key, value)

    def delete(self, key: str) -> bool:
        if key in self._data:
            del self._data[key]
            self._notify(key, None)
            return True
        return False

    def list(self, prefix: str) -> dict[str, bytes]:
        return {k: v for k, v in self._data.items() if k.startswith(prefix)}

    def watch(self, prefix: str,
              cb: Callable[[str, bytes | None], None]) -> Callable[[], None]:
        """Subscribe to changes under `prefix`. Returns a cancel
        callable (idempotent); watchers fire in registration order."""
        entry = (prefix, cb)
        self._watchers.append(entry)

        def cancel():
            if entry in self._watchers:
                self._watchers.remove(entry)

        return cancel

    def _notify(self, key: str, value: bytes | None) -> None:
        for prefix, cb in list(self._watchers):
            if key.startswith(prefix):
                cb(key, value)


T = TypeVar("T")


class TypedStore(Generic[T]):
    """Typed veneer over a KV store (store.go:129-205)."""

    def __init__(self, store, prefix: str, cls: type[T]):
        self.store = store
        self.prefix = prefix.rstrip("/") + "/"
        self.cls = cls

    def _key(self, id_: str) -> str:
        return self.prefix + id_

    def get(self, id_: str) -> T | None:
        raw = self.store.get(self._key(id_))
        return self.cls(**json.loads(raw)) if raw else None

    def put(self, id_: str, obj: T) -> None:
        self.store.put(self._key(id_), json.dumps(asdict(obj)).encode())

    def delete(self, id_: str) -> bool:
        return self.store.delete(self._key(id_))

    def list(self) -> dict[str, T]:
        return {
            k[len(self.prefix):]: self.cls(**json.loads(v))
            for k, v in self.store.list(self.prefix).items()
        }

    def watch(self, cb: Callable[[str, T | None], None]) -> Callable[[], None]:
        def wrapped(key: str, value: bytes | None):
            id_ = key[len(self.prefix):]
            cb(id_, self.cls(**json.loads(value)) if value else None)

        return self.store.watch(self.prefix, wrapped)


# ---------------------------------------------------------------------------
# Entities (store.go:211-291)
# ---------------------------------------------------------------------------
@dataclass
class SubscriberEntity:
    id: str
    mac: str = ""
    circuit_id: str = ""
    nte_id: str = ""
    isp_id: str = ""
    client_class: int = 0
    qos_policy: str = ""
    enabled: bool = True
    static_ip: str = ""


@dataclass
class NTEEntity:
    id: str
    serial: str = ""
    model: str = ""
    olt_id: str = ""
    state: str = "discovered"  # discovered|provisioning|connected|disconnected
    s_tag: int = 0
    c_tag: int = 0
    approved: bool = False


@dataclass
class ISPConfigEntity:
    id: str
    name: str = ""
    as_number: int = 0
    route_table: int = 0
    pools: list = field(default_factory=list)


@dataclass
class IPPoolEntity:
    id: str
    cidr: str = ""
    gateway: str = ""
    isp_id: str = ""
    client_class: int = 0
    lease_time: int = 3600


@dataclass
class DeviceEntity:
    id: str
    serial: str = ""
    mac: str = ""
    model: str = ""
    state: str = "pending"  # pending|approved|rejected
    last_heartbeat: float = 0.0


# ---------------------------------------------------------------------------
# Client with hashring allocation (client.go)
# ---------------------------------------------------------------------------
class NexusClient:
    """Coordination client over a Store (embedded or remote-backed).

    AllocateIPForSubscriber parity (client.go:487-577): deterministic
    hash(subscriberID+attempt) probing over the pool, claim via the store.
    """

    def __init__(self, store=None, node_id: str = "bng0", clock=time.time):
        self.store = store if store is not None else MemoryStore()
        self.node_id = node_id
        self.clock = clock
        self.subscribers = TypedStore(self.store, "subscribers", SubscriberEntity)
        self.ntes = TypedStore(self.store, "ntes", NTEEntity)
        self.isps = TypedStore(self.store, "isps", ISPConfigEntity)
        self.pools = TypedStore(self.store, "pools", IPPoolEntity)
        self.devices = TypedStore(self.store, "devices", DeviceEntity)

    # -- subscriber lookup (client.go:459) --
    def get_subscriber_by_mac(self, mac: str) -> SubscriberEntity | None:
        mac = mac.lower()
        for sub in self.subscribers.list().values():
            if sub.mac.lower() == mac:
                return sub
        return None

    def get_subscriber_by_circuit_id(self, cid: str) -> SubscriberEntity | None:
        for sub in self.subscribers.list().values():
            if sub.circuit_id == cid:
                return sub
        return None

    # -- heartbeat --
    def heartbeat(self, device_id: str) -> None:
        d = self.devices.get(device_id)
        if d:
            d.last_heartbeat = self.clock()
            self.devices.put(device_id, d)

    # -- hashring IP allocation (client.go:487-577) --
    def allocate_ip(self, subscriber_id: str, pool_id: str) -> str | None:
        import ipaddress

        pool = self.pools.get(pool_id)
        if pool is None:
            return None
        net = ipaddress.ip_network(pool.cidr, strict=False)
        size = net.num_addresses - 2 if net.version == 4 and net.num_addresses > 2 else net.num_addresses
        base = int(net.network_address) + (1 if net.version == 4 else 0)

        existing_key = f"allocations/{pool_id}/by-sub/{subscriber_id}"
        existing = self.store.get(existing_key)
        if existing:
            return existing.decode()

        def is_free(idx: int) -> bool:
            ip = str(ipaddress.ip_address(base + idx))
            return self.store.get(f"allocations/{pool_id}/by-ip/{ip}") is None

        idx = hashring_allocate(subscriber_id, size, is_free)
        if idx is None:
            return None
        ip = str(ipaddress.ip_address(base + idx))
        self.store.put(f"allocations/{pool_id}/by-ip/{ip}", subscriber_id.encode())
        self.store.put(existing_key, ip.encode())
        return ip

    def release_ip(self, subscriber_id: str, pool_id: str) -> bool:
        key = f"allocations/{pool_id}/by-sub/{subscriber_id}"
        ip_raw = self.store.get(key)
        if ip_raw is None:
            return False
        self.store.delete(key)
        self.store.delete(f"allocations/{pool_id}/by-ip/{ip_raw.decode()}")
        return True


# ---------------------------------------------------------------------------
# HTTP allocator (http_allocator.go)
# ---------------------------------------------------------------------------
class HTTPAllocator:
    """REST allocate/lookup/release against a central Nexus.

    transport(method, path, body_dict) -> (status, body_dict); production
    wires an HTTP session, tests wire a fake (http_allocator_test parity).
    """

    def __init__(self, base_url: str, transport, node_id: str = "bng0"):
        self.base_url = base_url.rstrip("/")
        self.transport = transport
        self.node_id = node_id
        self.stats = {"allocations": 0, "failures": 0, "releases": 0}

    def allocate(self, subscriber_id: str, pool_hint: str = "") -> str | None:
        status, body = self.transport("POST", "/api/v1/allocate", {
            "subscriber_id": subscriber_id, "node_id": self.node_id,
            "pool": pool_hint,
        })
        if status == 200 and body.get("ip"):
            self.stats["allocations"] += 1
            return body["ip"]
        if status == 404:
            raise ErrNoAllocation(subscriber_id)
        self.stats["failures"] += 1
        if status >= 500:
            raise ConnectionError(f"nexus {status}")
        return None

    def lookup(self, subscriber_id: str) -> str | None:
        status, body = self.transport("GET", f"/api/v1/allocations/{subscriber_id}", None)
        if status == 200:
            return body.get("ip")
        if status == 404:
            return None
        raise ConnectionError(f"nexus {status}")

    def lookup_by_ip(self, ip: str) -> tuple[str, float] | None:
        """Who does the CENTRAL store think owns this IP? -> (subscriber,
        allocated_at) — the heal-time conflict-detection query
        (conflict_detector.go:121-233's central view)."""
        status, body = self.transport(
            "GET", f"/api/v1/allocation-by-ip/{ip}", None)
        if status == 200 and body.get("subscriber_id"):
            return body["subscriber_id"], float(body.get("allocated_at", 0))
        if status == 404:
            return None
        raise ConnectionError(f"nexus {status}")

    def release(self, subscriber_id: str) -> bool:
        status, _ = self.transport("DELETE", f"/api/v1/allocations/{subscriber_id}", None)
        ok = status in (200, 204)
        if ok:
            self.stats["releases"] += 1
        return ok

    def get_pool_info(self) -> dict:
        status, body = self.transport("GET", "/api/v1/pools", None)
        if status != 200:
            raise ConnectionError(f"nexus {status}")
        return body

    def health_check(self) -> bool:
        try:
            status, _ = self.transport("GET", "/health", None)
            return status == 200
        except Exception:
            return False


# ---------------------------------------------------------------------------
# VLAN allocator (vlan.go:46-270)
# ---------------------------------------------------------------------------
class VLANAllocator:
    """S-TAG/C-TAG assignment for QinQ deployments."""

    def __init__(self, s_tag_range=(100, 4000), c_tag_range=(1, 4094)):
        self.s_range = s_tag_range
        self.c_range = c_tag_range
        self._assigned: dict[str, tuple[int, int]] = {}
        self._used: set[tuple[int, int]] = set()
        self._next_s = s_tag_range[0]
        self._next_c = c_tag_range[0]

    def allocate(self, subscriber_id: str) -> tuple[int, int] | None:
        if subscriber_id in self._assigned:
            return self._assigned[subscriber_id]
        s, c = self._next_s, self._next_c
        span_c = self.c_range[1] - self.c_range[0] + 1
        for _ in range(span_c * (self.s_range[1] - self.s_range[0] + 1)):
            if (s, c) not in self._used:
                self._assigned[subscriber_id] = (s, c)
                self._used.add((s, c))
                self._advance()
                return s, c
            s, c = self._peek_next(s, c)
        return None

    def _advance(self):
        self._next_s, self._next_c = self._peek_next(self._next_s, self._next_c)

    def _peek_next(self, s, c):
        c += 1
        if c > self.c_range[1]:
            c = self.c_range[0]
            s += 1
            if s > self.s_range[1]:
                s = self.s_range[0]
        return s, c

    def release(self, subscriber_id: str) -> bool:
        pair = self._assigned.pop(subscriber_id, None)
        if pair is None:
            return False
        self._used.discard(pair)
        return True

    def lookup(self, subscriber_id: str) -> tuple[int, int] | None:
        return self._assigned.get(subscriber_id)
