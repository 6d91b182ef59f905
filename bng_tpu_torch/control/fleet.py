"""Slow-path fleet: sharded multi-worker control-plane service (copy of
`bng_tpu/control/fleet.py`).

The reference BNG sustains 50k+ DHCP req/s because its slow path is
concurrent Go (pkg/dhcp/server.go:302 onward — one goroutine per
request); ours was a single GIL thread behind the engine's PASS lanes.
This module re-hosts that concurrency as a shared-nothing worker fleet:

- **Sharding**: frames are steered to workers by FNV-1a32(src MAC) —
  bit-for-bit the hash the ring classifier uses for DHCP control frames
  (runtime/ring.py shard_of, bngring.h spec), so one subscriber's whole
  DORA lands on ONE worker (the SO_REUSEPORT + consistent-hash role).
  No lock is ever taken on the per-frame path.

- **Workers**: each worker owns a full `SlowPathDemux` + `DHCPServer`
  stack and allocates from per-worker *lease slices* carved out of the
  parent `PoolManager` — addresses a worker holds are marked allocated
  in the parent pool, so two workers can never hand out the same IP.
  Slice refill (batched, low-watermark-triggered) is the only
  cross-worker coordination, and it happens between batches, never
  mid-frame.

- **Single-writer tables**: workers never touch the device tables.
  Their DHCP servers write to a `TableEventLog` recorder; the parent
  replays the events into the real `FastPathTables` host mirror, which
  the engine's existing bounded update drain ships to HBM — the same
  single-writer discipline every other table producer follows.

- **Admission**: an `AdmissionController` (control/admission.py) sheds
  DHCP-correctly in front of the inboxes — DISCOVERs first, never a
  REQUEST whose OFFER we already sent, never a half-allocation.

Execution modes:
  - ``process`` — one OS process per worker (multiprocessing, spawn by
    default): real CPU parallelism for the Python slow path. Workers
    are built IN the child from a picklable `FleetSpec`. Standard
    spawn rules apply: an embedding *script* must guard its
    entrypoint with ``if __name__ == '__main__'`` (module entrypoints
    like ``python -m bng_tpu_torch.cli`` are fine as-is). Parents whose
    __main__ is not importable at all (stdin, REPL) automatically fall
    back to fork; BNG_FLEET_START or start_method overrides.
  - ``inline`` — same sharding/admission/slice machinery, handlers run
    synchronously in the caller; deterministic (tests, workers=1).

A worker that dies mid-flight (IPC error) loses only its own shard's
lanes for that batch — clients retransmit — and is counted in
`worker_failures`; other shards and later batches are unaffected.

The fleet's `handle_batch` is the engine's `slow_path_batch` hook:
fan-out by shard, fan-in with replies re-merged in lane (ring) order.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from bng_tpu_torch.chaos.faults import fault_point
from bng_tpu_torch.control import dhcp_codec
from bng_tpu_torch.telemetry import spans as tele
from bng_tpu_torch.telemetry.hist import LatencyHist
from bng_tpu_torch.control.admission import (AdmissionConfig, AdmissionController,
                                       peek_reply)
from bng_tpu_torch.control.pool import PoolExhaustedError, PoolManager
from bng_tpu_torch.runtime.ring import classify_dhcp
from bng_tpu_torch.utils.net import fnv1a32, prefix_to_mask
from bng_tpu_torch.utils.structlog import SlowPathErrorLog, get_logger
from bng_tpu_torch.analysis.sanitize import ctx_enter, owned_by


def shard_for_mac(mac: bytes, n_workers: int) -> int:
    """Worker owning a client MAC — the ring classifier's DHCP-control
    steering hash (shard_of's fnv1a32(frame[6:12]) fallback), so the
    host ring, the sharded cluster and the fleet all agree on owners."""
    if n_workers <= 1:
        return 0
    return fnv1a32(mac[:6]) % n_workers


def shard_for_frame(frame: bytes, n_workers: int) -> int:
    """Worker for a slow-path frame: by source MAC (frame[6:12])."""
    if n_workers <= 1 or len(frame) < 12:
        return 0
    return fnv1a32(frame[6:12]) % n_workers


# ---------------------------------------------------------------------------
# picklable worker construction spec
# ---------------------------------------------------------------------------

@dataclass
class FleetPoolSpec:
    """Per-pool config a worker needs to build reply options + validate
    addresses. Mirrors control.pool.Pool's config surface (no state)."""

    pool_id: int
    network: int
    prefix_len: int
    gateway: int
    dns_primary: int = 0
    dns_secondary: int = 0
    lease_time: int = 3600
    client_class: int = 0


@dataclass
class FleetSpec:
    """Everything a child process needs to build its worker stack."""

    server_mac: bytes
    server_ip: int
    pools: list = field(default_factory=list)  # [FleetPoolSpec]
    lease_time_cap: int | None = None
    slice_size: int = 1024
    low_watermark: int = 256
    # RADIUS fan-out: each worker builds its OWN RadiusClient
    # from these picklable RadiusServerConfig entries — auth runs on the
    # shard that owns the subscriber's MAC (auth affinity = DHCP
    # affinity, both the same FNV-1a32 hash), so no cross-worker lock
    # and no parent round-trip on the DORA path
    radius_servers: list = field(default_factory=list)
    radius_nas_id: str = "bng-tpu"
    radius_nas_ip: int = 0
    # central Nexus allocation: worker lease authority routes through the
    # shared store per shard — each worker builds its own HTTPAllocator +
    # ResilienceManager from these picklable fields (the radius_servers
    # mold). nexus_tls is a ztp_tls.TLSConfig (string/list dataclass —
    # picklable) or None for plaintext.
    nexus_url: str = ""
    nexus_node_id: str = "bng-tpu"
    nexus_tls: object = None

    @staticmethod
    def from_pool_manager(server_mac: bytes, server_ip: int,
                          pools: PoolManager, **kw) -> "FleetSpec":
        specs = [FleetPoolSpec(
            pool_id=p.pool_id, network=p.network, prefix_len=p.prefix_len,
            gateway=p.gateway, dns_primary=p.dns_primary,
            dns_secondary=p.dns_secondary, lease_time=p.lease_time,
            client_class=p.client_class) for p in pools.pools.values()]
        return FleetSpec(server_mac=server_mac, server_ip=server_ip,
                         pools=specs, **kw)


# ---------------------------------------------------------------------------
# worker-side pools: lease slices
# ---------------------------------------------------------------------------

class SlicePool:
    """Worker-side view of one pool: full config, but allocation is
    restricted to the address slices the parent granted. Duck-types the
    Pool surface DHCPServer consumes."""

    def __init__(self, spec: FleetPoolSpec,
                 on_exhausted: Callable[[int], None] | None = None):
        # called once when allocate() drains the slice dry: the worker's
        # synchronous refill hook (mid-batch exhaustion must be able to
        # pull a new slice, not silently drop the tail of a batch)
        self.on_exhausted = on_exhausted
        self.pool_id = spec.pool_id
        self.prefix_len = spec.prefix_len
        self.gateway = spec.gateway
        self.dns_primary = spec.dns_primary
        self.dns_secondary = spec.dns_secondary
        self.lease_time = spec.lease_time
        self.client_class = spec.client_class
        mask = prefix_to_mask(spec.prefix_len)
        self.network = spec.network & mask
        self.first = self.network + 1
        self.last = (self.network | (~mask & 0xFFFFFFFF)) - 1
        self._free: deque[int] = deque()
        self._granted: set[int] = set()
        self._allocated: dict[int, str] = {}
        self._declined: set[int] = set()

    def grant(self, ips) -> int:
        added = 0
        for ip in ips:
            if ip not in self._granted:
                self._granted.add(ip)
                self._free.append(ip)
                added += 1
        return added

    @property
    def free_count(self) -> int:
        return (len(self._granted) - len(self._allocated)
                - len(self._declined & self._granted))

    @property
    def used(self) -> int:
        return len(self._allocated)

    def allocate(self, owner: str) -> int:
        for attempt in (0, 1):
            while self._free:
                ip = self._free.popleft()
                # revoked (no longer granted), re-claimed or declined
                # addresses may still sit in the free deque — skip them
                if (ip not in self._granted or ip in self._allocated
                        or ip in self._declined):
                    continue
                self._allocated[ip] = owner
                return ip
            if attempt == 0 and self.on_exhausted is not None:
                self.on_exhausted(self.pool_id)  # may grant a new slice
        raise PoolExhaustedError(
            f"worker slice of pool {self.pool_id} exhausted")

    def revoke(self, ip: int) -> bool:
        """Withdraw an un-leased address from this slice (restore-time
        ownership transfer). Active allocations are never revoked."""
        if ip in self._allocated:
            return False
        self._granted.discard(ip)
        return True

    def allocate_specific(self, ip: int, owner: str) -> bool:
        # the granted set is the correctness boundary: an address another
        # worker owns is simply not grantable here, so a cross-shard
        # REQUEST NAKs instead of double-allocating
        if ip not in self._granted or ip in self._declined:
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
        self._allocated.pop(ip, None)
        self._declined.add(ip)

    def contains(self, ip: int) -> bool:
        # FULL pool range, not just granted slices: pool_for_ip must
        # find the owning pool for renewals/validation; allocate_specific
        # still enforces the granted boundary
        return self.first <= ip <= self.last


class WorkerPools:
    """PoolManager-shaped registry over a worker's SlicePools."""

    def __init__(self, specs: list[FleetPoolSpec],
                 on_exhausted: Callable[[int], None] | None = None):
        self.pools: dict[int, SlicePool] = {
            s.pool_id: SlicePool(s, on_exhausted) for s in specs}

    def classify(self, client_class: int = 0):
        best = None
        for p in self.pools.values():
            if p.client_class == client_class:
                return p
            if p.client_class == 0 and best is None:
                best = p
        return best

    def pool_for_ip(self, ip: int):
        for p in self.pools.values():
            if p.contains(ip):
                return p
        return None


# ---------------------------------------------------------------------------
# single-writer table relay
# ---------------------------------------------------------------------------

class TableEventLog:
    """FastPathTables-shaped recorder: workers call the same methods the
    DHCP server calls on the real tables; the calls are logged as
    picklable events the PARENT replays into the host mirror — keeping
    the device tables single-writer."""

    _METHODS = ("add_subscriber", "remove_subscriber",
                "add_circuit_id_subscriber", "remove_circuit_id_subscriber",
                "add_vlan_subscriber", "remove_vlan_subscriber")

    def __init__(self):
        self.events: list = []

    def __getattr__(self, name):
        if name not in self._METHODS:
            raise AttributeError(name)

        def record(*args, **kwargs):
            self.events.append(("fastpath", name, args, kwargs))
        return record

    def drain(self) -> list:
        out, self.events = self.events, []
        return out


def apply_table_events(events: list, table_sink, qos_hook=None,
                       nat_hook=None, lease_hook=None) -> None:
    """Replay worker events into the parent-side sinks (the single
    writer). Unknown event kinds are ignored — forward compatibility
    across worker versions mid-rolling-restart."""
    for ev in events:
        kind = ev[0]
        if kind == "fastpath":
            if table_sink is not None:
                getattr(table_sink, ev[1])(*ev[2], **ev[3])
        elif kind == "qos":
            if qos_hook is not None:
                qos_hook(ev[1], ev[2])
        elif kind == "nat":
            if nat_hook is not None:
                nat_hook(ev[1], ev[2])
        elif kind == "lease":
            if lease_hook is not None:
                lease_hook(ev[1], ev[2], ev[3])


# ---------------------------------------------------------------------------
# the worker (runs in-child for process mode, in-parent for inline)
# ---------------------------------------------------------------------------

class _WorkerNexusAllocator:
    """DHCPServer's int-contract adapter over a worker-local
    HTTPAllocator (the cli `_NexusAlloc` twin, one per shard):
    partitioned -> None so the local slice answers immediately instead
    of eating a central-store timeout per DISCOVER."""

    def __init__(self, allocator, resilience):
        self.allocator = allocator
        self.resilience = resilience
        self.release_errors = 0

    def allocate(self, owner: str):
        if self.resilience.partitioned:
            return None
        try:
            ip = self.allocator.allocate(owner)
        except Exception:  # network lane: any failure = local fallback
            return None
        if not ip:
            return None
        from bng_tpu_torch.utils.net import ip_to_u32

        return ip_to_u32(ip)

    def release(self, owner: str) -> None:
        if self.resilience.partitioned:
            return  # heal-time reconciliation covers it — no timeout
            # per expired lease during an outage
        try:
            self.allocator.release(owner)
        except Exception:  # heal-time reconciliation sweeps leaked IPs
            self.release_errors += 1


class FleetWorker:
    """One shard: demux + DHCP server + slice pools, shared-nothing."""

    def __init__(self, spec: FleetSpec, worker_id: int, n_workers: int,
                 clock: Callable[[], float] | None = None):
        from bng_tpu_torch.control.dhcp_server import DHCPServer
        from bng_tpu_torch.control.slowpath import SlowPathDemux

        self.spec = spec
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.clock = clock or time.time
        self.tables = TableEventLog()
        # set by the execution context (fleet for inline, _worker_main
        # for process): called when a slice runs dry MID-batch so the
        # tail of the batch can still allocate. None = rely on the
        # between-batch watermark refill only.
        self.refill_now: Callable[[int], None] | None = None
        self.pools = WorkerPools(spec.pools, self._on_slice_exhausted)
        self._events: list = []
        # per-worker RADIUS lane: own client socket, own degraded-auth
        # cache. The MAC that steered the frame here is the MAC being
        # authenticated, so the cache is shard-complete by construction.
        self.radius = None
        self._radius_degraded = None
        self.auth_requests = 0
        self.auth_degraded = 0
        if spec.radius_servers:
            from bng_tpu_torch.control.radius.client import RadiusClient
            from bng_tpu_torch.control.resilience import DegradedRADIUSHandler

            self.radius = RadiusClient(
                servers=list(spec.radius_servers),
                nas_identifier=spec.radius_nas_id,
                nas_ip=spec.radius_nas_ip, clock=self.clock)
            self._radius_degraded = DegradedRADIUSHandler()
        # per-worker Nexus lane: the shard that owns the MAC allocates
        # against the shared store under its own node id — no parent
        # round-trip on the DORA path. While partitioned the adapter
        # answers None and DHCP falls back to the local slice (the
        # resilience FSM owns retry cadence, not a per-DISCOVER timeout).
        self.nexus = None
        self.nexus_resilience = None
        allocator = None
        if spec.nexus_url:
            from bng_tpu_torch.control.cluster_http import http_nexus_transport
            from bng_tpu_torch.control.nexus import HTTPAllocator
            from bng_tpu_torch.control.resilience import ResilienceManager

            self.nexus = HTTPAllocator(
                spec.nexus_url,
                http_nexus_transport(spec.nexus_url, tls=spec.nexus_tls),
                node_id=f"{spec.nexus_node_id}-w{worker_id}")
            self.nexus_resilience = ResilienceManager(
                nexus_healthy=self.nexus.health_check)
            allocator = _WorkerNexusAllocator(self.nexus,
                                              self.nexus_resilience)
        self.server = DHCPServer(
            server_mac=spec.server_mac, server_ip=spec.server_ip,
            allocator=allocator,
            pool_manager=self.pools, fastpath_tables=self.tables,
            qos_hook=lambda ip, pol: self._events.append(("qos", ip, pol)),
            nat_hook=lambda ip, now: self._events.append(("nat", ip, now)),
            accounting_hook=self._lease_event,
            authenticator=(self._radius_auth if self.radius is not None
                           else None),
            lease_time_cap=spec.lease_time_cap, clock=self.clock)
        self.demux = SlowPathDemux(dhcp=self.server, clock=self.clock)
        # mac_u64s whose lease ENDED (release/expiry/replacement) since
        # the last report — the admission controller's is_known feedback
        self._released: list[int] = []
        self.frames = 0
        self.batches = 0
        self.errors = 0
        self.busy_s = 0.0
        # per-frame handler latency histogram, shipped in the stats
        # payload and merged into the parent tracer's `worker` stage
        # (telemetry/hist.py — merge is counter addition, so worker
        # order never matters). Built only when telemetry is armed in
        # the parent: process-mode children inherit BNG_TELEMETRY=1
        # (exported by SlowPathFleet before spawning), inline workers
        # see the parent's armed tracer directly.
        self._lat_hist = (LatencyHist()
                          if (tele.enabled()
                              or os.environ.get("BNG_TELEMETRY") == "1")
                          else None)

    def _on_slice_exhausted(self, pool_id: int) -> None:
        if self.refill_now is not None:
            self.refill_now(pool_id)

    def _lease_event(self, event: str, lease, sid: str) -> None:
        if event == "stop":
            # RELEASE produces no reply frame, so the reply peek can
            # never observe it — report ended leases explicitly or the
            # admission controller's known-client set grows forever
            self._released.append(int.from_bytes(lease.mac[:6], "big"))
        self._events.append(("lease", event, {
            "mac": lease.mac.hex(), "ip": lease.ip, "pool_id": lease.pool_id,
            "expiry": lease.expiry, "username": lease.username,
            "qos_policy": lease.qos_policy}, sid))

    # -- RADIUS fan-out (worker-local auth + CoA actions) -----------------

    def _radius_auth(self, username="", password="", mac=b"",
                     circuit_id=b"", **kw):
        """Worker-shard authenticator (the cli closure's fleet twin):
        auth over this worker's own RadiusClient, degraded fallback from
        the worker-local profile cache on full-timeout — an outage must
        not evict paying subscribers, and a REJECT is never cached."""
        self.auth_requests += 1
        res = self.radius.authenticate(username, password, mac=mac,
                                       circuit_id=circuit_id)
        key = username or mac.hex()
        if res is None:
            cached = self._radius_degraded.degraded_auth(key, self.clock())
            if cached is not None:
                self.auth_degraded += 1
                return {"qos_policy": cached.policy_name,
                        "framed_ip": cached.framed_ip}
            return None
        if not res.success:
            return None
        from bng_tpu_torch.control.resilience import CachedProfile

        self._radius_degraded.cache_profile(CachedProfile(
            username=key, policy_name=res.policy_name,
            framed_ip=res.framed_ip, cached_at=self.clock()))
        profile = {"qos_policy": res.policy_name,
                   "framed_ip": res.framed_ip, **res.attributes}
        if res.session_timeout:
            profile["lease_time"] = res.session_timeout
        return profile

    def handle_coa(self, action: str, mac_u64: int = 0, ip: int = 0,
                   session_id: str = "", policy_name: str = "") -> dict:
        """CoA/Disconnect actions against THIS shard's lease book.
        `locate` finds without mutating (the fleet's steering probe);
        `qos` re-plans a live lease; `disconnect` force-expires it. The
        mutations ride the same drained event stream as DHCP handling,
        so the parent's single-writer replay sees them in order."""
        lease = None
        if mac_u64:
            lease = self.server.leases.get(mac_u64)
        if lease is None and (ip or session_id):
            for cand in self.server.leases.values():
                if (ip and cand.ip == ip) or \
                        (session_id and cand.session_id == session_id):
                    lease = cand
                    break
        out = {"found": lease is not None, "ip": 0, "events": [],
               "releases": [], "stats": None}
        if lease is None:
            return out
        out["ip"] = lease.ip
        if action == "qos":
            lease.qos_policy = policy_name
            self._events.append(("qos", lease.ip, policy_name))
            # re-push through the lease-event seam so HA replication
            # sees the new plan — else failover restores pre-CoA QoS
            self._lease_event("renew", lease, lease.session_id)
        elif action == "disconnect":
            lease.expiry = 0
            self.server.cleanup_expired(1)  # reaps only the forced lease
        out["events"] = self.tables.drain() + self._drain_events()
        out["releases"] = self._drain_released()
        out["stats"] = self._stats()
        return out

    # -- batch handling ---------------------------------------------------

    def handle_batch(self, items: list, now: float | None = None) -> dict:
        """[(lane, frame)] -> {"results", "events", "offers", "acks",
        "releases", "pending", "refill", "stats"}. One poison frame must
        not kill the worker or shift any other lane's result."""
        t0 = time.perf_counter()
        if self.nexus_resilience is not None:
            # drive the partition FSM here (the worker's only periodic
            # entry point); check_interval_s gates the actual probes so
            # this is a float compare per batch, not an HTTP call
            self.nexus_resilience.tick(self.clock())
        results = []
        offers, acks, releases = [], [], []
        hist = self._lat_hist
        if hist is None and tele.enabled():
            # armed after construction (inline workers share the parent
            # interpreter): start recording from this batch on
            hist = self._lat_hist = LatencyHist()
        for lane, frame in items:
            reply = None
            tf = time.perf_counter() if hist is not None else 0.0
            try:
                reply = self.demux(frame)
            except Exception:  # noqa: BLE001 — untrusted wire input
                self.errors += 1
            if hist is not None:
                hist.record((time.perf_counter() - tf) * 1e6)
            if reply is not None:
                peek = peek_reply(reply)
                if peek is not None:
                    if peek[0] == dhcp_codec.OFFER:
                        offers.append(peek[1])
                    elif peek[0] == dhcp_codec.ACK:
                        acks.append(peek[1])
            results.append((lane, reply))
        self.frames += len(items)
        self.batches += 1
        self.busy_s += time.perf_counter() - t0
        releases += self._drain_released()
        return {
            "results": results,
            "events": self.tables.drain() + self._drain_events(),
            "offers": offers, "acks": acks, "releases": releases,
            "pending": self.demux.drain_pending(),
            "refill": self._refill_wanted(),
            "stats": self._stats(),
        }

    def _drain_events(self) -> list:
        out, self._events = self._events, []
        return out

    def _drain_released(self) -> list:
        out, self._released = self._released, []
        return out

    def _refill_wanted(self) -> list:
        """[(pool_id, want)] for slices under the low watermark."""
        want = []
        for pid, p in self.pools.pools.items():
            free = p.free_count
            if free < self.spec.low_watermark:
                want.append((pid, self.spec.slice_size - free))
        return want

    def apply_grant(self, grants: list) -> None:
        for pid, ips in grants:
            p = self.pools.pools.get(pid)
            if p is not None:
                p.grant(ips)

    def expire(self, now: int, max_reaps: int | None = None) -> dict:
        n = self.server.cleanup_expired(now, max_reaps=max_reaps)
        return {"expired": n,
                "events": self.tables.drain() + self._drain_events(),
                "releases": self._drain_released(),
                "stats": self._stats()}

    def _stats(self) -> dict:
        out = {
            "frames": self.frames, "batches": self.batches,
            "errors": self.errors, "busy_s": self.busy_s,
            "leases": len(self.server.leases),
            "demux": dict(self.demux.stats),
            "slice_free": {pid: p.free_count
                           for pid, p in self.pools.pools.items()},
            # slice exhaustion (refill couldn't keep up / parent pool
            # dry) surfaces through the server's counted degradations
            "pool_exhausted": self.server.stats.pool_exhausted,
        }
        if self.radius is not None:
            out["radius"] = dict(self.radius.stats)
            out["auth_requests"] = self.auth_requests
            out["auth_degraded"] = self.auth_degraded
        if self._lat_hist is not None and self._lat_hist.n:
            # ship-and-reset: the parent folds each shipped delta into
            # its tracer (merge = addition, so deltas compose exactly)
            out["lat_hist"] = self._lat_hist.to_dict()
            self._lat_hist = LatencyHist()
        return out

    # -- checkpoint -------------------------------------------------------

    def export_state(self) -> dict:
        return self.server.export_leases()

    def export_transfer(self) -> dict:
        """Live-transfer state (fleet resize / rolling restart): the
        checkpoint lease book PLUS the in-flight DORA state (un-ACKed
        OFFERs — a checkpoint drops them because a restart client just
        re-DISCOVERs, but a live transition must not strand a client
        whose OFFER is outstanding) and the granted slice map (so the
        parent can release un-held addresses / re-grant verbatim)."""
        st = self.server.export_leases()
        st["offers"] = self.server.export_offers()
        st["granted"] = {int(pid): sorted(int(i) for i in p._granted)
                         for pid, p in self.pools.pools.items()}
        return st

    def restore_state(self, state: dict) -> int:
        """Hydrate the lease book (and, for live transfers, the in-flight
        OFFER state). `revoke` lists every restored address fleet-wide:
        whichever worker's INITIAL slice happened to cover an address
        withdraws it first (ownership moves to the lease's hash-owner),
        then the owner grants + re-claims its own leases — so a fresh
        DORA can never double-assign a restored subscriber's address."""
        for ip in state.get("revoke", ()):
            pool = self.pools.pool_for_ip(int(ip))
            if pool is not None:
                pool.revoke(int(ip))
        ips = [int(d["ip"]) for d in state.get("leases", [])]
        ips += [int(o["ip"]) for o in state.get("offers", [])]
        for ip in ips:
            pool = self.pools.pool_for_ip(ip)
            if pool is not None:
                pool.grant([ip])
        restored = self.server.restore_leases(state)
        restored += self.server.restore_offers(state.get("offers", []))
        return restored


def _worker_main(conn, spec: FleetSpec, worker_id: int,
                 n_workers: int) -> None:
    """Child-process loop: message-driven, never dies on handler input
    (per-frame isolation lives in FleetWorker.handle_batch)."""
    ctx_enter("worker")
    worker = FleetWorker(spec, worker_id, n_workers)

    def refill_now(pool_id: int) -> None:
        # mid-batch synchronous refill: the parent is blocked in its
        # gather loop for this worker and answers refill_req inline
        # (always with a grant message, possibly empty), so this recv
        # cannot deadlock
        conn.send(("refill_req", [(pool_id, spec.slice_size)]))
        tag, payload = conn.recv()
        if tag == "grant":
            worker.apply_grant(payload)

    worker.refill_now = refill_now
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            kind = msg[0]
            if kind == "batch":
                conn.send(("result", worker.handle_batch(msg[1], msg[2])))
            elif kind == "grant":
                worker.apply_grant(msg[1])
            elif kind == "expire":
                conn.send(("expired", worker.expire(
                    msg[1], msg[2] if len(msg) > 2 else None)))
            elif kind == "export":
                conn.send(("state", worker.export_state()))
            elif kind == "export_transfer":
                conn.send(("state", worker.export_transfer()))
            elif kind == "restore":
                conn.send(("restored", worker.restore_state(msg[1])))
            elif kind == "coa":
                conn.send(("coa", worker.handle_coa(msg[1], **msg[2])))
            elif kind == "stop":
                break
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# the fleet (parent side)
# ---------------------------------------------------------------------------

@owned_by("loop", attrs=None)
class SlowPathFleet:
    """N shared-nothing slow-path workers behind admission control.

    Ownership (BNG_SANITIZE): every mutation belongs to the loop
    context — transitions (resize/rolling restart) run on the loop
    thread via the OpsController drain, reads from the ctl/scrape
    threads go through stats_snapshot()/busy_seconds_total() under the
    app's _ctl. The @owned_by stamp turns a reintroduced cross-context
    reach-in (the pre-PR-7 `_pending`/`_dead` class) into a loud
    OwnershipViolation in sanitizer runs.

    `handle_batch` is the engine's `slow_path_batch` hook: it fans a
    slow-lane batch out to the owning workers, fans replies back in
    **re-merged in lane order**, replays worker table events into the
    parent's single-writer host mirrors, and services lease-slice
    refills — the only cross-worker coordination point.
    """

    def __init__(self, spec: FleetSpec, n_workers: int, pools: PoolManager,
                 mode: str = "process",
                 admission: AdmissionConfig | None = None,
                 table_sink=None, qos_hook=None, nat_hook=None,
                 lease_hook=None,
                 fallback: Callable[[bytes], bytes | None] | None = None,
                 start_method: str | None = None,
                 clock: Callable[[], float] | None = None,
                 worker_factory: Callable[[int, int], FleetWorker] | None = None):
        if mode not in ("process", "inline"):
            raise ValueError(f"fleet mode {mode!r}: expected "
                             f"'process' or 'inline'")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.spec = spec
        self.n = n_workers
        self.pools = pools
        self.mode = mode
        self.clock = clock or time.time
        self.admission = AdmissionController(admission, clock=self.clock)
        self.table_sink = table_sink
        self.qos_hook = qos_hook
        self.nat_hook = nat_hook
        self.lease_hook = lease_hook
        self.fallback = fallback
        self.refills = 0
        self.refill_ips_granted = 0
        self.fallback_frames = 0
        self.fallback_errors = 0
        self._fallback_err_log = SlowPathErrorLog("fleet-fallback")
        self.batches = 0
        self.worker_failures = 0  # dead-worker batch losses (IPC errors)
        # CoA fan-out: found on the steered shard / relayed
        # to another shard (missteered — no MAC in the request, or the
        # lease moved) / not found anywhere
        self.coa_handled = 0
        self.coa_relayed = 0
        self.coa_misses = 0
        # workers killed by the chaos harness (fleet.scatter `kill`):
        # process mode terminates the child AND marks it here so the
        # maintenance fan-outs stop talking to a dead pipe; inline mode
        # uses the mark alone (deterministic scenarios)
        self._dead: set[int] = set()
        self.start_method = None  # set for process mode below
        self._pending: list[bytes] = []
        self._last_stats: list[dict] = [{} for _ in range(n_workers)]
        # monotonic fold of dead worker sets' slice-exhaustion counts:
        # per-worker ServerStats restart at 0 on resize/rolling restart,
        # and a counter metric fed from live stats alone would move
        # BACKWARD across a transition (same ship-and-reset discipline
        # as the worker latency histograms)
        self.pool_exhausted_folded = 0
        self._procs: list = []
        self._conns: list = []
        self._inline: list[FleetWorker] = []
        self._worker_factory = worker_factory
        self._mp_ctx = None
        # zero-downtime transition counters (bng_ops_* families)
        self.resizes = 0
        self.rolling_restarts = 0
        if mode == "process":
            import multiprocessing as mp
            import sys

            method = start_method or os.environ.get("BNG_FLEET_START")
            if method is None:
                # spawn re-imports the parent's __main__ in the child;
                # when __main__ is not importable (stdin scripts, REPLs:
                # __file__ == '<stdin>' or missing) every child dies at
                # startup with FileNotFoundError — fall back to fork,
                # which needs no re-import
                main = sys.modules.get("__main__")
                spec_name = getattr(getattr(main, "__spec__", None),
                                    "name", None)
                main_file = getattr(main, "__file__", None)
                spawn_safe = (spec_name is not None or main_file is None
                              or os.path.exists(main_file))
                method = "spawn" if spawn_safe else "fork"
            self._mp_ctx = mp.get_context(method)
            self.start_method = method
        self._spawn_workers()
        self._initial_grant()

    # -- worker lifecycle (shared by __init__, resize, rolling restart) --

    def _make_inline(self, i: int) -> FleetWorker:
        make = self._worker_factory or (
            lambda w, n: FleetWorker(self.spec, w, n, clock=self.clock))
        worker = make(i, self.n)
        worker.refill_now = (lambda pid, _w=i: self._refill_sync(_w, pid))
        return worker

    def _spawn_one(self, i: int) -> tuple:
        """(process, conn) for worker slot i — caller owns the telemetry
        env window (see _spawn_workers)."""
        parent, child = self._mp_ctx.Pipe(duplex=True)
        p = self._mp_ctx.Process(target=_worker_main,
                                 args=(child, self.spec, i, self.n),
                                 daemon=True,
                                 name=f"bng-slowpath-w{i}")
        p.start()
        child.close()
        return p, parent

    class _telemetry_env:
        """Children build their own per-frame latency histograms only
        when the parent traces — env is the only channel that survives
        both spawn and fork. Set ONLY around the worker starts and
        restored after: a leaked BNG_TELEMETRY=1 would force-arm every
        later BNGApp in this process and make every later fleet's
        workers pay armed per-frame costs forever."""

        def __enter__(self):
            self.was = os.environ.get("BNG_TELEMETRY")
            self.set = tele.enabled()
            if self.set:
                os.environ["BNG_TELEMETRY"] = "1"
            return self

        def __exit__(self, *exc):
            # every child inherited its env at start(); restore ours even
            # when a spawn fails mid-loop (a leaked armed flag outlives
            # this fleet, per the warning above)
            if self.set:
                if self.was is None:
                    os.environ.pop("BNG_TELEMETRY", None)
                else:
                    os.environ["BNG_TELEMETRY"] = self.was

    def _spawn_workers(self) -> None:
        """Build a fresh worker set for the CURRENT self.n."""
        if self.mode == "inline":
            self._inline = [self._make_inline(i) for i in range(self.n)]
            return
        with self._telemetry_env():
            for i in range(self.n):
                p, conn = self._spawn_one(i)
                self._procs.append(p)
                self._conns.append(conn)

    def _stop_worker(self, w: int) -> None:
        """Tear down one worker slot (process mode: stop + join; inline:
        the object is simply replaced)."""
        if self.mode == "inline":
            return
        conn, p = self._conns[w], self._procs[w]
        try:
            conn.send(("stop",))
        except (BrokenPipeError, OSError):
            pass
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
        try:
            conn.close()
        except OSError:
            pass

    def _stop_workers(self) -> None:
        for w in range(len(self._procs)):
            self._stop_worker(w)
        self._procs.clear()
        self._conns.clear()
        self._inline.clear()

    # -- lease-slice coordination (the parent pools stay the authority) --

    def _carve(self, pool_id: int, want: int, worker: int) -> list[int]:
        """Claim up to `want` addresses from the parent pool for a
        worker. Claimed addresses are marked allocated in the parent
        (owner 'fleet:wN'), so cross-worker double allocation is
        structurally impossible."""
        pool = self.pools.pools.get(pool_id)
        if pool is None:
            return []
        out = []
        owner = f"fleet:w{worker}"
        for _ in range(want):
            try:
                out.append(pool.allocate(owner))
            except PoolExhaustedError:
                break
        return out

    def _initial_grant(self) -> None:
        for pid, pool in self.pools.pools.items():
            # fair first carve: don't let worker 0 drain a small pool
            per = max(1, min(self.spec.slice_size,
                             max(0, pool.size - pool.used) // self.n))
            for w in range(self.n):
                ips = self._carve(pid, per, w)
                if ips:
                    self._grant(w, [(pid, ips)])

    def _initial_grant_for(self, w: int) -> None:
        """Fresh initial slices for ONE worker slot (rolling restart of a
        worker whose book was lost with its process)."""
        for pid, pool in self.pools.pools.items():
            per = max(1, min(self.spec.slice_size,
                             max(0, pool.size - pool.used) // self.n))
            ips = self._carve(pid, per, w)
            if ips:
                self._grant(w, [(pid, ips)])

    def _grant(self, worker: int, grants: list) -> None:
        self.refill_ips_granted += sum(len(ips) for _, ips in grants)
        if self.mode == "inline":
            self._inline[worker].apply_grant(grants)
        else:
            self._conns[worker].send(("grant", grants))

    def _service_refill(self, worker: int, wanted: list) -> None:
        grants = self._carve_grants(worker, wanted)
        if grants:
            self.refills += 1
            self._grant(worker, grants)

    def _carve_grants(self, worker: int, wanted: list) -> list:
        grants = []
        for pid, want in wanted:
            ips = self._carve(pid, want, worker)
            if ips:
                grants.append((pid, ips))
        return grants

    def _refill_sync(self, worker: int, pool_id: int) -> None:
        """Inline-mode mid-batch refill (the worker's slice ran dry)."""
        grants = self._carve_grants(worker, [(pool_id,
                                              self.spec.slice_size)])
        if grants:
            self.refills += 1
            self.refill_ips_granted += sum(len(i) for _p, i in grants)
            self._inline[worker].apply_grant(grants)

    def _gather(self, worker: int, expect: str):
        """Receive one `expect`-tagged message from a worker process,
        servicing mid-batch refill_req messages inline. The reply to a
        refill_req is ALWAYS a grant (possibly empty) — the child blocks
        on it."""
        conn = self._conns[worker]
        while True:
            tag, payload = conn.recv()
            if tag == "refill_req":
                grants = self._carve_grants(worker, payload)
                if grants:
                    self.refills += 1
                    self.refill_ips_granted += sum(
                        len(i) for _p, i in grants)
                conn.send(("grant", grants))
                continue
            if tag != expect:
                raise RuntimeError(
                    f"fleet worker {worker}: unexpected reply {tag!r} "
                    f"(wanted {expect!r})")
            return payload

    # -- chaos harness hooks (chaos/faults.py) --------------------

    def _scatter_fault(self, w: int, groups: dict,
                       now: float | None = None) -> bool:
        """fault_point('fleet.scatter') on the per-worker batch dispatch
        — the pipe protocol's failure surface. Returns True when this
        worker's batch is LOST (kill / drop_batch / already dead);
        dup_batch and reorder mutate the delivery and the batch still
        runs. Disarmed cost: one no-op call per worker-group."""
        fp = fault_point("fleet.scatter")
        if fp is not None:
            if fp.kind == "kill":
                self._kill_worker(w)
            elif fp.kind == "drop_batch":
                self._note_worker_failure(w)
                return True
            elif fp.kind == "reorder":
                # pipe reorder: lanes arrive at the worker out of order;
                # the parent's lane-sorted re-merge must absorb it
                groups[w] = list(reversed(groups[w]))
            elif fp.kind == "dup_batch" and self.mode == "inline" \
                    and w not in self._dead:
                # at-least-once delivery: the worker handles the batch
                # twice. The duplicate's table events / admission
                # feedback absorb normally (idempotent upserts); its
                # replies are superseded by the second pass.
                self._absorb(w, self._inline[w].handle_batch(
                    list(groups[w]),
                    now if now is not None else self.clock()))
        if w in self._dead:
            self._note_worker_failure(w)
            return True
        return False

    def _kill_worker(self, w: int) -> None:
        """The chaos `kill` fault: a real terminate in process mode (the
        pipe dies mid-protocol — the existing IPC-failure handling owns
        the fallout), a permanent dead-mark in inline mode. Either way
        the worker's shard loses service until a restart; its carved
        slices stay allocated in the parent pool, so no other worker can
        ever double-assign its addresses."""
        self._dead.add(w)
        if self.mode == "process":
            try:
                self._procs[w].terminate()
                self._procs[w].join(timeout=2)
            except (OSError, ValueError):
                pass

    # -- the hot path -----------------------------------------------------

    def handle_batch(self, items: list, now: float | None = None) -> list:
        """[(lane, frame)] or [(lane, frame, enq_t)] -> [(lane, reply)]
        in ascending lane order. Shed frames return (lane, None)."""
        now = now if now is not None else self.clock()
        self.batches += 1
        groups: dict[int, list] = {}
        results: list[tuple[int, bytes | None]] = []
        shed_n = 0
        t0 = tele.t()
        depth: dict[int, int] = {}
        for item in items:
            lane, frame = item[0], item[1]
            enq_t = item[2] if len(item) > 2 else None
            if self.fallback is not None and not classify_dhcp(frame):
                # non-DHCPv4 slow traffic (v6 / SLAAC / PPPoE /
                # poison) stays on the parent's demux — the fleet
                # shards DHCPv4
                self.fallback_frames += 1
                try:
                    results.append((lane, self.fallback(frame)))
                except Exception as e:  # noqa: BLE001 — untrusted wire input
                    self.fallback_errors += 1
                    self._fallback_err_log.report(e, lane=lane)
                    results.append((lane, None))
                continue
            w = shard_for_frame(frame, self.n)
            ok, _reason = self.admission.admit(
                frame, depth.get(w, 0), now, enq_t)
            if not ok:
                shed_n += 1
                results.append((lane, None))
                continue
            groups.setdefault(w, []).append((lane, frame))
            depth[w] = depth.get(w, 0) + 1
        tele.lap(tele.ADMIT, t0)
        tele.add(shed=shed_n)
        t0 = tele.t()
        if groups:
            if self.mode == "inline":
                for w in sorted(groups):
                    if self._scatter_fault(w, groups, now):
                        results.extend((lane, None)
                                       for lane, _f in groups[w])
                        continue
                    out = self._inline[w].handle_batch(groups[w], now)
                    results.extend(self._absorb(w, out))
            else:
                # scatter first so every child computes concurrently,
                # THEN gather. A dead worker (IPC error) loses only ITS
                # lanes — the client retransmits; other shards and later
                # batches are unaffected.
                sent = []
                for w in sorted(groups):
                    if self._scatter_fault(w, groups, now):
                        results.extend((lane, None)
                                       for lane, _f in groups[w])
                        continue
                    try:
                        self._conns[w].send(("batch", groups[w], now))
                        sent.append(w)
                    except (OSError, ValueError):
                        self._note_worker_failure(w)
                        results.extend((lane, None)
                                       for lane, _f in groups[w])
                for w in sent:
                    try:
                        results.extend(self._absorb(
                            w, self._gather(w, "result")))
                    except (OSError, EOFError):
                        self._note_worker_failure(w)
                        results.extend((lane, None)
                                       for lane, _f in groups[w])
        tele.lap(tele.FLEET, t0)
        results.sort(key=lambda t: t[0])
        return results

    def _note_worker_failure(self, w: int) -> None:
        """One dead/failed worker batch: counted AND surfaced to the
        flight recorder (gray failures hide in counters; a worker death
        must leave the last-N batch evidence on disk)."""
        self.worker_failures += 1
        tele.trigger("worker_death", f"worker {w} lost a batch")

    def _absorb(self, worker: int, out: dict) -> list:
        """Fold one worker's batch result into parent state (events ->
        single-writer tables, offer/ack feedback -> admission, refill
        service, pending frames) and return its lane results."""
        apply_table_events(out["events"], self.table_sink,
                          self.qos_hook, self.nat_hook, self.lease_hook)
        # releases BEFORE offers/acks: a lease replaced within the batch
        # emits stop(old) + ACK(new) for one MAC — the re-lease must win
        for mac in out["releases"]:
            self.admission.note_release(mac)
        for mac in out["offers"]:
            self.admission.note_offer(mac)
        for mac in out["acks"]:
            self.admission.note_ack(mac)
        self._pending.extend(out["pending"])
        if out["refill"]:
            self._service_refill(worker, out["refill"])
        self._last_stats[worker] = out["stats"]
        tr = tele.tracer()
        if tr is not None and "lat_hist" in out["stats"]:
            # cross-process histogram merge: the worker's per-frame
            # handler-latency delta folds into the parent's `worker`
            # stage (merge = counter addition — worker order never
            # changes the distribution)
            tr.merge_stage(tele.WORKER, out["stats"]["lat_hist"])
        return out["results"]

    def handle_frame(self, frame: bytes) -> bytes | None:
        """Single-frame facade (the plain `slow_path` signature)."""
        out = self.handle_batch([(0, frame)])
        return out[0][1] if out else None

    def drain_pending(self) -> list[bytes]:
        """Extra frames beyond one-reply-per-input (the demux pending
        contract), merged in worker-arrival order — deterministic
        because workers are gathered in index order."""
        out, self._pending = self._pending, []
        return out

    def requeue(self, frames: list[bytes], front: bool = False) -> None:
        """Public re-queue onto the pending queue (the drain_pending
        counterpart): the composition root puts back frames it could not
        TX-inject this beat (`front=True` preserves wire order) instead
        of reaching into the private list."""
        if front:
            self._pending[:0] = frames
        else:
            self._pending.extend(frames)

    # -- CoA fan-out ------------------------------------------------------

    def _coa_one(self, w: int, action: str, kw: dict) -> dict | None:
        """One shard's CoA verdict, with its event stream folded through
        the parent's single-writer replay (same discipline as batches)."""
        try:
            if self.mode == "inline":
                out = self._inline[w].handle_coa(action, **kw)
            else:
                self._conns[w].send(("coa", action, kw))
                out = self._gather(w, "coa")
        except (OSError, EOFError):
            self._note_worker_failure(w)
            return None
        apply_table_events(out["events"], self.table_sink,
                          self.qos_hook, self.nat_hook, self.lease_hook)
        for mac in out["releases"]:
            self.admission.note_release(mac)
        if out["stats"] is not None:
            self._last_stats[w] = out["stats"]
        return out

    def handle_coa(self, action: str, mac: bytes = b"", ip: int = 0,
                   session_id: str = "", policy_name: str = "") -> dict:
        """Route a CoA/Disconnect action to the owning shard. With a MAC
        the steering hash names the owner directly (auth affinity = DHCP
        affinity = CoA affinity); otherwise — or when the steered shard
        misses — the remaining shards are probed in index order and a
        hit counts as a relay. Returns {found, ip, worker, relayed}."""
        kw = {"mac_u64": int.from_bytes(mac[:6].rjust(6, b"\0"), "big")
              if mac else 0,
              "ip": ip, "session_id": session_id,
              "policy_name": policy_name}
        steered = shard_for_mac(mac, self.n) if mac else 0
        order = [steered] + [w for w in range(self.n) if w != steered]
        for w in order:
            if w in self._dead:
                continue
            out = self._coa_one(w, action, kw)
            if out is None or not out["found"]:
                continue
            relayed = bool(mac) and w != steered
            self.coa_handled += 1
            if relayed:
                self.coa_relayed += 1
            return {"found": True, "ip": out["ip"], "worker": w,
                    "relayed": relayed}
        self.coa_misses += 1
        return {"found": False, "ip": 0, "worker": -1, "relayed": False}

    # -- maintenance ------------------------------------------------------

    def expire(self, now: int, max_reaps: int | None = None) -> int:
        """Lease-expiry sweep across every worker (the parent tick's
        cleanup_expired role). `max_reaps` is a PER-WORKER teardown
        bound (each worker's sweep is its own serial section; bounding
        per shard keeps the tick budget proportional to fleet width the
        same way batch handling is)."""
        total = 0
        if self.mode == "inline":
            for w, worker in enumerate(self._inline):
                if w in self._dead:
                    continue
                out = worker.expire(now, max_reaps)
                total += self._absorb_expire(w, out)
        else:
            sent = []
            for w, conn in enumerate(self._conns):
                if w in self._dead:
                    continue
                try:
                    conn.send(("expire", now, max_reaps))
                    sent.append(w)
                except (OSError, ValueError):
                    self._note_worker_failure(w)
            for w in sent:
                try:
                    total += self._absorb_expire(w,
                                                 self._gather(w, "expired"))
                except (OSError, EOFError):
                    self._note_worker_failure(w)
        return total

    def _absorb_expire(self, worker: int, out: dict) -> int:
        apply_table_events(out["events"], self.table_sink,
                          self.qos_hook, self.nat_hook, self.lease_hook)
        for mac in out.get("releases", ()):
            self.admission.note_release(mac)
        self._last_stats[worker] = out["stats"]
        tr = tele.tracer()
        if tr is not None and "lat_hist" in out["stats"]:
            # the worker ships-and-resets its histogram with EVERY stats
            # payload — an expire-path delta dropped here would be lost
            tr.merge_stage(tele.WORKER, out["stats"]["lat_hist"])
        return out["expired"]

    # -- checkpoint (runtime/checkpoint.py 'fleet' component) -------------

    def export_state(self) -> dict:
        """Per-worker lease books for the checkpoint payload. Slice
        free-lists are transient (like the server's _offers) — on
        restore, workers get fresh slices and each restored lease's IP
        is re-claimed explicitly."""
        if self.mode == "inline":
            # dead (chaos-killed) inline workers keep their books in
            # memory — a checkpoint still captures their leases
            workers = [dict(w.export_state(), worker_id=i)
                       for i, w in enumerate(self._inline)]
        else:
            # a KNOWN-dead process's book is gone: snapshot the
            # survivors rather than failing the whole checkpoint. A
            # LIVE worker's IPC failure still raises — a silently
            # partial snapshot saved as good would un-claim a whole
            # shard's addresses on restore (double-allocation), which is
            # strictly worse than keeping the previous good checkpoint.
            workers = []
            for w, conn in enumerate(self._conns):
                if w in self._dead:
                    continue
                conn.send(("export",))
                workers.append(dict(self._gather(w, "state"),
                                    worker_id=w))
        return {"n_workers": self.n, "workers": workers}

    @staticmethod
    def parse_state(state: dict) -> int:
        """Dry-parse (the restore pre-check role): raises on a corrupt
        fleet blob, touches nothing. Returns the total lease count."""
        from bng_tpu_torch.control.dhcp_server import DHCPServer

        total = 0
        for wstate in state["workers"]:
            _seq, leases = DHCPServer.parse_lease_state(wstate)
            total += len(leases)
        return total

    def restore_state(self, state: dict) -> int:
        """Re-shard the checkpointed lease books onto the CURRENT worker
        count (the MAC hash decides, so a changed --slowpath-workers
        still lands every subscriber on its new owner), claim each
        lease's IP in the parent pool, and hydrate the owners."""
        return self._hydrate_books(state["workers"])

    def _hydrate_books(self, books: list[dict]) -> int:
        """The shared re-shard + hydrate core: checkpoint restore and
        live resize both route every lease (and, for live transfers,
        every in-flight OFFER) to its MAC-hash owner at the CURRENT
        worker count — bit-for-bit the ring classifier's steering hash,
        so restore-time and resize-time ownership can never diverge."""
        per_worker: list[dict] = [
            {"session_seq": 0, "leases": [], "offers": []}
            for _ in range(self.n)]
        all_ips: list[int] = []
        for wstate in books:
            seq = int(wstate.get("session_seq", 0))
            for d in wstate.get("leases", []):
                mac = bytes.fromhex(d["mac"])
                w = shard_for_mac(mac, self.n)
                per_worker[w]["leases"].append(d)
                per_worker[w]["session_seq"] = max(
                    per_worker[w]["session_seq"], seq)
                all_ips.append(int(d["ip"]))
            for o in wstate.get("offers", []):
                w = shard_for_mac(bytes.fromhex(o["mac"]), self.n)
                per_worker[w]["offers"].append(o)
                all_ips.append(int(o["ip"]))
        restored = 0
        for w, wstate in enumerate(per_worker):
            for ip in ([int(d["ip"]) for d in wstate["leases"]]
                       + [int(o["ip"]) for o in wstate["offers"]]):
                # parent-side ownership transfer: the address may sit in
                # ANOTHER worker's initial free slice — release that
                # claim, then re-claim for the lease's hash-owner, so it
                # is out of every other worker's reach before the owner
                # re-leases it (the workers revoke their side below)
                pool = self.pools.pool_for_ip(ip)
                if pool is None:
                    continue
                owner_tag = f"fleet:w{w}"
                cur = pool._allocated.get(ip)
                if cur is not None and cur != owner_tag:
                    pool.release(ip)
                pool.allocate_specific(ip, owner_tag)
            # every worker gets the full revoke list: initial slices are
            # carved before restore, so any worker may hold any address
            wstate["revoke"] = all_ips
            if self.mode == "inline":
                restored += self._inline[w].restore_state(wstate)
            elif w not in self._dead:
                # a chaos-killed process can't hydrate its shard; the
                # parent-side claims above still protect every restored
                # address from double-allocation (service degraded,
                # consistency intact)
                self._conns[w].send(("restore", wstate))
        if self.mode == "process":
            for w in range(self.n):
                if w not in self._dead:
                    restored += self._gather(w, "restored")
        return restored

    # -- zero-downtime operations (ROADMAP [ops-refactor]) ----------------

    def _export_transfer(self, w: int) -> dict | None:
        """One worker's live-transfer state, or None when the book is
        unknowable (dead process — its carved addresses stay allocated
        in the parent pool, so consistency survives the loss). Inline
        dead-marked workers keep their books in memory, so a transition
        HEALS them: the state moves, the subscriber never notices."""
        if self.mode == "inline":
            return dict(self._inline[w].export_transfer(), worker_id=w)
        if w in self._dead:
            return None
        try:
            self._conns[w].send(("export_transfer",))
            return dict(self._gather(w, "state"), worker_id=w)
        except (OSError, EOFError, BrokenPipeError):
            self._note_worker_failure(w)
            return None

    def resize(self, n_new: int) -> dict:
        """Live fleet elasticity: grow/shrink to `n_new` workers at a
        batch boundary (caller serializes against handle_batch), without
        dropping in-flight DORAs.

        Drain-then-transfer, transactional: phase 1 reads every knowable
        worker book + offer set (abortable — a chaos `fail` here leaves
        the old fleet serving untouched); phase 2 stops the old workers
        and releases their un-held slice addresses back to the parent
        pool; phase 3 builds the new worker set with fresh initial
        slices; phase 4 re-shards every lease AND every un-ACKed OFFER
        onto its new MAC-hash owner (the checkpoint-restore discipline),
        transferring parent-pool ownership address by address. The
        admission controller is parent-side state and rides through
        unchanged, so REQUEST-after-OFFER protection holds ACROSS the
        transition. Returns the transition report (bng_ops_* feed)."""
        if n_new < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_new}")
        t_all = time.perf_counter()
        report: dict = {"op": "fleet_resize", "from": self.n, "to": n_new}
        if n_new == self.n:
            report.update(outcome="noop", duration_s=0.0)
            return report
        # phase 1 — drain-then-transfer (read-only, abortable)
        t0 = tele.t()
        states: list[dict] = []
        lost: list[int] = []
        for w in range(self.n):
            fp = fault_point("fleet.resize")
            if fp is not None:
                if fp.kind == "kill":
                    self._kill_worker(w)
                elif fp.kind == "fail":
                    report.update(
                        outcome="aborted",
                        error="chaos: injected resize failure",
                        duration_s=time.perf_counter() - t_all)
                    return report
            st = self._export_transfer(w)
            if st is None:
                lost.append(w)
            else:
                states.append(st)
        tele.lap(tele.OPS, t0)
        # phase 2 — commit: stop the old fleet; un-held slice addresses
        # go back to the parent pool (a lost book's grants are unknowable
        # and stay allocated: consistency over reclamation)
        t0 = tele.t()
        self._stop_workers()
        held = {int(d["ip"]) for st in states for d in st["leases"]}
        held |= {int(o["ip"]) for st in states
                 for o in st.get("offers", [])}
        freed = 0
        for st in states:
            for pid, ips in st.get("granted", {}).items():
                pool = self.pools.pools.get(int(pid))
                if pool is None:
                    continue
                for ip in ips:
                    if int(ip) not in held and pool.release(int(ip)):
                        freed += 1
        # phase 3 — the new worker set + initial slices at the new count
        try:
            self.n = n_new
            self._dead.clear()
            self._fold_exhaustion()
            self._last_stats = [{} for _ in range(n_new)]
            self._spawn_workers()
            self._initial_grant()
            tele.lap(tele.OPS, t0)
            # phase 4 — re-shard + hydrate (checkpoint-restore hash)
            t0 = tele.t()
            restored = self._hydrate_books(states)
            tele.lap(tele.OPS, t0)
        except Exception as e:  # noqa: BLE001
            # past the commit point the old fleet is GONE and `states`
            # is the only copy of every lease and in-flight OFFER —
            # "transactional" must not end at phase 2. Salvage: rebuild
            # the smallest viable worker set and hydrate the exported
            # books into it (fd/process pressure that failed an N-worker
            # spawn usually still admits one; shard count changing again
            # is fine — _hydrate_books re-routes by the same hash).
            report.update(outcome="failed",
                          error=f"{type(e).__name__}: {e}"[:300])
            log = get_logger("fleet.resize")
            log.error("resize failed past commit point, salvaging",
                      to=n_new, error=report["error"],
                      books=len(states))
            for fallback in dict.fromkeys((n_new, 1)):
                try:
                    self._stop_workers()
                    self.n = fallback
                    self._dead.clear()
                    self._fold_exhaustion()
                    self._last_stats = [{} for _ in range(fallback)]
                    self._spawn_workers()
                    self._initial_grant()
                    restored = self._hydrate_books(states)
                except Exception as e2:  # noqa: BLE001 — next size down
                    log.error("salvage attempt failed", workers=fallback,
                              error=f"{type(e2).__name__}: {e2}")
                    continue
                self.resizes += 1
                report.update(
                    outcome="salvaged", to=fallback, restored=restored,
                    leases_moved=sum(len(s["leases"]) for s in states),
                    offers_moved=sum(len(s.get("offers", ()))
                                     for s in states),
                    slices_freed=freed, lost_workers=sorted(lost))
                break
            report["duration_s"] = time.perf_counter() - t_all
            return report
        self.resizes += 1
        report.update(
            outcome="ok", restored=restored,
            leases_moved=sum(len(s["leases"]) for s in states),
            offers_moved=sum(len(s.get("offers", ())) for s in states),
            slices_freed=freed, lost_workers=sorted(lost),
            duration_s=time.perf_counter() - t_all)
        return report

    def rolling_restart(self) -> dict:
        """Replace every worker one shard at a time under the same
        drain-then-transfer discipline as resize — the live-deploy /
        leak-recovery verb. Same worker count, same shard map: each
        worker's book, offer set and granted slices move verbatim into
        a fresh worker in the same slot (parent-pool owner tags never
        change), so no re-shard and no cross-shard transfer happens. A
        dead-marked process worker's book is gone — its replacement
        starts empty on fresh slices (subscribers re-DORA; the lost
        slices stay allocated: consistency over reclamation) — while a
        dead-marked INLINE worker's book is still in memory, so the
        rotation heals it with zero subscriber impact."""
        t_all = time.perf_counter()
        report: dict = {"op": "fleet_rolling_restart", "workers": self.n}
        replaced: list[int] = []
        healed: list[int] = []
        lost: list[int] = []
        moved = 0
        for w in range(self.n):
            fp = fault_point("fleet.restart")
            if fp is not None:
                if fp.kind == "kill":
                    self._kill_worker(w)
                elif fp.kind == "fail":
                    report.update(
                        outcome="aborted",
                        error="chaos: injected restart failure",
                        replaced=replaced, healed=healed, lost=lost,
                        leases_moved=moved,
                        duration_s=time.perf_counter() - t_all)
                    return report
            t0 = tele.t()
            was_dead = w in self._dead
            st = self._export_transfer(w)
            self._stop_worker(w)
            if self.mode == "inline":
                self._inline[w] = self._make_inline(w)
            else:
                with self._telemetry_env():
                    p, conn = self._spawn_one(w)
                self._procs[w], self._conns[w] = p, conn
            self._dead.discard(w)
            self.pool_exhausted_folded += int(
                self._last_stats[w].get("pool_exhausted", 0) or 0)
            self._last_stats[w] = {}
            if st is None:
                # fresh slices so the shard serves again
                self._initial_grant_for(w)
                lost.append(w)
                tele.lap(tele.OPS, t0)
                continue
            grants = [(int(pid), [int(i) for i in ips])
                      for pid, ips in st.pop("granted", {}).items()]
            if grants:
                self._grant(w, grants)
            st["revoke"] = []
            if self.mode == "inline":
                moved += self._inline[w].restore_state(st)
            else:
                self._conns[w].send(("restore", st))
                moved += self._gather(w, "restored")
            (healed if was_dead else replaced).append(w)
            tele.lap(tele.OPS, t0)
        self.rolling_restarts += 1
        report.update(outcome="ok", replaced=replaced, healed=healed,
                      lost=lost, leases_moved=moved,
                      duration_s=time.perf_counter() - t_all)
        return report

    # -- observability ----------------------------------------------------

    def _fold_exhaustion(self) -> None:
        """Absorb the outgoing worker set's slice-exhaustion counts into
        the monotonic fold — call exactly once per teardown, BEFORE the
        per-worker stats reset."""
        self.pool_exhausted_folded += sum(
            int(w.get("pool_exhausted", 0) or 0)
            for w in self._last_stats if w)

    def pool_exhausted_total(self) -> int:
        """Monotonic slice-exhaustion count across worker generations:
        folded dead-set counts + the live workers' latest payloads (the
        counter-metric read — never moves backward over a transition)."""
        return self.pool_exhausted_folded + sum(
            int(w.get("pool_exhausted", 0) or 0)
            for w in self._last_stats if w)

    def busy_seconds_total(self) -> float:
        """Cumulative handler-busy seconds across the worker set (from
        the latest per-worker stats payloads) — the autoscaler's load
        signal: sampled on a cadence, the delta over wall time is the
        fleet's mean busy fraction."""
        return sum(float(w.get("busy_s", 0.0))
                   for w in self._last_stats if w)

    def stats_snapshot(self) -> dict:
        return {
            "workers": self.n,
            "mode": self.mode,
            "start_method": self.start_method,
            "worker_failures": self.worker_failures,
            "dead_workers": sorted(self._dead),
            "batches": self.batches,
            "resizes": self.resizes,
            "rolling_restarts": self.rolling_restarts,
            "refills": self.refills,
            "refill_ips_granted": self.refill_ips_granted,
            "fallback_frames": self.fallback_frames,
            "fallback_errors": self.fallback_errors,
            "coa_handled": self.coa_handled,
            "coa_relayed": self.coa_relayed,
            "coa_misses": self.coa_misses,
            "per_worker": list(self._last_stats),
            "pool_exhausted_total": self.pool_exhausted_total(),
            "admission": self.admission.stats_snapshot(),
        }

    def close(self) -> None:
        if self.mode == "inline":
            return
        for conn in self._conns:
            try:
                conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()
        self._procs.clear()
