"""In-memory indexed state store — the embedded single-node alternative to
Nexus.

Parity: pkg/state/store.go — Store (:15) with subscriber/lease/pool/
session/NAT-binding records, by-MAC/by-IP/by-NTE indexes (:148-856),
FindPoolForSubscriber class matching (:356), pool name lookups (:330),
lease renew (:547), session activity accounting (:705), NAT-binding
endpoint lookups incl. by-public (the LEA-query shape, :803-833), list/
update CRUD, store stats (:129), and TTL cleanup — both explicit sweeps
and the background loops behind start()/stop() (:100-127, :858-1024).
Types: pkg/state/types.go:9-330.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field


def _locked(fn):
    """Store methods run under one re-entrant lock — the reference store
    is mutex-guarded throughout (store.go uses sync.RWMutex), and the
    background sweep thread would otherwise race foreground CRUD
    (dict-changed-during-iteration kills the sweeper silently)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._lock:
            return fn(self, *a, **k)

    return wrapper


@dataclass
class Subscriber:
    id: str
    mac: str = ""
    circuit_id: str = ""
    nte_id: str = ""
    client_class: int = 0
    isp_id: str = ""
    enabled: bool = True
    meta: dict = field(default_factory=dict)


@dataclass
class LeaseRecord:
    ip: str
    subscriber_id: str
    mac: str
    expires_at: float
    pool_id: str = ""


@dataclass
class PoolRecord:
    id: str
    cidr: str
    name: str = ""
    client_class: int = 0
    isp_id: str = ""
    enabled: bool = True


@dataclass
class SessionRecord:
    id: str
    subscriber_id: str
    ip: str = ""
    mac: str = ""
    started_at: float = 0.0
    last_seen: float = 0.0
    kind: str = "ipoe"  # ipoe | pppoe | wifi
    state: str = "active"
    bytes_in: int = 0
    bytes_out: int = 0


@dataclass
class NATBinding:
    private_ip: str
    public_ip: str
    port_start: int
    port_end: int
    subscriber_id: str = ""


class Store:
    def __init__(self, clock=time.time, lease_sweep_interval: float = 60.0,
                 session_idle_s: float = 3600.0):
        self.clock = clock
        self.lease_sweep_interval = lease_sweep_interval
        self.session_idle_s = session_idle_s
        self.subscribers: dict[str, Subscriber] = {}
        self.leases: dict[str, LeaseRecord] = {}  # by ip
        self.pools: dict[str, PoolRecord] = {}
        self.sessions: dict[str, SessionRecord] = {}
        self.nat_bindings: dict[str, NATBinding] = {}  # by private ip
        # indexes
        self._sub_by_mac: dict[str, str] = {}
        self._sub_by_cid: dict[str, str] = {}
        self._sub_by_nte: dict[str, set[str]] = {}
        self._sess_by_sub: dict[str, set[str]] = {}
        self._sess_by_mac: dict[str, str] = {}
        self._sess_by_ip: dict[str, str] = {}
        self._lease_by_mac: dict[str, str] = {}
        self._pool_by_name: dict[str, str] = {}
        # public ip -> sorted [(port_start, port_end, private_ip)] blocks
        self._nat_by_public: dict[str, list] = {}
        self._counters = {"leases_expired": 0, "sessions_reaped": 0}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- subscribers --
    @_locked
    def put_subscriber(self, s: Subscriber) -> None:
        old = self.subscribers.get(s.id)
        if old:
            self._unindex_subscriber(old)
        self.subscribers[s.id] = s
        if s.mac:
            self._sub_by_mac[s.mac.lower()] = s.id
        if s.circuit_id:
            self._sub_by_cid[s.circuit_id] = s.id
        if s.nte_id:
            self._sub_by_nte.setdefault(s.nte_id, set()).add(s.id)

    @_locked
    def get_subscriber(self, sub_id: str) -> Subscriber | None:
        return self.subscribers.get(sub_id)

    @_locked
    def subscriber_by_mac(self, mac: str) -> Subscriber | None:
        sid = self._sub_by_mac.get(mac.lower())
        return self.subscribers.get(sid) if sid else None

    @_locked
    def subscriber_by_circuit_id(self, cid: str) -> Subscriber | None:
        sid = self._sub_by_cid.get(cid)
        return self.subscribers.get(sid) if sid else None

    @_locked
    def subscribers_by_nte(self, nte_id: str) -> list[Subscriber]:
        return [self.subscribers[s] for s in self._sub_by_nte.get(nte_id, ())]

    @_locked
    def delete_subscriber(self, sub_id: str) -> bool:
        s = self.subscribers.pop(sub_id, None)
        if s is None:
            return False
        self._unindex_subscriber(s)
        return True

    def _unindex_subscriber(self, s: Subscriber) -> None:
        # ownership-guarded like every other index teardown: a MAC or
        # circuit-id reassigned to another subscriber must keep ITS entry
        if s.mac and self._sub_by_mac.get(s.mac.lower()) == s.id:
            del self._sub_by_mac[s.mac.lower()]
        if s.circuit_id and self._sub_by_cid.get(s.circuit_id) == s.id:
            del self._sub_by_cid[s.circuit_id]
        if s.nte_id:
            self._sub_by_nte.get(s.nte_id, set()).discard(s.id)

    # -- leases --
    @_locked
    def put_lease(self, l: LeaseRecord) -> None:
        self.leases[l.ip] = l
        self._lease_by_mac[l.mac.lower()] = l.ip

    @_locked
    def lease_by_ip(self, ip: str) -> LeaseRecord | None:
        return self.leases.get(ip)

    @_locked
    def lease_by_mac(self, mac: str) -> LeaseRecord | None:
        ip = self._lease_by_mac.get(mac.lower())
        return self.leases.get(ip) if ip else None

    @_locked
    def delete_lease(self, ip: str) -> bool:
        l = self.leases.pop(ip, None)
        if l is None:
            return False
        if self._lease_by_mac.get(l.mac.lower()) == ip:
            del self._lease_by_mac[l.mac.lower()]
        return True

    @_locked
    def update_subscriber(self, s: Subscriber) -> None:
        """Update-only variant (store.go:225): missing id is an error —
        a typo'd update must not silently create a ghost subscriber."""
        if s.id not in self.subscribers:
            raise KeyError(f"subscriber {s.id!r} not found")
        self.put_subscriber(s)

    @_locked
    def list_subscribers(self) -> list[Subscriber]:
        return list(self.subscribers.values())

    # -- pools --
    @_locked
    def put_pool(self, p: PoolRecord) -> None:
        old = self.pools.get(p.id)
        if old and old.name and self._pool_by_name.get(old.name) == p.id:
            self._pool_by_name.pop(old.name)
        self.pools[p.id] = p
        if p.name:
            self._pool_by_name[p.name] = p.id

    @_locked
    def get_pool(self, pool_id: str) -> PoolRecord | None:
        return self.pools.get(pool_id)

    @_locked
    def pool_by_name(self, name: str) -> PoolRecord | None:
        pid = self._pool_by_name.get(name)
        return self.pools.get(pid) if pid else None

    @_locked
    def list_pools(self) -> list[PoolRecord]:
        return list(self.pools.values())

    @_locked
    def delete_pool(self, pool_id: str) -> bool:
        p = self.pools.pop(pool_id, None)
        if p is None:
            return False
        if p.name and self._pool_by_name.get(p.name) == pool_id:
            del self._pool_by_name[p.name]
        return True

    @_locked
    def find_pool_for_subscriber(self, sub: Subscriber) -> PoolRecord | None:
        """Class/ISP matching (parity: FindPoolForSubscriber, store.go:356):
        exact class+isp > class > isp > any-enabled."""
        best, best_score = None, -1
        for p in self.pools.values():
            if not p.enabled:
                continue
            score = 0
            if p.client_class and p.client_class != sub.client_class:
                continue
            if p.isp_id and p.isp_id != sub.isp_id:
                continue
            score = (2 if p.client_class else 0) + (1 if p.isp_id else 0)
            if score > best_score:
                best, best_score = p, score
        return best

    # -- leases (cont.) --
    @_locked
    def renew_lease(self, ip: str, duration_s: float,
                    now: float | None = None) -> bool:
        """store.go:547: extend from NOW, not from the old expiry."""
        l = self.leases.get(ip)
        if l is None:
            return False
        l.expires_at = (now if now is not None else self.clock()) + duration_s
        return True

    @_locked
    def list_leases(self) -> list[LeaseRecord]:
        return list(self.leases.values())

    # -- sessions --
    @_locked
    def put_session(self, s: SessionRecord) -> None:
        old = self.sessions.get(s.id)
        if old:
            self._unindex_session(old)
        self.sessions[s.id] = s
        self._sess_by_sub.setdefault(s.subscriber_id, set()).add(s.id)
        if s.mac:
            self._sess_by_mac[s.mac.lower()] = s.id
        if s.ip:
            self._sess_by_ip[s.ip] = s.id

    def _unindex_session(self, s: SessionRecord) -> None:
        self._sess_by_sub.get(s.subscriber_id, set()).discard(s.id)
        if s.mac and self._sess_by_mac.get(s.mac.lower()) == s.id:
            del self._sess_by_mac[s.mac.lower()]
        if s.ip and self._sess_by_ip.get(s.ip) == s.id:
            del self._sess_by_ip[s.ip]

    @_locked
    def sessions_for(self, subscriber_id: str) -> list[SessionRecord]:
        return [self.sessions[i] for i in self._sess_by_sub.get(subscriber_id, ())]

    @_locked
    def session_by_mac(self, mac: str) -> SessionRecord | None:
        sid = self._sess_by_mac.get(mac.lower())
        return self.sessions.get(sid) if sid else None

    @_locked
    def session_by_ip(self, ip: str) -> SessionRecord | None:
        sid = self._sess_by_ip.get(ip)
        return self.sessions.get(sid) if sid else None

    @_locked
    def update_session_activity(self, session_id: str, bytes_in: int = 0,
                                bytes_out: int = 0,
                                now: float | None = None) -> bool:
        """store.go:705: accounting tick — counters accumulate and
        last_seen advances (keeps the idle reaper away)."""
        s = self.sessions.get(session_id)
        if s is None:
            return False
        s.bytes_in += bytes_in
        s.bytes_out += bytes_out
        s.last_seen = now if now is not None else self.clock()
        return True

    @_locked
    def list_sessions(self) -> list[SessionRecord]:
        return list(self.sessions.values())

    @_locked
    def delete_session(self, session_id: str) -> bool:
        s = self.sessions.pop(session_id, None)
        if s is None:
            return False
        self._unindex_session(s)
        return True

    # -- NAT bindings --
    @_locked
    def put_nat_binding(self, b: NATBinding) -> None:
        """Port-BLOCK bindings (RFC 6431): the by-public index is an
        interval list per public IP (bisect on block start), not one
        entry per port — a /26 pool of 1024-port blocks would otherwise
        carry millions of index entries."""
        import bisect

        old = self.nat_bindings.get(b.private_ip)
        if old:
            self.delete_nat_binding(old.private_ip)
        self.nat_bindings[b.private_ip] = b
        blocks = self._nat_by_public.setdefault(b.public_ip, [])
        bisect.insort(blocks, (b.port_start, b.port_end, b.private_ip))

    @_locked
    def nat_binding(self, private_ip: str) -> NATBinding | None:
        return self.nat_bindings.get(private_ip)

    @_locked
    def nat_binding_by_public(self, public_ip: str,
                              port: int) -> NATBinding | None:
        """Reverse lookup by public endpoint — the LEA-request shape
        (store.go:819-833; same query pkg/nat's compliance log answers)."""
        blocks = self._nat_by_public.get(public_ip, [])
        i = bisect.bisect_right(blocks, (port, float("inf"), "")) - 1
        if i >= 0:
            start, end, priv = blocks[i]
            if start <= port <= end:
                return self.nat_bindings.get(priv)
        return None

    @_locked
    def delete_nat_binding(self, private_ip: str) -> bool:
        b = self.nat_bindings.pop(private_ip, None)
        if b is None:
            return False
        blocks = self._nat_by_public.get(b.public_ip, [])
        try:
            blocks.remove((b.port_start, b.port_end, b.private_ip))
        except ValueError:
            pass
        return True

    # -- stats (store.go:129-146) --
    @_locked
    def stats(self) -> dict:
        return {
            "subscribers": len(self.subscribers),
            "leases": len(self.leases),
            "pools": len(self.pools),
            "sessions": len(self.sessions),
            "nat_bindings": len(self.nat_bindings),
            **self._counters,
        }

    # -- background cleanup loops (store.go:100-127, 858-1024) --
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return  # one sweeper; a second start() must not orphan it
        self._stop.clear()
        self._thread = threading.Thread(target=self._cleanup_loop,
                                        daemon=True, name="bng-state-sweep")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _cleanup_loop(self) -> None:
        while not self._stop.wait(self.lease_sweep_interval):
            self.cleanup_expired_leases()
            self.cleanup_idle_sessions(self.session_idle_s)

    # -- cleanup sweeps (parity: store.go:858-1024) --
    @_locked
    def cleanup_expired_leases(self, now: float | None = None) -> int:
        now = now if now is not None else self.clock()
        dead = [ip for ip, l in self.leases.items() if l.expires_at < now]
        for ip in dead:
            self.delete_lease(ip)
        self._counters["leases_expired"] += len(dead)
        return len(dead)

    @_locked
    def cleanup_idle_sessions(self, idle_s: float, now: float | None = None) -> int:
        now = now if now is not None else self.clock()
        dead = [i for i, s in self.sessions.items() if now - s.last_seen > idle_s]
        for i in dead:
            self.delete_session(i)
        self._counters["sessions_reaped"] += len(dead)
        return len(dead)
