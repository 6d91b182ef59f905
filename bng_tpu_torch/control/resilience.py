"""Partition tolerance: degraded operation when Nexus/RADIUS are down.

The port's copy of `bng_tpu/control/resilience.py` (jax-free).

Parity: pkg/resilience — Manager partition state machine
(manager.go:221-341 normal/partitioned/recovering), reconciliation with
earlier-timestamp-wins conflict resolution + forced renumber of losers
(manager.go:342-528), ConflictDetector (conflict_detector.go:25,121-233),
PoolMonitor with short-lease activation (pool_monitor.go:20,201-346),
RADIUSHandler degraded auth from cached profiles + offline accounting
buffer (radius_handler.go:52,134-489), RequestQueue (request_queue.go:17).

All loops are tick(now)-driven; health checkers are injectable callables
(the reference's controllable-health-checker test pattern, SURVEY §4.6).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

from bng_tpu_torch.utils.structlog import ErrorLog


class PartitionState(str, enum.Enum):
    NORMAL = "normal"
    PARTITIONED = "partitioned"
    RECOVERING = "recovering"


@dataclass
class PartitionAllocation:
    """An IP handed out while partitioned (conflict_detector.go role)."""

    subscriber_id: str
    ip: int
    allocated_at: float


@dataclass
class Conflict:
    ip: int
    local: PartitionAllocation
    remote_subscriber: str
    remote_allocated_at: float
    winner: str = ""  # subscriber id
    loser: str = ""


class ConflictDetector:
    """Track partition-time allocations; diff against the central store
    on heal. Parity: conflict_detector.go:25,121-233."""

    def __init__(self):
        self._partition_allocs: dict[int, PartitionAllocation] = {}

    def record(self, subscriber_id: str, ip: int, at: float) -> None:
        self._partition_allocs[ip] = PartitionAllocation(subscriber_id, ip, at)

    def clear(self) -> None:
        self._partition_allocs.clear()

    @property
    def count(self) -> int:
        return len(self._partition_allocs)

    def detect(self, central_lookup: Callable[[int], tuple[str, float] | None]
               ) -> list[Conflict]:
        """For each partition-time allocation, ask the central store who
        else claims that IP. Returns resolved conflicts
        (earlier-timestamp-wins; manager.go:resolveConflict)."""
        conflicts = []
        for ip, local in self._partition_allocs.items():
            remote = central_lookup(ip)
            if remote is None:
                continue
            r_sub, r_at = remote
            if r_sub == local.subscriber_id:
                continue
            c = Conflict(ip, local, r_sub, r_at)
            if r_at <= local.allocated_at:
                c.winner, c.loser = r_sub, local.subscriber_id
            else:
                c.winner, c.loser = local.subscriber_id, r_sub
            conflicts.append(c)
        return conflicts


class PoolLevel(str, enum.Enum):
    """Parity: pool_monitor.go:20 levels."""

    NORMAL = "normal"
    WARNING = "warning"
    CRITICAL = "critical"
    EXHAUSTED = "exhausted"


class PoolMonitor:
    """Utilization watcher; activates short leases under pressure.

    Parity: pool_monitor.go:201-346 — warning 80%, critical 95%,
    exhausted 100%; critical+ switches the DHCP server to short leases so
    churn frees addresses faster during a partition.
    """

    def __init__(self, utilization: Callable[[], float],
                 warning_pct: float = 0.80, critical_pct: float = 0.95,
                 short_lease_s: int = 300,
                 on_level_change: Callable[[PoolLevel], None] | None = None):
        self.utilization = utilization
        self.warning_pct = warning_pct
        self.critical_pct = critical_pct
        self.short_lease_s = short_lease_s
        self.on_level_change = on_level_change
        self.level = PoolLevel.NORMAL

    @property
    def short_lease_active(self) -> bool:
        return self.level in (PoolLevel.CRITICAL, PoolLevel.EXHAUSTED)

    def tick(self, now: float = 0.0) -> PoolLevel:
        u = self.utilization()
        if u >= 1.0:
            new = PoolLevel.EXHAUSTED
        elif u >= self.critical_pct:
            new = PoolLevel.CRITICAL
        elif u >= self.warning_pct:
            new = PoolLevel.WARNING
        else:
            new = PoolLevel.NORMAL
        if new != self.level:
            self.level = new
            if self.on_level_change:
                self.on_level_change(new)
        return self.level


@dataclass
class CachedProfile:
    """RADIUS profile cached from a successful auth
    (radius_handler.go:52 role)."""

    username: str
    policy_name: str = ""
    framed_ip: int = 0
    cached_at: float = 0.0


class DegradedRADIUSHandler:
    """Auth from cache when RADIUS is down; queue reauth + buffer acct.

    Parity: radius_handler.go:134-489 — cache successful auths; during
    partition serve auth decisions from cache (subject to TTL), queue the
    subscriber for re-auth on heal, and buffer accounting records for
    replay.
    """

    def __init__(self, cache_ttl_s: float = 86400.0, max_buffer: int = 10000):
        self.cache: dict[str, CachedProfile] = {}
        self.cache_ttl_s = cache_ttl_s
        self.reauth_queue: list[str] = []
        self.acct_buffer: list[dict] = []
        self.max_buffer = max_buffer
        self.stats = {"cache_hits": 0, "cache_misses": 0, "buffered_acct": 0,
                      "replayed_acct": 0, "reauths": 0}

    def cache_profile(self, p: CachedProfile) -> None:
        self.cache[p.username] = p

    def degraded_auth(self, username: str, now: float) -> CachedProfile | None:
        p = self.cache.get(username)
        if p is None or now - p.cached_at > self.cache_ttl_s:
            self.stats["cache_misses"] += 1
            return None
        self.stats["cache_hits"] += 1
        if username not in self.reauth_queue:
            self.reauth_queue.append(username)
        return p

    def buffer_accounting(self, record: dict) -> bool:
        if len(self.acct_buffer) >= self.max_buffer:
            self.acct_buffer.pop(0)  # oldest-drop (bounded buffer)
        self.acct_buffer.append(record)
        self.stats["buffered_acct"] += 1
        return True

    def replay(self, send: Callable[[dict], bool],
               reauth: Callable[[str], bool] | None = None) -> tuple[int, int]:
        """On heal: flush accounting then re-auth queued subscribers.
        Returns (acct_sent, reauth_done); failures stay queued."""
        sent = 0
        remaining = []
        for rec in self.acct_buffer:
            if send(rec):
                sent += 1
                self.stats["replayed_acct"] += 1
            else:
                remaining.append(rec)
        self.acct_buffer = remaining
        reauthed = 0
        if reauth is not None:
            still = []
            for u in self.reauth_queue:
                if reauth(u):
                    reauthed += 1
                    self.stats["reauths"] += 1
                else:
                    still.append(u)
            self.reauth_queue = still
        return sent, reauthed


class RequestQueue:
    """Bounded FIFO of deferred central-store writes
    (request_queue.go:17 role)."""

    def __init__(self, max_size: int = 10000):
        self._q: list[tuple[str, dict]] = []
        self.max_size = max_size
        self.dropped = 0

    def enqueue(self, kind: str, payload: dict) -> bool:
        if len(self._q) >= self.max_size:
            self.dropped += 1
            return False
        self._q.append((kind, payload))
        return True

    def drain(self, handler: Callable[[str, dict], bool]) -> int:
        done = 0
        remaining = []
        for kind, payload in self._q:
            if handler(kind, payload):
                done += 1
            else:
                remaining.append((kind, payload))
        self._q = remaining
        return done

    def __len__(self) -> int:
        return len(self._q)


@dataclass
class ResilienceEvents:
    partitions: int = 0
    recoveries: int = 0
    conflicts_found: int = 0
    renumbered: int = 0


class ResilienceManager:
    """The partition state machine tying it together.

    Parity: manager.go:22 — checkHealth (:221) drives NORMAL ->
    PARTITIONED when Nexus (and optionally RADIUS) fail; heal drives
    PARTITIONED -> RECOVERING (reconcile: detect + resolve conflicts,
    renumber losers, drain queued writes, replay accounting) -> NORMAL.
    """

    def __init__(
        self,
        nexus_healthy: Callable[[], bool],
        radius_healthy: Callable[[], bool] | None = None,
        check_interval_s: float = 5.0,
        failure_threshold: int = 3,
        central_lookup: Callable[[int], tuple[str, float] | None] | None = None,
        renumber: Callable[[str], bool] | None = None,
        on_state_change: Callable[[PartitionState], None] | None = None,
        probe_clock: Callable[[], float] | None = None,
    ):
        self.nexus_healthy = nexus_healthy
        self.radius_healthy = radius_healthy
        self.check_interval_s = check_interval_s
        self.failure_threshold = failure_threshold
        self.central_lookup = central_lookup
        self.renumber = renumber
        self.on_state_change = on_state_change
        if probe_clock is None:
            import time

            probe_clock = time.monotonic
        self.probe_clock = probe_clock

        self.state = PartitionState.NORMAL
        self.conflicts = ConflictDetector()
        self.radius_handler = DegradedRADIUSHandler()
        self.queue = RequestQueue()
        self.events = ResilienceEvents()
        self._fails = 0
        self._radius_fails = 0
        self.radius_down = False
        self._last_check = 0.0
        self._last_conflicts: list[Conflict] = []
        self._probe_err_log = ErrorLog(
            "resilience", "health probe raised (folded to unhealthy)")

    @property
    def partitioned(self) -> bool:
        return self.state != PartitionState.NORMAL

    @property
    def degraded_auth_active(self) -> bool:
        """Serve auth from cache when RADIUS is unreachable — whether from
        a full Nexus partition or a RADIUS-only outage
        (radius_handler.go's activation condition)."""
        return self.partitioned or self.radius_down

    def record_allocation(self, subscriber_id: str, ip: int, at: float) -> None:
        """DHCP server calls this for allocations made while partitioned."""
        if self.partitioned:
            self.conflicts.record(subscriber_id, ip, at)

    def _set_state(self, s: PartitionState) -> None:
        self.state = s
        if self.on_state_change:
            self.on_state_change(s)

    def tick(self, now: float,
             drain_handler: Callable[[str, dict], bool] | None = None,
             acct_send: Callable[[dict], bool] | None = None) -> PartitionState:
        if now - self._last_check < self.check_interval_s:
            return self.state
        self._last_check = now
        ok = False
        try:
            ok = bool(self.nexus_healthy())
        except Exception as e:
            # a raising probe is a different signal than a clean False —
            # visible (rate-limited), then folded to unhealthy (BNG021)
            self._probe_err_log.report(e, probe="nexus")

        # RADIUS-only outage: degraded auth without a Nexus partition
        if self.radius_healthy is not None:
            r_ok = False
            probe_t0 = self.probe_clock()
            try:
                r_ok = bool(self.radius_healthy())
            except Exception as e:
                self._probe_err_log.report(e, probe="radius")
            probe_wall_s = max(0.0, self.probe_clock() - probe_t0)
            if r_ok:
                self._radius_fails = 0
                if self.radius_down:
                    self.radius_down = False
                    # caller replays buffered accounting via acct_send below
                    if acct_send is not None:
                        self.radius_handler.replay(acct_send)
            else:
                # a probe that STALLED (socket timeout against a
                # black-holed server) already burned the wall-time of
                # that many check intervals — credit them all, or
                # detection takes threshold * stall instead of
                # threshold * interval and degraded auth arrives long
                # after subscribers started timing out
                self._radius_fails += min(
                    self.failure_threshold,
                    1 + int(probe_wall_s // self.check_interval_s))
                if self._radius_fails >= self.failure_threshold:
                    self.radius_down = True

        if self.state == PartitionState.NORMAL:
            if ok:
                self._fails = 0
            else:
                self._fails += 1
                if self._fails >= self.failure_threshold:
                    self._set_state(PartitionState.PARTITIONED)
                    self.events.partitions += 1
        elif self.state == PartitionState.PARTITIONED:
            if ok:
                self._set_state(PartitionState.RECOVERING)
                self._reconcile(now, drain_handler, acct_send)
        return self.state

    def _reconcile(self, now: float,
                   drain_handler: Callable[[str, dict], bool] | None,
                   acct_send: Callable[[dict], bool] | None) -> None:
        """performReconciliation (manager.go:342-528)."""
        if self.central_lookup is not None:
            found = self.conflicts.detect(self.central_lookup)
            self._last_conflicts = found
            self.events.conflicts_found += len(found)
            for c in found:
                if self.renumber is not None and c.loser:
                    if self.renumber(c.loser):
                        self.events.renumbered += 1
        self.conflicts.clear()
        if drain_handler is not None:
            self.queue.drain(drain_handler)
        if acct_send is not None:
            self.radius_handler.replay(acct_send)
        self._fails = 0
        self._set_state(PartitionState.NORMAL)
        self.events.recoveries += 1
