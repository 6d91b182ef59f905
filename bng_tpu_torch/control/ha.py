"""Active/standby HA: session replication, health monitoring, failover.

The port's copy of `bng_tpu/control/ha.py` (jax-free), its imports
renamed; the checkpoint form is the reference's, so either package
restores the other's.

Parity: pkg/ha — HASyncer (sync.go:77; active serves /sessions full sync
+ /sessions/stream SSE deltas :231-454, standby full-sync + reconnect
with backoff :482-770), SessionState (protocol.go:76-113), SessionStore
(protocol.go:162, store.go:10-62), HealthMonitor (health_monitor.go:79,
:232-415), FailoverController with Normal/FailoverPending/FailedOver/
FailbackPending states and auto-failback (failover.go:137, :305-600).

Build differences: transport is injectable (tests wire two syncers
directly; production uses DCN/HTTP), and all loops are tick(now)-driven.
The role of the standby pod-slice mirroring session tables (SURVEY §2.3).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, asdict
from typing import Callable

from bng_tpu_torch.analysis.sanitize import owned_by
from bng_tpu_torch.chaos.faults import fault_point
from bng_tpu_torch.utils.structlog import ErrorLog


@dataclass
class SessionState:
    """Full subscriber session record (parity: protocol.go:76-113)."""

    session_id: str
    mac: str = ""
    ip: int = 0
    pool_id: int = 0
    circuit_id: str = ""
    username: str = ""
    lease_expiry: float = 0.0
    s_tag: int = 0
    c_tag: int = 0
    nat_public_ip: int = 0
    nat_port_start: int = 0
    nat_port_end: int = 0
    qos_policy: str = ""
    session_kind: str = "ipoe"  # ipoe | pppoe | wifi
    updated_at: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SessionState":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


class InMemorySessionStore:
    """Parity: ha/store.go:10-62."""

    def __init__(self):
        self._sessions: dict[str, SessionState] = {}

    def put(self, s: SessionState) -> None:
        self._sessions[s.session_id] = s

    def get(self, session_id: str) -> SessionState | None:
        return self._sessions.get(session_id)

    def delete(self, session_id: str) -> bool:
        return self._sessions.pop(session_id, None) is not None

    def all(self) -> list[SessionState]:
        return list(self._sessions.values())

    def __len__(self) -> int:
        return len(self._sessions)


@dataclass
class HAChange:
    """One replication event (the SSE event payload role)."""

    op: str  # "put" | "delete"
    session: SessionState | None = None
    session_id: str = ""
    seq: int = 0


def parse_ha_checkpoint_state(state: dict) -> tuple[int, list[SessionState]]:
    """Checkpoint HA blob -> (seq, SessionState list), touching no
    syncer state. The restore pre-check runs this before any store
    mutation so a corrupt session dict rejects all-or-nothing
    (KeyError/TypeError/ValueError propagate)."""
    sessions = [SessionState.from_dict(d) for d in state.get("sessions", [])]
    return int(state.get("seq", 0)), sessions


class ActiveSyncer:
    """Active side: records changes, serves full syncs + deltas.

    Parity: the active half of HASyncer (sync.go:231-454). Standbys
    subscribe with a callback (the SSE connection role); a bounded replay
    buffer covers reconnect gaps before forcing a full resync.
    """

    def __init__(self, store: InMemorySessionStore, replay_buffer: int = 1024):
        import threading

        self.store = store
        self._seq = 0
        self._replay: list[HAChange] = []
        self._replay_cap = replay_buffer
        self._subscribers: list[Callable[[HAChange], None]] = []
        self.stats = {"changes": 0, "full_syncs": 0, "sink_errors": 0}
        self._sink_err_log = ErrorLog(
            "ha", "replica sink failed; subscriber dropped pending "
            "reconnect full-resync")
        # push_change runs on the main loop; full_sync/replay_since on
        # the cluster listener's HTTP threads. Without this lock a push
        # landing between the snapshot read and the seq read hands a
        # connecting standby "snapshot WITHOUT the session, seq AFTER
        # it" — the delta is skipped and the session is silently absent
        # until its next lifecycle event.
        self._lock = threading.Lock()

    def push_change(self, session: SessionState | None, session_id: str = "") -> None:
        """Parity: HASyncer.PushChange (sync.go:456)."""
        with self._lock:
            return self._push_change_locked(session, session_id)

    def _push_change_locked(self, session, session_id):
        self._seq += 1
        if session is not None:
            self.store.put(session)
            ch = HAChange("put", session=session, seq=self._seq)
        else:
            self.store.delete(session_id)
            ch = HAChange("delete", session_id=session_id, seq=self._seq)
        self._replay.append(ch)
        if len(self._replay) > self._replay_cap:
            self._replay.pop(0)
        self.stats["changes"] += 1
        fp = fault_point("ha.push")
        if fp is not None and fp.kind == "drop_delta":
            # chaos: every replica stream dies mid-event (an SSE
            # connection breaking). The change IS recorded — store +
            # replay buffer — so a reconnecting standby heals via
            # replay_since; only the live delivery is lost.
            self._subscribers.clear()
            return
        for cb in list(self._subscribers):
            # a broken replica sink must never take down the active's
            # session-write path; the subscriber is dropped and will
            # full-resync on reconnect
            try:
                cb(ch)
            except Exception as e:
                self.stats["sink_errors"] += 1
                self._sink_err_log.report(e, seq=ch.seq)
                if cb in self._subscribers:
                    self._subscribers.remove(cb)

    def full_sync(self) -> tuple[list[SessionState], int]:
        """GET /sessions role: snapshot + high-water seq — ATOMIC vs
        push_change (see __init__'s lock note)."""
        with self._lock:
            self.stats["full_syncs"] += 1
            return self.store.all(), self._seq

    def replay_since(self, seq: int) -> list[HAChange] | None:
        """Deltas after `seq`, or None if the gap fell out of the buffer."""
        with self._lock:
            if seq == self._seq:
                return []
            missing = [c for c in self._replay if c.seq > seq]
            if not missing or missing[0].seq != seq + 1:
                return None  # gap: standby must full-sync
            return missing

    # -- checkpoint/warm-restart (control/statestore.py) ---------------
    def checkpoint_state(self) -> dict:
        """Session store + high-water seq, atomically vs push_change —
        the payload a checkpoint carries so a restarted active (or a
        bootstrapping standby) resumes from a consistent cut."""
        with self._lock:
            return {"seq": self._seq,
                    "sessions": [s.to_dict() for s in self.store.all()]}

    parse_checkpoint_state = staticmethod(parse_ha_checkpoint_state)

    def restore_state(self, state: dict) -> int:
        """Hydrate a restarted ACTIVE from a checkpoint. The seq resumes
        at the checkpointed high-water mark so a standby that bootstrapped
        from the same (or older) checkpoint replays forward cleanly; the
        replay buffer starts empty, so any standby further behind gets
        the correct None -> full-resync answer."""
        seq, sessions = parse_ha_checkpoint_state(state)
        with self._lock:
            for s in sessions:
                self.store.put(s)
            self._seq = max(self._seq, seq)
            return len(sessions)

    def subscribe(self, cb: Callable[[HAChange], None]) -> Callable[[], None]:
        self._subscribers.append(cb)

        def cancel():
            if cb in self._subscribers:
                self._subscribers.remove(cb)

        return cancel


@owned_by(None, guard="_lock")
class StandbySyncer:
    """Standby side: full sync then live deltas, reconnect with backoff.

    Parity: standbyLoop (sync.go:495), performFullSync (:538),
    connectToStream (:596). The `transport` returns the active's
    ActiveSyncer-shaped API or raises ConnectionError.

    Thread ownership (BNG060): over the HTTP transport the subscribed
    `_on_change` runs on the SSE reader thread while `tick`
    (reconnect/full-sync) and `checkpoint_state` run on the loop thread
    — `_lock` serializes every touch of the store / `last_seq` /
    `stats`, so a delta can never interleave with a full-sync store
    rebuild or tear a checkpoint snapshot.
    """

    def __init__(self, store: InMemorySessionStore,
                 transport: Callable[[], ActiveSyncer],
                 backoff_initial_s: float = 1.0, backoff_max_s: float = 30.0):
        import threading

        self.store = store
        self.transport = transport
        self.connected = False
        self.last_seq = 0
        self._cancel = None
        self._backoff = backoff_initial_s
        self._backoff_initial = backoff_initial_s
        self._backoff_max = backoff_max_s
        self._next_attempt = 0.0
        self._lock = threading.Lock()
        self.stats = {"full_syncs": 0, "deltas": 0, "reconnects": 0,
                      "bootstraps": 0}

    parse_checkpoint_state = staticmethod(parse_ha_checkpoint_state)

    def bootstrap_state(self, state: dict) -> int:
        """Hydrate from an ActiveSyncer.checkpoint_state() payload BEFORE
        the first connect: the store fills from the snapshot and last_seq
        jumps to its high-water mark, so the first _connect asks
        replay_since(seq) and ships only the delta since the checkpoint —
        full_sync() is the fallback only when the active's replay buffer
        has already wrapped past that seq."""
        seq, sessions = parse_ha_checkpoint_state(state)
        with self._lock:
            for s in sessions:
                self.store.put(s)
            self.last_seq = max(self.last_seq, seq)
            self.stats["bootstraps"] += 1
        return len(sessions)

    def checkpoint_state(self) -> dict:
        """Snapshot the standby's replicated view (its own checkpoints
        make a standby restart a local bootstrap instead of a full
        resync off the active). Under _lock: an SSE delta landing
        mid-snapshot would otherwise pair a new session list with the
        old seq (replay would then skip that delta on bootstrap)."""
        with self._lock:
            return {"seq": self.last_seq,
                    "sessions": [s.to_dict() for s in self.store.all()]}

    def _on_change(self, ch: HAChange) -> None:
        # SSE reader thread (HTTP transport) or loop thread (in-process)
        with self._lock:
            if ch.op == "put":
                self.store.put(ch.session)
            else:
                self.store.delete(ch.session_id)
            self.last_seq = ch.seq
            self.stats["deltas"] += 1

    def _connect(self) -> None:
        fp = fault_point("ha.connect")
        if fp is not None and fp.kind == "fail":
            # chaos: peer timeout — tick()'s backoff path owns recovery
            raise ConnectionError("chaos: injected peer timeout")
        active = self.transport()  # raises ConnectionError when active is down
        replay = active.replay_since(self.last_seq) if self.last_seq else None
        if replay is None:
            sessions, seq = active.full_sync()
            with self._lock:
                self.store._sessions = {s.session_id: s for s in sessions}
                self.last_seq = seq
                self.stats["full_syncs"] += 1
        else:
            for ch in replay:
                self._on_change(ch)
        # Ordering against the stream dying instantly: subscribe()
        # starts the reader thread, whose on_stream_end fires
        # disconnect() possibly BEFORE we return here. `connected`
        # must therefore be set True BEFORE subscribe — then an
        # immediate drop's disconnect() lands after and leaves it
        # False (tick reconnects), instead of us overwriting the drop
        # with a wedged True for a dead stream.
        with self._lock:
            self.connected = True
            self._backoff = self._backoff_initial
        try:
            cancel = active.subscribe(self._on_change)
        except BaseException:
            # a subscribe that never opened must not leave `connected`
            # True — tick()'s backoff owns the retry
            with self._lock:
                self.connected = False
            raise
        with self._lock:
            self._cancel = cancel

    def disconnect(self) -> None:
        # runs on the SSE reader thread too (cli wires it as the HTTP
        # transport's on_stream_end) — _cancel/connected are the same
        # fields the loop's tick/_connect write, so take _lock here as
        # well; unlocked this both races the reconnect path and trips
        # the @owned_by stamp in sanitizer runs, wedging `connected`
        # True forever after a stream drop
        with self._lock:
            if self._cancel:
                self._cancel()
                self._cancel = None
            self.connected = False

    def tick(self, now: float) -> None:
        if self.connected:
            return
        if now < self._next_attempt:
            return
        try:
            self._connect()
            with self._lock:
                self.stats["reconnects"] += 1
        except ConnectionError:
            self._next_attempt = now + self._backoff
            self._backoff = min(self._backoff * 2, self._backoff_max)


# ---------------------------------------------------------------------------
class HealthState(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    FAILED = "failed"


@dataclass
class HealthEvent:
    state: HealthState
    at: float
    consecutive_failures: int = 0


class HealthMonitor:
    """Probe the peer with failure/recovery thresholds.

    Parity: health_monitor.go:79,232-415 — 1s HTTP probes, N consecutive
    failures -> FAILED, M consecutive successes -> HEALTHY.
    """

    def __init__(self, probe: Callable[[], bool], interval_s: float = 1.0,
                 failure_threshold: int = 3, recovery_threshold: int = 2,
                 on_event: Callable[[HealthEvent], None] | None = None):
        self.probe = probe
        self.interval_s = interval_s
        self.failure_threshold = failure_threshold
        self.recovery_threshold = recovery_threshold
        self.on_event = on_event
        self.state = HealthState.HEALTHY
        self._fails = 0
        self._oks = 0
        self._last_check = 0.0
        self._probe_err_log = ErrorLog("ha", "health probe raised")

    def tick(self, now: float) -> HealthState:
        if now - self._last_check < self.interval_s:
            return self.state
        self._last_check = now
        ok = False
        try:
            ok = bool(self.probe())
        except Exception as e:
            # a RAISING probe is a distinct gray-failure signal from a
            # clean False — log it (rate-limited) before folding to fail
            self._probe_err_log.report(e)
        if ok:
            self._oks += 1
            self._fails = 0
            if self.state == HealthState.FAILED:
                if self._oks >= self.recovery_threshold:
                    self._emit(HealthState.HEALTHY, now)
            elif self.state == HealthState.DEGRADED:
                self.state = HealthState.HEALTHY
        else:
            self._fails += 1
            self._oks = 0
            if self.state != HealthState.FAILED:
                if self._fails >= self.failure_threshold:
                    self._emit(HealthState.FAILED, now)
                else:
                    self.state = HealthState.DEGRADED
        return self.state

    def _emit(self, state: HealthState, now: float) -> None:
        self.state = state
        if self.on_event:
            self.on_event(HealthEvent(state, now, self._fails))


class FailoverState(str, enum.Enum):
    """Parity: failover.go:137 states."""

    NORMAL = "normal"
    FAILOVER_PENDING = "failover_pending"
    FAILED_OVER = "failed_over"
    FAILBACK_PENDING = "failback_pending"


class Role(str, enum.Enum):
    ACTIVE = "active"
    STANDBY = "standby"


class FailoverController:
    """Standby-side promote/failback state machine.

    Parity: failover.go:305-600 — health events drive NORMAL ->
    FAILOVER_PENDING (grace delay) -> FAILED_OVER (promote, role-change
    callback); peer recovery + auto-failback drives FAILED_OVER ->
    FAILBACK_PENDING (stability window) -> NORMAL (demote).
    """

    def __init__(self, role: Role = Role.STANDBY,
                 failover_delay_s: float = 5.0,
                 failback_delay_s: float = 30.0,
                 auto_failback: bool = True,
                 on_role_change: Callable[[Role], None] | None = None):
        self.role = role
        self.state = FailoverState.NORMAL
        self.failover_delay_s = failover_delay_s
        self.failback_delay_s = failback_delay_s
        self.auto_failback = auto_failback
        self.on_role_change = on_role_change
        self._pending_since = 0.0
        self.stats = {"failovers": 0, "failbacks": 0}

    def handle_health_event(self, ev: HealthEvent) -> None:
        """Parity: handleHealthEvent (failover.go:322)."""
        if self.role != Role.STANDBY and self.state not in (
                FailoverState.FAILED_OVER, FailoverState.FAILBACK_PENDING):
            return
        if ev.state == HealthState.FAILED and self.state == FailoverState.NORMAL:
            self.state = FailoverState.FAILOVER_PENDING
            self._pending_since = ev.at
        elif ev.state == HealthState.FAILED and \
                self.state == FailoverState.FAILBACK_PENDING:
            # peer died again before failback completed: stay active
            self.state = FailoverState.FAILED_OVER
        elif ev.state == HealthState.HEALTHY:
            if self.state == FailoverState.FAILOVER_PENDING:
                self.state = FailoverState.NORMAL  # peer came back in time
            elif self.state == FailoverState.FAILED_OVER and self.auto_failback:
                self.state = FailoverState.FAILBACK_PENDING
                self._pending_since = ev.at

    def tick(self, now: float) -> None:
        if self.state == FailoverState.FAILOVER_PENDING and \
                now - self._pending_since >= self.failover_delay_s:
            self._promote()
        elif self.state == FailoverState.FAILBACK_PENDING and \
                now - self._pending_since >= self.failback_delay_s:
            self._demote()

    def _promote(self) -> None:
        """executeFailover (failover.go:400-500)."""
        self.state = FailoverState.FAILED_OVER
        self.role = Role.ACTIVE
        self.stats["failovers"] += 1
        if self.on_role_change:
            self.on_role_change(Role.ACTIVE)

    def _demote(self) -> None:
        self.state = FailoverState.NORMAL
        self.role = Role.STANDBY
        self.stats["failbacks"] += 1
        if self.on_role_change:
            self.on_role_change(Role.STANDBY)

    def force_failover(self) -> None:
        """Operator-initiated (failover.go manual path)."""
        self._promote()

    def force_failback(self) -> None:
        self._demote()
