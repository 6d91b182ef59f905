"""Subscriber session lifecycle orchestrator (IPoE/PPPoE/WiFi-agnostic).

The port's copy of `bng_tpu/control/subscriber.py` (jax-free).

Parity: pkg/subscriber — Manager (manager.go:36) with CreateSession
(:106), Authenticate (:179), AssignAddress (:296), walled-garden set/clear
(:389-456), TerminateSession (:457); Session + states + events
(types.go:42-237). Pluggable Authenticator + AddressAllocator, event
emission, idle cleanup tick.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable


class SessionState(str, Enum):
    CREATED = "created"
    AUTHENTICATING = "authenticating"
    AUTHENTICATED = "authenticated"
    ADDRESS_ASSIGNED = "address_assigned"
    ACTIVE = "active"
    WALLED_GARDEN = "walled_garden"
    TERMINATING = "terminating"
    TERMINATED = "terminated"


class SessionKind(str, Enum):
    IPOE = "ipoe"
    PPPOE = "pppoe"
    WIFI = "wifi"


@dataclass
class Session:
    id: str
    kind: SessionKind
    mac: str = ""
    circuit_id: str = ""
    username: str = ""
    state: SessionState = SessionState.CREATED
    ip: str = ""
    subscriber_id: str = ""
    created_at: float = 0.0
    last_activity: float = 0.0
    walled: bool = False
    attributes: dict = field(default_factory=dict)


@dataclass
class SessionEvent:
    session_id: str
    event: str
    at: float
    detail: dict = field(default_factory=dict)


class SubscriberManager:
    def __init__(
        self,
        authenticator: Callable[[Session], dict | None] | None = None,
        allocator=None,  # .allocate(sid)/.release(sid)
        walled_garden=None,  # .add(session)/.remove(session)
        event_sink: Callable[[SessionEvent], None] | None = None,
        idle_timeout_s: float = 3600,
        clock=time.time,
    ):
        self.authenticator = authenticator
        self.allocator = allocator
        self.walled_garden = walled_garden
        self.event_sink = event_sink
        self.idle_timeout_s = idle_timeout_s
        self.clock = clock
        self.sessions: dict[str, Session] = {}
        self._by_mac: dict[str, str] = {}
        self._seq = 0

    def _emit(self, session: Session, event: str, **detail) -> None:
        if self.event_sink:
            self.event_sink(SessionEvent(session.id, event, self.clock(), detail))

    # -- lifecycle (manager.go:106-486) --
    def create_session(self, kind: SessionKind, mac: str = "", circuit_id: str = "",
                       username: str = "") -> Session:
        now = self.clock()
        self._seq += 1
        s = Session(id=f"{kind.value}-{int(now):x}-{self._seq:06x}", kind=kind,
                    mac=mac.lower(), circuit_id=circuit_id, username=username,
                    created_at=now, last_activity=now)
        self.sessions[s.id] = s
        if mac:
            self._by_mac[s.mac] = s.id
        self._emit(s, "created")
        return s

    def authenticate(self, session_id: str) -> bool:
        s = self._get(session_id)
        s.state = SessionState.AUTHENTICATING
        profile = self.authenticator(s) if self.authenticator else {}
        if profile is None:
            # auth failed -> walled garden, not termination (manager.go:389)
            self.set_walled_garden(session_id)
            self._emit(s, "auth_failed")
            return False
        s.attributes.update(profile or {})
        s.subscriber_id = (profile or {}).get("subscriber_id", s.mac or s.username)
        s.state = SessionState.AUTHENTICATED
        self._emit(s, "authenticated")
        return True

    def assign_address(self, session_id: str) -> str | None:
        s = self._get(session_id)
        if self.allocator is None:
            return None
        ip = self.allocator.allocate(s.subscriber_id or s.mac)
        if ip is None:
            self._emit(s, "address_exhausted")
            return None
        s.ip = ip
        s.state = SessionState.ADDRESS_ASSIGNED
        self._emit(s, "address_assigned", ip=ip)
        return ip

    def activate(self, session_id: str) -> None:
        s = self._get(session_id)
        if s.walled:
            self.clear_walled_garden(session_id)
        s.state = SessionState.ACTIVE
        self._emit(s, "active")

    def set_walled_garden(self, session_id: str) -> None:
        s = self._get(session_id)
        s.walled = True
        s.state = SessionState.WALLED_GARDEN
        if self.walled_garden is not None:
            self.walled_garden.add(s)
        self._emit(s, "walled_garden")

    def clear_walled_garden(self, session_id: str) -> None:
        s = self._get(session_id)
        s.walled = False
        if self.walled_garden is not None:
            self.walled_garden.remove(s)
        self._emit(s, "walled_garden_cleared")

    def touch(self, session_id: str) -> None:
        s = self.sessions.get(session_id)
        if s:
            s.last_activity = self.clock()

    def terminate(self, session_id: str, reason: str = "user") -> bool:
        s = self.sessions.get(session_id)
        if s is None:
            return False
        s.state = SessionState.TERMINATING
        if s.walled and self.walled_garden is not None:
            self.walled_garden.remove(s)
        if s.ip and self.allocator is not None:
            self.allocator.release(s.subscriber_id or s.mac)
        s.state = SessionState.TERMINATED
        self._emit(s, "terminated", reason=reason)
        del self.sessions[s.id]
        self._by_mac.pop(s.mac, None)
        return True

    # -- queries --
    def by_mac(self, mac: str) -> Session | None:
        sid = self._by_mac.get(mac.lower())
        return self.sessions.get(sid) if sid else None

    def _get(self, session_id: str) -> Session:
        s = self.sessions.get(session_id)
        if s is None:
            raise KeyError(f"no session {session_id}")
        return s

    # -- idle sweep (manager.go idle cleanup) --
    def cleanup_idle(self, now: float | None = None) -> int:
        now = now if now is not None else self.clock()
        dead = [sid for sid, s in self.sessions.items()
                if now - s.last_activity > self.idle_timeout_s]
        for sid in dead:
            self.terminate(sid, reason="idle_timeout")
        return len(dead)
