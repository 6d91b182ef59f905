"""PPPoE session state + manager + teardown causes.

The port's copy of `bng_tpu/control/pppoe/session.py` (jax-free).

Parity: pkg/pppoe/session.go (SessionManager :182, session-ID
allocation) and teardown.go (TerminateCause RFC 2866 values :20-37,
SessionTeardown :113). Sessions advance through phases: discovery ->
lcp -> auth -> network (IPCP/IPV6CP) -> open -> closed.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

from bng_tpu_torch.control.pppoe.ipcp import IPCP
from bng_tpu_torch.control.pppoe.ipv6cp import IPV6CP
from bng_tpu_torch.control.pppoe.lcp import LCP


class TerminateCause(enum.IntEnum):
    """RFC 2866 Acct-Terminate-Cause (parity: teardown.go:20-37)."""

    USER_REQUEST = 1
    LOST_CARRIER = 2
    LOST_SERVICE = 3
    IDLE_TIMEOUT = 4
    SESSION_TIMEOUT = 5
    ADMIN_RESET = 6
    ADMIN_REBOOT = 7
    PORT_ERROR = 8
    NAS_ERROR = 9
    NAS_REQUEST = 10
    NAS_REBOOT = 11
    PORT_UNNEEDED = 12
    PORT_PREEMPTED = 13
    PORT_SUSPENDED = 14
    SERVICE_UNAVAILABLE = 15
    CALLBACK = 16
    USER_ERROR = 17
    HOST_REQUEST = 18


class Phase(str, enum.Enum):
    DISCOVERY = "discovery"
    LCP = "lcp"
    AUTH = "auth"
    NETWORK = "network"
    OPEN = "open"
    CLOSED = "closed"


@dataclass
class PPPoESession:
    session_id: int
    client_mac: bytes
    phase: Phase = Phase.LCP
    lcp: LCP | None = None
    ipcp: IPCP | None = None
    ipv6cp: IPV6CP | None = None
    username: str = ""
    assigned_ip: int = 0
    chap_ident: int = 0
    chap_challenge: bytes = b""
    created_at: float = 0.0
    last_activity: float = 0.0
    # keepalive (parity: keepalive.go)
    echo_ident: int = 0
    echo_pending: int = 0  # unanswered echo-requests
    last_echo_tx: float = 0.0
    terminate_cause: TerminateCause | None = None
    acct_session_id: str = ""
    radius_attributes: dict = field(default_factory=dict)
    vlans: list[int] = field(default_factory=list)  # S/C tags of the access line

    def touch(self, now: float) -> None:
        self.last_activity = now
        self.echo_pending = 0


class SessionManager:
    """Session-ID allocation + lookup (parity: session.go:182).

    PPPoE session IDs are 16-bit, nonzero, unique per (AC, client MAC).
    Allocation scans from a rolling cursor — same shape as the
    reference's nextSessionID behavior.
    """

    def __init__(self, max_sessions: int = 65535):
        self.max_sessions = min(max_sessions, 0xFFFF)
        self._sessions: dict[int, PPPoESession] = {}
        self._by_mac: dict[bytes, int] = {}
        self._cursor = 0

    def __len__(self) -> int:
        return len(self._sessions)

    def allocate(self, client_mac: bytes, now: float) -> PPPoESession | None:
        if len(self._sessions) >= self.max_sessions:
            return None
        # one session per MAC: replace a stale one (reference tears down
        # the old session on re-PADR)
        old = self._by_mac.get(client_mac)
        if old is not None:
            self.remove(old)
        for _ in range(0xFFFF):
            self._cursor = (self._cursor % 0xFFFF) + 1  # 1..65535
            if self._cursor not in self._sessions:
                break
        else:
            return None
        s = PPPoESession(session_id=self._cursor, client_mac=client_mac,
                         created_at=now, last_activity=now)
        self._sessions[s.session_id] = s
        self._by_mac[client_mac] = s.session_id
        return s

    def get(self, session_id: int) -> PPPoESession | None:
        return self._sessions.get(session_id)

    def by_mac(self, mac: bytes) -> PPPoESession | None:
        sid = self._by_mac.get(mac)
        return self._sessions.get(sid) if sid is not None else None

    def remove(self, session_id: int) -> PPPoESession | None:
        s = self._sessions.pop(session_id, None)
        if s is not None and self._by_mac.get(s.client_mac) == session_id:
            del self._by_mac[s.client_mac]
        return s

    def all(self) -> list[PPPoESession]:
        return list(self._sessions.values())


@dataclass
class TeardownEvent:
    """Handed to accounting/fast-path hooks on session close
    (parity: teardown.go:113 SessionTeardown)."""

    session: PPPoESession
    cause: TerminateCause
    at: float
    session_time_s: float = 0.0

    def __post_init__(self):
        if not self.session_time_s and self.session.created_at:
            self.session_time_s = max(0.0, self.at - self.session.created_at)


TeardownHook = Callable[[TeardownEvent], None]
