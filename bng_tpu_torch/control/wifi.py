"""WiFi gateway operating mode: captive-portal session flow for WiFi.

Parity: pkg/wifi — OperatingMode + Config with DefaultWiFiConfig /
DefaultOLTBNGConfig (gateway.go:27-100), Session + states (:102-149),
Manager create/renew/authenticate/release (:222-365), by-IP index (:374),
traffic stats (:400), grace period + NeedsAuthentication (:416-444),
Stats (:446-470).

Same BNG stack, different deployment: WiFi mode allocates on DHCP
DISCOVER and deallocates on lease expiry; OLT-BNG mode allocates after
RADIUS auth and deallocates on session termination.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum


class OperatingMode(str, Enum):
    OLT_BNG = "olt_bng"
    WIFI_GATEWAY = "wifi_gateway"


class WiFiSessionState(str, Enum):
    NEW = "new"
    GRACE_PERIOD = "grace_period"
    AUTHENTICATED = "authenticated"
    ACTIVE = "active"
    EXPIRED = "expired"


@dataclass
class WiFiConfig:
    mode: OperatingMode = OperatingMode.WIFI_GATEWAY
    allocation_trigger: str = "dhcp_discover"  # or "radius_auth"
    deallocation_trigger: str = "lease_expiry"  # or "session_termination"
    lease_duration: float = 1800.0
    nexus_enabled: bool = False
    pon_enabled: bool = False
    pppoe_enabled: bool = False
    captive_portal_enabled: bool = True
    captive_portal_url: str = ""
    grace_period: float = 300.0


def default_wifi_config() -> WiFiConfig:
    """gateway.go:73-86."""
    return WiFiConfig()


def default_olt_bng_config() -> WiFiConfig:
    """gateway.go:88-100."""
    return WiFiConfig(
        mode=OperatingMode.OLT_BNG,
        allocation_trigger="radius_auth",
        deallocation_trigger="session_termination",
        lease_duration=86400.0,
        nexus_enabled=True,
        pon_enabled=True,
        pppoe_enabled=True,
        captive_portal_enabled=False,
    )


@dataclass
class WiFiSession:
    id: str
    mac: str
    ip: str = ""
    hostname: str = ""
    pool_id: int = 0
    state: WiFiSessionState = WiFiSessionState.NEW
    authenticated: bool = False
    auth_method: str = ""
    user_identity: str = ""
    created_at: float = 0.0
    lease_expiry: float = 0.0
    authenticated_at: float = 0.0
    grace_period_ends: float = 0.0
    last_renewal: float = 0.0
    lease_duration: float = 0.0
    bytes_in: int = 0
    bytes_out: int = 0
    packets_in: int = 0
    packets_out: int = 0
    vendor_class: str = ""
    user_class: str = ""


class WiFiGatewayManager:
    """WiFi gateway session manager (gateway.go:151-470)."""

    def __init__(self, config: WiFiConfig | None = None, clock=time.time):
        self.config = config or default_wifi_config()
        self._clock = clock
        self._lock = threading.Lock()
        self._sessions: dict[str, WiFiSession] = {}  # mac -> session
        self._by_ip: dict[str, str] = {}  # ip -> mac
        self.on_session_create = None
        self.on_session_auth = None
        self.on_session_expire = None

    def create_session(self, mac: str, hostname: str = "", pool_id: int = 0,
                       ip: str = "") -> WiFiSession:
        """DHCP DISCOVER arrival (gateway.go:222-278)."""
        now = self._clock()
        with self._lock:
            existing = self._sessions.get(mac)
            if existing is not None:
                existing.last_renewal = now
                existing.lease_expiry = now + self.config.lease_duration
                if hostname:
                    existing.hostname = hostname
                if ip and ip != existing.ip:
                    if existing.ip:
                        self._by_ip.pop(existing.ip, None)
                    existing.ip = ip
                    self._by_ip[ip] = mac
                return existing
            s = WiFiSession(
                id=uuid.uuid4().hex[:16], mac=mac, ip=ip, hostname=hostname,
                pool_id=pool_id, created_at=now, last_renewal=now,
                lease_duration=self.config.lease_duration,
                lease_expiry=now + self.config.lease_duration,
            )
            if self.config.captive_portal_enabled:
                s.state = WiFiSessionState.GRACE_PERIOD
                s.grace_period_ends = now + self.config.grace_period
            else:
                s.state = WiFiSessionState.ACTIVE
                s.authenticated = True
            self._sessions[mac] = s
            if ip:
                self._by_ip[ip] = mac
        if self.on_session_create:
            self.on_session_create(s)
        return s

    def renew_session(self, mac: str) -> None:
        """DHCP renewal (gateway.go:280-301)."""
        now = self._clock()
        with self._lock:
            s = self._sessions.get(mac)
            if s is None:
                raise KeyError(f"no session for {mac}")
            s.last_renewal = now
            s.lease_expiry = now + s.lease_duration

    def authenticate_session(self, mac: str, auth_method: str,
                             user_identity: str) -> None:
        """Captive portal success (gateway.go:303-333)."""
        now = self._clock()
        with self._lock:
            s = self._sessions.get(mac)
            if s is None:
                raise KeyError(f"no session for {mac}")
            s.authenticated = True
            s.auth_method = auth_method
            s.user_identity = user_identity
            s.authenticated_at = now
            s.state = WiFiSessionState.AUTHENTICATED
            s.grace_period_ends = 0.0
        if self.on_session_auth:
            self.on_session_auth(s)

    def release_session(self, mac: str) -> None:
        with self._lock:
            s = self._sessions.pop(mac, None)
            if s is not None and s.ip:
                self._by_ip.pop(s.ip, None)

    def get_session(self, mac: str) -> WiFiSession | None:
        with self._lock:
            return self._sessions.get(mac)

    def get_session_by_ip(self, ip: str) -> WiFiSession | None:
        with self._lock:
            mac = self._by_ip.get(ip)
            return self._sessions.get(mac) if mac else None

    def list_sessions(self) -> list[WiFiSession]:
        with self._lock:
            return list(self._sessions.values())

    def update_traffic_stats(self, mac: str, bytes_in: int, bytes_out: int,
                             packets_in: int, packets_out: int) -> None:
        with self._lock:
            s = self._sessions.get(mac)
            if s is None:
                return
            s.bytes_in += bytes_in
            s.bytes_out += bytes_out
            s.packets_in += packets_in
            s.packets_out += packets_out
            if s.state == WiFiSessionState.AUTHENTICATED:
                s.state = WiFiSessionState.ACTIVE

    def is_in_grace_period(self, mac: str) -> bool:
        now = self._clock()
        with self._lock:
            s = self._sessions.get(mac)
            return (s is not None and s.state == WiFiSessionState.GRACE_PERIOD
                    and now < s.grace_period_ends)

    def needs_authentication(self, mac: str) -> bool:
        if not self.config.captive_portal_enabled:
            return False
        with self._lock:
            s = self._sessions.get(mac)
            return s is None or not s.authenticated

    def expire_sessions(self) -> int:
        """Sweep lease-expired and grace-period-overrun sessions."""
        now = self._clock()
        expired = []
        lease_driven = self.config.deallocation_trigger == "lease_expiry"
        with self._lock:
            for mac, s in list(self._sessions.items()):
                # In session-termination mode (OLT-BNG) authenticated sessions
                # outlive the DHCP lease; RADIUS teardown releases them.
                lease_out = (s.lease_expiry and now >= s.lease_expiry
                             and (lease_driven or not s.authenticated))
                grace_out = (s.state == WiFiSessionState.GRACE_PERIOD
                             and not s.authenticated
                             and now >= s.grace_period_ends)
                if lease_out or grace_out:
                    s.state = WiFiSessionState.EXPIRED
                    del self._sessions[mac]
                    if s.ip:
                        self._by_ip.pop(s.ip, None)
                    expired.append(s)
        if self.on_session_expire:
            for s in expired:
                self.on_session_expire(s)
        return len(expired)

    def stats(self) -> dict:
        now = self._clock()
        with self._lock:
            out = {
                "active_sessions": len(self._sessions),
                "authenticated_sessions": 0,
                "grace_period_sessions": 0,
                "total_bytes_in": 0,
                "total_bytes_out": 0,
            }
            for s in self._sessions.values():
                if s.authenticated:
                    out["authenticated_sessions"] += 1
                if (s.state == WiFiSessionState.GRACE_PERIOD
                        and now < s.grace_period_ends):
                    out["grace_period_sessions"] += 1
                out["total_bytes_in"] += s.bytes_in
                out["total_bytes_out"] += s.bytes_out
            return out
