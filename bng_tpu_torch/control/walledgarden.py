"""Walled garden / captive portal state machine.

The port's copy of `bng_tpu/control/walledgarden.py` (jax-free).

Parity: pkg/walledgarden — SubscriberState (manager.go:16-44), Config +
DefaultConfig (:65-105), Manager with subscriber CRUD (:244-345), expiry
checker (:347-396), stats (:398-428), allowed destinations incl. DNS
(:95-103, :187-242), redirect callback (:182).

TPU mapping: the reference writes state into an eBPF map consulted by the
kernel redirect program; here the manager keeps the authoritative host-side
table and (optionally, nil-safe like the reference's SetEBPFMaps) pushes
entries into the device fast-path tables so the packet pipeline can divert
unauthenticated subscribers' TCP:80 to the portal.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import IntEnum

from bng_tpu_torch.utils.net import ip_to_u32, mac_to_u64


class SubscriberState(IntEnum):
    """manager.go:16-44. UNKNOWN gets the walled garden by default."""

    UNKNOWN = 0
    WALLED_GARDEN = 1
    PROVISIONED = 2
    BLOCKED = 3


IPPROTO_TCP = 6
IPPROTO_UDP = 17


@dataclass(frozen=True)
class AllowedDestination:
    """A destination that bypasses the garden (manager.go:56-63)."""

    ip: str
    port: int = 0  # 0 = any port
    proto: int = 0  # 0 = any proto

    def key(self) -> int:
        # Same packing idea as allowedDestKey (manager.go:237-242):
        # ip:port:proto folded into one u64 lookup key.
        return (ip_to_u32(self.ip) << 32) | (self.port << 8) | self.proto


@dataclass
class WalledGardenConfig:
    """manager.go:65-105 defaults."""

    portal_ip: str = "10.255.255.1"
    portal_port: int = 8080
    allowed_dns: list[str] = field(default_factory=lambda: ["8.8.8.8", "8.8.4.4"])
    allowed_destinations: list[AllowedDestination] = field(default_factory=list)
    default_timeout: float = 300.0  # seconds unknown MACs stay gardened
    max_entries: int = 100_000


@dataclass
class Entry:
    state: SubscriberState
    vlan_id: int = 0
    expiry_time: float = 0.0  # 0 = never
    added_at: float = 0.0


class WalledGardenManager:
    """Host-authoritative captive-portal table (manager.go:107-464)."""

    def __init__(self, config: WalledGardenConfig | None = None,
                 clock=time.time):
        self.config = config or WalledGardenConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: dict[int, Entry] = {}  # mac_u64 -> Entry
        self._allowed: dict[int, AllowedDestination] = {}
        self._on_redirect = None
        self._on_expire = None
        self._on_state_change = None
        self._stats = {"redirects": 0, "expired": 0}
        self._init_allowed_destinations()

    # -- setup ---------------------------------------------------------

    def _init_allowed_destinations(self) -> None:
        """Portal + DNS servers always bypass (manager.go:187-242)."""
        cfg = self.config
        base = [AllowedDestination(cfg.portal_ip, cfg.portal_port, IPPROTO_TCP)]
        base += [AllowedDestination(d, 53, IPPROTO_UDP) for d in cfg.allowed_dns]
        base += [AllowedDestination(d, 53, IPPROTO_TCP) for d in cfg.allowed_dns]
        base += list(cfg.allowed_destinations)
        for dest in base:
            self._allowed[dest.key()] = dest

    def on_redirect(self, callback) -> None:
        self._on_redirect = callback

    def on_expire(self, callback) -> None:
        self._on_expire = callback

    def on_state_change(self, callback) -> None:
        """callback(mac_u64, state) after every set_subscriber_state —
        lets enforcement points (the DNS resolver's per-client garden,
        the device-side gate) track membership without polling."""
        self._on_state_change = callback

    # -- subscriber state ----------------------------------------------

    def set_subscriber_state(self, mac: bytes | str, state: SubscriberState,
                             vlan_id: int = 0) -> None:
        key = mac_to_u64(mac)
        now = self._clock()
        with self._lock:
            if len(self._entries) >= self.config.max_entries and key not in self._entries:
                raise OverflowError("walled garden table full")
            expiry = 0.0
            if state in (SubscriberState.UNKNOWN, SubscriberState.WALLED_GARDEN):
                expiry = now + self.config.default_timeout
            self._entries[key] = Entry(state=state, vlan_id=vlan_id,
                                       expiry_time=expiry, added_at=now)
        if self._on_state_change:  # outside the lock: callbacks may re-enter
            self._on_state_change(key, state)

    def get_subscriber_state(self, mac: bytes | str) -> SubscriberState:
        with self._lock:
            e = self._entries.get(mac_to_u64(mac))
            return e.state if e else SubscriberState.UNKNOWN

    def add_to_walled_garden(self, mac: bytes | str, vlan_id: int = 0) -> None:
        self.set_subscriber_state(mac, SubscriberState.WALLED_GARDEN, vlan_id)

    def release_from_walled_garden(self, mac: bytes | str) -> None:
        """Promote to fully provisioned (manager.go:313-316)."""
        self.set_subscriber_state(mac, SubscriberState.PROVISIONED)

    def block_mac(self, mac: bytes | str) -> None:
        self.set_subscriber_state(mac, SubscriberState.BLOCKED)

    def remove_mac(self, mac: bytes | str) -> None:
        key = mac_to_u64(mac)
        with self._lock:
            removed = self._entries.pop(key, None) is not None
        # removal reverts the MAC to UNKNOWN (gardened by default): every
        # enforcement point must hear about it, same as a transition
        if removed and self._on_state_change:
            self._on_state_change(key, SubscriberState.UNKNOWN)

    def list_walled_macs(self) -> list[int]:
        with self._lock:
            return [k for k, e in self._entries.items()
                    if e.state == SubscriberState.WALLED_GARDEN]

    # -- packet-path decisions (host-side mirror of the device logic) --

    def is_destination_allowed(self, ip: str, port: int, proto: int) -> bool:
        with self._lock:
            # exact + each wildcard combination (port=0 any-port, proto=0 any-proto)
            for p, pr in ((port, proto), (port, 0), (0, proto), (0, 0)):
                if AllowedDestination(ip, p, pr).key() in self._allowed:
                    return True
        return False

    def should_redirect(self, mac: bytes | str, dst_ip: str, dst_port: int,
                        proto: int = IPPROTO_TCP) -> bool:
        """True if this flow should be diverted to the portal."""
        state = self.get_subscriber_state(mac)
        if state == SubscriberState.PROVISIONED:
            return False
        if self.is_destination_allowed(dst_ip, dst_port, proto):
            return False
        with self._lock:
            self._stats["redirects"] += 1
        if self._on_redirect:
            self._on_redirect(mac, dst_ip)
        return True

    # -- expiry (manager.go:347-396) -----------------------------------

    def check_expired(self) -> int:
        """Drop expired gardened entries; they revert to UNKNOWN."""
        now = self._clock()
        expired = []
        with self._lock:
            for key, e in list(self._entries.items()):
                if e.expiry_time and e.expiry_time <= now:
                    del self._entries[key]
                    expired.append(key)
            self._stats["expired"] += len(expired)
        for key in expired:
            if self._on_expire:
                self._on_expire(key)
            if self._on_state_change:  # expiry reverts to UNKNOWN
                self._on_state_change(key, SubscriberState.UNKNOWN)
        return len(expired)

    def stats(self) -> dict:
        with self._lock:
            by_state = {s.name: 0 for s in SubscriberState}
            for e in self._entries.values():
                by_state[e.state.name] += 1
            return {
                "total_entries": len(self._entries),
                "allowed_destinations": len(self._allowed),
                **by_state,
                **self._stats,
            }
