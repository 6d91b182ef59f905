"""RADIUS-less "direct" authenticator: ONT-serial / circuit-ID -> subscriber.

Parity: pkg/direct — Config (authenticator.go:40-78), Authenticator with
the lookup cascade cache -> Nexus -> BSS (authenticator.go:182-351),
TTL cache by serial + circuit-ID (authenticator.go:353-391), SyncFromBSS
(authenticator.go:393-425), ReportBindingEvent (authenticator.go:427-451),
BSSClient interface + stub (authenticator.go:127-140, bss_stub.go:9).

Plugs into subscriber.SubscriberManager as its `authenticator` callable:
returns a profile dict on success, None on failure (-> walled garden).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from bng_tpu_torch.control.nexus import NexusClient
from bng_tpu_torch.control.subscriber import Session


@dataclass
class ONTMapping:
    """authenticator.go:93-125."""

    ont_serial: str = ""
    circuit_id: str = ""
    subscriber_id: str = ""
    isp_id: str = ""
    qos_policy: str = ""
    s_tag: int = 0
    c_tag: int = 0
    enabled: bool = True
    cached_at: float = 0.0


@dataclass
class BindingEvent:
    """authenticator.go:142-163: reported upstream for BSS reconciliation."""

    event_type: str  # "bind" | "unbind" | "reject"
    ont_serial: str = ""
    circuit_id: str = ""
    subscriber_id: str = ""
    mac: str = ""
    ip: str = ""
    timestamp: float = 0.0


@dataclass
class DirectConfig:
    """authenticator.go:40-78."""

    cache_ttl: float = 300.0
    allow_unknown: bool = False  # unknown ONT -> walled garden vs reject
    report_bindings: bool = True


class StubBSSClient:
    """bss_stub.go:9: fixture-backed BSS for tests/demo."""

    def __init__(self, mappings: list[ONTMapping] | None = None):
        self.mappings = {m.ont_serial: m for m in (mappings or [])}
        self.by_circuit = {m.circuit_id: m for m in (mappings or [])
                           if m.circuit_id}
        self.events: list[BindingEvent] = []

    def lookup_by_serial(self, serial: str) -> ONTMapping | None:
        return self.mappings.get(serial)

    def lookup_by_circuit_id(self, circuit_id: str) -> ONTMapping | None:
        return self.by_circuit.get(circuit_id)

    def list_mappings(self) -> list[ONTMapping]:
        return list(self.mappings.values())

    def report_event(self, event: BindingEvent) -> None:
        self.events.append(event)


class DirectAuthenticator:
    """authenticator.go:80-451."""

    def __init__(self, config: DirectConfig | None = None,
                 nexus: NexusClient | None = None, bss=None, clock=time.time):
        self.config = config or DirectConfig()
        self.nexus = nexus
        self.bss = bss
        self._clock = clock
        self._lock = threading.Lock()
        self._by_serial: dict[str, ONTMapping] = {}
        self._by_circuit: dict[str, ONTMapping] = {}
        self.stats = {"auth_success": 0, "auth_failure": 0, "cache_hits": 0,
                      "nexus_lookups": 0, "bss_lookups": 0, "bss_syncs": 0}

    def set_bss_client(self, bss) -> None:
        self.bss = bss

    # -- the SubscriberManager authenticator contract -------------------

    def __call__(self, session: Session) -> dict | None:
        return self.authenticate(session)

    def authenticate(self, session: Session) -> dict | None:
        """authenticator.go:182-263: resolve the session's ONT serial or
        circuit-ID to a subscriber profile; None -> walled garden."""
        serial = session.attributes.get("ont_serial", "")
        mapping = self.lookup(serial=serial, circuit_id=session.circuit_id,
                              mac=session.mac)
        if mapping is None or not mapping.enabled:
            self.stats["auth_failure"] += 1
            if self.config.report_bindings and self.bss is not None:
                self.bss.report_event(BindingEvent(
                    event_type="reject", ont_serial=serial,
                    circuit_id=session.circuit_id, mac=session.mac,
                    timestamp=self._clock()))
            return None
        self.stats["auth_success"] += 1
        if self.config.report_bindings and self.bss is not None:
            self.bss.report_event(BindingEvent(
                event_type="bind", ont_serial=mapping.ont_serial,
                circuit_id=mapping.circuit_id,
                subscriber_id=mapping.subscriber_id, mac=session.mac,
                timestamp=self._clock()))
        return {
            "subscriber_id": mapping.subscriber_id,
            "isp_id": mapping.isp_id,
            "qos_policy": mapping.qos_policy,
            "s_tag": mapping.s_tag,
            "c_tag": mapping.c_tag,
        }

    # -- lookup cascade (authenticator.go:265-351) ----------------------

    def lookup(self, serial: str = "", circuit_id: str = "",
               mac: str = "") -> ONTMapping | None:
        now = self._clock()
        with self._lock:
            m = None
            if serial:
                m = self._by_serial.get(serial)
            if m is None and circuit_id:
                m = self._by_circuit.get(circuit_id)
            if m is not None and now - m.cached_at < self.config.cache_ttl:
                self.stats["cache_hits"] += 1
                return m

        m = self._lookup_nexus(serial, circuit_id, mac)
        if m is None and self.bss is not None:
            self.stats["bss_lookups"] += 1
            if serial:
                m = self.bss.lookup_by_serial(serial)
            if m is None and circuit_id:
                m = self.bss.lookup_by_circuit_id(circuit_id)
        if m is not None:
            self._cache(m)
        return m

    def _lookup_nexus(self, serial: str, circuit_id: str,
                      mac: str) -> ONTMapping | None:
        if self.nexus is None:
            return None
        self.stats["nexus_lookups"] += 1
        sub = None
        if circuit_id:
            sub = self.nexus.get_subscriber_by_circuit_id(circuit_id)
        if sub is None and mac:
            sub = self.nexus.get_subscriber_by_mac(mac)
        if sub is None and serial:
            for s in self.nexus.subscribers.list().values():
                if s.nte_id == serial:
                    sub = s
                    break
        if sub is None or not sub.enabled:
            return None
        nte = self.nexus.ntes.get(sub.nte_id) if sub.nte_id else None
        return ONTMapping(
            ont_serial=sub.nte_id, circuit_id=sub.circuit_id,
            subscriber_id=sub.id, isp_id=sub.isp_id,
            qos_policy=sub.qos_policy,
            s_tag=nte.s_tag if nte else 0, c_tag=nte.c_tag if nte else 0,
            enabled=sub.enabled)

    def _cache(self, m: ONTMapping) -> None:
        m.cached_at = self._clock()
        with self._lock:
            if m.ont_serial:
                self._by_serial[m.ont_serial] = m
            if m.circuit_id:
                self._by_circuit[m.circuit_id] = m

    def invalidate_cache(self, serial: str = "", circuit_id: str = "") -> None:
        """authenticator.go:380-391."""
        with self._lock:
            if serial:
                self._by_serial.pop(serial, None)
            if circuit_id:
                self._by_circuit.pop(circuit_id, None)

    def sync_from_bss(self) -> int:
        """authenticator.go:393-425: bulk-refresh the cache."""
        if self.bss is None:
            return 0
        n = 0
        for m in self.bss.list_mappings():
            self._cache(m)
            n += 1
        self.stats["bss_syncs"] += 1
        return n
