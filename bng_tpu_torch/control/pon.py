"""PON/OLT NTE (ONT) lifecycle: discovery -> provisioning -> connected.

Parity: pkg/pon — NTEState (manager.go:14-39), DiscoveryEvent /
ProvisioningResult (manager.go:41-57), Manager with HandleDiscovery queue
(manager.go:188-214), handleDiscoveryEvent + provisionNTE (VLAN alloc via
Nexus, QoS profile, approval gating) (manager.go:216-379),
handleNexusNTEChange reacting to approval flips (manager.go:381-396),
HandleDisconnect (manager.go:398-427), stats (manager.go:460-495).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum

from bng_tpu_torch.control.nexus import NexusClient, NTEEntity


class NTEState(str, Enum):
    UNKNOWN = "unknown"
    DISCOVERED = "discovered"
    PENDING_APPROVAL = "pending_approval"
    PROVISIONING = "provisioning"
    CONNECTED = "connected"
    DISCONNECTED = "disconnected"
    FAILED = "failed"


@dataclass
class DiscoveryEvent:
    """manager.go:41-47: an ONT appeared on an OLT port."""

    serial: str
    olt_id: str = ""
    olt_port: int = 0
    model: str = ""
    timestamp: float = 0.0


@dataclass
class QoSProfile:
    """manager.go:80-84."""

    name: str = "default"
    down_mbps: int = 100
    up_mbps: int = 20


@dataclass
class ProvisioningResult:
    """manager.go:49-57."""

    serial: str
    success: bool = False
    s_tag: int = 0
    c_tag: int = 0
    qos_profile: str = ""
    error: str = ""


@dataclass
class PONConfig:
    """manager.go:59-97."""

    auto_provision: bool = True
    default_qos: QoSProfile = field(default_factory=QoSProfile)
    require_approval: bool = True


class PONManager:
    """manager.go:99-495. vlan_allocator: nexus.VLANAllocator-compatible
    (.allocate(id) -> (s_tag, c_tag))."""

    def __init__(self, config: PONConfig, nexus: NexusClient,
                 vlan_allocator=None, clock=time.time):
        self.config = config
        self.nexus = nexus
        self.vlans = vlan_allocator
        self._clock = clock
        self._lock = threading.Lock()
        self._states: dict[str, NTEState] = {}
        self._pending: dict[str, DiscoveryEvent] = {}
        self.on_discovered = None
        self.on_provisioned = None
        self.on_disconnected = None
        self.stats = {"discovered": 0, "provisioned": 0, "failed": 0,
                      "disconnected": 0, "pending": 0}
        self.nexus.ntes.watch(self._on_nexus_nte_change)

    # -- discovery (manager.go:188-277) ---------------------------------

    def handle_discovery(self, event: DiscoveryEvent) -> ProvisioningResult | None:
        event.timestamp = event.timestamp or self._clock()
        with self._lock:
            self._states[event.serial] = NTEState.DISCOVERED
            self.stats["discovered"] += 1
        if self.on_discovered:
            self.on_discovered(event)

        nte = self._find_nte(event.serial)
        if nte is None:
            # Unknown ONT: register as pending in Nexus, hold locally.
            self.nexus.ntes.put(event.serial, NTEEntity(
                id=event.serial, serial=event.serial, model=event.model,
                olt_id=event.olt_id, state="discovered", approved=False))
            return self._hold_pending(event)
        if self.config.require_approval and not nte.approved:
            return self._hold_pending(event)
        if not self.config.auto_provision:
            return self._hold_pending(event)
        return self.provision(event)

    def _hold_pending(self, event: DiscoveryEvent) -> None:
        with self._lock:
            if event.serial not in self._pending:
                self.stats["pending"] += 1
            self._pending[event.serial] = event
            self._states[event.serial] = NTEState.PENDING_APPROVAL
        return None

    def _find_nte(self, serial: str) -> NTEEntity | None:
        nte = self.nexus.ntes.get(serial)
        if nte is not None:
            return nte
        for n in self.nexus.ntes.list().values():
            if n.serial == serial:
                return n
        return None

    # -- provisioning (manager.go:279-379) ------------------------------

    def provision(self, event: DiscoveryEvent) -> ProvisioningResult:
        serial = event.serial
        with self._lock:
            # Leave pending before writing back to Nexus: the ntes.put below
            # re-fires our own watcher, which must not re-enter provision.
            if self._pending.pop(serial, None) is not None:
                self.stats["pending"] -= 1
            self._states[serial] = NTEState.PROVISIONING
        nte = self._find_nte(serial)
        if nte is None:
            return self._fail(serial, "NTE vanished during provisioning")
        s_tag, c_tag = nte.s_tag, nte.c_tag
        if not (s_tag or c_tag):
            if self.vlans is None:
                return self._fail(serial, "no VLAN assignment and no allocator")
            pair = self.vlans.allocate(serial)
            if pair is None:
                return self._fail(serial, "VLAN space exhausted")
            s_tag, c_tag = pair
        nte.s_tag, nte.c_tag = s_tag, c_tag
        nte.state = "connected"
        self.nexus.ntes.put(nte.id, nte)
        result = ProvisioningResult(
            serial=serial, success=True, s_tag=s_tag, c_tag=c_tag,
            qos_profile=self.config.default_qos.name)
        with self._lock:
            self._states[serial] = NTEState.CONNECTED
            self.stats["provisioned"] += 1
        if self.on_provisioned:
            self.on_provisioned(result)
        return result

    def _fail(self, serial: str, error: str) -> ProvisioningResult:
        with self._lock:
            self._states[serial] = NTEState.FAILED
            self.stats["failed"] += 1
        result = ProvisioningResult(serial=serial, success=False, error=error)
        if self.on_provisioned:
            self.on_provisioned(result)
        return result

    # -- nexus reaction (manager.go:381-396) ----------------------------

    def _on_nexus_nte_change(self, nte_id: str, nte: NTEEntity | None) -> None:
        if nte is None:
            return
        with self._lock:
            pending = self._pending.get(nte.serial or nte_id)
        if pending is not None and nte.approved:
            self.provision(pending)

    # -- disconnect (manager.go:398-427) --------------------------------

    def handle_disconnect(self, serial: str) -> None:
        with self._lock:
            self._states[serial] = NTEState.DISCONNECTED
            self.stats["disconnected"] += 1
        nte = self._find_nte(serial)
        if nte is not None:
            nte.state = "disconnected"
            self.nexus.ntes.put(nte.id, nte)
        if self.on_disconnected:
            self.on_disconnected(serial)

    # -- queries (manager.go:429-495) -----------------------------------

    def get_state(self, serial: str) -> NTEState:
        with self._lock:
            return self._states.get(serial, NTEState.UNKNOWN)

    def list_connected(self) -> list[str]:
        with self._lock:
            return [s for s, st in self._states.items()
                    if st == NTEState.CONNECTED]

    def list_pending(self) -> list[DiscoveryEvent]:
        with self._lock:
            return list(self._pending.values())

    def get_stats(self) -> dict:
        with self._lock:
            return dict(self.stats)
