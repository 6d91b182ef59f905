"""On-OLT agent daemon: bootstrap -> watch Nexus -> local caches.

The port's copy of `bng_tpu/control/agent.py` (jax-free).

Parity: pkg/agent — Agent state machine + loops (agent.go:41-313),
subscriber/NTE/ISP local caches with by-MAC / by-NTE lookups
(agent.go:315-455), ISP churn events (agent.go:389-412), heartbeat loop
(agent.go:255-300), health snapshot (agent.go:457-486), bootstrap
integration via ztp.BootstrapClient (bootstrap.go:62-340).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum

from bng_tpu_torch.control.nexus import (ISPConfigEntity, NTEEntity, NexusClient,
                                   SubscriberEntity)


class AgentState(str, Enum):
    """types.go:10-40."""

    INIT = "init"
    BOOTSTRAPPING = "bootstrapping"
    SYNCING = "syncing"
    ONLINE = "online"
    DEGRADED = "degraded"
    STOPPED = "stopped"


@dataclass
class AgentConfig:
    """agent.go:16-39."""

    device_id: str = ""
    heartbeat_interval: float = 30.0
    sync_interval: float = 60.0
    degraded_after: float = 90.0  # missed-heartbeat window


class Agent:
    """agent.go:41-486. The nexus client is injected; watchers keep the
    local caches warm so the dataplane never blocks on Nexus."""

    def __init__(self, config: AgentConfig, nexus: NexusClient,
                 bootstrap_client=None, clock=time.time):
        """bootstrap_client: an optional ztp.BootstrapClient — when given,
        start() runs the full registration flow first (the agent's TLS
        bootstrap variant, pkg/agent/bootstrap.go:62-340, typically over
        ztp.make_https_transport's pinned channel) and adopts the
        returned DeviceConfig (node identity, partner, pools)."""
        self.config = config
        self.nexus = nexus
        self._bootstrap = bootstrap_client
        self.device_config = None  # ztp.DeviceConfig after bootstrap
        self._clock = clock
        self._lock = threading.Lock()
        self._state = AgentState.INIT
        self._started_at = 0.0
        self._last_heartbeat_ok = 0.0
        self._subscribers: dict[str, SubscriberEntity] = {}
        self._by_mac: dict[str, str] = {}
        self._by_nte: dict[str, str] = {}
        self._ntes: dict[str, NTEEntity] = {}
        self._isps: dict[str, ISPConfigEntity] = {}
        self.on_state_change = None
        self.on_config_change = None
        self.on_isp_churn = None
        self.stats = {"heartbeats": 0, "heartbeat_failures": 0,
                      "subscriber_updates": 0, "nte_updates": 0,
                      "isp_churns": 0, "bootstrapped": 0,
                      "bootstrap_failures": 0}

    # -- state ----------------------------------------------------------

    @property
    def state(self) -> AgentState:
        with self._lock:
            return self._state

    def _set_state(self, new: AgentState) -> None:
        with self._lock:
            old, self._state = self._state, new
        if old != new and self.on_state_change:
            self.on_state_change(old, new)

    def is_online(self) -> bool:
        return self.state == AgentState.ONLINE

    def uptime(self) -> float:
        return self._clock() - self._started_at if self._started_at else 0.0

    # -- lifecycle ------------------------------------------------------

    def start(self, bootstrap_deadline: float | None = None) -> None:
        """Synchronous start: bootstrap -> full sync -> watch. The
        composition root drives heartbeat()/tick() on its scheduler
        (the reference's goroutine loops, agent.go:216-313)."""
        self._started_at = self._clock()
        self._set_state(AgentState.BOOTSTRAPPING)
        if self._bootstrap is not None:
            # registration poll (pending/backoff handled by the client);
            # the returned DeviceConfig is this agent's durable identity.
            # A failed bootstrap must not leave a live-looking agent stuck
            # in 'bootstrapping': transition to DEGRADED, then re-raise.
            try:
                dev = self._bootstrap.bootstrap(deadline=bootstrap_deadline)
            except BaseException:
                self.stats["bootstrap_failures"] += 1
                self._set_state(AgentState.DEGRADED)
                raise
            self.device_config = dev
            if dev.node_id:
                self.config.device_id = dev.node_id
            self.stats["bootstrapped"] = 1
        self._set_state(AgentState.SYNCING)
        self._full_sync()
        self._watch()
        self._last_heartbeat_ok = self._clock()
        self._set_state(AgentState.ONLINE)

    def stop(self) -> None:
        self._set_state(AgentState.STOPPED)

    def _full_sync(self) -> None:
        for sid, sub in self.nexus.subscribers.list().items():
            self._put_subscriber(sid, sub)
        for nid, nte in self.nexus.ntes.list().items():
            with self._lock:
                self._ntes[nid] = nte
        for iid, isp in self.nexus.isps.list().items():
            with self._lock:
                self._isps[iid] = isp

    def _watch(self) -> None:
        self.nexus.subscribers.watch(self._on_subscriber)
        self.nexus.ntes.watch(self._on_nte)
        self.nexus.isps.watch(self._on_isp)

    # -- heartbeat (agent.go:255-300) -----------------------------------

    def heartbeat(self) -> bool:
        try:
            self.nexus.heartbeat(self.config.device_id)
            self._last_heartbeat_ok = self._clock()
            self.stats["heartbeats"] += 1
            if self.state == AgentState.DEGRADED:
                self._set_state(AgentState.ONLINE)
            return True
        except Exception:
            self.stats["heartbeat_failures"] += 1
            self.tick()
            return False

    def tick(self) -> None:
        """Degrade when heartbeats stop landing."""
        if (self.state == AgentState.ONLINE
                and self._clock() - self._last_heartbeat_ok
                > self.config.degraded_after):
            self._set_state(AgentState.DEGRADED)

    # -- cache maintenance ---------------------------------------------

    def _put_subscriber(self, sid: str, sub: SubscriberEntity) -> None:
        with self._lock:
            old = self._subscribers.get(sid)
            self._subscribers[sid] = sub
            if sub.mac:
                self._by_mac[sub.mac.lower()] = sid
            if sub.nte_id:
                self._by_nte[sub.nte_id] = sid
        self.stats["subscriber_updates"] += 1
        if (old is not None and old.isp_id and sub.isp_id
                and old.isp_id != sub.isp_id):
            self.stats["isp_churns"] += 1
            if self.on_isp_churn:
                self.on_isp_churn(sid, old.isp_id, sub.isp_id)
        if self.on_config_change:
            self.on_config_change("subscriber", sid)

    def _on_subscriber(self, sid: str, sub: SubscriberEntity | None) -> None:
        if sub is None:
            self.remove_subscriber(sid)
        else:
            self._put_subscriber(sid, sub)

    def _on_nte(self, nid: str, nte: NTEEntity | None) -> None:
        with self._lock:
            if nte is None:
                self._ntes.pop(nid, None)
            else:
                self._ntes[nid] = nte
        self.stats["nte_updates"] += 1

    def _on_isp(self, iid: str, isp: ISPConfigEntity | None) -> None:
        with self._lock:
            if isp is None:
                self._isps.pop(iid, None)
            else:
                self._isps[iid] = isp

    def remove_subscriber(self, sid: str) -> None:
        with self._lock:
            sub = self._subscribers.pop(sid, None)
            if sub is not None:
                if sub.mac and self._by_mac.get(sub.mac.lower()) == sid:
                    del self._by_mac[sub.mac.lower()]
                serial = sub.nte_id
                if serial and self._by_nte.get(serial) == sid:
                    del self._by_nte[serial]

    # -- lookups (agent.go:315-455) -------------------------------------

    def get_subscriber(self, sid: str) -> SubscriberEntity | None:
        with self._lock:
            return self._subscribers.get(sid)

    def get_subscriber_by_mac(self, mac: str) -> SubscriberEntity | None:
        with self._lock:
            sid = self._by_mac.get(mac.lower())
            return self._subscribers.get(sid) if sid else None

    def get_subscriber_by_nte(self, serial: str) -> SubscriberEntity | None:
        with self._lock:
            sid = self._by_nte.get(serial)
            return self._subscribers.get(sid) if sid else None

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subscribers)

    def subscriber_count_by_isp(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for sub in self._subscribers.values():
                if sub.isp_id:
                    out[sub.isp_id] = out.get(sub.isp_id, 0) + 1
            return out

    def get_nte(self, serial: str) -> NTEEntity | None:
        with self._lock:
            return self._ntes.get(serial)

    def nte_count(self) -> int:
        with self._lock:
            return len(self._ntes)

    def get_isp_config(self, isp_id: str) -> ISPConfigEntity | None:
        with self._lock:
            return self._isps.get(isp_id)

    def health(self) -> dict:
        """agent.go:457-486."""
        return {
            "state": self.state.value,
            "device_id": self.config.device_id,
            "uptime_s": self.uptime(),
            "subscribers": self.subscriber_count(),
            "ntes": self.nte_count(),
            "last_heartbeat_age_s": (self._clock() - self._last_heartbeat_ok
                                     if self._last_heartbeat_ok else -1),
            **self.stats,
        }
