"""Security/compliance audit pipeline.

Parity: pkg/audit — Event/EventType/Severity (types.go:8-180), async
Logger with severity filter + buffered worker (logger.go:15-628), Storage
interface + query (logger.go:89-133), exporters: syslog RFC 5424
(export.go:17-141), IPFIX-ish binary NAT records (export.go:143-315),
JSON lines (export.go:317-404), rotating file with gzip + retention
(rotation.go:19-413), RetentionManager with legal holds + standard ISP
retention presets (retention.go:9-370).
"""

from __future__ import annotations

import gzip
import json
import os
import queue
import struct
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum, IntEnum


class Severity(IntEnum):
    DEBUG = 0
    INFO = 1
    NOTICE = 2
    WARNING = 3
    ERROR = 4
    CRITICAL = 5


class EventType(str, Enum):
    # Session (types.go:13-16)
    SESSION_START = "SESSION_START"
    SESSION_STOP = "SESSION_STOP"
    SESSION_UPDATE = "SESSION_UPDATE"
    SESSION_TIMEOUT = "SESSION_TIMEOUT"
    # Auth (types.go:19-21)
    AUTH_SUCCESS = "AUTH_SUCCESS"
    AUTH_FAILURE = "AUTH_FAILURE"
    AUTH_REJECT = "AUTH_REJECT"
    # DHCP (types.go:24-30)
    DHCP_DISCOVER = "DHCP_DISCOVER"
    DHCP_OFFER = "DHCP_OFFER"
    DHCP_REQUEST = "DHCP_REQUEST"
    DHCP_ACK = "DHCP_ACK"
    DHCP_NAK = "DHCP_NAK"
    DHCP_RELEASE = "DHCP_RELEASE"
    DHCP_DECLINE = "DHCP_DECLINE"
    # NAT (types.go:33-34)
    NAT_MAPPING = "NAT_MAPPING"
    NAT_EXPIRY = "NAT_EXPIRY"
    # Policy (types.go:37-38)
    POLICY_APPLY = "POLICY_APPLY"
    POLICY_VIOLATION = "POLICY_VIOLATION"
    # Walled garden (types.go:41-43)
    WALLED_GARDEN_ADD = "WALLED_GARDEN_ADD"
    WALLED_GARDEN_RELEASE = "WALLED_GARDEN_RELEASE"
    WALLED_GARDEN_BLOCK = "WALLED_GARDEN_BLOCK"
    # Admin / system (types.go:46-53)
    CONFIG_CHANGE = "CONFIG_CHANGE"
    ADMIN_ACTION = "ADMIN_ACTION"
    SYSTEM_START = "SYSTEM_START"
    SYSTEM_STOP = "SYSTEM_STOP"
    SYSTEM_ERROR = "SYSTEM_ERROR"
    # Device registration (types.go:56-59)
    DEVICE_REGISTRATION_ATTEMPT = "DEVICE_REGISTRATION_ATTEMPT"
    DEVICE_REGISTRATION_SUCCESS = "DEVICE_REGISTRATION_SUCCESS"
    DEVICE_REGISTRATION_FAILURE = "DEVICE_REGISTRATION_FAILURE"
    DEVICE_DEREGISTRATION = "DEVICE_DEREGISTRATION"
    # API security (types.go:62-66)
    API_AUTH_ATTEMPT = "API_AUTH_ATTEMPT"
    API_AUTH_SUCCESS = "API_AUTH_SUCCESS"
    API_AUTH_FAILURE = "API_AUTH_FAILURE"
    API_ACCESS_DENIED = "API_ACCESS_DENIED"
    API_RATE_LIMITED = "API_RATE_LIMITED"
    # Suspicious activity (types.go:69-74)
    SUSPICIOUS_ACTIVITY = "SUSPICIOUS_ACTIVITY"
    BRUTE_FORCE_DETECTED = "BRUTE_FORCE_DETECTED"
    UNAUTHORIZED_ACCESS = "UNAUTHORIZED_ACCESS"
    MAC_SPOOF_DETECTED = "MAC_SPOOF_DETECTED"
    IP_SPOOF_DETECTED = "IP_SPOOF_DETECTED"
    DHCP_STARVATION_ATTEMPT = "DHCP_STARVATION_ATTEMPT"
    # Resources (types.go:77-79)
    RESOURCE_ALLOCATED = "RESOURCE_ALLOCATED"
    RESOURCE_DEALLOCATED = "RESOURCE_DEALLOCATED"
    RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"


_CATEGORY_PREFIXES = [
    ("SESSION", "session"), ("AUTH", "auth"), ("DHCP", "dhcp"),
    ("NAT", "nat"), ("POLICY", "policy"), ("WALLED_GARDEN", "walledgarden"),
    ("CONFIG", "admin"), ("ADMIN", "admin"), ("SYSTEM", "system"),
    ("DEVICE", "device"), ("API", "api"), ("RESOURCE", "resource"),
]


def event_category(event_type: EventType) -> str:
    """Map event type -> retention category (retention.go:80-97 spirit)."""
    name = event_type.value
    for prefix, cat in _CATEGORY_PREFIXES:
        if name.startswith(prefix):
            return cat
    return "security"


@dataclass
class Event:
    event_type: EventType
    severity: Severity = Severity.INFO
    id: str = ""
    timestamp: float = 0.0
    subscriber_id: str = ""
    session_id: str = ""
    username: str = ""
    mac: str = ""
    ip: str = ""
    nat_public_ip: str = ""
    nat_public_port: int = 0
    nat_private_port: int = 0
    protocol: int = 0
    source: str = ""  # emitting component
    message: str = ""
    details: dict = field(default_factory=dict)

    @property
    def category(self) -> str:
        return event_category(self.event_type)


@dataclass
class AuditQuery:
    """logger.go:110-133."""

    start_time: float = 0.0
    end_time: float = 0.0
    event_types: list[EventType] = field(default_factory=list)
    subscriber_id: str = ""
    session_id: str = ""
    mac: str = ""
    ip: str = ""
    min_severity: Severity = Severity.DEBUG
    limit: int = 0


class MemoryStorage:
    """In-memory Storage impl (the reference's test double; Storage iface
    logger.go:89-108)."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: list[Event] = []

    def store(self, event: Event) -> None:
        with self._lock:
            self._events.append(event)
            if len(self._events) > self.max_events:
                del self._events[: len(self._events) - self.max_events]

    def query(self, q: AuditQuery) -> list[Event]:
        with self._lock:
            out = []
            for e in self._events:
                if q.start_time and e.timestamp < q.start_time:
                    continue
                if q.end_time and e.timestamp >= q.end_time:
                    continue
                if q.event_types and e.event_type not in q.event_types:
                    continue
                if q.subscriber_id and e.subscriber_id != q.subscriber_id:
                    continue
                if q.session_id and e.session_id != q.session_id:
                    continue
                if q.mac and e.mac.lower() != q.mac.lower():
                    continue
                if q.ip and e.ip != q.ip:
                    continue
                if e.severity < q.min_severity:
                    continue
                out.append(e)
                if q.limit and len(out) >= q.limit:
                    break
            return out

    def delete_before(self, cutoff: float, category: str = "",
                      keep=None) -> int:
        """Retention enforcement; keep(event) -> True preserves (legal hold)."""
        with self._lock:
            kept, dropped = [], 0
            for e in self._events:
                expired = e.timestamp < cutoff and \
                    (not category or e.category == category)
                if expired and not (keep and keep(e)):
                    dropped += 1
                else:
                    kept.append(e)
            self._events = kept
            return dropped

    def count(self) -> int:
        with self._lock:
            return len(self._events)


class AuditLogger:
    """Async audit logger (logger.go:15-628): buffered queue, worker
    thread, severity filter, storage + fan-out to exporters."""

    def __init__(self, storage=None, min_severity: Severity = Severity.INFO,
                 buffer_size: int = 10_000, clock=time.time,
                 async_mode: bool = True):
        self.storage = storage if storage is not None else MemoryStorage()
        self.min_severity = min_severity
        self._clock = clock
        self._async = async_mode
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._exporters: list = []
        self._worker: threading.Thread | None = None
        self._running = False
        self._lock = threading.Lock()
        self.stats = {"logged": 0, "dropped": 0, "filtered": 0,
                      "export_errors": 0}

    def add_exporter(self, exporter) -> None:
        self._exporters.append(exporter)

    def start(self) -> None:
        if not self._async or self._running:
            return
        self._running = True
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        if self._running:
            self._running = False
            self._queue.put(None)
            self._worker.join(timeout=5)
        self.flush()

    def flush(self) -> None:
        while True:
            try:
                ev = self._queue.get_nowait()
            except queue.Empty:
                return
            if ev is not None:
                self._store_and_export(ev)

    # -- logging entry points (logger.go:265-392) ----------------------

    def log_event(self, event: Event) -> None:
        if event.severity < self.min_severity:
            with self._lock:
                self.stats["filtered"] += 1
            return
        event.id = event.id or uuid.uuid4().hex
        event.timestamp = event.timestamp or self._clock()
        if self._async and self._running:
            try:
                self._queue.put_nowait(event)
            except queue.Full:
                with self._lock:
                    self.stats["dropped"] += 1
        else:
            self._store_and_export(event)

    def log(self, event_type: EventType, severity: Severity = Severity.INFO,
            **fields) -> None:
        self.log_event(Event(event_type=event_type, severity=severity, **fields))

    def log_session_start(self, **fields) -> None:
        self.log(EventType.SESSION_START, **fields)

    def log_session_stop(self, **fields) -> None:
        self.log(EventType.SESSION_STOP, **fields)

    def log_nat_mapping(self, **fields) -> None:
        self.log(EventType.NAT_MAPPING, **fields)

    def log_auth(self, success: bool, **fields) -> None:
        self.log(EventType.AUTH_SUCCESS if success else EventType.AUTH_FAILURE,
                 Severity.INFO if success else Severity.WARNING, **fields)

    def log_suspicious(self, threat_type: str, score: int, **fields) -> None:
        details = fields.pop("details", {})
        details.update({"threat_type": threat_type, "score": score})
        self.log(EventType.SUSPICIOUS_ACTIVITY, Severity.WARNING,
                 details=details, **fields)

    def log_config_change(self, **fields) -> None:
        self.log(EventType.CONFIG_CHANGE, Severity.NOTICE, **fields)

    # -- internals ------------------------------------------------------

    def _drain(self) -> None:
        while self._running:
            ev = self._queue.get()
            if ev is None:
                break
            self._store_and_export(ev)

    def _store_and_export(self, event: Event) -> None:
        self.storage.store(event)
        with self._lock:
            self.stats["logged"] += 1
        for exp in self._exporters:
            try:
                exp.export(event)
            except Exception:
                with self._lock:
                    self.stats["export_errors"] += 1


# -- exporters ----------------------------------------------------------

def event_to_dict(event: Event) -> dict:
    d = {k: v for k, v in event.__dict__.items() if v not in ("", 0, {}, None)}
    d["event_type"] = event.event_type.value
    d["severity"] = event.severity.name
    d["timestamp"] = event.timestamp
    return d


class SyslogAuditExporter:
    """RFC 5424 structured-data lines to a sink (export.go:17-141)."""

    _SEV_MAP = {Severity.DEBUG: 7, Severity.INFO: 6, Severity.NOTICE: 5,
                Severity.WARNING: 4, Severity.ERROR: 3, Severity.CRITICAL: 2}

    def __init__(self, sink, facility: int = 13, hostname: str = "bng",
                 app: str = "bng-audit"):
        self._sink = sink
        self.facility = facility
        self.hostname = hostname
        self.app = app

    def name(self) -> str:
        return "syslog"

    def export(self, event: Event) -> None:
        pri = self.facility * 8 + self._SEV_MAP[event.severity]
        ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(event.timestamp))
        sd = (f'[bng@32473 type="{event.event_type.value}" '
              f'subscriber="{event.subscriber_id}" session="{event.session_id}" '
              f'mac="{event.mac}" ip="{event.ip}"]')
        line = (f"<{pri}>1 {ts} {self.hostname} {self.app} - {event.id} "
                f"{sd} {event.message}")
        self._sink(line.encode())


class IPFIXAuditExporter:
    """Binary NAT-record export (export.go:143-315): fixed 32-byte record
    per NAT event, big-endian — timestamp_ms u64, private ip u32,
    private port u16, public ip u32, public port u16, protocol u8,
    event u8 (1=create 2=delete), subscriber-id FNV-1a u32, pad u64."""

    RECORD = struct.Struct(">QIHIHBBIQ")

    def __init__(self, sink):
        self._sink = sink

    def name(self) -> str:
        return "ipfix"

    def export(self, event: Event) -> None:
        if event.event_type not in (EventType.NAT_MAPPING, EventType.NAT_EXPIRY):
            return
        from bng_tpu_torch.utils.net import fnv1a32, ip_to_u32
        self._sink(self.RECORD.pack(
            int(event.timestamp * 1000),
            ip_to_u32(event.ip) if event.ip else 0,
            event.nat_private_port & 0xFFFF,
            ip_to_u32(event.nat_public_ip) if event.nat_public_ip else 0,
            event.nat_public_port & 0xFFFF,
            event.protocol & 0xFF,
            1 if event.event_type == EventType.NAT_MAPPING else 2,
            fnv1a32(event.subscriber_id.encode()) if event.subscriber_id else 0,
            0))


class JSONAuditExporter:
    """JSON-lines to a sink (export.go:317-404)."""

    def __init__(self, sink):
        self._sink = sink

    def name(self) -> str:
        return "json"

    def export(self, event: Event) -> None:
        self._sink((json.dumps(event_to_dict(event), separators=(",", ":"),
                               default=str) + "\n").encode())


class RotatingFileExporter:
    """Size-based rotation with optional gzip + retention sweep
    (rotation.go:19-413)."""

    def __init__(self, path: str, max_bytes: int = 10 * 1024 * 1024,
                 max_files: int = 10, compress: bool = True, clock=time.time):
        self.path = path
        self.max_bytes = max_bytes
        self.max_files = max_files
        self.compress = compress
        self._clock = clock
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "ab")

    def name(self) -> str:
        return "rotating-file"

    def export(self, event: Event) -> None:
        line = (json.dumps(event_to_dict(event), separators=(",", ":"),
                           default=str) + "\n").encode()
        with self._lock:
            self._fh.write(line)
            self._fh.flush()
            if self._fh.tell() >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(self._clock()))
        rotated = f"{self.path}.{stamp}.{uuid.uuid4().hex[:6]}"
        os.rename(self.path, rotated)
        if self.compress:
            with open(rotated, "rb") as src, gzip.open(rotated + ".gz", "wb") as dst:
                dst.write(src.read())
            os.remove(rotated)
        self._fh = open(self.path, "ab")
        self._enforce_retention()

    def _enforce_retention(self) -> None:
        base = os.path.basename(self.path)
        d = os.path.dirname(self.path) or "."
        rotated = sorted(f for f in os.listdir(d)
                         if f.startswith(base + ".") and f != base)
        while len(rotated) > self.max_files:
            os.remove(os.path.join(d, rotated.pop(0)))

    def close(self) -> None:
        with self._lock:
            self._fh.close()


# -- retention ----------------------------------------------------------

@dataclass
class LegalHold:
    """retention.go:26-41: preserve matching events regardless of policy."""

    id: str
    reason: str = ""
    created_at: float = 0.0
    expires_at: float = 0.0  # 0 = indefinite
    subscriber_id: str = ""
    session_id: str = ""
    mac: str = ""
    ip: str = ""
    event_types: list[EventType] = field(default_factory=list)


def standard_retention_policies() -> dict[str, int]:
    """Standard ISP retention presets in days (retention.go:304-345)."""
    return {
        "session": 365, "nat": 365, "auth": 365, "dhcp": 90, "admin": 730,
        "policy": 365, "walledgarden": 90, "system": 30, "device": 365,
        "api": 365, "security": 730, "resource": 365,
    }


class RetentionManager:
    """Per-category retention + legal holds (retention.go:9-302)."""

    def __init__(self, default_days: int = 365,
                 category_days: dict[str, int] | None = None, clock=time.time):
        self.default_days = default_days
        self.category_days = dict(category_days or standard_retention_policies())
        self._clock = clock
        self._lock = threading.Lock()
        self._holds: dict[str, LegalHold] = {}

    def get_retention(self, category: str) -> int:
        return self.category_days.get(category, self.default_days)

    def set_category_retention(self, category: str, days: int) -> None:
        self.category_days[category] = days

    def add_legal_hold(self, hold: LegalHold) -> None:
        with self._lock:
            hold.created_at = hold.created_at or self._clock()
            self._holds[hold.id] = hold

    def remove_legal_hold(self, hold_id: str) -> bool:
        with self._lock:
            return self._holds.pop(hold_id, None) is not None

    def legal_holds(self) -> list[LegalHold]:
        with self._lock:
            return list(self._holds.values())

    def is_under_legal_hold(self, event: Event) -> bool:
        """retention.go:155-263."""
        now = self._clock()
        with self._lock:
            holds = list(self._holds.values())
        for h in holds:
            if h.expires_at and now >= h.expires_at:
                continue
            if self._matches(event, h):
                return True
        return False

    @staticmethod
    def _matches(e: Event, h: LegalHold) -> bool:
        if h.subscriber_id and e.subscriber_id != h.subscriber_id:
            return False
        if h.session_id and e.session_id != h.session_id:
            return False
        if h.mac and e.mac.lower() != h.mac.lower():
            return False
        if h.ip and e.ip != h.ip:
            return False
        if h.event_types and e.event_type not in h.event_types:
            return False
        # A hold with no selectors holds everything.
        return True

    def cleanup_expired_holds(self) -> int:
        now = self._clock()
        with self._lock:
            dead = [k for k, h in self._holds.items()
                    if h.expires_at and now >= h.expires_at]
            for k in dead:
                del self._holds[k]
            return len(dead)

    def enforce(self, storage: MemoryStorage) -> int:
        """Sweep expired events out of storage, honoring legal holds."""
        now = self._clock()
        dropped = 0
        for category in set(list(self.category_days) + ["security"]):
            cutoff = now - self.get_retention(category) * 86400
            dropped += storage.delete_before(cutoff, category,
                                             keep=self.is_under_legal_hold)
        return dropped

    def policy_summary(self) -> dict[str, int]:
        return dict(self.category_days)
