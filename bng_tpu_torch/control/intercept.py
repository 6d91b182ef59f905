"""Lawful intercept: warrants, session matching, IRI/CC records, exporters.

The port's copy of `bng_tpu/control/intercept.py` (jax-free), its imports
renamed.

Parity: pkg/intercept — Warrant model + delivery methods (types.go:40-120),
Manager with AddWarrant/validate (manager.go:142-233, :467-496), target
indexes + MatchSession (manager.go:260-301, :498-534), RecordIRI/RecordCC
with port/protocol/dest-IP filters (manager.go:303-379), intercept session
lifecycle (manager.go:381-458), ETSI TS 102 232 HI2/HI3 PDU export
(exporter.go:191-317), JSON and syslog exporters (exporter.go:319-513),
warrant expiry.

Exporters here write to pluggable sinks (callables); TLSDeliverySink is
the production sink — a persistent pinned-TLS channel to the LEA
collector (the exporter.go:191-317 TLS delivery role) with bounded
buffering and reconnect-on-failure, built on control.ztp_tls.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum


class WarrantType(str, Enum):
    SUBSCRIBER = "subscriber"
    IP = "ip"
    MAC = "mac"
    USERNAME = "username"


class WarrantStatus(str, Enum):
    PENDING = "pending"
    ACTIVE = "active"
    SUSPENDED = "suspended"
    EXPIRED = "expired"
    REVOKED = "revoked"


class DeliveryMethod(str, Enum):
    ETSI = "ETSI"
    PCAP = "PCAP"
    SYSLOG = "SYSLOG"
    JSON_HTTPS = "JSON_HTTPS"


class IRIEventType(str, Enum):
    SESSION_START = "session_start"
    SESSION_STOP = "session_stop"
    SESSION_UPDATE = "session_update"
    ADDRESS_ASSIGNED = "address_assigned"
    ADDRESS_RELEASED = "address_released"
    AUTH_SUCCESS = "auth_success"
    AUTH_FAILURE = "auth_failure"


class Direction(str, Enum):
    UPSTREAM = "upstream"
    DOWNSTREAM = "downstream"


@dataclass
class Warrant:
    """types.go:40-83."""

    id: str
    liid: str  # Lawful Interception ID assigned by the LEA
    type: WarrantType = WarrantType.SUBSCRIBER
    status: WarrantStatus = WarrantStatus.PENDING
    authority_ref: str = ""
    issuing_body: str = ""
    target_subscriber_id: str = ""
    target_mac: str = ""
    target_ipv4: str = ""
    target_ipv6: str = ""
    target_username: str = ""
    valid_from: float = 0.0
    valid_until: float = 0.0
    delivery_method: DeliveryMethod = DeliveryMethod.ETSI
    mediation_address: str = ""
    mediation_port: int = 0
    filter_source_ports: list[int] = field(default_factory=list)
    filter_dest_ports: list[int] = field(default_factory=list)
    filter_protocols: list[int] = field(default_factory=list)
    filter_dest_ips: list[str] = field(default_factory=list)
    sessions_matched: int = 0
    bytes_intercepted: int = 0
    last_activity: float = 0.0
    created_at: float = 0.0


@dataclass
class InterceptSession:
    """An active tap on one subscriber session (manager.go:381-416)."""

    id: str
    warrant_id: str
    liid: str
    subscriber_id: str = ""
    mac: str = ""
    ipv4: str = ""
    ipv6: str = ""
    started_at: float = 0.0
    iri_count: int = 0
    cc_count: int = 0
    cc_bytes: int = 0


@dataclass
class InterceptRecord:
    """types.go:96-140: one IRI (metadata) or CC (content) record."""

    id: str
    liid: str
    warrant_id: str
    timestamp: float
    record_type: str  # "IRI" | "CC"
    subscriber_id: str = ""
    mac: str = ""
    source_ip: str = ""
    dest_ip: str = ""
    source_port: int = 0
    dest_port: int = 0
    protocol: int = 0
    session_id: str = ""
    event_type: str = ""
    direction: str = ""
    payload: bytes = b""
    party_info: dict | None = None


class InterceptManager:
    """Warrant store + matcher + record pipeline (manager.go:15-534)."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._warrants: dict[str, Warrant] = {}
        self._by_subscriber: dict[str, list[str]] = {}
        self._by_mac: dict[str, list[str]] = {}
        self._by_ip: dict[str, list[str]] = {}
        self._by_username: dict[str, list[str]] = {}
        self._sessions: dict[str, InterceptSession] = {}
        self._exporters: dict[DeliveryMethod, object] = {}
        self._stats = {"iri_records": 0, "cc_records": 0, "filtered": 0,
                       "export_errors": 0}

    # -- warrant CRUD ---------------------------------------------------

    def add_exporter(self, method: DeliveryMethod, exporter) -> None:
        self._exporters[method] = exporter

    def add_warrant(self, warrant: Warrant) -> None:
        self._validate(warrant)
        now = self._clock()
        with self._lock:
            if warrant.id in self._warrants:
                raise ValueError(f"warrant {warrant.id} already exists")
            warrant.created_at = warrant.created_at or now
            if warrant.status == WarrantStatus.PENDING and \
                    warrant.valid_from <= now < warrant.valid_until:
                warrant.status = WarrantStatus.ACTIVE
            self._warrants[warrant.id] = warrant
            self._index(warrant)

    def remove_warrant(self, warrant_id: str) -> None:
        with self._lock:
            w = self._warrants.pop(warrant_id, None)
            if w is None:
                raise KeyError(warrant_id)
            self._unindex(w)
            for sid in [s.id for s in self._sessions.values()
                        if s.warrant_id == warrant_id]:
                del self._sessions[sid]

    def update_warrant_status(self, warrant_id: str, status: WarrantStatus) -> None:
        with self._lock:
            w = self._warrants.get(warrant_id)
            if w is None:
                raise KeyError(warrant_id)
            w.status = status

    def get_warrant(self, warrant_id: str) -> Warrant:
        with self._lock:
            w = self._warrants.get(warrant_id)
            if w is None:
                raise KeyError(warrant_id)
            return w

    def list_warrants(self) -> list[Warrant]:
        with self._lock:
            return list(self._warrants.values())

    def _validate(self, w: Warrant) -> None:
        """manager.go:467-496."""
        if not w.id or not w.liid:
            raise ValueError("warrant needs id and liid")
        if not (w.target_subscriber_id or w.target_mac or w.target_ipv4
                or w.target_ipv6 or w.target_username):
            raise ValueError("warrant needs at least one target identifier")
        if w.valid_until <= w.valid_from:
            raise ValueError("warrant validity window is empty")

    def _index(self, w: Warrant) -> None:
        if w.target_subscriber_id:
            self._by_subscriber.setdefault(w.target_subscriber_id, []).append(w.id)
        if w.target_mac:
            self._by_mac.setdefault(w.target_mac.lower(), []).append(w.id)
        for ip in (w.target_ipv4, w.target_ipv6):
            if ip:
                self._by_ip.setdefault(ip, []).append(w.id)
        if w.target_username:
            self._by_username.setdefault(w.target_username, []).append(w.id)

    def _unindex(self, w: Warrant) -> None:
        for index, key in ((self._by_subscriber, w.target_subscriber_id),
                           (self._by_mac, w.target_mac.lower()),
                           (self._by_ip, w.target_ipv4),
                           (self._by_ip, w.target_ipv6),
                           (self._by_username, w.target_username)):
            if key and key in index:
                index[key] = [i for i in index[key] if i != w.id]
                if not index[key]:
                    del index[key]

    # -- matching (manager.go:260-301) ---------------------------------

    def match_session(self, subscriber_id: str = "", mac: str = "",
                      ipv4: str = "", ipv6: str = "",
                      username: str = "") -> list[Warrant]:
        now = self._clock()
        with self._lock:
            ids: list[str] = []
            if subscriber_id:
                ids += self._by_subscriber.get(subscriber_id, [])
            if mac:
                ids += self._by_mac.get(mac.lower(), [])
            for ip in (ipv4, ipv6):
                if ip:
                    ids += self._by_ip.get(ip, [])
            if username:
                ids += self._by_username.get(username, [])
            out = []
            for wid in dict.fromkeys(ids):  # dedupe, preserve order
                w = self._warrants.get(wid)
                if w is None or w.status != WarrantStatus.ACTIVE:
                    continue
                if not (w.valid_from <= now < w.valid_until):
                    continue
                w.sessions_matched += 1
                out.append(w)
            return out

    # -- intercept sessions --------------------------------------------

    def start_intercept_session(self, warrant: Warrant, session_id: str,
                                subscriber_id: str = "", mac: str = "",
                                ipv4: str = "", ipv6: str = "") -> InterceptSession:
        s = InterceptSession(id=session_id, warrant_id=warrant.id,
                            liid=warrant.liid, subscriber_id=subscriber_id,
                            mac=mac, ipv4=ipv4, ipv6=ipv6,
                            started_at=self._clock())
        with self._lock:
            self._sessions[session_id] = s
        self.record_iri(warrant, IRIEventType.SESSION_START, s)
        return s

    def stop_intercept_session(self, session_id: str) -> None:
        with self._lock:
            s = self._sessions.pop(session_id, None)
            w = self._warrants.get(s.warrant_id) if s else None
        if s is not None and w is not None:
            self.record_iri(w, IRIEventType.SESSION_STOP, s)

    def get_session(self, session_id: str) -> InterceptSession | None:
        with self._lock:
            return self._sessions.get(session_id)

    # -- record generation (manager.go:303-379) ------------------------

    def record_iri(self, warrant: Warrant, event_type: IRIEventType,
                   session: InterceptSession, party_info: dict | None = None) -> None:
        rec = InterceptRecord(
            id=uuid.uuid4().hex, liid=warrant.liid, warrant_id=warrant.id,
            timestamp=self._clock(), record_type="IRI",
            subscriber_id=session.subscriber_id, mac=session.mac,
            session_id=session.id, event_type=event_type.value,
            party_info=party_info)
        with self._lock:
            session.iri_count += 1
            warrant.last_activity = rec.timestamp
            self._stats["iri_records"] += 1
        self._deliver(warrant, rec, iri=True)

    def record_cc(self, warrant: Warrant, session: InterceptSession,
                  direction: Direction, src_ip: str, dst_ip: str,
                  src_port: int, dst_port: int, protocol: int,
                  payload: bytes) -> bool:
        """Returns False if the warrant's filters exclude this packet."""
        if not self._passes_filters(warrant, src_port, dst_port, protocol, dst_ip):
            with self._lock:
                self._stats["filtered"] += 1
            return False
        rec = InterceptRecord(
            id=uuid.uuid4().hex, liid=warrant.liid, warrant_id=warrant.id,
            timestamp=self._clock(), record_type="CC",
            subscriber_id=session.subscriber_id, mac=session.mac,
            source_ip=src_ip, dest_ip=dst_ip, source_port=src_port,
            dest_port=dst_port, protocol=protocol, session_id=session.id,
            direction=direction.value, payload=payload)
        with self._lock:
            session.cc_count += 1
            session.cc_bytes += len(payload)
            warrant.bytes_intercepted += len(payload)
            warrant.last_activity = rec.timestamp
            self._stats["cc_records"] += 1
        self._deliver(warrant, rec, iri=False)
        return True

    @staticmethod
    def _passes_filters(w: Warrant, src_port: int, dst_port: int,
                        protocol: int, dst_ip: str) -> bool:
        if w.filter_source_ports and src_port not in w.filter_source_ports:
            return False
        if w.filter_dest_ports and dst_port not in w.filter_dest_ports:
            return False
        if w.filter_protocols and protocol not in w.filter_protocols:
            return False
        if w.filter_dest_ips and dst_ip not in w.filter_dest_ips:
            return False
        return True

    def _deliver(self, warrant: Warrant, rec: InterceptRecord, iri: bool) -> None:
        exp = self._exporters.get(warrant.delivery_method)
        if exp is None:
            return
        try:
            if iri:
                exp.deliver_iri(rec)
            else:
                exp.deliver_cc(rec)
        except Exception:
            with self._lock:
                self._stats["export_errors"] += 1

    # -- maintenance ----------------------------------------------------

    def expire_warrants(self, max_reaps: int | None = None) -> int:
        """Sweep ACTIVE warrants past their validity window to EXPIRED.

        `max_reaps` bounds one sweep (the `cleanup_expired` mold): a
        maintenance tick over a large warrant store expires at most
        that many per call, the remainder reaped by later ticks —
        iteration order is insertion order, so repeated bounded sweeps
        converge without starvation.
        """
        now = self._clock()
        n = 0
        with self._lock:
            for w in self._warrants.values():
                if max_reaps is not None and n >= max_reaps:
                    break
                if w.status == WarrantStatus.ACTIVE and now >= w.valid_until:
                    w.status = WarrantStatus.EXPIRED
                    n += 1
        return n

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats,
                        warrants=len(self._warrants),
                        active_sessions=len(self._sessions))


# -- exporters ----------------------------------------------------------

class ETSIExporter:
    """ETSI TS 102 232 HI2 (IRI) / HI3 (CC) handover PDUs
    (exporter.go:17-317). Simplified TLV framing, per-LIID sequencing."""

    VERSION = 0x02
    HI2 = 0x02
    HI3 = 0x03

    def __init__(self, sink, country_code: str = "XX"):
        """sink: Callable[[bytes], None] — the HI delivery channel."""
        self._sink = sink
        self.country_code = country_code
        self._seq: dict[str, int] = {}
        self._lock = threading.Lock()

    def name(self) -> str:
        return "etsi"

    def _next_seq(self, liid: str) -> int:
        with self._lock:
            seq = self._seq.get(liid, 0)
            self._seq[liid] = seq + 1
            return seq

    def _header(self, handover: int, rec: InterceptRecord, seq: int) -> bytearray:
        buf = bytearray()
        buf.append(self.VERSION)
        buf.append(handover)
        buf += rec.liid.encode() + b"\x00"
        buf += struct.pack(">Q", seq)
        buf += struct.pack(">Q", int(rec.timestamp * 1000))
        return buf

    def deliver_iri(self, rec: InterceptRecord) -> None:
        buf = self._header(self.HI2, rec, self._next_seq(rec.liid))
        payload = json.dumps({
            "event_type": rec.event_type,
            "timestamp": rec.timestamp,
            "session_id": rec.session_id,
            "subscriber_id": rec.subscriber_id,
            "source_ip": rec.source_ip,
            "dest_ip": rec.dest_ip,
            "source_port": rec.source_port,
            "dest_port": rec.dest_port,
            "protocol": rec.protocol,
            "party_info": rec.party_info,
            "country_code": self.country_code,
        }, separators=(",", ":")).encode()
        buf += struct.pack(">I", len(payload))
        buf += payload
        self._sink(bytes(buf))

    def deliver_cc(self, rec: InterceptRecord) -> None:
        buf = self._header(self.HI3, rec, self._next_seq(rec.liid))
        buf.append(len(rec.direction))
        buf += rec.direction.encode()
        for ip in (rec.source_ip, rec.dest_ip):
            raw = _pack_ip(ip)
            buf.append(len(raw))
            buf += raw
            # port follows each address, src then dst
            buf += struct.pack(">H", rec.source_port if ip == rec.source_ip
                               else rec.dest_port)
        buf.append(rec.protocol)
        buf += struct.pack(">I", len(rec.payload))
        buf += rec.payload
        self._sink(bytes(buf))


class JSONExporter:
    """JSON-lines delivery (exporter.go:319-424)."""

    def __init__(self, sink):
        self._sink = sink

    def name(self) -> str:
        return "json"

    def _deliver(self, rec: InterceptRecord) -> None:
        d = {k: v for k, v in rec.__dict__.items() if k != "payload"}
        if rec.payload:
            d["payload_len"] = len(rec.payload)
            d["payload_hex"] = rec.payload.hex()
        self._sink((json.dumps(d, separators=(",", ":")) + "\n").encode())

    deliver_iri = _deliver
    deliver_cc = _deliver


class SyslogExporter:
    """IRI-only syslog delivery (exporter.go:426-513); CC is refused the
    way the reference's syslog path only carries metadata."""

    def __init__(self, sink, facility: int = 13):
        self._sink = sink
        self.facility = facility

    def name(self) -> str:
        return "syslog"

    def deliver_iri(self, rec: InterceptRecord) -> None:
        pri = self.facility * 8 + 6  # informational
        msg = (f"<{pri}>1 - bng intercept - - - "
               f'liid={rec.liid} event={rec.event_type} session={rec.session_id} '
               f'subscriber={rec.subscriber_id}')
        self._sink(msg.encode())

    def deliver_cc(self, rec: InterceptRecord) -> None:
        raise ValueError("syslog delivery carries IRI only")


def _pack_ip(ip: str) -> bytes:
    if not ip:
        return b""
    if ":" in ip:
        import ipaddress
        return ipaddress.IPv6Address(ip).packed
    return bytes(int(x) for x in ip.split("."))


class TLSDeliverySink:
    """Persistent TLS delivery channel to an LEA collector — the sink an
    ETSIExporter (or JSONExporter) writes through in production.

    Parity: exporter.go:191-317 — the reference dials the collector over
    TLS, frames each PDU with a 4-byte big-endian length prefix, and
    reconnects with backoff on failure. Verification (CA and/or pinning,
    optional mTLS client identity) rides control.ztp_tls.TLSConfig: the
    pin check runs post-handshake, BEFORE any intercept product leaves
    the box — a mis-dialed collector sees zero bytes of HI2/HI3.

    Delivery is synchronous while the channel is HEALTHY (connected, or
    never yet failed): each record writes through inline. The moment a
    dial fails, send() stops dialing — records only buffer (bounded at
    `buffer_max`, oldest dropped + counted) and reconnection happens in
    flush(), which the owner drives from its tick loop. This keeps the
    capture path free of connect() stalls for the whole outage: the
    blocking dial cost lands on the 1 Hz maintenance heartbeat, not on
    per-packet interception.
    """

    FRAME_HDR = 4  # uint32 length prefix per PDU

    def __init__(self, host: str, port: int, tls_cfg, timeout: float = 5.0,
                 reconnect_backoff_s: float = 2.0, buffer_max: int = 4096,
                 clock=time.time, auto_flush: bool = True):
        from bng_tpu_torch.control.ztp_tls import build_ssl_context

        self.host = host
        self.port = port
        self.tls_cfg = tls_cfg
        # built ONCE: validates the config at construction and keeps the
        # cert/CA file I/O off the per-dial path (backoff retries included)
        self._ctx = build_ssl_context(tls_cfg)
        self.timeout = timeout
        self.backoff_s = reconnect_backoff_s
        self.buffer_max = buffer_max
        self.clock = clock
        self._sock = None
        self._buffer: list[bytes] = []
        self._next_dial = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.stats = {"delivered": 0, "buffered": 0, "dropped": 0,
                      "connects": 0, "connect_failures": 0}
        # self-healing: after a dial failure send() stops dialing (no
        # connect stalls on the capture path), so SOMETHING must redial —
        # this daemon retries every backoff while records are buffered.
        # auto_flush=False hands that duty to the owner's explicit
        # flush() (tests with fake clocks; apps with their own tick).
        if auto_flush:
            threading.Thread(target=self._flush_loop, daemon=True,
                             name=f"etsi-tls-{host}:{port}").start()

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.backoff_s):
            with self._lock:
                need = bool(self._buffer) and self._sock is None
            if not need:
                continue
            # dial OUTSIDE the buffer lock: a blocked connect (up to
            # `timeout`) must never stall a capture-path send() waiting
            # on the lock — that would defeat the class's entire design
            tls = self._dial()
            with self._lock:
                if tls is None:
                    self.stats["connect_failures"] += 1
                    self._next_dial = self.clock() + self.backoff_s
                elif self._sock is None:
                    self.stats["connects"] += 1
                    self._sock = tls
                    self._flush_locked()
                else:  # a send() beat us to it
                    try:
                        tls.close()
                    except OSError:
                        pass  # race loser; the winning socket is kept

    # -- the sink callable the exporters take --
    def __call__(self, pdu: bytes) -> None:
        self.send(pdu)

    def send(self, pdu: bytes) -> None:
        with self._lock:
            self._buffer.append(pdu)
            if len(self._buffer) > self.buffer_max:
                self._buffer.pop(0)
                self.stats["dropped"] += 1
            else:
                self.stats["buffered"] += 1
            # inline delivery only while healthy: _next_dial > 0 means a
            # dial failed and hasn't been cleared by a successful flush —
            # buffer without blocking; flush() (tick-driven) redials
            if self._sock is not None or self._next_dial == 0.0:
                self._flush_locked()

    def _dial(self):
        """Dial + verify; returns the TLS socket or None. Takes NO locks
        — callers decide how the result is installed."""
        import socket as _socket

        from bng_tpu_torch.control.ztp_tls import verify_wrapped_socket

        try:
            raw = _socket.create_connection((self.host, self.port),
                                            timeout=self.timeout)
            sn = self.tls_cfg.server_name or self.host
            tls = self._ctx.wrap_socket(raw, server_hostname=sn)
            verify_wrapped_socket(tls, self.tls_cfg)  # raises pre-delivery
            return tls
        except Exception:
            return None

    def _connect_locked(self):
        now = self.clock()
        if now < self._next_dial:
            return None
        tls = self._dial()
        if tls is None:
            self.stats["connect_failures"] += 1
            self._next_dial = now + self.backoff_s
            return None
        self.stats["connects"] += 1
        self._sock = tls
        return tls

    def _flush_locked(self) -> None:
        sock = self._sock or self._connect_locked()
        if sock is None:
            return
        while self._buffer:
            pdu = self._buffer[0]
            try:
                sock.sendall(struct.pack(">I", len(pdu)) + pdu)
            except Exception:
                # connection died mid-delivery: keep the PDU buffered,
                # drop the socket, back off before redialing
                try:
                    sock.close()
                except OSError:
                    pass  # socket already dead; nothing to release
                self._sock = None
                self._next_dial = self.clock() + self.backoff_s
                return
            self._buffer.pop(0)
            self.stats["delivered"] += 1

    def flush(self) -> bool:
        """Retry buffered PDUs now (tick hook). True = buffer empty."""
        with self._lock:
            self._next_dial = 0.0  # an explicit flush overrides backoff
            self._flush_locked()
            return not self._buffer

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass  # shutdown path; the socket is gone either way
                self._sock = None


def parse_etsi_pdu(data: bytes) -> dict:
    """Decode the framing produced by ETSIExporter (for tests/mediation)."""
    version, handover = data[0], data[1]
    end = data.index(0, 2)
    liid = data[2:end].decode()
    off = end + 1
    seq, ts_ms = struct.unpack_from(">QQ", data, off)
    off += 16
    out = {"version": version, "handover": handover, "liid": liid,
           "seq": seq, "timestamp_ms": ts_ms}
    if handover == ETSIExporter.HI2:
        (plen,) = struct.unpack_from(">I", data, off)
        out["iri"] = json.loads(data[off + 4:off + 4 + plen])
    else:
        dlen = data[off]; off += 1
        out["direction"] = data[off:off + dlen].decode(); off += dlen
        for which in ("source", "dest"):
            alen = data[off]; off += 1
            raw = data[off:off + alen]; off += alen
            out[f"{which}_ip"] = (".".join(str(b) for b in raw)
                                  if alen == 4 else raw.hex())
            (out[f"{which}_port"],) = struct.unpack_from(">H", data, off)
            off += 2
        out["protocol"] = data[off]; off += 1
        (plen,) = struct.unpack_from(">I", data, off)
        out["payload"] = data[off + 4:off + 4 + plen]
    return out
