"""RFC 6908 NAT compliance logging with LEA query support (a copy of
`bng_tpu/control/nat_logging.py`).

Parity: pkg/nat/logging.go — Logger with buffered entries + flush
(logging.go:63-214, :349-414), formats json/syslog/csv/nel
(:416-523), bulk port-block logging (RFC 6908 reduced-volume mode,
:51-61, :364-414), size-based rotation with gzip + max-age cleanup
(:525-683), QueryByPublicEndpoint — "who had this public IP:port at this
time?" — backed by a real in-memory interval index here (the reference
stubs it behind an index database, :685-694).

Consumes the NAT events through NATManager's log_sink (control/nat.py
NATLogEntry: the host sweep and the punt path emit them).
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from dataclasses import dataclass, field

from bng_tpu_torch.control.nat import (LOG_PORT_BLOCK_ASSIGN, LOG_PORT_BLOCK_RELEASE,
                                 LOG_SESSION_CREATE, LOG_SESSION_DELETE,
                                 NATLogEntry)
from bng_tpu_torch.utils.net import u32_to_ip

_EVENT_NAMES = {
    LOG_SESSION_CREATE: "session_create",
    LOG_SESSION_DELETE: "session_delete",
    LOG_PORT_BLOCK_ASSIGN: "port_block_assign",
    LOG_PORT_BLOCK_RELEASE: "port_block_release",
    5: "port_exhaustion", 6: "hairpin", 7: "alg_trigger",
}

_PROTO_NAMES = {1: "icmp", 6: "tcp", 17: "udp"}


def _ts(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


@dataclass
class PortBlockRecord:
    """RFC 6908 bulk record (logging.go:51-61): one line covers the whole
    block instead of per-session churn."""

    timestamp: float
    event: str  # assign | release
    subscriber_id: int
    private_ip: str
    public_ip: str
    port_start: int
    port_end: int


@dataclass
class NATLoggerConfig:
    """logging.go:95-113."""

    enabled: bool = True
    file_path: str = ""  # empty -> in-memory only
    fmt: str = "json"  # json | syslog | csv | nel
    buffer_size: int = 1000
    bulk_logging: bool = False
    max_file_size: int = 0  # bytes; 0 = no rotation
    max_age: float = 0.0  # seconds; 0 = keep forever
    compress: bool = True
    enable_index: bool = True
    index_capacity: int = 1_000_000


class NATComplianceLogger:
    """logging.go:63-724."""

    def __init__(self, config: NATLoggerConfig | None = None, clock=time.time):
        self.config = config or NATLoggerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._buffer: list[dict] = []
        self._block_buffer: list[PortBlockRecord] = []
        self._fh = None
        self._size = 0
        # Compliance index: (public_ip, port) -> list of
        # (start_ts, end_ts|None, record) in insertion (time) order.
        self._index: dict[tuple[str, int], list] = {}
        self._indexed = 0
        self.stats = {"entries": 0, "block_entries": 0, "flushes": 0,
                      "rotations": 0, "dropped": 0}
        if self.config.file_path:
            os.makedirs(os.path.dirname(self.config.file_path) or ".",
                        exist_ok=True)
            self._fh = open(self.config.file_path, "ab")
            self._size = self._fh.tell()

    # -- ingestion ------------------------------------------------------

    def log_device_event(self, e: NATLogEntry) -> None:
        """The NATManager log_sink target (logging.go LogFromBPF :293-333)."""
        if not self.config.enabled:
            return
        event = _EVENT_NAMES.get(e.event_type, f"event_{e.event_type}")
        if self.config.bulk_logging and e.event_type in (
                LOG_PORT_BLOCK_ASSIGN, LOG_PORT_BLOCK_RELEASE):
            self._add_block(PortBlockRecord(
                timestamp=float(e.timestamp),
                event="assign" if e.event_type == LOG_PORT_BLOCK_ASSIGN
                else "release",
                subscriber_id=e.subscriber_id,
                private_ip=u32_to_ip(e.private_ip),
                public_ip=u32_to_ip(e.public_ip),
                port_start=e.private_port, port_end=e.public_port))
            return
        if self.config.bulk_logging and e.event_type in (
                LOG_SESSION_CREATE, LOG_SESSION_DELETE):
            return  # RFC 6908: block records subsume per-session lines
        self._add({
            "ts": _ts(float(e.timestamp)), "t": float(e.timestamp),
            "event": event, "subscriber": e.subscriber_id,
            "private_ip": u32_to_ip(e.private_ip), "private_port": e.private_port,
            "public_ip": u32_to_ip(e.public_ip), "public_port": e.public_port,
            "dest_ip": u32_to_ip(e.dest_ip), "dest_port": e.dest_port,
            "protocol": _PROTO_NAMES.get(e.protocol, str(e.protocol)),
        })

    def log_session(self, private_ip: str, private_port: int, public_ip: str,
                    public_port: int, dest_ip: str = "", dest_port: int = 0,
                    protocol: int = 6, subscriber_id: int = 0,
                    end: bool = False) -> None:
        """logging.go:239-291."""
        now = self._clock()
        self._add({
            "ts": _ts(now), "t": now,
            "event": "session_delete" if end else "session_create",
            "subscriber": subscriber_id,
            "private_ip": private_ip, "private_port": private_port,
            "public_ip": public_ip, "public_port": public_port,
            "dest_ip": dest_ip, "dest_port": dest_port,
            "protocol": _PROTO_NAMES.get(protocol, str(protocol)),
        })

    def log_allocation(self, subscriber_id: int, private_ip: str,
                       public_ip: str, port_start: int, port_end: int,
                       release: bool = False) -> None:
        """logging.go:178-237: the RFC 6908 bulk path."""
        self._add_block(PortBlockRecord(
            timestamp=self._clock(),
            event="release" if release else "assign",
            subscriber_id=subscriber_id, private_ip=private_ip,
            public_ip=public_ip, port_start=port_start, port_end=port_end))

    def _add(self, rec: dict) -> None:
        with self._lock:
            self._buffer.append(rec)
            self.stats["entries"] += 1
            if self.config.enable_index:
                self._index_session(rec)
            full = len(self._buffer) >= self.config.buffer_size
        if full:
            self.flush()

    def _add_block(self, rec: PortBlockRecord) -> None:
        with self._lock:
            self._block_buffer.append(rec)
            self.stats["block_entries"] += 1
            if self.config.enable_index:
                self._index_block(rec)
            full = len(self._block_buffer) >= self.config.buffer_size
        if full:
            self.flush()

    # -- compliance index ----------------------------------------------

    def _index_session(self, rec: dict) -> None:
        key = (rec["public_ip"], rec["public_port"])
        if rec["event"] == "session_create":
            self._index.setdefault(key, []).append(
                [rec["t"], None, rec])
            self._indexed += 1
        elif rec["event"] == "session_delete":
            for iv in reversed(self._index.get(key, [])):
                if iv[1] is None:
                    iv[1] = rec["t"]
                    break
        if self._indexed > self.config.index_capacity:
            self._evict_index()

    def _index_block(self, rec: PortBlockRecord) -> None:
        # One interval entry per block, keyed port 0 + range kept in the
        # record; query expands the range check.
        key = (rec.public_ip, -1)
        if rec.event == "assign":
            self._index.setdefault(key, []).append(
                [rec.timestamp, None, rec])
            self._indexed += 1
        else:
            for iv in reversed(self._index.get(key, [])):
                r = iv[2]
                if iv[1] is None and r.port_start == rec.port_start \
                        and r.private_ip == rec.private_ip:
                    iv[1] = rec.timestamp
                    break
        if self._indexed > self.config.index_capacity:
            self._evict_index()

    def _evict_index(self) -> None:
        # Drop oldest closed intervals first.
        for key in list(self._index):
            ivs = self._index[key]
            keep = [iv for iv in ivs if iv[1] is None]
            dropped = len(ivs) - len(keep)
            if dropped:
                closed = sorted((iv for iv in ivs if iv[1] is not None),
                                key=lambda iv: iv[1])
                keep = closed[dropped // 2:] + keep
                self._index[key] = keep
                self._indexed -= dropped // 2
            if self._indexed <= self.config.index_capacity:
                break

    def query_by_public_endpoint(self, public_ip: str, public_port: int,
                                 timestamp: float) -> dict | None:
        """The LEA question (logging.go:685-694): who held public
        ip:port at time T? Checks session intervals then port blocks."""
        with self._lock:
            for start, end, rec in self._index.get((public_ip, public_port), []):
                if start <= timestamp and (end is None or timestamp < end):
                    return dict(rec)
            for start, end, rec in self._index.get((public_ip, -1), []):
                if (start <= timestamp and (end is None or timestamp < end)
                        and rec.port_start <= public_port <= rec.port_end):
                    return {"event": "port_block", "subscriber": rec.subscriber_id,
                            "private_ip": rec.private_ip,
                            "public_ip": rec.public_ip,
                            "port_start": rec.port_start,
                            "port_end": rec.port_end, "t": start}
        return None

    # -- formatting (logging.go:416-523) --------------------------------

    def _format(self, rec: dict) -> bytes:
        fmt = self.config.fmt
        if fmt == "json":
            return (json.dumps({k: v for k, v in rec.items() if k != "t"},
                               separators=(",", ":")) + "\n").encode()
        if fmt == "syslog":
            return (f"{rec['ts']} NAT {rec['event']}: "
                    f"subscriber={rec['subscriber']} "
                    f"private={rec['private_ip']}:{rec['private_port']} "
                    f"public={rec['public_ip']}:{rec['public_port']} "
                    f"dest={rec['dest_ip']}:{rec['dest_port']} "
                    f"proto={rec['protocol']}\n").encode()
        if fmt == "csv":
            cols = (rec["ts"], rec["event"], rec["subscriber"],
                    rec["private_ip"], rec["private_port"], rec["public_ip"],
                    rec["public_port"], rec["dest_ip"], rec["dest_port"],
                    rec["protocol"])
            return (",".join(str(c) for c in cols) + "\n").encode()
        if fmt == "nel":
            nel = {"type": "NAT", "age": 0,
                   "body": {k: rec[k] for k in
                            ("event", "subscriber", "private_ip",
                             "private_port", "public_ip", "public_port",
                             "dest_ip", "dest_port", "protocol")}}
            return (json.dumps(nel, separators=(",", ":")) + "\n").encode()
        raise ValueError(f"unknown format {fmt}")

    def _format_block(self, rec: PortBlockRecord) -> bytes:
        return (json.dumps({
            "ts": _ts(rec.timestamp), "event": f"port_block_{rec.event}",
            "subscriber": rec.subscriber_id, "private_ip": rec.private_ip,
            "public_ip": rec.public_ip, "port_start": rec.port_start,
            "port_end": rec.port_end}, separators=(",", ":")) + "\n").encode()

    # -- flush + rotation (logging.go:376-414, :525-683) -----------------

    def flush(self) -> int:
        with self._lock:
            buf, self._buffer = self._buffer, []
            blocks, self._block_buffer = self._block_buffer, []
            if not buf and not blocks:
                return 0
            data = b"".join(self._format(r) for r in buf) + \
                b"".join(self._format_block(r) for r in blocks)
            self.stats["flushes"] += 1
            if self._fh is None:
                return len(buf) + len(blocks)
            self._fh.write(data)
            self._fh.flush()
            self._size += len(data)
            if self.config.max_file_size and \
                    self._size >= self.config.max_file_size:
                self._rotate_locked()
        return len(buf) + len(blocks)

    def _rotate_locked(self) -> None:
        self._fh.close()
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(self._clock()))
        rotated = f"{self.config.file_path}.{stamp}.{self.stats['rotations']}"
        os.rename(self.config.file_path, rotated)
        if self.config.compress:
            with open(rotated, "rb") as src, \
                    gzip.open(rotated + ".gz", "wb") as dst:
                dst.write(src.read())
            os.remove(rotated)
        self._fh = open(self.config.file_path, "ab")
        self._size = 0
        self.stats["rotations"] += 1

    def clean_old_logs(self) -> int:
        """Age-based retention sweep (logging.go:646-683)."""
        if not self.config.max_age or not self.config.file_path:
            return 0
        base = os.path.basename(self.config.file_path)
        d = os.path.dirname(self.config.file_path) or "."
        cutoff = self._clock() - self.config.max_age
        removed = 0
        for name in os.listdir(d):
            if not name.startswith(base + "."):
                continue
            path = os.path.join(d, name)
            if os.path.getmtime(path) < cutoff:
                os.remove(path)
                removed += 1
        return removed

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def get_stats(self) -> dict:
        with self._lock:
            return dict(self.stats, buffer_used=len(self._buffer),
                        block_buffer_used=len(self._block_buffer),
                        indexed=self._indexed,
                        format=self.config.fmt,
                        bulk_logging=self.config.bulk_logging)
