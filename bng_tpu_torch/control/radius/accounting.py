"""Accounting manager: session records, interim updates, crash recovery.

The port's copy of `bng_tpu/control/radius/accounting.py` (jax-free).

Parity: pkg/radius/accounting.go — AccountingManager (:19), interim loop
(:410-497), pending-record disk persistence + recoverOrphanedSessions
(:729-877). Loops are explicit tick() methods (the engine/operator calls
them); persistence is JSON lines in a spool file.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field

from bng_tpu_torch.control.radius import packet as rp


@dataclass
class AcctSession:
    session_id: str
    username: str
    framed_ip: int
    mac: str
    start_time: float
    last_interim: float = 0.0
    input_octets: int = 0
    output_octets: int = 0
    input_packets: int = 0
    output_packets: int = 0


@dataclass
class PendingRecord:
    session_id: str
    status: int
    payload: dict
    attempts: int = 0
    queued_at: float = 0.0


class AccountingManager:
    def __init__(
        self,
        client,  # RadiusClient
        interim_interval_s: int = 300,
        spool_path: str | None = None,
        max_retries: int = 10,
        clock=time.time,
    ):
        self.client = client
        self.interim_interval_s = interim_interval_s
        self.spool_path = spool_path
        self.max_retries = max_retries
        self.clock = clock
        self.sessions: dict[str, AcctSession] = {}
        self.pending: list[PendingRecord] = []
        if spool_path and os.path.exists(spool_path):
            self._recover()

    # -- session lifecycle --
    def start(self, session_id: str, username: str, framed_ip: int, mac: str = "") -> bool:
        s = AcctSession(session_id, username, framed_ip, mac, self.clock())
        self.sessions[session_id] = s
        ok = self.client.send_accounting(session_id, rp.ACCT_START,
                                         username=username, framed_ip=framed_ip)
        if not ok:
            self._queue(session_id, rp.ACCT_START, {"username": username, "framed_ip": framed_ip})
        self._persist()
        return ok

    def update_counters(self, session_id: str, input_octets: int, output_octets: int,
                        input_packets: int = 0, output_packets: int = 0) -> None:
        s = self.sessions.get(session_id)
        if s:
            s.input_octets = input_octets
            s.output_octets = output_octets
            s.input_packets = input_packets
            s.output_packets = output_packets

    def stop(self, session_id: str, terminate_cause: int = rp.TERM_USER_REQUEST) -> bool:
        s = self.sessions.pop(session_id, None)
        if s is None:
            return False
        now = self.clock()
        ok = self.client.send_accounting(
            session_id, rp.ACCT_STOP, username=s.username, framed_ip=s.framed_ip,
            input_octets=s.input_octets, output_octets=s.output_octets,
            input_packets=s.input_packets, output_packets=s.output_packets,
            session_time=int(now - s.start_time), terminate_cause=terminate_cause,
        )
        if not ok:
            self._queue(session_id, rp.ACCT_STOP, {
                "username": s.username, "framed_ip": s.framed_ip,
                "input_octets": s.input_octets, "output_octets": s.output_octets,
                "session_time": int(now - s.start_time),
                "terminate_cause": terminate_cause,
            })
        self._persist()
        return ok

    # -- ticks (the reference's goroutine loops, accounting.go:410-497) --
    def interim_tick(self, now: float | None = None) -> int:
        """Send interim updates for sessions past the interval."""
        now = now if now is not None else self.clock()
        sent = 0
        for s in self.sessions.values():
            due = max(s.last_interim, s.start_time) + self.interim_interval_s
            if now < due:
                continue
            ok = self.client.send_accounting(
                s.session_id, rp.ACCT_INTERIM, username=s.username,
                framed_ip=s.framed_ip, input_octets=s.input_octets,
                output_octets=s.output_octets,
                session_time=int(now - s.start_time),
            )
            if ok:
                s.last_interim = now
                sent += 1
        return sent

    def retry_tick(self) -> int:
        """Retry queued records; drop after max_retries (accounting.go:500+)."""
        kept, sent = [], 0
        for rec in self.pending:
            ok = self.client.send_accounting(rec.session_id, rec.status, **{
                k: v for k, v in rec.payload.items()
                if k in ("username", "framed_ip", "input_octets", "output_octets",
                         "session_time", "terminate_cause")
            })
            if ok:
                sent += 1
                continue
            rec.attempts += 1
            if rec.attempts < self.max_retries:
                kept.append(rec)
        self.pending = kept
        self._persist()
        return sent

    # -- persistence / orphan recovery (accounting.go:729-877) --
    def _queue(self, session_id: str, status: int, payload: dict) -> None:
        self.pending.append(PendingRecord(session_id, status, payload,
                                          queued_at=self.clock()))

    def _persist(self) -> None:
        if not self.spool_path:
            return
        tmp = self.spool_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "sessions": {k: asdict(v) for k, v in self.sessions.items()},
                "pending": [asdict(p) for p in self.pending],
            }, f)
        os.replace(tmp, self.spool_path)

    def _recover(self) -> None:
        """Reload sessions + pending from disk. Live sessions found on disk
        at startup are orphans: a crash interrupted them — close them out
        with Acct-Stop(Lost-Carrier) like recoverOrphanedSessions."""
        try:
            with open(self.spool_path) as f:
                d = json.load(f)
        except (json.JSONDecodeError, OSError):
            return
        self.pending = [PendingRecord(**p) for p in d.get("pending", [])]
        for sid, sd in d.get("sessions", {}).items():
            s = AcctSession(**sd)
            self._queue(sid, rp.ACCT_STOP, {
                "username": s.username, "framed_ip": s.framed_ip,
                "input_octets": s.input_octets, "output_octets": s.output_octets,
                "session_time": int(self.clock() - s.start_time),
                "terminate_cause": rp.TERM_LOST_CARRIER,
            })
