"""RADIUS client: auth + accounting with multi-server failover.

The port's copy of `bng_tpu/control/radius/client.py` (jax-free).

Parity: pkg/radius/client.go — Client.Authenticate (:157), SendAccounting
(:250), per-server failover and rate limiting, Message-Authenticator
signing (:405). Transport is injectable (tests use an in-memory server;
production uses UDP sockets) — the reference's testability pattern.
"""

from __future__ import annotations

import socket
import time
from dataclasses import dataclass, field

from bng_tpu_torch.control.radius import packet as rp
from bng_tpu_torch.control.radius.packet import RadiusPacket


@dataclass
class RadiusServerConfig:
    host: str
    auth_port: int = 1812
    acct_port: int = 1813
    secret: bytes = b""
    timeout_s: float = 3.0  # parity: cmd/bng/main.go:226 (3s)
    retries: int = 3  # parity: main.go:227


@dataclass
class AuthResult:
    success: bool
    framed_ip: int = 0
    session_timeout: int = 0
    idle_timeout: int = 0
    filter_id: str = ""
    policy_name: str = ""
    reply_message: str = ""
    radius_class: bytes = b""
    attributes: dict = field(default_factory=dict)


class _UDPTransport:
    def __call__(self, data: bytes, host: str, port: int, timeout: float) -> bytes | None:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.settimeout(timeout)
            s.sendto(data, (host, port))
            resp, _ = s.recvfrom(4096)
            return resp
        except (socket.timeout, OSError):
            return None
        finally:
            s.close()


class RadiusClient:
    def __init__(
        self,
        servers: list[RadiusServerConfig],
        nas_identifier: str = "bng-tpu",
        nas_ip: int = 0,
        transport=None,  # (data, host, port, timeout) -> bytes | None
        max_requests_per_second: float = 0.0,
        clock=time.time,
    ):
        if not servers:
            raise ValueError("need at least one RADIUS server")
        self.servers = servers
        self.nas_identifier = nas_identifier
        self.nas_ip = nas_ip
        self.transport = transport or _UDPTransport()
        self.clock = clock
        self._id = 0
        self._rate = max_requests_per_second
        self._last_req = 0.0
        self.stats = {"auth_ok": 0, "auth_reject": 0, "auth_timeout": 0,
                      "acct_ok": 0, "acct_timeout": 0, "failovers": 0,
                      "rate_limited": 0}

    def _next_id(self) -> int:
        self._id = (self._id + 1) & 0xFF
        return self._id

    def _rate_limit(self) -> bool:
        """Token-ish limiter (parity: client.go per-server rate limiting)."""
        if self._rate <= 0:
            return True
        now = self.clock()
        if now - self._last_req < 1.0 / self._rate:
            self.stats["rate_limited"] += 1
            return False
        self._last_req = now
        return True

    def _exchange(self, pkt: RadiusPacket, port_of,
                  password: bytes | None = None) -> tuple[RadiusPacket, RadiusServerConfig] | None:
        """Send with per-server retry then failover (client.go:157-248).

        `password` is the plaintext PAP password: User-Password ciphering
        is per-secret (RFC 2865 §5.2), so it must be re-encrypted for
        each failover server rather than reusing servers[0]'s cipher.
        """
        for si, srv in enumerate(self.servers):
            if password is not None:
                pkt.attributes = [(t, v) for (t, v) in pkt.attributes
                                  if t != rp.USER_PASSWORD]
                pkt.add(rp.USER_PASSWORD,
                        rp.encrypt_password(password, srv.secret,
                                            pkt.authenticator))
            raw = pkt.encode(srv.secret, sign_message_authenticator=(pkt.code == rp.ACCESS_REQUEST))
            for _ in range(srv.retries):
                resp_raw = self.transport(raw, srv.host, port_of(srv), srv.timeout_s)
                if resp_raw is None:
                    continue
                try:
                    resp = RadiusPacket.decode(resp_raw)
                except ValueError:
                    continue
                if resp.id != pkt.id:
                    continue
                if not resp.verify_response(srv.secret, pkt.authenticator, resp_raw):
                    continue
                return resp, srv
            if si + 1 < len(self.servers):
                self.stats["failovers"] += 1
        return None

    def _auth_result(self, resp: RadiusPacket) -> AuthResult:
        """Access-Accept/Reject -> AuthResult (+ ok/reject stats) —
        shared by the PAP and CHAP request paths."""
        if resp.code == rp.ACCESS_ACCEPT:
            self.stats["auth_ok"] += 1
            return AuthResult(
                success=True,
                framed_ip=resp.get_int(rp.FRAMED_IP_ADDRESS) or 0,
                session_timeout=resp.get_int(rp.SESSION_TIMEOUT) or 0,
                idle_timeout=resp.get_int(rp.IDLE_TIMEOUT) or 0,
                filter_id=resp.get_str(rp.FILTER_ID) or "",
                policy_name=resp.get_str(rp.FILTER_ID) or "",
                reply_message=resp.get_str(rp.REPLY_MESSAGE) or "",
                radius_class=resp.get(rp.CLASS) or b"",
            )
        self.stats["auth_reject"] += 1
        return AuthResult(success=False,
                          reply_message=resp.get_str(rp.REPLY_MESSAGE) or "")

    # ------------------------------------------------------------------
    def authenticate(self, username: str, password: str | bytes = "",
                     mac: bytes = b"", circuit_id: bytes = b"",
                     nas_port: int = 0) -> AuthResult | None:
        """PAP Access-Request. None = timeout everywhere (parity: the
        degraded-auth trigger for resilience.RADIUSHandler). password
        accepts raw bytes: PAP passwords are arbitrary octets (RFC 1334)
        and must not round-trip through text."""
        if not self._rate_limit():
            return None
        pkt = RadiusPacket(rp.ACCESS_REQUEST, self._next_id(),
                           rp.new_request_authenticator())
        pkt.add(rp.USER_NAME, username)
        pkt.add(rp.NAS_IDENTIFIER, self.nas_identifier)
        if self.nas_ip:
            pkt.add(rp.NAS_IP_ADDRESS, self.nas_ip)
        if nas_port:
            pkt.add(rp.NAS_PORT, nas_port)
        if mac:
            pkt.add(rp.CALLING_STATION_ID, "-".join(f"{b:02X}" for b in mac))
        if circuit_id:
            pkt.add(rp.CALLED_STATION_ID, circuit_id)

        pw = password if isinstance(password, bytes) else password.encode()
        got = self._exchange(pkt, lambda s: s.auth_port, password=pw)
        if got is None:
            self.stats["auth_timeout"] += 1
            return None
        resp, _ = got
        return self._auth_result(resp)

    def authenticate_chap(self, username: str, ident: int, challenge: bytes,
                          response: bytes, mac: bytes = b"") -> AuthResult | None:
        """CHAP Access-Request (RFC 2865 §2.2): CHAP-Password carries the
        ident + the client's MD5 response; CHAP-Challenge carries the
        challenge the AC sent. The PPPoE CHAP handler delegates here
        when RADIUS is the credential backend (auth.go's radius mode).
        None = timeout everywhere (degraded-auth trigger, like PAP)."""
        if not self._rate_limit():
            return None
        pkt = RadiusPacket(rp.ACCESS_REQUEST, self._next_id(),
                           rp.new_request_authenticator())
        pkt.add(rp.USER_NAME, username)
        pkt.add(rp.NAS_IDENTIFIER, self.nas_identifier)
        if self.nas_ip:
            pkt.add(rp.NAS_IP_ADDRESS, self.nas_ip)
        if mac:
            pkt.add(rp.CALLING_STATION_ID, "-".join(f"{b:02X}" for b in mac))
        pkt.add(rp.CHAP_PASSWORD, bytes([ident & 0xFF]) + response)
        pkt.add(rp.CHAP_CHALLENGE, challenge)

        got = self._exchange(pkt, lambda s: s.auth_port)
        if got is None:
            self.stats["auth_timeout"] += 1
            return None
        resp, _ = got
        return self._auth_result(resp)

    def send_accounting(self, session_id: str, status: int, username: str = "",
                        framed_ip: int = 0, input_octets: int = 0,
                        output_octets: int = 0, input_packets: int = 0,
                        output_packets: int = 0, session_time: int = 0,
                        terminate_cause: int = 0, mac: bytes = b"") -> bool:
        """Accounting-Request (client.go:250-340)."""
        pkt = RadiusPacket(rp.ACCOUNTING_REQUEST, self._next_id())
        pkt.add(rp.ACCT_STATUS_TYPE, status)
        pkt.add(rp.ACCT_SESSION_ID, session_id)
        if username:
            pkt.add(rp.USER_NAME, username)
        pkt.add(rp.NAS_IDENTIFIER, self.nas_identifier)
        if framed_ip:
            pkt.add(rp.FRAMED_IP_ADDRESS, framed_ip)
        if mac:
            pkt.add(rp.CALLING_STATION_ID, "-".join(f"{b:02X}" for b in mac))
        if input_octets:
            pkt.add(rp.ACCT_INPUT_OCTETS, input_octets & 0xFFFFFFFF)
        if output_octets:
            pkt.add(rp.ACCT_OUTPUT_OCTETS, output_octets & 0xFFFFFFFF)
        if input_packets:
            pkt.add(rp.ACCT_INPUT_PACKETS, input_packets & 0xFFFFFFFF)
        if output_packets:
            pkt.add(rp.ACCT_OUTPUT_PACKETS, output_packets & 0xFFFFFFFF)
        if session_time:
            pkt.add(rp.ACCT_SESSION_TIME, session_time)
        if terminate_cause:
            pkt.add(rp.ACCT_TERMINATE_CAUSE, terminate_cause)
        pkt.add(rp.EVENT_TIMESTAMP, int(self.clock()))

        got = self._exchange(pkt, lambda s: s.acct_port)
        if got is None:
            self.stats["acct_timeout"] += 1
            return False
        resp, _ = got
        ok = resp.code == rp.ACCOUNTING_RESPONSE
        if ok:
            self.stats["acct_ok"] += 1
        return ok
