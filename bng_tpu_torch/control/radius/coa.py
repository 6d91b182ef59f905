"""CoA / Disconnect server (RFC 5176): dynamic authorization from RADIUS.

The port's copy of `bng_tpu/control/radius/coa.py` (jax-free).

Parity: pkg/radius/coa.go (CoAServer :119, request-authenticator verify
:486-502) + coa_handler.go (CoAProcessor :16-460: session lookup by
Acct-Session-Id / Framed-IP / Calling-Station-Id, policy update wired to
the QoS tables, disconnect wired to session teardown).
"""

from __future__ import annotations

import socket
import threading

from bng_tpu_torch.control.radius import packet as rp
from bng_tpu_torch.control.radius.packet import RadiusPacket


class CoAProcessor:
    """Applies CoA/Disconnect actions to live sessions.

    session_index: callables that resolve a session handle;
    qos_update(ip, policy_name) is the EBPFQoSUpdaterFunc role
    (coa_handler.go:175-460) — here it writes the device QoS tables.
    """

    def __init__(
        self,
        find_by_session_id=None,  # (sid) -> session | None
        find_by_ip=None,  # (ip_u32) -> session | None
        find_by_mac=None,  # (mac_str) -> session | None
        qos_update=None,  # (framed_ip_u32, policy_name) -> bool
        disconnect=None,  # (session) -> bool
        policy_manager=None,
    ):
        self.find_by_session_id = find_by_session_id
        self.find_by_ip = find_by_ip
        self.find_by_mac = find_by_mac
        self.qos_update = qos_update
        self.disconnect = disconnect
        self.policy_manager = policy_manager
        self.stats = {"coa_ack": 0, "coa_nak": 0, "disc_ack": 0, "disc_nak": 0}

    def _locate(self, req: RadiusPacket):
        sid = req.get_str(rp.ACCT_SESSION_ID)
        if sid and self.find_by_session_id:
            s = self.find_by_session_id(sid)
            if s is not None:
                return s
        ip = req.get_int(rp.FRAMED_IP_ADDRESS)
        if ip and self.find_by_ip:
            s = self.find_by_ip(ip)
            if s is not None:
                return s
        mac = req.get_str(rp.CALLING_STATION_ID)
        if mac and self.find_by_mac:
            return self.find_by_mac(mac)
        return None

    def process(self, req: RadiusPacket) -> RadiusPacket:
        session = self._locate(req)
        if req.code == rp.DISCONNECT_REQUEST:
            if session is not None and self.disconnect and self.disconnect(session):
                self.stats["disc_ack"] += 1
                return RadiusPacket(rp.DISCONNECT_ACK, req.id)
            self.stats["disc_nak"] += 1
            return RadiusPacket(rp.DISCONNECT_NAK, req.id)

        # CoA: policy change via Filter-Id
        if session is None:
            self.stats["coa_nak"] += 1
            return RadiusPacket(rp.COA_NAK, req.id)
        policy_name = req.get_str(rp.FILTER_ID) or ""
        ok = True
        if policy_name and self.qos_update:
            framed_ip = req.get_int(rp.FRAMED_IP_ADDRESS) or getattr(session, "ip", 0)
            if self.policy_manager and self.policy_manager.get(policy_name) is None:
                ok = False
            else:
                ok = self.qos_update(framed_ip, policy_name)
        if ok:
            self.stats["coa_ack"] += 1
            return RadiusPacket(rp.COA_ACK, req.id)
        self.stats["coa_nak"] += 1
        return RadiusPacket(rp.COA_NAK, req.id)


class CoAServer:
    """UDP listener for CoA/Disconnect (coa.go:119-240). handle_raw is
    also callable directly for tests (no socket needed)."""

    def __init__(self, secret: bytes, processor: CoAProcessor,
                 bind: tuple[str, int] = ("0.0.0.0", 3799)):
        self.secret = secret
        self.processor = processor
        self.bind = bind
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._running = False
        self.stats = {"bad_auth": 0, "bad_packet": 0, "handled": 0}

    def handle_raw(self, data: bytes) -> bytes | None:
        try:
            req = RadiusPacket.decode(data)
        except ValueError:
            self.stats["bad_packet"] += 1
            return None
        if req.code not in (rp.COA_REQUEST, rp.DISCONNECT_REQUEST):
            self.stats["bad_packet"] += 1
            return None
        if not req.verify_request(self.secret, data):
            self.stats["bad_auth"] += 1
            return None  # silently drop on bad authenticator (coa.go:495)
        resp = self.processor.process(req)
        self.stats["handled"] += 1
        return resp.encode(self.secret, request_auth=req.authenticator)

    # -- socket runtime --
    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(self.bind)
        self.addr = self._sock.getsockname()  # bind=port 0 -> real port
        self._sock.settimeout(0.5)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while self._running:
            try:
                data, addr = self._sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            resp = self.handle_raw(data)
            if resp is not None:
                self._sock.sendto(resp, addr)

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)
        if self._sock:
            self._sock.close()
