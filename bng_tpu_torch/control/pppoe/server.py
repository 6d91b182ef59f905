"""PPPoE access-concentrator server.

The port's copy of `bng_tpu/control/pppoe/server.py` (jax-free).

Parity: pkg/pppoe/server.go — receiveLoop dispatch (:263-301), discovery
handlers PADI->PADO / PADR->PADS / PADT (:303-464), session dispatch by
PPP protocol (:466-499), LCP->auth->IPCP progression (:531-852), and
keepalive.go's echo loop (:218-310).

Differences by design (TPU build): no raw socket — the server consumes
ethernet frames from the engine's PASS lanes and returns frames to
transmit; all timing is tick(now)-driven (no goroutines).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
from dataclasses import dataclass, field
from typing import Callable

from bng_tpu_torch.control.pppoe import codec
from bng_tpu_torch.control.pppoe.auth import (
    CHAP_RESPONSE,
    AuthResult,
    CHAPHandler,
    CredentialVerifier,
    PAPHandler,
    RateLimiter,
)
from bng_tpu_torch.control.pppoe.codec import (
    CODE_PADI,
    CODE_PADO,
    CODE_PADR,
    CODE_PADS,
    CODE_PADT,
    CODE_SESSION,
    CP_ECHO_REP,
    CP_ECHO_REQ,
    ETH_PPPOE_DISCOVERY,
    ETH_PPPOE_SESSION,
    PROTO_CHAP,
    PROTO_IPCP,
    PROTO_IPV6CP,
    PROTO_IPV4,
    PROTO_LCP,
    PROTO_PAP,
    CPPacket,
    PPPoEPacket,
    Tag,
    eth_frame,
    find_tag,
    parse_eth_vlan,
    parse_ppp,
    parse_tags,
    ppp_frame,
    serialize_tags,
)
from bng_tpu_torch.control.pppoe.ipcp import IPCP
from bng_tpu_torch.control.pppoe.ipv6cp import IPV6CP
from bng_tpu_torch.control.pppoe.lcp import LCP
from bng_tpu_torch.control.pppoe.session import (
    Phase,
    PPPoESession,
    SessionManager,
    TeardownEvent,
    TerminateCause,
)


@dataclass
class PPPoEServerConfig:
    ac_name: str = "bng-tpu"
    service_name: str = ""  # empty = accept any
    server_mac: bytes = b"\x02\xbb\x00\x00\x00\x01"
    our_ip: int = 0x0A000001  # 10.0.0.1, IPCP our side
    dns_primary: int = 0
    dns_secondary: int = 0
    auth_proto: int = PROTO_CHAP  # PROTO_PAP | PROTO_CHAP | 0
    max_sessions: int = 65535
    echo_interval_s: float = 30.0  # keepalive.go defaults
    echo_max_missed: int = 3
    idle_timeout_s: float = 0.0  # 0 = disabled
    session_timeout_s: float = 0.0
    # half-open sessions (PADR done but never reached OPEN) are reclaimed
    # after this long, else stuck LCP/AUTH floods exhaust the table
    setup_timeout_s: float = 60.0
    cookie_secret: bytes = field(default_factory=lambda: os.urandom(16))


@dataclass
class PPPoEStats:
    padi_rx: int = 0
    pado_tx: int = 0
    padr_rx: int = 0
    pads_tx: int = 0
    padt_rx: int = 0
    padt_tx: int = 0
    sessions_opened: int = 0
    sessions_closed: int = 0
    auth_success: int = 0
    auth_failure: int = 0
    data_frames: int = 0


class PPPoEServer:
    """Frames-in/frames-out PPPoE AC."""

    def __init__(self, config: PPPoEServerConfig, verifier: CredentialVerifier,
                 allocate_ip: Callable[[str, bytes], int | None],
                 release_ip: Callable[[int, bytes], None] | None = None,
                 on_open: Callable[[PPPoESession], None] | None = None,
                 on_close: Callable[[TeardownEvent], None] | None = None,
                 magic_source: Callable[[], int] | None = None,
                 challenge_source: Callable[[], bytes] | None = None):
        self.config = config
        self.sessions = SessionManager(config.max_sessions)
        self.stats = PPPoEStats()
        self.allocate_ip = allocate_ip
        self.release_ip = release_ip
        self.on_open = on_open
        self.on_close = on_close
        self._magic = magic_source or (
            lambda: int.from_bytes(os.urandom(4), "big"))
        limiter = RateLimiter()
        self.pap = PAPHandler(verifier, limiter=limiter)
        self.chap = CHAPHandler(verifier, ac_name=config.ac_name,
                                challenge_source=challenge_source,
                                limiter=limiter)
        self._limiter = limiter
        self._acct_counter = 0
        self._cur_vlans: list[int] = []

    # ---- frame entry point ----

    def handle_frame(self, frame: bytes, now: float) -> list[bytes]:
        try:
            dst, src, etype, payload, vlans = parse_eth_vlan(frame)
        except ValueError:
            return []
        # replies mirror the request's VLAN stack (single-threaded server;
        # _cur_vlans is valid for the duration of this frame)
        self._cur_vlans = vlans
        if etype == ETH_PPPOE_DISCOVERY:
            return self._handle_discovery(src, payload, now)
        if etype == ETH_PPPOE_SESSION:
            return self._handle_session(src, payload, now)
        return []

    # ---- discovery (server.go:303-464) ----

    def _cookie_for(self, mac: bytes) -> bytes:
        return hmac.new(self.config.cookie_secret, mac, hashlib.sha256).digest()[:16]

    def _discovery_reply(self, code: int, dst: bytes, session_id: int,
                         tags: list[Tag], vlans: list[int] | None = None) -> bytes:
        pkt = PPPoEPacket(code=code, session_id=session_id,
                          payload=serialize_tags(tags))
        return eth_frame(dst, self.config.server_mac, ETH_PPPOE_DISCOVERY,
                         pkt.encode(),
                         vlans=vlans if vlans is not None else self._cur_vlans)

    def _handle_discovery(self, src: bytes, payload: bytes, now: float
                          ) -> list[bytes]:
        try:
            pkt = PPPoEPacket.decode(payload)
            tags = parse_tags(pkt.payload)
        except ValueError:
            return []
        if pkt.code == CODE_PADI:
            self.stats.padi_rx += 1
            svc = find_tag(tags, codec.TAG_SERVICE_NAME)
            if (self.config.service_name and svc and svc.value
                    and svc.value.decode("utf-8", "replace") != self.config.service_name):
                err = [Tag(codec.TAG_SERVICE_NAME_ERR,
                           b"service not offered")]
                return [self._discovery_reply(CODE_PADO, src, 0, err)]
            out = [Tag(codec.TAG_AC_NAME, self.config.ac_name.encode()),
                   Tag(codec.TAG_SERVICE_NAME, svc.value if svc else b""),
                   Tag(codec.TAG_AC_COOKIE, self._cookie_for(src))]
            hu = find_tag(tags, codec.TAG_HOST_UNIQ)
            if hu:
                out.append(hu)
            self.stats.pado_tx += 1
            return [self._discovery_reply(CODE_PADO, src, 0, out)]
        if pkt.code == CODE_PADR:
            self.stats.padr_rx += 1
            cookie = find_tag(tags, codec.TAG_AC_COOKIE)
            if cookie is None or not hmac.compare_digest(
                    cookie.value, self._cookie_for(src)):
                err = [Tag(codec.TAG_GENERIC_ERR, b"bad AC-Cookie")]
                return [self._discovery_reply(CODE_PADS, src, 0, err)]
            # re-dial from a MAC with a live session: tear the old one
            # down properly (IP release + accounting stop) before replacing
            old = self.sessions.by_mac(src)
            if old is not None:
                self._close_session(old, TerminateCause.LOST_CARRIER, now,
                                    send_padt=False)
            sess = self.sessions.allocate(src, now)
            if sess is None:
                err = [Tag(codec.TAG_AC_SYSTEM_ERR, b"session table full")]
                return [self._discovery_reply(CODE_PADS, src, 0, err)]
            self._acct_counter += 1
            sess.acct_session_id = f"pppoe-{sess.session_id:04x}-{self._acct_counter}"
            sess.lcp = LCP(magic=self._magic(), auth_proto=self.config.auth_proto)
            sess.phase = Phase.LCP
            sess.vlans = list(self._cur_vlans)
            out = [Tag(codec.TAG_AC_NAME, self.config.ac_name.encode()),
                   Tag(codec.TAG_SERVICE_NAME, b"")]
            hu = find_tag(tags, codec.TAG_HOST_UNIQ)
            if hu:
                out.append(hu)
            self.stats.pads_tx += 1
            frames = [self._discovery_reply(CODE_PADS, src, sess.session_id, out)]
            sess.lcp.open(now)
            frames += self._drain_cp(sess, sess.lcp)
            return frames
        if pkt.code == CODE_PADT:
            self.stats.padt_rx += 1
            sess = self.sessions.get(pkt.session_id)
            if sess is not None and sess.client_mac == src:
                self._close_session(sess, TerminateCause.USER_REQUEST, now,
                                    send_padt=False)
            return []
        return []

    # ---- session phase (server.go:466-852) ----

    def _session_frame(self, sess: PPPoESession, proto: int, body: bytes) -> bytes:
        pkt = PPPoEPacket(code=CODE_SESSION, session_id=sess.session_id,
                          payload=ppp_frame(proto, body))
        return eth_frame(sess.client_mac, self.config.server_mac,
                         ETH_PPPOE_SESSION, pkt.encode(), vlans=sess.vlans)

    def _drain_cp(self, sess: PPPoESession, fsm) -> list[bytes]:
        frames = []
        while fsm.out:
            cp = fsm.out.pop(0)
            frames.append(self._session_frame(sess, fsm.proto, cp.encode()))
        return frames

    def _handle_session(self, src: bytes, payload: bytes, now: float
                        ) -> list[bytes]:
        try:
            pkt = PPPoEPacket.decode(payload)
        except ValueError:
            return []
        if pkt.code != CODE_SESSION:
            return []
        sess = self.sessions.get(pkt.session_id)
        if sess is None or sess.client_mac != src:
            # unknown session: PADT (server.go behavior for stale sessions)
            self.stats.padt_tx += 1
            return [self._discovery_reply(CODE_PADT, src, pkt.session_id,
                                          [Tag(codec.TAG_GENERIC_ERR,
                                               b"unknown session")])]
        try:
            proto, body = parse_ppp(pkt.payload)
        except ValueError:
            return []
        sess.touch(now)
        if proto == PROTO_LCP:
            return self._handle_lcp(sess, body, now)
        if proto == PROTO_PAP and sess.phase == Phase.AUTH:
            return self._handle_pap(sess, body, now)
        if proto == PROTO_CHAP and sess.phase == Phase.AUTH:
            return self._handle_chap(sess, body, now)
        if proto == PROTO_IPCP and sess.ipcp is not None:
            try:
                cp = CPPacket.decode(body)
            except ValueError:
                return []
            sess.ipcp.handle(cp, now)
            return self._drain_cp(sess, sess.ipcp)
        if proto == PROTO_IPV6CP and sess.ipv6cp is not None:
            try:
                cp = CPPacket.decode(body)
            except ValueError:
                return []
            sess.ipv6cp.handle(cp, now)
            return self._drain_cp(sess, sess.ipv6cp)
        if proto in (PROTO_IPV4, codec.PROTO_IPV6):
            self.stats.data_frames += 1
            return []  # data path is the device pipeline's job
        # Protocol-Reject (RFC 1661 §5.7)
        if sess.lcp is not None and sess.lcp.state == "opened":
            rej = CPPacket(codec.CP_PROTO_REJ, 0,
                           data=struct.pack(">H", proto) + body[:64])
            return [self._session_frame(sess, PROTO_LCP, rej.encode())]
        return []

    def _handle_lcp(self, sess: PPPoESession, body: bytes, now: float
                    ) -> list[bytes]:
        if sess.lcp is None:
            return []
        try:
            cp = CPPacket.decode(body)
        except ValueError:
            return []
        if cp.code == CP_ECHO_REP:
            sess.echo_pending = 0
            return []
        was_open = sess.lcp.state == "opened"
        sess.lcp.handle(cp, now)
        frames = self._drain_cp(sess, sess.lcp)
        if sess.lcp.state == "opened" and not was_open:
            frames += self._start_auth(sess, now)
        elif was_open and sess.lcp.state == "closed":
            self._close_session(sess, TerminateCause.USER_REQUEST, now,
                                send_padt=True)
        return frames

    def _start_auth(self, sess: PPPoESession, now: float) -> list[bytes]:
        auth = sess.lcp.auth_proto if sess.lcp else 0
        if auth == 0:
            return self._start_network(sess, "", AuthResult(ok=True), now)
        sess.phase = Phase.AUTH
        if auth == PROTO_CHAP:
            sess.chap_ident = (sess.chap_ident + 1) & 0xFF or 1
            sess.chap_challenge, pkt = self.chap.make_challenge(sess.chap_ident)
            return [self._session_frame(sess, PROTO_CHAP, pkt)]
        return []  # PAP: wait for the client's Auth-Request

    def _auth_done(self, sess: PPPoESession, res: AuthResult, now: float
                   ) -> list[bytes]:
        if not res.ok:
            self.stats.auth_failure += 1
            return self._terminate_frames(sess, TerminateCause.USER_ERROR, now)
        self.stats.auth_success += 1
        # a successful auth clears the attempt budget so legitimately
        # flapping clients are not locked out (limiter counts failures)
        self._limiter.reset(sess.client_mac.hex())
        return self._start_network(sess, res.username, res, now)

    def _handle_pap(self, sess: PPPoESession, body: bytes, now: float
                    ) -> list[bytes]:
        key = sess.client_mac.hex()
        reply, res = self.pap.handle(body, key, now)
        if reply is None:
            return []  # malformed frame: ignore, client will retransmit
        return [self._session_frame(sess, PROTO_PAP, reply)] + \
            self._auth_done(sess, res, now)

    def _handle_chap(self, sess: PPPoESession, body: bytes, now: float
                     ) -> list[bytes]:
        if len(body) >= 1 and body[0] != CHAP_RESPONSE:
            return []
        key = sess.client_mac.hex()
        reply, res = self.chap.handle_response(body, sess.chap_challenge,
                                               key, now)
        if reply is None:
            return []  # malformed frame: ignore, client will retransmit
        return [self._session_frame(sess, PROTO_CHAP, reply)] + \
            self._auth_done(sess, res, now)

    def _start_network(self, sess: PPPoESession, username: str,
                       res: AuthResult, now: float) -> list[bytes]:
        ip = res.attributes.get("framed_ip") or self.allocate_ip(
            username, sess.client_mac)
        if ip is None:
            return self._terminate_frames(sess, TerminateCause.SERVICE_UNAVAILABLE,
                                          now)
        sess.username = username
        sess.assigned_ip = ip
        sess.radius_attributes = res.attributes
        sess.phase = Phase.NETWORK

        def opened():
            if sess.phase != Phase.OPEN:
                sess.phase = Phase.OPEN
                self.stats.sessions_opened += 1
                if self.on_open:
                    self.on_open(sess)

        sess.ipcp = IPCP(our_ip=self.config.our_ip, client_ip=ip,
                         dns_primary=self.config.dns_primary,
                         dns_secondary=self.config.dns_secondary,
                         on_open=opened)
        # IID from MACs (EUI-64-ish, locally administered)
        sess.ipv6cp = IPV6CP(
            our_iid=self.config.server_mac[:3] + b"\xff\xfe" + self.config.server_mac[3:],
            client_iid=sess.client_mac[:3] + b"\xff\xfe" + sess.client_mac[3:])
        sess.ipcp.open(now)
        sess.ipv6cp.open(now)
        return self._drain_cp(sess, sess.ipcp) + self._drain_cp(sess, sess.ipv6cp)

    # ---- teardown (teardown.go) ----

    def _terminate_frames(self, sess: PPPoESession, cause: TerminateCause,
                          now: float) -> list[bytes]:
        frames = []
        if sess.lcp is not None and sess.lcp.state == "opened":
            sess.lcp.close(now)
            frames += self._drain_cp(sess, sess.lcp)
        frames += self._close_session(sess, cause, now, send_padt=True)
        return frames

    def _close_session(self, sess: PPPoESession, cause: TerminateCause,
                       now: float, send_padt: bool) -> list[bytes]:
        frames: list[bytes] = []
        if send_padt:
            self.stats.padt_tx += 1
            frames.append(self._discovery_reply(
                CODE_PADT, sess.client_mac, sess.session_id, []))
        removed = self.sessions.remove(sess.session_id)
        if removed is None:
            return frames
        was_open = sess.phase == Phase.OPEN
        sess.terminate_cause = cause
        sess.phase = Phase.CLOSED
        self.stats.sessions_closed += 1
        if sess.assigned_ip and self.release_ip:
            self.release_ip(sess.assigned_ip, sess.client_mac)
        if self.on_close and was_open:
            # accounting/teardown hooks only for sessions that opened:
            # half-open reclaims have no accounting session to stop
            self.on_close(TeardownEvent(session=sess, cause=cause, at=now))
        return frames

    def terminate(self, session_id: int, cause: TerminateCause, now: float
                  ) -> list[bytes]:
        """Admin/NAS-initiated teardown (CoA Disconnect path)."""
        sess = self.sessions.get(session_id)
        if sess is None:
            return []
        return self._terminate_frames(sess, cause, now)

    # ---- tick: keepalive + timeouts (keepalive.go:218-310) ----

    def tick(self, now: float) -> list[bytes]:
        frames: list[bytes] = []
        for sess in self.sessions.all():
            for fsm in (sess.lcp, sess.ipcp, sess.ipv6cp):
                if fsm is not None:
                    fsm.tick(now)
                    frames += self._drain_cp(sess, fsm)
            # reclaim half-open sessions: PADR done but LCP/AUTH/IPCP never
            # completed (or LCP retried out into CLOSED). Without this, a
            # PADI/PADR flood from distinct MACs pins the session table.
            if sess.phase != Phase.OPEN:
                lcp_dead = sess.lcp is not None and sess.lcp.state == "closed" \
                    and sess.phase in (Phase.LCP, Phase.AUTH)
                if lcp_dead or (self.config.setup_timeout_s and
                                now - sess.created_at >= self.config.setup_timeout_s):
                    frames += self._close_session(
                        sess, TerminateCause.LOST_SERVICE, now, send_padt=True)
                continue
            if sess.phase == Phase.OPEN and sess.lcp is not None:
                cfg = self.config
                if cfg.session_timeout_s and \
                        now - sess.created_at >= cfg.session_timeout_s:
                    frames += self._terminate_frames(
                        sess, TerminateCause.SESSION_TIMEOUT, now)
                    continue
                if cfg.idle_timeout_s and \
                        now - sess.last_activity >= cfg.idle_timeout_s:
                    frames += self._terminate_frames(
                        sess, TerminateCause.IDLE_TIMEOUT, now)
                    continue
                if now - sess.last_echo_tx >= cfg.echo_interval_s:
                    if sess.echo_pending >= cfg.echo_max_missed:
                        frames += self._terminate_frames(
                            sess, TerminateCause.LOST_CARRIER, now)
                        continue
                    sess.echo_ident = (sess.echo_ident + 1) & 0xFF
                    sess.echo_pending += 1
                    sess.last_echo_tx = now
                    echo = CPPacket(CP_ECHO_REQ, sess.echo_ident,
                                    data=struct.pack(">I", sess.lcp.magic))
                    frames.append(self._session_frame(sess, PROTO_LCP,
                                                      echo.encode()))
        return frames
