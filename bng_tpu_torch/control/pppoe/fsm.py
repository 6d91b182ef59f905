"""Generic PPP option-negotiation state machine (RFC 1661 §4 subset).

The port's copy of `bng_tpu/control/pppoe/fsm.py` (jax-free).

Parity: the shared shape of pkg/pppoe/lcp.go:104 / ipcp.go:92 /
ipv6cp.go:90 — each is the same Configure-Request/Ack/Nak/Reject machine
with protocol-specific option handling. Here that common machine is one
class; LCP/IPCP/IPV6CP subclass it with option policy only.

States (subset of RFC 1661 §4.2 sufficient for a server): CLOSED,
REQ_SENT, ACK_RCVD, ACK_SENT, OPENED, CLOSING. Tick-driven retransmit
with max-configure retry budget (RFC 1661 §4.6 counters).
"""

from __future__ import annotations

from typing import Callable

from bng_tpu_torch.control.pppoe.codec import (
    CP_CODE_REJ,
    CP_CONF_ACK,
    CP_CONF_NAK,
    CP_CONF_REJ,
    CP_CONF_REQ,
    CP_DISCARD_REQ,
    CP_ECHO_REP,
    CP_ECHO_REQ,
    CP_TERM_ACK,
    CP_TERM_REQ,
    CPOption,
    CPPacket,
)

CLOSED = "closed"
REQ_SENT = "req-sent"
ACK_RCVD = "ack-rcvd"
ACK_SENT = "ack-sent"
OPENED = "opened"
CLOSING = "closing"

DEFAULT_RESTART_INTERVAL = 3.0  # RFC 1661 §4.6 Restart timer
DEFAULT_MAX_CONFIGURE = 10  # Max-Configure
DEFAULT_MAX_TERMINATE = 2  # Max-Terminate


class OptionFSM:
    """One PPP control protocol instance for one session.

    Outgoing packets are appended to `self.out` as CPPacket; the session
    layer wraps them in PPP/PPPoE/Ethernet and transmits.
    """

    proto: int = 0  # overridden: PPP protocol number
    name: str = "cp"

    def __init__(self, on_open: Callable[[], None] | None = None,
                 on_close: Callable[[], None] | None = None):
        self.state = CLOSED
        self.out: list[CPPacket] = []
        self.on_open = on_open
        self.on_close = on_close
        self._ident = 0
        self._req_ident = 0
        self._retries = 0
        self._next_resend = 0.0
        self.restart_interval = DEFAULT_RESTART_INTERVAL
        self.max_configure = DEFAULT_MAX_CONFIGURE

    # ---- option policy, overridden per protocol ----

    def own_options(self) -> list[CPOption]:
        """Options for our Configure-Request."""
        return []

    def check_peer_options(self, opts: list[CPOption]) -> tuple[
            list[CPOption], list[CPOption], list[CPOption]]:
        """Split the peer's Configure-Request into (ack, nak, reject)."""
        return opts, [], []

    def peer_acked(self, opts: list[CPOption]) -> None:
        """Peer Configure-Ack'd our request."""

    def peer_naked(self, opts: list[CPOption]) -> None:
        """Peer Configure-Nak'd: adjust our options before resend."""

    def peer_rejected(self, opts: list[CPOption]) -> None:
        """Peer Configure-Reject'd: drop those options before resend."""

    # ---- machine ----

    def _next_ident(self) -> int:
        self._ident = (self._ident + 1) & 0xFF
        return self._ident

    def _send_conf_req(self, now: float) -> None:
        self._req_ident = self._next_ident()
        self.out.append(CPPacket(CP_CONF_REQ, self._req_ident,
                                 options=self.own_options()))
        self._retries += 1
        self._next_resend = now + self.restart_interval

    def open(self, now: float) -> None:
        """Lower layer is up and we want the protocol open (This-Layer-Start)."""
        if self.state in (CLOSED, CLOSING):
            self._retries = 0
            self._send_conf_req(now)
            self.state = REQ_SENT

    def close(self, now: float, send_term: bool = True) -> None:
        if self.state == OPENED and send_term:
            self.out.append(CPPacket(CP_TERM_REQ, self._next_ident()))
            self.state = CLOSING
            self._next_resend = now + self.restart_interval
            self._retries = 0
        else:
            self._to_closed()

    def _to_closed(self) -> None:
        was_open = self.state == OPENED
        self.state = CLOSED
        if was_open and self.on_close:
            self.on_close()

    def _this_layer_up(self) -> None:
        self.state = OPENED
        if self.on_open:
            self.on_open()

    def tick(self, now: float) -> None:
        """Retransmit timers (RFC 1661 §4.6)."""
        if self.state in (REQ_SENT, ACK_RCVD, ACK_SENT) and now >= self._next_resend:
            if self._retries >= self.max_configure:
                self._to_closed()
            else:
                self._send_conf_req(now)
                if self.state == ACK_RCVD:
                    self.state = REQ_SENT  # ack applies to the old request
        elif self.state == CLOSING and now >= self._next_resend:
            if self._retries >= DEFAULT_MAX_TERMINATE:
                self._to_closed()
            else:
                self.out.append(CPPacket(CP_TERM_REQ, self._next_ident()))
                self._retries += 1
                self._next_resend = now + self.restart_interval

    def handle(self, pkt: CPPacket, now: float) -> None:
        code = pkt.code
        if code == CP_CONF_REQ:
            self._rcv_conf_req(pkt, now)
        elif code == CP_CONF_ACK:
            if pkt.identifier != self._req_ident:
                return  # stale ack
            self.peer_acked(pkt.options)
            if self.state == REQ_SENT:
                self.state = ACK_RCVD
            elif self.state == ACK_SENT:
                self._this_layer_up()
        elif code in (CP_CONF_NAK, CP_CONF_REJ):
            if pkt.identifier != self._req_ident:
                return
            if code == CP_CONF_NAK:
                self.peer_naked(pkt.options)
            else:
                self.peer_rejected(pkt.options)
            if self.state in (REQ_SENT, ACK_RCVD, ACK_SENT):
                self._send_conf_req(now)
                if self.state == ACK_RCVD:
                    self.state = REQ_SENT
        elif code == CP_TERM_REQ:
            self.out.append(CPPacket(CP_TERM_ACK, pkt.identifier))
            self._to_closed()
        elif code == CP_TERM_ACK:
            if self.state == CLOSING:
                self._to_closed()
        elif code == CP_ECHO_REQ:
            if self.state == OPENED:
                # magic number in data[:4] is ours in the reply
                self.out.append(CPPacket(CP_ECHO_REP, pkt.identifier,
                                         data=pkt.data))
        elif code in (CP_ECHO_REP, CP_DISCARD_REQ, CP_CODE_REJ):
            pass  # echo replies handled by keepalive layer; others ignored
        else:
            self.out.append(CPPacket(CP_CODE_REJ, self._next_ident(),
                                     data=pkt.encode()[:64]))

    def _rcv_conf_req(self, pkt: CPPacket, now: float) -> None:
        ack, nak, rej = self.check_peer_options(pkt.options)
        if rej:
            self.out.append(CPPacket(CP_CONF_REJ, pkt.identifier, options=rej))
            return
        if nak:
            self.out.append(CPPacket(CP_CONF_NAK, pkt.identifier, options=nak))
            return
        self.out.append(CPPacket(CP_CONF_ACK, pkt.identifier, options=ack))
        if self.state == CLOSED:
            # peer raced ahead of our open(); start our side too
            self._retries = 0
            self._send_conf_req(now)
            self.state = ACK_SENT
        elif self.state == REQ_SENT:
            self.state = ACK_SENT
        elif self.state == ACK_RCVD:
            self._this_layer_up()
        # ACK_SENT/OPENED: re-ack is fine
