"""LCP — link control protocol for PPPoE sessions.

The port's copy of `bng_tpu/control/pppoe/lcp.py` (jax-free).

Parity: pkg/pppoe/lcp.go (LCPStateMachine :104, option negotiation
:394-496). Server negotiates MRU 1492 (PPPoE, RFC 2516 §7), announces the
auth protocol (PAP or CHAP-MD5), and exchanges magic numbers.
"""

from __future__ import annotations

import struct

from bng_tpu_torch.control.pppoe.codec import PROTO_CHAP, PROTO_LCP, PROTO_PAP, CPOption
from bng_tpu_torch.control.pppoe.fsm import OptionFSM

OPT_MRU = 1
OPT_AUTH_PROTO = 3
OPT_QUALITY_PROTO = 4
OPT_MAGIC = 5
OPT_PFC = 7
OPT_ACFC = 8

PPPOE_MRU = 1492
CHAP_ALG_MD5 = 5


class LCP(OptionFSM):
    proto = PROTO_LCP
    name = "lcp"

    def __init__(self, magic: int, auth_proto: int = PROTO_CHAP, **kw):
        super().__init__(**kw)
        self.magic = magic & 0xFFFFFFFF
        self.auth_proto = auth_proto  # PROTO_PAP | PROTO_CHAP | 0 (no auth)
        self.peer_magic = 0
        self.peer_mru = PPPOE_MRU
        self.negotiated_auth = 0

    def own_options(self) -> list[CPOption]:
        opts = [CPOption(OPT_MRU, struct.pack(">H", PPPOE_MRU)),
                CPOption(OPT_MAGIC, struct.pack(">I", self.magic))]
        if self.auth_proto == PROTO_PAP:
            opts.append(CPOption(OPT_AUTH_PROTO, struct.pack(">H", PROTO_PAP)))
        elif self.auth_proto == PROTO_CHAP:
            opts.append(CPOption(OPT_AUTH_PROTO,
                                 struct.pack(">HB", PROTO_CHAP, CHAP_ALG_MD5)))
        return opts

    def check_peer_options(self, opts):
        ack, nak, rej = [], [], []
        for o in opts:
            if o.type == OPT_MRU:
                if len(o.data) == 2:
                    mru = struct.unpack(">H", o.data)[0]
                    if mru < 576:  # too small to be useful; nak up to PPPoE MRU
                        nak.append(CPOption(OPT_MRU, struct.pack(">H", PPPOE_MRU)))
                    else:
                        self.peer_mru = min(mru, PPPOE_MRU)
                        ack.append(o)
                else:
                    rej.append(o)
            elif o.type == OPT_MAGIC:
                if len(o.data) == 4:
                    self.peer_magic = struct.unpack(">I", o.data)[0]
                    ack.append(o)
                else:
                    rej.append(o)
            elif o.type in (OPT_PFC, OPT_ACFC):
                # header compression is meaningless over PPPoE; reject
                rej.append(o)
            elif o.type == OPT_AUTH_PROTO:
                # client must not authenticate the server
                rej.append(o)
            else:
                rej.append(o)
        return ack, nak, rej

    def peer_acked(self, opts):
        self.negotiated_auth = self.auth_proto

    def peer_naked(self, opts):
        for o in opts:
            if o.type == OPT_AUTH_PROTO and len(o.data) >= 2:
                want = struct.unpack(">H", o.data[:2])[0]
                # fall back PAP<->CHAP if the client insists (lcp.go behavior:
                # server policy wins only if client supports it)
                if want in (PROTO_PAP, PROTO_CHAP):
                    self.auth_proto = want

    def peer_rejected(self, opts):
        for o in opts:
            if o.type == OPT_AUTH_PROTO:
                # client refuses auth entirely -> keep requiring it; the
                # session will fail authentication instead of skipping it
                pass
