"""IPV6CP — IPv6 interface-identifier negotiation over PPP.

The port's copy of `bng_tpu/control/pppoe/ipv6cp.py` (jax-free).

Parity: pkg/pppoe/ipv6cp.go (IPV6CPStateMachine :90): negotiate the
64-bit interface identifier; zero or colliding IIDs are Nak'd with a
server-assigned one. Global addresses then come from SLAAC/DHCPv6 over
the session.
"""

from __future__ import annotations

from bng_tpu_torch.control.pppoe.codec import PROTO_IPV6CP, CPOption
from bng_tpu_torch.control.pppoe.fsm import OptionFSM

OPT_INTERFACE_ID = 1


class IPV6CP(OptionFSM):
    proto = PROTO_IPV6CP
    name = "ipv6cp"

    def __init__(self, our_iid: bytes, client_iid: bytes, **kw):
        super().__init__(**kw)
        assert len(our_iid) == 8 and len(client_iid) == 8
        self.our_iid = our_iid
        self.client_iid = client_iid
        self.client_confirmed_iid = b""

    def own_options(self) -> list[CPOption]:
        return [CPOption(OPT_INTERFACE_ID, self.our_iid)]

    def check_peer_options(self, opts):
        ack, nak, rej = [], [], []
        for o in opts:
            if o.type == OPT_INTERFACE_ID and len(o.data) == 8:
                if o.data != b"\x00" * 8 and o.data != self.our_iid:
                    self.client_confirmed_iid = o.data
                    ack.append(o)
                else:
                    nak.append(CPOption(OPT_INTERFACE_ID, self.client_iid))
            else:
                rej.append(o)
        return ack, nak, rej
