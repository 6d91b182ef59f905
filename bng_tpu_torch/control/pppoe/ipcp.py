"""IPCP — IPv4 address/DNS negotiation over PPP.

The port's copy of `bng_tpu/control/pppoe/ipcp.py` (jax-free).

Parity: pkg/pppoe/ipcp.go (IPCPStateMachine :92, IP assignment
negotiation :375-474): the server Naks the client's 0.0.0.0 (or wrong)
IP-Address with the allocated address; DNS options 129/131 are Nak'd
with the configured resolvers.
"""

from __future__ import annotations

import struct

from bng_tpu_torch.control.pppoe.codec import PROTO_IPCP, CPOption
from bng_tpu_torch.control.pppoe.fsm import OptionFSM

OPT_IP_ADDRESSES = 1  # deprecated, reject
OPT_IP_COMPRESSION = 2
OPT_IP_ADDRESS = 3
OPT_PRIMARY_DNS = 129
OPT_SECONDARY_DNS = 131


def _ip4(v: int) -> bytes:
    return struct.pack(">I", v & 0xFFFFFFFF)


class IPCP(OptionFSM):
    proto = PROTO_IPCP
    name = "ipcp"

    def __init__(self, our_ip: int, client_ip: int,
                 dns_primary: int = 0, dns_secondary: int = 0, **kw):
        super().__init__(**kw)
        self.our_ip = our_ip
        self.client_ip = client_ip  # the address we assign
        self.dns_primary = dns_primary
        self.dns_secondary = dns_secondary
        self.client_confirmed_ip = 0

    def own_options(self) -> list[CPOption]:
        return [CPOption(OPT_IP_ADDRESS, _ip4(self.our_ip))]

    def check_peer_options(self, opts):
        ack, nak, rej = [], [], []
        for o in opts:
            if o.type == OPT_IP_ADDRESS and len(o.data) == 4:
                got = struct.unpack(">I", o.data)[0]
                if got == self.client_ip and got != 0:
                    self.client_confirmed_ip = got
                    ack.append(o)
                else:
                    nak.append(CPOption(OPT_IP_ADDRESS, _ip4(self.client_ip)))
            elif o.type == OPT_PRIMARY_DNS and self.dns_primary:
                if len(o.data) == 4 and struct.unpack(">I", o.data)[0] == self.dns_primary:
                    ack.append(o)
                else:
                    nak.append(CPOption(OPT_PRIMARY_DNS, _ip4(self.dns_primary)))
            elif o.type == OPT_SECONDARY_DNS and self.dns_secondary:
                if len(o.data) == 4 and struct.unpack(">I", o.data)[0] == self.dns_secondary:
                    ack.append(o)
                else:
                    nak.append(CPOption(OPT_SECONDARY_DNS, _ip4(self.dns_secondary)))
            else:
                rej.append(o)
        return ack, nak, rej
