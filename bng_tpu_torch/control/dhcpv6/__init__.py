"""DHCPv6 server: wire codec + IA_NA address / IA_PD prefix delegation.

The port's copy of `bng_tpu/control/dhcpv6/__init__.py` (jax-free).

Parity: pkg/dhcpv6 (from-scratch codec + server, reference
protocol.go:166-453 / server.go). Handles SOLICIT/REQUEST/CONFIRM/RENEW/
REBIND/RELEASE/DECLINE/INFORMATION-REQUEST with IA_NA pools and IA_PD
prefix pools, rapid commit, and status codes.
"""

from bng_tpu_torch.control.dhcpv6.protocol import (
    DHCPv6Message,
    DUID,
    IAAddress,
    IANA,
    IAPD,
    IAPrefix,
    generate_duid_ll,
)
from bng_tpu_torch.control.dhcpv6.server import (
    AddressPool6,
    DHCPv6Server,
    DHCPv6ServerConfig,
    PrefixPool6,
)

__all__ = [
    "DHCPv6Message",
    "DUID",
    "IAAddress",
    "IANA",
    "IAPD",
    "IAPrefix",
    "generate_duid_ll",
    "AddressPool6",
    "DHCPv6Server",
    "DHCPv6ServerConfig",
    "PrefixPool6",
]
