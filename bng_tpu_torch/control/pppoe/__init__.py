"""PPPoE server: discovery, LCP/IPCP/IPV6CP, PAP/CHAP auth, sessions.

The port's copy of `bng_tpu/control/pppoe/__init__.py` (jax-free).

Parity: pkg/pppoe (reference's largest package, ~8.2k LoC). The reference
runs over an AF_PACKET raw socket with goroutine loops; here the server is
frames-in/frames-out and tick-driven: the host engine feeds it ethernet
frames (ethertype 0x8863/0x8864) from PASS-verdict lanes and transmits the
frames it returns, and calls tick(now) for keepalive/timeout processing.
"""

from bng_tpu_torch.control.pppoe.codec import (
    ETH_PPPOE_DISCOVERY,
    ETH_PPPOE_SESSION,
    PPPoEPacket,
    Tag,
)
from bng_tpu_torch.control.pppoe.server import PPPoEServer, PPPoEServerConfig
from bng_tpu_torch.control.pppoe.session import PPPoESession, SessionManager, TerminateCause

__all__ = [
    "ETH_PPPOE_DISCOVERY",
    "ETH_PPPOE_SESSION",
    "PPPoEPacket",
    "Tag",
    "PPPoEServer",
    "PPPoEServerConfig",
    "PPPoESession",
    "SessionManager",
    "TerminateCause",
]
