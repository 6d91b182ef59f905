"""Cluster control fabric (copy of `bng_tpu/cluster/fabric/`): the real
transport under the cluster's membership — authenticated UDP datagrams for production, a
deterministic `SimTransport` for tests and chaos, and a partition-aware
failure detector that understands the two failure shapes PAPERS.md
warns about: *partial* partitions (Alquraan et al., OSDI'18 NEAT) and
*gray* members that answer heartbeats but cannot serve (Huang et al.,
HotOS'17).
"""

from .membership import (PEER_DOWN, PEER_GRAY, PEER_SUSPECT, PEER_UP,
                         FailureDetector, PeerView)
from .transport import FabricMessage, SimTransport, UDPTransport

__all__ = [
    "FabricMessage", "UDPTransport", "SimTransport",
    "FailureDetector", "PeerView",
    "PEER_UP", "PEER_SUSPECT", "PEER_GRAY", "PEER_DOWN",
]
