"""Rendezvous (HRW) hashing + deterministic hashring allocation.

The port's copy of `bng_tpu/parallel/hashring.py` (jax-free).

The reference's two scale-out placement mechanisms (SURVEY.md §2.3):

- Rendezvous hashing across peer nodes with ranked failover
  (pkg/pool/peer.go:723-790: FNV-1a hashCombine of node+key, owner =
  highest score; rendezvousRanked for failover order).
- Deterministic hashring IP allocation: candidate = hash(subscriberID +
  attempt) % poolSize with bounded linear probing
  (pkg/nexus/client.go:487-577, hashString FNV-1a :694).

Here they place subscribers/flows on chips and shards instead of nodes;
the same functions serve the control plane (peer pools, Nexus clients).
"""

from __future__ import annotations

from bng_tpu_torch.utils.net import fnv1a32


def hash_combine(node: str, key: str) -> int:
    """FNV-1a over node+key (parity: peer.go:777-790)."""
    return fnv1a32((node + ":" + key).encode())


def rendezvous_owner(nodes: list[str], key: str) -> str | None:
    """Highest-random-weight owner (parity: rendezvousHash, peer.go:723-745)."""
    best, best_score = None, -1
    for n in nodes:
        s = hash_combine(n, key)
        if s > best_score or (s == best_score and (best is None or n < best)):
            best, best_score = n, s
    return best


def rendezvous_ranked(nodes: list[str], key: str) -> list[str]:
    """All nodes ranked by HRW score — failover order
    (parity: rendezvousRanked, peer.go:747-776)."""
    return [n for _, n in sorted(((hash_combine(n, key), n) for n in nodes),
                                 key=lambda t: (-t[0], t[1]))]


def hashring_allocate(
    subscriber_id: str,
    pool_size: int,
    is_free,  # Callable[[int], bool]
    max_attempts: int = 1024,
) -> int | None:
    """Deterministic hash-based index allocation with linear probing.

    Parity: AllocateIPForSubscriber (pkg/nexus/client.go:487-577):
    candidate = hash(subscriberID + ":" + attempt) % size, then accept the
    first free candidate. Deterministic across nodes: two BNGs allocating
    for the same subscriber pick the same address without coordination.
    """
    if pool_size <= 0:
        return None
    attempts = min(max_attempts, pool_size)
    for attempt in range(attempts):
        idx = fnv1a32(f"{subscriber_id}:{attempt}".encode()) % pool_size
        if is_free(idx):
            return idx
    return None
