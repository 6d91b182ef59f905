"""The deployment's data, made from its configuration and the run's seed.

These arrays are what the benchmark hands to both sides: `deploy.py`
installs them into the program through its host API, and the reference
works out from them alone what the program should answer. Nothing here
imports the program.

The seed moves where the data lies (the subscribers' MAC block and the
flows' destination block), not how much of it there is, so every seed
builds tables of the same shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAC_OUI = 0x02AA00000000  # locally administered block of the subscribers' MACs
FLOW_MAC_OUI = 0x020000000000  # a flow's source MAC: 02:00 and its IPv4 address
FLOW_DST_NET = 0x5DB80000  # 93.184.0.0/16, the flows' far ends


def ip(s: str) -> int:
    a, b, c, d = (int(x) for x in s.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


@dataclass
class Dataset:
    cfg: dict
    now0: int  # the deployment's clock at build time (seconds)
    server_mac: int
    server_ip: int
    sub_macs: np.ndarray  # [N] uint64
    sub_ips: np.ndarray  # [N] uint64
    sub_pools: np.ndarray  # [N] pool id of each subscriber
    flow_src: np.ndarray  # [F] uint64 private source address
    flow_dst: np.ndarray  # [F]
    flow_sport: np.ndarray  # [F]
    flow_dport: np.ndarray  # [F]
    nat_public_ips: np.ndarray  # [P]
    qos_ips: np.ndarray  # [Q]
    qos_policed: np.ndarray  # [Q] bool
    bind_ips: np.ndarray  # [A] strict antispoof bindings (MAC = flow MAC of the address)

    @property
    def n_subs(self) -> int:
        return len(self.sub_macs)

    @property
    def n_flows(self) -> int:
        return len(self.flow_src)


def fnv1a32(values, nbytes: int) -> np.ndarray:
    """FNV-1a 32 over each value's `nbytes` big-endian bytes: the ring's
    steering hash and the sharded box's subscriber affinity."""
    v = np.asarray(values, dtype=np.uint64)
    h = np.full(v.shape, 0x811C9DC5, dtype=np.uint64)
    for k in range(nbytes - 1, -1, -1):
        h = ((h ^ ((v >> np.uint64(8 * k)) & np.uint64(0xFF))) * np.uint64(0x01000193)) \
            & np.uint64(0xFFFFFFFF)
    return h


def ip_shard(ips, n: int) -> np.ndarray:
    """The shard an address's upstream traffic and state live on."""
    return (fnv1a32(ips, 4) % np.uint64(n)).astype(np.int64)


def mac_shard(macs, n: int) -> np.ndarray:
    """The shard a DHCP request from this MAC is steered to."""
    return (fnv1a32(macs, 6) % np.uint64(n)).astype(np.int64)


def flow_mac(ips) -> np.ndarray:
    return np.uint64(FLOW_MAC_OUI) | np.asarray(ips, dtype=np.uint64)


def build(cfg: dict, seed: int) -> Dataset:
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xDA7A])
    n = int(cfg["subscribers"])
    first = ip(cfg["first_address"])
    idx = np.arange(n, dtype=np.uint64)
    mac_off = int(rng.integers(0, (1 << 32) - n))
    sub_ips = np.uint64(first) + idx
    pool_bits = 32 - int(cfg["pool_prefix_len"])
    sub_pools = (idx >> np.uint64(pool_bits)) + np.uint64(1)

    ns = int(cfg["nat_subscribers"])
    nf = int(cfg["flows"])
    per_sub = -(-nf // ns)
    fi = np.arange(nf, dtype=np.uint64)
    k = fi // np.uint64(ns)
    dst_off = int(rng.integers(0, (1 << 16) - per_sub))
    flow_src = sub_ips[(fi % np.uint64(ns)).astype(np.int64)]

    nq = int(cfg["qos_policies"])
    qos_ips = sub_ips[np.arange(nq) * (ns // nq)]
    policed = np.arange(nq) < int(round(nq * float(cfg["qos_policed_share"])))
    nb = int(cfg["antispoof_bindings"])
    bind_ips = sub_ips[(np.arange(nb) * int(cfg["antispoof_stride"])) % ns]
    n_pub = int(cfg["nat_public_ips"])
    return Dataset(
        cfg=cfg, now0=int(cfg["now0"]),
        server_mac=int(cfg["server_mac"], 16), server_ip=ip(cfg["server_ip"]),
        sub_macs=np.uint64(MAC_OUI + mac_off) + idx, sub_ips=sub_ips, sub_pools=sub_pools,
        flow_src=flow_src, flow_dst=np.uint64(FLOW_DST_NET + dst_off) + k,
        flow_sport=np.uint64(int(cfg["flow_sport_base"])) + k,
        flow_dport=np.full(nf, int(cfg["flow_dport"]), dtype=np.uint64),
        nat_public_ips=np.uint64(ip(cfg["nat_first_public"])) + np.arange(n_pub, dtype=np.uint64),
        qos_ips=qos_ips, qos_policed=policed, bind_ips=bind_ips,
    )
