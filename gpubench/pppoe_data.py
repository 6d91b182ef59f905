"""The PPPoE-over-QinQ deployment's data and traffic, made from its
configuration, its mix and the run's seed.

The dataset is what the benchmark hands to both sides: the system's module
installs it into the program through its host API, and the reference
(`gpubench/reference/pppoe.py`) works out from it alone what the program
should answer. Nothing here imports the program.

Session k (0-based) has session id `first_session_id` + k, the address
`first_address` + k, a MAC from a block the seed places, and the line
S-tag `s_tag_first` + k // `c_tags_per_s_tag`, C-tag 1 + k % that (1:1
VLANs, BBF TR-101). Its flows are flow_per_session UDP flows, flow j
from source port `flow_sport_base` + j to the far end j of a /16 the seed
places, port `flow_dport`; flow f is flow f // sessions of session
f % sessions. Every `qos_over_quota_every`-th session is in the
over-quota tier.

A mix (`gpubench/traffic/<mix>.json`) gives the shares of a batch:
downstream frames (`downstream_share`, `down_frame_len` bytes from the
core), LCP Echo-Requests (`lcp_share`, at least one a batch) and upstream
session frames (the rest, `up_frame_len` bytes on the line), each batch
holding exactly its counts at shuffled lanes; flows and sessions are
picked uniformly. All frames are built at set-up into one pool of whole
batches (`pool_batches`), so the measured window makes no packet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gpubench.dataset import MAC_OUI, ip
from gpubench.reference.pppoe import KIND_DOWN, KIND_LCP, KIND_UP, Reference

FROM_ACCESS = 1  # the ring descriptor's from-access flag
FLOW_DST_NET = 0x5DB80000  # 93.184.0.0/16, the flows' far ends
BUILD_CHUNK = 16384  # frames built at once (bounds the set-up's memory)


@dataclass
class Dataset:
    cfg: dict
    now0: int  # the deployment's clock at build time (seconds)
    ac_mac: int
    session_ids: np.ndarray  # [S]
    sub_macs: np.ndarray  # [S] uint64
    sub_ips: np.ndarray  # [S] uint64
    s_tags: np.ndarray  # [S] the line's S-VID
    c_tags: np.ndarray  # [S] the line's C-VID
    over_quota: np.ndarray  # [S] bool
    flow_session: np.ndarray  # [F] int64
    flow_dst: np.ndarray  # [F] uint64
    flow_sport: np.ndarray  # [F]
    flow_dport: np.ndarray  # [F]
    nat_public_ips: np.ndarray  # [P]

    @property
    def n_sessions(self) -> int:
        return len(self.session_ids)

    @property
    def n_flows(self) -> int:
        return len(self.flow_session)


def build(cfg: dict, seed: int) -> Dataset:
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x99E0E])
    n = int(cfg["subscribers"])
    k = np.arange(n, dtype=np.int64)
    per_s = int(cfg["c_tags_per_s_tag"])
    nf = int(cfg["flows"])
    per_session = nf // n
    if per_session * n != nf:
        raise ValueError("flows must be a whole number a session")
    f = np.arange(nf, dtype=np.int64)
    j = (f // n).astype(np.uint64)
    mac_off = int(rng.integers(0, (1 << 32) - n))
    dst_off = int(rng.integers(0, (1 << 16) - per_session))
    every = int(cfg["qos_over_quota_every"])
    return Dataset(
        cfg=cfg, now0=int(cfg["now0"]), ac_mac=int(cfg["ac_mac"], 16),
        session_ids=(int(cfg["first_session_id"]) + k).astype(np.uint64),
        sub_macs=np.uint64(MAC_OUI + mac_off) + k.astype(np.uint64),
        sub_ips=np.uint64(ip(cfg["first_address"])) + k.astype(np.uint64),
        s_tags=(int(cfg["s_tag_first"]) + k // per_s).astype(np.uint64),
        c_tags=(1 + k % per_s).astype(np.uint64),
        over_quota=k % every == every - 1,
        flow_session=f % n,
        flow_dst=np.uint64(FLOW_DST_NET + dst_off) + j,
        flow_sport=np.uint64(int(cfg["flow_sport_base"])) + j,
        flow_dport=np.full(nf, int(cfg["flow_dport"]), dtype=np.uint64),
        nat_public_ips=(np.uint64(ip(cfg["nat_first_public"]))
                        + np.arange(int(cfg["nat_public_addresses"]), dtype=np.uint64)),
    )


@dataclass
class Traffic:
    kind: np.ndarray  # [n] KIND_UP, KIND_DOWN or KIND_LCP
    ref: np.ndarray  # [n] flow index (data) or session index (LCP)
    rows: np.ndarray  # [n, width] uint8 frames
    lens: np.ndarray  # [n]
    flags: np.ndarray  # [n] uint32 ring descriptor flags (the direction)

    def __len__(self) -> int:
        return len(self.kind)


def batch_counts(mix: dict, batch: int) -> tuple[int, int, int]:
    """(downstream, LCP, upstream) frames of each batch."""
    down = int(round(float(mix["downstream_share"]) * batch))
    lcp = max(1, int(round(float(mix["lcp_share"]) * batch)))
    return down, lcp, batch - down - lcp


def closed_loop(mix: dict, ds: Dataset, batch: int, seed: int, width: int) -> Traffic:
    """`pool_batches` batches of `batch` frames, each holding exactly its
    counts of every kind at shuffled lanes; flows and sessions uniform."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xB1D1])
    nb = int(mix["pool_batches"])
    down, lcp, _ = batch_counts(mix, batch)
    kind = np.full((nb, batch), KIND_UP, dtype=np.int8)
    kind[:, :down] = KIND_DOWN
    kind[:, down:down + lcp] = KIND_LCP
    kind = rng.permuted(kind, axis=1).reshape(-1)
    ref = np.where(kind == KIND_LCP, rng.integers(0, ds.n_sessions, size=len(kind)),
                   rng.integers(0, ds.n_flows, size=len(kind)))
    lens = np.select([kind == KIND_UP, kind == KIND_DOWN],
                     [int(mix["up_frame_len"]), int(mix["down_frame_len"])], 0).astype(np.int64)
    rows = np.zeros((len(kind), width), dtype=np.uint8)
    refm = Reference(ds)
    for c0 in range(0, len(kind), BUILD_CHUNK):
        sl = slice(c0, c0 + BUILD_CHUNK)
        k, r = kind[sl], ref[sl]
        for kk, make in ((KIND_UP, refm.upstream_rows), (KIND_DOWN, refm.downstream_rows)):
            sel = np.nonzero(k == kk)[0]
            if len(sel):
                rows[c0 + sel], _ = make(r[sel], int(lens[c0 + sel[0]]), width)
        sel = np.nonzero(k == KIND_LCP)[0]
        if len(sel):
            rows[c0 + sel], lens[c0 + sel] = refm.lcp_rows(r[sel], c0 + sel, width)
    flags = np.where(kind == KIND_DOWN, 0, FROM_ACCESS).astype(np.uint32)
    return Traffic(kind, ref, rows, lens, flags)
