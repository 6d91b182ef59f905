"""The one traffic generator: reads a mix's parameters, makes frames.

A mix file (`gpubench/traffic/<mix>.json`) says how much of the traffic is
cached DISCOVERs and how much established flows, how long a flow frame is
(`flow_frame_len`, bytes on the wire less the FCS), how subscribers and
flows are picked (`subscriber_pick`, `flow_pick`: "uniform", or
{"dist": "zipf", "s": <exponent>}), and whether the load comes as a closed
loop (the next batch goes in as one retires) or as an open loop (arrivals
at fixed rates, timed from when each was due). Every seed gets the same numbers of frames
of each kind and the same numbers of arrivals, in another order, so seeds
change which rows are touched and not how much work there is.

All frames are built at set-up into one pool of rows, so the measured
window makes no packet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gpubench import packets as P
from gpubench.dataset import Dataset, flow_mac, ip_shard, mac_shard
from gpubench.reference.bng import KIND_DISCOVER, KIND_FLOW


@dataclass
class Traffic:
    kind: np.ndarray  # [n] KIND_DISCOVER or KIND_FLOW
    ref: np.ndarray  # [n] subscriber (DISCOVER) or flow index
    xid: np.ndarray  # [n] DHCP transaction ids (0 for flows)
    rows: np.ndarray  # [n, ROW] uint8 frames
    lens: np.ndarray  # [n]
    due: np.ndarray | None = None  # [n] seconds after the window opens (open loop)

    def __len__(self) -> int:
        return len(self.kind)


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, salt])


def _pick(rng, n_total: int, n: int, how) -> np.ndarray:
    """`n` indices into `n_total` items. A Zipf pick takes its ranks at
    evenly spaced quantiles of the law, so every seed has the same ranks;
    the seed decides which item holds each rank, and the order."""
    if how == "uniform":
        return rng.integers(0, n_total, size=n)
    if isinstance(how, dict) and how.get("dist") == "zipf":
        w = np.arange(1, n_total + 1, dtype=np.float64) ** -float(how["s"])
        cdf = np.cumsum(w)
        rank = np.searchsorted(cdf / cdf[-1], (np.arange(n) + 0.5) / n)
        items = rng.permutation(n_total)[np.minimum(rank, n_total - 1)]
        return rng.permutation(items)
    raise ValueError(f"no such pick: {how!r}")


def flow_frame_len(mix: dict) -> int:
    if "flow_frame_len" not in mix:
        raise ValueError("a mix with flows names its flow_frame_len")
    return int(mix["flow_frame_len"])


def build_frames(ds: Dataset, kind: np.ndarray, ref: np.ndarray, xid: np.ndarray,
                 mix: dict):
    rows = np.zeros((len(kind), P.ROW), dtype=np.uint8)
    lens = np.zeros(len(kind), dtype=np.int64)
    d = np.nonzero(kind == KIND_DISCOVER)[0]
    if len(d):
        rows[d], lens[d] = P.discover_rows(ds.sub_macs[ref[d]], xid[d])
    f = np.nonzero(kind == KIND_FLOW)[0]
    if len(f):
        fl = ref[f]
        rows[f], lens[f] = P.flow_rows(flow_mac(ds.flow_src[fl]), ds.flow_src[fl],
                                       ds.flow_dst[fl], ds.flow_sport[fl], ds.flow_dport[fl],
                                       flow_frame_len(mix))
    return rows, lens


def closed_loop(mix: dict, ds: Dataset, batch: int, seed: int) -> Traffic:
    """`pool_batches` batches of `batch` frames; each batch holds exactly
    round(discover_share * batch) DISCOVERs at shuffled lanes. On a box of
    `shards` shards each batch is one region a shard, in shard order, and
    each region holds its share of DISCOVERs steered to that shard and
    flows of that shard's subscribers, so every region fills exactly."""
    rng = _rng(seed, 0xC105ED)
    nb = int(mix["pool_batches"])
    n_sh = int(ds.cfg.get("shards", 1))
    b = batch // n_sh
    n_disc = int(round(float(mix["discover_share"]) * b))
    kind = np.full((nb * n_sh, b), KIND_FLOW, dtype=np.int8)
    kind[:, :n_disc] = KIND_DISCOVER
    kind = rng.permuted(kind, axis=1)
    ref = np.zeros(kind.shape, dtype=np.int64)
    if n_sh == 1:
        subs, flows = [np.arange(ds.n_subs)], [np.arange(ds.n_flows)]
    else:
        ms, fs = mac_shard(ds.sub_macs, n_sh), ip_shard(ds.flow_src, n_sh)
        subs = [np.nonzero(ms == s)[0] for s in range(n_sh)]
        flows = [np.nonzero(fs == s)[0] for s in range(n_sh)]
    for s in range(n_sh):
        k, r = kind[s::n_sh], ref[s::n_sh]
        d = k == KIND_DISCOVER
        r[d] = subs[s][_pick(rng, len(subs[s]), int(d.sum()), mix["subscriber_pick"])]
        r[~d] = flows[s][_pick(rng, len(flows[s]), int((~d).sum()), mix.get("flow_pick", "uniform"))]
        ref[s::n_sh] = r
    kind, ref = kind.reshape(-1), ref.reshape(-1)
    d = kind == KIND_DISCOVER
    xid = np.where(d, rng.integers(1, 1 << 32, size=len(kind)), 0).astype(np.uint64)
    rows, lens = build_frames(ds, kind, ref, xid, mix)
    return Traffic(kind, ref, xid, rows, lens)


def arrivals(rng, rate: float, seconds: float) -> np.ndarray:
    """round(rate * seconds) arrival times in [0, seconds): exponential gaps
    scaled so the last lands at the end, so their number is fixed."""
    n = int(round(rate * seconds))
    gaps = rng.exponential(1.0, size=n + 1)
    t = np.cumsum(gaps)
    return (t[:-1] / t[-1]) * seconds


def open_loop(mix: dict, ds: Dataset, seed: int, seconds: float) -> Traffic:
    """Two streams over `seconds`: cached DISCOVERs at `discover_rate_per_s`
    and established flows at `flow_rate_per_s`, merged in time order."""
    rng = _rng(seed, 0x0BE11)
    td = arrivals(rng, float(mix["discover_rate_per_s"]), seconds)
    tf = arrivals(rng, float(mix["flow_rate_per_s"]), seconds)
    due = np.concatenate([td, tf])
    kind = np.concatenate([np.full(len(td), KIND_DISCOVER), np.full(len(tf), KIND_FLOW)])
    ref = np.concatenate([_pick(rng, ds.n_subs, len(td), mix["subscriber_pick"]),
                          _pick(rng, ds.n_flows, len(tf), mix.get("flow_pick", "uniform"))])
    order = np.argsort(due, kind="stable")
    kind, ref, due = kind[order].astype(np.int8), ref[order], due[order]
    xid = np.where(kind == KIND_DISCOVER, rng.integers(1, 1 << 32, size=len(kind)),
                   0).astype(np.uint64)
    rows, lens = build_frames(ds, kind, ref, xid, mix)
    return Traffic(kind, ref, xid, rows, lens, due)
