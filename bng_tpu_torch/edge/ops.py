"""Edge protection on the fast path: intercept tap-match and next-hop
route rewrite (port of `bng_tpu/edge/ops.py`).

Tap-match: rows keyed by the subscriber IPv4 (src upstream, post-DNAT
dst downstream) carry a warrant id; optional port/proto/peer filters
sit in a dense [F, 4] word array keyed back to the warrant. A matching
lane gets the warrant id in the per-lane MIRROR word (0 = not
mirrored), a side array beside the verdict.

The reference puts the armed body under `jax.lax.cond` on
`tap_config[TC_ARMED]`. Deciding that branch here would need the armed
word on the host, a device-to-host sync in the middle of the step. The
port computes the armed body unconditionally and selects its result on
the armed word instead (a branch-free select): the same outputs, one
K1 probe per step whether armed or not.

Route rewrite: rows keyed by the subscriber IPv4 hold a next-hop
gateway MAC; upstream lanes that hit get their L2 destination rewritten
(a masked select) and forward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops import bytes as B_
from bng_tpu_torch.ops.hashing import MASK32, u32
from bng_tpu_torch.ops.table import TableGeom, TableState, lookup

# tap row value words: TW_FLAG 1 = armed row, TW_WID the warrant id
(TW_FLAG, TW_WID) = range(2)
TAP_WORDS = 8

# dense filter rows [F, 4]; a lane passes if ANY row of its warrant
# matches (0 in a column = wildcard; wid 0 = free row)
(TF_WID, TF_PORT, TF_PROTO, TF_PEER) = range(4)
TAP_FILTER_COLS = 4

# dense tap config words; TC_ARMED = count of armed rows
TC_ARMED = 0
TAP_CONFIG_WORDS = 2

# route row value words
(RW_FLAG, RW_MAC_HI, RW_MAC_LO, RW_TABLE, RW_CLASS) = range(5)
ROUTE_WORDS = 8

(EST_MIRRORED, EST_TAP_FILTERED, EST_ROUTE_REWRITES, EST_ROUTE_MISSES) = range(4)
EDGE_NSTATS = 4


class TapResult(NamedTuple):
    mirror: torch.Tensor  # [B] int64: warrant id where mirrored, 0 = no
    stats: torch.Tensor  # [2] int64: (mirrored, filtered-out)


class RouteResult(NamedTuple):
    out_pkt: torch.Tensor  # [B, L] uint8, dst MAC rewritten on hit lanes
    hit: torch.Tensor  # [B] bool
    stats: torch.Tensor  # [2] int64: (rewrites, eligible misses)


def tap_match(sub_ip, src_port, dst_port, proto, peer_ip, eligible, taps: TableState,
              filters, config, geom: TableGeom) -> TapResult:
    """Per-lane intercept tap match; filters [F, 4] and config [2] are int32
    words. A disarmed table (armed word 0) gives zeros, selected on the
    device (see the module docstring)."""
    res = lookup(taps, sub_ip[:, None], geom)
    vals = u32(res.vals)
    hit = res.found & (vals[:, TW_FLAG] != 0) & eligible
    wid = vals[:, TW_WID]
    f = u32(filters)
    fw = f[:, TF_WID]
    mine = (fw[None, :] != 0) & (fw[None, :] == wid[:, None])  # [B, F]
    port = f[:, TF_PORT][None, :]
    port_ok = (port == 0) | (src_port[:, None] == port) | (dst_port[:, None] == port)
    prt = f[:, TF_PROTO][None, :]
    proto_ok = (prt == 0) | (proto[:, None] == prt)
    per = f[:, TF_PEER][None, :]
    peer_ok = (per == 0) | (peer_ip[:, None] == per)
    has_filter = mine.any(dim=1)
    passes = (mine & port_ok & proto_ok & peer_ok).any(dim=1)
    matched = hit & (~has_filter | passes)

    armed = u32(config[TC_ARMED]) > 0
    mirror = torch.where(matched & armed, wid, 0)
    stats = torch.where(armed, torch.stack([matched.sum(), (hit & ~matched).sum()]), 0)
    return TapResult(mirror=mirror, stats=stats & MASK32)


def route_rewrite(pkt, sub_ip, eligible, routes: TableState, geom: TableGeom) -> RouteResult:
    """Upstream next-hop rewrite: probe by subscriber IPv4, stamp the
    gateway MAC into the L2 destination of hit lanes."""
    res = lookup(routes, sub_ip[:, None], geom)
    vals = u32(res.vals)
    hit = res.found & (vals[:, RW_FLAG] != 0) & eligible
    z = torch.zeros_like(sub_ip)
    out = B_.scatter_be16_at_masked(pkt, z, vals[:, RW_MAC_HI], hit)
    out = B_.scatter_be32_at_masked(out, z + 2, vals[:, RW_MAC_LO], hit)
    stats = torch.stack([hit.sum(), (eligible & ~hit).sum()]) & MASK32
    return RouteResult(out_pkt=out, hit=hit, stats=stats)
