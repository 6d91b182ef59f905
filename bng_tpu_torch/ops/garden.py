"""Device walled-garden gate (port of `bng_tpu/ops/garden.py`).

A gardened subscriber's upstream IPv4 data to a destination outside the
allowed set drops; portal and DNS flows pass. Membership is a cuckoo
table keyed by the subscriber's private IPv4 (one K1 probe, 8-word value
rows, word 0 the gardened flag); the allowed destinations are a dense
[D, 3] word array (ip, port, proto; port/proto 0 = wildcard, ip 0 =
empty row) compared [B, D].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops.hashing import MASK32, u32
from bng_tpu_torch.ops.parse import Parsed
from bng_tpu_torch.ops.table import TableGeom, TableState, lookup

GARDEN_WORDS = 8  # value row: [flag, 7 spare]
GV_FLAG = 0

(GST_GATED_DROPS, GST_ALLOWED_HITS) = range(2)
GARDEN_NSTATS = 2

GardenGeom = TableGeom


class GardenResult(NamedTuple):
    gate_drop: torch.Tensor  # [B] bool — gardened lane to a non-allowed dest
    gardened: torch.Tensor  # [B] bool
    stats: torch.Tensor  # [GARDEN_NSTATS] int64 (uint32 values)


def garden_kernel(parsed: Parsed, eligible, subscribers: TableState, geom: GardenGeom,
                  allowed) -> GardenResult:
    """eligible: [B] bool upstream IPv4 data lanes (not DHCP); allowed:
    [D, 3] int32 words (ip, port, proto)."""
    res = lookup(subscribers, parsed.src_ip[:, None], geom)
    gardened = res.found & (res.vals[:, GV_FLAG] != 0) & eligible

    rows = u32(allowed)
    ip, port, proto = rows[:, 0], rows[:, 1], rows[:, 2]
    dst_ok = parsed.dst_ip[:, None] == ip[None, :]
    port_ok = (port[None, :] == 0) | (parsed.dst_port[:, None] == port[None, :])
    proto_ok = (proto[None, :] == 0) | (parsed.proto[:, None] == proto[None, :])
    allowed_lane = (dst_ok & port_ok & proto_ok & (ip != 0)[None, :]).any(dim=1)

    gate_drop = gardened & ~allowed_lane
    stats = torch.stack([gate_drop.sum(), (gardened & allowed_lane).sum()]) & MASK32
    return GardenResult(gate_drop=gate_drop, gardened=gardened, stats=stats)
