"""Per-subscriber token-bucket rate limiting (port of `bng_tpu/ops/qos.py`).

Admission is sequential-TBF per lane in arrival order: lane i passes iff
the bytes of same-bucket lanes j <= i fit the tokens available at batch
start. The port always takes the Pallas-path formulation of
`_prefix_consumed` (`bng_tpu/ops/qos.py:72-91`): one K2 prefix over the
lengths, one K2 total over the admitted bytes — 2 K2 calls per direction.
K2 sums in integers, so the result also equals the JAX sort path.

The refill arithmetic stays plain torch, in the reference's float32
operation order (no fused multiply-add), which gives the token bits of
the JAX CPU run. Token state is written back into the table IN PLACE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.qtable import QTableGeom, QTableState, qlookup, write_token_rows
from bng_tpu_torch.ops.seg_prefix import seg_prefix_total

(QST_PKTS_PASSED, QST_PKTS_DROPPED, QST_BYTES_PASSED, QST_BYTES_DROPPED) = range(4)
QOS_NSTATS = 4

QoSGeom = QTableGeom


def _prefix_consumed(limited, slot, lens, avail):
    """(allowed, consumed f32, is_head) — see the module docstring.

    lens: [B] int64 byte counts; avail: [B] float32 tokens at batch start.
    """
    Bsz = slot.shape[0]
    dev = slot.device
    # lanes without a limit get unique negative ids -> group with nobody
    slot_eff = torch.where(limited, slot, -1 - torch.arange(Bsz, device=dev)).to(torch.int32)
    lens_f = lens.to(torch.float32)
    cum_incl, _ = seg_prefix_total(slot_eff, lens.to(torch.int32), compute="prefix")
    allowed = ~limited | (cum_incl <= avail)
    admitted = torch.where(allowed & limited, lens, 0)
    _, consumed = seg_prefix_total(slot_eff, admitted.to(torch.int32), compute="total")
    is_head = limited & (cum_incl <= lens_f)  # no earlier same-bucket lane
    return allowed, consumed, is_head


class QoSResult(NamedTuple):
    allowed: torch.Tensor  # [B] bool (True also for no-policy lanes)
    dropped: torch.Tensor  # [B] bool
    priority: torch.Tensor  # [B] int64
    table: QTableState  # the same table, token state updated in place
    stats: torch.Tensor  # [QOS_NSTATS] int64 (uint32 values)


def qos_kernel(ip_key, pkt_len, active, table: QTableState, geom: QTableGeom,
               now_us) -> QoSResult:
    """ip_key, pkt_len: [B] int64; active: [B] bool; now_us: int64 scalar
    tensor (uint32 value, wraps)."""
    # QoS writes its token rows back at res.slot, which under a sharded
    # geometry would be an owner-local slot: QoS tables stay chip-local,
    # placed by subscriber affinity
    if geom.axis is not None and geom.n_shards > 1:
        raise ValueError("qos_kernel requires a chip-local table (geom.axis=None); "
                         "QoS state is placed by subscriber affinity, not hash-sharding")
    res = qlookup(table, ip_key, geom)
    has_policy = res.found & active
    limited = has_policy & ((res.rate_lo | res.rate_hi) != 0)

    # Python scalars ride as kernel arguments and are rounded to float32
    # once (2^32 and 8 exactly, 1e-6 to its nearest f32), as the
    # reference's f32 constants; each op rounds its own result, so no
    # multiply-add is fused.
    f32 = torch.float32
    burst_f = res.burst.to(f32)
    elapsed_us = ((now_us - res.last_us) & MASK32).to(f32)
    rate_bps = res.rate_lo.to(f32) + res.rate_hi.to(f32) * 2.0 ** 32
    refill = elapsed_us * (rate_bps / 8.0) * 1e-6
    avail = torch.minimum(res.tokens + refill, burst_f)

    lens = pkt_len.to(torch.int64) & MASK32
    allowed, consumed, first = _prefix_consumed(limited, res.slot, lens, avail)
    dropped = limited & ~allowed
    new_tokens = torch.minimum((avail - consumed).clamp(min=0.0), burst_f)
    S = table.rows.shape[0]
    wslot = torch.where(first, res.slot, S)
    write_token_rows(table, wslot, res.row, new_tokens, now_us)

    priority = torch.where(has_policy, res.priority, 0)
    counted = has_policy
    stats = torch.stack([
        (counted & allowed).sum(),
        dropped.sum(),
        torch.where(counted & allowed, lens, 0).sum(),
        torch.where(dropped, lens, 0).sum(),
    ]) & MASK32
    return QoSResult(allowed=allowed, dropped=dropped, priority=priority,
                     table=table, stats=stats)
