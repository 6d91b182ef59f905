"""Anti-spoofing / uRPF source validation (port of `bng_tpu/ops/antispoof.py`).

Per-lane mode resolution, strict/loose/log-only semantics, IPv4 + IPv6
exact binding, and the allowed-ranges check as a dense [B, R] prefix
compare. The binding lookup is one K1 probe.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops import bytes as B_
from bng_tpu_torch.ops.hashing import MASK32, u32
from bng_tpu_torch.ops.parse import Parsed
from bng_tpu_torch.ops.table import TableGeom, TableState, lookup

MODE_DISABLED, MODE_STRICT, MODE_LOOSE, MODE_LOG_ONLY = range(4)

(AB_IPV4, AB_V6_0, AB_V6_1, AB_V6_2, AB_V6_3, AB_VALIDS, AB_MODE) = range(7)
ANTISPOOF_WORDS = 8
VALID_V4, VALID_V6 = 0x01, 0x02

(AST_ALLOWED, AST_DROPPED, AST_LOGGED, AST_V4_VIOL, AST_V6_VIOL, AST_UNKNOWN_MAC) = range(6)
ANTISPOOF_NSTATS = 6

AntispoofGeom = TableGeom


class AntispoofResult(NamedTuple):
    dropped: torch.Tensor  # [B] bool
    violation: torch.Tensor  # [B] bool (includes log-only violations)
    stats: torch.Tensor  # [ANTISPOOF_NSTATS] int64 (uint32 values)


def antispoof_kernel(pkt, parsed: Parsed, bindings: TableState, geom: AntispoofGeom,
                     allowed_ranges, config) -> AntispoofResult:
    """allowed_ranges: [R, 2] int32 words (prefix_len, network; plen 0 =
    empty row); config: [2] int32 words (default_mode, log_violations)."""
    Bsz = pkt.shape[0]
    cfg = u32(config)
    default_mode = cfg[0]

    mac_key = torch.stack([parsed.src_mac_hi, parsed.src_mac_lo], dim=1)
    res = lookup(bindings, mac_key, geom)
    vals = u32(res.vals)
    has_binding = res.found
    mode = torch.where(has_binding, vals[:, AB_MODE], default_mode)
    disabled = mode == MODE_DISABLED

    # --- IPv4 ---
    v4_valid = has_binding & ((vals[:, AB_VALIDS] & VALID_V4) != 0)
    strict_ok = parsed.src_ip == vals[:, AB_IPV4]
    rng = u32(allowed_ranges)
    plen = rng[:, 0]
    net = rng[:, 1]
    # the reference reads plen as int32 here: a word >= 2^31 shifts by 32
    sh = (32 - allowed_ranges[:, 0].to(torch.int64)).clamp(0, 32)
    sh1 = torch.minimum(sh, torch.full_like(sh, 16))
    sh2 = sh - sh1
    src_pfx = (parsed.src_ip[:, None] >> sh1[None, :]) >> sh2[None, :]
    net_pfx = ((net >> sh1) >> sh2)[None, :]
    in_range = ((src_pfx == net_pfx) & (plen != 0)[None, :]).any(dim=1)

    v4_allowed = torch.where(
        v4_valid,
        ((mode == MODE_STRICT) | (mode == MODE_LOG_ONLY)) & strict_ok,
        (mode == MODE_LOOSE) & in_range,
    )
    v4_viol = parsed.is_ipv4 & ~disabled & ~v4_allowed
    v4_drop = v4_viol & (mode != MODE_LOG_ONLY)

    # --- IPv6 ---
    v6_valid = has_binding & ((vals[:, AB_VALIDS] & VALID_V6) != 0)
    w = B_.bytes_at(pkt, parsed.l3_off + 8, 16).to(torch.int64).view(Bsz, 4, 4)
    src6_words = (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | (w[:, :, 2] << 8) | w[:, :, 3]
    v6_match = (src6_words == vals[:, AB_V6_0: AB_V6_3 + 1]).all(dim=1)
    v6_allowed = torch.where(v6_valid, v6_match, mode == MODE_LOOSE)
    v6_viol = parsed.is_ipv6 & ~disabled & ~v6_allowed
    v6_drop = v6_viol & (mode != MODE_LOG_ONLY)

    dropped = v4_drop | v6_drop
    violation = v4_viol | v6_viol
    log_on = cfg[1] != 0

    stats = torch.zeros((ANTISPOOF_NSTATS,), dtype=torch.int64, device=pkt.device)
    stats[AST_DROPPED] = dropped.sum()
    stats[AST_ALLOWED] = (~dropped).sum()
    stats[AST_V4_VIOL] = v4_drop.sum()
    stats[AST_V6_VIOL] = v6_drop.sum()
    stats[AST_LOGGED] = (violation & log_on).sum()
    return AntispoofResult(dropped=dropped, violation=violation & log_on,
                           stats=stats & MASK32)
