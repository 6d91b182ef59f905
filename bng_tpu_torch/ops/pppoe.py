"""PPPoE session-stage decap/encap and QinQ push/pop over a batch (port of
`bng_tpu/ops/pppoe.py`).

Frame layouts:
  decap: [eth][vlans 0/4/8][0x8864][PPPoE hdr 6B][PPP proto 2B][IPv4...]
     ->  [eth][vlans][0x0800][IPv4...]              (8-byte contraction)
  encap: the reverse 8-byte expansion, the session id taken from the
     session table keyed by the downstream subscriber IP.

Decap validates ver/type 0x11, code 0, the declared length, and that the
session id is in `by_sid` bound to the frame's source MAC (one K1
probe); encap finds the session of the post-DNAT destination in `by_ip`
(one K1 probe). Bytes move by one gather per op (`_shift_bytes`); header
fields are masked selects. Lengths are int64 holding uint32 values and
are masked where the reference's uint32 arithmetic wraps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops import bytes as B_
from bng_tpu_torch.ops.hashing import MASK32, u32
from bng_tpu_torch.ops.parse import ETH_P_8021AD, ETH_P_8021Q, ETH_P_IP, ETH_P_IPV6
from bng_tpu_torch.ops.table import TableGeom, TableState, lookup

ETH_PPPOE_SESSION = 0x8864
ETH_PPPOE_DISC = 0x8863
PPP_IPV4 = 0x0021
PPP_IPV6 = 0x0057
PPPOE_HDR = 8  # 6B PPPoE header + 2B PPP protocol

# session table value words (8-word rows)
(PS_SESSION_ID, PS_MAC_HI, PS_MAC_LO, PS_IP, PS_FLAGS) = range(5)
PPPOE_WORDS = 8

# stats
(PST_DECAP, PST_ENCAP, PST_CTRL_PUNT, PST_BAD, PST_MISS) = range(5)
PPPOE_NSTATS = 5


class PPPoEResult(NamedTuple):
    out_pkt: torch.Tensor  # [B, L] uint8
    out_len: torch.Tensor  # [B] int64
    done: torch.Tensor  # [B] bool — lane rewritten by this op
    punt: torch.Tensor  # [B] bool — PPPoE control traffic for the host stack
    src_ip_hint: torch.Tensor  # [B] int64 session IP
    stats: torch.Tensor  # [PPPOE_NSTATS] int64 (uint32 values)


def _shift_bytes(pkt, shift, gate, start):
    """Shift the bytes at and after per-lane `start` by per-lane `shift`:
    positive contracts (byte j reads j+shift), negative expands. Bytes
    before `start` never move. One [B, L] gather, the source clipped to
    [0, L-1]."""
    L = pkt.shape[1]
    jj = torch.arange(L, device=pkt.device)[None, :]
    src = (jj + shift.to(torch.int64)[:, None]).clamp(0, L - 1)
    moved = pkt.gather(1, src)
    keep_head = jj < start.to(torch.int64).reshape(-1, 1)
    return torch.where(gate[:, None] & ~keep_head, moved, pkt)


def _stats(device, **masks):
    """[PPPOE_NSTATS] lane counts by name (one stack: no host copy)."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return torch.stack([masks[n].sum() if n in masks else zero
                        for n in ("decap", "encap", "ctrl_punt", "bad", "miss")]) & MASK32


def pppoe_decap(pkt, length, vlan_offset, ethertype, sessions: TableState,
                geom: TableGeom) -> PPPoEResult:
    """Strip PPPoE+PPP framing from established-session IPv4 data."""
    length = length.to(torch.int64)
    et_off = 12 + vlan_offset.to(torch.int64)  # offset of the ethertype field
    ph = et_off + 2  # PPPoE header start

    is_sess = ethertype == ETH_PPPOE_SESSION
    is_disc = ethertype == ETH_PPPOE_DISC
    hdr_ok = (ph + PPPOE_HDR) <= length

    ver_type = B_.u8_at(pkt, ph)
    code = B_.u8_at(pkt, ph + 1)
    session_id = B_.be16_at(pkt, ph + 2)
    plen = B_.be16_at(pkt, ph + 4)  # PPP proto + data
    ppp_proto = B_.be16_at(pkt, ph + 6)

    # the declared payload must fit the frame and hold the PPP protocol word
    plen_ok = (plen >= 2) & ((ph + 6 + plen) <= length)
    well_formed = is_sess & hdr_ok & (ver_type == 0x11) & (code == 0) & plen_ok
    # only IPv4 data decaps: encap is IPv4-keyed, v6 PPP data goes to the host
    is_data = well_formed & (ppp_proto == PPP_IPV4)
    is_malformed = is_sess & ~well_formed
    is_ctrl = is_disc | (well_formed & ~is_data) | is_malformed

    zero = torch.zeros_like(et_off)
    src_mac_hi = B_.be16_at(pkt, zero + 6)
    src_mac_lo = B_.be32_at(pkt, zero + 8)
    res = lookup(sessions, session_id[:, None], geom)
    vals = u32(res.vals)
    bound = res.found & (vals[:, PS_MAC_HI] == src_mac_hi) & (vals[:, PS_MAC_LO] == src_mac_lo)
    ok = is_data & bound
    miss = is_data & ~bound  # unknown or foreign session -> punt

    out = _shift_bytes(pkt, torch.where(ok, PPPOE_HDR, 0), ok, et_off)
    inner_et = torch.where(ppp_proto == PPP_IPV4, ETH_P_IP, ETH_P_IPV6)
    out = B_.scatter_be16_at_masked(out, et_off, inner_et, ok)
    # L2 up to the ethertype + the IP bytes; Ethernet padding past plen drops
    out_len = torch.where(ok, et_off + plen, length)

    # disjoint buckets: a malformed frame counts only as BAD
    stats = _stats(pkt.device, decap=ok, ctrl_punt=is_disc | (well_formed & ~is_data),
                   bad=is_malformed, miss=miss)
    return PPPoEResult(out_pkt=out, out_len=out_len, done=ok, punt=is_ctrl | miss,
                       src_ip_hint=torch.where(ok, vals[:, PS_IP], 0), stats=stats)


def pppoe_encap(pkt, length, vlan_offset, ethertype, dst_ip, by_ip: TableState,
                geom: TableGeom, server_mac) -> PPPoEResult:
    """Add PPPoE+PPP framing to downstream IPv4 data for PPPoE subscribers.

    server_mac: [2] int32 words (hi16, lo32), the access concentrator's MAC
    written as the L2 source of every encapsulated frame; None declares
    the frames pre-stamped (no default, as in the reference)."""
    Bsz, L = pkt.shape
    length = length.to(torch.int64)
    et_off = 12 + vlan_offset.to(torch.int64)

    res = lookup(by_ip, dst_ip[:, None], geom)
    vals = u32(res.vals)
    ok = (ethertype == ETH_P_IP) & res.found & (((length + PPPOE_HDR) & MASK32) <= L)

    out = _shift_bytes(pkt, torch.where(ok, -PPPOE_HDR, 0), ok, et_off)
    ph = et_off + 2
    zero = torch.zeros_like(et_off)
    out = B_.scatter_be16_at_masked(out, et_off, zero + ETH_PPPOE_SESSION, ok)
    out = B_.scatter_be16_at_masked(out, ph, zero + 0x1100, ok)
    out = B_.scatter_be16_at_masked(out, ph + 2, vals[:, PS_SESSION_ID], ok)
    out = B_.scatter_be16_at_masked(out, ph + 4, (length - et_off) & MASK32, ok)
    out = B_.scatter_be16_at_masked(out, ph + 6, zero + PPP_IPV4, ok)
    # L2 destination: the subscriber's MAC from the session row
    out = B_.scatter_be16_at_masked(out, zero, vals[:, PS_MAC_HI], ok)
    out = B_.scatter_be32_at_masked(out, zero + 2, vals[:, PS_MAC_LO], ok)
    if server_mac is not None:
        sm = u32(server_mac)
        out = B_.scatter_be16_at_masked(out, zero + 6, sm[0].expand(Bsz), ok)
        out = B_.scatter_be32_at_masked(out, zero + 8, sm[1].expand(Bsz), ok)
    out_len = torch.where(ok, (length + PPPOE_HDR) & MASK32, length)

    return PPPoEResult(out_pkt=out, out_len=out_len, done=ok,
                       punt=torch.zeros_like(ok), src_ip_hint=torch.zeros_like(length),
                       stats=_stats(pkt.device, encap=ok))


def qinq_push(pkt, length, s_tag, c_tag, gate):
    """Insert an 802.1ad S-tag and an 802.1Q C-tag after the MAC addresses."""
    L = pkt.shape[1]
    length = length.to(torch.int64)
    ok = gate & (((length + 8) & MASK32) <= L)
    z = torch.zeros_like(length)
    out = _shift_bytes(pkt, torch.where(ok, -8, 0), ok, z + 12)
    out = B_.scatter_be16_at_masked(out, z + 12, z + ETH_P_8021AD, ok)
    out = B_.scatter_be16_at_masked(out, z + 14, s_tag.to(torch.int64) & 0x0FFF, ok)
    out = B_.scatter_be16_at_masked(out, z + 16, z + ETH_P_8021Q, ok)
    out = B_.scatter_be16_at_masked(out, z + 18, c_tag.to(torch.int64) & 0x0FFF, ok)
    return out, torch.where(ok, (length + 8) & MASK32, length), ok


def qinq_pop(pkt, length, vlan_offset, gate):
    """Strip all VLAN tags (0/4/8 bytes) from gated lanes."""
    length = length.to(torch.int64)
    vo = vlan_offset.to(torch.int64)
    ok = gate & (vo > 0)
    out = _shift_bytes(pkt, torch.where(ok, vo, 0), ok, torch.full_like(vo, 12))
    return out, torch.where(ok, (length - vo) & MASK32, length), ok
