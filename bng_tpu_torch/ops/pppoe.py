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
(one K1 probe). Bytes move by one gather per op (`_shift_bytes`); decap's
ethertype is a masked select, encap's header and MACs are block writes
(`_write_block`). Lengths are int64 holding uint32 values and
are masked where the reference's uint32 arithmetic wraps.

A session row flagged `PSF_LINE` is bound to its subscriber's 802.1ad
access line (BBF TR-101 1:1 VLANs: an S-tag per access node, a C-tag per
line), the VIDs in `PS_S_TAG`/`PS_C_TAG`. Its upstream data decaps only
from that line (S- and C-tag VIDs equal to the row's; any other frame of
the session is a miss and punts) and loses the tags with the PPPoE
framing in the same shift: [eth][0x0800][IPv4...]. Its downstream data
gets the line's tags written before the PPPoE framing, in place of any
tags the frame came with: [eth][0x88a8 S][0x8100 C][0x8864]... Rows
without the flag give the bytes the unflagged layouts above give. The
line's work is counted in `line_stats` (`PSL_*`), beside the five
`PST_*` stats.
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
(PS_SESSION_ID, PS_MAC_HI, PS_MAC_LO, PS_IP, PS_FLAGS, PS_S_TAG, PS_C_TAG) = range(7)
PPPOE_WORDS = 8
PSF_LINE = 0x1  # PS_FLAGS: bound to the QinQ line in PS_S_TAG / PS_C_TAG

# stats
(PST_DECAP, PST_ENCAP, PST_CTRL_PUNT, PST_BAD, PST_MISS) = range(5)
PPPOE_NSTATS = 5
# line stats: lanes whose line tags were stripped (decap) or written
# (encap), and session data from another line than its row's (a miss)
(PSL_STRIPPED, PSL_WRITTEN, PSL_MISMATCH) = range(3)
PPPOE_LINE_NSTATS = 3
VID_MASK = 0x0FFF


class PPPoEResult(NamedTuple):
    out_pkt: torch.Tensor  # [B, L] uint8
    out_len: torch.Tensor  # [B] int64
    done: torch.Tensor  # [B] bool — lane rewritten by this op
    punt: torch.Tensor  # [B] bool — PPPoE control traffic for the host stack
    src_ip_hint: torch.Tensor  # [B] int64 session IP
    stats: torch.Tensor  # [PPPOE_NSTATS] int64 (uint32 values)
    line_stats: torch.Tensor | None = None  # [PPPOE_LINE_NSTATS] int64 (uint32 values)


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


def _counts(device, names, masks):
    """Lane counts by name, in `names` order (one stack: no host copy)."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return torch.stack([masks[n].sum() if n in masks else zero for n in names]) & MASK32


def _stats(device, **masks):
    """[PPPOE_NSTATS] lane counts by name."""
    return _counts(device, ("decap", "encap", "ctrl_punt", "bad", "miss"), masks)


def _line_stats(device, **masks):
    """[PPPOE_LINE_NSTATS] lane counts by name."""
    return _counts(device, ("stripped", "written", "mismatch"), masks)


def _be_bytes(fields) -> torch.Tensor:
    """[(values [B] int64, nbytes)] -> [B, sum(nbytes)] uint8, each value
    big-endian."""
    cols = [(v >> (8 * (n - 1 - k))) & 0xFF for v, n in fields for k in range(n)]
    return torch.stack(cols, dim=1).to(torch.uint8)


def _write_block(pkt, start, block, n, gate):
    """Write the first n[b] bytes of block[b] at column start[b] of each
    gated lane (one [B, L] gather from the block); columns past L are
    never written."""
    L, W = pkt.shape[1], block.shape[1]
    rel = torch.arange(L, device=pkt.device)[None, :] - start.to(torch.int64)[:, None]
    inside = gate[:, None] & (rel >= 0) & (rel < n.to(torch.int64)[:, None])
    return torch.where(inside, block.gather(1, rel.clamp(0, W - 1)), pkt)


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
    mac_ok = res.found & (vals[:, PS_MAC_HI] == src_mac_hi) & (vals[:, PS_MAC_LO] == src_mac_lo)
    # a line-bound row takes its session's frames from its own S/C tags only
    line = (vals[:, PS_FLAGS] & PSF_LINE) != 0
    on_line = ((vlan_offset == 8) & ((B_.be16_at(pkt, zero + 14) & VID_MASK) == vals[:, PS_S_TAG])
               & ((B_.be16_at(pkt, zero + 18) & VID_MASK) == vals[:, PS_C_TAG]))
    bound = mac_ok & (~line | on_line)
    ok = is_data & bound
    miss = is_data & ~bound  # unknown or foreign session, or another line -> punt
    strip = ok & line

    # the inner ethertype lands where the frame's was, or right after the
    # MACs when the line's tags go with the PPPoE framing
    head = torch.where(strip, 12, et_off)
    shift = torch.where(strip, PPPOE_HDR + vlan_offset.to(torch.int64), PPPOE_HDR)
    out = _shift_bytes(pkt, torch.where(ok, shift, 0), ok, head)
    inner_et = torch.where(ppp_proto == PPP_IPV4, ETH_P_IP, ETH_P_IPV6)
    out = B_.scatter_be16_at_masked(out, head, inner_et, ok)
    # L2 up to the ethertype + the IP bytes; Ethernet padding past plen drops
    out_len = torch.where(ok, head + plen, length)

    # disjoint buckets: a malformed frame counts only as BAD
    stats = _stats(pkt.device, decap=ok, ctrl_punt=is_disc | (well_formed & ~is_data),
                   bad=is_malformed, miss=miss)
    line_stats = _line_stats(pkt.device, stripped=strip,
                             mismatch=is_data & mac_ok & line & ~on_line)
    return PPPoEResult(out_pkt=out, out_len=out_len, done=ok, punt=is_ctrl | miss,
                       src_ip_hint=torch.where(ok, vals[:, PS_IP], 0), stats=stats,
                       line_stats=line_stats)


def pppoe_encap(pkt, length, vlan_offset, ethertype, dst_ip, by_ip: TableState,
                geom: TableGeom, server_mac) -> PPPoEResult:
    """Add PPPoE+PPP framing to downstream IPv4 data for PPPoE subscribers
    (and a line-bound session's S/C tags, see the module docstring).

    server_mac: [2] int32 words (hi16, lo32), the access concentrator's MAC
    written as the L2 source of every encapsulated frame; None declares
    the frames pre-stamped (no default, as in the reference)."""
    Bsz, L = pkt.shape
    length = length.to(torch.int64)
    vo = vlan_offset.to(torch.int64)
    et_off = 12 + vo

    res = lookup(by_ip, dst_ip[:, None], geom)
    vals = u32(res.vals)
    line = (vals[:, PS_FLAGS] & PSF_LINE) != 0
    # a line-bound lane's tags replace the frame's: its head block starts
    # right after the MACs and holds the 8 tag bytes before the framing
    head = torch.where(line, 12, et_off)
    grow = torch.where(line, 8 - vo, 0) + PPPOE_HDR
    out_len = (length + grow) & MASK32
    ok = (ethertype == ETH_P_IP) & res.found & (out_len <= L)

    out = _shift_bytes(pkt, torch.where(ok, -grow, 0), ok, head)
    zero = torch.zeros_like(et_off)
    framing = [(zero + ETH_PPPOE_SESSION, 2), (zero + 0x1100, 2), (vals[:, PS_SESSION_ID], 2),
               ((length - et_off) & MASK32, 2), (zero + PPP_IPV4, 2)]
    tags = [(zero + ETH_P_8021AD, 2), (vals[:, PS_S_TAG] & VID_MASK, 2),
            (zero + ETH_P_8021Q, 2), (vals[:, PS_C_TAG] & VID_MASK, 2)]
    block = torch.where(line[:, None], _be_bytes(tags + framing),
                        _be_bytes(framing + [(zero, 8)]))
    out = _write_block(out, head, block, torch.where(line, 18, 10), ok)
    # L2 destination: the subscriber's MAC from the session row; source: the AC's
    macs = [(vals[:, PS_MAC_HI], 2), (vals[:, PS_MAC_LO], 4)]
    if server_mac is not None:
        sm = u32(server_mac)
        macs += [(sm[0].expand(Bsz), 2), (sm[1].expand(Bsz), 4)]
    out = _write_block(out, zero, _be_bytes(macs), zero + (12 if server_mac is not None else 6),
                       ok)

    return PPPoEResult(out_pkt=out, out_len=torch.where(ok, out_len, length), done=ok,
                       punt=torch.zeros_like(ok), src_ip_hint=torch.zeros_like(length),
                       stats=_stats(pkt.device, encap=ok),
                       line_stats=_line_stats(pkt.device, written=ok & line))


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
