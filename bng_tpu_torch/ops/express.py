"""Express OFFER path: the host admission parse and the minimal device
program (port of `bng_tpu/ops/express.py`).

The DHCP-only program (`ops/dhcp.py`) parses [B, L] frames on the device
and composes every reply byte. The express lane splits that work:

- **Admission (host, once per frame):** `parse_express` extracts the
  descriptor: the columns the probe cascade needs (MAC key words, VLAN
  key, circuit-ID key words, eligibility flags) and the host-only fields
  (xid, message type, offsets). Its checks are those of `parse_batch` and
  `dhcp_fastpath`, bit for bit: a frame it refuses is one the device
  program would have PASSed.
- **Device (`express_verdicts`):** the VLAN -> circuit-ID -> MAC cascade
  (three K1 probes, at K = 1, 8 and 2), the lease-expiry and
  pool-validity selects, and a [B, XD_WORDS] verdict block (verdict,
  yiaddr, pool id, lease seconds) written over the descriptor's lead
  columns. No packet byte enters or leaves the program, and it makes no
  host round trip, so the engine can capture it in a CUDA graph.
- **Retire (host):** the block selects a preassembled
  `ExpressWireTemplate` (`control/dhcp_codec.py`) and patches the
  per-client words, byte-identical to the `dhcp_fastpath` compose.

Stats use the `ops/dhcp.py` counter indices, as int64 in [0, 2^32).
Wrong-type frames never reach the device here (admission refuses them),
so they are absent from ST_MISS; the express lane never answers them.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from bng_tpu_torch.ops.dhcp import (
    AV_IP, AV_LEASE_EXP, AV_POOL_ID, CID_KEY_LEN, DHCP_MAGIC, DISCOVER, PV_LEASE_T,
    PV_VALID, REQUEST, DHCPGeom, DHCPTables,
)
from bng_tpu_torch.ops.hashing import u32
from bng_tpu_torch.ops.table import lookup

# ---- descriptor layout: one [XD_WORDS] word row per express frame ----
# Columns 0..3 double as the verdict block on the way back.
XD_FLAGS = 0  # XF_* eligibility bits
XD_MAC_HI = 1  # chaddr hi16 (table key word 0)
XD_MAC_LO = 2  # chaddr lo32 (table key word 1)
XD_VLAN = 3  # s_tag<<16 | c_tag (vlan table key)
XD_XID = 4  # host-only: request xid
XD_MSG = 5  # host-only: DHCP message type
XD_CID0 = 8  # 8 big-endian words of the 32-byte circuit-id key
XD_WORDS = 16

# verdict block columns (over XD_FLAGS..XD_VLAN)
VB_VERDICT = 0  # 1 = answered on the device (the host patches a template)
VB_YIADDR = 1
VB_POOL = 2  # pool id (template selection)
VB_LEASE_T = 3  # the pool's lease seconds, as the device read them

XF_VALID = 1  # an eligible DISCOVER/REQUEST (probe it)
XF_VLAN = 2  # VLAN-tagged (the vlan tier may answer)
XF_CID = 4  # option-82 circuit-id extracted (the cid tier may answer)
XF_BCAST = 8  # the reply broadcasts (ST_BCAST / ST_UCAST)
XF_RELAYED = 16  # giaddr != 0 (host-side addressing)


class ExpressDesc(NamedTuple):
    """One admitted express frame: its device row and host patch-in fields."""

    words: np.ndarray  # [XD_WORDS] uint32 (the device descriptor row)
    vlan_off: int  # 0 / 4 / 8: the reply copies frame[12:14+vlan_off]
    dhcp_off: int  # BOOTP payload offset in the frame
    msg_type: int  # DISCOVER or REQUEST
    relayed: bool  # giaddr != 0: unicast to giaddr, UDP dst 67
    use_bcast: bool  # L2/L3 broadcast reply


class ExpressResult(NamedTuple):
    """Device outputs of one express dispatch."""

    block: torch.Tensor  # [B, XD_WORDS] int32 words; cols VB_* are the verdict
    stats: torch.Tensor  # [NSTATS] int64 batch deltas (ops/dhcp indices)


def _u16(frame: bytes, off: int) -> int:
    return (frame[off] << 8) | frame[off + 1]


def parse_express(frame: bytes) -> ExpressDesc | None:
    """Host admission parse: frame -> descriptor, or None when the device
    program would not have answered it (the frame then takes the slow
    path unchanged). The VLAN peel is parse_batch's (outer 0x8100/0x88A8,
    inner 0x8100 only); the bounds checks, the fixed-offset option-53 scan
    ({0,1,3,4,5,6}, first match) and the fixed-position option-82 scan
    (position A, then 12..19) are dhcp_fastpath's."""
    L = len(frame)
    if L < 34:
        return None
    et = _u16(frame, 12)
    vlan_off, s_tag, c_tag = 0, 0, 0
    tagged = et in (0x8100, 0x88A8)
    if tagged:
        if L < 18:
            return None
        s_tag = _u16(frame, 14) & 0x0FFF
        et1 = _u16(frame, 16)
        if et1 == 0x8100:  # QinQ: the inner tag must be 802.1Q
            if L < 22:
                return None
            c_tag = _u16(frame, 18) & 0x0FFF
            vlan_off, et = 8, _u16(frame, 20)
        else:
            vlan_off, et = 4, et1
    l3 = 14 + vlan_off
    if et != 0x0800 or L < l3 + 20 or (frame[l3] >> 4) != 4:
        return None
    ihl = (frame[l3] & 0x0F) * 4
    if ihl < 20 or frame[l3 + 9] != 17:
        return None
    l4 = l3 + ihl
    if L < l4 + 8 or _u16(frame, l4 + 2) != 67:
        return None
    dhcp_off = l4 + 8
    if (L < dhcp_off + 240 or frame[dhcp_off] != 1
            or int.from_bytes(frame[dhcp_off + 236: dhcp_off + 240], "big") != DHCP_MAGIC):
        return None

    opts = dhcp_off + 240
    mtype = 0
    if opts + 12 <= L:
        for o in (0, 1, 3, 4, 5, 6):
            if frame[opts + o] == 53 and frame[opts + o + 1] == 1:
                mtype = frame[opts + o + 2]
                break
    if mtype not in (DISCOVER, REQUEST):
        return None

    cid = b""
    if opts + 64 <= L:
        o82len_a = frame[opts + 4]
        positions = [(3, 4, 5, 6, 7, opts + 5 + o82len_a <= L)]
        positions += [(p, p + 1, p + 2, p + 3, p + 4, opts + p + 8 <= L) for p in range(12, 20)]
        for tag_o, len_o, sub_o, cl_o, cid_o, extra_ok in positions:
            cl = frame[opts + cl_o]
            if (extra_ok and frame[opts + tag_o] == 82 and frame[opts + len_o] >= 4
                    and frame[opts + sub_o] == 1 and 0 < cl <= CID_KEY_LEN
                    and opts + cid_o + cl <= L):
                cid = frame[opts + cid_o: opts + cid_o + cl]
                break

    xid, _secs, flags16 = struct.unpack_from("!IHH", frame, dhcp_off + 4)
    ciaddr, = struct.unpack_from("!I", frame, dhcp_off + 12)
    giaddr, = struct.unpack_from("!I", frame, dhcp_off + 24)
    relayed = giaddr != 0
    use_bcast = (not relayed) and ((flags16 & 0x8000) != 0 or ciaddr == 0)

    w = np.zeros((XD_WORDS,), dtype=np.uint32)
    fl = XF_VALID
    if tagged:
        fl |= XF_VLAN
    if cid:
        fl |= XF_CID
    if use_bcast:
        fl |= XF_BCAST
    if relayed:
        fl |= XF_RELAYED
    w[XD_FLAGS] = fl
    w[XD_MAC_HI] = _u16(frame, dhcp_off + 28)
    w[XD_MAC_LO] = int.from_bytes(frame[dhcp_off + 30: dhcp_off + 34], "big")
    w[XD_VLAN] = (s_tag << 16) | c_tag
    w[XD_XID] = xid
    w[XD_MSG] = mtype
    if cid:
        buf = (cid + b"\x00" * CID_KEY_LEN)[:CID_KEY_LEN]
        w[XD_CID0: XD_CID0 + 8] = np.frombuffer(buf, dtype=">u4")
    return ExpressDesc(words=w, vlan_off=vlan_off, dhcp_off=dhcp_off, msg_type=mtype,
                       relayed=relayed, use_bcast=use_bcast)


def express_verdicts(tables: DHCPTables, desc: torch.Tensor, geom: DHCPGeom,
                     now_s: torch.Tensor) -> ExpressResult:
    """The express device program: probe cascade and verdict block.

    desc: [B, XD_WORDS] int32 words; now_s: int64 scalar tensor (uint32
    seconds). The same resolution as `dhcp_fastpath` (VLAN -> circuit-ID
    -> MAC, lease expiry against now_s, pool validity) over descriptor
    columns instead of frames."""
    flags = u32(desc[:, XD_FLAGS])
    valid = (flags & XF_VALID) != 0
    vlan_flag = (flags & XF_VLAN) != 0

    vlan_res = lookup(tables.vlan, desc[:, XD_VLAN: XD_VLAN + 1], geom.vlan)
    vlan_hit = vlan_res.found & vlan_flag & valid
    cid_res = lookup(tables.cid, desc[:, XD_CID0: XD_CID0 + 8], geom.cid)
    cid_hit = cid_res.found & ((flags & XF_CID) != 0) & valid & ~vlan_hit
    mac_res = lookup(tables.sub, desc[:, XD_MAC_HI: XD_MAC_HI + 2], geom.sub)
    mac_hit = mac_res.found & valid & ~vlan_hit & ~cid_hit
    hit = vlan_hit | cid_hit | mac_hit
    assign = u32(torch.where(vlan_hit[:, None], vlan_res.vals,
                             torch.where(cid_hit[:, None], cid_res.vals, mac_res.vals)))

    expired = hit & (now_s > assign[:, AV_LEASE_EXP])
    live = hit & ~expired
    pools = u32(tables.pools)
    P = pools.shape[0]
    pool_id = assign[:, AV_POOL_ID]
    pool_row = pools[pool_id.clamp(max=P - 1)]
    pool_valid = (pool_id < P) & (pool_row[:, PV_VALID] != 0)
    reply = live & pool_valid

    bcast = (flags & XF_BCAST) != 0
    # one column per ops/dhcp counter, in ST_* order (ST_OPT82_ABSENT is
    # not counted on this program)
    counted = torch.stack([valid, reply, valid & ~hit, live & ~pool_valid, expired, cid_hit,
                           torch.zeros_like(valid), reply & bcast, reply & ~bcast,
                           valid & vlan_flag], dim=1)
    stats = counted.sum(dim=0)

    block = desc.clone()
    block[:, VB_VERDICT] = reply.to(torch.int32)
    block[:, VB_YIADDR] = torch.where(reply, assign[:, AV_IP], 0).to(torch.int32)
    block[:, VB_POOL] = torch.where(reply, pool_id, 0).to(torch.int32)
    block[:, VB_LEASE_T] = torch.where(reply, pool_row[:, PV_LEASE_T], 0).to(torch.int32)
    return ExpressResult(block=block, stats=stats)
