"""DHCP fast path: batched OFFER/ACK generation (port of `bng_tpu/ops/dhcp.py`).

Eligibility and message-type checks at fixed offsets, the VLAN ->
circuit-ID -> MAC lookup cascade (three K1 probes), the lease-expiry
check, and the canonical reply compose (segments concatenated once, the
options area assembled with two index gathers, VLAN tags re-inserted by
one shifting gather).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops import bytes as B_
from bng_tpu_torch.ops.checksum import ipv4_header_checksum
from bng_tpu_torch.ops.hashing import MASK32, u32
from bng_tpu_torch.ops.parse import Parsed
from bng_tpu_torch.ops.table import TableGeom, TableState, lookup

DHCP_SERVER_PORT = 67
DHCP_CLIENT_PORT = 68
DHCP_MAGIC = 0x63825363
BOOTREQUEST, BOOTREPLY = 1, 2
DISCOVER, OFFER, REQUEST, ACK = 1, 2, 3, 5
FLAG_BROADCAST = 0x8000

AV_POOL_ID, AV_IP, AV_VLAN, AV_CLASS, AV_LEASE_EXP, AV_FLAGS = range(6)
ASSIGN_WORDS = 8

PV_NETWORK, PV_PREFIX, PV_GATEWAY, PV_DNS1, PV_DNS2, PV_LEASE_T, PV_VALID = range(7)
POOL_WORDS = 8

SC_MAC_HI, SC_MAC_LO, SC_IP = range(3)
SERVER_WORDS = 4

(ST_TOTAL, ST_HIT, ST_MISS, ST_ERROR, ST_EXPIRED,
 ST_OPT82_PRESENT, ST_OPT82_ABSENT, ST_BCAST, ST_UCAST, ST_VLAN) = range(10)
NSTATS = 10

CID_KEY_LEN = 32
CID_WORDS = 8

_ETH, _IP, _UDP, _BOOTP = 14, 20, 8, 240
_OPT_HEAD = 27  # 53(3) + 54(6) + 51(6) + 1(6) + 3(6)
_OPT_DNS_MAX = 10
_OPT_TAIL = 13  # 58(6) + 59(6) + 255(1)
_OPT_MAX = _OPT_HEAD + _OPT_DNS_MAX + _OPT_TAIL
CANON_LEN = _ETH + _IP + _UDP + _BOOTP + _OPT_MAX  # 332


class DHCPTables(NamedTuple):
    sub: TableState  # key [mac_hi, mac_lo] -> assignment
    vlan: TableState  # key [s_tag<<16|c_tag] -> assignment
    cid: TableState  # key 8 words (32 B circuit-id) -> assignment
    pools: torch.Tensor  # [P, POOL_WORDS] int32 words
    server: torch.Tensor  # [SERVER_WORDS] int32 words


class DHCPGeom(NamedTuple):
    sub: TableGeom
    vlan: TableGeom
    cid: TableGeom


class DHCPResult(NamedTuple):
    is_reply: torch.Tensor  # [B] bool — answered on device (TX)
    is_dhcp: torch.Tensor  # [B] bool — a DHCP request (reply or slow path)
    out_pkt: torch.Tensor  # [B, L] uint8 reply bytes (valid where is_reply)
    out_len: torch.Tensor  # [B] int64
    stats: torch.Tensor  # [NSTATS] int64 (uint32 values)


def _extract_msg_type(pkt, opts_off, opts_in_bounds):
    """Fixed-offset option-53 scan (offsets 0, 1, 3, 4, 5, 6 in order)."""
    found = torch.zeros_like(opts_in_bounds)
    mtype = torch.zeros((pkt.shape[0],), dtype=torch.int64, device=pkt.device)
    for o in (0, 1, 3, 4, 5, 6):
        ok = (B_.u8_at(pkt, opts_off + o) == 53) & (B_.u8_at(pkt, opts_off + o + 1) == 1)
        take = ok & ~found & opts_in_bounds
        mtype = torch.where(take, B_.u8_at(pkt, opts_off + o + 2), mtype)
        found = found | take
    return torch.where(opts_in_bounds, mtype, 0)


def _extract_circuit_id(pkt, opts_off, length):
    """Fixed-position option-82 circuit-ID: (found [B], cid [B, 32] uint8)."""
    Bsz = pkt.shape[0]
    dev = pkt.device
    scan_ok = (opts_off + 64) <= length
    found = torch.zeros((Bsz,), dtype=torch.bool, device=dev)
    cid = torch.zeros((Bsz, CID_KEY_LEN), dtype=torch.uint8, device=dev)
    cols = torch.arange(CID_KEY_LEN, device=dev)[None, :]

    def try_pos(found, cid, tag_off, len_off, sub_off, cidlen_off, cid_off, extra_ok):
        tag = B_.u8_at(pkt, opts_off + tag_off)
        o82len = B_.u8_at(pkt, opts_off + len_off)
        sub1 = B_.u8_at(pkt, opts_off + sub_off)
        cl = B_.u8_at(pkt, opts_off + cidlen_off)
        in_b = (opts_off + cid_off + cl) <= length
        ok = (scan_ok & extra_ok & (tag == 82) & (o82len >= 4) & (sub1 == 1)
              & (cl > 0) & (cl <= CID_KEY_LEN) & in_b & ~found)
        raw = B_.bytes_at(pkt, opts_off + cid_off, CID_KEY_LEN)
        cand = torch.where(cols < cl[:, None], raw, torch.zeros_like(raw))
        cid = torch.where(ok[:, None], cand, cid)
        return found | ok, cid

    o82len_a = B_.u8_at(pkt, opts_off + 4)
    a_extra = (opts_off + 5 + o82len_a) <= length
    found, cid = try_pos(found, cid, 3, 4, 5, 6, 7, a_extra)
    for p in range(12, 20):
        p_extra = (opts_off + p + 8) <= length
        found, cid = try_pos(found, cid, p, p + 1, p + 2, p + 3, p + 4, p_extra)
    return found, cid


def pack_cid_words(cid_bytes):
    """[B, 32] uint8 -> [B, 8] int64 big-endian words (table key form)."""
    b = cid_bytes.to(torch.int64).view(cid_bytes.shape[0], CID_WORDS, 4)
    return (b[:, :, 0] << 24) | (b[:, :, 1] << 16) | (b[:, :, 2] << 8) | b[:, :, 3]


def _prefix_to_mask(plen):
    """CIDR prefix -> netmask, shifting in two halves (plen 0 -> 0).
    The reference reads plen as int32 here."""
    sh = (32 - plen.to(torch.int32).to(torch.int64)).clamp(0, 32)
    sh1 = torch.minimum(sh, torch.full_like(sh, 16))
    sh2 = sh - sh1
    return ((MASK32 << sh1) << sh2) & MASK32


def dhcp_fastpath(pkt, length, parsed: Parsed, tables: DHCPTables, geom: DHCPGeom,
                  now_s) -> DHCPResult:
    """now_s: int64 scalar tensor (uint32 seconds)."""
    Bsz, L = pkt.shape
    dev = pkt.device
    length = length.to(torch.int64)
    stats = torch.zeros((NSTATS,), dtype=torch.int64, device=dev)

    dhcp_off = parsed.l4_off + _UDP
    is_dhcp_port = parsed.is_udp & (parsed.dst_port == DHCP_SERVER_PORT)
    hdr_in_bounds = (dhcp_off + _BOOTP) <= length
    base = is_dhcp_port & hdr_in_bounds
    op = B_.u8_at(pkt, dhcp_off)
    magic = B_.be32_at(pkt, dhcp_off + 236)
    base = base & (op == BOOTREQUEST) & (magic == DHCP_MAGIC)

    stats[ST_VLAN] += (parsed.is_vlan & (length > 0)).sum()
    stats[ST_TOTAL] += base.sum()

    opts_off = dhcp_off + 240
    opts_in_bounds = (opts_off + 12) <= length
    mtype = _extract_msg_type(pkt, opts_off, opts_in_bounds & base)
    is_fast_type = (mtype == DISCOVER) | (mtype == REQUEST)
    stats[ST_MISS] += (base & ~is_fast_type).sum()
    elig = base & is_fast_type

    # lookup cascade: VLAN -> circuit-ID -> MAC
    vlan_key = ((parsed.s_tag << 16) | parsed.c_tag)[:, None]
    vlan_res = lookup(tables.vlan, vlan_key, geom.vlan)
    vlan_hit = vlan_res.found & parsed.is_vlan & elig

    cid_found, cid_bytes = _extract_circuit_id(pkt, opts_off, length)
    cid_res = lookup(tables.cid, pack_cid_words(cid_bytes), geom.cid)
    cid_hit = cid_res.found & cid_found & elig & ~vlan_hit

    mac_hi = B_.be16_at(pkt, dhcp_off + 28)
    mac_lo = B_.be32_at(pkt, dhcp_off + 30)
    mac_res = lookup(tables.sub, torch.stack([mac_hi, mac_lo], dim=1), geom.sub)
    mac_hit = mac_res.found & elig & ~vlan_hit & ~cid_hit

    stats[ST_OPT82_PRESENT] += cid_hit.sum()

    hit = vlan_hit | cid_hit | mac_hit
    assign = u32(torch.where(vlan_hit[:, None], vlan_res.vals,
                             torch.where(cid_hit[:, None], cid_res.vals, mac_res.vals)))
    stats[ST_MISS] += (elig & ~hit).sum()

    expired = hit & (now_s > assign[:, AV_LEASE_EXP])
    stats[ST_EXPIRED] += expired.sum()
    live = hit & ~expired

    pools = u32(tables.pools)
    P = pools.shape[0]
    pool_id = assign[:, AV_POOL_ID]
    pool_ok_idx = pool_id < P
    pool_row = pools[pool_id.clamp(max=P - 1)]
    pool_valid = pool_ok_idx & (pool_row[:, PV_VALID] != 0)
    stats[ST_ERROR] += (live & ~pool_valid).sum()
    reply = live & pool_valid
    stats[ST_HIT] += reply.sum()

    server = u32(tables.server)
    gateway = pool_row[:, PV_GATEWAY]
    cfg_server_ip = server[SC_IP]
    server_ip = torch.where(cfg_server_ip != 0, cfg_server_ip, gateway)
    reply_type = torch.where(mtype == DISCOVER, OFFER, ACK)

    xid_b = B_.bytes_at(pkt, dhcp_off + 4, 4)
    secs_b = B_.bytes_at(pkt, dhcp_off + 8, 2)
    flags = B_.be16_at(pkt, dhcp_off + 10)
    ciaddr = B_.be32_at(pkt, dhcp_off + 12)
    giaddr = B_.be32_at(pkt, dhcp_off + 24)
    chaddr_b = B_.bytes_at(pkt, dhcp_off + 28, 16)
    giaddr_b = B_.bytes_at(pkt, dhcp_off + 24, 4)

    relayed = giaddr != 0
    use_bcast = (~relayed) & (((flags & FLAG_BROADCAST) != 0) | (ciaddr == 0))
    stats[ST_BCAST] += (reply & use_bcast).sum()
    stats[ST_UCAST] += (reply & ~use_bcast).sum()

    req_src = B_.bytes_at(pkt, torch.zeros_like(dhcp_off) + 6, 6)
    bcast_mac = torch.full((Bsz, 6), 0xFF, dtype=torch.uint8, device=dev)
    dst_mac = torch.where(relayed[:, None], req_src,
                          torch.where(use_bcast[:, None], bcast_mac, chaddr_b[:, :6]))

    ip_dst = torch.where(relayed, giaddr, MASK32)
    udp_dst = torch.where(relayed, DHCP_SERVER_PORT, DHCP_CLIENT_PORT)

    dns1 = pool_row[:, PV_DNS1]
    dns2 = pool_row[:, PV_DNS2]
    dns_sz = torch.where(dns1 == 0, 0, torch.where(dns2 == 0, 6, 10))
    opt_len = _OPT_HEAD + dns_sz + _OPT_TAIL
    lease_t = pool_row[:, PV_LEASE_T]
    t1 = lease_t // 2
    t2 = ((lease_t * 7) & MASK32) // 8
    mask32 = _prefix_to_mask(pool_row[:, PV_PREFIX])

    dhcp_len = _BOOTP + opt_len
    udp_len = 8 + dhcp_len
    ip_len = 20 + udp_len
    canon_total = 14 + ip_len
    out_len = canon_total + parsed.vlan_offset

    zeros = torch.zeros((Bsz,), dtype=torch.int64, device=dev)
    ip_csum = ipv4_header_checksum([
        zeros + 0x4500, ip_len, zeros, zeros, zeros + ((64 << 8) | 17), zeros,
        server_ip >> 16, server_ip & 0xFFFF, ip_dst >> 16, ip_dst & 0xFFFF,
    ])

    def const(*vals):
        return B_.const_seg(Bsz, *vals, device=dev)

    canon = torch.cat([
        dst_mac,
        B_.be16_seg(zeros + server[SC_MAC_HI]),
        B_.be32_seg(zeros + server[SC_MAC_LO]),
        const(0x08, 0x00),
        const(0x45, 0x00),
        B_.be16_seg(ip_len),
        const(0, 0, 0, 0, 64, 17),
        B_.be16_seg(ip_csum),
        B_.be32_seg(server_ip),
        B_.be32_seg(ip_dst),
        const(0, DHCP_SERVER_PORT),
        B_.be16_seg(udp_dst),
        B_.be16_seg(udp_len),
        const(0, 0),
        const(BOOTREPLY, 1, 6, 0),
        xid_b,
        secs_b,
        B_.be16_seg(flags),
        B_.be32_seg(ciaddr),
        B_.be32_seg(assign[:, AV_IP]),
        B_.be32_seg(server_ip),
        giaddr_b,
        chaddr_b,
        torch.zeros((Bsz, 192), dtype=torch.uint8, device=dev),
        B_.be32_seg(zeros + DHCP_MAGIC),
    ], dim=1)

    head = torch.cat([
        const(53, 1), B_.u8_seg(reply_type),
        const(54, 4), B_.be32_seg(server_ip),
        const(51, 4), B_.be32_seg(lease_t),
        const(1, 4), B_.be32_seg(mask32),
        const(3, 4), B_.be32_seg(gateway),
    ], dim=1)
    dns = torch.cat([
        const(6), B_.u8_seg(torch.where(dns2 == 0, 4, 8)),
        B_.be32_seg(dns1), B_.be32_seg(dns2),
    ], dim=1)
    tail = torch.cat([
        const(58, 4), B_.be32_seg(t1),
        const(59, 4), B_.be32_seg(t2),
        const(255),
    ], dim=1)

    oj = torch.arange(_OPT_MAX, device=dev)[None, :]
    head_p = torch.zeros((Bsz, _OPT_MAX), dtype=torch.uint8, device=dev)
    head_p[:, :_OPT_HEAD] = head
    dns_idx = (oj - _OPT_HEAD).clamp(0, _OPT_DNS_MAX - 1).expand(Bsz, _OPT_MAX)
    tail_idx = (oj - _OPT_HEAD - dns_sz[:, None]).clamp(0, _OPT_TAIL - 1)
    dns_g = dns.gather(1, dns_idx)
    tail_g = tail.gather(1, tail_idx)
    opt_area = torch.where(
        oj < _OPT_HEAD, head_p,
        torch.where(oj < (_OPT_HEAD + dns_sz[:, None]), dns_g,
                    torch.where(oj < opt_len[:, None], tail_g, torch.zeros_like(tail_g))))
    canon = torch.cat([canon, opt_area], dim=1)

    canon_L = torch.zeros((Bsz, L), dtype=torch.uint8, device=dev)
    canon_L[:, :CANON_LEN] = canon
    jj = torch.arange(L, device=dev)[None, :]
    vo = parsed.vlan_offset[:, None]
    canon_shift = canon_L.gather(1, (jj - vo).clamp(0, L - 1))
    out = torch.where(jj < 12, canon_L, torch.where(jj < 14 + vo, pkt, canon_shift))
    out = torch.where(jj < out_len[:, None], out, torch.zeros_like(out))

    return DHCPResult(
        is_reply=reply,
        is_dhcp=base,
        out_pkt=out,
        out_len=torch.where(reply, out_len, 0),
        stats=stats & MASK32,
    )
