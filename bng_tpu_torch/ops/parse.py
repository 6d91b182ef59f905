"""Batched header parsing: Eth -> [802.1ad/802.1Q] -> IPv4 -> L4
(port of `bng_tpu/ops/parse.py`).

Every lane is parsed unconditionally and validity is carried in boolean
flags. IPs and ports come back as host-order int64 values; offsets as
int64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops.bytes import be16_at, be32_at, u8_at

ETH_P_IP = 0x0800
ETH_P_IPV6 = 0x86DD
ETH_P_8021Q = 0x8100
ETH_P_8021AD = 0x88A8

PROTO_ICMP = 1
PROTO_TCP = 6
PROTO_UDP = 17


class Parsed(NamedTuple):
    """Structure-of-arrays parse result; all fields [B]."""

    dst_mac_hi: torch.Tensor
    dst_mac_lo: torch.Tensor
    src_mac_hi: torch.Tensor
    src_mac_lo: torch.Tensor
    ethertype: torch.Tensor
    is_vlan: torch.Tensor
    is_qinq: torch.Tensor
    s_tag: torch.Tensor
    c_tag: torch.Tensor
    vlan_offset: torch.Tensor
    is_ipv4: torch.Tensor
    is_ipv6: torch.Tensor
    l3_off: torch.Tensor
    ihl_bytes: torch.Tensor
    total_len: torch.Tensor
    ttl: torch.Tensor
    proto: torch.Tensor
    src_ip: torch.Tensor
    dst_ip: torch.Tensor
    l4_off: torch.Tensor
    is_udp: torch.Tensor
    is_tcp: torch.Tensor
    is_icmp: torch.Tensor
    src_port: torch.Tensor
    dst_port: torch.Tensor
    tcp_flags: torch.Tensor


def mac_words_at(pkt, off):
    """6 bytes at per-lane offset -> (hi16, lo32)."""
    return be16_at(pkt, off), be32_at(pkt, off + 2)


def eth_vlan(pkt):
    """VLAN peel only: per-lane (vlan_offset, inner ethertype)."""
    zero = torch.zeros((pkt.shape[0],), dtype=torch.int64, device=pkt.device)
    et0 = be16_at(pkt, zero + 12)
    outer_tagged = (et0 == ETH_P_8021Q) | (et0 == ETH_P_8021AD)
    et1 = be16_at(pkt, zero + 16)
    inner_tagged = outer_tagged & (et1 == ETH_P_8021Q)
    et2 = be16_at(pkt, zero + 20)
    vlan_offset = torch.where(inner_tagged, 8, torch.where(outer_tagged, 4, 0))
    ethertype = torch.where(inner_tagged, et2, torch.where(outer_tagged, et1, et0))
    return vlan_offset, ethertype


def parse_batch(pkt, length) -> Parsed:
    """Parse [B, L] uint8 packets with [B] lengths."""
    B = pkt.shape[0]
    zero = torch.zeros((B,), dtype=torch.int64, device=pkt.device)
    length = length.to(torch.int64)

    dst_mac_hi, dst_mac_lo = mac_words_at(pkt, zero)
    src_mac_hi, src_mac_lo = mac_words_at(pkt, zero + 6)

    et0 = be16_at(pkt, zero + 12)
    outer_tagged = (et0 == ETH_P_8021Q) | (et0 == ETH_P_8021AD)
    outer_vid = be16_at(pkt, zero + 14) & 0x0FFF
    et1 = be16_at(pkt, zero + 16)
    inner_tagged = outer_tagged & (et1 == ETH_P_8021Q)
    inner_vid = be16_at(pkt, zero + 18) & 0x0FFF
    et2 = be16_at(pkt, zero + 20)

    is_qinq = inner_tagged
    is_vlan = outer_tagged
    vlan_offset = torch.where(is_qinq, 8, torch.where(is_vlan, 4, 0))
    ethertype = torch.where(is_qinq, et2, torch.where(is_vlan, et1, et0))
    s_tag = torch.where(is_vlan, outer_vid, 0)
    c_tag = torch.where(is_qinq, inner_vid, 0)

    l3_off = 14 + vlan_offset

    ver_ihl = u8_at(pkt, l3_off)
    ihl = (ver_ihl & 0x0F) * 4
    version = ver_ihl >> 4
    total_len = be16_at(pkt, l3_off + 2)
    ttl = u8_at(pkt, l3_off + 8)
    proto = u8_at(pkt, l3_off + 9)
    src_ip = be32_at(pkt, l3_off + 12)
    dst_ip = be32_at(pkt, l3_off + 16)

    is_ipv4 = ((ethertype == ETH_P_IP) & (version == 4) & (ihl >= 20)
               & ((l3_off + 20) <= length))
    is_ipv6 = (ethertype == ETH_P_IPV6) & ((l3_off + 40) <= length)

    l4_off = l3_off + ihl
    l4_in_bounds = (l4_off + 8) <= length
    is_udp = is_ipv4 & (proto == PROTO_UDP) & l4_in_bounds
    is_tcp = is_ipv4 & (proto == PROTO_TCP) & ((l4_off + 20) <= length)
    is_icmp = is_ipv4 & (proto == PROTO_ICMP) & l4_in_bounds

    sp = be16_at(pkt, l4_off)
    dp = be16_at(pkt, l4_off + 2)
    icmp_id = be16_at(pkt, l4_off + 4)
    src_port = torch.where(is_icmp, icmp_id, torch.where(is_udp | is_tcp, sp, 0))
    dst_port = torch.where(is_icmp, icmp_id, torch.where(is_udp | is_tcp, dp, 0))
    tcp_flags = torch.where(is_tcp, u8_at(pkt, l4_off + 13), 0)

    return Parsed(
        dst_mac_hi=dst_mac_hi, dst_mac_lo=dst_mac_lo,
        src_mac_hi=src_mac_hi, src_mac_lo=src_mac_lo,
        ethertype=ethertype, is_vlan=is_vlan, is_qinq=is_qinq,
        s_tag=s_tag, c_tag=c_tag, vlan_offset=vlan_offset,
        is_ipv4=is_ipv4, is_ipv6=is_ipv6, l3_off=l3_off, ihl_bytes=ihl,
        total_len=total_len, ttl=ttl, proto=proto, src_ip=src_ip, dst_ip=dst_ip,
        l4_off=l4_off, is_udp=is_udp, is_tcp=is_tcp, is_icmp=is_icmp,
        src_port=src_port, dst_port=dst_port, tcp_flags=tcp_flags,
    )
