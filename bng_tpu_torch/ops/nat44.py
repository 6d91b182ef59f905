"""NAT44/CGNAT: batched SNAT (egress) + DNAT (ingress)
(port of `bng_tpu/ops/nat44.py`).

Established flows translate on the device from the `sessions` / `reverse`
cuckoo tables (four K1 probes per batch: sub_nat, sessions, reverse,
sessions again); a session miss is punted to the host NAT manager, which
inserts the rows so the flow is device-resident from its next packet.

`nat44_update_sessions` writes the session counters, last_seen and TCP
state IN PLACE into the device value rows (the JAX step returns a new
array from a donated scatter). Its three scatters keep the reference's
drop-mode semantics without a host sync: the add parks skipped lanes on
row 0 with a zero addend, the set parks them on a written target with
that target's value (`table.scatter_set_drop`), and the max parks them
on row 0 with the smallest int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.ops import bytes as B_
from bng_tpu_torch.ops.checksum import csum_update16, csum_update32
from bng_tpu_torch.ops.hashing import MASK32, u32
from bng_tpu_torch.ops.parse import Parsed
from bng_tpu_torch.ops.table import TableGeom, TableState, lookup, scatter_set_drop

(SV_NAT_IP, SV_NAT_PORT, SV_ORIG_IP, SV_ORIG_PORT, SV_DEST_IP, SV_DEST_PORT,
 SV_CREATED, SV_LAST_SEEN, SV_STATE, SV_PROTO, SV_FLAGS,
 SV_PKTS_OUT, SV_PKTS_IN, SV_BYTES_OUT, SV_BYTES_IN) = range(15)
SESSION_WORDS = 16
REVERSE_WORDS = 8

(BV_PUBLIC_IP, BV_PORT_START, BV_PORT_END, BV_NEXT_PORT, BV_IN_USE,
 BV_SUB_ID, BV_FLAGS) = range(7)
SUBNAT_WORDS = 8

NAT_STATE_NEW, NAT_STATE_ESTABLISHED, NAT_STATE_FIN_WAIT, NAT_STATE_CLOSING, NAT_STATE_TIME_WAIT = range(5)

FLAG_EIM, FLAG_EIF, FLAG_HAIRPIN, FLAG_ALG_FTP, FLAG_ALG_SIP, FLAG_PORT_PARITY, FLAG_PORT_CONTIG = (
    0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40)

(NST_SNAT, NST_DNAT, NST_HAIRPIN, NST_DROPPED, NST_PASSED, NST_CREATED,
 NST_EXPIRED, NST_PORT_EXH, NST_EIM_HIT, NST_EIM_MISS, NST_ALG) = range(11)
NAT_NSTATS = 11


class NATTables(NamedTuple):
    sessions: TableState  # K=4, V=SESSION_WORDS
    reverse: TableState  # K=4, V=8 (original key words + pad)
    sub_nat: TableState  # K=1, V=SUBNAT_WORDS
    hairpin_ips: torch.Tensor  # [H] int32 words (0 = empty)
    alg_ports: torch.Tensor  # [A] int32 words (port<<16|proto; 0 = empty)
    config: torch.Tensor  # [4] int32 words: flags, port_start, port_end, ports_per_sub


class NATGeom(NamedTuple):
    sessions: TableGeom
    reverse: TableGeom
    sub_nat: TableGeom


class NATResult(NamedTuple):
    translated: torch.Tensor  # [B] bool
    punted: torch.Tensor  # [B] bool — new flow / ALG: needs the host
    dropped: torch.Tensor  # [B] bool
    out_pkt: torch.Tensor  # [B, L] uint8 rewritten packets
    stats: torch.Tensor  # [NAT_NSTATS] int64 (uint32 values)
    is_hairpin: torch.Tensor
    egress_hit: torch.Tensor
    ingress_hit: torch.Tensor
    e_slot: torch.Tensor  # [B] int64 session row of egress hits
    i_slot: torch.Tensor  # [B] int64 session row of ingress hits
    i_state: torch.Tensor  # [B] int64 current TCP state (ingress rows)


def is_private_ip(ip):
    """RFC1918 + 100.64/10."""
    o1 = ip >> 24
    o2 = (ip >> 16) & 0xFF
    return ((o1 == 10) | ((o1 == 172) & (o2 >= 16) & (o2 <= 31))
            | ((o1 == 192) & (o2 == 168)) | ((o1 == 100) & (o2 >= 64) & (o2 <= 127)))


def _in_set(values, dense_set):
    """[B] membership in a small dense set of words (0 = empty)."""
    s = u32(dense_set)
    return ((values[:, None] == s[None, :]) & (s[None, :] != 0)).any(dim=1)


def _session_key(a_ip, b_ip, a_port, b_port, proto):
    return torch.stack([a_ip, b_ip, ((a_port & 0xFFFF) << 16) | (b_port & 0xFFFF), proto], dim=1)


def _rewrite_l3_l4(pkt, parsed, mask, new_ip, new_port, is_src: bool):
    """SNAT (is_src) or DNAT rewrite with incremental checksums."""
    ip_field_off = parsed.l3_off + (12 if is_src else 16)
    old_ip = parsed.src_ip if is_src else parsed.dst_ip
    old_port = parsed.src_port if is_src else parsed.dst_port

    ip_csum = B_.be16_at(pkt, parsed.l3_off + 10)
    new_ip_csum = csum_update32(ip_csum, old_ip, new_ip)
    pkt = B_.scatter_be32_at_masked(pkt, ip_field_off, new_ip, mask)
    pkt = B_.scatter_be16_at_masked(pkt, parsed.l3_off + 10, new_ip_csum, mask)

    port_off = parsed.l4_off + (0 if is_src else 2)
    tcp_mask = mask & parsed.is_tcp
    udp_mask = mask & parsed.is_udp
    icmp_mask = mask & parsed.is_icmp

    tcp_csum = B_.be16_at(pkt, parsed.l4_off + 16)
    tcp_csum = csum_update32(tcp_csum, old_ip, new_ip)
    tcp_csum = csum_update16(tcp_csum, old_port, new_port)
    pkt = B_.scatter_be16_at_masked(pkt, parsed.l4_off + 16, tcp_csum, tcp_mask)
    pkt = B_.scatter_be16_at_masked(pkt, port_off, new_port, tcp_mask)

    udp_csum = B_.be16_at(pkt, parsed.l4_off + 6)
    has_csum = udp_csum != 0
    new_udp_csum = csum_update16(csum_update32(udp_csum, old_ip, new_ip), old_port, new_port)
    new_udp_csum = torch.where(new_udp_csum == 0, 0xFFFF, new_udp_csum)
    pkt = B_.scatter_be16_at_masked(pkt, parsed.l4_off + 6, new_udp_csum, udp_mask & has_csum)
    pkt = B_.scatter_be16_at_masked(pkt, port_off, new_port, udp_mask)

    icmp_csum = B_.be16_at(pkt, parsed.l4_off + 2)
    new_icmp_csum = csum_update16(icmp_csum, old_port, new_port)
    pkt = B_.scatter_be16_at_masked(pkt, parsed.l4_off + 2, new_icmp_csum, icmp_mask)
    pkt = B_.scatter_be16_at_masked(pkt, parsed.l4_off + 4, new_port, icmp_mask)
    return pkt


def nat44_kernel(pkt, length, parsed: Parsed, tables: NATTables, geom: NATGeom,
                 now_s) -> NATResult:
    """Fused egress-SNAT + ingress-DNAT over one batch."""
    Bsz = pkt.shape[0]
    dev = pkt.device
    stats = torch.zeros((NAT_NSTATS,), dtype=torch.int64, device=dev)
    cfg_flags = u32(tables.config)[0]

    l4ok = parsed.is_tcp | parsed.is_udp | parsed.is_icmp
    eligible = parsed.is_ipv4 & l4ok
    private = is_private_ip(parsed.src_ip)
    egress = eligible & private
    ingress = eligible & ~private

    sub_res = lookup(tables.sub_nat, parsed.src_ip[:, None], geom.sub_nat)
    has_alloc = sub_res.found & egress
    stats[NST_PASSED] += (egress & ~sub_res.found).sum()

    alg_enabled = (cfg_flags & (FLAG_ALG_FTP | FLAG_ALG_SIP)) != 0
    alg_key = ((parsed.dst_port & 0xFFFF) << 16) | (parsed.proto & 0xFF)
    alg_hit = (has_alloc & alg_enabled & _in_set(alg_key, tables.alg_ports)
               & (parsed.is_tcp | parsed.is_udp))
    stats[NST_ALG] += alg_hit.sum()

    hairpin_on = (cfg_flags & FLAG_HAIRPIN) != 0
    is_hairpin = has_alloc & hairpin_on & _in_set(parsed.dst_ip, tables.hairpin_ips)
    stats[NST_HAIRPIN] += is_hairpin.sum()

    # ICMP keys: egress tracks (echo_id, 0), ingress matches (0, echo_id)
    e_dst_port = torch.where(parsed.is_icmp, 0, parsed.dst_port)
    ekey = _session_key(parsed.src_ip, parsed.dst_ip, parsed.src_port, e_dst_port, parsed.proto)
    esess = lookup(tables.sessions, ekey, geom.sessions)
    egress_active = has_alloc & ~alg_hit
    egress_hit = egress_active & esess.found
    egress_miss = egress_active & ~esess.found
    stats[NST_SNAT] += egress_hit.sum()

    i_src_port = torch.where(parsed.is_icmp, 0, parsed.src_port)
    rkey = _session_key(parsed.src_ip, parsed.dst_ip, i_src_port, parsed.dst_port, parsed.proto)
    rres = lookup(tables.reverse, rkey, geom.reverse)
    ingress_rhit = ingress & rres.found
    stats[NST_PASSED] += (ingress & ~rres.found).sum()
    isess = lookup(tables.sessions, rres.vals[:, :4], geom.sessions)
    ingress_hit = ingress_rhit & isess.found
    stats[NST_EXPIRED] += (ingress_rhit & ~isess.found).sum()
    stats[NST_DNAT] += ingress_hit.sum()

    evals = u32(esess.vals)
    ivals = u32(isess.vals)
    pkt = _rewrite_l3_l4(pkt, parsed, egress_hit, evals[:, SV_NAT_IP], evals[:, SV_NAT_PORT],
                         is_src=True)
    pkt = _rewrite_l3_l4(pkt, parsed, ingress_hit, ivals[:, SV_ORIG_IP], ivals[:, SV_ORIG_PORT],
                         is_src=False)

    return NATResult(
        translated=egress_hit | ingress_hit,
        punted=egress_miss | alg_hit,
        dropped=torch.zeros((Bsz,), dtype=torch.bool, device=dev),
        out_pkt=pkt,
        stats=stats & MASK32,
        is_hairpin=is_hairpin,
        egress_hit=egress_hit,
        ingress_hit=ingress_hit,
        e_slot=esess.slot.to(torch.int64),
        i_slot=isess.slot.to(torch.int64),
        i_state=ivals[:, SV_STATE],
    )


def nat44_update_sessions(sessions: TableState, res: NATResult, parsed: Parsed, length,
                          keep, now_s) -> TableState:
    """Session counters / last_seen / TCP state for forwarded lanes only,
    written in place into `sessions.vals` (see the module docstring)."""
    vals = sessions.vals
    S, V = vals.shape
    dev = vals.device
    egress_hit = res.egress_hit & keep
    ingress_hit = res.ingress_hit & keep
    hit_any = egress_hit | ingress_hit
    slot = torch.where(egress_hit, res.e_slot, res.i_slot)
    plen = length.to(torch.int64) & MASK32

    # counters: scatter-add (duplicate slots sum); skipped lanes add 0 at row 0.
    # int32 two's-complement adds give the uint32 wrap bits.
    add_slot = torch.where(hit_any, slot, 0)
    add_block = torch.stack([
        egress_hit.to(torch.int64), ingress_hit.to(torch.int64),
        torch.where(egress_hit, plen, 0), torch.where(ingress_hit, plen, 0),
    ], dim=1).to(torch.int32)
    cols = torch.arange(SV_PKTS_OUT, SV_BYTES_IN + 1, device=dev)[None, :]
    vals.index_put_((add_slot[:, None], cols), add_block, accumulate=True)

    # last_seen: scatter-set of one value for every hit lane
    now_w = now_s.to(torch.int32).expand(slot.shape[0])
    scatter_set_drop(vals, torch.where(hit_any, slot, S), now_w, col=SV_LAST_SEEN)

    # TCP state: scatter-max, so a FIN/RST lane beats a same-slot ACK lane.
    fin_or_rst = (parsed.tcp_flags & 0x05) != 0
    ack = (parsed.tcp_flags & 0x10) != 0
    cur = res.i_state
    new_state = torch.where(
        fin_or_rst, NAT_STATE_CLOSING,
        torch.where((cur == NAT_STATE_NEW) & ack, NAT_STATE_ESTABLISHED, cur))
    # The max is unsigned in the reference. Every lane of a slot shares
    # `cur`, and new_state is cur, 1 or 3: where cur >= 3 the unsigned max
    # is cur itself, so those lanes write cur and the int32 max agrees.
    new_state = torch.where(cur >= NAT_STATE_CLOSING, cur, new_state).to(torch.int32)
    st = ingress_hit & parsed.is_tcp
    flat_idx = torch.where(st, res.i_slot, 0) * V + SV_STATE
    src = torch.where(st, new_state, torch.iinfo(torch.int32).min)
    vals.view(-1).scatter_reduce_(0, flat_idx, src, "amax")
    return sessions
