"""The fused dataplane step (port of `bng_tpu/ops/pipeline.py`):

    [PPPoE decap] -> parse -> antispoof -> DHCP responder -> [garden gate]
      -> NAT44 (SNAT/DNAT) -> QoS up/down -> [tap match, route rewrite]
      -> [PPPoE encap]

The bracketed stages are optional: each runs when its tables are in
`PipelineTables` (garden; PPPoE by_sid/by_ip; edge tap/route). TX lanes
(device-generated DHCP replies) are exempt from the drop masks, and DHCP
requests bypass antispoof, as in the reference. Verdicts per lane:
PASS=0, DROP=1, TX=2, FWD=3 (precedence TX > DROP > FWD > PASS); the
mirror word (a warrant id, 0 = none) is a side array, not a verdict.

The step updates its tables IN PLACE (NAT session counters and QoS token
rows: `step_writes`) and returns the same `PipelineTables` object. Packet bytes stay
out of place. K1 probes per step: antispoof 1, DHCP 3, NAT44 4, garden
1, PPPoE 2 (decap by_sid, encap by_ip), tap 1, route 1: 8 for the IPoE
step and 13 with every stage. K2 calls: 4 (2 per QoS direction).

Each stage runs inside the stage hook `telemetry/spans.region` (PARSE,
ANTISPOOF, ...): armed, the tracer laps the host time issuing each stage;
while a torch profiler records, the stage is the range "bng::parse",
"bng::antispoof", ..., so a profiler trace attributes host and device
time per stage; neither, the hook is a flag check.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bng_tpu_torch.edge.ops import route_rewrite, tap_match
from bng_tpu_torch.ops import bytes as B_
from bng_tpu_torch.ops.antispoof import AntispoofGeom, antispoof_kernel
from bng_tpu_torch.ops.dhcp import DHCPGeom, DHCPTables, dhcp_fastpath
from bng_tpu_torch.ops.garden import garden_kernel
from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.nat44 import NATGeom, NATTables, nat44_kernel, nat44_update_sessions
from bng_tpu_torch.ops.parse import eth_vlan, parse_batch
from bng_tpu_torch.ops.pppoe import pppoe_decap, pppoe_encap
from bng_tpu_torch.ops.qos import QoSGeom, qos_kernel
from bng_tpu_torch.ops.qtable import QTableState
from bng_tpu_torch.ops.table import TableGeom, TableState
from bng_tpu_torch.telemetry import spans as tele

VERDICT_PASS, VERDICT_DROP, VERDICT_TX, VERDICT_FWD = 0, 1, 2, 3


class PipelineTables(NamedTuple):
    """All device state of the fused step (None = stage not compiled in)."""

    dhcp: DHCPTables
    nat: NATTables
    qos_up: QTableState  # keyed by src ip (upload)
    qos_down: QTableState  # keyed by dst ip (download)
    spoof: TableState
    spoof_ranges: torch.Tensor  # [R, 2] int32 words
    spoof_config: torch.Tensor  # [2] int32 words
    garden: TableState | None = None
    garden_allowed: torch.Tensor | None = None  # [D, 3] int32 words
    pppoe_by_sid: TableState | None = None  # upstream decap: session id -> row
    pppoe_by_ip: TableState | None = None  # downstream encap: subscriber IP -> row
    pppoe_server_mac: torch.Tensor | None = None  # [2] int32 words (hi16, lo32)
    tap: TableState | None = None
    tap_filters: torch.Tensor | None = None  # [F, 4] int32 words
    tap_config: torch.Tensor | None = None  # [2] int32 words
    route: TableState | None = None


class PipelineGeom(NamedTuple):
    dhcp: DHCPGeom
    nat: NATGeom
    qos: QoSGeom
    spoof: AntispoofGeom
    garden: TableGeom | None = None
    pppoe: TableGeom | None = None
    tap: TableGeom | None = None
    route: TableGeom | None = None


class PipelineResult(NamedTuple):
    verdict: torch.Tensor  # [B] int32
    out_pkt: torch.Tensor  # [B, L] uint8
    out_len: torch.Tensor  # [B] int64
    tables: PipelineTables  # the input tables, updated in place
    dhcp_stats: torch.Tensor  # int64 (uint32 values)
    nat_stats: torch.Tensor
    qos_stats: torch.Tensor  # up + down
    spoof_stats: torch.Tensor
    priority: torch.Tensor  # [B] int64
    nat_punt: torch.Tensor  # [B] bool — new flow, the host creates the session
    spoof_violation: torch.Tensor  # [B] bool
    garden_stats: torch.Tensor | None = None  # [GARDEN_NSTATS] when gated
    pppoe_stats: torch.Tensor | None = None  # [PPPOE_NSTATS]: decap + encap
    mirror: torch.Tensor | None = None  # [B] int64 warrant id (0 = not mirrored)
    edge_stats: torch.Tensor | None = None  # [EDGE_NSTATS] when edge is on


def step_writes(tables: PipelineTables) -> list[torch.Tensor]:
    """The table tensors `pipeline_step` writes in place: the NAT session
    rows (counters, last_seen) and both QoS token tables."""
    return [tables.nat.sessions.vals, tables.qos_up.rows, tables.qos_down.rows]


def pipeline_step(tables: PipelineTables, pkt, length, from_access, geom: PipelineGeom,
                  now_s, now_us) -> PipelineResult:
    """pkt [B, L] uint8, length [B] int, from_access [B] bool; now_s and
    now_us are int64 scalar tensors (uint32 values) on the step's device."""
    length = length.to(torch.int64)
    # PPPoE decap pre-stage: session DATA frames lose their framing before
    # the parse, so every later stage sees the inner IPv4 packet; control,
    # discovery and unknown sessions keep their bytes and PASS
    pppoe_dec = None
    if tables.pppoe_by_sid is not None:
        with tele.region(tele.PPPOE_DECAP):
            vo, et = eth_vlan(pkt)
            # access side only: a session ethertype from the core is foreign
            et_gated = torch.where(from_access, et, 0)
            pppoe_dec = pppoe_decap(pkt, length, vo, et_gated, tables.pppoe_by_sid, geom.pppoe)
            pkt = torch.where(pppoe_dec.done[:, None], pppoe_dec.out_pkt, pkt)
            length = torch.where(pppoe_dec.done, pppoe_dec.out_len, length)

    with tele.region(tele.PARSE):
        parsed = parse_batch(pkt, length)

    with tele.region(tele.ANTISPOOF):
        spoof = antispoof_kernel(pkt, parsed, tables.spoof, geom.spoof,
                                 tables.spoof_ranges, tables.spoof_config)
        spoof_drop = spoof.dropped & from_access

    with tele.region(tele.DHCP):
        dhcp = dhcp_fastpath(pkt, length, parsed, tables.dhcp, geom.dhcp, now_s)
        dhcp_tx = dhcp.is_reply & from_access
        spoof_drop = spoof_drop & ~dhcp.is_dhcp

    # the optional stages' masks stay None when the stage is off, so an
    # IPoE-only step issues none of their ops
    garden_drop = None
    garden_stats = None
    if tables.garden is not None:
        with tele.region(tele.GARDEN):
            garden = garden_kernel(parsed, from_access & parsed.is_ipv4 & ~dhcp.is_dhcp,
                                   tables.garden, geom.garden, tables.garden_allowed)
            garden_drop = garden.gate_drop
            garden_stats = garden.stats

    with tele.region(tele.NAT44):
        nat = nat44_kernel(pkt, length, parsed, tables.nat, geom.nat, now_s)
        natable = ~dhcp.is_dhcp & ~spoof_drop
        if garden_drop is not None:
            natable = natable & ~garden_drop
        nat_fwd = nat.translated & natable
        nat_punt = nat.punted & natable

    with tele.region(tele.QOS):
        up = qos_kernel(parsed.src_ip, length, from_access & parsed.is_ipv4 & ~dhcp.is_dhcp,
                        tables.qos_up, geom.qos, now_us)
        # download keys on the POST-DNAT dst ip, read from the rewritten bytes
        dnat_dst = B_.be32_at(nat.out_pkt, parsed.l3_off + 16)
        down = qos_kernel(dnat_dst, length, ~from_access & parsed.is_ipv4,
                          tables.qos_down, geom.qos, now_us)
        qos_drop = (up.dropped & from_access) | (down.dropped & ~from_access)

    # edge: the tap keys on the lane's SUBSCRIBER address (src upstream,
    # post-DNAT dst downstream); the route rewrite patches the L2 dst of
    # upstream lanes on a copy of nat.out_pkt
    mirror = None
    edge_stats = None
    data_pkt = nat.out_pkt
    route_fwd = None
    if tables.tap is not None:
        with tele.region(tele.EDGE):
            sub_ip = torch.where(from_access, parsed.src_ip, dnat_dst)
            peer_ip = torch.where(from_access, parsed.dst_ip, parsed.src_ip)
            data_lane = parsed.is_ipv4 & ~dhcp.is_dhcp
            tap = tap_match(sub_ip, parsed.src_port, parsed.dst_port, parsed.proto, peer_ip,
                            data_lane, tables.tap, tables.tap_filters, tables.tap_config,
                            geom.tap)
            mirror = tap.mirror
            rt = route_rewrite(data_pkt, sub_ip, data_lane & from_access, tables.route,
                               geom.route)
            data_pkt = rt.out_pkt
            route_fwd = rt.hit
            edge_stats = torch.cat([tap.stats, rt.stats])

    # PPPoE encap post-stage: downstream data whose post-DNAT dst is an open
    # session gets its AC framing; it reads nat.out_pkt (downstream lanes
    # are never route-rewritten), joined below by the enc_done select
    pppoe_enc = None
    if tables.pppoe_by_ip is not None:
        with tele.region(tele.PPPOE_ENCAP):
            enc_et = torch.where(~from_access, parsed.ethertype, 0)
            pppoe_enc = pppoe_encap(nat.out_pkt, length, parsed.vlan_offset, enc_et, dnat_dst,
                                    tables.pppoe_by_ip, geom.pppoe, tables.pppoe_server_mac)

    with tele.region(tele.VERDICT):
        drop = spoof_drop | qos_drop
        if garden_drop is not None:
            drop = drop | garden_drop
        drop = drop & ~dhcp_tx
        fwd = nat_fwd
        if route_fwd is not None:
            # a routed lane forwards even when NAT left it untouched
            fwd = fwd | (route_fwd & ~drop & ~dhcp_tx)
        out_pkt = torch.where(dhcp_tx[:, None], dhcp.out_pkt, data_pkt)
        out_len = torch.where(dhcp_tx, dhcp.out_len, length)
        if pppoe_enc is not None:
            enc_done = pppoe_enc.done & ~drop & ~dhcp_tx
            out_pkt = torch.where(enc_done[:, None], pppoe_enc.out_pkt, out_pkt)
            out_len = torch.where(enc_done, pppoe_enc.out_len, out_len)
            fwd = fwd | enc_done
        verdict = torch.where(
            dhcp_tx, VERDICT_TX,
            torch.where(drop, VERDICT_DROP, torch.where(fwd, VERDICT_FWD, VERDICT_PASS)),
        ).to(torch.int32)

    with tele.region(tele.NAT_ACCOUNTING):
        # only lanes that forward advance the session counters
        nat44_update_sessions(tables.nat.sessions, nat, parsed, length,
                              keep=nat_fwd & ~drop, now_s=now_s)
    pppoe_stats = None
    if pppoe_dec is not None:
        pppoe_stats = pppoe_dec.stats if pppoe_enc is None else (
            (pppoe_dec.stats + pppoe_enc.stats) & MASK32)
    return PipelineResult(
        verdict=verdict,
        out_pkt=out_pkt,
        out_len=out_len,
        tables=tables,
        dhcp_stats=dhcp.stats,
        nat_stats=nat.stats,
        qos_stats=(up.stats + down.stats) & MASK32,
        spoof_stats=spoof.stats,
        priority=torch.maximum(up.priority, down.priority),
        nat_punt=nat_punt,
        spoof_violation=spoof.violation,
        garden_stats=garden_stats,
        pppoe_stats=pppoe_stats,
        mirror=mirror,
        edge_stats=edge_stats,
    )
