"""The fused IPoE dataplane step (port of `bng_tpu/ops/pipeline.py`):

    parse -> antispoof -> DHCP responder -> NAT44 (SNAT/DNAT) -> QoS up/down

TX lanes (device-generated DHCP replies) are exempt from the drop masks,
and DHCP requests bypass antispoof, as in the reference. Verdicts per
lane: PASS=0, DROP=1, TX=2, FWD=3 (precedence TX > DROP > FWD > PASS).

The step updates its tables IN PLACE (NAT session counters and QoS token
rows) and returns the same `PipelineTables` object. One IPoE step makes
8 K1 probes (antispoof 1, DHCP 3, NAT44 4) and 4 K2 calls (2 per QoS
direction). The garden, PPPoE and edge stages belong to later slices of
the port: a `PipelineTables` that carries any of them raises.

Each stage runs inside a `torch.profiler.record_function` range
("bng::parse", "bng::antispoof", ...), so a profiler trace of the step
attributes host and device time per stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from bng_tpu_torch.ops import bytes as B_
from bng_tpu_torch.ops.antispoof import AntispoofGeom, antispoof_kernel
from bng_tpu_torch.ops.dhcp import DHCPGeom, DHCPTables, dhcp_fastpath
from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.nat44 import NATGeom, NATTables, nat44_kernel, nat44_update_sessions
from bng_tpu_torch.ops.parse import parse_batch
from bng_tpu_torch.ops.qos import QoSGeom, qos_kernel
from bng_tpu_torch.ops.qtable import QTableState
from bng_tpu_torch.ops.table import TableGeom, TableState

VERDICT_PASS, VERDICT_DROP, VERDICT_TX, VERDICT_FWD = 0, 1, 2, 3

# optional stages of the reference pipeline that this slice does not carry
LATER_STAGES = ("garden", "garden_allowed", "pppoe_by_sid", "pppoe_by_ip",
                "pppoe_server_mac", "tap", "tap_filters", "tap_config", "route")


class PipelineTables(NamedTuple):
    """All device state of the fused IPoE step."""

    dhcp: DHCPTables
    nat: NATTables
    qos_up: QTableState  # keyed by src ip (upload)
    qos_down: QTableState  # keyed by dst ip (download)
    spoof: TableState
    spoof_ranges: torch.Tensor  # [R, 2] int32 words
    spoof_config: torch.Tensor  # [2] int32 words
    garden: TableState | None = None
    garden_allowed: torch.Tensor | None = None
    pppoe_by_sid: TableState | None = None
    pppoe_by_ip: TableState | None = None
    pppoe_server_mac: torch.Tensor | None = None
    tap: TableState | None = None
    tap_filters: torch.Tensor | None = None
    tap_config: torch.Tensor | None = None
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


def check_ipoe_only(tables: PipelineTables, geom: PipelineGeom) -> None:
    for name in LATER_STAGES:
        if getattr(tables, name) is not None:
            raise NotImplementedError(
                f"pipeline stage table {name!r}: the garden, PPPoE and edge "
                "stages are not ported yet (a later slice of the port)")
    for name in ("garden", "pppoe", "tap", "route"):
        if getattr(geom, name) is not None:
            raise NotImplementedError(
                f"pipeline stage {name!r} is not ported yet (a later slice of the port)")


def pipeline_step(tables: PipelineTables, pkt, length, from_access, geom: PipelineGeom,
                  now_s, now_us) -> PipelineResult:
    """pkt [B, L] uint8, length [B] int, from_access [B] bool; now_s and
    now_us are int64 scalar tensors (uint32 values) on the step's device."""
    check_ipoe_only(tables, geom)
    length = length.to(torch.int64)
    with record_function("bng::parse"):
        parsed = parse_batch(pkt, length)

    with record_function("bng::antispoof"):
        spoof = antispoof_kernel(pkt, parsed, tables.spoof, geom.spoof,
                                 tables.spoof_ranges, tables.spoof_config)
        spoof_drop = spoof.dropped & from_access

    with record_function("bng::dhcp"):
        dhcp = dhcp_fastpath(pkt, length, parsed, tables.dhcp, geom.dhcp, now_s)
        dhcp_tx = dhcp.is_reply & from_access
        spoof_drop = spoof_drop & ~dhcp.is_dhcp

    with record_function("bng::nat44"):
        nat = nat44_kernel(pkt, length, parsed, tables.nat, geom.nat, now_s)
        natable = ~dhcp.is_dhcp & ~spoof_drop
        nat_fwd = nat.translated & natable
        nat_punt = nat.punted & natable

    with record_function("bng::qos"):
        up = qos_kernel(parsed.src_ip, length, from_access & parsed.is_ipv4 & ~dhcp.is_dhcp,
                        tables.qos_up, geom.qos, now_us)
        # download keys on the POST-DNAT dst ip, read from the rewritten bytes
        dnat_dst = B_.be32_at(nat.out_pkt, parsed.l3_off + 16)
        down = qos_kernel(dnat_dst, length, ~from_access & parsed.is_ipv4,
                          tables.qos_down, geom.qos, now_us)
        qos_drop = (up.dropped & from_access) | (down.dropped & ~from_access)

    with record_function("bng::verdict"):
        drop = (spoof_drop | qos_drop) & ~dhcp_tx
        fwd = nat_fwd
        out_pkt = torch.where(dhcp_tx[:, None], dhcp.out_pkt, nat.out_pkt)
        out_len = torch.where(dhcp_tx, dhcp.out_len, length)
        verdict = torch.where(
            dhcp_tx, VERDICT_TX,
            torch.where(drop, VERDICT_DROP, torch.where(fwd, VERDICT_FWD, VERDICT_PASS)),
        ).to(torch.int32)

    with record_function("bng::nat_accounting"):
        nat44_update_sessions(tables.nat.sessions, nat, parsed, length,
                              keep=nat_fwd & ~drop, now_s=now_s)
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
    )
