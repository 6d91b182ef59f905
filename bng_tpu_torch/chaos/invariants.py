"""Cross-authority invariant auditor (port of `bng_tpu/chaos/invariants.py`).

Several authorities hold overlapping views of subscriber and session
state: the pool bitmaps, the lease books, the host fast-path tables, the
device tables (`Engine.tables`, int32 words read back as uint32 here) and
the NAT manager's allocator, EIM map and tables. A bug in any writer
shows as two authorities disagreeing. `audit_invariants` proves, at the
quiesce barrier the checkpoint uses:

  - no IP is leased twice, and every leased IP is allocated in its pool
    (the DHCPv4 and DHCPv6 books, the PPPoE sessions);
  - no fast-path row outlives or contradicts its lease;
  - after a drain, every device table equals its host mirror bit for bit
    (DHCP, edge, the dense config, and the QoS config words; the
    device-written NAT counters and QoS tokens are masked);
  - the edge tap rows are backed by warrants and the armed count is true;
  - the NAT allocator, EIM map, sessions and reverse rows agree;
  - a checkpoint save -> decode round trip is state-identical;
  - a sharded cluster partitions its state (rows on their owner shards).

Findings come back as structured `Finding`s, bounded per kind;
`AuditReport.to_dict()` is sorted, so reports diff clean. Components the
port does not have (the HA pair, the cluster of BNGs, the slow-path
fleet) are accepted as None and audit nothing; any other value raises.
Their audits come with those components. `audit_app` audits a composed
`BNGApp`; the reference's `metrics` and `epoch` arguments come with the
metrics subsystem.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from bng_tpu_torch.telemetry import spans as tele

# per-kind cap: a systematically broken table would otherwise produce
# one finding per row; the count still lands in violations_by_kind
MAX_FINDINGS_PER_KIND = 16


@dataclass(frozen=True)
class Finding:
    kind: str  # stable slug, the bng_invariant_violations_total label
    subject: str  # the ip/mac/slot/table the violation is about
    detail: str

    def to_dict(self) -> dict:
        return {"kind": self.kind, "subject": self.subject,
                "detail": self.detail}


@dataclass
class AuditReport:
    findings: list[Finding] = field(default_factory=list)
    checks: dict[str, int] = field(default_factory=dict)  # coverage counts
    suppressed: dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.suppressed

    def violations_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        for kind, extra in self.suppressed.items():
            out[kind] = out.get(kind, 0) + extra
        return dict(sorted(out.items()))

    def add(self, kind: str, subject: str, detail: str) -> None:
        if sum(1 for f in self.findings if f.kind == kind) \
                >= MAX_FINDINGS_PER_KIND:
            self.suppressed[kind] = self.suppressed.get(kind, 0) + 1
            return
        self.findings.append(Finding(kind, subject, detail))

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "checks": dict(sorted(self.checks.items())),
            "violations_by_kind": self.violations_by_kind(),
            "findings": [f.to_dict() for f in sorted(
                self.findings, key=lambda f: (f.kind, f.subject))],
        }


# ---------------------------------------------------------------------------
# lease book collection
# ---------------------------------------------------------------------------

def _audit_ownership(report: AuditReport, pools, dhcp) -> None:
    """Pool bitmap vs the lease book: every leased IP allocated in its
    pool, none outside every pool or on a gateway, none leased twice.
    (The reference checks its slow-path fleet's slices and worker books
    here too; the port has no fleet.)"""
    if pools is None:
        return
    report.checks["slice_granted"] = 0  # no fleet worker holds a slice
    leases = list(dhcp.leases.items()) if dhcp is not None else []
    report.checks["leases"] = len(leases)
    by_ip: dict[int, list[int]] = {}
    for mk, lease in leases:
        by_ip.setdefault(lease.ip, []).append(mk)
        pool = pools.pool_for_ip(lease.ip)
        if pool is None:
            report.add("lease-outside-pools", _ip(lease.ip),
                       f"parent lease (mac {lease.mac.hex()}) is outside "
                       f"every configured pool")
        elif lease.ip not in pool._allocated:
            report.add("lease-not-allocated", _ip(lease.ip),
                       f"parent lease (mac {lease.mac.hex()}) not "
                       f"allocated in pool {pool.pool_id}")
        elif lease.ip == pool.gateway:
            report.add("gateway-leased", _ip(lease.ip),
                       f"parent leased the pool {pool.pool_id} gateway")
    for ip, macs in by_ip.items():
        if len(macs) > 1:
            owners = sorted({f"parent:{mk:012x}" for mk in macs})
            report.add("double-lease", _ip(ip),
                       f"leased by {len(macs)} owners: {owners}")


# ---------------------------------------------------------------------------
# fast-path tables: rows vs leases, host vs device
# ---------------------------------------------------------------------------

def _audit_fastpath_rows(report: AuditReport, fastpath, dhcp) -> None:
    """Authority 4 vs 3: no subscriber row outlives (or contradicts) its
    lease. One-directional by design — a lease WITHOUT a row is only a
    fast-path miss (the slow path re-answers; restores that hydrate
    books but not tables are legal), but a row without a lease would
    device-ACK an address nobody holds."""
    if fastpath is None or dhcp is None:
        # without a lease book there is nothing to cross-check rows
        # against (bench-style bulk installs are legal book-less rows)
        return
    idx = {mk: lease.ip for mk, lease in dhcp.leases.items()}
    sub = fastpath.sub
    occupied = np.nonzero(sub.used)[0]
    report.checks["fastpath_rows"] = len(occupied)
    from bng_tpu_torch.ops.dhcp import AV_IP

    for s in occupied:
        hi, lo = int(sub.keys[s][0]), int(sub.keys[s][1])
        mk = (hi << 32) | lo
        row_ip = int(sub.vals[s][AV_IP])
        got = idx.get(mk)
        if got is None:
            report.add("fastpath-stale-row", f"{mk:012x}",
                       f"subscriber row (ip {_ip(row_ip)}) has no live "
                       f"lease in any book")
        elif got != row_ip:
            report.add("fastpath-ip-mismatch", f"{mk:012x}",
                       f"row ip {_ip(row_ip)} != leased ip {_ip(got)}")


def _words(t) -> np.ndarray:
    """A device word tensor (int32 holding uint32 bits) as host uint32."""
    if isinstance(t, torch.Tensor):
        return t.to("cpu", copy=True).numpy().view(np.uint32)
    return np.asarray(t)


def _table_mirror_findings(report: AuditReport, host, dev_state,
                           label: str) -> None:
    """One HostTable vs its device TableState, bit-exact. Caller must
    have drained (dirty_count()==0) — pending deltas are legal lag, not
    divergence."""
    exp_krows = host._pack_bucket_rows(np.arange(host.nbuckets))
    exp_stash = host._pack_stash_rows(np.arange(host.stash))
    got_krows = _words(dev_state.krows)
    got_stash = _words(dev_state.stash_rows)
    got_vals = _words(dev_state.vals)
    report.checks[f"mirror_buckets.{label}"] = host.nbuckets
    if exp_krows.shape != got_krows.shape:
        report.add("mirror-mismatch", label,
                   f"krows shape {got_krows.shape} != host "
                   f"{exp_krows.shape}")
        return
    bad = np.nonzero((exp_krows != got_krows).any(axis=1))[0]
    for b in bad[:4]:
        report.add("mirror-mismatch", f"{label}/bucket{int(b)}",
                   "device probe row differs from host mirror")
    if len(bad) > 4:
        report.add("mirror-mismatch", label,
                   f"{len(bad)} buckets diverge in total")
    if not np.array_equal(exp_stash, got_stash):
        report.add("mirror-mismatch", f"{label}/stash",
                   "device stash rows differ from host mirror")
    if host.vals.shape != got_vals.shape \
            or not np.array_equal(host.vals, got_vals):
        bad_v = (np.nonzero((host.vals != got_vals).any(axis=1))[0]
                 if host.vals.shape == got_vals.shape else [])
        for s in bad_v[:4]:
            report.add("mirror-mismatch", f"{label}/slot{int(s)}",
                       "device value row differs from host mirror")
        if len(bad_v) > 4 or host.vals.shape != got_vals.shape:
            report.add("mirror-mismatch", f"{label}/vals",
                       "device value array differs from host mirror")


def _audit_device_mirror(report: AuditReport, engine,
                         max_drain_steps: int = 64) -> None:
    """Authority 5 vs 4: after draining every pending delta, the device
    DHCP tables must equal the host mirrors bit-exact, and the QoS way
    rows must match on every host-authoritative word. NAT session
    values and the QoS token/last-us words are device-WRITTEN
    (fold_device_authoritative owns those), so they are masked out."""
    if engine is None:
        return
    fastpath = engine.fastpath
    steps = 0
    while engine.pending_dirty() > 0 and steps < max_drain_steps:
        # an empty batch still runs the bounded update drain (and a
        # bulk-build resync if one is pending) — the cheapest way to
        # ship the remaining deltas without inventing a second drain
        # path. pending_dirty covers EVERY drained mirror (dhcp, nat,
        # qos, antispoof, ...), not just the fastpath tables: the QoS
        # mirror check below needs its deltas shipped too.
        engine.process([])
        steps += 1
    if engine.pending_dirty() > 0:
        report.add("mirror-undrained", "fastpath",
                   f"{engine.pending_dirty()} dirty slots after "
                   f"{steps} drain steps")
        return
    engine.quiesce()
    report.checks["mirror_drain_steps"] = steps
    for t in ("sub", "vlan", "cid"):
        _table_mirror_findings(report, getattr(fastpath, t),
                               getattr(engine.tables.dhcp, t),
                               f"fastpath.{t}")
    if not np.array_equal(fastpath.pools, _words(engine.tables.dhcp.pools)):
        report.add("mirror-mismatch", "fastpath.pools",
                   "device pool config differs from host")
    if not np.array_equal(fastpath.server, _words(engine.tables.dhcp.server)):
        report.add("mirror-mismatch", "fastpath.server",
                   "device server config differs from host")
    _audit_qos_mirror(report, engine)
    edge = getattr(engine, "edge", None)
    if edge is not None and engine.tables.tap is not None:
        _table_mirror_findings(report, edge.tap, engine.tables.tap,
                               "edge.tap")
        _table_mirror_findings(report, edge.route, engine.tables.route,
                               "edge.route")
        if not np.array_equal(edge.tap_filters, _words(engine.tables.tap_filters)):
            report.add("mirror-mismatch", "edge.tap_filters",
                       "device filter rows differ from host")
        if not np.array_equal(edge.tap_config, _words(engine.tables.tap_config)):
            report.add("mirror-mismatch", "edge.tap_config",
                       "device armed predicate differs from host")


def _audit_qos_mirror(report: AuditReport, engine) -> None:
    """QoS host way rows vs device rows, masking the device-written
    token-bucket words (tokens + last_us) — a CoA policy flap rewrites
    key/flags/rate/burst/priority through the bounded drain, and after
    the drain the config words must agree bit-exact on every slot.
    Caller has drained (pending_dirty()==0) and quiesced."""
    from bng_tpu_torch.ops.qtable import QW_LAST_US, QW_TOKENS

    for label, host, dev_rows in (
            ("qos.up", engine.qos.up, engine.tables.qos_up.rows),
            ("qos.down", engine.qos.down, engine.tables.qos_down.rows)):
        got = _words(dev_rows)
        report.checks[f"mirror_slots.{label}"] = host.S
        if host.rows.shape != got.shape:
            report.add("qos-mirror-mismatch", label,
                       f"device rows shape {got.shape} != host "
                       f"{host.rows.shape}")
            continue
        mask = np.ones(host.rows.shape[1], dtype=bool)
        mask[[QW_TOKENS, QW_LAST_US]] = False
        bad = np.nonzero(
            (host.rows[:, mask] != got[:, mask]).any(axis=1))[0]
        for s in bad[:4]:
            report.add("qos-mirror-mismatch", f"{label}/slot{int(s)}",
                       "device config words differ from host way row")
        if len(bad) > 4:
            report.add("qos-mirror-mismatch", label,
                       f"{len(bad)} slots diverge in total")


# ---------------------------------------------------------------------------
# edge protection: tap rows vs warrants, route rows vs the routing program
# ---------------------------------------------------------------------------

def _audit_edge(report: AuditReport, edge, tap_program=None,
                route_program=None) -> None:
    """Edge-protection cross-authority clauses. The tap table
    and the warrant store are separate writers (device rows via
    EdgeTables, warrant lifecycle via control/intercept.py), so the
    auditor proves both directions:

    - every device tap row is backed by an ACTIVE in-window warrant — a
      row without one mirrors subscriber traffic with no legal basis,
      the worst finding this auditor can make;
    - every target the compiler armed is resident on the device — a
      missing row silently under-collects a live intercept;
    - every route row equals what the routing program would compile
      RIGHT NOW from the ISP tables + link health — a divergent row
      forwards to a next hop the tables no longer name;
    - each EdgeTables' armed predicate equals its live tap row count —
      a stale zero disables matching with warrants armed, a stale
      nonzero pays the tap probe with none.

    `edge` is anything with tap_rows()/route_rows(): an EdgeTables or a
    ShardedCluster's merged owner-routed surface.
    """
    if edge is None:
        return
    from bng_tpu_torch.edge.compile import _active_in_window
    from bng_tpu_torch.edge.ops import (RW_CLASS, RW_MAC_HI, RW_MAC_LO,
                                  RW_TABLE, TC_ARMED, TW_WID)

    taps = edge.tap_rows()
    routes = edge.route_rows()
    report.checks["edge_tap_rows"] = len(taps)
    report.checks["edge_route_rows"] = len(routes)

    if tap_program is not None:
        now = tap_program._clock()
        resident = {}
        for ip, row in taps:
            wid = int(row[TW_WID])
            resident[ip] = wid
            wid_id = tap_program.warrant_for(wid)
            try:
                w = (tap_program.manager.get_warrant(wid_id)
                     if wid_id is not None else None)
            except KeyError:  # warrant deleted out from under the row
                w = None
            if w is None:
                report.add("edge-tap-orphan", _ip(ip),
                           f"tap row carries wid {wid} with no known "
                           f"warrant — mirroring without legal basis")
            elif not _active_in_window(w, now):
                report.add("edge-tap-orphan", _ip(ip),
                           f"tap row for warrant {w.id} outside its "
                           f"ACTIVE validity window — must be reaped")
        for wid, ips in sorted(tap_program._ips_by_wid.items()):
            for ip in sorted(ips):
                if resident.get(ip) != wid:
                    report.add("edge-tap-missing", _ip(ip),
                               f"warrant wid {wid} armed this target but "
                               f"no device row carries it — the intercept "
                               f"silently under-collects")

    if route_program is not None:
        for ip, row in routes:
            want = route_program.expected_row(ip)
            got = (int(row[RW_MAC_HI]), int(row[RW_MAC_LO]),
                   int(row[RW_TABLE]), int(row[RW_CLASS]))
            if want is None:
                report.add("edge-route-orphan", _ip(ip),
                           "route row for a subscriber the routing "
                           "program would not route (unbound, or no "
                           "eligible upstream for its class)")
            elif got != tuple(int(x) for x in want):
                report.add("edge-route-divergence", _ip(ip),
                           f"device row {got} != compiled {want} — "
                           f"forwarding to a next hop the ISP tables "
                           f"no longer select")

    # armed predicate == live tap row count, per EdgeTables instance
    # (a ShardedCluster exposes its per-shard authorities as .edge)
    tables = ([edge] if hasattr(edge, "tap_config")
              else list(getattr(edge, "edge", None) or ()))
    for j, e in enumerate(tables):
        n_rows = len(e.tap_rows())
        cfg = int(e.tap_config[TC_ARMED])
        if cfg != n_rows:
            report.add("edge-armed-count", f"edge{j}",
                       f"armed predicate {cfg} != {n_rows} live tap rows")


# ---------------------------------------------------------------------------
# NAT: allocator / EIM / tables
# ---------------------------------------------------------------------------

def _audit_nat(report: AuditReport, nat) -> None:
    if nat is None:
        return
    from bng_tpu_torch.ops.nat44 import (BV_PORT_END, BV_PORT_START, BV_PUBLIC_IP,
                                         FLAG_EIM, SV_NAT_IP, SV_NAT_PORT,
                                         SV_ORIG_IP, SV_ORIG_PORT, SV_PROTO)
    from bng_tpu_torch.ops.parse import PROTO_ICMP

    report.checks["nat_blocks"] = len(nat.blocks)
    # blocks <-> sub_nat rows (one vectorized lookup of every block's row)
    blocks = list(nat.blocks.items())
    priv = np.array([ip for ip, _ in blocks], dtype=np.uint32).reshape(-1, 1)
    rslots = nat.sub_nat.find_slots(priv)
    rows = nat.sub_nat.vals[np.maximum(rslots, 0)].astype(np.int64)
    want = np.array([[b["public_ip"], b["port_start"], b["port_end"]] for _, b in blocks],
                    dtype=np.int64).reshape(-1, 3)
    for j in np.nonzero(rslots < 0)[0]:
        report.add("nat-block-row-missing", _ip(blocks[j][0]),
                   "allocator block has no subscriber_nat row")
    got = rows[:, [BV_PUBLIC_IP, BV_PORT_START, BV_PORT_END]]
    for j in np.nonzero((rslots >= 0) & (got != want).any(axis=1))[0]:
        priv_ip, blk = blocks[j]
        report.add("nat-block-row-mismatch", _ip(priv_ip),
                   f"row ({_ip(int(got[j, 0]))} "
                   f"{int(got[j, 1])}-{int(got[j, 2])}) "
                   f"!= block ({_ip(blk['public_ip'])} "
                   f"{blk['port_start']}-{blk['port_end']})")
    n_rows = int(np.count_nonzero(nat.sub_nat.used))
    if n_rows != len(nat.blocks):
        report.add("nat-subnat-count", "subscriber_nat",
                   f"{n_rows} rows != {len(nat.blocks)} allocator blocks")

    # block carving: per public IP the allocated+free block starts must
    # be disjoint, uniform-size and behind the cursor
    by_pub: dict[int, list[tuple[int, int, str]]] = {}
    span = nat.ports_per_subscriber
    for priv_ip, blk in nat.blocks.items():
        by_pub.setdefault(blk["public_ip"], []).append(
            (blk["port_start"], blk["port_end"], _ip(priv_ip)))
        if blk["port_end"] - blk["port_start"] + 1 != span:
            report.add("nat-block-geometry", _ip(priv_ip),
                       f"block span {blk['port_end'] - blk['port_start'] + 1}"
                       f" != ports_per_subscriber {span}")
    for pub_ip, starts in nat._free_blocks.items():
        if len(starts) != len(set(starts)):
            report.add("nat-free-duplicate", _ip(pub_ip),
                       "free-block list holds duplicate starts")
        allocated = {s for s, _e, _p in by_pub.get(pub_ip, [])}
        for s in starts:
            if s in allocated:
                report.add("nat-free-allocated-overlap", _ip(pub_ip),
                           f"block start {s} is both free and allocated")
            if s + span - 1 >= nat._next_block.get(pub_ip, 0) + span:
                report.add("nat-free-past-cursor", _ip(pub_ip),
                           f"free block {s} lies beyond the carve cursor")
    for pub_ip, ranges in by_pub.items():
        cursor = nat._next_block.get(pub_ip)
        prev_end, prev_sub = -1, ""
        for start, end, sub in sorted(ranges):
            if start <= prev_end:
                report.add("nat-block-overlap", _ip(pub_ip),
                           f"blocks of {prev_sub} and {sub} overlap "
                           f"at port {start}")
            prev_end, prev_sub = end, sub
            if cursor is not None and start >= cursor:
                report.add("nat-cursor-behind", _ip(pub_ip),
                           f"block {start}-{end} ({sub}) sits at/past the "
                           f"carve cursor {cursor} — a future carve would "
                           f"re-issue it")

    # block-exhaustion accounting: every block the cursor has ever
    # carved is either allocated to a subscriber or on the free list —
    # carved != allocated + free means blocks leaked (exhaustion that
    # never heals) or double-booked. Checked per public IP so an
    # exhausted IP proves it is exhausted for a REASON.
    for pub_ip in nat.public_ips:
        cursor = nat._next_block.get(pub_ip, nat.port_range[0])
        carved = (cursor - nat.port_range[0]) // span
        n_alloc = len(by_pub.get(pub_ip, ()))
        n_free = len(nat._free_blocks.get(pub_ip, ()))
        if carved != n_alloc + n_free:
            report.add("nat-block-accounting", _ip(pub_ip),
                       f"{carved} blocks carved but {n_alloc} allocated "
                       f"+ {n_free} free — blocks leaked or double-booked")
        if cursor > nat.port_range[1] + 1:
            report.add("nat-block-accounting", _ip(pub_ip),
                       f"carve cursor {cursor} ran past the port range "
                       f"end {nat.port_range[1]}")
    report.checks["nat_exhausted_block"] = int(nat.exhausted["block"])
    report.checks["nat_exhausted_port"] = int(nat.exhausted["port"])

    # EIM <-> _ext_ports bijection, mappings inside the owner's block
    report.checks["nat_eim"] = len(nat.eim)
    for key, m in nat.eim.items():
        int_ip, _int_port, proto = key
        ext = (m[0], m[1], proto)
        if nat._ext_ports.get(ext) != key:
            report.add("nat-eim-extports-mismatch", _ip(int_ip),
                       f"eim {key} -> {ext} not indexed back")
        if m[2] <= 0:
            report.add("nat-eim-refcount", _ip(int_ip),
                       f"eim {key} refcount {m[2]} <= 0 but still mapped")
        blk = nat.blocks.get(int_ip)
        if blk is None:
            report.add("nat-eim-orphan", _ip(int_ip),
                       f"eim {key} has no allocator block")
        elif (m[0] != blk["public_ip"]
              or not blk["port_start"] <= m[1] <= blk["port_end"]):
            report.add("nat-eim-outside-block", _ip(int_ip),
                       f"mapping {_ip(m[0])}:{m[1]} outside block "
                       f"{blk['port_start']}-{blk['port_end']}")
    for ext, key in nat._ext_ports.items():
        if key not in nat.eim:
            report.add("nat-eim-extports-mismatch", _ip(ext[0]),
                       f"ext port {ext} indexes a vanished eim {key}")

    # sessions <-> reverse pairing + per-endpoint refcounts. The checks run
    # as numpy passes over every occupied slot (a million sessions take
    # seconds, where one host lookup per session took minutes); findings
    # are added per kind in slot order, as the reference's loop adds them
    occupied = np.nonzero(nat.sessions.used)[0]
    report.checks["nat_sessions"] = len(occupied)
    keys = nat.sessions.keys[occupied].astype(np.int64)
    vals = nat.sessions.vals[occupied].astype(np.int64)
    src_ip, dst_ip, proto = keys[:, 0], keys[:, 1], keys[:, 3]
    dst_port = keys[:, 2] & 0xFFFF
    nat_ip, nat_port = vals[:, SV_NAT_IP], vals[:, SV_NAT_PORT]
    bl = sorted(nat.blocks.items())
    b_priv = np.array([ip for ip, _ in bl], dtype=np.int64)
    b_pub = np.array([b["public_ip"] for _, b in bl], dtype=np.int64)
    b_lo = np.array([b["port_start"] for _, b in bl], dtype=np.int64)
    b_hi = np.array([b["port_end"] for _, b in bl], dtype=np.int64)
    at = np.minimum(np.searchsorted(b_priv, src_ip), max(len(bl) - 1, 0))
    has_blk = (b_priv[at] == src_ip) if len(bl) else np.zeros(len(occupied), dtype=bool)
    outside = has_blk & ((nat_ip != b_pub[at] if len(bl) else False)
                         | (nat_port < b_lo[at] if len(bl) else False)
                         | (nat_port > b_hi[at] if len(bl) else False))
    r_src = np.where(proto == PROTO_ICMP, 0, dst_port)
    rkeys = np.stack([dst_ip, nat_ip, ((r_src & 0xFFFF) << 16) | (nat_port & 0xFFFF), proto],
                     axis=1).astype(np.uint32)
    rslot = nat.reverse.find_slots(rkeys)
    # reverse rows are the 4 session-key words padded to the 8-word
    # gather-fast shape — only the key words carry meaning
    paired = (rslot >= 0) & (nat.reverse.vals[np.maximum(rslot, 0), :4]
                             == keys.astype(np.uint32)).all(axis=1)
    for j in np.nonzero(~has_blk)[0]:
        report.add("nat-session-orphan", _ip(int(src_ip[j])),
                   f"session slot {int(occupied[j])} has no allocator block")
    for j in np.nonzero(outside)[0]:
        report.add("nat-session-outside-block", _ip(int(src_ip[j])),
                   f"session maps to {_ip(int(nat_ip[j]))}:{int(nat_port[j])} outside "
                   f"block {int(b_lo[at[j]])}-{int(b_hi[at[j]])}")
    for j in np.nonzero(~paired)[0]:
        report.add("nat-missing-reverse", _ip(int(src_ip[j])),
                   f"session slot {int(occupied[j])} has no matching reverse row")
    n_rev = int(np.count_nonzero(nat.reverse.used))
    if n_rev != len(occupied):
        report.add("nat-reverse-count", "nat_reverse",
                   f"{n_rev} reverse rows != {len(occupied)} sessions "
                   f"(orphan reverse rows DNAT dead flows)")
    if nat.flags & FLAG_EIM and len(occupied):
        eps, first, counts = np.unique(vals[:, [SV_ORIG_IP, SV_ORIG_PORT, SV_PROTO]], axis=0,
                                       return_index=True, return_counts=True)
        for k in np.argsort(first, kind="stable"):  # first-seen order
            ep = (int(eps[k, 0]), int(eps[k, 1]), int(eps[k, 2]))
            n = int(counts[k])
            m = nat.eim.get(ep)
            if m is not None and m[2] != n:
                report.add("nat-eim-refcount", _ip(ep[0]),
                           f"eim {ep} refcount {m[2]} != {n} live sessions")


# ---------------------------------------------------------------------------
# DHCPv6 / PPPoE: lease books vs their pools
# ---------------------------------------------------------------------------

def _audit_dhcpv6(report: AuditReport, dhcpv6) -> None:
    """v6 lease book vs pool bitmaps, both directions: every IA_NA/IA_PD
    binding must be allocated in its pool (a binding outside the bitmap
    can be re-granted -> v6 double-lease), and every allocated address
    must have a binding (an orphan allocation is an address leak the
    pool can never hand out again). Advertise-only allocations release
    before the server returns, so the book and the bitmaps agree exactly
    at every quiesce point."""
    if dhcpv6 is None:
        return
    leased_na: dict[bytes, list] = {}
    leased_pd: dict[bytes, list] = {}
    for (duid, iaid, is_pd), lease in dhcpv6.leases.items():
        (leased_pd if is_pd else leased_na).setdefault(
            lease.address, []).append((duid.hex(), iaid))
    report.checks["v6_leases_na"] = len(leased_na)
    report.checks["v6_leases_pd"] = len(leased_pd)
    for addr, owners in leased_na.items():
        if len(owners) > 1:
            report.add("v6-double-lease", _ip6(addr),
                       f"IA_NA address bound to {len(owners)} clients")
    for addr, owners in leased_pd.items():
        if len(owners) > 1:
            report.add("v6-double-lease", _ip6(addr),
                       f"IA_PD prefix delegated to {len(owners)} clients")
    for pool, book, kind in ((dhcpv6.addr_pool, leased_na, "IA_NA"),
                             (dhcpv6.prefix_pool, leased_pd, "IA_PD")):
        if pool is None:
            continue
        allocated = set(pool._allocated)
        for addr in book:
            if addr not in allocated:
                report.add("v6-lease-not-allocated", _ip6(addr),
                           f"{kind} binding not marked allocated in its "
                           f"pool — re-grantable while bound")
        for addr in allocated - set(book):
            report.add("v6-alloc-orphan", _ip6(addr),
                       f"{kind} pool allocation with no binding — the "
                       f"address leaked out of circulation")
        # free-list hygiene: a free offset that is also allocated would
        # double-grant on the next allocate()
        alloc_offs = set(pool._allocated.values())
        for off in pool._free:
            if off in alloc_offs:
                report.add("v6-free-allocated-overlap", f"{kind}+{off}",
                           "pool offset is both free and allocated")


def _audit_pppoe(report: AuditReport, pppoe, pools) -> None:
    """PPPoE session store vs the v4 pools: every established session's
    assigned IP must be allocated in a configured pool, and no address
    may back two live sessions (the IPCP grant and the pool bitmap are
    separate writers — exactly the two-authority shape this auditor
    exists for)."""
    if pppoe is None:
        return
    by_ip: dict[int, list[int]] = {}
    n = 0
    for sess in pppoe.sessions.all():
        if not sess.assigned_ip:
            continue
        n += 1
        by_ip.setdefault(sess.assigned_ip, []).append(sess.session_id)
        if pools is not None:
            pool = pools.pool_for_ip(sess.assigned_ip)
            if pool is None:
                report.add("pppoe-lease-outside-pools",
                           _ip(sess.assigned_ip),
                           f"session {sess.session_id} assigned an IP "
                           f"outside every configured pool")
            elif sess.assigned_ip not in pool._allocated:
                report.add("pppoe-lease-not-allocated",
                           _ip(sess.assigned_ip),
                           f"session {sess.session_id} IP not marked "
                           f"allocated in pool {pool.pool_id}")
    for ip, sids in by_ip.items():
        if len(sids) > 1:
            report.add("pppoe-double-lease", _ip(ip),
                       f"IP assigned to sessions {sorted(sids)}")
    report.checks["pppoe_sessions"] = n


def _ip6(addr: bytes) -> str:
    import ipaddress

    try:
        return str(ipaddress.IPv6Address(int.from_bytes(addr, "big")))
    except Exception:  # noqa: BLE001 — a bad value is still a subject
        return addr.hex()


# ---------------------------------------------------------------------------
# checkpoint round trip
# ---------------------------------------------------------------------------

def _audit_checkpoint_roundtrip(report: AuditReport, *, fastpath=None,
                                nat=None, dhcp=None) -> None:
    """save -> encode -> decode must be state-identical: same meta, same
    arrays, and a re-encode of the decode is byte-identical. Runs with
    engine=None — the caller already quiesced; this must not re-enter
    the barrier."""
    from bng_tpu_torch.runtime.checkpoint import (build_checkpoint,
                                                  decode_checkpoint,
                                                  encode_checkpoint)

    if fastpath is None and nat is None and dhcp is None:
        return
    c1 = build_checkpoint(0, 0.0, fastpath=fastpath, nat=nat, dhcp=dhcp,
                          node_id="audit")
    e1 = encode_checkpoint(c1)
    report.checks["ckpt_bytes"] = len(e1)
    try:
        d = decode_checkpoint(e1)
    except Exception as e:  # noqa: BLE001 — a reject IS the finding
        report.add("ckpt-roundtrip-reject", "checkpoint",
                   f"fresh snapshot failed to decode: {e}")
        return
    if json.dumps(c1.meta, sort_keys=True) != json.dumps(d.meta,
                                                         sort_keys=True):
        report.add("ckpt-roundtrip-mismatch", "meta",
                   "decoded meta differs from the snapshot")
    if sorted(c1.arrays) != sorted(d.arrays):
        report.add("ckpt-roundtrip-mismatch", "arrays",
                   f"array manifest differs: {sorted(c1.arrays)[:4]}... vs "
                   f"{sorted(d.arrays)[:4]}...")
        return
    for name in sorted(c1.arrays):
        if not np.array_equal(np.asarray(c1.arrays[name]),
                              d.arrays[name]):
            report.add("ckpt-roundtrip-mismatch", name,
                       "decoded array differs from the snapshot")
    if encode_checkpoint(d) != e1:
        report.add("ckpt-roundtrip-mismatch", "bytes",
                   "re-encoding the decode is not byte-identical")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _ip(ip: int) -> str:
    from bng_tpu_torch.utils.net import u32_to_ip

    try:
        return u32_to_ip(int(ip))
    except Exception:  # noqa: BLE001 — a bad value is still a subject
        return str(ip)


def _audit_sharded(report: AuditReport, cluster, dhcp=None,
                   max_drain_steps: int = 64) -> None:
    """The sharded dataplane's cross-authority clause: shard-local tables must PARTITION the
    global authority —

    * every DHCP row lives on exactly the shard its key hashes to, and
      no key is resident on two shards (the fleet's "no IP reachable
      from two workers" clause at the chip level);
    * chip-local state (QoS rows, antispoof bindings, garden
      membership, NAT port blocks) lives on the subscriber's affinity
      shard and nowhere else — the ring steers traffic there, so a
      misplaced row is state the dataplane can never reach;
    * NAT public-IP ownership is exclusive across shards (downstream
      steering is by-IP: shared ownership is unroutable);
    * the union of shard-resident subscriber rows covers the lease
      book: every lease's row on its owner shard (sums to the global
      authority, no row orphaned by a re-shard);
    * after draining pending deltas, every shard's device slice equals
      its host mirror bit-exact (the single-engine mirror proof, per
      shard).
    """
    if cluster is None:
        return
    from bng_tpu_torch.ops.antispoof import AB_IPV4, AB_VALIDS, VALID_V4
    from bng_tpu_torch.ops.qtable import QW_FLAGS as _QF, QW_KEY as _QK
    from bng_tpu_torch.ops.table import shard_owner

    n = cluster.n
    report.checks["shards"] = n

    # -- partition: dhcp rows on their owner shard, no double-residency
    for t in ("sub", "vlan", "cid"):
        seen: dict[bytes, int] = {}
        total = 0
        for i in range(n):
            tbl = getattr(cluster.fastpath[i], t)
            used = np.nonzero(tbl.used)[0]
            total += len(used)
            if not len(used):
                continue
            keys = tbl.keys[used]
            owners = np.asarray(shard_owner(
                [keys[:, k] for k in range(keys.shape[1])], n))
            for r in np.nonzero(owners != i)[0]:
                report.add("shard-misplaced-row",
                           f"fastpath.{t}/shard{i}",
                           f"key {keys[int(r)].tolist()} hashes to shard "
                           f"{int(owners[int(r)])} but is resident on "
                           f"shard {i}: the device lookup routes probes "
                           f"to the owner, so this row is unreachable")
            for r in range(len(keys)):
                kb = keys[r].tobytes()
                prev = seen.get(kb)
                if prev is not None and prev != i:
                    report.add("shard-double-owner", f"fastpath.{t}",
                               f"key {keys[r].tolist()} resident on "
                               f"shards {prev} AND {i}: two shards "
                               f"claim one subscriber row")
                else:
                    seen[kb] = i
        report.checks[f"shard_rows.{t}"] = total

    # -- chip-local state on the affinity shard
    for i in range(n):
        for side in ("up", "down"):
            host = getattr(cluster.qos[i], side)
            for s in np.nonzero((host.rows[:, _QF] & 1) != 0)[0]:
                ip = int(host.rows[int(s), _QK])
                o = cluster.affinity_shard_ip(ip)
                if o != i:
                    report.add("shard-misplaced-affinity",
                               f"qos.{side}/shard{i}",
                               f"{_ip(ip)} affinity shard is {o}; the "
                               f"ring never steers its traffic here")
        sp = cluster.spoof[i].bindings
        for s in np.nonzero(sp.used)[0]:
            if not (int(sp.vals[int(s)][AB_VALIDS]) & VALID_V4):
                continue  # v6-only binding: no v4 affinity key
            ip = int(sp.vals[int(s)][AB_IPV4])
            o = cluster.affinity_shard_ip(ip)
            if o != i:
                report.add("shard-misplaced-affinity",
                           f"antispoof/shard{i}",
                           f"binding for {_ip(ip)} belongs on shard {o}")
        if cluster.garden is not None:
            gd = cluster.garden[i].subscribers
            for s in np.nonzero(gd.used)[0]:
                ip = int(gd.keys[int(s)][0])
                o = cluster.affinity_shard_ip(ip)
                if o != i:
                    report.add("shard-misplaced-affinity",
                               f"garden/shard{i}",
                               f"membership for {_ip(ip)} belongs on "
                               f"shard {o}")
        for priv in cluster.nat[i].blocks:
            o = cluster.affinity_shard_ip(int(priv))
            if o != i:
                report.add("shard-misplaced-affinity",
                           f"nat/shard{i}",
                           f"port block for {_ip(int(priv))} belongs on "
                           f"shard {o}")
        if cluster.edge is not None:
            for t in ("tap", "route"):
                for ip, _row in getattr(cluster.edge[i], f"{t}_rows")():
                    o = cluster.affinity_shard_ip(int(ip))
                    if o != i:
                        report.add("shard-misplaced-affinity",
                                   f"edge.{t}/shard{i}",
                                   f"{t} row for {_ip(int(ip))} belongs "
                                   f"on shard {o}; the ring never "
                                   f"steers its traffic here")

    # -- NAT public-IP exclusivity (downstream steering is by-IP)
    try:
        report.checks["shard_pub_ips"] = len(cluster.pub_ip_map())
    except ValueError as e:
        report.add("shard-pub-ip-conflict", "nat", str(e))

    # -- shard rows sum to the global lease authority
    if dhcp is not None:
        report.checks["shard_leases"] = len(dhcp.leases)
        for mac_u64 in dhcp.leases:
            o = cluster.dhcp_sub_shard(int(mac_u64))
            if cluster.fastpath[o].get_subscriber(int(mac_u64)) is None:
                lease = dhcp.leases[mac_u64]
                report.add("shard-lease-unbacked", f"shard{o}",
                           f"lease {lease.mac.hex()} -> {_ip(lease.ip)} "
                           f"has no subscriber row on its owner shard")

    # -- per-shard host == device mirror (after draining pending deltas)
    if cluster.tables is None:
        return
    B = cluster.n * cluster.b
    # pkt slot must cover the DHCP canon region even for all-idle lanes
    # (the program's shapes are static)
    zero_pkt = np.zeros((B, 512), dtype=np.uint8)
    zero_len = np.zeros((B,), dtype=np.uint32)
    zero_fa = np.zeros((B,), dtype=bool)
    steps = 0
    while cluster.pending_dirty() > 0 and steps < max_drain_steps:
        # an empty sharded step still runs the bounded update drain
        # (deterministic at now=0: zero-length lanes are not real, so
        # no verdict/stat depends on the clock)
        cluster.step(zero_pkt, zero_len, zero_fa, 0, 0)
        steps += 1
    if cluster.pending_dirty() > 0:
        report.add("mirror-undrained", "sharded",
                   f"{cluster.pending_dirty()} dirty slots after "
                   f"{steps} drain steps")
        return
    cluster.quiesce()
    report.checks["shard_mirror_drain_steps"] = steps
    for i, dev in enumerate(cluster.tables):  # one PipelineTables per shard
        for t in ("sub", "vlan", "cid"):
            _table_mirror_findings(
                report, getattr(cluster.fastpath[i], t), getattr(dev.dhcp, t),
                f"shard{i}.fastpath.{t}")
        if not np.array_equal(cluster.fastpath[i].pools, _words(dev.dhcp.pools)):
            report.add("mirror-mismatch", f"shard{i}.fastpath.pools",
                       "device pool config differs from host")
        if cluster.edge is not None and dev.tap is not None:
            for t, dt in (("tap", dev.tap), ("route", dev.route)):
                _table_mirror_findings(
                    report, getattr(cluster.edge[i], t), dt, f"shard{i}.edge.{t}")
            if not np.array_equal(cluster.edge[i].tap_filters, _words(dev.tap_filters)):
                report.add("mirror-mismatch",
                           f"shard{i}.edge.tap_filters",
                           "device filter rows differ from host")
            if not np.array_equal(cluster.edge[i].tap_config, _words(dev.tap_config)):
                report.add("mirror-mismatch",
                           f"shard{i}.edge.tap_config",
                           "device armed predicate differs from host")


def audit_invariants(*, engine=None, scheduler=None, fastpath=None,
                     pools=None, dhcp=None, fleet=None, nat=None,
                     dhcpv6=None, pppoe=None, edge=None, tap_program=None,
                     route_program=None, cluster=None, bng_cluster=None,
                     ha_pair=None, quiesce=True,
                     check_roundtrip=True) -> AuditReport:
    """Run every applicable invariant over the components given.

    With an `engine`, runs at the same drain barrier checkpoints use
    (scheduler.quiesce() when a scheduler owns the loop, else
    engine.quiesce()) and includes the host-vs-device mirror proof;
    fastpath/nat default from the engine. The reference's `fleet`,
    `ha_pair` and `bng_cluster` name components the port does not have:
    None is accepted and audits nothing, anything else raises.
    """
    given = [k for k, v in (("fleet", fleet), ("ha_pair", ha_pair),
                            ("bng_cluster", bng_cluster))
             if v is not None]
    if given:
        raise ValueError(f"audit_invariants: no such component in the port: {given}")
    report = AuditReport()
    if engine is not None:
        if quiesce:
            if scheduler is not None:
                scheduler.quiesce()
            else:
                engine.quiesce()
        fastpath = fastpath if fastpath is not None else engine.fastpath
        nat = nat if nat is not None else engine.nat
    if cluster is not None:
        if quiesce:
            cluster.quiesce()
        _audit_sharded(report, cluster, dhcp=dhcp)
        # each shard's NAT authority must be internally consistent too
        # (allocator/EIM/session/reverse mutual consistency, per shard)
        if nat is None:
            for _i in range(cluster.n):
                _audit_nat(report, cluster.nat[_i])

    _audit_ownership(report, pools, dhcp)
    _audit_fastpath_rows(report, fastpath, dhcp)
    _audit_device_mirror(report, engine)
    _audit_nat(report, nat)
    _audit_dhcpv6(report, dhcpv6)
    _audit_pppoe(report, pppoe, pools)
    if edge is None and engine is not None:
        edge = getattr(engine, "edge", None)
    if edge is None and cluster is not None \
            and getattr(cluster, "edge", None) is not None:
        # the merged owner-routed surface IS the cluster audit surface
        edge = cluster
    _audit_edge(report, edge, tap_program, route_program)
    if check_roundtrip:
        _audit_checkpoint_roundtrip(report, fastpath=fastpath, nat=nat,
                                    dhcp=dhcp)

    if not report.ok:
        # flight-recorder anomaly hook: an invariant violation asks an
        # armed recorder to keep the evidence the moment it is proven.
        # Disarmed: one global load + None compare.
        tele.trigger("invariant_violation", str(report.violations_by_kind()))
    return report


def audit_app(app) -> AuditReport:
    """Audit a composed BNGApp (the `checkpoint restore --audit` entry):
    pulls the live components out of the composition root and runs the
    full invariant set."""
    c = app.components
    return audit_invariants(
        engine=c.get("engine"), scheduler=c.get("scheduler"),
        fastpath=c.get("fastpath"), pools=c.get("pools"),
        dhcp=c.get("dhcp"), nat=c.get("nat"),
        dhcpv6=c.get("dhcpv6"), pppoe=c.get("pppoe"))
