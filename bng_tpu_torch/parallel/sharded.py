"""N-shard BNG (port of `bng_tpu/parallel/sharded.py`).

The reference's scale-out design, with the shards of its mesh kept as N
logical shards of one process:

- **Packets are data-parallel.** The host ring steers each subscriber's
  traffic to its affinity shard (`runtime/ring.py` `shard_of`: upstream
  by FNV-1a32 of the private source IP, downstream by NAT public-IP
  ownership), and `assemble_sharded` puts shard i's lanes at rows
  i*b..(i+1)*b of the batch.
- **Flow state is shard-local.** NAT sessions, QoS buckets, antispoof
  bindings, garden membership, PPPoE sessions and edge rows live on the
  shard that owns the subscriber (`affinity_shard_ip`).
- **The DHCP tables are hash-sharded.** A DISCOVER or REQUEST may arrive
  on any shard; its three lookups (VLAN, circuit ID, MAC) probe each key
  on its owner shard through the bounded exchange of
  `ops/table.py:sharded_lookup`. Lanes past a destination's capacity
  punt to the slow path (PASS), never a wrong reply.
- **Stats are summed over shards** and wrap at 2^32, as the reference's
  `psum` of uint32 does.

Each shard is an `Engine` over its own host tables (one `PipelineTables`
per shard, on the device the shard-to-device map gives it; one device
for every shard here, `parallel/exchange.py`). A step first applies
every shard's bounded update drain, then runs the shards' steps in turn:
a lookup reads other shards' DHCP tables, so a row drained on one shard
is visible to every other shard's lanes of the same step, as under the
reference's barrier. Running the shards in turn is sound because no
stage writes a DHCP table during the step.

Host side: `ShardedCluster` routes every control-plane write to its
owner shard (DHCP rows by key hash, the rest by subscriber affinity),
serves `step`, `dhcp_step`, `process_ring` and `process_ring_pipelined`
(outputs through `_InFlight`: a dispatch makes no host round trip), and
the maintenance verbs (`quiesce`, `resync_tables`, `fetch_session_vals`,
`expire`). `ShardTelemetry` keeps per-shard stage histograms and verdict
counters. Checkpoint and swap (`runtime/checkpoint.py`, `runtime/ops.py`)
use `fold_device_authoritative` (each shard's engine folds its own rows),
`shard_components`, `clone_empty(n_shards)` (an empty cluster of the same
per-shard geometry: the swap's standby and the re-shard target) and
`adopt_authorities`; `tap_rows` / `route_rows` are the merged audit walk.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bng_tpu_torch import frames as F
from bng_tpu_torch import resolve_device
from bng_tpu_torch.control.nat import NATManager
from bng_tpu_torch.edge.tables import EdgeTables
from bng_tpu_torch.ops.dhcp import ST_HIT, DHCPTables, dhcp_fastpath
from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.parse import parse_batch
from bng_tpu_torch.ops.pipeline import (
    VERDICT_DROP, VERDICT_PASS, VERDICT_TX, PipelineGeom, PipelineResult, pipeline_step,
)
from bng_tpu_torch.ops.table import ShardedTable, shard_owner, to_device
from bng_tpu_torch.parallel.exchange import DeviceLocalExchange
from bng_tpu_torch.runtime.engine import (
    _STAT_FIELDS, AntispoofTables, DhcpBatchResult, Engine, EngineStats, GardenTables, QoSTables,
    _apply_all_updates, _InFlight,
)
from bng_tpu_torch.runtime.ring import FLAG_DHCP_CTRL, FLAG_FROM_ACCESS
from bng_tpu_torch.runtime.tables import (
    FastPathTables, PPPoEFastPathTables, apply_fastpath_updates, pack_cid_host,
)
from bng_tpu_torch.telemetry.hist import LatencyHist
from bng_tpu_torch.utils.net import fnv1a32, mac_to_u64, split_u64
from bng_tpu_torch.utils.structlog import ErrorLog

AXIS = "shard"

# lane outputs concatenated over shards; the stats are summed instead
_LANE_FIELDS = ("verdict", "out_pkt", "out_len", "nat_punt", "spoof_violation", "mirror")
_STAT_LEN = {name: len(getattr(EngineStats(), name)) for name, _ in _STAT_FIELDS}


def _sharded_geom(geom: PipelineGeom, n: int) -> PipelineGeom:
    """Mark the three DHCP lookup tables as hash-sharded over the shard axis.

    Only tables whose miss falls through to an authoritative slow path may
    be sharded: an overflowed lane of the bounded exchange punts as
    found=False, which for the DHCP tables is a slow-path request the
    server answers. Antispoof would drop and QoS would stop shaping, so
    those stay shard-local (qos_kernel refuses a sharded geometry)."""
    dhcp = geom.dhcp._replace(
        sub=geom.dhcp.sub._replace(axis=AXIS, n_shards=n),
        vlan=geom.dhcp.vlan._replace(axis=AXIS, n_shards=n),
        cid=geom.dhcp.cid._replace(axis=AXIS, n_shards=n),
    )
    return geom._replace(dhcp=dhcp)


def _sum_stats(parts):
    """Per-shard uint32 stats summed with the reference's psum wrap."""
    return torch.stack(parts).sum(0) & MASK32


def _shard_dhcp(dhcp: list[DHCPTables], i: int, exchange) -> DHCPTables:
    """Shard i's DHCP tables with the three lookup tables seen through the
    exchange (every shard's state, looked up from shard i)."""
    return DHCPTables(
        sub=ShardedTable(tuple(d.sub for d in dhcp), i, exchange),
        vlan=ShardedTable(tuple(d.vlan for d in dhcp), i, exchange),
        cid=ShardedTable(tuple(d.cid for d in dhcp), i, exchange),
        pools=dhcp[i].pools, server=dhcp[i].server)


def sharded_step(tables: list, exchange, pkt: list, length: list, from_access: list,
                 geom_sharded: PipelineGeom, now_s, now_us) -> PipelineResult:
    """The sharded fused step over already-drained tables: each shard's
    `pipeline_step` on its lanes (pkt[i] etc.), its DHCP lookups through
    the exchange, in shard order. One `PipelineResult` for the whole
    batch: lanes concatenated in shard order, stats summed (uint32 wrap);
    its `tables` are the shards' tables, updated in place."""
    dhcp = [t.dhcp for t in tables]
    res = [pipeline_step(t._replace(dhcp=_shard_dhcp(dhcp, i, exchange)), pkt[i], length[i],
                         from_access[i], geom_sharded, now_s, now_us)
           for i, t in enumerate(tables)]
    out = {}
    for f in _LANE_FIELDS:
        if getattr(res[0], f) is not None:
            out[f] = torch.cat([getattr(r, f) for r in res])
    for _, f in _STAT_FIELDS:
        if getattr(res[0], f) is not None:
            out[f] = _sum_stats([getattr(r, f) for r in res])
    return PipelineResult(tables=tables, priority=None, **out)


def sharded_dhcp_step(dhcp: list[DHCPTables], exchange, pkt: list, length: list,
                      geom_sharded: PipelineGeom, now_s) -> DhcpBatchResult:
    """The sharded DHCP-only program over already-drained tables: parse and
    the responder per shard, lookups through the exchange; TX where a
    shard answered, else PASS; stats summed."""
    res = [dhcp_fastpath(pkt[i], length[i], parse_batch(pkt[i], length[i]),
                         _shard_dhcp(dhcp, i, exchange), geom_sharded.dhcp, now_s)
           for i in range(len(dhcp))]
    is_reply = torch.cat([r.is_reply for r in res])
    return DhcpBatchResult(
        verdict=torch.where(is_reply, VERDICT_TX, VERDICT_PASS).to(torch.int32),
        out_pkt=torch.cat([r.out_pkt for r in res]),
        out_len=torch.cat([r.out_len for r in res]),
        dhcp_stats=_sum_stats([r.stats for r in res]))


class ShardTelemetry:
    """Per-shard stage histograms and verdict/punt counters (the reference's
    `ShardTelemetry`).

    Two host-visible times per step: the `dispatch` (upload, drain,
    queueing the shards' steps) and the `device_wait` (the retire's wait
    for the outputs), one lap per step into each shard that had real
    lanes (`total` = dispatch + wait). Per shard, the work: verdicts
    (pass/drop/tx/fwd), NAT punts and antispoof violations, counted over
    the shard's lane region. A PASS lane whose frame's affinity owner is
    another shard is a `missteer` (counted at retire by the ring loops);
    `pass_total` holds only the legitimate slow-path punts. The DHCP hit
    counter is the summed one. Histograms merge by counter addition."""

    STAGES = ("dispatch", "device_wait", "total")
    VERDICT_NAMES = ("pass", "drop", "tx", "fwd")

    def __init__(self, n_shards: int, batch_per_shard: int):
        self.n = n_shards
        self.b = batch_per_shard
        self.hists = [{s: LatencyHist() for s in self.STAGES} for _ in range(n_shards)]
        self.frames = np.zeros((n_shards,), dtype=np.int64)
        self.verdicts = np.zeros((n_shards, 4), dtype=np.int64)
        self.nat_punts = np.zeros((n_shards,), dtype=np.int64)
        self.missteers = np.zeros((n_shards,), dtype=np.int64)
        self.violations = np.zeros((n_shards,), dtype=np.int64)
        self.dhcp_replies = np.zeros((n_shards,), dtype=np.int64)
        self.psum_dhcp_hits = 0
        self.steps = 0

    def _active(self, length) -> np.ndarray:
        real = (np.asarray(length) > 0).reshape(self.n, self.b)
        self.frames += real.sum(axis=1)
        return real

    def _lap(self, shard_active: np.ndarray, dispatch_us: float, wait_us: float) -> None:
        for i in np.nonzero(shard_active)[0]:
            h = self.hists[int(i)]
            h["dispatch"].record(dispatch_us)
            h["device_wait"].record(wait_us)
            h["total"].record(dispatch_us + wait_us)
        self.steps += 1

    def _per_shard(self, mask, real) -> np.ndarray:
        return (np.asarray(mask).reshape(self.n, self.b) & real).sum(axis=1)

    def record_fused(self, length, verdict, nat_punt, viol, dhcp_hits: int,
                     dispatch_us: float, wait_us: float, missteer=None) -> None:
        real = self._active(length)
        v = np.asarray(verdict).reshape(self.n, self.b)
        for k in range(4):
            self.verdicts[:, k] += ((v == k) & real).sum(axis=1)
        if nat_punt is not None:
            self.nat_punts += self._per_shard(nat_punt, real)
        if missteer is not None:
            self.missteers += self._per_shard(missteer, real)
        if viol is not None:
            self.violations += self._per_shard(viol, real)
        self.psum_dhcp_hits += int(dhcp_hits)
        self._lap(real.any(axis=1), dispatch_us, wait_us)

    def record_dhcp(self, length, is_reply, dhcp_hits: int, dispatch_us: float,
                    wait_us: float) -> None:
        real = self._active(length)
        rep = np.asarray(is_reply).reshape(self.n, self.b) & real
        self.dhcp_replies += rep.sum(axis=1)
        self.verdicts[:, 2] += rep.sum(axis=1)  # replies TX
        self.verdicts[:, 0] += (real & ~rep).sum(axis=1)  # misses punt
        self.psum_dhcp_hits += int(dhcp_hits)
        self._lap(real.any(axis=1), dispatch_us, wait_us)

    def merged(self) -> dict:
        """Every shard's histograms folded into one per stage (counter addition)."""
        out = {s: LatencyHist() for s in self.STAGES}
        for shard in self.hists:
            for s in self.STAGES:
                out[s].merge(shard[s])
        return out

    def snapshot(self) -> dict:
        """The MULTICHIP-TELEMETRY payload: per-shard summaries and counters,
        the merged view and the summed DHCP hit counter."""
        per_shard = []
        for i in range(self.n):
            verdicts = {name: int(self.verdicts[i, k])
                        for k, name in enumerate(self.VERDICT_NAMES)}
            verdicts["pass"] -= int(self.missteers[i])
            per_shard.append({
                "frames": int(self.frames[i]),
                "verdicts": verdicts,
                "nat_punts": int(self.nat_punts[i]),
                "missteers": int(self.missteers[i]),
                "violations": int(self.violations[i]),
                "dhcp_replies": int(self.dhcp_replies[i]),
                "stages": {s: self.hists[i][s].summary()
                           for s in self.STAGES if self.hists[i][s].n},
            })
        return {
            "shards": self.n,
            "steps": self.steps,
            "psum_dhcp_hits": self.psum_dhcp_hits,
            "pass_total": int(self.verdicts[:, 0].sum() - self.missteers.sum()),
            "missteer_total": int(self.missteers.sum()),
            "nat_punt_total": int(self.nat_punts.sum()),
            "per_shard": per_shard,
            "merged_stages": {s: h.summary() for s, h in self.merged().items() if h.n},
        }


class ShardedCluster:
    """N-shard BNG on one device. Control-plane writes route to their owners."""

    def __init__(
        self,
        n_shards: int,
        batch_per_shard: int = 64,
        sub_nbuckets: int = 256,
        vlan_nbuckets: int = 64,
        cid_nbuckets: int = 64,
        max_pools: int = 16,
        nat_sessions_nbuckets: int = 256,
        nat_ports_per_subscriber: int = 1024,
        qos_nbuckets: int = 256,
        spoof_nbuckets: int = 256,
        public_ips: list[int] | None = None,
        garden_enabled: bool = True,
        pppoe_enabled: bool = False,
        pppoe_nbuckets: int = 256,
        server_mac: bytes = b"\x02\xbb\x00\x00\x00\x01",
        edge_enabled: bool = False,
        edge_nbuckets: int = 256,
        device=None,
        nat_sub_nbuckets: int = 256,
        public_ips_per_shard: int = 1,
    ):
        # every argument but the shard count, for clone_empty
        self._ctor_kwargs = {k: v for k, v in locals().items() if k not in ("self", "n_shards")}
        self.n = n_shards
        self.b = batch_per_shard
        self.device = resolve_device(device)
        # the shard-to-device map: every shard on the one device here
        self.shard_devices = [self.device] * n_shards
        self.exchange = DeviceLocalExchange(self.shard_devices)
        self.fastpath = [
            FastPathTables(sub_nbuckets=sub_nbuckets, vlan_nbuckets=vlan_nbuckets,
                           cid_nbuckets=cid_nbuckets, max_pools=max_pools)
            for _ in range(n_shards)
        ]
        # shard i's NAT pool owns public IPs [i*k, (i+1)*k) of the list, k =
        # public_ips_per_shard (the reference: one each, and 256 sub_nat
        # buckets; a deployment of many NAT subscribers per shard raises both)
        k = public_ips_per_shard
        base_pub = public_ips or [0xCB007100 + i for i in range(n_shards * k)]
        if len(base_pub) < n_shards * k:
            # downstream steering is by public-IP ownership: one public IP
            # cannot belong to two shards
            raise ValueError(
                f"need >= {n_shards * k} public IPs for {n_shards} shards (got {len(base_pub)}): "
                f"each shard's NAT pool must own its public IPs exclusively")
        self.nat = [
            NATManager(public_ips=list(base_pub[i * k: (i + 1) * k]),
                       sessions_nbuckets=nat_sessions_nbuckets,
                       ports_per_subscriber=nat_ports_per_subscriber,
                       sub_nat_nbuckets=nat_sub_nbuckets)
            for i in range(n_shards)
        ]
        self.qos = [QoSTables(nbuckets=qos_nbuckets) for _ in range(n_shards)]
        self.spoof = [AntispoofTables(nbuckets=spoof_nbuckets) for _ in range(n_shards)]
        self.garden = ([GardenTables(nbuckets=spoof_nbuckets) for _ in range(n_shards)]
                       if garden_enabled else None)
        # PPPoE rows (by_sid and by_ip) live on the subscriber's affinity
        # shard: the ring steers session DATA by the inner source IP
        self.pppoe = ([PPPoEFastPathTables(nbuckets=pppoe_nbuckets, server_mac=server_mac)
                       for _ in range(n_shards)] if pppoe_enabled else None)
        self.edge = ([EdgeTables(nbuckets=edge_nbuckets) for _ in range(n_shards)]
                     if edge_enabled else None)
        # retire hook for mirrored lanes: (lane, frame, warrant id)
        self.mirror_sink = None
        self.geom = PipelineGeom(
            dhcp=self.fastpath[0].geom, nat=self.nat[0].geom, qos=self.qos[0].geom,
            spoof=self.spoof[0].geom,
            garden=self.garden[0].geom if garden_enabled else None,
            pppoe=self.pppoe[0].geom if pppoe_enabled else None,
            tap=self.edge[0].geom if edge_enabled else None,
            route=self.edge[0].geom if edge_enabled else None,
        )
        self.geom_sharded = _sharded_geom(self.geom, n_shards)
        self.engines: list[Engine] | None = None  # built by the first step or sync_tables()
        self._ring_bufs = [None, None]  # ping-pong ring staging
        self._stage_idx = 0
        self._inflight = None  # the pipelined loop's dispatched window
        self.stats: dict = {"slow_errors": 0}  # per-step deltas folded by the ring loops
        self._slow_err_log = ErrorLog("slowpath", "slow-path handler failed", level="error",
                                      component="sharded")
        self.telemetry = ShardTelemetry(n_shards, batch_per_shard)
        self._pub_owner_cache: dict[int, int] | None = None

    # ---- owner routing (agrees with shard_owner on the device) ----
    def dhcp_sub_shard(self, mac) -> int:
        key = mac_to_u64(mac) if not isinstance(mac, int) else mac
        lo, hi = split_u64(key)
        return int(shard_owner([np.array([hi], np.uint32), np.array([lo], np.uint32)],
                               self.n)[0])

    def dhcp_vlan_shard(self, s_tag: int, c_tag: int) -> int:
        return int(shard_owner([np.array([(s_tag << 16) | c_tag], np.uint32)], self.n)[0])

    def dhcp_cid_shard(self, circuit_id: bytes) -> int:
        w = pack_cid_host(circuit_id)
        return int(shard_owner([w[i: i + 1] for i in range(8)], self.n)[0])

    def affinity_shard_ip(self, private_ip: int) -> int:
        """The shard a subscriber's traffic is steered to, and so the only
        shard whose NAT/QoS/antispoof state for it is consulted: FNV-1a32
        over the 4 wire-order IP bytes, mod n (the ring's `shard_of`)."""
        return fnv1a32(int(private_ip).to_bytes(4, "big")) % self.n

    # ---- subscriber-affinity placement ----
    def allocate_nat(self, private_ip: int, now: int = 0):
        """Carve a NAT port block on the subscriber's owner shard.
        Returns (owner_shard, allocation)."""
        o = self.affinity_shard_ip(private_ip)
        return o, self.nat[o].allocate_nat(private_ip, now)

    def handle_new_flow(self, src_ip: int, *args, **kw):
        o = self.affinity_shard_ip(src_ip)
        return o, self.nat[o].handle_new_flow(src_ip, *args, **kw)

    def set_qos(self, private_ip: int, **kw) -> int:
        o = self.affinity_shard_ip(private_ip)
        self.qos[o].set_subscriber(private_ip, **kw)
        return o

    def add_spoof_binding(self, mac, ipv4: int, mode: int) -> int:
        o = self.affinity_shard_ip(ipv4)
        self.spoof[o].add_binding(mac, ipv4, mode)
        return o

    def set_gardened(self, private_ip: int, gardened: bool) -> int:
        if self.garden is None:
            raise RuntimeError("device garden gate disabled for this cluster")
        o = self.affinity_shard_ip(private_ip)
        self.garden[o].set_gardened(private_ip, gardened)
        return o

    def allow_garden_destination(self, ip: int, port: int = 0, proto: int = 0) -> None:
        if self.garden is None:
            raise RuntimeError("device garden gate disabled for this cluster")
        for g in self.garden:  # policy is global; membership is per shard
            g.allow_destination(ip, port, proto)

    def pppoe_session_up(self, sess) -> int:
        """Publish an open PPPoE session (by_sid and by_ip) on its affinity shard."""
        if self.pppoe is None:
            raise RuntimeError("PPPoE disabled for this cluster")
        o = self.affinity_shard_ip(sess.assigned_ip)
        self.pppoe[o].session_up(sess)
        return o

    def pppoe_session_down(self, event) -> int:
        if self.pppoe is None:
            raise RuntimeError("PPPoE disabled for this cluster")
        sess = getattr(event, "session", event)
        o = self.affinity_shard_ip(sess.assigned_ip)
        self.pppoe[o].session_down(event)
        return o

    # ---- edge protection (rows on the subscriber's affinity shard) ----
    def _edge_or_raise(self) -> list[EdgeTables]:
        if self.edge is None:
            raise RuntimeError("edge protection disabled for this cluster")
        return self.edge

    def arm_tap(self, private_ip: int, wid: int, filters=()) -> int:
        edge = self._edge_or_raise()
        o = self.affinity_shard_ip(private_ip)
        edge[o].arm_tap(private_ip, wid, filters)
        # filter rows are warrant-global: every shard holds them
        for i, e in enumerate(edge):
            if i != o:
                e.set_tap_filters(wid, filters)
        return o

    def disarm_tap(self, private_ip: int) -> bool:
        return self._edge_or_raise()[self.affinity_shard_ip(private_ip)].disarm_tap(private_ip)

    def get_tap(self, private_ip: int):
        return self._edge_or_raise()[self.affinity_shard_ip(private_ip)].get_tap(private_ip)

    def set_tap_filters(self, wid: int, filters) -> int:
        """Replicated cluster-wide; the smallest per-shard write count, so a
        truncation anywhere reads as dropped."""
        return min(e.set_tap_filters(wid, filters) for e in self._edge_or_raise())

    def set_route(self, private_ip: int, nh_mac: bytes, table_id: int, klass: int = 0) -> int:
        edge = self._edge_or_raise()
        o = self.affinity_shard_ip(private_ip)
        edge[o].set_route(private_ip, nh_mac, table_id, klass)
        return o

    def clear_route(self, private_ip: int) -> bool:
        return self._edge_or_raise()[self.affinity_shard_ip(private_ip)].clear_route(private_ip)

    def get_route(self, private_ip: int):
        return self._edge_or_raise()[self.affinity_shard_ip(private_ip)].get_route(private_ip)

    def tap_rows(self):
        """Every shard's tap rows, by IP (the audit surface)."""
        return sorted((kv for e in self._edge_or_raise() for kv in e.tap_rows()),
                      key=lambda kv: kv[0])

    def route_rows(self):
        return sorted((kv for e in self._edge_or_raise() for kv in e.route_rows()),
                      key=lambda kv: kv[0])

    def pub_ip_map(self) -> dict[int, int]:
        """NAT public IP -> owner shard (downstream steering). Raises when two
        shards claim one public IP: return traffic could reach only one."""
        owners: dict[int, int] = {}
        for s in range(self.n):
            for ip in self.nat[s].public_ips:
                if ip in owners and owners[ip] != s:
                    raise ValueError(
                        f"public IP {ip:#x} owned by shards {owners[ip]} and {s}: downstream "
                        f"steering needs exclusive ownership (give each shard distinct public_ips)")
                owners[ip] = s
        return owners

    def make_ring(self, nframes: int = 4096, frame_size: int = 2048, depth: int = 1024,
                  prefer_native: bool = True):
        """A packet ring steering frames to this cluster's shards; its
        `assemble_sharded` layout is `step()`'s batch layout."""
        from bng_tpu_torch.runtime.ring import make_ring as _mk

        ring = _mk(nframes, frame_size, depth, prefer_native=prefer_native, n_shards=self.n)
        for ip, s in self.pub_ip_map().items():
            if not ring.steer_pub_ip(ip, s):
                # an unregistered public IP would fall back to dst-IP hashing
                # and punt every return packet on a wrong shard
                raise RuntimeError(
                    f"ring steering table rejected public IP {ip:#x} (capacity/probe bound); "
                    f"reduce public IPs per ring")
        return ring

    # ---- DHCP control-plane writes ----
    def add_pool_all(self, pool_id: int, network: int, prefix_len: int, gateway: int,
                     dns1: int = 0, dns2: int = 0, lease_time: int = 3600) -> None:
        for fp in self.fastpath:
            fp.add_pool(pool_id, network, prefix_len, gateway, dns1, dns2, lease_time)

    def set_server_config_all(self, mac, ip: int) -> None:
        for fp in self.fastpath:
            fp.set_server_config(mac, ip)

    def add_subscriber(self, mac, **kw) -> int:
        o = self.dhcp_sub_shard(mac)
        self.fastpath[o].add_subscriber(mac, **kw)
        return o

    def add_subscribers_bulk(self, macs_u64, pool_ids, ips, lease_expiries, **kw) -> np.ndarray:
        """Split subscribers by owner shard (the vectorized `shard_owner` the
        device routes with) and bulk-insert each shard's slice. Returns the
        owner of each. The next step (or sync_tables()) uploads in full."""
        macs_u64 = np.asarray(macs_u64, dtype=np.uint64)
        hi = (macs_u64 >> np.uint64(32)).astype(np.uint32)
        lo = (macs_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        owners = np.asarray(shard_owner([hi, lo], self.n))
        pool_ids = np.broadcast_to(np.asarray(pool_ids, dtype=np.uint32), macs_u64.shape)
        ips = np.broadcast_to(np.asarray(ips, dtype=np.uint32), macs_u64.shape)
        lease_expiries = np.broadcast_to(np.asarray(lease_expiries, dtype=np.uint32),
                                         macs_u64.shape)
        for s in range(self.n):
            m = owners == s
            if m.any():
                self.fastpath[s].add_subscribers_bulk(
                    macs_u64[m], pool_ids=pool_ids[m], ips=ips[m],
                    lease_expiries=lease_expiries[m], **kw)
        return owners

    def add_vlan_subscriber(self, s_tag: int, c_tag: int, **kw) -> int:
        o = self.dhcp_vlan_shard(s_tag, c_tag)
        self.fastpath[o].add_vlan_subscriber(s_tag, c_tag, **kw)
        return o

    def add_circuit_id_subscriber(self, circuit_id: bytes, **kw) -> int:
        o = self.dhcp_cid_shard(circuit_id)
        self.fastpath[o].add_circuit_id_subscriber(circuit_id, **kw)
        return o

    def remove_subscriber(self, mac) -> bool:
        return self.fastpath[self.dhcp_sub_shard(mac)].remove_subscriber(mac)

    def remove_vlan_subscriber(self, s_tag: int, c_tag: int) -> bool:
        return self.fastpath[self.dhcp_vlan_shard(s_tag, c_tag)].remove_vlan_subscriber(
            s_tag, c_tag)

    def remove_circuit_id_subscriber(self, circuit_id: bytes) -> bool:
        return self.fastpath[self.dhcp_cid_shard(circuit_id)].remove_circuit_id_subscriber(
            circuit_id)

    def touch_lease(self, mac, lease_expiry: int) -> bool:
        return self.fastpath[self.dhcp_sub_shard(mac)].touch_lease(mac, lease_expiry)

    def get_subscriber(self, mac):
        return self.fastpath[self.dhcp_sub_shard(mac)].get_subscriber(mac)

    # ---- device state ----
    @property
    def tables(self):
        """Every shard's `PipelineTables` (None before the first upload)."""
        return None if self.engines is None else [e.tables for e in self.engines]

    def sync_tables(self) -> None:
        """Full upload of every shard's host tables. Resets the
        device-written words (NAT counters, QoS tokens) to the host view."""
        if self.engines is None:
            self.engines = [
                Engine(self.fastpath[i], self.nat[i], self.qos[i], self.spoof[i],
                       self.garden[i] if self.garden is not None else None,
                       self.pppoe[i] if self.pppoe is not None else None,
                       batch_size=self.b, edge=self.edge[i] if self.edge is not None else None,
                       device=self.shard_devices[i])
                for i in range(self.n)]
        else:
            for e in self.engines:
                e.resync_tables()

    def resync_tables(self) -> None:
        """Full re-upload of every shard (the bulk-build heal path)."""
        self.sync_tables()

    def _ensure_synced(self, mirrors) -> None:
        """First upload, or a full one when a bulk build on any shard
        abandoned delta tracking (the reference answers the drain's "full
        upload" signal with one cluster-wide upload)."""
        if self.engines is None or any(t._dirty_all for t in mirrors()):
            self.sync_tables()

    def _all_mirrors(self):
        return [t for e in self.engines for t in e._host_mirrors()] if self.engines else []

    def _fastpath_mirrors(self):
        return [t for fp in self.fastpath for t in (fp.sub, fp.vlan, fp.cid)]

    def _drain_updates(self) -> None:
        """Every shard's bounded update batch, applied before any shard
        steps: a row drained on one shard is visible to the other shards'
        lookups of the same step."""
        self._ensure_synced(self._all_mirrors)
        for e in self.engines:
            upd = e._drain_updates()
            if upd is not None:
                _apply_all_updates(e.tables, upd)

    def _drain_fastpath(self) -> None:
        """The DHCP-only program's drain: every shard's fastpath deltas."""
        self._ensure_synced(self._fastpath_mirrors)
        for e in self.engines:
            upd = e._drain_fastpath_updates()
            if upd is not None:
                apply_fastpath_updates(e.tables.dhcp, upd)

    def _now(self, now_s: int, now_us: int):
        return (torch.full((), int(now_s) & MASK32, dtype=torch.int64, device=self.device),
                torch.full((), int(now_us) & MASK32, dtype=torch.int64, device=self.device))

    def _lanes(self, a: np.ndarray) -> list[torch.Tensor]:
        """One upload of a [N*b, ...] host array, as each shard's lane slice."""
        t = to_device(np.ascontiguousarray(a), self.device)
        return list(t.split(self.b))

    def _dispatch_fused(self, pkt, length, from_access, now_s: int, now_us: int):
        """Drain every shard, then queue the sharded step (`sharded_step`)."""
        self._drain_updates()
        ts, tus = self._now(now_s, now_us)
        res = sharded_step(self.tables, self.exchange, self._lanes(pkt),
                           self._lanes(np.asarray(length).astype(np.int64)),
                           self._lanes(np.asarray(from_access, dtype=bool)),
                           self.geom_sharded, ts, tus)
        for e in self.engines:
            e.stats.batches += 1
        return res

    def _dispatch_dhcp(self, pkt, length, now_s: int) -> DhcpBatchResult:
        """Drain every shard's fastpath, then queue the sharded DHCP-only
        program (`sharded_dhcp_step`)."""
        self._drain_fastpath()
        ts, _ = self._now(now_s, 0)
        res = sharded_dhcp_step([e.tables.dhcp for e in self.engines], self.exchange,
                                self._lanes(pkt), self._lanes(np.asarray(length).astype(np.int64)),
                                self.geom_sharded, ts)
        for e in self.engines:
            e.stats.batches += 1
        return res

    def step(self, pkt: np.ndarray, length: np.ndarray, from_access: np.ndarray,
             now_s: int, now_us: int) -> dict:
        """One sharded step. pkt: [N*b, L] uint8, shard i's lanes at rows
        i*b..(i+1)*b. Returns host arrays: verdict, out_pkt, out_len, the
        summed stats, nat_punt, violation (and garden/PPPoE/edge outputs
        when those stages are on)."""
        t0 = time.perf_counter()
        fl = _InFlight(self._dispatch_fused(pkt, length, from_access, now_s, now_us))
        t1 = time.perf_counter()
        h = fl.wait()
        res = {"verdict": h["verdict"], "out_pkt": h["out_pkt"], "out_len": h["out_len"],
               **self._split_stats(fl, h), "nat_punt": h["nat_punt"],
               "violation": h["spoof_violation"]}
        if "mirror" in h:
            res["mirror"] = h["mirror"]
        t2 = time.perf_counter()
        self.telemetry.record_fused(length, res["verdict"], res["nat_punt"], res["violation"],
                                    int(res["dhcp_stats"][ST_HIT]),
                                    (t1 - t0) * 1e6, (t2 - t1) * 1e6)
        return res

    @staticmethod
    def _split_stats(fl: _InFlight, h: dict) -> dict:
        """The concatenated stats block of `_InFlight` -> {name_stats: array}."""
        out, off = {}, 0
        for name in fl.stat_names:
            out[f"{name}_stats"] = h["stats"][off: off + _STAT_LEN[name]]
            off += _STAT_LEN[name]
        return out

    def dhcp_step(self, pkt: np.ndarray, length: np.ndarray, now_s: int) -> dict:
        """One sharded DHCP-only step (the control-batch fast lane): only the
        fastpath drains; NAT/QoS/antispoof deltas wait for the next fused
        step. Returns {"is_reply", "out_pkt", "out_len", "dhcp_stats"}."""
        t0 = time.perf_counter()
        fl = _InFlight(self._dispatch_dhcp(pkt, length, now_s))
        t1 = time.perf_counter()
        h = fl.wait()
        out = {"is_reply": h["verdict"] == VERDICT_TX, "out_pkt": h["out_pkt"],
               "out_len": h["out_len"], "dhcp_stats": h["stats"]}
        t2 = time.perf_counter()
        self.telemetry.record_dhcp(length, out["is_reply"], int(out["dhcp_stats"][ST_HIT]),
                                   (t1 - t0) * 1e6, (t2 - t1) * 1e6)
        return out

    # ---- the ring loops ----
    def process_ring(self, ring, now_s: int, now_us: int, pkt_slot: int = 2048,
                     slow_path=None, violation_sink=None) -> int:
        """One production beat: assemble a steering ring's window, run it
        (all-control batches take the sharded DHCP-only program), demux the
        verdicts back to the ring. PASS lanes: NAT new-flow punts create the
        session on the owner shard, the rest go to `slow_path(frame)` with
        replies injected on TX; violations reach `violation_sink(lane,
        frame)`. Returns frames processed."""
        if pkt_slot < ring.frame_size:
            raise ValueError(f"pkt_slot {pkt_slot} < ring frame_size {ring.frame_size}: "
                             f"oversize frames would be silently truncated")
        if self._inflight is not None:
            # a pipelined window holds one of the ring's assemble windows:
            # retire it with this call's handlers
            self.flush_pipeline(slow_path, violation_sink)
        pkt, length, flags = self._staging(self._stage_idx, pkt_slot)
        got = ring.assemble_sharded(pkt, length, flags)
        if not got:
            return 0
        entry = self._dispatch_ring_batch(ring, pkt, length, flags, got, now_s, now_us)
        self._retire(entry, slow_path, violation_sink)
        return got

    def process_ring_pipelined(self, ring, now_s: int, now_us: int, pkt_slot: int = 2048,
                               slow_path=None, violation_sink=None) -> int:
        """Double-buffered ring loop: dispatch window k+1, then retire k, so
        the host's demux overlaps the device's work. Call flush_pipeline()
        before reading final state. Returns frames retired this call."""
        if pkt_slot < ring.frame_size:
            raise ValueError(f"pkt_slot {pkt_slot} < ring frame_size {ring.frame_size}: "
                             f"oversize frames would be silently truncated")
        prev, self._inflight = self._inflight, None
        try:
            idx = 1 - self._stage_idx
            pkt, length, flags = self._staging(idx, pkt_slot)
            got = ring.assemble_sharded(pkt, length, flags)
            if got:
                try:
                    entry = self._dispatch_ring_batch(ring, pkt, length, flags, got,
                                                      now_s, now_us)
                except BaseException:
                    # fail closed: complete() retires FIFO, so the older
                    # window retires first, then this one drops
                    self._retire(prev, slow_path, violation_sink)
                    prev = None
                    B = self.n * self.b
                    ring.complete(np.full((B,), VERDICT_DROP, dtype=np.uint8), pkt, length, B)
                    raise
                self._inflight = entry
                self._stage_idx = idx
        finally:
            retired = self._retire(prev, slow_path, violation_sink)
        return retired

    def flush_pipeline(self, slow_path=None, violation_sink=None) -> int:
        """Retire the in-flight pipelined window, if any."""
        entry, self._inflight = self._inflight, None
        return self._retire(entry, slow_path, violation_sink)

    def _staging(self, idx: int, pkt_slot: int):
        B = self.n * self.b
        if self._ring_bufs[idx] is None or self._ring_bufs[idx][0].shape != (B, pkt_slot):
            self._ring_bufs[idx] = (np.zeros((B, pkt_slot), dtype=np.uint8),
                                    np.zeros((B,), dtype=np.uint32),
                                    np.zeros((B,), dtype=np.uint32))
        return self._ring_bufs[idx]

    def _dispatch_ring_batch(self, ring, pkt, length, flags, got, now_s: int, now_us: int):
        """Queue one assembled window and its output copies (`_InFlight`)
        without waiting for them."""
        real = length > 0
        all_ctrl = bool(((flags[real] & FLAG_DHCP_CTRL) != 0).all())
        t0 = time.perf_counter()
        if all_ctrl:
            kind, res = "dhcp", self._dispatch_dhcp(pkt, length, now_s)
        else:
            kind, res = "fused", self._dispatch_fused(pkt, length, (flags & FLAG_FROM_ACCESS) != 0,
                                                      now_s, now_us)
        fl = _InFlight(res)
        dispatch_us = (time.perf_counter() - t0) * 1e6
        return (ring, kind, fl, pkt, length, flags, got, now_s, dispatch_us)

    def _retire(self, entry, slow_path, violation_sink) -> int:
        """Wait for a dispatched window's outputs and demux them to its ring."""
        if entry is None:
            return 0
        ring, kind, fl, pkt, length, flags, got, now_s, dispatch_us = entry
        B = self.n * self.b
        real = length > 0
        t0 = time.perf_counter()
        h = fl.wait()
        wait_us = (time.perf_counter() - t0) * 1e6
        verdict = h["verdict"].astype(np.uint8)
        stats = self._split_stats(fl, h)
        self._fold_stats(**{k[: -len("_stats")]: v for k, v in stats.items()})
        dhcp_hits = int(stats["dhcp_stats"][ST_HIT])
        punt, viol, mir = h["nat_punt"], h["spoof_violation"], h.get("mirror")
        if kind == "dhcp":
            self.telemetry.record_dhcp(length, verdict == VERDICT_TX, dhcp_hits,
                                       dispatch_us, wait_us)
        else:
            # a PASS lane that is no NAT punt and whose affinity owner is
            # another shard was steered to the wrong region: counted apart
            missteer = np.zeros((B,), dtype=bool)
            for lane in np.nonzero((verdict == VERDICT_PASS) & real & ~punt)[0]:
                owner = self._frame_affinity_owner(bytes(pkt[lane, : int(length[lane])]),
                                                   int(flags[lane]))
                if owner is not None and owner != lane // self.b:
                    missteer[lane] = True
            self.telemetry.record_fused(length, verdict, punt, viol, dhcp_hits,
                                        dispatch_us, wait_us, missteer=missteer)
        ring.complete(verdict, np.ascontiguousarray(h["out_pkt"]),
                      h["out_len"].astype(np.uint32), B)

        if violation_sink is not None:
            for lane in np.nonzero(viol)[0]:
                violation_sink(int(lane), bytes(pkt[lane, : int(length[lane])]))
        if mir is not None and self.mirror_sink is not None:
            for lane in np.nonzero((mir != 0) & real)[0]:
                # interception sees the ring's original bytes, whatever the verdict
                self.mirror_sink(int(lane), bytes(pkt[lane, : int(length[lane])]),
                                 int(mir[lane]))
        # the slow ring holds the PASS frames in lane order
        for lane in np.nonzero((verdict == VERDICT_PASS) & real)[0]:
            got_f = ring.slow_pop()
            if got_f is None:
                break  # the slow ring overflowed during complete()
            frame, fl_ = got_f
            try:
                if punt[lane]:
                    self._punt_new_flow(frame, int(now_s))
                elif slow_path is not None:
                    reply = slow_path(frame)
                    if reply is not None:
                        ring.tx_inject(reply, from_access=(fl_ & FLAG_FROM_ACCESS) != 0)
            except Exception as e:  # noqa: BLE001 — the slow path takes untrusted input
                self.stats["slow_errors"] += 1
                self._slow_err_log.report(e, path="ring", lane=int(lane))
        return got

    def _fold_stats(self, **deltas) -> None:
        for k, v in deltas.items():
            acc = self.stats.get(k)
            if acc is None:
                self.stats[k] = np.asarray(v, dtype=np.uint64).copy()
            else:
                acc += np.asarray(v, dtype=np.uint64)

    def _frame_affinity_owner(self, frame: bytes, flags: int) -> int | None:
        """The shard owning a frame's shard-local state, or None when no
        shard owns it (DHCP or PPPoE control, non-IPv4, return traffic to an
        unregistered public IP): the ring's steering spec."""
        if (flags & FLAG_DHCP_CTRL) or len(frame) < 14:
            return None
        off = 12
        et = (frame[off] << 8) | frame[off + 1]
        for _ in range(2):
            if et not in (0x8100, 0x88A8):
                break
            off += 4
            if len(frame) < off + 2:
                return None
            et = (frame[off] << 8) | frame[off + 1]
        off += 2  # L3 start
        if et == 0x0800 and len(frame) >= off + 20 and (frame[off] >> 4) == 4:
            if flags & FLAG_FROM_ACCESS:
                return fnv1a32(frame[off + 12: off + 16]) % self.n
            dst = int.from_bytes(frame[off + 16: off + 20], "big")
            if self._pub_owner_cache is None:
                self._pub_owner_cache = self.pub_ip_map()
            return self._pub_owner_cache.get(dst)
        if (et == 0x8864 and (flags & FLAG_FROM_ACCESS)
                and len(frame) >= off + 8 + 20
                and frame[off] == 0x11 and frame[off + 1] == 0
                and ((frame[off + 6] << 8) | frame[off + 7]) == 0x0021
                and (frame[off + 8] >> 4) == 4):
            return fnv1a32(frame[off + 8 + 12: off + 8 + 16]) % self.n
        return None

    def _punt_new_flow(self, frame: bytes, now: int) -> None:
        """A device egress miss: create the session on the owner shard."""
        if self.pppoe is not None:
            # the punt carries the ring's bytes, still session-framed for a
            # PPPoE subscriber: strip to the inner IPv4 view
            frame = Engine._strip_pppoe_host(frame)
        try:
            d = F.decode(frame)
        except Exception:  # noqa: BLE001 — a truncated frame is simply not a flow
            return
        if d.ethertype != 0x0800:
            return
        src_port = d.icmp_id if d.proto == 1 else d.src_port
        dst_port = 0 if d.proto == 1 else d.dst_port
        self.handle_new_flow(d.src_ip, d.dst_ip, src_port, dst_port, d.proto, len(frame), now)

    # ---- maintenance ----
    def quiesce(self) -> int:
        """Retire the in-flight pipelined window, then wait for the device, so
        no table update is in flight. Returns frames retired. A caller with
        a ring's slow queue flushes through process_ring/flush_pipeline
        with its handlers first."""
        n = self.flush_pipeline()
        for dev in set(self.shard_devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return n

    def fetch_session_vals(self, shard: int) -> np.ndarray:
        """One shard's device NAT session rows (counters, last_seen) as host
        uint32 words."""
        return self.engines[shard].fetch_session_vals()

    def expire(self, now: int) -> int:
        """NAT idle-session sweep of every shard against its device rows."""
        total = 0
        for i in range(self.n):
            dev = self.fetch_session_vals(i) if self.engines is not None else None
            total += self.nat[i].expire_sessions(int(now), device_vals=dev)
        return total

    def fold_device_authoritative(self) -> None:
        """Every shard's device-written words (NAT session counters and
        last_seen, QoS tokens) into its host mirrors, shipped slots only
        (`Engine.fold_device_authoritative` per shard). Behind quiesce()."""
        for e in self.engines or ():
            e.fold_device_authoritative()

    def shard_components(self, i: int) -> dict:
        """Shard i's host authorities under the checkpoint's component names."""
        out = {"fastpath": self.fastpath[i], "nat": self.nat[i],
               "qos": self.qos[i], "antispoof": self.spoof[i]}
        if self.garden is not None:
            out["garden"] = self.garden[i]
        if self.pppoe is not None:
            out["pppoe"] = self.pppoe[i]
        if self.edge is not None:
            out["edge"] = self.edge[i]
        return out

    def clone_empty(self, n_shards: int | None = None) -> "ShardedCluster":
        """An empty cluster with this one's per-shard geometry (nothing is
        uploaded until its first step or sync): the swap's standby, the
        re-shard target. Auto-derived public IPs regenerate for a new shard
        count; an explicit list must still cover it."""
        kw = dict(self._ctor_kwargs)
        n = self.n if n_shards is None else n_shards
        if kw["public_ips"] is not None and len(kw["public_ips"]) < n * kw["public_ips_per_shard"]:
            raise ValueError(f"cannot re-shard to {n} shards: only "
                             f"{len(kw['public_ips'])} public IPs configured")
        return ShardedCluster(n, **kw)

    def adopt_authorities(self, other: "ShardedCluster") -> None:
        """Take a hydrated clone's host authorities wholesale. The shard
        engines are dropped with the old mirrors: the next sync builds them
        over the adopted ones."""
        self.fastpath, self.nat, self.qos, self.spoof = (other.fastpath, other.nat,
                                                         other.qos, other.spoof)
        self.garden, self.pppoe, self.edge = other.garden, other.pppoe, other.edge
        self.engines = None
        self._pub_owner_cache = None

    def pending_dirty(self) -> int:
        """Dirty slots across every shard's host mirrors (0: the device is current)."""
        total = 0
        for i in range(self.n):
            total += self.fastpath[i].dirty_count()
            total += sum(t.dirty_count() for t in (
                self.nat[i].sessions, self.nat[i].reverse, self.nat[i].sub_nat))
            total += self.qos[i].up.dirty_count() + self.qos[i].down.dirty_count()
            total += self.spoof[i].bindings.dirty_count()
            if self.garden is not None:
                total += self.garden[i].subscribers.dirty_count()
            if self.pppoe is not None:
                total += self.pppoe[i].by_sid.dirty_count() + self.pppoe[i].by_ip.dirty_count()
            if self.edge is not None:
                total += self.edge[i].dirty_count()
        return total

    def stats_summary(self) -> dict:
        """Aggregate serving counters (the engine-stats analog)."""
        t = self.telemetry
        return {
            "shards": self.n,
            "steps": t.steps,
            "frames": int(t.frames.sum()),
            "tx": int(t.verdicts[:, 2].sum()),
            "fwd": int(t.verdicts[:, 3].sum()),
            "dropped": int(t.verdicts[:, 1].sum()),
            "passed": int(t.verdicts[:, 0].sum() - t.missteers.sum()),
            "missteers": int(t.missteers.sum()),
            "nat_punts": int(t.nat_punts.sum()),
            "psum_dhcp_hits": t.psum_dhcp_hits,
            "slow_errors": int(self.stats.get("slow_errors", 0)),
        }


class ShardedFastPathSink:
    """The FastPathTables write interface over a ShardedCluster: the DHCP
    server and pool manager write "the fast path" as before, and each row
    lands on its owner shard (pool and server config on every shard).
    Takes a cluster or a zero-argument resolver returning one."""

    def __init__(self, cluster):
        self._cluster = cluster

    @property
    def cluster(self) -> ShardedCluster:
        c = self._cluster
        return c() if callable(c) else c

    def add_pool(self, *a, **kw) -> None:
        for fp in self.cluster.fastpath:
            fp.add_pool(*a, **kw)

    def remove_pool(self, pool_id: int) -> None:
        for fp in self.cluster.fastpath:
            fp.remove_pool(pool_id)

    def set_server_config(self, mac, ip: int) -> None:
        self.cluster.set_server_config_all(mac, ip)

    def add_subscriber(self, mac, **kw) -> None:
        self.cluster.add_subscriber(mac, **kw)

    def remove_subscriber(self, mac) -> bool:
        return self.cluster.remove_subscriber(mac)

    def add_vlan_subscriber(self, s_tag: int, c_tag: int, **kw) -> None:
        self.cluster.add_vlan_subscriber(s_tag, c_tag, **kw)

    def remove_vlan_subscriber(self, s_tag: int, c_tag: int) -> bool:
        return self.cluster.remove_vlan_subscriber(s_tag, c_tag)

    def add_circuit_id_subscriber(self, circuit_id: bytes, **kw) -> None:
        self.cluster.add_circuit_id_subscriber(circuit_id, **kw)

    def remove_circuit_id_subscriber(self, circuit_id: bytes) -> bool:
        return self.cluster.remove_circuit_id_subscriber(circuit_id)

    def touch_lease(self, mac, lease_expiry: int) -> bool:
        return self.cluster.touch_lease(mac, lease_expiry)

    def get_subscriber(self, mac):
        return self.cluster.get_subscriber(mac)
