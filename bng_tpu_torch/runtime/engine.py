"""Host runtime engine (port of `bng_tpu/runtime/engine.py`: `process`,
`process_dhcp`, `process_ring` and `process_ring_pipelined`).

The engine packs frames into a [B, L] uint8 batch, drains the bounded
host->device table updates, runs one device program and demuxes the
verdicts: TX/FWD frames out, DROP counted, PASS lanes to the slow path,
new NAT flows punted to `NATManager.handle_new_flow`, mirrored lanes to
`mirror_sink`. Its ways in:

- `process(frames)`: one batch through the fused step, every stage the
  engine was given (garden, PPPoE and edge are optional);
- `process_dhcp(frames)`: the DHCP-only program (parse and the DHCP
  responder on the dhcp tables alone, no K2 call), in pow2 batch
  buckets;
- `process_ring(ring)` / `process_ring_pipelined(ring)`: batches
  assembled from a packet ring (`runtime/ring.py`); all-control batches
  take the DHCP-only program. The pipelined loop dispatches batch k+1
  before it retires batch k.

A dispatch makes no host round trip: uploads go through pinned memory
(`ops/table.to_device`), and the outputs come back through async copies
queued behind the step with an event recorded after them (`_InFlight`).
Only the retire waits, and only on its own batch's event.

The engine owns its device tensors and updates them IN PLACE: applied
host updates, NAT session counters and QoS token rows (the JAX engine
rebinds new arrays returned by a donated step). When no host table is
dirty the drain ships nothing (the dense config arrays are re-sent only
when they changed). The engine runs on the card unless the caller asks
for the CPU with `device="cpu"`.

The latency-tiered scheduler (`runtime/scheduler.py`) drives the engine
through three more ways in: the express program (`compile_express_aot` /
`run_express_aot`: the `ops/express.py` probe cascade over admission
descriptors, captured once per key as a CUDA graph on the card), the
devloop's ring program (`compile_devloop_aot` / `prepare_devloop_dispatch`
/ `call_devloop_aot` / `adopt_devloop_chain`: k express batches per
dispatch, `devloop/`) and the bulk lane (`dispatch_scheduled_bulk`: the
fused step over a read replica of the DHCP tables, with the drain
cadence the scheduler sets).

Host path (`BNG_HOST_PATH`, resolved at construction): `vector` packs
frames through a `runtime/hostpath.StagingPool`, whose pinned buffers
the upload copies from directly; `scalar` packs into fresh arrays. The
ring loops serve a `NativeRing` as they serve a `PyRing`.

Chaos points (`chaos/faults.py`): `engine.dispatch` (fail | delay) before
every dispatch of the fused step, the DHCP-only program, the express
program and a devloop ring, and `engine.slow_drain` (fail) on a slow-lane
batch. `fetch_session_vals` and `expire` are the maintenance verbs: the
NAT expiry sweep over the device's session rows, outside any dispatch.

Checkpoint and swap (`runtime/checkpoint.py`, `runtime/ops.py`) use the
barrier verbs: `quiesce` (retire the pipelined batch, synchronise the
stream), `fold_device_authoritative` (the device-written NAT counters and
QoS token words back into the host mirrors, as bits), `host_mirror_tables`
and `adopt_device_tables` (a standby takes a snapshot-built device chain;
like `resync_tables` this re-captures the express programs and moves
`resync_count`, so the devloop re-seeds). `Engine(..., device_tables=...)`
adopts such a chain through it at construction, with no upload of its own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

from bng_tpu_torch import frames as F
from bng_tpu_torch import kernels, resolve_device
from bng_tpu_torch.chaos.faults import FaultInjectedError, fault_point
from bng_tpu_torch.devloop import kernel as devloop_kernel
from bng_tpu_torch.control.nat import NATManager, apply_nat_updates
from bng_tpu_torch.edge.ops import EDGE_NSTATS
from bng_tpu_torch.edge.tables import EdgeTables
from bng_tpu_torch.ops.antispoof import (
    AB_IPV4, AB_MODE, AB_V6_0, AB_VALIDS, ANTISPOOF_NSTATS, ANTISPOOF_WORDS, MODE_DISABLED,
    VALID_V4, VALID_V6,
)
from bng_tpu_torch.ops.dhcp import NSTATS as DHCP_NSTATS
from bng_tpu_torch.ops.dhcp import dhcp_fastpath
from bng_tpu_torch.ops.express import XD_WORDS, express_verdicts
from bng_tpu_torch.ops.garden import GARDEN_NSTATS, GARDEN_WORDS, GV_FLAG
from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.nat44 import NAT_NSTATS
from bng_tpu_torch.ops.parse import parse_batch
from bng_tpu_torch.ops.pipeline import (
    VERDICT_DROP, VERDICT_FWD, VERDICT_PASS, VERDICT_TX, PipelineGeom, PipelineResult,
    PipelineTables, pipeline_step,
)
from bng_tpu_torch.ops.pppoe import PPPOE_NSTATS
from bng_tpu_torch.ops.qos import QOS_NSTATS
from bng_tpu_torch.ops.qtable import (
    QW_FLAGS, QW_LAST_US, QW_TOKENS, HostQTable, QTableGeom, apply_qupdate,
)
from bng_tpu_torch.ops.table import (
    HostTable, PinnedStage, TableGeom, apply_update, to_device, words_to_device,
)
from bng_tpu_torch.runtime import hostpath
from bng_tpu_torch.runtime.ring import FLAG_DHCP_CTRL, FLAG_FROM_ACCESS
from bng_tpu_torch.runtime.tables import (
    FastPathTables, PPPoEFastPathTables, apply_fastpath_updates,
)
from bng_tpu_torch.utils.net import mac_to_u64, split_u64
from bng_tpu_torch.utils.structlog import ErrorLog

PKT_SLOT = 1536  # default per-lane packet slot (full MTU + encap headroom)

# EngineStats accumulator -> the result field it folds
_STAT_FIELDS = (("dhcp", "dhcp_stats"), ("nat", "nat_stats"), ("qos", "qos_stats"),
                ("spoof", "spoof_stats"), ("garden", "garden_stats"),
                ("pppoe", "pppoe_stats"), ("edge", "edge_stats"))


@dataclass
class EngineStats:
    dhcp: np.ndarray = field(default_factory=lambda: np.zeros(DHCP_NSTATS, dtype=np.uint64))
    nat: np.ndarray = field(default_factory=lambda: np.zeros(NAT_NSTATS, dtype=np.uint64))
    qos: np.ndarray = field(default_factory=lambda: np.zeros(QOS_NSTATS, dtype=np.uint64))
    spoof: np.ndarray = field(default_factory=lambda: np.zeros(ANTISPOOF_NSTATS, dtype=np.uint64))
    # walled-garden gate: [gated_drops, allowed_hits]
    garden: np.ndarray = field(default_factory=lambda: np.zeros(GARDEN_NSTATS, dtype=np.uint64))
    # PPPoE decap + encap (ops/pppoe.py PST_*)
    pppoe: np.ndarray = field(default_factory=lambda: np.zeros(PPPOE_NSTATS, dtype=np.uint64))
    # tap mirror + route rewrite (edge/ops.py EST_*)
    edge: np.ndarray = field(default_factory=lambda: np.zeros(EDGE_NSTATS, dtype=np.uint64))
    batches: int = 0
    tx: int = 0
    fwd: int = 0
    dropped: int = 0
    passed: int = 0
    slow_errors: int = 0


class DhcpBatchResult(NamedTuple):
    """Output of the DHCP-only program: TX where the device answered, else PASS."""

    verdict: torch.Tensor  # [B] int32
    out_pkt: torch.Tensor
    out_len: torch.Tensor
    dhcp_stats: torch.Tensor


class ExpressAotResult(NamedTuple):
    """Output of the express program: the verdict block and the DHCP stats
    (no packet bytes; the scheduler patches replies from templates)."""

    block: torch.Tensor  # [B, XD_WORDS] int32 words (ops/express VB_* columns)
    dhcp_stats: torch.Tensor


class ExpressProgram:
    """The express program for one fixed batch, over one engine's DHCP tables.

    On the card it is a CUDA graph of `express_verdicts` (three K1 launches
    and the selects) captured over static buffers: the descriptor rows,
    `now`, and the block and stats it writes. The table tensors are baked
    in by address, which in-place drains keep and `resync_tables` does not:
    `key` carries the engine's resync count, and a program whose key is
    stale is never replayed. A replay calls no wrapper, so the kernel
    launches counted while it was captured are added to `kernels.LAUNCHES`
    on every replay instead. On the CPU it is a plain call.

    The descriptors go up from a few persistent pinned buffers, cycled, each
    rewritten only after the event behind its last copy (`PinnedStage`): a
    dispatch neither pins a fresh buffer nor waits for the stream."""

    STAGES = 4  # the express lane's dispatches in flight, and one staging

    def __init__(self, eng: "Engine", batch: int, key: tuple):
        self.key, self.batch = key, batch
        dev = eng.device
        self.desc = torch.zeros((batch, XD_WORDS), dtype=torch.int32, device=dev)
        self.now = torch.zeros((), dtype=torch.int64, device=dev)
        self.tables, self.geom = eng.tables.dhcp, eng.geom.dhcp
        self.graph, self.launches = None, {}
        self.stages = [PinnedStage((batch, XD_WORDS), np.uint32, dev) for _ in range(self.STAGES)]
        self._stage_i = 0
        if dev.type == "cuda":
            self._capture(dev)

    def _run(self):
        return express_verdicts(self.tables, self.desc, self.geom, self.now)

    def _capture(self, dev) -> None:
        # warm on a side stream first (builds and loads K1, fills the
        # caching allocator), as CUDA graph capture asks
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._run()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self._run()
        # the capture recorded these launches; they run at each replay
        self.launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        kernels.LAUNCHES.update(before)
        self.graph = graph

    def __call__(self, desc: np.ndarray, now: float):
        stage = self.stages[self._stage_i]
        self._stage_i = (self._stage_i + 1) % len(self.stages)
        np.copyto(stage.acquire(), desc)
        stage.upload_into(self.desc)
        self.now.fill_(int(now) & MASK32)
        if self.graph is None:
            return self._run()
        self.graph.replay()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        return self.out


class _InFlight:
    """A dispatched batch's outputs on their way to the host.

    On the card every output is copied into pinned host memory by an async
    copy queued behind the batch, and an event is recorded after the
    copies; `wait` blocks on that event alone, so a batch dispatched
    later keeps the card busy meanwhile, and `ready` asks the event
    without blocking. On the CPU the outputs are already there."""

    LANES = ("verdict", "out_pkt", "out_len", "nat_punt", "spoof_violation", "mirror", "block")

    def __init__(self, res):
        present = [(name, getattr(res, f)) for name, f in _STAT_FIELDS
                   if getattr(res, f, None) is not None]
        self.stat_names = [name for name, _ in present]
        leaves = {k: getattr(res, k) for k in self.LANES if getattr(res, k, None) is not None}
        leaves["stats"] = torch.cat([t for _, t in present])
        if leaves["stats"].device.type == "cuda":
            self._host = {k: v.to("cpu", non_blocking=True) for k, v in leaves.items()}
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = leaves, None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> dict[str, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        host = {k: v.numpy() for k, v in self._host.items()}
        if "verdict" in host:  # the express program has a block instead
            B = host["verdict"].shape[0]
            for k in ("nat_punt", "spoof_violation"):  # absent on the DHCP-only program
                host.setdefault(k, np.zeros((B,), dtype=bool))
        return host


def _mac_key(mac) -> list[int]:
    key = mac_to_u64(mac) if not isinstance(mac, int) else mac
    lo, hi = split_u64(key)
    return [hi, lo]


class QoSTables:
    """Host side of the two QoS maps."""

    def __init__(self, nbuckets: int = 1 << 12, update_slots: int = 128):
        self.up = HostQTable(nbuckets, name="qos_ingress")
        self.down = HostQTable(nbuckets, name="qos_egress")
        self.geom = QTableGeom(nbuckets)
        self.update_slots = update_slots

    def set_subscriber(self, ip: int, down_bps: int, up_bps: int,
                       down_burst: int | None = None, up_burst: int | None = None,
                       priority: int = 0) -> None:
        # burst default: 1.25 s at rate/8 bytes, at least one MTU
        down_burst = down_burst if down_burst is not None else max(int(down_bps / 8 * 1.25), 1500)
        up_burst = up_burst if up_burst is not None else max(int(up_bps / 8 * 1.25), 1500)
        self.down.insert(ip, down_bps, down_burst, priority)
        self.up.insert(ip, up_bps, up_burst, priority)

    def bulk_set_subscribers(self, ips, down_bps: int, up_bps: int,
                             down_burst: int | None = None, up_burst: int | None = None) -> None:
        """Vectorized install for large table builds."""
        ips = np.asarray(ips, dtype=np.uint32)
        down_burst = down_burst if down_burst is not None else max(int(down_bps / 8 * 1.25), 1500)
        up_burst = up_burst if up_burst is not None else max(int(up_bps / 8 * 1.25), 1500)
        n = len(ips)
        self.down.bulk_insert(ips, np.full(n, down_bps, np.uint64), np.full(n, down_burst, np.uint32))
        self.up.bulk_insert(ips, np.full(n, up_bps, np.uint64), np.full(n, up_burst, np.uint32))

    def remove_subscriber(self, ip: int) -> None:
        self.down.delete(ip)
        self.up.delete(ip)


class AntispoofTables:
    """Host side of antispoof (MAC -> binding table, ranges, config)."""

    def __init__(self, nbuckets: int = 1 << 12, stash: int = 64, update_slots: int = 128):
        self.bindings = HostTable(nbuckets, 2, ANTISPOOF_WORDS, stash=stash,
                                  name="subscriber_bindings")
        self.ranges = np.zeros((256, 2), dtype=np.uint32)
        self.config = np.array([MODE_DISABLED, 0], dtype=np.uint32)
        self.geom = TableGeom(nbuckets, stash)
        self.update_slots = update_slots

    def set_config(self, default_mode: int, log_violations: bool) -> None:
        self.config[0] = default_mode
        self.config[1] = 1 if log_violations else 0

    def add_binding(self, mac, ipv4: int, mode: int) -> None:
        row = np.zeros((ANTISPOOF_WORDS,), dtype=np.uint32)
        row[AB_IPV4] = ipv4
        row[AB_VALIDS] = VALID_V4
        row[AB_MODE] = mode
        self.bindings.insert(_mac_key(mac), row)

    def add_binding_v6(self, mac, ipv6_words: list[int], mode: int) -> None:
        existing = self.bindings.lookup(_mac_key(mac))
        row = existing if existing is not None else np.zeros((ANTISPOOF_WORDS,), dtype=np.uint32)
        row[AB_V6_0: AB_V6_0 + 4] = np.asarray(ipv6_words, dtype=np.uint32)
        row[AB_VALIDS] |= VALID_V6
        row[AB_MODE] = mode
        self.bindings.insert(_mac_key(mac), row)

    def remove_binding(self, mac) -> bool:
        return self.bindings.delete(_mac_key(mac))

    def add_allowed_range(self, network: int, prefix_len: int) -> None:
        free = np.nonzero(self.ranges[:, 0] == 0)[0]
        if len(free) == 0:
            raise RuntimeError("allowed-ranges table full")
        self.ranges[free[0]] = (prefix_len, network)


class GardenTables:
    """Host side of the walled-garden gate (`ops/garden.py`): gardened
    subscriber IPs and the allowed destinations (portal, DNS)."""

    def __init__(self, nbuckets: int = 1 << 12, stash: int = 64, update_slots: int = 128,
                 max_allowed: int = 64):
        self.subscribers = HostTable(nbuckets, 1, GARDEN_WORDS, stash=stash,
                                     name="garden_subscribers")
        self.allowed = np.zeros((max_allowed, 3), dtype=np.uint32)
        self.geom = TableGeom(nbuckets, stash)
        self.update_slots = update_slots

    def set_gardened(self, ip: int, gardened: bool) -> None:
        """Mark or unmark a subscriber IP (idempotent: insert is an upsert)."""
        if gardened:
            row = np.zeros((GARDEN_WORDS,), dtype=np.uint32)
            row[GV_FLAG] = 1
            self.subscribers.insert([ip], row)
        else:
            self.subscribers.delete([ip])

    def allow_destination(self, ip: int, port: int = 0, proto: int = 0) -> None:
        """port/proto 0 = wildcard."""
        free = np.nonzero(self.allowed[:, 0] == 0)[0]
        if len(free) == 0:
            raise RuntimeError("allowed-destinations table full")
        self.allowed[free[0]] = (ip, port, proto)


def _apply_all_updates(t: PipelineTables, upd) -> None:
    """Apply one drained update batch in place. Layout: 7 entries, then the
    tails of the stages present, in order: garden (delta, allowed rows),
    PPPoE (by_sid delta, by_ip delta), edge (tap delta, filters, config,
    route delta)."""
    fp_upd, nat_upd, qup, qdown, sp_upd, sp_ranges, sp_config, *tails = upd
    if t.dhcp is not None:  # None: a bulk batch applied outside a step
        apply_fastpath_updates(t.dhcp, fp_upd)
    apply_nat_updates(t.nat, nat_upd)
    apply_qupdate(t.qos_up, qup)
    apply_qupdate(t.qos_down, qdown)
    apply_update(t.spoof, sp_upd)
    t.spoof_ranges.copy_(sp_ranges)
    t.spoof_config.copy_(sp_config)
    tails = list(tails)
    if t.garden is not None:
        apply_update(t.garden, tails.pop(0))
        t.garden_allowed.copy_(tails.pop(0))
    if t.pppoe_by_sid is not None:
        apply_update(t.pppoe_by_sid, tails.pop(0))
        apply_update(t.pppoe_by_ip, tails.pop(0))
    if t.tap is not None:
        apply_update(t.tap, tails.pop(0))
        t.tap_filters.copy_(tails.pop(0))
        t.tap_config.copy_(tails.pop(0))
        apply_update(t.route, tails.pop(0))


class Engine:
    # pow2 batch buckets of the DHCP-only lane (the reference's compile-shape
    # budget); a larger control batch is split at the cap
    DHCP_BATCH_FLOOR = 64
    DHCP_BATCH_CAP = 8192

    def __init__(self, fastpath: FastPathTables, nat: NATManager,
                 qos: QoSTables | None = None, antispoof: AntispoofTables | None = None,
                 garden: GardenTables | None = None, pppoe: PPPoEFastPathTables | None = None,
                 batch_size: int = 256, pkt_slot: int = PKT_SLOT,
                 slow_path: Callable[[bytes], bytes | None] | None = None,
                 violation_sink: Callable[[int, bytes], None] | None = None,
                 clock: Callable[[], float] = time.time,
                 edge: EdgeTables | None = None,
                 mirror_sink: Callable[[int, bytes, int], None] | None = None,
                 device=None, device_tables: PipelineTables | None = None):
        self.device = resolve_device(device)
        self.fastpath = fastpath
        self.nat = nat
        self.qos = qos or QoSTables()
        self.antispoof = antispoof or AntispoofTables()
        # None = the stage is not in the step (an IPoE-only deployment pays nothing)
        self.garden = garden
        self.pppoe = pppoe
        self.edge = edge
        # retire hook for mirrored lanes: (lane, original frame, warrant id)
        self.mirror_sink = mirror_sink
        self.B = batch_size
        self.L = pkt_slot
        self.slow_path = slow_path
        # a batched slow-path handler ([(lane, frame)] -> [(lane, reply)]):
        # the reference's slow-path fleet hook; it stays None until the
        # fleet is ported
        self.slow_path_batch = None
        # slow-path failures are counted and logged, rate-limited
        self._slow_err_log = ErrorLog("slowpath", "slow-path handler failed", level="error",
                                      component="engine")
        self.violation_sink = violation_sink
        self.clock = clock
        self.stats = EngineStats()
        self._inflight = None  # the pipelined ring loop's dispatched batch
        self._stage_bufs = [None, None]  # its ping-pong staging buffers
        self._stage_idx = 0
        self.geom = PipelineGeom(
            dhcp=fastpath.geom, nat=nat.geom, qos=self.qos.geom, spoof=self.antispoof.geom,
            garden=garden.geom if garden else None,
            pppoe=pppoe.geom if pppoe else None,
            tap=edge.geom if edge else None,
            route=edge.geom if edge else None,
        )
        # bumped by resync_tables (new device tensors): the scheduler's bulk
        # replica and the captured express programs watch it
        self.resync_count = 0
        self._express_programs: dict[tuple, ExpressProgram] = {}
        self.express_captures = 0  # express programs built (graphs captured on the card)
        self._devloop_programs: dict = {}  # devloop/kernel.py's ring programs, per key
        self.devloop_captures = 0
        if device_tables is not None:
            # a standby's snapshot-built chain, in place of the init upload
            # (two engines' tables already share the card during a swap)
            self.adopt_device_tables(device_tables)
        else:
            self.tables: PipelineTables = self._device_tables()
        # host path, resolved once: vector packs through pooled pinned buffers
        self.host_path = hostpath.resolved_host_path()
        self._stage_pool = (hostpath.StagingPool(self.L, device=self.device)
                            if self.host_path == "vector" else None)

    # -- device state --
    def _dense_host(self) -> dict[str, np.ndarray]:
        """The small dense config arrays the device copies wholesale."""
        d = {"pools": self.fastpath.pools, "server": self.fastpath.server,
             "hairpin": self.nat.hairpin, "alg": self.nat.alg,
             "nat_config": self.nat.config_array(),
             "spoof_ranges": self.antispoof.ranges, "spoof_config": self.antispoof.config}
        if self.garden is not None:
            d["garden_allowed"] = self.garden.allowed
        if self.edge is not None:
            d["tap_filters"] = self.edge.tap_filters
            d["tap_config"] = self.edge.tap_config
        return d

    def _device_tables(self) -> PipelineTables:
        self._dense_sent = {k: v.copy() for k, v in self._dense_host().items()}
        dev = self.device
        g, p, e = self.garden, self.pppoe, self.edge
        return PipelineTables(
            dhcp=self.fastpath.device_tables(dev),
            nat=self.nat.device_tables(dev),
            qos_up=self.qos.up.device_state(dev),
            qos_down=self.qos.down.device_state(dev),
            spoof=self.antispoof.bindings.device_state(dev),
            spoof_ranges=words_to_device(self.antispoof.ranges, dev),
            spoof_config=words_to_device(self.antispoof.config, dev),
            garden=g.subscribers.device_state(dev) if g else None,
            garden_allowed=words_to_device(g.allowed, dev) if g else None,
            pppoe_by_sid=p.by_sid.device_state(dev) if p else None,
            pppoe_by_ip=p.by_ip.device_state(dev) if p else None,
            pppoe_server_mac=words_to_device(p.server_mac, dev) if p else None,
            tap=e.tap.device_state(dev) if e else None,
            tap_filters=words_to_device(e.tap_filters, dev) if e else None,
            tap_config=words_to_device(e.tap_config, dev) if e else None,
            route=e.route.device_state(dev) if e else None,
        )

    def _dense_of(self, t: PipelineTables) -> dict[str, np.ndarray]:
        """The dense config arrays a device chain holds, read back as uint32
        (what the next drain compares the host arrays with)."""
        d = {"pools": t.dhcp.pools, "server": t.dhcp.server, "hairpin": t.nat.hairpin_ips,
             "alg": t.nat.alg_ports, "nat_config": t.nat.config,
             "spoof_ranges": t.spoof_ranges, "spoof_config": t.spoof_config}
        if self.garden is not None:
            d["garden_allowed"] = t.garden_allowed
        if self.edge is not None:
            d["tap_filters"] = t.tap_filters
            d["tap_config"] = t.tap_config
        return {k: v.to("cpu", copy=True).numpy().view(np.uint32) for k, v in d.items()}

    def resync_tables(self) -> None:
        """Full device re-upload after a bulk host-table build (device-written
        QoS tokens and NAT counters reset to the host view)."""
        self._rebind(self._device_tables())

    def _rebind(self, tables: PipelineTables) -> None:
        """New device tensors invalidate every captured express program: each
        is dropped and built again over them, under a key with the new
        resync count (which also tells the devloop to re-seed)."""
        self.tables = tables
        self.resync_count += 1
        stale, self._express_programs = self._express_programs, {}
        for prog in stale.values():  # rebuilt (re-captured) over the new tensors
            self.compile_express_aot(prog.batch)

    def host_mirror_tables(self) -> dict:
        """{name: HostTable | HostQTable} of every sparse mirror the engine
        drains, in drain order (the delta replay's walk)."""
        out = {
            "fastpath/sub": self.fastpath.sub,
            "fastpath/vlan": self.fastpath.vlan,
            "fastpath/cid": self.fastpath.cid,
            "nat/sessions": self.nat.sessions,
            "nat/reverse": self.nat.reverse,
            "nat/sub_nat": self.nat.sub_nat,
            "qos/up": self.qos.up,
            "qos/down": self.qos.down,
            "antispoof/bindings": self.antispoof.bindings,
        }
        if self.garden is not None:
            out["garden/subscribers"] = self.garden.subscribers
        if self.pppoe is not None:
            out["pppoe/by_sid"] = self.pppoe.by_sid
            out["pppoe/by_ip"] = self.pppoe.by_ip
        if self.edge is not None:
            out["edge/tap"] = self.edge.tap
            out["edge/route"] = self.edge.route
        return out

    def _host_mirrors(self):
        return list(self.host_mirror_tables().values())

    def pending_dirty(self) -> int:
        return sum(t.dirty_count() for t in self._host_mirrors())

    def _dense_changed(self, keys=None) -> bool:
        host = self._dense_host()
        return any(not np.array_equal(host[k], self._dense_sent[k]) for k in keys or host)

    def _drain_updates(self):
        """One bounded update batch for the fused step, or None when there is
        nothing to ship (no dirty slot and no changed config array)."""
        if self.pending_dirty() == 0 and not self._dense_changed():
            return None
        if any(t._dirty_all for t in self._host_mirrors()):
            # a bulk build abandoned delta tracking: answer with one full upload
            self.resync_tables()
            return None
        self._dense_sent = {k: v.copy() for k, v in self._dense_host().items()}
        return self._update_batch(drain_fastpath=True, drain_rest=True)

    def _update_batch(self, drain_fastpath: bool, drain_rest: bool):
        """One update batch for the fused step: for each table its real
        delta (which drains the table's dirty slots) or its empty one (which
        leaves them queued), and the dense config arrays, which the step
        copies wholesale. The fastpath's part is chosen apart: only the
        express lane drains it when the scheduler runs the engine."""
        dev = self.device

        def delta(t, slots):
            return t.make_update(slots, dev) if drain_rest else t.empty_update(slots, dev)

        def deltas(owner):
            return owner.make_updates(dev) if drain_rest else owner.empty_updates(dev)

        fp = self.fastpath
        upd = (
            fp.make_updates(dev) if drain_fastpath else fp.empty_updates(dev),
            deltas(self.nat),
            delta(self.qos.up, self.qos.update_slots),
            delta(self.qos.down, self.qos.update_slots),
            delta(self.antispoof.bindings, self.antispoof.update_slots),
            words_to_device(self.antispoof.ranges, dev),
            words_to_device(self.antispoof.config, dev),
        )
        if self.garden is not None:
            upd += (delta(self.garden.subscribers, self.garden.update_slots),
                    words_to_device(self.garden.allowed, dev))
        if self.pppoe is not None:
            upd += deltas(self.pppoe)
        if self.edge is not None:
            upd += deltas(self.edge)
        return upd

    def _drain_fastpath_updates(self):
        """The DHCP-only program's drain: the fastpath tables alone (the
        other tables' deltas wait for the next fused step), or None."""
        fp = self.fastpath
        if fp.dirty_count() == 0 and not self._dense_changed(("pools", "server")):
            return None
        if any(t._dirty_all for t in (fp.sub, fp.vlan, fp.cid)):
            self.resync_tables()
            return None
        self._dense_sent["pools"] = fp.pools.copy()
        self._dense_sent["server"] = fp.server.copy()
        return fp.make_updates(self.device)

    # -- dispatch (no host round trip) --
    def _now_tensors(self, now: float):
        # fills, not host copies
        dev = self.device
        return (torch.full((), int(now) & MASK32, dtype=torch.int64, device=dev),
                torch.full((), int(now * 1e6) & MASK32, dtype=torch.int64, device=dev))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A staged array on the device: straight from its pinned pool buffer
        when the vector host path staged it, else through `to_device`."""
        if self._stage_pool is not None:
            t = self._stage_pool.upload(a)
            if t is not None:
                return t
        return to_device(a, self.device)

    @staticmethod
    def _dispatch_fault() -> None:
        """The chaos point on every device dispatch: `delay` sleeps (a slow
        device, at most 50 ms), `fail` raises before the update drain, so
        no table delta is lost with the batch. Disarmed: one no-op call."""
        fp = fault_point("engine.dispatch")
        if fp is not None:
            if fp.kind == "fail":
                raise FaultInjectedError("chaos: injected device dispatch failure")
            if fp.kind == "delay":
                time.sleep(min(max(fp.arg, 0.0), 0.05))

    def _dispatch_step(self, pkt: np.ndarray, length: np.ndarray, fa: np.ndarray,
                       now: float) -> PipelineResult:
        """Drain + apply updates and queue one fused step."""
        self._dispatch_fault()
        upd = self._drain_updates()
        if upd is not None:
            _apply_all_updates(self.tables, upd)
        dev = self.device
        now_s, now_us = self._now_tensors(now)
        res = pipeline_step(self.tables, self._upload(pkt), self._upload(length),
                            to_device(fa, dev), self.geom, now_s, now_us)
        self.stats.batches += 1
        return res

    def _run_dhcp_batch(self, pkt: np.ndarray, length: np.ndarray,
                        now: float) -> DhcpBatchResult:
        """Drain the fastpath tables and queue the DHCP-only program (parse +
        the DHCP responder on the dhcp tables the fused step also uses):
        3 K1 probes, no K2 call."""
        self._dispatch_fault()
        upd = self._drain_fastpath_updates()
        if upd is not None:
            apply_fastpath_updates(self.tables.dhcp, upd)
        pkt_d, len_d = self._upload(pkt), self._upload(length)
        now_s, _ = self._now_tensors(now)
        res = dhcp_fastpath(pkt_d, len_d, parse_batch(pkt_d, len_d), self.tables.dhcp,
                            self.geom.dhcp, now_s)
        self.stats.batches += 1
        verdict = torch.where(res.is_reply, VERDICT_TX, VERDICT_PASS).to(torch.int32)
        return DhcpBatchResult(verdict=verdict, out_pkt=res.out_pkt, out_len=res.out_len,
                               dhcp_stats=res.stats)

    def _fold_stats(self, names, stats: np.ndarray) -> None:
        off = 0
        for name in names:
            acc = getattr(self.stats, name)
            acc += stats[off: off + len(acc)].astype(np.uint64)
            off += len(acc)

    def _collect(self, res) -> dict[str, np.ndarray]:
        """Wait for one batch's outputs and fold its stats."""
        fl = _InFlight(res)
        host = fl.wait()
        self._fold_stats(fl.stat_names, host["stats"])
        return host

    def step(self, pkt: np.ndarray, length: np.ndarray, fa: np.ndarray,
             now: float) -> PipelineResult:
        """Drain + apply updates, run one fused step, fold the stats."""
        res = self._dispatch_step(pkt, length, fa, now)
        self._collect(res)
        return res

    # -- the express program (runtime/scheduler.py's express lane) --
    def _express_device(self, device):
        """The express lane shares the engine's device and stream; another
        device (the reference's second-chip express lane) is not ported."""
        if device is None:
            return self.device
        want, dev = torch.device(device), self.device
        index = dev.index
        if dev.type == "cuda" and index is None:
            index = torch.cuda.current_device()
        if want.type != dev.type or want.index not in (None, index):
            raise NotImplementedError(
                f"an express lane on {want}, apart from the engine's {dev}, is not ported "
                "(ROADMAP Queue 1, item 5a)")
        return dev

    def _express_aot_key(self, batch: int, device=None) -> tuple:
        # the table shapes and update-batch shapes the program reads, the
        # batch, the device, and the resync count: a resync uploads new
        # tensors, which a captured graph's baked addresses would not see
        return (self.fastpath.geom, len(self.fastpath.pools), self.fastpath.update_slots,
                batch, str(self._express_device(device)), self.resync_count)

    def express_aot(self, batch: int, device=None) -> ExpressProgram | None:
        """The express program for `batch`, or None: a None is the geometry
        miss the scheduler falls back from, loudly. It never captures."""
        return self._express_programs.get(self._express_aot_key(batch, device))

    def compile_express_aot(self, batch: int, device=None) -> ExpressProgram:
        """Build the express program for one fixed batch (on the card:
        capture its CUDA graph), at scheduler init, never on the dispatch
        path. Kept per key, so a second call captures nothing new. A
        capture that fails raises."""
        key = self._express_aot_key(batch, device)
        prog = self._express_programs.get(key)
        if prog is None:
            prog = self._express_programs[key] = ExpressProgram(self, batch, key)
            self.express_captures += 1
        return prog

    def run_express_aot(self, prog: ExpressProgram, desc: np.ndarray, now: float,
                        device=None) -> ExpressAotResult:
        """Dispatch one staged descriptor batch ([batch, XD_WORDS] uint32)
        to the express program: the fastpath delta drains first (an OFFER
        sees the newest lease), then the descriptors go up and the program
        runs (the graph replays). A resync inside the drain re-keys: the
        program is rebuilt for the new tables and the stale one never
        replays. The outputs are the program's own buffers, rewritten by
        the next dispatch: take them with `_InFlight` before that."""
        self._dispatch_fault()
        upd = self._drain_fastpath_updates()
        if upd is not None:
            apply_fastpath_updates(self.tables.dhcp, upd)
        if prog.key != self._express_aot_key(prog.batch, device):
            prog = self.compile_express_aot(prog.batch, device)
        res = prog(desc, now)
        self.stats.batches += 1
        return ExpressAotResult(block=res.block, dhcp_stats=res.stats)

    # -- the devloop's ring program (devloop/host.py's pump) --
    #
    # The ring program reads its own leading copy of the DHCP tables; the
    # published tables (self.tables.dhcp) take each ring's drained deltas
    # only when the ring retires, which is when the reference publishes a
    # ring's output chain.
    def devloop_aot(self, k: int, batch: int, device=None):
        """The ring program for this (k, batch), or None: the geometry miss
        the pump falls back from. It never captures."""
        return devloop_kernel.get_compiled(self, k, batch, device)

    def compile_devloop_aot(self, k: int, batch: int, device=None):
        """Build the ring program (capture its graph on the card), at
        scheduler init or engine adoption, never on the dispatch path."""
        return devloop_kernel.compile_devloop(self, k, batch, device)

    def prepare_devloop_dispatch(self):
        """The ordered half of a ring dispatch: the `engine.dispatch` chaos
        point and the fastpath drain. Returns (deltas or None, resynced):
        `resynced` says a resync inside the drain replaced the published
        tables, so the pump must re-seed the leading copy."""
        self._dispatch_fault()
        before = self.tables.dhcp
        upd = self._drain_fastpath_updates()
        return upd, self.tables.dhcp is not before

    @staticmethod
    def call_devloop_aot(prog, upd, stage, n_slots: int, now: float):
        """Apply the drained deltas to the program's leading copy, upload the
        staged ring and run it (replay the graph). Touches no engine state;
        returns the program's `DevloopResult` buffers."""
        if upd is not None:
            apply_fastpath_updates(prog.tables, upd)
        return prog(stage, n_slots, now)

    def adopt_devloop_chain(self, upd, published, count: bool = True) -> None:
        """Publish a retired ring: its deltas go into the published DHCP
        tables, unless a resync has replaced them since the ring was
        dispatched (`published` is the tables it was dispatched against):
        the fresh upload already holds every host write. `count=False`
        publishes without claiming a ring dispatch."""
        if upd is not None and self.tables.dhcp is published:
            apply_fastpath_updates(published, upd)
        if count:
            self.stats.batches += 1

    # -- the bulk lane (runtime/scheduler.py) --
    #
    # The scheduler runs the fused step over a READ REPLICA of the DHCP
    # tables and owns the drain cadence: the express lane alone drains the
    # fastpath deltas, the bulk lane ships empty fastpath deltas and the
    # other tables' real deltas every `drain_every` dispatches.
    def prefetch_bulk_updates(self):
        """Build and start uploading the next bulk drain while the current
        step runs (overlap drain). It consumes the host dirty sets as the
        in-dispatch drain would. The caller owns the batch: it must reach
        the device through `dispatch_scheduled_bulk(upd=...)` or
        `apply_updates_now`, or host and device tables diverge. A bulk
        build that abandoned delta tracking answers with a full resync."""
        bulk_mirrors = self._host_mirrors()[3:]  # all but the fastpath's sub/vlan/cid
        if any(t._dirty_all for t in bulk_mirrors):
            self.resync_tables()
        return self._update_batch(drain_fastpath=False, drain_rest=True)

    def apply_updates_now(self, upd) -> None:
        """Apply one built bulk update batch with no packet batch (a
        prefetched drain that no later step consumed). The authoritative
        DHCP tables are left out, as the bulk step leaves them out."""
        _apply_all_updates(self.tables._replace(dhcp=None), upd)

    def dispatch_scheduled_bulk(self, pkt: np.ndarray, length: np.ndarray, fa: np.ndarray,
                                now: float, dhcp_replica, drain: bool = True, upd=None):
        """The bulk lane's dispatch: the fused step over `dhcp_replica`
        instead of the authoritative DHCP tables. drain=False ships the
        no-op batch; a prefetched batch (`upd`) takes the drain's place.
        Returns (result, replica); the outputs are not waited for."""
        if upd is None:
            upd = (self.prefetch_bulk_updates() if drain
                   else self._update_batch(drain_fastpath=False, drain_rest=False))
        # read self.tables after the drain: a resync rebinds it
        tables_in = self.tables._replace(dhcp=dhcp_replica)
        _apply_all_updates(tables_in, upd)
        now_s, now_us = self._now_tensors(now)
        res = pipeline_step(tables_in, self._upload(pkt), self._upload(length),
                            to_device(fa, self.device), self.geom, now_s, now_us)
        self.stats.batches += 1
        return res, dhcp_replica

    # -- frames in, verdicts out --
    def _pack_frames(self, frames: list[bytes], B: int):
        """Stage a frame list into [B, L] uint8 + [B] lengths (numpy): the
        vector host path packs into a pooled pinned pair with one ragged
        gather, the scalar path into fresh arrays with one scatter."""
        if len(frames) > B:
            raise ValueError(f"batch of {len(frames)} exceeds batch size {B}")
        if self._stage_pool is not None:
            if not frames:
                return self._stage_pool.stage(frames, B)
            lens = hostpath.frame_lens(frames)
            if int(lens.max()) > self.L:
                raise ValueError(
                    f"frame of {int(lens.max())} bytes exceeds engine pkt_slot {self.L}")
            return self._stage_pool.stage(frames, B, lens=lens)
        pkt = np.zeros((B, self.L), dtype=np.uint8)
        length = np.zeros((B,), dtype=np.int64)
        if not frames:
            return pkt, length
        lens = np.fromiter((len(f) for f in frames), dtype=np.int64, count=len(frames))
        if int(lens.max()) > self.L:
            # never truncate: a clipped frame would be NAT-accounted and TX'd corrupt
            raise ValueError(f"frame of {int(lens.max())} bytes exceeds engine pkt_slot {self.L}")
        flat = np.frombuffer(b"".join(frames), dtype=np.uint8)
        rows = np.repeat(np.arange(len(frames)), lens)
        starts = np.cumsum(lens) - lens
        cols = np.arange(len(flat)) - np.repeat(starts, lens)
        pkt[rows, cols] = flat
        length[: len(frames)] = lens
        return pkt, length

    def _handle_slow_lanes(self, items: list, path: str) -> list:
        """PASS-lane frames through the slow path: the batched handler when
        one is set, else the per-frame one. items: [(lane, frame)] or
        [(lane, frame, enq_t)] (the scheduler passes each frame's enqueue
        time along) -> [(lane, reply|None)] in ascending lane order. A
        handler error is counted and reported with its `path`, and the
        drain goes on."""
        if not items:
            return []
        fp = fault_point("engine.slow_drain")
        if fp is not None and fp.kind == "fail":
            # chaos: the whole slow batch is lost before any handler runs (no
            # half-allocation); clients retransmit
            self.stats.slow_errors += 1
            return [(item[0], None) for item in items]
        if self.slow_path_batch is not None:
            try:
                out = self.slow_path_batch(items)
            except Exception as e:  # noqa: BLE001 — the batched handler can fail whole
                self.stats.slow_errors += 1
                self._slow_err_log.report(e, path=path, lane=-1)
                return [(item[0], None) for item in items]
            return sorted(out, key=lambda t: t[0])
        results = []
        for lane, frame in ((item[0], item[1]) for item in items):
            reply = None
            try:
                if self.slow_path is not None:
                    reply = self.slow_path(frame)
            except Exception as e:  # noqa: BLE001 — slow path is untrusted input
                self.stats.slow_errors += 1
                self._slow_err_log.report(e, path=path, lane=lane)
            results.append((lane, reply))
        return results

    def _punt(self, frame: bytes, now: float, lane: int, path: str = "punt") -> None:
        try:
            self._punt_new_flow(frame, int(now))
        except Exception as e:  # noqa: BLE001 — untrusted frame: count, log, go on
            self.stats.slow_errors += 1
            self._slow_err_log.report(e, path=path, lane=lane)

    def process(self, frames: list[bytes], from_access: list[bool] | bool = True,
                now: float | None = None) -> dict:
        """Run one batch through the fused step and apply verdicts.

        Returns {"tx": [(lane, frame)], "fwd": [...], "dropped": [lanes],
        "slow": [(lane, reply_frame|None)]}.
        """
        now = now if now is not None else self.clock()
        pkt, length = self._pack_frames(frames, self.B)
        if isinstance(from_access, bool):
            fa = np.full((self.B,), from_access, dtype=bool)
        else:
            fa = np.zeros((self.B,), dtype=bool)
            fa[: len(from_access)] = from_access

        h = self._collect(self._dispatch_step(pkt, length, fa, now))
        n = len(frames)
        verdict, out_len, out_rows = h["verdict"][:n], h["out_len"], h["out_pkt"]
        punt, viol = h["nat_punt"], h["spoof_violation"]
        mir = h.get("mirror")

        out = {"tx": [], "fwd": [], "dropped": [], "slow": []}
        slow_items, punt_lanes = [], []
        for i, v in enumerate(verdict):
            if v == VERDICT_TX:
                out["tx"].append((i, bytes(out_rows[i, : int(out_len[i])])))
                self.stats.tx += 1
            elif v == VERDICT_FWD:
                out["fwd"].append((i, bytes(out_rows[i, : int(out_len[i])])))
                self.stats.fwd += 1
            elif v == VERDICT_DROP:
                out["dropped"].append(i)
                self.stats.dropped += 1
            else:
                self.stats.passed += 1
                if punt[i]:
                    self._punt(frames[i], now, i)
                    punt_lanes.append(i)
                else:
                    slow_items.append((i, frames[i]))
            if viol[i] and self.violation_sink is not None:
                self.violation_sink(i, frames[i])
            if mir is not None and mir[i] and self.mirror_sink is not None:
                # interception sees the ORIGINAL frame, whatever the verdict
                self.mirror_sink(i, frames[i], int(mir[i]))
        out["slow"] = sorted([(i, None) for i in punt_lanes]
                             + self._handle_slow_lanes(slow_items, "process"),
                             key=lambda t: t[0])
        return out

    @classmethod
    def dhcp_batch_bucket(cls, n: int) -> int:
        """Pow2 bucket (floor 64, cap 8192) for a DHCP-only batch of n frames."""
        b = max(cls.DHCP_BATCH_FLOOR, 1 << max(0, n - 1).bit_length())
        return min(b, cls.DHCP_BATCH_CAP)

    def process_dhcp(self, frames: list[bytes], now: float | None = None,
                     batch: int | None = None) -> dict:
        """The DHCP-only lane: a pre-classified control batch through the
        DHCP-only program. Frames it does not answer come back as "slow".
        Returns {"tx": [(lane, frame)], "slow": [(lane, reply|None)]}."""
        if batch is None and len(frames) > self.DHCP_BATCH_CAP:
            out = {"tx": [], "slow": []}
            for base in range(0, len(frames), self.DHCP_BATCH_CAP):
                part = self.process_dhcp(frames[base: base + self.DHCP_BATCH_CAP], now=now)
                for k in ("tx", "slow"):
                    out[k].extend((base + i, v) for i, v in part[k])
            return out
        B = batch if batch is not None else self.dhcp_batch_bucket(len(frames))
        now = now if now is not None else self.clock()
        pkt, length = self._pack_frames(frames, B)
        h = self._collect(self._run_dhcp_batch(pkt, length, now))
        out = {"tx": [], "slow": []}
        slow_items = []
        for i, v in enumerate(h["verdict"][: len(frames)]):
            if v == VERDICT_TX:
                out["tx"].append((i, bytes(h["out_pkt"][i, : int(h["out_len"][i])])))
                self.stats.tx += 1
            else:
                self.stats.passed += 1
                slow_items.append((i, frames[i]))
        out["slow"] = self._handle_slow_lanes(slow_items, "process_dhcp")
        return out

    # -- the packet-ring loops --
    def _dispatch_ring_batch(self, pkt, length, flags, n: int, now: float):
        """All-control batches take the DHCP-only program; mixed ones the
        fused step (one dispatch beats two). The ring stages lengths as
        uint32; the programs take the port's int64 lanes."""
        length = length.astype(np.int64)
        if bool(((flags[:n] & FLAG_DHCP_CTRL) != 0).all()):
            return self._run_dhcp_batch(pkt, length, now)
        return self._dispatch_step(pkt, length, (flags & FLAG_FROM_ACCESS) != 0, now)

    def process_ring(self, ring, now: float | None = None) -> int:
        """Drain one batch from a packet ring through the device and apply
        its verdicts back to the ring (TX/FWD out, PASS frames to the slow
        path, slow-path replies injected on TX). Returns frames processed."""
        if self._inflight is not None:
            # a pipelined batch holds one of its ring's assemble windows
            self.flush_pipeline()
        pkt = np.zeros((self.B, self.L), dtype=np.uint8)
        length = np.zeros((self.B,), dtype=np.uint32)
        flags = np.zeros((self.B,), dtype=np.uint32)
        n = ring.assemble(pkt, length, flags)
        if n == 0:
            return 0
        now = now if now is not None else self.clock()
        h = self._collect(self._dispatch_ring_batch(pkt, length, flags, n, now))
        self._apply_ring_verdicts(ring, h, pkt, length, n, now)
        return n

    def _apply_ring_verdicts(self, ring, h: dict, pkt, length, n: int, now: float) -> None:
        """Demux one batch's host outputs back to the ring it came from."""
        vv = h["verdict"][:n]
        ring.complete(vv.astype(np.uint8), np.ascontiguousarray(h["out_pkt"]),
                      h["out_len"].astype(np.uint32), n)
        self.stats.tx += int((vv == VERDICT_TX).sum())
        self.stats.fwd += int((vv == VERDICT_FWD).sum())
        self.stats.dropped += int((vv == VERDICT_DROP).sum())
        self.stats.passed += int((vv == VERDICT_PASS).sum())

        if self.violation_sink is not None:
            for lane in np.nonzero(h["spoof_violation"][:n])[0]:
                self.violation_sink(int(lane), bytes(pkt[lane, : int(length[lane])]))
        mir = h.get("mirror")
        if mir is not None and self.mirror_sink is not None:
            for lane in np.nonzero(mir[:n])[0]:
                # the frame as it arrived, whatever the verdict
                self.mirror_sink(int(lane), bytes(pkt[lane, : int(length[lane])]),
                                 int(mir[lane]))

        # The slow ring holds PASS frames in lane order: pop one per PASS lane
        # to recover its punt flag. Every PASS frame is popped even when a
        # handler fails, or later batches would misalign.
        punt = h["nat_punt"][:n]
        slow_items, slow_fa = [], {}
        for lane in np.nonzero(vv == VERDICT_PASS)[0]:
            got = ring.slow_pop()
            if got is None:
                break  # the slow ring overflowed during complete()
            frame, fl = got
            if punt[lane]:
                self._punt(frame, now, int(lane))
            else:
                slow_items.append((int(lane), frame))
                slow_fa[int(lane)] = (fl & FLAG_FROM_ACCESS) != 0
        for lane, reply in self._handle_slow_lanes(slow_items, "ring"):
            if reply is not None:
                ring.tx_inject(reply, from_access=slow_fa[lane])

    def _staging(self, idx: int):
        """Ping-pong staging buffers (allocated once): the in-flight batch
        keeps its frames in one while the next assembles into the other.
        Their upload copies them into pinned memory before it returns, so
        a buffer is never rewritten under an unfinished transfer."""
        if self._stage_bufs[idx] is None:
            self._stage_bufs[idx] = (np.zeros((self.B, self.L), dtype=np.uint8),
                                     np.zeros((self.B,), dtype=np.uint32),
                                     np.zeros((self.B,), dtype=np.uint32))
        return self._stage_bufs[idx]

    def process_ring_pipelined(self, ring, now: float | None = None) -> int:
        """Double-buffered ring loop: assemble and dispatch batch k+1, THEN
        retire batch k, so the host's demux overlaps the card's work. The
        dispatch makes no host round trip. Call flush_pipeline() before
        reading final state. Returns frames retired this call."""
        now = now if now is not None else self.clock()
        prev, self._inflight = self._inflight, None
        try:
            idx = 1 - self._stage_idx
            pkt, length, flags = self._staging(idx)
            n = ring.assemble(pkt, length, flags)
            if n:
                try:
                    fl = _InFlight(self._dispatch_ring_batch(pkt, length, flags, n, now))
                except BaseException:
                    # fail closed: complete() retires FIFO, so the older window
                    # retires first, then this one drops
                    self._retire(prev)
                    prev = None
                    ring.complete(np.full((n,), VERDICT_DROP, dtype=np.uint8), pkt, length, n)
                    raise
                self._inflight = (ring, fl, pkt, length, n, now)
                self._stage_idx = idx
        finally:
            retired = self._retire(prev)
        return retired

    def _retire(self, entry) -> int:
        """Wait for a pipelined batch and apply its verdicts to its ring."""
        if entry is None:
            return 0
        ring, fl, pkt, length, n, now = entry
        h = fl.wait()
        self._apply_ring_verdicts(ring, h, pkt, length, n, now)
        self._fold_stats(fl.stat_names, h["stats"])
        return n

    def flush_pipeline(self, ring=None) -> int:
        """Retire the in-flight pipelined batch, if any, against the ring it
        came from (the argument is accepted for call-site symmetry)."""
        entry, self._inflight = self._inflight, None
        return self._retire(entry)

    # -- maintenance --
    def fetch_session_vals(self) -> np.ndarray:
        """The device-authoritative NAT session rows (counters, last_seen) as
        host uint32 words. The one sync a maintenance call makes: never
        called from a dispatch."""
        return self.tables.nat.sessions.vals.to("cpu", copy=True).numpy().view(np.uint32)

    def expire(self, now: float | None = None) -> int:
        """NAT idle-session sweep against the device's last_seen words; the
        deletions drain to the device with the next step's updates."""
        now = int(now if now is not None else self.clock())
        return self.nat.expire_sessions(now, device_vals=self.fetch_session_vals())

    # -- checkpoint and swap (runtime/checkpoint.py, runtime/ops.py) --
    def quiesce(self) -> int:
        """The drain barrier: retire the pipelined batch, then wait until
        the stream has applied every queued table write, so a checkpoint
        reads no row mid-scatter. Returns the frames retired."""
        n = self.flush_pipeline()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return n

    def adopt_device_tables(self, tables: PipelineTables) -> None:
        """Take a geometry-identical device chain built from a snapshot (the
        blue/green standby), with the dense arrays it holds as the last
        shipped ones: a config change made after the snapshot then ships
        with the next drain. Like a resync, it re-captures the express
        programs and moves `resync_count`. The delta since the snapshot is
        replayed afterwards (`ops.replay_delta_since`)."""
        self._dense_sent = self._dense_of(tables)
        self._rebind(tables)

    @staticmethod
    def _uploaded_mask(table, live: np.ndarray) -> np.ndarray:
        """Slots whose host row has shipped to the device: `live` less the
        pending dirty set (a row the drain has not scattered reads back
        stale, and folding it would destroy the newer host row). A
        `_dirty_all` table has shipped nothing since its bulk build."""
        if table._dirty_all:
            return np.zeros_like(live)
        if not table._dirty:
            return live
        mask = live.copy()
        mask[np.fromiter(table._dirty, dtype=np.int64, count=len(table._dirty))] = False
        return mask

    def fold_device_authoritative(self) -> None:
        """Copy the device-written words into the host mirrors: the NAT
        session rows (counters, last_seen) and the QoS tokens/last_us words,
        bit for bit (the token word is an f32 pattern; it never passes
        through a float). Only shipped slots are folded. A synchronising
        read: call it behind `quiesce()`, never from a dispatch."""
        dev = self.fetch_session_vals()
        mask = self._uploaded_mask(self.nat.sessions, self.nat.sessions.used.astype(bool))
        self.nat.sessions.vals[mask] = dev[mask]
        for host, dev_rows in ((self.qos.up, self.tables.qos_up.rows),
                               (self.qos.down, self.tables.qos_down.rows)):
            rows = dev_rows.to("cpu", copy=True).numpy().view(np.uint32)
            live = self._uploaded_mask(host, (host.rows[:, QW_FLAGS] & 1) != 0)
            host.rows[live, QW_TOKENS] = rows[live, QW_TOKENS]
            host.rows[live, QW_LAST_US] = rows[live, QW_LAST_US]

    # -- the host side of punts --
    @staticmethod
    def _strip_pppoe_host(frame: bytes) -> bytes:
        """The host twin of the device decap, for punted frames (the punt
        handler sees the original bytes): the inner Ethernet+IPv4 view of
        a PPPoE session IPv4 frame, else the frame unchanged."""
        off = 12
        et = int.from_bytes(frame[off: off + 2], "big")
        while et in (0x8100, 0x88A8) and len(frame) >= off + 8:
            off += 4
            et = int.from_bytes(frame[off: off + 2], "big")
        if et != 0x8864 or len(frame) < off + 10:
            return frame
        if int.from_bytes(frame[off + 8: off + 10], "big") != 0x0021:
            return frame
        return frame[:off] + b"\x08\x00" + frame[off + 10:]

    def _punt_new_flow(self, frame: bytes, now: int) -> None:
        """Device egress-miss: create the session host-side."""
        if self.pppoe is not None:
            frame = self._strip_pppoe_host(frame)
        try:
            d = F.decode(frame)
        except Exception:  # noqa: BLE001 — a truncated frame is simply not a flow
            return
        if d.ethertype != 0x0800:
            return
        src_port = d.icmp_id if d.proto == 1 else d.src_port
        dst_port = 0 if d.proto == 1 else d.dst_port
        self.nat.handle_new_flow(d.src_ip, d.dst_ip, src_port, dst_port, d.proto,
                                 len(frame), now)
