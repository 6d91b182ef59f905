"""Prometheus-compatible metrics registry with bng_* name parity (a copy of
`bng_tpu/control/metrics.py`).

Parity: pkg/metrics — Metrics struct with ~30 bng_* families
(metrics.go:16-380, names at :92-280), Collect polling fast-path stats +
pool stats + DHCP server counters every interval (metrics.go:555-623),
StartCollector (:625), /metrics HTTP endpoint (cmd/bng/main.go:1219-1241).

Implemented without the prometheus client library: a small registry
producing the text exposition format (v0.0.4), which Prometheus scrapes
identically. Counter/Gauge/Histogram support labels.

`BNGMetrics` registers every family the reference registers, so a fresh
`expose()` is byte-equal to the reference's, and has every collector
the reference has: the wire pump's, the cluster fabric's and its
handoff's, and cluster membership's among them. Every
source reads host state only (EngineStats numpy,
scheduler counters, host mirrors): a scrape never reads a device tensor,
so it never synchronizes the serving stream.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from bng_tpu_torch.utils.structlog import ErrorLog


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str, label_names: tuple = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: OrderedDict[tuple, float] = OrderedDict()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}, "
                             f"got {tuple(labels)}")
        return tuple(labels[n] for n in self.label_names)

    def labeled(self) -> list[dict]:
        """Label dicts currently carrying a child value — lets callers
        reconcile a labeled family against fresh state and `remove`
        labels that no longer exist."""
        with self._lock:
            return [dict(zip(self.label_names, k)) for k in self._children]

    def remove(self, **labels) -> bool:
        """Drop one labeled child (True if it existed). A label whose
        subject disappeared must leave the scrape — a frozen last value
        reads as live state."""
        key = self._key(labels)
        with self._lock:
            return self._children.pop(key, None) is not None

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            if not self._children and not self.label_names:
                out.append(f"{self.name} 0")
            for key, val in self._children.items():
                labels = dict(zip(self.label_names, key))
                out.append(f"{self.name}{_fmt_labels(labels)} {_fmt_value(val)}")
        return out


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + value

    def set_total(self, value: float, **labels) -> None:
        """Absolute set for counters mirrored from device stats arrays
        (the reference overwrites from the eBPF stats map the same way)."""
        key = self._key(labels)
        with self._lock:
            self._children[key] = max(self._children.get(key, 0.0), float(value))

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._children[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Histogram:
    kind = "histogram"
    DEFAULT_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2,
                       1e-1, 5e-1, 1.0, float("inf"))

    def __init__(self, name: str, help_text: str, label_names: tuple = (),
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(buckets))
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self._lock = threading.Lock()
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: bad labels {tuple(labels)}")
        return tuple(labels[n] for n in self.label_names)

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in self._counts.items():
                labels = dict(zip(self.label_names, key))
                for ub, c in zip(self.buckets, counts):
                    ls = dict(labels, le=_fmt_value(ub))
                    out.append(f"{self.name}_bucket{_fmt_labels(ls)} {c}")
                out.append(f"{self.name}_sum{_fmt_labels(labels)} "
                           f"{self._sums[key]}")
                out.append(f"{self.name}_count{_fmt_labels(labels)} "
                           f"{counts[-1]}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: OrderedDict[str, object] = OrderedDict()

    def register(self, metric) -> object:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help_text, labels=()):
        return self.register(Counter(name, help_text, labels))

    def gauge(self, name, help_text, labels=()):
        return self.register(Gauge(name, help_text, labels))

    def histogram(self, name, help_text, labels=(), buckets=Histogram.DEFAULT_BUCKETS):
        return self.register(Histogram(name, help_text, labels, buckets))

    def expose(self) -> str:
        """Text exposition format, scrape-ready."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


# Device stats array indexes (mirrors runtime.engine stat layouts; the
# reference reads the same counters from the dhcp_stats map,
# bpf/maps.h:171-191).
DHCP_STAT_NAMES = ("packets_seen", "fastpath_hits", "fastpath_misses",
                   "offers_sent", "acks_sent", "errors", "expired",
                   "non_dhcp", "malformed", "punted")


class BNGMetrics:
    """All bng_* families (metrics.go:16-380) + the 5s collector loop."""

    def __init__(self, registry: Registry | None = None):
        r = self.registry = registry or Registry()
        lbl_type = ("type",)
        self.dhcp_requests_total = r.counter(
            "bng_dhcp_requests_total", "DHCP requests processed", lbl_type)
        self.dhcp_request_duration = r.histogram(
            "bng_dhcp_request_duration_seconds", "DHCP handling latency", ("path",))
        self.dhcp_cache_hit_rate = r.gauge(
            "bng_dhcp_cache_hit_rate", "Fast-path cache hit rate")
        self.dhcp_active_leases = r.gauge(
            "bng_dhcp_active_leases", "Active DHCP leases")
        self.ebpf_fastpath_hits = r.counter(
            "bng_ebpf_fastpath_hits_total", "Device fast-path hits")
        self.ebpf_fastpath_misses = r.counter(
            "bng_ebpf_fastpath_misses_total", "Device fast-path misses")
        self.ebpf_errors = r.counter(
            "bng_ebpf_errors_total", "Device pipeline errors")
        self.ebpf_cache_expired = r.counter(
            "bng_ebpf_cache_expired_total", "Expired fast-path entries")
        self.ebpf_map_entries = r.gauge(
            "bng_ebpf_map_entries", "Entries per device table", ("map",))
        self.pool_utilization = r.gauge(
            "bng_pool_utilization_ratio", "Pool utilization 0-1", ("pool",))
        self.pool_available = r.gauge(
            "bng_pool_available_ips", "Available IPs", ("pool",))
        self.pool_allocated = r.gauge(
            "bng_pool_allocated_ips", "Allocated IPs", ("pool",))
        # counted degradations (storm-suite hygiene): every allocator
        # that can refuse work for capacity reasons reports here, by
        # resource — dhcp_pool / fleet_slice (worker-side dhcp_pool) /
        # dhcp6_addr / dhcp6_pd / nat_block / nat_port
        self.pool_exhausted = r.counter(
            "bng_pool_exhausted_total",
            "Allocations refused on an exhausted resource (degraded "
            "verdicts are counted + rate-limit logged, never silent)",
            ("resource",))
        self.circuit_id_collisions = r.counter(
            "bng_circuit_id_hash_collisions_total", "Circuit-ID hash collisions")
        self.circuit_id_collision_rate = r.gauge(
            "bng_circuit_id_collision_rate", "Circuit-ID collision rate")
        self.session_active = r.gauge(
            "bng_session_active", "Active sessions", lbl_type)
        self.session_total = r.counter(
            "bng_session_total", "Sessions created", lbl_type)
        self.session_bytes_in = r.counter(
            "bng_session_bytes_in_total", "Subscriber bytes in")
        self.session_bytes_out = r.counter(
            "bng_session_bytes_out_total", "Subscriber bytes out")
        self.nat_bindings_active = r.gauge(
            "bng_nat_bindings_active", "Active NAT bindings")
        self.nat_translations_total = r.counter(
            "bng_nat_translations_total", "NAT translations", ("direction",))
        self.nat_ports_used = r.gauge(
            "bng_nat_ports_used", "NAT ports in use", ("public_ip",))
        self.radius_requests_total = r.counter(
            "bng_radius_requests_total", "RADIUS requests", ("type", "status"))
        self.radius_timeouts_total = r.counter(
            "bng_radius_timeouts_total", "RADIUS timeouts")
        self.qos_policies_active = r.gauge(
            "bng_qos_policies_active", "Active QoS policies")
        self.qos_packets_dropped = r.counter(
            "bng_qos_packets_dropped_total", "QoS-dropped packets")
        self.qos_bytes_dropped = r.counter(
            "bng_qos_bytes_dropped_total", "QoS-dropped bytes")
        self.pppoe_sessions_active = r.gauge(
            "bng_pppoe_sessions_active", "Active PPPoE sessions")
        self.pppoe_negotiations_total = r.counter(
            "bng_pppoe_negotiations_total", "PPPoE negotiations", ("result",))
        self.routes_active = r.gauge(
            "bng_routes_active", "Installed routes", ("isp",))
        self.bgp_peers_up = r.gauge(
            "bng_bgp_peers_up", "Established BGP peers")
        self.bgp_prefixes_received = r.gauge(
            "bng_bgp_prefixes_received", "Prefixes from peers", ("peer",))
        self.subscriber_total = r.gauge(
            "bng_subscriber_total", "Known subscribers")
        self.subscriber_by_class = r.gauge(
            "bng_subscriber_by_class", "Subscribers per class", ("class",))
        self.subscriber_by_isp = r.gauge(
            "bng_subscriber_by_isp", "Subscribers per ISP", ("isp",))
        # round-4 subsystems (no reference analog for the device gate —
        # its garden never gated the packet path; observability is how a
        # new enforcement point earns trust)
        self.garden_gated_drops = r.counter(
            "bng_walled_garden_device_drops_total",
            "Packets dropped on device by the walled-garden gate")
        self.garden_allowed_hits = r.counter(
            "bng_walled_garden_device_allowed_total",
            "Gardened packets passed to an allowed destination")
        self.dns_queries = r.counter(
            "bng_dns_queries_total", "DNS queries served", ("outcome",))
        self.dns_cache_hit_rate = r.gauge(
            "bng_dns_cache_hit_rate", "DNS cache hit rate")
        self.dns_overloaded = r.counter(
            "bng_dns_overloaded_total", "DNS queries dropped under overload")
        # latency-tiered scheduler (runtime/scheduler.py). No reference
        # analog: per-packet XDP has no batches to schedule; these are the
        # observability surface the two-lane design earns trust with.
        lbl_lane = ("lane",)
        self.sched_queue_depth = r.gauge(
            "bng_sched_queue_depth", "Frames staged per scheduler lane",
            lbl_lane)
        self.sched_inflight = r.gauge(
            "bng_sched_inflight_batches",
            "Dispatched-but-unretired device batches per lane", lbl_lane)
        self.sched_dispatches = r.counter(
            "bng_sched_dispatches_total",
            "Device dispatches per lane and batch-close reason",
            ("lane", "close"))
        self.sched_frames = r.counter(
            "bng_sched_frames_total", "Frames retired per lane", lbl_lane)
        self.sched_dropped = r.counter(
            "bng_sched_dropped_total",
            "Frames dropped at lane backpressure bound", lbl_lane)
        self.sched_oversize_dropped = r.counter(
            "bng_sched_oversize_dropped_total",
            "Frames dropped at submit for exceeding the engine pkt slot")
        self.sched_completions_evicted = r.counter(
            "bng_sched_completions_evicted_total",
            "Completions evicted from the bounded delivery deque")
        self.sched_batch_occupancy = r.histogram(
            "bng_sched_batch_occupancy_ratio",
            "Dispatched batch fill ratio (1.0 = full close)", lbl_lane,
            buckets=(0.0625, 0.125, 0.25, 0.5, 0.75, 0.875, 1.0))
        self.sched_dispatch_latency = r.histogram(
            "bng_sched_dispatch_latency_seconds",
            "Oldest-frame submit->retire latency per dispatched batch",
            lbl_lane)
        # AOT express OFFER path: which program served the
        # express lane, and how often the AOT geometry missed — a miss
        # falls back to the jit full-program path, so a rising miss
        # counter under steady traffic IS a fallback storm
        self.express_program_dispatches = r.counter(
            "bng_express_program_dispatches_total",
            "Express-lane device dispatches by serving program",
            ("program",))
        self.express_aot_miss = r.counter(
            "bng_express_aot_miss_total",
            "Express dispatches that missed the AOT program cache and "
            "fell back to the jit full-program path")
        # express rung-fallback family (gray-failure
        # hardening): every event where the express lane served below
        # its configured rung, by reason — compile_failed (AOT refused
        # to lower at setup), geometry_miss (per-dispatch cache miss),
        # devloop_compile_failed / devloop_unavailable / devloop_miss
        # (the ring megakernel degrading to per-batch). Any nonzero
        # rate here under a supposedly-healthy config is a gray failure.
        self.express_fallback = r.counter(
            "bng_express_fallback_total",
            "Express serving-rung fallback events by reason",
            ("reason",))
        # AF_XDP wire path: which attach rung actually serves
        # (a requested NIC landing on `memory` is a silent fallback that
        # must never masquerade as wire serving) + the wire pump's frame
        # accounting — pump_stats exported so fill-pool leaks, submit
        # failures and TX-stall overflow drops are dashboard facts.
        self.wire_rung = r.gauge(
            "bng_wire_rung",
            "1 for the attach-ladder rung serving the wire (zerocopy | "
            "copy | memory), 0 for the others", ("mode",))
        self.wire_pump_path = r.gauge(
            "bng_wire_pump_path",
            "1 for the wire-pump implementation in use (scalar | "
            "vector, BNG_WIRE_PUMP)", ("path",))
        self.wire_frames = r.counter(
            "bng_wire_frames_total",
            "Frames moved by the wire pump per direction", ("dir",))
        self.wire_filled = r.counter(
            "bng_wire_filled_total",
            "Free frames fed to the kernel fill ring")
        self.wire_completed = r.counter(
            "bng_wire_completed_total",
            "TX completions reaped back to the frame pool")
        self.wire_rx_submit_fail = r.counter(
            "bng_wire_rx_submit_fail_total",
            "Kernel RX frames the ring refused (rx-full or a length "
            "that cannot fit the chunk room); every one is recycled")
        self.wire_tx_overflow = r.counter(
            "bng_wire_tx_overflow_total",
            "Pending-TX frames dropped at the explicit bound while the "
            "kernel TX ring stalled")
        self.wire_tx_pending = r.gauge(
            "bng_wire_tx_pending",
            "Verdict descriptors awaiting kernel TX slots")
        # slow-path fleet (control/fleet.py + control/admission.py). The
        # reference's concurrency is invisible goroutines; here worker
        # sharding, admission shedding and lease-slice refill are
        # explicit mechanisms that earn trust through these families.
        lbl_worker = ("worker",)
        self.slowpath_workers = r.gauge(
            "bng_slowpath_workers", "Slow-path fleet worker count")
        self.slowpath_worker_frames = r.counter(
            "bng_slowpath_worker_frames_total",
            "Frames handled per fleet worker", lbl_worker)
        self.slowpath_worker_errors = r.counter(
            "bng_slowpath_worker_errors_total",
            "Per-frame handler errors isolated per fleet worker",
            lbl_worker)
        self.slowpath_worker_busy = r.counter(
            "bng_slowpath_worker_busy_seconds_total",
            "Wall seconds each worker spent handling batches", lbl_worker)
        self.slowpath_worker_leases = r.gauge(
            "bng_slowpath_worker_leases",
            "Active leases owned per fleet worker", lbl_worker)
        self.slowpath_slice_free = r.gauge(
            "bng_slowpath_lease_slice_free",
            "Unallocated addresses in a worker's lease slices",
            lbl_worker)
        self.slowpath_admitted = r.counter(
            "bng_slowpath_admitted_total",
            "Frames admitted to fleet worker inboxes")
        self.slowpath_shed = r.counter(
            "bng_slowpath_shed_total",
            "Frames shed by the admission controller", ("reason",))
        self.slowpath_refills = r.counter(
            "bng_slowpath_lease_refills_total",
            "Lease-slice refill grants served to workers")
        self.slowpath_fallback = r.counter(
            "bng_slowpath_fallback_frames_total",
            "Non-DHCPv4 slow frames routed to the parent demux")
        # a configured fleet that silently degraded to one worker is an
        # invisible capacity cliff: the gauge names WHY (per blocker), so
        # the dashboard shows it before the first overload does
        self.slowpath_fleet_blocked = r.gauge(
            "bng_slowpath_fleet_blocked",
            "1 per integration blocking the configured slow-path fleet "
            "(process runs single-worker until these are fleet-aware)",
            ("blocker",))
        # cluster-of-BNGs (bng_tpu/cluster): the front-door
        # coordinator's view — membership, carve-plan ownership and the
        # failover counters. Per-instance gauges reconcile against the
        # live membership (a departed member's labels drop).
        self.cluster_instances = r.gauge(
            "bng_cluster_instances",
            "Cluster members by state (up / dead / pending)", ("state",))
        self.cluster_plan_epoch = r.gauge(
            "bng_cluster_plan_epoch",
            "Carve-plan epoch the coordinator is serving")
        self.cluster_free_blocks = r.gauge(
            "bng_cluster_free_blocks",
            "Unassigned carve blocks (headroom for joiners)")
        self.cluster_addresses = r.gauge(
            "bng_cluster_addresses",
            "Addresses carved to an instance", ("instance",))
        self.cluster_leases = r.gauge(
            "bng_cluster_leases",
            "Live leases held by an instance", ("instance",))
        self.cluster_steered = r.counter(
            "bng_cluster_steered_frames_total",
            "Front-door frames steered to an instance", ("instance",))
        self.cluster_recarves = r.counter(
            "bng_cluster_recarves_total",
            "Carve-plan changes applied (joins, leaves)")
        self.cluster_failovers = r.counter(
            "bng_cluster_failovers_total",
            "Standby promotions after a member death")
        self.cluster_shed = r.counter(
            "bng_cluster_shed_frames_total",
            "Front-door frames shed (steered at a dead member before "
            "its standby promoted)")
        self.cluster_refused_removes = r.counter(
            "bng_cluster_refused_removes_total",
            "Member removals refused for holding live leases "
            "(never-half-allocate)")
        # cluster control fabric (cluster/fabric): the membership lane's
        # own health — beat traffic, per-member suspicion state, verdict
        # and partition counts, and the transport's rejection reasons.
        # The RADIUS fan-out counters ride here too (the fabric owns
        # cross-member steering, and CoA relay is exactly that).
        self.fabric_beats_tx = r.counter(
            "bng_fabric_beats_tx_total",
            "Heartbeats this node sent over the fabric")
        self.fabric_beats_rx = r.counter(
            "bng_fabric_beats_rx_total",
            "Heartbeats this node absorbed from watched peers")
        self.fabric_member_state = r.gauge(
            "bng_fabric_member_state",
            "Detector state per watched member (1 at the current "
            "state's label, 0 elsewhere)", ("member", "state"))
        self.fabric_member_suspicion = r.gauge(
            "bng_fabric_member_suspicion",
            "Accusers currently voting against a member (quorum "
            "pressure; 0 = trusted by everyone)", ("member",))
        self.fabric_verdicts = r.counter(
            "bng_fabric_verdicts_total",
            "Detector verdicts issued by kind", ("verdict",))
        self.fabric_partitions = r.counter(
            "bng_fabric_partitions_observed_total",
            "Suspicion episodes that healed (beats resumed before any "
            "demotion): transient partitions survived")
        self.fabric_rx_rejected = r.counter(
            "bng_fabric_rx_rejected_total",
            "Fabric datagrams rejected on receive", ("reason",))
        # multi-box deployment: join bootstrap, the handoff
        # state-transfer lane, and host-loss group promotions
        self.fabric_join_retries = r.counter(
            "bng_fabric_join_retries_total",
            "Join announces re-sent by the capped-backoff bootstrap "
            "(first attempt not counted)")
        self.handoff_chunks = r.counter(
            "bng_handoff_chunks_total",
            "State-transfer chunks by disposition (rx / corrupt / dup "
            "/ orphan / tx / retx)", ("disposition",))
        self.handoff_transfers = r.counter(
            "bng_handoff_transfers_total",
            "State transfers by outcome (completed / rejected / "
            "resumed)", ("outcome",))
        self.cluster_host_losses = r.counter(
            "bng_cluster_host_losses_total",
            "Whole hosts declared lost (every member DOWN by quorum; "
            "surviving-host HA halves promoted as a group)")
        self.fabric_coa_relayed = r.counter(
            "bng_fabric_coa_relayed_total",
            "CoA/Disconnect requests relayed off the steered shard "
            "(the dynamic-authorization missteer corrector)")
        self.fabric_auth_shard = r.counter(
            "bng_fabric_auth_shard_total",
            "RADIUS authentications served per MAC-affine worker "
            "shard", ("worker",))
        # checkpoint/warm-restart subsystem (runtime/checkpoint.py +
        # control/statestore.py). The reference needs none of this — its
        # state survives in kernel-pinned maps; here snapshot health IS
        # restart safety, so it gets first-class observability.
        self.ckpt_saves = r.counter(
            "bng_ckpt_saves_total", "Checkpoints written successfully")
        self.ckpt_failures = r.counter(
            "bng_ckpt_failures_total", "Checkpoint save attempts that failed")
        self.ckpt_last_success_age = r.gauge(
            "bng_ckpt_last_success_age_seconds",
            "Seconds since the last successful checkpoint")
        self.ckpt_bytes = r.gauge(
            "bng_ckpt_bytes", "Size of the last written checkpoint")
        self.ckpt_seq = r.gauge(
            "bng_ckpt_seq", "Sequence number of the last written checkpoint")
        self.ckpt_duration = r.histogram(
            "bng_ckpt_duration_seconds",
            "Quiesce+snapshot+write duration per checkpoint", ("reason",))
        self.ckpt_restore_rows = r.gauge(
            "bng_ckpt_restore_rows",
            "Rows recovered per table by the startup restore", ("table",))
        self.ckpt_restores = r.counter(
            "bng_ckpt_restores_total",
            "Startup restore outcomes", ("outcome",))
        # chaos harness + invariant auditor (bng_tpu/chaos). The
        # reference has no analog — its correctness-under-failure story
        # is kernel-pinned maps; here recovery is code, and code that is
        # only trusted because these families prove it keeps passing.
        self.chaos_faults = r.counter(
            "bng_chaos_faults_injected_total",
            "Faults injected by the chaos harness", ("point", "kind"))
        self.chaos_scenarios = r.counter(
            "bng_chaos_scenarios_total",
            "Chaos scenarios run", ("result",))
        self.invariant_audits = r.counter(
            "bng_invariant_audits_total",
            "Cross-authority invariant audits run")
        self.invariant_violations = r.counter(
            "bng_invariant_violations_total",
            "Invariant violations found, by kind", ("kind",))
        self.invariant_last_epoch = r.gauge(
            "bng_invariant_last_audit_epoch",
            "Epoch (soak epoch or audit counter) of the last audit")
        self.invariant_last_violations = r.gauge(
            "bng_invariant_last_audit_violations",
            "Violations found by the most recent audit")
        # zero-downtime operations (control/fleet.py resize/rolling
        # restart, runtime/ops.py blue/green swap, control/opsctl.py).
        # The reference restarts for every capacity/config change; here
        # each transition is code with a rollback path, and these
        # families are how an operator proves a transition cost what the
        # runbook promised.
        lbl_op = ("op",)
        self.ops_transitions = r.counter(
            "bng_ops_transitions_total",
            "Zero-downtime transitions by op and outcome",
            ("op", "outcome"))
        self.ops_transition_duration = r.histogram(
            "bng_ops_transition_duration_seconds",
            "End-to-end duration per transition", lbl_op)
        self.ops_quiesce_duration = r.histogram(
            "bng_ops_quiesce_duration_seconds",
            "Quiesce-barrier cost paid by a transition", lbl_op)
        self.ops_frames_deferred = r.counter(
            "bng_ops_frames_deferred_total",
            "In-flight frames retired early by a transition's quiesce",
            lbl_op)
        self.ops_leases_moved = r.counter(
            "bng_ops_leases_transferred_total",
            "Leases transferred between workers by a transition", lbl_op)
        self.ops_offers_moved = r.counter(
            "bng_ops_offers_transferred_total",
            "In-flight (un-ACKed) OFFERs carried across a transition",
            lbl_op)
        self.ops_delta_rows = r.counter(
            "bng_ops_delta_rows_replayed_total",
            "Host-mirror rows delta-replayed into the standby engine")
        self.ops_autoscaler_target = r.gauge(
            "bng_ops_autoscaler_target_workers",
            "Most recent worker count the autoscaler steered to")
        # telemetry subsystem (bng_tpu/telemetry): flight-recorder and
        # tracer health. The per-stage latency distributions themselves
        # export as bng_stage_latency_us via attach_telemetry (a live
        # view over the tracer's mergeable log-bucketed histograms — a
        # 5s scrape cannot reconstruct a p999).
        self.flight_dumps = r.counter(
            "bng_flight_dumps_total",
            "Flight-recorder dumps written, by anomaly trigger",
            ("reason",))
        self.telemetry_records = r.counter(
            "bng_telemetry_batch_records_total",
            "Per-batch flight records finalized by the tracer")
        self.telemetry_dropped = r.counter(
            "bng_telemetry_records_dropped_total",
            "Batch records dropped because the open-slot pool was full")
        self._stage_latency_export = None  # attach_telemetry wires it
        # SLO engine (telemetry/slo.py SLOMonitor): live burn-rate
        # verdicts over the per-stage budgets. The budget gauge exports
        # the configured line so dashboards draw target vs observed
        # from one scrape.
        lbl_stage = ("stage",)
        self.slo_breaches = r.counter(
            "bng_slo_breaches_total",
            "Burn-rate SLO breaches by stage (slo_breach flight dumps "
            "fire alongside)", lbl_stage)
        self.slo_burning = r.gauge(
            "bng_slo_burning_windows",
            "Consecutive over-budget windows per stage (resets on a "
            "healthy window)", lbl_stage)
        self.slo_window_p99 = r.gauge(
            "bng_slo_window_p99_us",
            "Windowed p99 per stage from the live SLO monitor",
            lbl_stage)
        self.slo_budget = r.gauge(
            "bng_slo_budget_us",
            "Configured per-stage p99 budget (amortized by the spec's "
            "per divisor)", lbl_stage)
        self.slo_ok = r.gauge(
            "bng_slo_ok", "1 while no stage is burning its SLO budget")
        # sharded-path telemetry (parallel/sharded.py ShardTelemetry):
        # per-shard verdict/punt counters + per-shard stage p99s — the
        # observability the 8-chip serving-path promotion gates on
        self.shard_frames = r.counter(
            "bng_shard_frames_total",
            "Real frames processed per shard by verdict",
            ("shard", "verdict"))
        self.shard_nat_punts = r.counter(
            "bng_shard_nat_punts_total",
            "NAT egress-miss punts per shard", ("shard",))
        self.shard_missteers = r.counter(
            "bng_shard_missteer_total",
            "Wrong-shard punts counted exactly at retire (a PASS lane "
            "whose affinity owner is a different shard): nonzero means "
            "steering drift, not slow-path load", ("shard",))
        self.shard_psum_hits = r.counter(
            "bng_shard_psum_dhcp_hits_total",
            "DHCP fast-path hits psum-reduced over the mesh")
        self.shard_stage_p99 = r.gauge(
            "bng_shard_stage_p99_us",
            "Per-shard stage p99 from the sharded-path histograms",
            ("shard", "stage"))
        # antispoof stage (ops/antispoof.py AST_* words). The reference
        # streams violations over a perf-event buffer; here the device
        # counts and the host logs rate-limited, so the counters are the
        # durable record a DDoS post-mortem reads.
        self.antispoof_allowed = r.counter(
            "bng_antispoof_allowed_total",
            "Access-side frames the source-validation stage passed")
        self.antispoof_dropped = r.counter(
            "bng_antispoof_dropped_total",
            "Frames dropped for a spoofed source address")
        self.antispoof_logged = r.counter(
            "bng_antispoof_logged_total",
            "Violations recorded by log-only mode (frame still passed)")
        self.antispoof_violations = r.counter(
            "bng_antispoof_violations_total",
            "Source-validation violations by address family",
            ("family",))
        # edge protection (bng_tpu/edge): device tap-match + next-hop
        # rewrite. Armed-tap and route-row gauges reconcile against the
        # control plane (the _audit_edge clauses); the counters are the
        # fast-path truth a lawful-intercept export is reconciled to.
        self.edge_taps_armed = r.gauge(
            "bng_edge_taps_armed", "Tap rows armed on the device")
        self.edge_routes_active = r.gauge(
            "bng_edge_routes_active", "Next-hop route rows on the device")
        self.edge_dirty_slots = r.gauge(
            "bng_edge_dirty_slots",
            "Edge table rows changed host-side awaiting the next drain")
        self.edge_mirrored = r.counter(
            "bng_edge_mirrored_total",
            "Frames flagged MIRROR by the device tap-match stage")
        self.edge_tap_filtered = r.counter(
            "bng_edge_tap_filtered_total",
            "Tapped-subscriber frames the DEVICE filter predicate "
            "excluded (never reached the host mirror path)")
        self.edge_route_rewrites = r.counter(
            "bng_edge_route_rewrites_total",
            "Upstream frames steered by the device next-hop rewrite")
        self.edge_route_misses = r.counter(
            "bng_edge_route_misses_total",
            "Upstream data frames with no route row (default path)")
        # lawful intercept (control/intercept.py): warrant book + export
        # stream health. export_errors nonzero is an evidentiary gap.
        self.intercept_warrants = r.gauge(
            "bng_intercept_warrants", "Warrants in the book")
        self.intercept_sessions = r.gauge(
            "bng_intercept_sessions_active",
            "Sessions currently matched to a warrant")
        self.intercept_iri = r.counter(
            "bng_intercept_iri_records_total",
            "IRI (intercept-related information) records exported")
        self.intercept_cc = r.counter(
            "bng_intercept_cc_records_total",
            "CC (content) records exported from mirrored frames")
        self.intercept_filtered = r.counter(
            "bng_intercept_filtered_total",
            "Mirrored frames excluded by host-side warrant filters")
        self.intercept_export_errors = r.counter(
            "bng_intercept_export_errors_total",
            "Delivery failures while exporting intercept records")

    # -- telemetry (bng_tpu/telemetry) ----------------------------------

    def attach_telemetry(self, tracer) -> None:
        """Register the bng_stage_latency_us family as a live view over
        the tracer's per-stage histograms and remember the tracer for
        collect_telemetry. Idempotent (re-attach swaps the tracer)."""
        if self._stage_latency_export is None:
            self._stage_latency_export = _StageLatencyExport(tracer)
            self.registry.register(self._stage_latency_export)
        else:
            self._stage_latency_export.tracer = tracer

    def collect_telemetry(self, tracer) -> None:
        """Tracer/recorder health -> counters (a 5s-scrape source)."""
        self.telemetry_records.set_total(tracer.seq)
        self.telemetry_dropped.set_total(tracer.records_dropped)
        rec = tracer.recorder
        if rec is not None:
            for reason, n in rec.triggers.items():
                self.flight_dumps.set_total(n, reason=reason)

    def collect_slo(self, monitor) -> None:
        """Live SLO monitor (telemetry/slo.py) -> bng_slo_* families.
        Reads one locked snapshot — never monitor internals — so the
        scrape thread can never observe a half-evaluated window."""
        snap = monitor.snapshot()
        self.slo_ok.set(1.0 if snap["ok"] else 0.0)
        for stage, limit in snap["budgets_us"].items():
            self.slo_budget.set(limit, stage=stage)
        for stage, n in snap["breaches"].items():
            self.slo_breaches.set_total(n, stage=stage)
        for stage, n in snap["burning"].items():
            self.slo_burning.set(n, stage=stage)
        for stage, p99 in snap["window_p99_us"].items():
            self.slo_window_p99.set(p99, stage=stage)

    def collect_wire(self, attachment, pump=None) -> None:
        """AF_XDP wire identity + pump accounting (runtime/xsk.py) ->
        bng_wire_* families. `attachment` is the WireAttachment the
        attach ladder returned (None = wire never requested); `pump`
        defaults to the attached socket's WirePump and may be passed
        explicitly for memory-rung loops (SimKernelRings)."""
        if attachment is None and pump is None:
            return
        if attachment is not None:
            from bng_tpu_torch.runtime.xsk import (MODE_COPY, MODE_MEMORY,
                                             MODE_ZEROCOPY)

            for mode in (MODE_ZEROCOPY, MODE_COPY, MODE_MEMORY):
                self.wire_rung.set(1.0 if attachment.mode == mode else 0.0,
                                   mode=mode)
            if pump is None and attachment.xsk is not None:
                pump = attachment.xsk.wire_pump
        if pump is None:
            return
        from bng_tpu_torch.runtime.xsk import WIRE_PUMPS

        for p in WIRE_PUMPS:
            self.wire_pump_path.set(1.0 if pump.path == p else 0.0, path=p)
        st = pump.pump_stats
        self.wire_frames.set_total(st["rx"], dir="rx")
        self.wire_frames.set_total(st["tx"], dir="tx")
        self.wire_filled.set_total(st["filled"])
        self.wire_completed.set_total(st["completed"])
        self.wire_rx_submit_fail.set_total(st["rx_submit_fail"])
        self.wire_tx_overflow.set_total(st["tx_overflow"])
        self.wire_tx_pending.set(pump.tx_pending())

    def collect_sharded(self, cluster) -> None:
        """Sharded-path telemetry (parallel/sharded.py ShardTelemetry)
        -> bng_shard_* families: per-shard verdict/punt counters + the
        per-shard stage p99s, from one snapshot."""
        snap = cluster.telemetry.snapshot()
        self.shard_psum_hits.set_total(snap["psum_dhcp_hits"])
        for i, sh in enumerate(snap["per_shard"]):
            shard = str(i)
            for verdict, n in sh["verdicts"].items():
                self.shard_frames.set_total(n, shard=shard,
                                            verdict=verdict)
            self.shard_nat_punts.set_total(sh["nat_punts"], shard=shard)
            self.shard_missteers.set_total(sh["missteers"], shard=shard)
            for stage, s in sh["stages"].items():
                self.shard_stage_p99.set(s["p99_us"], shard=shard,
                                         stage=stage)

    # -- collection (metrics.go:555-623) -------------------------------

    def collect_engine(self, engine_stats) -> None:
        """Pull device-side counters from runtime.engine.EngineStats."""
        d = engine_stats.dhcp
        names = DHCP_STAT_NAMES[: len(d)]
        vals = {n: int(v) for n, v in zip(names, d)}
        hits = vals.get("fastpath_hits", 0)
        misses = vals.get("fastpath_misses", 0)
        self.ebpf_fastpath_hits.set_total(hits)
        self.ebpf_fastpath_misses.set_total(misses)
        self.ebpf_errors.set_total(vals.get("errors", 0) + vals.get("malformed", 0))
        self.ebpf_cache_expired.set_total(vals.get("expired", 0))
        total = hits + misses
        if total:
            self.dhcp_cache_hit_rate.set(hits / total)

    def collect_pools(self, pool_stats: dict) -> None:
        """pool_stats: {pool_name: {"size": N, "allocated"|"used": M}}."""
        for name, st in pool_stats.items():
            size = st.get("size", 0)
            alloc = st.get("allocated", st.get("used", 0))
            self.pool_allocated.set(alloc, pool=name)
            self.pool_available.set(size - alloc, pool=name)
            if size:
                self.pool_utilization.set(alloc / size, pool=name)

    def collect_dhcp_server(self, server_stats) -> None:
        for msg in ("discover", "offer", "request", "ack", "nak", "release"):
            v = getattr(server_stats, msg, None)
            if v is not None:
                self.dhcp_requests_total.set_total(v, type=msg)
        v = getattr(server_stats, "pool_exhausted", None)
        if v:
            self.pool_exhausted.set_total(v, resource="dhcp_pool")

    def collect_exhaustion(self, dhcpv6=None, nat=None, fleet=None) -> None:
        """Mirror the per-subsystem exhaustion counters into
        bng_pool_exhausted_total (the v4 server's ride along in
        collect_dhcp_server). Nil-safe per component so one source call
        covers whatever the composition root actually built."""
        if dhcpv6 is not None:
            if dhcpv6.stats.addr_exhausted:
                self.pool_exhausted.set_total(dhcpv6.stats.addr_exhausted,
                                              resource="dhcp6_addr")
            if dhcpv6.stats.pd_exhausted:
                self.pool_exhausted.set_total(dhcpv6.stats.pd_exhausted,
                                              resource="dhcp6_pd")
        if nat is not None:
            if nat.exhausted["block"]:
                self.pool_exhausted.set_total(nat.exhausted["block"],
                                              resource="nat_block")
            if nat.exhausted["port"]:
                self.pool_exhausted.set_total(nat.exhausted["port"],
                                              resource="nat_port")
        if fleet is not None:
            # monotonic across resize/rolling-restart (per-worker stats
            # restart at 0; the fleet folds dead sets' counts)
            total = fleet.pool_exhausted_total()
            if total:
                self.pool_exhausted.set_total(total, resource="fleet_slice")

    def collect_fleet(self, fleet) -> None:
        """SlowPathFleet.stats_snapshot() -> bng_slowpath_* families."""
        snap = fleet.stats_snapshot()
        self.slowpath_workers.set(snap["workers"])
        self.slowpath_refills.set_total(snap["refills"])
        self.slowpath_fallback.set_total(snap["fallback_frames"])
        for i, w in enumerate(snap["per_worker"]):
            if not w:
                continue  # no batch has reached this worker yet
            wl = str(i)
            self.slowpath_worker_frames.set_total(w["frames"], worker=wl)
            self.slowpath_worker_errors.set_total(w["errors"], worker=wl)
            self.slowpath_worker_busy.set_total(w["busy_s"], worker=wl)
            self.slowpath_worker_leases.set(w["leases"], worker=wl)
            self.slowpath_slice_free.set(
                sum(w["slice_free"].values()), worker=wl)
        adm = snap["admission"]
        self.slowpath_admitted.set_total(adm["admitted"])
        for reason, n in adm["shed"].items():
            self.slowpath_shed.set_total(n, reason=reason)
        # RADIUS fan-out: per-shard auth affinity + the CoA
        # relay counter (requests that arrived missteered and were
        # routed to the owning shard)
        if "coa_relayed" in snap:
            self.fabric_coa_relayed.set_total(snap["coa_relayed"])
        for i, w in enumerate(snap["per_worker"]):
            if w and "auth_requests" in w:
                self.fabric_auth_shard.set_total(w["auth_requests"],
                                                 worker=str(i))

    def collect_garden(self, engine_stats) -> None:
        """Device walled-garden gate counters (EngineStats.garden)."""
        g = getattr(engine_stats, "garden", None)
        if g is None or len(g) < 2:
            return
        self.garden_gated_drops.set_total(int(g[0]))
        self.garden_allowed_hits.set_total(int(g[1]))

    def collect_antispoof(self, engine_stats) -> None:
        """Antispoof stage counters (EngineStats.spoof, AST_* order)."""
        s = getattr(engine_stats, "spoof", None)
        if s is None or len(s) < 6:
            return
        self.antispoof_allowed.set_total(int(s[0]))
        self.antispoof_dropped.set_total(int(s[1]))
        self.antispoof_logged.set_total(int(s[2]))
        self.antispoof_violations.set_total(int(s[3]), family="v4")
        self.antispoof_violations.set_total(int(s[4]), family="v6")

    def collect_edge(self, engine_stats, tables=None) -> None:
        """Edge-protection counters (EngineStats.edge, EST_* order) +
        table-occupancy gauges from the host surface (Engine.edge or a
        ShardedCluster, both expose tap_rows/route_rows)."""
        e = getattr(engine_stats, "edge", None)
        if e is None and isinstance(engine_stats, dict):
            e = engine_stats.get("edge")
        if e is not None and len(e) >= 4:
            self.edge_mirrored.set_total(int(e[0]))
            self.edge_tap_filtered.set_total(int(e[1]))
            self.edge_route_rewrites.set_total(int(e[2]))
            self.edge_route_misses.set_total(int(e[3]))
        if tables is not None:
            self.edge_taps_armed.set(len(tables.tap_rows()))
            self.edge_routes_active.set(len(tables.route_rows()))
            dirty = getattr(tables, "dirty_count", None)
            if dirty is not None:
                self.edge_dirty_slots.set(dirty())

    def collect_intercept(self, manager) -> None:
        """Warrant-book + export-stream health (InterceptManager.stats()
        or an equivalent dict)."""
        st = manager.stats() if callable(getattr(manager, "stats", None)) \
            else dict(manager)
        self.intercept_warrants.set(st.get("warrants", 0))
        self.intercept_sessions.set(st.get("active_sessions", 0))
        self.intercept_iri.set_total(st.get("iri_records", 0))
        self.intercept_cc.set_total(st.get("cc_records", 0))
        self.intercept_filtered.set_total(st.get("filtered", 0))
        self.intercept_export_errors.set_total(st.get("export_errors", 0))

    def collect_scheduler(self, scheduler) -> None:
        """TieredScheduler.stats_snapshot() -> bng_sched_* gauges/counters
        (the histograms are fed live at dispatch/retire by the scheduler
        itself — a 5s scrape cannot reconstruct a latency distribution)."""
        snap = scheduler.stats_snapshot()
        for lane in ("express", "bulk"):
            s = snap.get(lane)
            if not s:
                continue
            self.sched_queue_depth.set(s["queue_depth"], lane=lane)
            self.sched_inflight.set(s["inflight"], lane=lane)
            self.sched_dropped.set_total(s["dropped_overflow"], lane=lane)
        self.sched_oversize_dropped.set_total(snap.get("oversize_dropped", 0))
        self.sched_completions_evicted.set_total(
            snap.get("completions_dropped", 0))
        ex = snap.get("express") or {}
        self.express_program_dispatches.set_total(
            ex.get("aot_dispatches", 0), program="aot-express")
        self.express_program_dispatches.set_total(
            ex.get("jit_dispatches", 0), program="jit-full")
        self.express_aot_miss.set_total(ex.get("aot_misses", 0))
        for reason, n in (ex.get("fallbacks") or {}).items():
            self.express_fallback.set_total(n, reason=reason)
        dl = ex.get("devloop")
        if dl:
            self.express_program_dispatches.set_total(
                dl.get("dispatches", 0), program="devloop")

    def collect_fabric(self, fabric: dict) -> None:
        """ClusterCoordinator.status()['fabric'] -> bng_fabric_*.
        Member-labeled gauges reconcile against the current watch set
        (a forgotten peer drops its labels, same staleness rule as
        record_cluster)."""
        self.fabric_beats_tx.set_total(fabric.get("beats_tx", 0))
        self.fabric_beats_rx.set_total(fabric.get("beats_rx", 0))
        for verdict, n in (fabric.get("verdicts") or {}).items():
            self.fabric_verdicts.set_total(n, verdict=str(verdict))
        self.fabric_partitions.set_total(
            fabric.get("partitions_observed", 0))
        peers = fabric.get("peers") or {}
        for labels in self.fabric_member_suspicion.labeled():
            if labels["member"] not in peers:
                self.fabric_member_suspicion.remove(**labels)
        for labels in self.fabric_member_state.labeled():
            if labels["member"] not in peers:
                self.fabric_member_state.remove(**labels)
        for member, view in sorted(peers.items()):
            self.fabric_member_suspicion.set(
                len(view.get("accused_by", ())), member=str(member))
            for state in ("up", "suspect", "gray", "down"):
                self.fabric_member_state.set(
                    1 if view.get("state") == state else 0,
                    member=str(member), state=state)
        for reason in ("bad_sig", "replay", "skew", "malformed"):
            n = (fabric.get("transport") or {}).get(f"rx_{reason}")
            if n is not None:
                self.fabric_rx_rejected.set_total(n, reason=reason)
        if "handoff" in fabric:
            self.collect_handoff(fabric["handoff"])

    def collect_handoff(self, h: dict) -> None:
        """HandoffManager.stats() -> bng_handoff_* (one node's view:
        the coordinator counts tx/retx, a member counts rx/rejects —
        both expose the same families)."""
        for disp in ("rx", "corrupt", "dup", "orphan"):
            self.handoff_chunks.set_total(
                h.get(f"rx_{disp}" if disp != "rx" else "rx_chunks", 0),
                disposition=disp)
        self.handoff_chunks.set_total(h.get("tx_chunks", 0),
                                      disposition="tx")
        self.handoff_chunks.set_total(h.get("retx_chunks", 0),
                                      disposition="retx")
        self.handoff_transfers.set_total(h.get("completed", 0),
                                         outcome="completed")
        self.handoff_transfers.set_total(h.get("rejects", 0),
                                         outcome="rejected")
        self.handoff_transfers.set_total(h.get("resumes", 0),
                                         outcome="resumed")

    def record_member(self, status: dict) -> None:
        """MemberRuntime.status() -> the joiner-side families: the
        bootstrap retry counter and its handoff receive lane."""
        self.fabric_join_retries.set_total(status.get("join_retries", 0))
        if "handoff" in status:
            self.collect_handoff(status["handoff"])

    def collect_checkpoint(self, checkpointer, now: float | None = None) -> None:
        """PeriodicCheckpointer.stats -> bng_ckpt_* gauges/counters (the
        duration histogram is fed live at save time)."""
        s = checkpointer.stats
        self.ckpt_saves.set_total(s["saves"])
        self.ckpt_failures.set_total(s["failures"])
        # before the first success, age counts from checkpointer start:
        # a dir that has NEVER taken a save must trip staleness alerts,
        # not read as perpetually fresh
        origin = s["last_success_t"] or getattr(checkpointer,
                                                "started_at", 0.0)
        if origin:
            now = now if now is not None else time.time()
            self.ckpt_last_success_age.set(max(0.0, now - origin))
        if s["last_success_t"]:
            self.ckpt_bytes.set(s["last_bytes"])
            self.ckpt_seq.set(s["last_seq"])

    def record_audit(self, report, epoch=None) -> None:
        """Invariant AuditReport -> bng_invariant_* families. `epoch`
        defaults to the running audit count (a monotonic stamp either
        way, so alerting can detect a stalled auditor)."""
        self.invariant_audits.inc()
        by_kind = report.violations_by_kind()
        for kind, n in by_kind.items():
            self.invariant_violations.inc(n, kind=kind)
        self.invariant_last_violations.set(sum(by_kind.values()))
        self.invariant_last_epoch.set(
            epoch if epoch is not None else self.invariant_audits.value())

    def record_transition(self, report: dict) -> None:
        """One zero-downtime transition report (fleet resize / rolling
        restart / engine swap) -> bng_ops_* families. Fed at transition
        time, not by the 5s scrape — transitions are rare events whose
        distribution a poll could miss entirely."""
        op = str(report.get("op", "unknown"))
        self.ops_transitions.inc(op=op,
                                outcome=str(report.get("outcome", "unknown")))
        if "duration_s" in report:
            self.ops_transition_duration.observe(float(report["duration_s"]),
                                                 op=op)
        if "quiesce_s" in report:
            self.ops_quiesce_duration.observe(float(report["quiesce_s"]),
                                              op=op)
        if report.get("frames_deferred"):
            self.ops_frames_deferred.inc(report["frames_deferred"], op=op)
        if report.get("leases_moved"):
            self.ops_leases_moved.inc(report["leases_moved"], op=op)
        if report.get("offers_moved"):
            self.ops_offers_moved.inc(report["offers_moved"], op=op)
        if report.get("delta_rows"):
            self.ops_delta_rows.inc(report["delta_rows"])

    def record_fleet_blocked(self, blockers: list[str]) -> None:
        """The configured-but-degraded fleet gauge: one labeled 1 per
        blocking integration (empty list = nothing blocked). A blocker
        that disappears across a config reload must DROP its label —
        a stale 1 reads as still-degraded forever on the dashboard."""
        want = {str(b) for b in blockers}
        for labels in self.slowpath_fleet_blocked.labeled():
            if labels["blocker"] not in want:
                self.slowpath_fleet_blocked.remove(**labels)
        for b in want:
            self.slowpath_fleet_blocked.set(1, blocker=b)

    def record_cluster(self, status: dict) -> None:
        """ClusterCoordinator.status() -> bng_cluster_* families.
        Instance-labeled gauges reconcile against the live membership:
        a member that left drops its labels (same staleness rule as
        record_fleet_blocked)."""
        states = {"up": 0, "dead": 0, "pending": 0}
        leases: dict[str, float] = {}
        steered: dict[str, float] = {}
        addrs: dict[str, float] = {}
        for iid, m in status.get("members", {}).items():
            if m.get("pending"):
                states["pending"] += 1
            elif not m.get("alive", True):
                states["dead"] += 1
            else:
                states["up"] += 1
            if "leases" in m:
                leases[str(iid)] = float(m["leases"])
            steered[str(iid)] = float(m.get("steered", 0))
        plan = status.get("plan") or {}
        if plan:
            self.cluster_plan_epoch.set(plan.get("epoch", 0))
            self.cluster_free_blocks.set(plan.get("free_blocks", 0))
            addrs = {str(i): float(a)
                     for i, a in plan.get("members", {}).items()}
        for state, n in states.items():
            self.cluster_instances.set(n, state=state)
        for gauge, want in ((self.cluster_addresses, addrs),
                            (self.cluster_leases, leases)):
            for labels in gauge.labeled():
                if labels["instance"] not in want:
                    gauge.remove(**labels)
            for iid, v in want.items():
                gauge.set(v, instance=iid)
        for iid, v in steered.items():
            self.cluster_steered.set_total(v, instance=iid)
        self.cluster_recarves.set_total(status.get("recarves", 0))
        self.cluster_failovers.set_total(status.get("failovers", 0))
        self.cluster_shed.set_total(status.get("shed_frames", 0))
        self.cluster_refused_removes.set_total(
            status.get("refused_removes", 0))
        self.cluster_host_losses.set_total(status.get("host_losses", 0))
        if "fabric" in status:
            self.collect_fabric(status["fabric"])

    def record_restore(self, rows: dict, outcome: str = "ok") -> None:
        """Startup-restore result -> bng_ckpt_restore_rows / restores."""
        self.ckpt_restores.inc(outcome=outcome)
        for table, n in rows.items():
            self.ckpt_restore_rows.set(n, table=table)

    def collect_dns(self, server_stats: dict, resolver_stats: dict) -> None:
        """DNSServer.stats + Resolver.stats() -> bng_dns_* families."""
        self.dns_queries.set_total(server_stats.get("served", 0), outcome="served")
        self.dns_queries.set_total(server_stats.get("bad_packets", 0), outcome="bad_packet")
        self.dns_queries.set_total(server_stats.get("server_errors", 0), outcome="error")
        self.dns_overloaded.set_total(server_stats.get("overloaded", 0))
        hits = resolver_stats.get("cache_hits", 0)
        total = resolver_stats.get("queries", 0)
        if total:
            self.dns_cache_hit_rate.set(hits / total)

    def expose(self) -> str:
        return self.registry.expose()


class _StageLatencyExport:
    """bng_stage_latency_us: Prometheus-histogram rendering of the
    telemetry tracer's per-stage log-bucketed histograms (telemetry/
    hist.py), materialized at expose time. The native buckets (8 per
    octave, <=12.5% relative error) are re-binned onto a fixed 1-2-5
    microsecond ladder so the exposition stays a bounded ~20 lines per
    stage while percentile math still happens on the full-resolution
    histograms (bench stage_breakdown, trace CLI)."""

    name = "bng_stage_latency_us"
    BOUNDS = (1, 2, 5, 10, 20, 50, 100, 200, 500,
              1_000, 2_000, 5_000, 10_000, 50_000, 100_000, 1_000_000)

    def __init__(self, tracer):
        self.tracer = tracer

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} Per-stage packet-lifecycle latency "
               f"(telemetry tracer)",
               f"# TYPE {self.name} histogram"]
        from bng_tpu_torch.telemetry.spans import STAGE_NAMES

        for i, h in enumerate(self.tracer.hists):
            if not h.n:
                continue
            stage = STAGE_NAMES[i]
            for ub in self.BOUNDS:
                out.append(f'{self.name}_bucket{{stage="{stage}",'
                           f'le="{ub}"}} {h.cumulative_le(float(ub))}')
            out.append(f'{self.name}_bucket{{stage="{stage}",'
                       f'le="+Inf"}} {h.n}')
            out.append(f'{self.name}_sum{{stage="{stage}"}} '
                       f'{round(h.sum_us, 3)}')
            out.append(f'{self.name}_count{{stage="{stage}"}} {h.n}')
        return out


class MetricsCollector:
    """Background collector loop (metrics.go:625) + HTTP /metrics server."""

    def __init__(self, metrics: BNGMetrics, interval: float = 5.0):
        self.metrics = metrics
        self.interval = interval
        self._sources: list = []  # callables () -> None that update metrics
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._httpd = None
        self.source_errors = 0
        self._source_err_log = ErrorLog(
            "metrics", "metrics source failed; its families go stale")

    def add_source(self, fn) -> None:
        self._sources.append(fn)

    def collect_once(self) -> None:
        for fn in self._sources:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — one bad source must
                # not stop the scrape, but a source that fails every 5s
                # forever is exactly how dashboards go quietly stale
                self.source_errors += 1
                self._source_err_log.report(
                    e, source=getattr(fn, "__qualname__", repr(fn)))

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        from bng_tpu_torch.analysis.sanitize import ctx_enter

        ctx_enter("scrape")
        while not self._stop.wait(self.interval):
            self.collect_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self._httpd:
            self._httpd.shutdown()

    def serve_http(self, port: int = 9090, host: str = "127.0.0.1") -> int:
        """Expose /metrics; returns the bound port (0 picks a free one)."""
        import http.server

        metrics = self.metrics

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                from bng_tpu_torch.analysis.sanitize import ctx_enter

                ctx_enter("scrape")
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = metrics.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self._httpd.server_address[1]
