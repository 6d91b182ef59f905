"""Composition root + CLI of the port: run / stats / loadtest / trace /
checkpoint / chaos / cluster / ctl / perf / check / demo / version (port
of `bng_tpu/cli.py`, every verb of it). `demo` and `perf` are host paths
and `check` is the static analyzer over the port (`analysis/`): none of
the three touches the card.

`BNGConfig` is the reference's flag surface, field for field, with the
same YAML overlay where the command line wins (`load_config_file`).
`BNGApp` builds what the reference's `run` builds for the subsystems the
port has: the span tracer with its flight recorder and SLO monitor (when
telemetry is on), the fast-path tables, the DNS listener over the
resolver, pools, device authentication toward the Nexus, the Nexus
allocator with its partition FSM, the peer pool, the RADIUS client with
its authenticator (degraded auth from the FSM's profile cache) and
accounting, NAT with its compliance logger, QoS, antispoof, the walled
garden (host manager, device gate and the resolver's portal answers),
the DHCP server and the engine on the card (with the PPPoE session
tables when PPPoE is on), the tiered scheduler when asked, the DHCPv6
and SLAAC servers, the PPPoE server, the slow-path demux over them, the
CoA listener, the HA pair (active or standby), the replicated store and
the cluster listener (plain or TLS), the packet ring with the AF_XDP
attach ladder (`--wire-if`: zerocopy, then copy, then the memory rung,
loudly) and its XDP redirect program, routing and BGP, Nexus,
subscribers, policies, the metrics registry and its collector, the
checkpointer (restore at start, the periodic cadence, the SIGTERM
snapshot) and the ops controller. `--shards N` puts an N-shard
`ShardedCluster` in the engine's place, its shards spread over the
visible cards (one a card on a host with N; `--device cuda:i` keeps them
on one card): every fast-path,
QoS, NAT and garden write routes to its owner shard, the cluster builds
the steered ring, and the features whose wiring is the engine's
(scheduler, PPPoE, the fleet) degrade loudly (`sharded_blockers`). The one
config the reference builds but cannot serve (an HA active under shards
with NAT on) is refused at construction; nothing degrades silently. On a
host with a second visible card the scheduler's express lane takes it
(`express_device_index`); `--device cuda:i` keeps the lane on that one
card too. The reference's defaults build, so

    python -m bng_tpu_torch run --once

Everything runs on the card unless `--device cpu` (or `device="cpu"`)
asks for the CPU; with no card and no such request the entry points
raise (`utils/devenv.resolve_device`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

from bng_tpu_torch.analysis.sanitize import ctx_enter, owned_by
from bng_tpu_torch.utils.devenv import NoCardError, resolve_device

__version__ = "0.1.0"


@dataclasses.dataclass
class BNGConfig:
    """Flattened flag surface: the reference's `BNGConfig`, the same fields
    and defaults."""

    # dataplane
    server_ip: str = "10.0.0.1"
    server_mac: str = "02:aa:bb:cc:dd:01"
    batch_size: int = 256
    shards: int = 1
    shard_nbuckets: int = 1 << 10
    scheduler_enabled: bool = False
    sched_express_batch: int = 64
    sched_express_max_wait_us: float = 200.0
    sched_express_aot: bool = True
    sched_bulk_depth: int = 2
    sched_drain_every: int = 1
    slowpath_workers: int = 1
    slowpath_worker_mode: str = "process"  # process | inline
    slowpath_inbox: int = 512  # per-worker admission inbox bound
    slowpath_deadline_ms: float = 50.0  # stale-DISCOVER shed deadline
    slowpath_slice: int = 1024  # per-worker lease-slice target size
    slowpath_autoscale: bool = False
    slowpath_min_workers: int = 1
    slowpath_max_workers: int = 8
    ctl_listen: str = ""
    # pools (single primary pool via flags; more via YAML `pools:`)
    pool_cidr: str = "10.0.0.0/16"
    pool_gateway: str = ""
    dns_primary: str = "1.1.1.1"
    dns_secondary: str = "8.8.8.8"
    lease_time: int = 3600
    lease_jitter_frac: float = 0.0
    expire_batch: int = 8192
    pools: list = dataclasses.field(default_factory=list)
    # RADIUS
    radius_server: str = ""
    radius_secret: str = ""
    radius_secret_file: str = ""
    acct_interim_interval: int = 300
    acct_spool_path: str = ""
    coa_enabled: bool = True
    coa_listen: str = "0.0.0.0:3799"
    pppoe_enabled: bool = False
    pppoe_ac_name: str = "bng-tpu"
    pppoe_service_name: str = ""
    pppoe_auth: str = "chap"  # chap | pap | none
    pppoe_users: list = dataclasses.field(default_factory=list)
    # NAT
    nat_enabled: bool = True
    nat_public_ips: list = dataclasses.field(default_factory=lambda: ["203.0.113.1"])
    nat_ports_per_subscriber: int = 1024
    nat_log_path: str = ""
    nat_log_format: str = "json"
    nat_bulk_logging: bool = False
    # QoS
    qos_enabled: bool = True
    default_policy: str = "residential-100mbps"
    # walled garden
    walled_garden_enabled: bool = True
    portal_ip: str = "10.255.255.1"
    portal_port: int = 8080
    dns_enabled: bool = False
    dns_listen: str = "0.0.0.0:53"
    dns_upstreams: list = dataclasses.field(
        default_factory=lambda: ["8.8.8.8:53", "1.1.1.1:53"])
    nexus_url: str = ""
    peer_pool_cidr: str = ""
    peer_pool_nodes: list = dataclasses.field(default_factory=list)
    device_auth_method: str = "none"
    device_auth_psk: str = ""
    device_auth_psk_file: str = ""
    device_auth_cert: str = ""
    device_auth_key: str = ""
    # HA
    ha_role: str = ""  # "", "active", "standby"
    ha_peer: str = ""  # active's cluster URL (http://host:port) for standbys
    cluster_listen: str = ""  # "host:port" ("" = no listener; port 0 = any)
    cluster_tls_cert: str = ""
    cluster_tls_key: str = ""
    cluster_tls_client_ca: str = ""
    cluster_tls_ca: str = ""
    cluster_tls_pins: list = dataclasses.field(default_factory=list)
    cluster_tls_server_name: str = ""
    cluster_tls_client_cert: str = ""
    cluster_tls_client_key: str = ""
    store_mode: str = "memory"  # memory | read | write (control/crdt.py)
    store_peers: list = dataclasses.field(default_factory=list)  # peer URLs
    # BGP
    bgp_enabled: bool = False
    bgp_local_as: int = 65000
    bgp_router_id: str = ""
    bgp_vtysh: bool = False
    bgp_vtysh_path: str = "vtysh"
    routing_platform: str = "stub"
    checkpoint_dir: str = ""
    checkpoint_interval_s: float = 0.0
    checkpoint_keep: int = 3
    telemetry_enabled: bool = False
    trace_dir: str = ""  # "" -> $BNG_TRACE_DIR or <tmp>/bng-flightrec
    trace_budget_us: float = 0.0  # latency-excursion dump trigger; 0=off
    slo_enabled: bool = True
    slo_window_s: float = 30.0  # burn-rate window length
    slo_burn_windows: int = 2  # consecutive bad windows before a breach
    slo_budgets: list = dataclasses.field(default_factory=list)
    # metrics
    metrics_port: int = 9090
    metrics_enabled: bool = True
    # dhcpv6 / slaac
    dhcpv6_enabled: bool = True
    dhcpv6_prefix: str = "2001:db8:1::/64"
    dhcpv6_server_ip: str = ""
    slaac_enabled: bool = True
    wire_if: str = ""  # NIC to bind AF_XDP on ("" = in-memory ring only)
    wire_queue: int = 0
    wire_pump: str = ""
    synthetic_subs: int = 0  # >0: generate DISCOVER/data traffic (smoke)
    # logging (main.go:1398-1418 zap production config role)
    log_level: str = "info"
    log_format: str = "json"  # json | console
    # misc
    node_id: str = "bng0"




def pppoe_sid(sess) -> str:
    """One Acct-Session-Id format for a PPPoE session, shared by
    accounting start/stop and the CoA locator."""
    return f"pppoe-{sess.session_id:04x}-{sess.client_mac.hex()}"


def resolve_secret(value: str, file_path: str) -> str:
    """main.go:1567: prefer --*-file so secrets stay out of ps."""
    if file_path:
        with open(file_path) as f:
            return f.read().strip()
    return value


def load_config_file(path: str, cli_set: set[str],
                     base: BNGConfig) -> BNGConfig:
    """YAML overlay applied only to fields NOT set on the CLI
    (main.go:1420-1457: CLI wins)."""
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    for key, value in data.items():
        key = key.replace("-", "_")
        if key in cli_set or not hasattr(base, key):
            continue
        setattr(base, key, value)
    return base


class UnservableConfigError(ValueError):
    """The config builds a dataplane that could not serve it."""


def check_servable(cfg: BNGConfig) -> None:
    if cfg.shards > 1 and cfg.ha_role == "active" and cfg.nat_enabled:
        # the reference builds this and then ACKs no REQUEST: the active's
        # lease hook reads a host NAT manager that shards do not have
        raise UnservableConfigError(
            "an HA active under sharded serving cannot serve with NAT on "
            "(use --shards 1 or --no-nat-enabled)")


class _ShardedGardenGate:
    """The garden gate's write surface over a ShardedCluster: membership
    lands on the subscriber's affinity shard, an allowed destination on
    every shard. It resolves the live cluster per call, so garden writes
    follow a blue/green swap."""

    def __init__(self, resolve):
        self._resolve = resolve

    def set_gardened(self, ip, gardened):
        self._resolve().set_gardened(ip, gardened)

    def allow_destination(self, ip, port=0, proto=0):
        self._resolve().allow_garden_destination(ip, port, proto)


@owned_by("loop", guard="_ctl")
class BNGApp:
    """Everything `run` constructs, with LIFO cleanup.

    Ownership (BNG_SANITIZE): app state belongs to the loop context; any
    other context (the ctl handler) must hold `_ctl` to mutate it."""

    # maintenance cadences (seconds) when tick() runs every second: lease
    # cleanup and NAT expiry 60 s, the garden expiry checker 30 s, the
    # accounting octet bridge 60 s, interims and spool retries 30 s
    EXPIRE_EVERY_S = 60.0
    GARDEN_EVERY_S = 30.0
    ACCT_SYNC_EVERY_S = 60.0
    ACCT_RETRY_EVERY_S = 30.0

    def __init__(self, config: BNGConfig, clock=time.time, device=None):
        check_servable(config)
        self.device = resolve_device(device)
        self.config = config
        self.clock = clock
        self._cleanup = []
        self._last_sync = 0.0
        self._last_expire = 0.0
        self._last_garden = 0.0
        self._last_acct_sync = 0.0
        self._last_acct_retry = 0.0
        # serializes the CoA listener thread's actions against the loop's
        # slow path and maintenance sweeps
        self._ctl = threading.Lock()
        self._syn_i = 0
        # sharded serving: the per-beat slow-path handler (the demux or the
        # DHCP server); the cluster takes it per call, where the engine
        # owns a reference
        self._slow_path = None
        # integrations that kept a configured fleet from being built, and
        # the engine-path features a sharded dataplane turns off
        self.fleet_blockers: list[str] = []
        self.sharded_blockers: list[str] = []
        self.components: dict[str, object] = {}
        try:
            self._build()
        except BaseException:
            self.close()
            raise

    def _on_close(self, fn) -> None:
        self._cleanup.append(fn)

    def _build(self) -> None:
        import ipaddress

        from bng_tpu_torch.control import walledgarden as wg
        from bng_tpu_torch.control.dhcp_server import DHCPServer
        from bng_tpu_torch.control.nat import NATManager
        from bng_tpu_torch.control.nat_logging import NATComplianceLogger, NATLoggerConfig
        from bng_tpu_torch.control.nexus import NexusClient
        from bng_tpu_torch.control.opsctl import OpsController
        from bng_tpu_torch.control.pool import Pool, PoolManager
        from bng_tpu_torch.control.radius.policy import PolicyManager
        from bng_tpu_torch.control.routing import IPRoute2Platform, RoutingManager, StubPlatform
        from bng_tpu_torch.control.subscriber import SubscriberManager
        from bng_tpu_torch.runtime.engine import AntispoofTables, Engine, GardenTables, QoSTables
        from bng_tpu_torch.runtime.tables import FastPathTables, PPPoEFastPathTables
        from bng_tpu_torch.utils.net import ip_to_u32, parse_mac, u32_to_ip
        from bng_tpu_torch.utils import structlog

        cfg = self.config
        c = self.components
        structlog.setup(cfg.log_level, cfg.log_format)
        self.log = structlog.get_logger("app", node_id=cfg.node_id)

        # 0. telemetry, armed first so every later step (the engine's and
        # the scheduler's spans) sees the armed tracer; metrics attach at
        # step 13
        if cfg.telemetry_enabled or os.environ.get("BNG_TELEMETRY") == "1":
            from bng_tpu_torch.telemetry import FlightRecorder, RecorderConfig
            from bng_tpu_torch.telemetry import spans as tele_spans

            recorder = FlightRecorder(RecorderConfig(latency_budget_us=cfg.trace_budget_us,
                                                     out_dir=cfg.trace_dir))
            tracer = c["telemetry"] = tele_spans.arm(tele_spans.Tracer(recorder=recorder))
            self._on_close(tele_spans.disarm)
            self.log.info("telemetry armed", trace_dir=recorder.cfg.out_dir or "(default)",
                          budget_us=cfg.trace_budget_us)
            if cfg.slo_enabled:
                # the SLO monitor rides the armed tracer: burn-rate windows
                # over the stage histograms, ticked by the 1 Hz heartbeat;
                # a breach dumps the flight ring and shows in bng_slo_*
                from bng_tpu_torch.telemetry import slo as slo_mod

                budgets = (slo_mod.parse_budgets(list(cfg.slo_budgets))
                           if cfg.slo_budgets else slo_mod.DEFAULT_SLOS)
                c["slo"] = slo_mod.SLOMonitor(tracer, slos=budgets, window_s=cfg.slo_window_s,
                                              burn_windows=cfg.slo_burn_windows)
                self.log.info("slo monitor armed", window_s=cfg.slo_window_s,
                              burn_windows=cfg.slo_burn_windows, budgets=len(budgets))

        # 1. device tables. --shards N puts an N-shard ShardedCluster in the
        # engine's place; every fast-path write routes to its owner shard
        # through the ShardedFastPathSink facade. Its shards spread over the
        # visible cards (shard i on card i mod min(cards, N); all on one card
        # for --device cuda:i or a one-card host), the lookups' rows crossing
        # cards through the copying exchange
        if cfg.shards > 1:
            fastpath = self._build_cluster()
        else:
            fastpath = c["fastpath"] = FastPathTables()
        fastpath.set_server_config(parse_mac(cfg.server_mac), ip_to_u32(cfg.server_ip))

        # 2. antispoof + walled garden
        c["antispoof"] = AntispoofTables()
        if cfg.walled_garden_enabled:
            garden = c["walledgarden"] = wg.WalledGardenManager(
                wg.WalledGardenConfig(portal_ip=cfg.portal_ip, portal_port=cfg.portal_port),
                clock=self.clock)
            self._on_close(lambda: garden.check_expired())

        # 2b. the DNS listener: a UDP socket serving the resolver; walled-
        # garden subscribers get the portal for every name, everyone else
        # forwards upstream with failover
        if cfg.dns_enabled:
            from bng_tpu_torch.control.dns import DNSConfig, Resolver
            from bng_tpu_torch.control.dns_wire import DNSServer, UDPForwarder

            dns_cfg = DNSConfig(upstreams=list(cfg.dns_upstreams),
                                walled_garden_redirect_ip=cfg.portal_ip)
            resolver = c["dns_resolver"] = Resolver(
                dns_cfg, forwarder=UDPForwarder(dns_cfg.upstreams, timeout=dns_cfg.timeout))
            host, _, port = cfg.dns_listen.partition(":")
            dns_srv = c["dns_server"] = DNSServer(resolver, host=host or "0.0.0.0",
                                                  port=int(port or 53))
            dns_srv.start()
            self._on_close(dns_srv.stop)
            self.log.info("dns listener", addr=f"{dns_srv.addr[0]}:{dns_srv.addr[1]}")

        # 3. pools
        pool_mgr = c["pools"] = PoolManager(fastpath_tables=fastpath)
        pool_specs = cfg.pools or [{
            "cidr": cfg.pool_cidr, "gateway": cfg.pool_gateway,
            "lease_time": cfg.lease_time}]
        for i, spec in enumerate(pool_specs, start=1):
            if isinstance(spec, str):  # --pools 10.1.0.0/24 (CLI shorthand)
                spec = {"cidr": spec}
            net = ipaddress.ip_network(spec["cidr"])
            gw = spec.get("gateway") or str(net.network_address + 1)
            pool_mgr.add_pool(Pool(
                pool_id=i, network=int(net.network_address),
                prefix_len=net.prefixlen, gateway=ip_to_u32(gw),
                dns_primary=ip_to_u32(spec.get("dns_primary", cfg.dns_primary)),
                dns_secondary=ip_to_u32(spec.get("dns_secondary", cfg.dns_secondary)),
                lease_time=int(spec.get("lease_time", cfg.lease_time)),
                client_class=int(spec.get("client_class", 0))))

        # 4. Nexus + subscriber orchestration
        c["nexus"] = NexusClient(node_id=cfg.node_id, clock=self.clock)
        c["subscribers"] = SubscriberManager(clock=self.clock)

        # 4a. device identity for the Nexus wire; built and kept, as the
        # reference does, for the callers that sign their requests
        if cfg.device_auth_method != "none":
            from bng_tpu_torch.control import deviceauth as da

            if cfg.device_auth_method == "psk":
                c["deviceauth"] = da.PSKAuthenticator(psk=cfg.device_auth_psk,
                                                      psk_file=cfg.device_auth_psk_file)
            elif cfg.device_auth_method == "mtls":
                c["deviceauth"] = da.MTLSAuthenticator(cert_file=cfg.device_auth_cert,
                                                       key_file=cfg.device_auth_key)
            else:
                raise ValueError(f"device_auth_method={cfg.device_auth_method!r}: "
                                 f"expected 'none', 'psk' or 'mtls'")

        # 4b. the central allocator client and partition resilience. The
        # adapter narrows HTTPAllocator's ip-string API to the DHCP
        # server's int contract, and goes straight to the local pool while
        # partitioned (one timeout per DISCOVER would melt the slow path;
        # the resilience FSM owns the retry cadence instead)
        nexus_alloc = None
        resilience = None
        if cfg.nexus_url:
            nexus_alloc, resilience = self._build_nexus()

        # 4c. the peer-to-peer shared pool: HRW owner-or-forward over the
        # cluster HTTP wire
        if cfg.peer_pool_cidr and cfg.peer_pool_nodes:
            self._build_peer_pool()

        # 5. RADIUS client and the DHCP authenticator
        authenticator = None
        radius_server_cfgs: list = []  # picklable, reused by the fleet
        if cfg.radius_server:
            from bng_tpu_torch.control.radius.client import RadiusClient, RadiusServerConfig

            secret = resolve_secret(cfg.radius_secret, cfg.radius_secret_file)
            host, _, port = cfg.radius_server.partition(":")
            radius_server_cfgs = [RadiusServerConfig(
                host=host, auth_port=int(port or 1812), secret=secret.encode())]
            radius = c["radius"] = RadiusClient(servers=radius_server_cfgs)

            def authenticator(username="", password="", mac=b"", circuit_id=b"", **kw):
                """A RADIUS Access-Request per new subscriber: the profile
                on an Accept, None on a Reject. When every server timed
                out, the resilience manager's cached profile (with the
                Nexus allocator on) keeps a paying subscriber served; a
                Reject is never served from the cache."""
                res = radius.authenticate(username, password, mac=mac, circuit_id=circuit_id)
                key = username or mac.hex()
                if res is None:
                    if resilience is not None:
                        cached = resilience.radius_handler.degraded_auth(key, self.clock())
                        if cached is not None:
                            return {"qos_policy": cached.policy_name,
                                    "framed_ip": cached.framed_ip}
                    return None
                if not res.success:
                    return None
                if resilience is not None:
                    from bng_tpu_torch.control.resilience import CachedProfile

                    resilience.radius_handler.cache_profile(CachedProfile(
                        username=key, policy_name=res.policy_name, framed_ip=res.framed_ip,
                        cached_at=self.clock()))
                # the keys DHCPServer._request consumes: qos_policy (Filter-Id)
                # and lease_time (Session-Timeout caps the lease)
                profile = {"qos_policy": res.policy_name, "framed_ip": res.framed_ip,
                           **res.attributes}
                if res.session_timeout:
                    profile["lease_time"] = res.session_timeout
                return profile

        # 6. QoS: sharded, the policy row lands on the subscriber's affinity
        # shard (the only shard the ring steers its traffic to)
        qos = None if cfg.shards > 1 else QoSTables()
        if qos is not None:
            c["qos"] = qos
        policies = c["policies"] = PolicyManager()
        qos_hook = None
        if cfg.qos_enabled:
            if cfg.shards > 1:
                def qos_hook(ip, policy_name):
                    p = policies.get(policy_name or cfg.default_policy)
                    if p is not None:
                        c["cluster"].set_qos(ip, down_bps=p.download_bps, up_bps=p.upload_bps,
                                             priority=p.priority)
            else:
                def qos_hook(ip, policy_name):
                    p = policies.get(policy_name or cfg.default_policy)
                    if p is not None:
                        qos.set_subscriber(ip, p.download_bps, p.upload_bps,
                                           priority=p.priority)

        # 7. NAT + compliance logger. Sharded, NAT state lives per shard in
        # the cluster and the hook routes an allocation to its owner; the
        # per-event compliance logger is the engine's wiring and is off
        nat = None
        nat_hook = None
        if cfg.shards > 1:
            if cfg.nat_enabled:
                def nat_hook(ip, now):
                    c["cluster"].allocate_nat(ip, int(now))
        elif cfg.nat_enabled:
            nat_logger = c["nat_logger"] = NATComplianceLogger(
                NATLoggerConfig(file_path=cfg.nat_log_path, fmt=cfg.nat_log_format,
                                bulk_logging=cfg.nat_bulk_logging),
                clock=self.clock)
            self._on_close(nat_logger.close)
            nat = c["nat"] = NATManager(
                public_ips=[ip_to_u32(ip) for ip in cfg.nat_public_ips],
                ports_per_subscriber=cfg.nat_ports_per_subscriber,
                log_sink=nat_logger.log_device_event)

            def nat_hook(ip, now):
                nat.allocate_nat(ip, int(now))
        else:
            nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")],
                             sessions_nbuckets=256, sub_nat_nbuckets=64)

        # 7b. RADIUS accounting: start/stop ride the DHCP lease lifecycle,
        # interims and retries fire from tick(); its hook goes in before the
        # garden's, whose chain keeps it
        acct = None
        if "radius" in c:
            from bng_tpu_torch.control.radius.accounting import AccountingManager

            acct = c["accounting"] = AccountingManager(
                c["radius"], interim_interval_s=cfg.acct_interim_interval,
                spool_path=cfg.acct_spool_path or None, clock=self.clock)

        # 8. DHCP server
        dhcp = c["dhcp"] = DHCPServer(
            server_mac=parse_mac(cfg.server_mac), server_ip=ip_to_u32(cfg.server_ip),
            pool_manager=pool_mgr, fastpath_tables=fastpath, allocator=nexus_alloc,
            authenticator=authenticator, qos_hook=qos_hook, nat_hook=nat_hook, clock=self.clock,
            lease_jitter_frac=cfg.lease_jitter_frac)
        if resilience is not None:
            self._wire_resilience(resilience, dhcp)
        if acct is not None:
            prev_acct_hook = dhcp.accounting_hook

            def _acct_lease(event, lease, sid, _acct=acct):
                if prev_acct_hook is not None:
                    prev_acct_hook(event, lease, sid)
                if event == "start":
                    _acct.start(sid, username=lease.username or u32_to_ip(lease.ip),
                                framed_ip=lease.ip, mac="-".join(f"{b:02X}" for b in lease.mac))
                elif event == "stop":
                    _acct.stop(sid)  # a renew extends, it never stops

            dhcp.accounting_hook = _acct_lease

        # 9. the engine on the device; the garden gate and the PPPoE stage
        # compile in only when the walled garden and PPPoE are enabled.
        # Sharded, the cluster is the dataplane: drive_once feeds its
        # steered ring loop, and the slow path is attached per beat (10b)
        pppoe_tables = None
        if cfg.pppoe_enabled and cfg.shards <= 1:
            pppoe_tables = c["pppoe_tables"] = PPPoEFastPathTables(
                server_mac=parse_mac(cfg.server_mac))
        if cfg.shards > 1:
            self._slow_path = dhcp.handle_frame
        else:
            c["engine"] = Engine(
                fastpath=fastpath, nat=nat, qos=qos, antispoof=c["antispoof"],
                garden=GardenTables() if cfg.walled_garden_enabled else None,
                pppoe=pppoe_tables, batch_size=cfg.batch_size, slow_path=dhcp.handle_frame,
                clock=self.clock, device=self.device)
            self.log.info("engine built", batch_size=cfg.batch_size, device=str(self.device),
                          nat=cfg.nat_enabled, qos=cfg.qos_enabled)
        if "telemetry" in c:
            # flight records name the backend that served them: a CPU run
            # must never read as a card's
            c["telemetry"].recorder.set_backend("gpu" if self.device.type == "cuda" else "cpu")

        # 9a. the tiered scheduler over the engine's programs
        if cfg.scheduler_enabled and cfg.shards <= 1:
            from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler

            c["scheduler"] = TieredScheduler(c["engine"], SchedulerConfig(
                express_batch=cfg.sched_express_batch,
                express_max_wait_us=cfg.sched_express_max_wait_us,
                express_aot=cfg.sched_express_aot,
                bulk_batch=cfg.batch_size,
                bulk_depth=cfg.sched_bulk_depth,
                drain_every=cfg.sched_drain_every,
                express_device_index=_express_index(self.device, bool(cfg.wire_if))),
                clock=self.clock)
            self.log.info("scheduler built", express_batch=cfg.sched_express_batch,
                          express_aot=cfg.sched_express_aot, bulk_depth=cfg.sched_bulk_depth)

        # 9b. walled-garden enforcement: one MAC-state feed drives the
        # device gate. Only explicit garden membership drops on the device
        # (UNKNOWN stays unenforced); the state maps to the lease IP at
        # each garden transition and each lease event.
        if cfg.walled_garden_enabled:
            from bng_tpu_torch.control.walledgarden import SubscriberState

            garden = c["walledgarden"]
            # sharded: membership lands on the subscriber's affinity shard,
            # allowed destinations on every shard; the gate resolves the
            # live cluster per call, so garden writes follow a swap
            gt = (_ShardedGardenGate(lambda: c["cluster"]) if cfg.shards > 1
                  else c["engine"].garden)
            gt.allow_destination(ip_to_u32(cfg.portal_ip), 0, 6)
            dns_ips = {cfg.dns_primary, cfg.dns_secondary, *garden.config.allowed_dns}
            for spec in pool_specs:
                if isinstance(spec, dict):
                    dns_ips |= {spec.get("dns_primary", ""), spec.get("dns_secondary", "")}
            for d in sorted(d for d in dns_ips if d):
                gt.allow_destination(ip_to_u32(d), 53, 0)

            resolver = c.get("dns_resolver")

            def _apply_garden_ip(state, ip_u32, _resolver=resolver, _gt=gt):
                # the device gate drops only explicit garden membership
                # (UNKNOWN stays unenforced); the resolver keeps the
                # manager's stricter contract, every non-PROVISIONED state
                # gardened, as portal answers are harmless where a drop is not
                _gt.set_gardened(ip_u32, state in (
                    SubscriberState.WALLED_GARDEN, SubscriberState.BLOCKED))
                if _resolver is not None:
                    ip = u32_to_ip(ip_u32)
                    if state == SubscriberState.PROVISIONED:
                        _resolver.remove_walled_garden_client(ip)
                    else:
                        _resolver.add_walled_garden_client(ip)

            def _garden_sync(mac_u64, state, _dhcp=dhcp):
                lease = _dhcp.leases.get(mac_u64)
                if lease is not None:
                    _apply_garden_ip(state, lease.ip)

            garden.on_state_change(_garden_sync)
            prev_acct = dhcp.accounting_hook

            def _lease_sync(event, lease, sid, _garden=garden, _resolver=resolver, _gt=gt):
                if prev_acct is not None:
                    prev_acct(event, lease, sid)
                if event in ("start", "renew"):
                    _apply_garden_ip(_garden.get_subscriber_state(lease.mac), lease.ip)
                elif event == "stop":
                    _gt.set_gardened(lease.ip, False)
                    if _resolver is not None:
                        _resolver.remove_walled_garden_client(u32_to_ip(lease.ip))

            dhcp.accounting_hook = _lease_sync

        # 10. DHCPv6 + SLAAC
        if cfg.dhcpv6_enabled:
            from bng_tpu_torch.control.dhcpv6.server import (AddressPool6, DHCPv6Server,
                                                             DHCPv6ServerConfig)

            server_ip6 = b""
            if cfg.dhcpv6_server_ip:
                server_ip6 = ipaddress.IPv6Address(cfg.dhcpv6_server_ip).packed
            c["dhcpv6"] = DHCPv6Server(
                DHCPv6ServerConfig(server_mac=parse_mac(cfg.server_mac), server_ip6=server_ip6),
                address_pool=AddressPool6(cfg.dhcpv6_prefix, cfg.lease_time, cfg.lease_time * 2),
                clock=self.clock)
        if cfg.slaac_enabled:
            from bng_tpu_torch.control.slaac import SLAACConfig, SLAACServer

            c["slaac"] = SLAACServer(SLAACConfig())

        # 10c. the PPPoE server: negotiation on the host through the PASS
        # lanes; an OPEN session is published to the device session tables,
        # so its DATA frames decap and encap in the fused step
        if cfg.pppoe_enabled:
            self._build_pppoe(pool_mgr, pppoe_tables, qos_hook, nat, acct)

        # 10b. the slow-path demux: every PASSed frame lands on the one slow
        # queue, so the engine's slow path dispatches over the enabled servers
        if cfg.dhcpv6_enabled or cfg.slaac_enabled or cfg.pppoe_enabled:
            from bng_tpu_torch.control.slowpath import SlowPathDemux

            demux = c["slowpath"] = SlowPathDemux(
                dhcp=dhcp, dhcpv6=c.get("dhcpv6"), slaac=c.get("slaac"),
                pppoe=c.get("pppoe"), clock=self.clock)
            if cfg.shards > 1:
                self._slow_path = demux
            else:
                c["engine"].slow_path = demux

        # 10b2. the slow-path fleet: DHCPv4 sharded over N shared-nothing
        # workers (control/fleet.py) that own per-worker lease slices
        # carved from the parent pools and relay their table writes back
        # through the single-writer drain; non-DHCPv4 slow frames (v6,
        # SLAAC) stay on the parent demux through the fallback. PPPoE
        # lives on the parent's per-lease state and the sharded dataplane
        # has no engine to hand batches to, so neither is fleet-aware: with
        # either on, the fleet is skipped, counted and said (stats,
        # metrics, the startup banner), never silently
        if cfg.slowpath_workers > 1:
            blockers = [name for flag, name in ((cfg.pppoe_enabled, "pppoe"),
                                                (cfg.shards > 1, "sharded")) if flag]
            if blockers:
                self.fleet_blockers = blockers
                self.log.warning("slowpath fleet disabled: per-lease integrations "
                                 "not yet fleet-aware", blockers=self.fleet_blockers,
                                 workers=cfg.slowpath_workers)
            else:
                self._build_fleet(pool_mgr, dhcp, qos_hook, nat_hook, acct,
                                  radius_server_cfgs)

        # 10d. the CoA/Disconnect listener (RFC 5176), over the DHCP leases
        # and the PPPoE sessions
        if cfg.radius_server and cfg.coa_enabled:
            self._build_coa(qos_hook)

        # 11. the HA pair: the active feeds its syncer from the lease and
        # PPPoE session lifecycles; the standby syncs from the active's
        # cluster listener over HTTP (a full sync, then the SSE deltas)
        if cfg.ha_role:
            self._build_ha(dhcp, nat)

        # 11b. the replicated store and the cluster listener
        if cfg.store_mode != "memory" or cfg.store_peers:
            from bng_tpu_torch.control.cluster_http import HTTPStorePeer
            from bng_tpu_torch.control.crdt import DistributedStore

            cstore = c["cluster_store"] = DistributedStore(cfg.node_id, mode=cfg.store_mode,
                                                           clock=self.clock)
            for url in cfg.store_peers:
                cstore.add_peer(HTTPStorePeer(
                    url, tls=self._cluster_client_tls() if url.startswith("https") else None))
        if cfg.cluster_listen:
            self._build_cluster_listener()

        # 11c. the wire: packet ring + AF_XDP attach ladder (the XDP-attach
        # role, loader.go:294-315). The ring is built when a wire or the
        # synthetic source is asked for; the attach mode is whatever rung
        # the host supports (zerocopy -> copy -> in-memory). Sharded, the
        # cluster builds the ring, so its steering tables (public-IP
        # ownership, the owner-shard hash) are registered and shard i's
        # batch region holds shard i's subscribers; AF_XDP attach is an
        # engine-path feature (sharded_blockers).
        if cfg.shards > 1 and (cfg.wire_if or cfg.synthetic_subs):
            ring = c["ring"] = c["cluster"].make_ring(frame_size=2048)
            self._on_close(ring.close)
            self._on_close(lambda: c["cluster"].flush_pipeline(self._slow_path))
        elif cfg.wire_if or cfg.synthetic_subs:
            self._build_wire(cfg, c)

        # 12. routing
        if cfg.routing_platform == "linux":
            c["routing"] = RoutingManager(platform=IPRoute2Platform())
            self.log.info("routing platform", kind="linux-iproute2")
        elif cfg.routing_platform == "stub":
            c["routing"] = RoutingManager(platform=StubPlatform())
        else:  # a typo must not silently disable multi-ISP routing
            raise ValueError(f"routing_platform={cfg.routing_platform!r}: "
                             f"expected 'stub' or 'linux'")
        if cfg.bgp_enabled:
            from bng_tpu_torch.control.routing import BGPConfig, BGPController, vtysh_executor

            if cfg.bgp_vtysh:
                executor = vtysh_executor(cfg.bgp_vtysh_path)
                self.log.info("bgp executor", kind="vtysh", binary=cfg.bgp_vtysh_path)
            else:
                executor = lambda cmd: ""  # noqa: E731 — inert by default
            c["bgp"] = BGPController(BGPConfig(local_as=cfg.bgp_local_as,
                                               router_id=cfg.bgp_router_id),
                                     executor=executor)

        # 13. metrics (main.go:1214-1241)
        if cfg.metrics_enabled:
            self._build_metrics(pool_mgr, dhcp)

        # 14. checkpoint and warm restart
        if cfg.checkpoint_dir:
            self._build_checkpointer(dhcp)

        # 15. zero-downtime ops: the transition queue the run loop drains
        # and, when asked, the watermark autoscaler driving live fleet
        # elasticity from tick
        c["ops"] = OpsController(self)
        if cfg.slowpath_autoscale and "fleet" in c:
            from bng_tpu_torch.control.opsctl import AutoscaleConfig, FleetAutoscaler

            c["autoscaler"] = FleetAutoscaler(
                c["fleet"], AutoscaleConfig(min_workers=max(1, cfg.slowpath_min_workers),
                                            max_workers=max(1, cfg.slowpath_max_workers)),
                clock=self.clock)
            self.log.info("fleet autoscaler armed", min=cfg.slowpath_min_workers,
                          max=cfg.slowpath_max_workers)

    def _build_nexus(self):
        """Step 4b: the HTTPAllocator over the Nexus wire (TLS when the URL
        is https), its partition FSM, and the DHCP server's adapter."""
        from bng_tpu_torch.control.cluster_http import http_nexus_transport
        from bng_tpu_torch.control.nexus import HTTPAllocator
        from bng_tpu_torch.control.resilience import ResilienceManager
        from bng_tpu_torch.utils.net import ip_to_u32

        cfg, c = self.config, self.components
        nexus_tls = self._cluster_client_tls() if cfg.nexus_url.startswith("https") else None
        nexus_http = c["nexus_allocator"] = HTTPAllocator(
            cfg.nexus_url, http_nexus_transport(cfg.nexus_url, tls=nexus_tls),
            node_id=cfg.node_id)
        resilience = c["resilience"] = ResilienceManager(nexus_healthy=nexus_http.health_check)

        class _NexusAlloc:
            def allocate(self, owner):
                if resilience.partitioned:
                    return None  # local-pool fallback, no timeout
                try:
                    ip = nexus_http.allocate(owner)
                except Exception:
                    return None
                return ip_to_u32(ip) if ip else None

            def release(self, owner):
                if resilience.partitioned:
                    return  # no timeout per expired lease during an
                    # outage: heal-time reconciliation covers it
                try:
                    nexus_http.release(owner)
                except Exception:
                    pass

        return _NexusAlloc(), resilience

    def _wire_resilience(self, resilience, dhcp) -> None:
        """Heal-time reconciliation: the central store answers who owns
        each partition-allocated IP, and the loser of a conflict is
        force-renumbered (its lease expires, the sweep deletes its
        fast-path row, and the client re-DORAs onto a fresh address).
        Partition-time allocations feed the conflict detector."""
        from bng_tpu_torch.utils.net import mac_to_u64, u32_to_ip

        nexus_http = self.components["nexus_allocator"]

        def _central_lookup(ip_u32):
            try:
                return nexus_http.lookup_by_ip(u32_to_ip(ip_u32))
            except Exception:
                return None  # unreachable mid-heal: no verdict

        def _renumber(subscriber_id):
            try:
                mac = bytes.fromhex(subscriber_id)
            except ValueError:
                return False
            lease = dhcp.leases.get(mac_to_u64(mac))
            if lease is None:
                return False
            lease.expiry = 0
            dhcp.cleanup_expired(1)  # reaps only the forced lease
            return True

        resilience.central_lookup = _central_lookup
        resilience.renumber = _renumber
        prev_res_acct = dhcp.accounting_hook

        def _res_lease(event, lease, sid):
            if prev_res_acct is not None:
                prev_res_acct(event, lease, sid)
            if event == "start":
                resilience.record_allocation(lease.mac.hex(), lease.ip, self.clock())

        dhcp.accounting_hook = _res_lease

    def _build_cluster(self):
        """The N-shard cluster in the engine's place, its shards placed over
        the app's cards (`parallel/sharded.place_shards`), and the fast-path
        facade that routes each row to its owner shard.
        The engine-path features that do not follow (scheduler, PPPoE, the
        fleet) are turned off, logged and listed in `sharded_blockers`."""
        from bng_tpu_torch.parallel.sharded import ShardedCluster, ShardedFastPathSink
        from bng_tpu_torch.utils.net import ip_to_u32, parse_mac

        cfg, c = self.config, self.components
        self.sharded_blockers = [name for flag, name in (
            (cfg.scheduler_enabled, "scheduler"),
            (cfg.pppoe_enabled, "pppoe"),
            (cfg.wire_if, "wire"),
            (cfg.slowpath_workers > 1, "slowpath-fleet")) if flag]
        if self.sharded_blockers:
            self.log.warning("sharded serving: engine-specific features disabled",
                             blockers=self.sharded_blockers, shards=cfg.shards)
        pub_ips = [ip_to_u32(ip) for ip in cfg.nat_public_ips]
        while len(pub_ips) < cfg.shards:
            # each shard must own its public IPs exclusively (downstream
            # ring steering is by IP): extend the configured block
            pub_ips.append((pub_ips[-1] + 1) if pub_ips
                           else ip_to_u32("203.0.113.1") + len(pub_ips))
        cluster = c["cluster"] = ShardedCluster(
            cfg.shards,
            batch_per_shard=max(8, cfg.batch_size // cfg.shards),
            sub_nbuckets=cfg.shard_nbuckets,
            vlan_nbuckets=max(64, cfg.shard_nbuckets // 4),
            cid_nbuckets=max(64, cfg.shard_nbuckets // 4),
            nat_sessions_nbuckets=cfg.shard_nbuckets,
            qos_nbuckets=cfg.shard_nbuckets,
            spoof_nbuckets=cfg.shard_nbuckets,
            public_ips=pub_ips,
            garden_enabled=cfg.walled_garden_enabled,
            server_mac=parse_mac(cfg.server_mac),
            device=self.device)
        self.log.info("sharded cluster built", shards=cfg.shards, batch_per_shard=cluster.b,
                      nbuckets=cfg.shard_nbuckets, device=str(self.device),
                      shard_devices=[str(d) for d in cluster.shard_devices])
        # a resolver, not the object: a blue/green swap replaces
        # c["cluster"], and every later DHCP and pool write must follow it
        sink = c["fastpath_sink"] = ShardedFastPathSink(lambda: c["cluster"])
        return sink

    def _build_peer_pool(self) -> None:
        """The peer pool over this node's member list, one HTTP proxy per
        peer (built once: each would otherwise re-read its TLS files per
        forwarded request)."""
        import ipaddress

        from bng_tpu_torch.control.cluster_http import HTTPPeerProxy
        from bng_tpu_torch.control.peerpool import PeerPool, PoolRange

        cfg, c = self.config, self.components
        net = ipaddress.ip_network(cfg.peer_pool_cidr)
        node_urls = {str(n["node"]): str(n["url"]) for n in cfg.peer_pool_nodes}
        if cfg.node_id not in node_urls:
            raise ValueError(f"peer_pool_nodes must include this node ({cfg.node_id!r}): "
                             f"peers agree on one member list")
        peer_proxies: dict[str, object] = {}

        def _peer_transport(node, _urls=node_urls):
            proxy = peer_proxies.get(node)
            if proxy is None:
                url = _urls.get(node)
                if url is None:
                    raise ConnectionError(f"unknown peer {node}")
                proxy = peer_proxies[node] = HTTPPeerProxy(
                    url, tls=self._cluster_client_tls() if url.startswith("https") else None)
            return proxy

        # PeerPool allocates network+1+idx (it skips the network address
        # itself): pass the raw base, usable = hosts only
        c["peerpool"] = PeerPool(
            cfg.node_id, sorted(node_urls),
            PoolRange(network=int(net.network_address), size=max(net.num_addresses - 2, 1)),
            transport=_peer_transport)
        self.log.info("peer pool", nodes=sorted(node_urls), cidr=cfg.peer_pool_cidr)

    def _build_ha(self, dhcp, nat) -> None:
        """The HA pair. The active's syncer is fed from both session
        lifecycles (DHCP leases, renewals re-pushed so the standby's expiry
        tracks them; PPPoE sessions), with each subscriber's NAT block. The
        standby syncs over `HTTPActiveProxy` from the active's listener."""
        from bng_tpu_torch.control.ha import (ActiveSyncer, InMemorySessionStore, Role,
                                              SessionState, StandbySyncer)

        cfg, c = self.config, self.components
        store = c["ha_store"] = InMemorySessionStore()
        if cfg.ha_role != "active":
            if cfg.ha_peer.startswith("http"):
                from bng_tpu_torch.control.cluster_http import HTTPActiveProxy

                def _peer():
                    return HTTPActiveProxy(cfg.ha_peer, on_stream_end=lambda: c["ha"].disconnect(),
                                           tls=self._cluster_client_tls())
            else:
                def _peer():
                    raise ConnectionError(f"HA peer unreachable: {cfg.ha_peer}")
            c["ha"] = StandbySyncer(store, transport=_peer)
            self.log.info("ha role standby", peer=cfg.ha_peer)
            c["ha_role"] = Role.STANDBY
            return

        ha_sync = c["ha"] = ActiveSyncer(store)
        self.log.info("ha role active")
        c["ha_role"] = Role.ACTIVE

        def _nat_fields(ip):
            # the reference's expression; with no host NAT manager (shards)
            # and NAT on it would raise, so `check_servable` refuses that config
            blk = nat.blocks.get(ip) if cfg.nat_enabled else None
            if blk is None:
                return {}
            return {"nat_public_ip": blk["public_ip"], "nat_port_start": blk["port_start"],
                    "nat_port_end": blk["port_end"]}

        prev_ha_hook = dhcp.accounting_hook

        def _ha_lease(event, lease, sid, _ha=ha_sync):
            if prev_ha_hook is not None:
                prev_ha_hook(event, lease, sid)
            if event in ("start", "renew"):
                _ha.push_change(SessionState(
                    session_id=sid, mac=lease.mac.hex(), ip=lease.ip, pool_id=lease.pool_id,
                    circuit_id=lease.circuit_id.hex(), username=lease.username,
                    lease_expiry=float(lease.expiry), s_tag=lease.s_tag, c_tag=lease.c_tag,
                    qos_policy=lease.qos_policy, session_kind="ipoe",
                    updated_at=self.clock(), **_nat_fields(lease.ip)))
            elif event == "stop":
                _ha.push_change(None, session_id=sid)

        dhcp.accounting_hook = _ha_lease
        pppoe_srv = c.get("pppoe")
        if pppoe_srv is not None:
            prev_po, prev_pc = pppoe_srv.on_open, pppoe_srv.on_close

            def _ha_pppoe_open(sess, _ha=ha_sync):
                if prev_po is not None:
                    prev_po(sess)
                _ha.push_change(SessionState(
                    session_id=pppoe_sid(sess), mac=sess.client_mac.hex(),
                    ip=sess.assigned_ip, username=sess.username, session_kind="pppoe",
                    updated_at=self.clock(), **_nat_fields(sess.assigned_ip)))

            def _ha_pppoe_close(event, _ha=ha_sync):
                if prev_pc is not None:
                    prev_pc(event)
                _ha.push_change(None, session_id=pppoe_sid(event.session))

            pppoe_srv.on_open = _ha_pppoe_open
            pppoe_srv.on_close = _ha_pppoe_close

    def _build_cluster_listener(self) -> None:
        """The cluster HTTP listener (TLS when a certificate is given, mTLS
        with a client CA), with the active's HA endpoints, the replicated
        store and the peer pool mounted."""
        from bng_tpu_torch.control.cluster_http import ClusterServer

        cfg, c = self.config, self.components
        server_tls = None
        if cfg.cluster_tls_cert or cfg.cluster_tls_key:
            from bng_tpu_torch.control.ztp_tls import ServerTLSConfig

            server_tls = ServerTLSConfig(cert_file=cfg.cluster_tls_cert,
                                         key_file=cfg.cluster_tls_key,
                                         client_ca_file=cfg.cluster_tls_client_ca)
        host, _, port = cfg.cluster_listen.rpartition(":")
        srv = ClusterServer(host or "127.0.0.1", int(port or 0), tls=server_tls)
        if cfg.ha_role == "active":
            srv.mount_ha(c["ha"])
        if "cluster_store" in c:
            srv.mount_store(c["cluster_store"])
        if "peerpool" in c:
            srv.mount_pool(c["peerpool"])
        c["cluster_server"] = srv.start()
        self.log.info("cluster listener up", url=srv.url, ha=bool(srv.ha),
                      store=srv.store is not None)
        self._on_close(srv.close)

    def _cluster_client_tls(self):
        """The client side's TLSConfig for https cluster peers, or None when
        no TLS material is configured (plain peers keep working)."""
        cfg = self.config
        if not (cfg.cluster_tls_ca or cfg.cluster_tls_pins or cfg.cluster_tls_client_cert):
            return None
        from bng_tpu_torch.control.ztp_tls import TLSConfig

        return TLSConfig(
            ca_cert_file=cfg.cluster_tls_ca,
            pinned_certs=list(cfg.cluster_tls_pins),
            server_name=cfg.cluster_tls_server_name,
            # pins without a CA: self-signed cluster certificates, the
            # pins carry the trust; with no pins the chain check stays on
            # (a CA file or the system roots) or nobody is authenticated
            require_valid_chain=not cfg.cluster_tls_pins or bool(cfg.cluster_tls_ca),
            client_cert_file=cfg.cluster_tls_client_cert,
            client_key_file=cfg.cluster_tls_client_key)

    def _build_fleet(self, pool_mgr, dhcp, qos_hook, nat_hook, acct,
                     radius_server_cfgs) -> None:
        """The fleet over the parent pools: worker lease events replay
        into accounting start/stop here, the single writer (octets stay
        device-authoritative: the tick bridge folds NAT counters by
        framed IP, disjoint per shard)."""
        from bng_tpu_torch.control.admission import AdmissionConfig
        from bng_tpu_torch.control.fleet import FleetSpec, SlowPathFleet
        from bng_tpu_torch.control.ha import SessionState as _HAState
        from bng_tpu_torch.utils.net import ip_to_u32, parse_mac, u32_to_ip

        cfg, c = self.config, self.components

        def _fleet_lease(event, lease, sid, _acct=acct):
            # late-bound: HA (step 11) builds after the fleet, so the hook
            # reads c["ha"] at event time; this is the fleet-side twin of
            # the parent's accounting and HA lease hooks
            if _acct is not None:
                if event == "start":
                    _acct.start(sid, username=lease.get("username") or u32_to_ip(lease["ip"]),
                                framed_ip=lease["ip"],
                                mac="-".join(f"{b:02X}" for b in bytes.fromhex(lease["mac"])))
                elif event == "stop":
                    _acct.stop(sid)
            ha_sync = c.get("ha")
            if ha_sync is None or not hasattr(ha_sync, "push_change"):
                return
            if event == "stop":
                ha_sync.push_change(None, session_id=sid)
            else:  # start and renew both re-push (the expiry tracks)
                ha_sync.push_change(_HAState(
                    session_id=sid, mac=lease["mac"], ip=lease["ip"], pool_id=lease["pool_id"],
                    username=lease.get("username") or "", lease_expiry=float(lease["expiry"]),
                    qos_policy=lease.get("qos_policy") or "", session_kind="ipoe",
                    updated_at=self.clock()))

        fspec = FleetSpec.from_pool_manager(
            parse_mac(cfg.server_mac), ip_to_u32(cfg.server_ip), pool_mgr,
            slice_size=cfg.slowpath_slice, low_watermark=max(1, cfg.slowpath_slice // 4))
        if radius_server_cfgs:
            # per-worker RADIUS sockets on the MAC steering hash: auth
            # affinity = DHCP affinity
            fspec.radius_servers = list(radius_server_cfgs)
            fspec.radius_nas_id = cfg.node_id or "bng-tpu"
            fspec.radius_nas_ip = ip_to_u32(cfg.server_ip)
        if cfg.nexus_url:
            # per-worker Nexus allocators: lease authority through the
            # shared store, one client and partition FSM per shard
            fspec.nexus_url = cfg.nexus_url
            fspec.nexus_node_id = cfg.node_id or "bng-tpu"
            if cfg.nexus_url.startswith("https"):
                fspec.nexus_tls = self._cluster_client_tls()
        fleet = c["fleet"] = SlowPathFleet(
            fspec, n_workers=cfg.slowpath_workers, pools=pool_mgr,
            mode=cfg.slowpath_worker_mode,
            admission=AdmissionConfig(inbox_capacity=cfg.slowpath_inbox,
                                      deadline_ms=cfg.slowpath_deadline_ms),
            table_sink=c["fastpath"], qos_hook=qos_hook, nat_hook=nat_hook,
            lease_hook=_fleet_lease, fallback=c.get("slowpath") or dhcp.handle_frame,
            clock=self.clock)
        c["engine"].slow_path_batch = fleet.handle_batch
        self._on_close(fleet.close)
        self.log.info("slowpath fleet up", workers=cfg.slowpath_workers,
                      mode=cfg.slowpath_worker_mode, inbox=cfg.slowpath_inbox)

    def _build_wire(self, cfg, c) -> None:
        """Step 11c on the engine path: the ring, the attach ladder, the
        XDP redirect program, and their LIFO close."""
        from bng_tpu_torch.runtime import xsk as xsk_mod
        from bng_tpu_torch.runtime.ring import make_ring

        # the tiered scheduler consumes frames through rx_pop (two lanes
        # retire out of dispatch order), so it prefers the Python ring. A
        # real wire attach needs the native UMEM, which wins: a PyRing
        # would silently downgrade the NIC to the memory rung, so with
        # wire_if set the ring stays native and drive_once takes the
        # pipelined engine loop (warned there)
        if cfg.wire_if and "scheduler" in c:
            self.log.warning("scheduler enabled with a wire interface: native ring "
                             "required for AF_XDP, scheduler will be bypassed in "
                             "the drive loop")
        ring = c["ring"] = make_ring(frame_size=2048,
                                     prefer_native=bool(cfg.wire_if) or "scheduler" not in c)
        att = xsk_mod.open_wire(ring, ifname=cfg.wire_if, queue=cfg.wire_queue,
                                pump_path=cfg.wire_pump or None)
        c["wire_attachment"] = att
        self.log.info("wire attach", mode=att.mode, interface=cfg.wire_if or "(none)",
                      detail=att.detail)
        if cfg.wire_if and att.mode == xsk_mod.MODE_MEMORY:
            # a requested NIC landed on the memory rung: the ring keeps
            # serving, so every counter looks healthy while no packet
            # touches the wire — dump the flight ring and say it loudly;
            # the bng_wire_rung gauge pins it for dashboards
            from bng_tpu_torch.telemetry import recorder as rec_mod
            from bng_tpu_torch.telemetry import spans as tele_sp

            self.log.warning("wire attach FELL BACK to the memory rung — this is "
                             "NOT wire serving", interface=cfg.wire_if, detail=att.detail)
            tele_sp.trigger(rec_mod.TRIG_WIRE_FALLBACK,
                            f"requested {cfg.wire_if!r} landed on the "
                            f"memory rung: {att.detail}")
        if att.xsk is not None:
            # an AF_XDP socket only receives through an xskmap redirect
            # program, loaded through the kernel verifier; TX works
            # without it, so a missing CAP_BPF degrades (logged)
            from bng_tpu_torch.runtime import xdp_redirect

            try:
                c["xdp_redirect"] = xdp_redirect.XdpRedirect(
                    cfg.wire_if, {cfg.wire_queue: att.xsk.fd})
                self.log.info("xdp redirect loaded", interface=cfg.wire_if,
                              queue=cfg.wire_queue)
            except OSError as e:
                self.log.warning("xdp redirect unavailable (RX via kernel needs CAP_BPF)",
                                 error=str(e))
        # LIFO close: flush the pipelined batch (needs the ring), then
        # detach the socket and the redirect, then free the ring and UMEM
        self._on_close(ring.close)
        if att.xsk is not None:
            self._on_close(att.xsk.close)
        if "xdp_redirect" in c:
            self._on_close(c["xdp_redirect"].close)
        self._on_close(lambda: c["engine"].flush_pipeline())

    def _build_metrics(self, pool_mgr, dhcp) -> None:
        """The registry, the collector and its sources. Each source reads
        host state only (EngineStats numpy, scheduler counters, host
        mirrors), never a device tensor, so a scrape never synchronizes
        the serving stream; the engine's reads c["engine"] at scrape time,
        so a blue/green swap's flip is followed."""
        from bng_tpu_torch.control.metrics import BNGMetrics, MetricsCollector

        cfg, c = self.config, self.components
        metrics = c["metrics"] = BNGMetrics()
        collector = c["collector"] = MetricsCollector(metrics)
        if cfg.shards > 1:
            collector.add_source(lambda: metrics.collect_sharded(c["cluster"]))
        else:
            collector.add_source(lambda: metrics.collect_engine(c["engine"].stats))
        collector.add_source(lambda: metrics.collect_dhcp_server(dhcp.stats))
        if self.fleet_blockers:
            metrics.record_fleet_blocked(self.fleet_blockers)
        if cfg.walled_garden_enabled and cfg.shards <= 1:
            collector.add_source(lambda: metrics.collect_garden(c["engine"].stats))
        if "scheduler" in c:
            sched = c["scheduler"]
            # the histograms are fed live at dispatch and retire; the
            # gauges come from the scrape like every other source
            sched.metrics = metrics
            collector.add_source(lambda: metrics.collect_scheduler(sched))
        if "fleet" in c:
            fleet_c = c["fleet"]
            collector.add_source(lambda: metrics.collect_fleet(fleet_c))
        if "wire_attachment" in c:
            # rung identity and pump accounting; reads c[...] at scrape
            # time so a re-attach follows the flip
            collector.add_source(lambda: metrics.collect_wire(c.get("wire_attachment")))
        if "telemetry" in c:
            tracer = c["telemetry"]
            # bng_stage_latency_us renders live from the tracer's
            # histograms at scrape; the counters ride the collector loop
            metrics.attach_telemetry(tracer)
            collector.add_source(lambda: metrics.collect_telemetry(tracer))
        if "slo" in c:
            slo_mon = c["slo"]
            collector.add_source(lambda: metrics.collect_slo(slo_mon))
        if cfg.dns_enabled:
            dns_srv, resolver = c["dns_server"], c["dns_resolver"]
            collector.add_source(lambda: metrics.collect_dns(dns_srv.stats, resolver.stats()))
        collector.add_source(lambda: metrics.collect_pools(
            {str(pid): st for pid, st in pool_mgr.stats().items()}))
        # read c[...] at scrape time: a fleet resize or engine swap must
        # not strand a captured ref
        collector.add_source(lambda: metrics.collect_exhaustion(
            dhcpv6=c.get("dhcpv6"), nat=c.get("nat"), fleet=c.get("fleet")))
        self._on_close(collector.stop)

    def _build_checkpointer(self, dhcp) -> None:
        """Restore at start from the newest good checkpoint (a corrupt or
        mismatched one is rejected and the process cold-starts, logged),
        then the periodic checkpointer over `build_checkpoint` (or the
        sharded one). The HA store rides along: a standby bootstraps from
        it, then catches up by `replay_since`. The snapshot reads
        c["engine"] or c["cluster"] when it runs, so after a blue/green
        swap it folds the serving side's device words."""
        from bng_tpu_torch.control.statestore import CheckpointStore, PeriodicCheckpointer
        from bng_tpu_torch.runtime import checkpoint as ckpt_mod

        cfg, c = self.config, self.components
        store = c["checkpoint_store"] = CheckpointStore(cfg.checkpoint_dir)
        ha_sync = c.get("ha")
        if store.has_checkpoints():
            try:
                snap, path = store.load_latest()
                if cfg.shards > 1:
                    # slot-exact at the same topology, re-sharded N -> M;
                    # a single-engine snapshot is rejected to a cold start
                    rows = ckpt_mod.restore_sharded_checkpoint(
                        snap, c["cluster"], dhcp=dhcp, ha=ha_sync, fleet=c.get("fleet"),
                        now=int(self.clock()))
                else:
                    rows = ckpt_mod.restore_checkpoint(snap, engine=c["engine"], dhcp=dhcp,
                                                       ha=ha_sync, fleet=c.get("fleet"))
                c["checkpoint_restored"] = rows
                self.log.info("warm restart from checkpoint", path=str(path), seq=snap.seq,
                              rows={k: v for k, v in rows.items() if v})
                if "metrics" in c:
                    c["metrics"].record_restore(rows)
            except ckpt_mod.CheckpointError as e:
                c["checkpoint_error"] = str(e)
                self.log.warning("checkpoint restore rejected; cold start", error=str(e))
                if "metrics" in c:
                    c["metrics"].record_restore({}, outcome="rejected")

        def _snapshot(seq, now):
            if cfg.shards > 1:
                return ckpt_mod.build_sharded_checkpoint(
                    c["cluster"], seq, now, dhcp=dhcp, ha=ha_sync, fleet=c.get("fleet"),
                    node_id=cfg.node_id)
            return ckpt_mod.build_checkpoint(seq, now, engine=c["engine"],
                                             scheduler=c.get("scheduler"), dhcp=dhcp,
                                             ha=ha_sync, fleet=c.get("fleet"),
                                             node_id=cfg.node_id)

        ckptr = c["checkpointer"] = PeriodicCheckpointer(
            store, _snapshot, interval_s=cfg.checkpoint_interval_s, keep=cfg.checkpoint_keep,
            metrics=c.get("metrics"), clock=self.clock)
        if "collector" in c:
            c["collector"].add_source(lambda: c["metrics"].collect_checkpoint(ckptr))

    def _build_pppoe(self, pool_mgr, pppoe_tables, qos_hook, nat, acct) -> None:
        """The PPPoE server with its hooks: IP from the first pool, and on
        open the device session tables, QoS, NAT and accounting start (the
        reverse on close)."""
        from bng_tpu_torch.control.pppoe.auth import LocalVerifier, RadiusVerifier
        from bng_tpu_torch.control.pppoe.codec import PROTO_CHAP, PROTO_PAP
        from bng_tpu_torch.control.pppoe.server import PPPoEServer, PPPoEServerConfig
        from bng_tpu_torch.utils.net import ip_to_u32, parse_mac

        cfg, c = self.config, self.components
        if "radius" in c:
            verifier = RadiusVerifier(c["radius"])
        else:
            creds = {str(u["username"]): str(u["password"]).encode()
                     for u in cfg.pppoe_users if isinstance(u, dict)}
            verifier = LocalVerifier(creds)
        auth_proto = {"chap": PROTO_CHAP, "pap": PROTO_PAP, "none": 0}.get(cfg.pppoe_auth)
        if auth_proto is None:
            raise ValueError(f"pppoe_auth={cfg.pppoe_auth!r}: expected 'chap', 'pap' or 'none'")

        def _pppoe_alloc(username, mac):
            pool = pool_mgr.classify(0)
            if pool is None:
                return None
            try:
                return pool.allocate(f"pppoe:{mac.hex()}")
            except Exception:  # noqa: BLE001 — exhaustion: Service-Unavailable PADT
                return None

        def _pppoe_release(ip, mac):
            pool = pool_mgr.pool_for_ip(ip)
            if pool is not None:
                pool.release(ip)

        def _pppoe_open(sess):
            # a RADIUS Framed-IP-Address bypasses _pppoe_alloc: reserve it in
            # its pool or DHCP could hand the same address out (idempotent
            # for the same owner)
            pool = pool_mgr.pool_for_ip(sess.assigned_ip)
            if pool is not None:
                pool.allocate_specific(sess.assigned_ip, f"pppoe:{sess.client_mac.hex()}")
            pppoe_tables.session_up(sess)
            if cfg.qos_enabled:
                qos_hook(sess.assigned_ip, sess.radius_attributes.get("qos_policy"))
            if cfg.nat_enabled:
                nat.allocate_nat(sess.assigned_ip, int(self.clock()))
            if acct is not None:
                acct.start(pppoe_sid(sess), username=sess.username, framed_ip=sess.assigned_ip,
                           mac="-".join(f"{b:02X}" for b in sess.client_mac))

        def _pppoe_close(event):
            sess = event.session
            pppoe_tables.session_down(event)
            if cfg.qos_enabled and sess.assigned_ip:
                c["qos"].remove_subscriber(sess.assigned_ip)
            if cfg.nat_enabled and sess.assigned_ip:
                nat.release_nat(sess.assigned_ip, int(self.clock()))
            if acct is not None:
                acct.stop(pppoe_sid(sess))

        c["pppoe"] = PPPoEServer(
            PPPoEServerConfig(
                ac_name=cfg.pppoe_ac_name, service_name=cfg.pppoe_service_name,
                server_mac=parse_mac(cfg.server_mac), our_ip=ip_to_u32(cfg.server_ip),
                dns_primary=ip_to_u32(cfg.dns_primary),
                dns_secondary=ip_to_u32(cfg.dns_secondary), auth_proto=auth_proto),
            verifier, _pppoe_alloc, release_ip=_pppoe_release,
            on_open=_pppoe_open, on_close=_pppoe_close)
        self.log.info("pppoe server", ac_name=cfg.pppoe_ac_name, auth=cfg.pppoe_auth,
                      backend="radius" if "radius" in c else "local")

    def _build_coa(self, qos_hook) -> None:
        """The CoA listener: locate by Acct-Session-Id, Framed-IP or
        Calling-Station-Id over the DHCP leases, then the PPPoE sessions,
        then the fleet's owning shard (on the MAC steering hash);
        a policy change rewrites the subscriber's QoS rows, a disconnect
        expires the lease or tears the session down (its PADT and LCP
        frames ride the demux's pending queue to the TX ring). Every verb
        runs under `_ctl`."""
        from bng_tpu_torch.control.pppoe.session import TerminateCause
        from bng_tpu_torch.control.radius.coa import CoAProcessor, CoAServer
        from bng_tpu_torch.utils.net import mac_to_u64

        cfg, c = self.config, self.components
        dhcp, pppoe_srv = c["dhcp"], c.get("pppoe")
        # DHCPv4 leases live in the workers when the fleet serves: the
        # locators probe the parent books first, then route to the owning
        # shard (relay counted by the fleet when missteered)
        fleet = c.get("fleet")

        def _find_by_ip(ip):
            for lease in dhcp.leases.values():
                if lease.ip == ip:
                    return ("dhcp", lease)
            if pppoe_srv is not None:
                for s in pppoe_srv.sessions.all():
                    if s.assigned_ip == ip:
                        return ("pppoe", s)
            if fleet is not None:
                r = fleet.handle_coa("locate", ip=ip)
                if r["found"]:
                    return ("fleet", r)
            return None

        def _find_by_sid(sid):
            for lease in dhcp.leases.values():
                if lease.session_id == sid:
                    return ("dhcp", lease)
            if pppoe_srv is not None and sid.startswith("pppoe-"):
                try:  # the inverse of pppoe_sid()
                    num = int(sid.split("-")[1], 16)
                except (IndexError, ValueError):
                    return None
                s = pppoe_srv.sessions.get(num)
                if s is not None:
                    return ("pppoe", s)
            if fleet is not None and not sid.startswith("pppoe-"):
                r = fleet.handle_coa("locate", session_id=sid)
                if r["found"]:
                    return ("fleet", r)
            return None

        def _find_by_mac(mac_str):
            try:
                mac = bytes.fromhex(mac_str.replace("-", "").replace(":", ""))
            except ValueError:
                return None
            lease = dhcp.leases.get(mac_to_u64(mac))
            if lease is not None:
                return ("dhcp", lease)
            if pppoe_srv is not None:
                for s in pppoe_srv.sessions.all():
                    if s.client_mac == mac:
                        return ("pppoe", s)
            if fleet is not None:
                r = fleet.handle_coa("locate", mac=mac)
                if r["found"]:
                    return ("fleet", r)
            return None

        def _coa_qos(ip, policy_name):
            if qos_hook is None:
                return False  # QoS disabled: a CoA rate change NAKs
            qos_hook(ip, policy_name)  # the processor checked the name
            # record the new plan on the lease and re-push it through the
            # hook chain, so every lease-state consumer sees the change
            lease = next((le for le in dhcp.leases.values() if le.ip == ip), None)
            if lease is not None:
                lease.qos_policy = policy_name
                if dhcp.accounting_hook is not None:
                    dhcp.accounting_hook("renew", lease, lease.session_id)
            elif fleet is not None:
                # the owning shard mutates its own lease; the renew event
                # rides the drained relay into accounting
                fleet.handle_coa("qos", ip=ip, policy_name=policy_name)
            return True

        def _coa_disconnect(kind, obj):
            if kind == "dhcp":
                obj.expiry = 0
                dhcp.cleanup_expired(1)  # reaps only the forced lease
                return True
            if kind == "fleet":
                return bool(fleet.handle_coa("disconnect", ip=obj["ip"])["found"])
            frames = pppoe_srv.terminate(obj.session_id, TerminateCause.ADMIN_RESET,
                                         now=self.clock())
            if "slowpath" in c:
                # the PADT/LCP teardown frames go out with the next beat
                c["slowpath"].requeue(frames)
            return True

        class _CoASession:  # (kind, obj) with the .ip the processor reads
            def __init__(self, kind, obj):
                self.kind, self.obj = kind, obj
                if kind == "dhcp":
                    self.ip = obj.ip
                elif kind == "fleet":
                    self.ip = obj["ip"]
                else:
                    self.ip = obj.assigned_ip

        def _wrap(found):
            return None if found is None else _CoASession(*found)

        def _locked(fn):
            def run(*a):
                with self._ctl:
                    return fn(*a)
            return run

        proc = CoAProcessor(
            find_by_session_id=_locked(lambda sid: _wrap(_find_by_sid(sid))),
            find_by_ip=_locked(lambda ip: _wrap(_find_by_ip(ip))),
            find_by_mac=_locked(lambda m: _wrap(_find_by_mac(m))),
            qos_update=_locked(_coa_qos),
            disconnect=_locked(lambda h: _coa_disconnect(h.kind, h.obj)),
            policy_manager=c["policies"])
        host, _, port = cfg.coa_listen.rpartition(":")
        coa = c["coa"] = CoAServer(
            resolve_secret(cfg.radius_secret, cfg.radius_secret_file).encode(), proc,
            bind=(host or "0.0.0.0", int(port or 3799)))
        coa.start()
        self._on_close(coa.stop)
        self.log.info("coa listener", addr=f"{coa.addr[0]}:{coa.addr[1]}")

    # -- zero-downtime transitions (ops verbs; serialized on _ctl) -------

    def fleet_resize(self, n: int) -> dict:
        """Live fleet elasticity: grow/shrink the slow-path fleet to `n`
        workers at a batch boundary — no restart, no dropped in-flight
        DORAs (control/fleet.py resize)."""
        with self._ctl:
            return self._fleet_resize_locked(int(n))

    def _fleet_resize_locked(self, n: int) -> dict:
        fleet = self.components.get("fleet")
        if fleet is None:
            why = (f"blocked by {self.fleet_blockers}" if self.fleet_blockers
                   else "not configured (--slowpath-workers <= 1)")
            return {"op": "fleet_resize", "outcome": "rejected",
                    "error": f"no slow-path fleet: {why}"}
        report = fleet.resize(n)
        if "metrics" in self.components:
            self.components["metrics"].record_transition(report)
            self.components["metrics"].slowpath_workers.set(fleet.n)
        self.log.info("fleet resize", **{k: report.get(k) for k in
                                         ("from", "to", "outcome", "leases_moved",
                                          "offers_moved")})
        return report

    def fleet_rolling_restart(self) -> dict:
        """Replace fleet workers one shard at a time (drain-then-transfer
        per shard; heals chaos-killed inline workers) — the live-deploy
        verb (control/fleet.py rolling_restart)."""
        with self._ctl:
            fleet = self.components.get("fleet")
            if fleet is None:
                return {"op": "fleet_rolling_restart", "outcome": "rejected",
                        "error": "no slow-path fleet configured"}
            report = fleet.rolling_restart()
            if "metrics" in self.components:
                self.components["metrics"].record_transition(report)
            self.log.info("fleet rolling restart", outcome=report.get("outcome"),
                          replaced=report.get("replaced"), lost=report.get("lost"))
            return report

    def engine_swap(self) -> dict:
        """Blue/green engine swap: hydrate a standby from an in-memory
        snapshot, replay the delta, audit, flip atomically — rollback on
        any failure with the active untouched (runtime/ops.py). On the
        sharded path the standby is a ShardedCluster hydrated from a
        sharded snapshot and partition-audited before the flip."""
        from bng_tpu_torch.runtime.ops import blue_green_swap, sharded_blue_green_swap

        with self._ctl:
            if "cluster" in self.components:
                report = sharded_blue_green_swap(
                    self.components, metrics=self.components.get("metrics"),
                    node_id=self.config.node_id, clock=self.clock)
            else:
                report = blue_green_swap(self.components,
                                         metrics=self.components.get("metrics"),
                                         node_id=self.config.node_id)
            self.log.info("engine swap", outcome=report.get("outcome"),
                          delta_rows=report.get("delta_rows"), error=report.get("error"))
            return report

    def ops_status(self) -> dict:
        """GET /ops/status payload: what a transition would act on. Runs
        on the HTTP handler thread — takes _ctl so it never reads fleet
        state mid-mutation."""
        with self._ctl:
            c = self.components
            out: dict = {"node_id": self.config.node_id,
                         "fleet_blocked": self.fleet_blockers,
                         "ops": c["ops"].stats_snapshot() if "ops" in c else None}
            fleet = c.get("fleet")
            if fleet is not None:
                fs = fleet.stats_snapshot()
                out["fleet"] = {k: fs[k] for k in (
                    "workers", "mode", "resizes", "rolling_restarts", "dead_workers")}
            auto = c.get("autoscaler")
            if auto is not None:
                out["autoscaler"] = {"decisions": auto.decisions,
                                     "min": auto.cfg.min_workers,
                                     "max": auto.cfg.max_workers}
            return out

    def close(self) -> None:
        """LIFO cleanup."""
        for fn in reversed(self._cleanup):
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown runs every step
                pass
        self._cleanup.clear()

    def drive_once(self) -> int:
        """One dataplane beat: pump the AF_XDP socket (kernel RX -> ring)
        when a real rung is attached, feed the synthetic source (if
        configured), run the sharded cluster's double-buffered ring loop,
        the scheduler's beat or a double-buffered engine step over the
        ring, put the slow-path demux's pending frames on the TX ring, and
        pump again (ring TX verdicts -> kernel). Returns frames moved (the
        run loop sleeps when this stays 0)."""
        ring = self.components.get("ring")
        if ring is None:
            return 0
        att = self.components.get("wire_attachment")
        pumped = 0
        if att is not None and att.xsk is not None:
            pumped = att.xsk.pump()  # kernel -> ring before the step
        if self.config.synthetic_subs:
            self._push_synthetic(ring)
        sched = self.components.get("scheduler")
        with self._ctl:
            if "cluster" in self.components:
                # ring-steered owner-shard batches, two windows in flight,
                # slow-path punts handled lane-aligned
                now = self.clock()
                moved = self.components["cluster"].process_ring_pipelined(
                    ring, int(now), int(now * 1e6) & 0xFFFFFFFF, slow_path=self._slow_path)
            elif sched is not None and hasattr(ring, "rx_pop"):
                moved = self._drive_scheduler(ring, sched)
            else:
                # scheduler off, or a native ring (batch assemble..complete
                # is its contract; the two lanes' out-of-order retire needs
                # the frame-wise rx_pop only PyRing has)
                if sched is not None and not self._warned_no_rx_pop:
                    self._warned_no_rx_pop = True
                    self.log.warning("scheduler enabled but ring has no rx_pop; "
                                     "using pipelined engine loop")
                moved = self.components["engine"].process_ring_pipelined(ring)
            # PPPoE negotiation's frames beyond the one inline reply (CHAP
            # Success + IPCP Conf-Req in one beat), CoA teardowns and the
            # fleet workers' pending frames relayed by the parent; a full
            # TX ring re-queues the rest, in order, for the next beat
            for src in (self.components.get("slowpath"), self.components.get("fleet")):
                if src is None:
                    continue
                pending = src.drain_pending()
                for i, frame in enumerate(pending):
                    if ring.tx_inject(frame, from_access=True):
                        moved += 1
                    else:
                        src.requeue(pending[i:], front=True)
                        break
        if att is not None and att.xsk is not None:
            pumped += att.xsk.pump()  # verdicts -> kernel after the step
        return moved + pumped

    _warned_no_rx_pop = False

    def _drive_scheduler(self, ring, sched) -> int:
        """One scheduler beat over the ring: RX frames into the lanes, poll
        (express first, bulk ring-managed), completions back out on the TX
        ring (slow-path replies too: the slow path ran inside the retire)."""
        from bng_tpu_torch.runtime.lanes import LANE_BULK, LANE_EXPRESS
        from bng_tpu_torch.runtime.ring import FLAG_DHCP_CTRL, FLAG_FROM_ACCESS
        from bng_tpu_torch.telemetry import spans as tele

        moved = 0
        t0 = tele.t()
        budget = sched.bulk.cfg.batch * sched.bulk.cfg.depth
        for _ in range(budget):
            got = ring.rx_pop()
            if got is None:
                break
            frame, fl = got
            fa = (fl & FLAG_FROM_ACCESS) != 0
            # the ring classified at rx_push: pass the lane so submit()
            # skips a second header parse
            lane = LANE_EXPRESS if fa and (fl & FLAG_DHCP_CTRL) else LANE_BULK
            sched.submit(frame, from_access=fa, lane=lane)
            # ingested frames count as movement, or the run loop's idle
            # sleep would stretch a sub-ms express deadline
            moved += 1
        if moved:
            tele.lap(tele.RING, t0)
        moved += sched.poll()
        if moved == 0 and (len(sched.express) or len(sched.bulk)):
            moved = 1  # frames wait on a deadline close: keep the loop hot
        for c in sched.drain_completions():
            if c.frame is None:
                continue
            if c.verdict in ("tx", "fwd", "slow"):
                # a full TX ring drops the frame (the client retransmits)
                ring.tx_inject(c.frame, from_access=c.from_access)
        return moved

    def _push_synthetic(self, ring, per_beat: int = 16) -> None:
        """Rotating-MAC DISCOVER source (`run --synthetic-subs N`)."""
        from bng_tpu_torch import frames as packets
        from bng_tpu_torch.control import dhcp_codec

        n_subs = self.config.synthetic_subs
        for _ in range(per_beat):
            i = self._syn_i % n_subs
            self._syn_i += 1
            mac = (0x02B70000 << 16 | i).to_bytes(6, "big")
            p = dhcp_codec.build_request(mac, dhcp_codec.DISCOVER, xid=self._syn_i & 0xFFFFFFFF)
            p.options.append((dhcp_codec.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
            f = packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                                   p.encode().ljust(320, b"\x00"))
            if not ring.rx_push(f, from_access=True):
                break  # ring full: back off until the engine drains

    def tick(self, now: float | None = None) -> None:
        """The run loop's 1 Hz maintenance heartbeat: the PPPoE keepalive
        and timeout sweep and SLAAC's periodic RAs (their frames go on the
        TX ring), DHCP and DHCPv6 lease cleanup and NAT session expiry
        (every EXPIRE_EVERY_S), the walled-garden expiry checker (every
        GARDEN_EVERY_S), the checkpointer's cadence, the SLO monitor's
        burn-rate window, and accounting: the device's NAT octet counts
        into the sessions (every ACCT_SYNC_EVERY_S), interims and spool
        retries (every ACCT_RETRY_EVERY_S)."""
        now = now if now is not None else self.clock()
        with self._ctl:
            self._tick_locked(now)

    def _tick_locked(self, now: float) -> None:
        c = self.components
        # the standby's reconnect (with backoff) and the store's
        # anti-entropy sync
        ha = c.get("ha")
        if ha is not None and hasattr(ha, "tick"):  # StandbySyncer only
            ha.tick(now)
        cstore = c.get("cluster_store")
        if cstore is not None and now - self._last_sync >= cstore.sync_interval:
            self._last_sync = now
            cstore.tick()
        # the protocol servers' ticks that emit frames; with no ring (a
        # control-plane app) there is no wire and they are dropped
        ring = c.get("ring")
        for name in ("pppoe", "slaac"):
            srv = c.get(name)
            if srv is not None:
                for frame in srv.tick(now):
                    if ring is not None:
                        ring.tx_inject(frame, from_access=True)
        # the reap bound keeps one synchronized lease cliff from starving
        # this tick (leftovers are reaped by the next sweeps)
        if now - self._last_expire >= self.EXPIRE_EVERY_S:
            self._last_expire = now
            budget = self.config.expire_batch or None
            c["dhcp"].cleanup_expired(int(now), max_reaps=budget)
            if c.get("dhcpv6") is not None:
                c["dhcpv6"].cleanup_expired(now, max_reaps=budget)
            if "cluster" in c:
                c["cluster"].expire(int(now))
            else:
                c["engine"].expire(int(now))
            fleet = c.get("fleet")
            if fleet is not None:
                # fleet workers own their lease books; the sweep fans out
                # and the release table-events replay here
                fleet.expire(int(now), max_reaps=budget)
        garden = c.get("walledgarden")
        if garden is not None and now - self._last_garden >= self.GARDEN_EVERY_S:
            self._last_garden = now
            garden.check_expired()
        # the partition FSM and the peer pool's health checks (both
        # rate-limited inside)
        res = c.get("resilience")
        if res is not None:
            acct_mgr = c.get("accounting")
            res.tick(now, acct_send=((lambda rec: acct_mgr.client.send_accounting(**rec))
                                     if acct_mgr is not None else None))
        pool = c.get("peerpool")
        if pool is not None:
            pool.health_check(now)
        # the background checkpoint cadence (never raises: a failure is
        # counted and logged inside PeriodicCheckpointer.tick)
        ckptr = c.get("checkpointer")
        if ckptr is not None:
            ckptr.tick(now)
        # the SLO burn-rate window: evaluates only when a window elapsed; a
        # breach fires the slo_breach flight dump and is logged here
        slo_mon = c.get("slo")
        if slo_mon is not None:
            breached = slo_mon.tick(now)
            if breached:
                self.log.warning("slo breach", stages=sorted(breached),
                                 window_s=slo_mon.window_s)
        # watermark-driven fleet elasticity: the autoscaler recommends,
        # the same resize verb the operator uses executes (under _ctl:
        # tick() took it)
        auto = c.get("autoscaler")
        if auto is not None and "fleet" in c:
            target = auto.target(now)
            if target is not None and target != c["fleet"].n:
                if "metrics" in c:
                    c["metrics"].ops_autoscaler_target.set(target)
                try:
                    self._fleet_resize_locked(target)
                except Exception as e:  # noqa: BLE001
                    # an autoscaler-triggered resize failure must not take
                    # the dataplane loop down; cooldown paces the retry
                    self.log.error("autoscaler resize failed", target=target,
                                   error=f"{type(e).__name__}: {e}")
        acct = c.get("accounting")
        if acct is not None:
            # the device's NAT octet counts into the accounting sessions
            # before interims fire, else every interim and stop reports 0
            if acct.sessions and now - self._last_acct_sync >= self.ACCT_SYNC_EVERY_S:
                self._last_acct_sync = now
                if "cluster" in c:
                    # a subscriber's NAT state lives on its affinity shard
                    # alone, so the per-shard dicts are disjoint
                    cl = c["cluster"]
                    octets = {}
                    if cl.tables is not None:
                        for i in range(cl.n):
                            octets.update(cl.nat[i].subscriber_octets(cl.fetch_session_vals(i)))
                else:
                    eng = c["engine"]
                    octets = eng.nat.subscriber_octets(eng.fetch_session_vals())
                for s in list(acct.sessions.values()):
                    got = octets.get(s.framed_ip)
                    if got is not None:
                        acct.update_counters(s.session_id, *got)
            # interims and retries block on the server (timeout x retries):
            # their own cadence, so a dead server does not stall every tick
            if now - self._last_acct_retry >= self.ACCT_RETRY_EVERY_S:
                self._last_acct_retry = now
                acct.interim_tick(now)
                acct.retry_tick()

    def stats(self) -> dict:
        out = {"version": __version__, "node_id": self.config.node_id,
               "device": str(self.device)}
        eng = self.components.get("engine")
        if eng is not None:
            out["engine"] = {"batches": eng.stats.batches, "tx": eng.stats.tx,
                             "passed": eng.stats.passed, "dropped": eng.stats.dropped}
        cluster = self.components.get("cluster")
        if cluster is not None:
            out["sharded"] = cluster.stats_summary()
            if self.sharded_blockers:
                out["sharded_blockers"] = list(self.sharded_blockers)
        dhcp = self.components.get("dhcp")
        if dhcp is not None:
            out["dhcp"] = {k: getattr(dhcp.stats, k) for k in
                           ("discover", "offer", "request", "ack", "nak", "release")
                           if hasattr(dhcp.stats, k)}
        pools = self.components.get("pools")
        if pools is not None:
            out["pools"] = pools.stats()
        pppoe = self.components.get("pppoe")
        if pppoe is not None and eng is not None:
            out["pppoe"] = {
                "sessions": len(pppoe.sessions), "opened": pppoe.stats.sessions_opened,
                "closed": pppoe.stats.sessions_closed,
                "auth_failures": pppoe.stats.auth_failure,
                "device": {"decap": int(eng.stats.pppoe[0]), "encap": int(eng.stats.pppoe[1])}}
            from bng_tpu_torch.ops.pppoe import PSL_MISMATCH, PSL_STRIPPED, PSL_WRITTEN

            line = eng.stats.pppoe_line
            if line.any():  # sessions bound to QinQ lines have been served
                out["pppoe"]["device"]["line"] = {
                    "stripped": int(line[PSL_STRIPPED]), "written": int(line[PSL_WRITTEN]),
                    "mismatch": int(line[PSL_MISMATCH])}
        nat = self.components.get("nat")
        if nat is not None:  # registered only when nat_enabled
            out["nat"] = {"sessions": nat.sessions.count, "blocks": len(nat.blocks)}
        fleet = self.components.get("fleet")
        if fleet is not None:
            out["slowpath_fleet"] = fleet.stats_snapshot()
        if self.fleet_blockers:
            # the configured-but-degraded state must be visible wherever
            # an operator looks first (stats, metrics, startup banner)
            out["slowpath_fleet_blocked"] = list(self.fleet_blockers)
        res = self.components.get("resilience")
        if res is not None:
            out["resilience"] = {"state": res.state.value,
                                 "degraded_auth": res.degraded_auth_active}
        coa = self.components.get("coa")
        if coa is not None:
            out["coa"] = {**coa.stats, **coa.processor.stats}
        return out


# ---------------------------------------------------------------------------
# demo mode: the reference's `run_demo`, a host path (no card)
# ---------------------------------------------------------------------------

def run_demo(subscriber_count: int = 3, out=None, clock=time.time) -> dict:
    """ONT discovery -> walled garden -> activation -> session, with stub
    auth/allocator (the reference's `run_demo`): a pure host path, so it
    needs no card and takes no device."""
    from bng_tpu_torch.control.direct import DirectAuthenticator
    from bng_tpu_torch.control.nexus import (NexusClient, NTEEntity,
                                             SubscriberEntity, VLANAllocator)
    from bng_tpu_torch.control.pon import DiscoveryEvent, PONConfig, PONManager
    from bng_tpu_torch.control.subscriber import SessionKind, SubscriberManager
    from bng_tpu_torch.control.walledgarden import WalledGardenManager

    def log(msg):
        print(msg, file=out if out is not None else sys.stdout)

    nexus = NexusClient(clock=clock)
    vlans = VLANAllocator()
    pon = PONManager(PONConfig(), nexus, vlans, clock=clock)
    garden = WalledGardenManager(clock=clock)
    auth = DirectAuthenticator(nexus=nexus, clock=clock)

    class DemoAllocator:
        def __init__(self):
            self.next = 10

        def allocate(self, sid):
            ip = f"10.1.0.{self.next}"
            self.next += 1
            return ip

        def release(self, sid):
            return True

    class GardenBridge:
        def add(self, session):
            garden.add_to_walled_garden(session.mac or "02:00:00:00:00:00")

        def remove(self, session):
            garden.release_from_walled_garden(session.mac or "02:00:00:00:00:00")

    subs = SubscriberManager(authenticator=auth, allocator=DemoAllocator(),
                             walled_garden=GardenBridge(), clock=clock)

    results = {"provisioned": 0, "active": 0, "walled": 0}
    for i in range(1, subscriber_count + 1):
        serial = f"DEMO-ONT-{i:03d}"
        mac = f"02:de:e0:00:00:{i:02x}"
        log(f"--- subscriber {i}: ONT {serial} ---")

        # 1. ONT appears; operator pre-approved it in Nexus
        nexus.ntes.put(serial, NTEEntity(id=serial, serial=serial, approved=True))
        r = pon.handle_discovery(DiscoveryEvent(serial=serial))
        log(f"  provisioned: s_tag={r.s_tag} c_tag={r.c_tag}")
        results["provisioned"] += 1

        # 2. subscriber record exists for odd ONTs; evens hit the garden
        if i % 2:
            nexus.subscribers.put(f"sub-{i}", SubscriberEntity(
                id=f"sub-{i}", mac=mac, nte_id=serial,
                circuit_id=f"olt1/1/{i}", qos_policy="residential-100mbps"))

        s = subs.create_session(SessionKind.IPOE, mac=mac, circuit_id=f"olt1/1/{i}")
        if subs.authenticate(s.id):
            ip = subs.assign_address(s.id)
            subs.activate(s.id)
            log(f"  ACTIVE: {s.subscriber_id} ip={ip}")
            results["active"] += 1
        else:
            log("  WALLED GARDEN: unknown subscriber, portal redirect on")
            results["walled"] += 1

    log(f"demo complete: {results}")
    return results


def run_loadtest(args, device) -> int:
    """Build a self-contained engine + slow-path stack on `device` and
    load-test it (the reference's `run_loadtest`). `--wire [IFNAME]`
    drives the batches through the wire loop instead of the engine's batch
    interface. `--workers N` fans the DHCPv4 slow lanes over a slow-path fleet of N
    workers (`--fleet-mode`). `--trace` arms the span tracer for the run:
    the report gains the per-stage breakdown and its SLO verdict."""
    import ipaddress

    from bng_tpu_torch import kernels
    from bng_tpu_torch.control.dhcp_server import DHCPServer
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.control.pool import Pool, PoolManager
    from bng_tpu_torch.loadtest import BenchmarkConfig, DHCPBenchmark
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.tables import FastPathTables
    from bng_tpu_torch.utils.net import ip_to_u32, parse_mac

    net = ipaddress.ip_network(args.pool_cidr)
    server_ip = int(net.network_address + 1)
    server_mac = parse_mac("02:aa:bb:cc:dd:01")
    # size the subscriber table for the MAC working set at <50% load
    sub_nb = 1 << max(10, (args.macs // 2).bit_length())
    # update_slots must cover a full warmup batch of inserts per step or
    # the device cache lags the host table and renewals miss spuriously
    fastpath = FastPathTables(sub_nbuckets=sub_nb, vlan_nbuckets=1 << 10,
                              cid_nbuckets=1 << 10, max_pools=16, stash=256,
                              update_slots=max(256, 2 * args.batch_size))
    fastpath.set_server_config(server_mac, server_ip)
    pools = PoolManager(fastpath)
    pools.add_pool(Pool(pool_id=1, network=int(net.network_address),
                        prefix_len=net.prefixlen, gateway=server_ip,
                        dns_primary=ip_to_u32("1.1.1.1"), lease_time=86400))
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")],
                     sessions_nbuckets=256, sub_nat_nbuckets=64)
    server = DHCPServer(server_mac, server_ip, pools, fastpath_tables=fastpath)
    engine = Engine(fastpath, nat, batch_size=args.batch_size,
                    slow_path=server.handle_frame, device=device)
    tracer = None
    if args.trace:
        # armed before the fleet spawns (a process-mode fleet exports
        # BNG_TELEMETRY to its children at construction) and before the
        # scheduler is built, as the reference's is
        from bng_tpu_torch.telemetry import spans as tele_spans

        tracer = tele_spans.arm(tele_spans.Tracer())
    fleet = None
    workers = args.workers or 1
    if workers > 1:
        # the parent DHCPServer above is bypassed (workers own the lease
        # books) but stays the engine's per-frame fallback
        from bng_tpu_torch.control.admission import AdmissionConfig
        from bng_tpu_torch.control.fleet import FleetSpec, SlowPathFleet

        fleet = SlowPathFleet(
            FleetSpec.from_pool_manager(server_mac, server_ip, pools),
            n_workers=workers, pools=pools, mode=args.fleet_mode,
            # inbox sized past the harness batch: the loadtest measures
            # throughput, the dedicated overload tests measure shedding
            admission=AdmissionConfig(inbox_capacity=max(512, 2 * args.batch_size)),
            table_sink=fastpath)
        engine.slow_path_batch = fleet.handle_batch
    target = engine
    if args.scheduler:
        from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler

        target = TieredScheduler(engine, SchedulerConfig(
            bulk_batch=args.batch_size, express_device_index=_express_index(engine.device)))

    # --wire: drive the batches through the full wire loop (inject at
    # the far end -> kernel rings -> WirePump -> UMEM ring -> engine ->
    # WirePump -> far end) instead of the engine's batch interface.
    # `--wire` alone runs the memory-rung SimKernelRings
    # loopback (no privileges needed); `--wire IFNAME` walks the real
    # attach ladder and needs --wire-peer to see replies.
    wire = args.wire
    wire_cleanup: list = []
    wire_pump = None
    wire_mode = ""
    if wire is not None:
        if args.scheduler:
            print("loadtest: --wire and --scheduler are incompatible "
                  "(the native ring's batch assemble..complete contract "
                  "has no rx_pop)", file=sys.stderr)
            return 2
        from bng_tpu_torch.loadtest import WireLoopTarget
        from bng_tpu_torch.runtime import xsk as xsk_mod
        from bng_tpu_torch.runtime.ring import NativeRing

        nframes = 1 << max(12, (4 * args.batch_size - 1).bit_length())
        depth = 1 << max(10, (2 * args.batch_size - 1).bit_length())
        try:
            wire_ring = NativeRing(nframes=nframes, frame_size=2048,
                                   depth=depth)
        except RuntimeError as e:
            print(f"loadtest: --wire needs the native ring: {e}",
                  file=sys.stderr)
            return 2
        wire_cleanup.append(wire_ring.close)
        pump_path = args.wire_pump or None
        att = (xsk_mod.open_wire(wire_ring, ifname=wire,
                                 pump_path=pump_path)
               if wire != "mem" else None)
        if att is not None and att.xsk is not None:
            peer = args.wire_peer
            if not peer:
                print("loadtest: --wire on a live rung needs --wire-peer "
                      "IFNAME (the far end to inject/collect on)",
                      file=sys.stderr)
                return 2
            import socket as so

            from bng_tpu_torch.runtime import xdp_redirect

            wire_cleanup.append(att.xsk.close)
            try:
                redir = xdp_redirect.XdpRedirect(wire, {0: att.xsk.fd})
                wire_cleanup.append(redir.close)
            except OSError as e:
                print(f"loadtest: xdp redirect failed (CAP_BPF): {e}",
                      file=sys.stderr)
                return 2
            txs = so.socket(so.AF_PACKET, so.SOCK_RAW)
            txs.bind((peer, 0))
            rxs = so.socket(so.AF_PACKET, so.SOCK_RAW, so.htons(0x0003))
            rxs.bind((peer, 0))
            rxs.setblocking(False)
            wire_cleanup.extend((txs.close, rxs.close))

            def _inject(frames, _s=txs):
                for f in frames:
                    _s.send(f)

            def _collect(_s=rxs):
                out = []
                while True:
                    try:
                        out.append(_s.recv(4096))
                    except (BlockingIOError, OSError):
                        break
                return out

            wire_pump = att.xsk.wire_pump
            wire_mode = att.mode
            target = WireLoopTarget(engine, wire_ring, wire_pump,
                                    _inject, _collect)
        else:
            if att is not None:
                # a REQUESTED NIC fell back: say it loudly, then serve
                # the memory rung anyway (the loadtest still measures
                # the pump loop; bng_wire_rung would pin it in `run`)
                print(f"loadtest: wire attach fell back to the memory "
                      f"rung: {att.detail}", file=sys.stderr)
            kern = xsk_mod.SimKernelRings(wire_ring, headroom=256,
                                          ring_size=depth)
            wire_pump = xsk_mod.WirePump(wire_ring, kern, path=pump_path)
            wire_mode = "memory"
            target = WireLoopTarget(engine, wire_ring, wire_pump,
                                    kern.inject_many, kern.drain_egress,
                                    tick=kern.deliver)

    cfg = BenchmarkConfig(
        batch_size=args.batch_size, duration_s=args.duration,
        warmup_s=args.warmup, unique_macs=args.macs,
        enable_renewals=args.renewals, renewal_ratio=args.renewal_ratio,
        rps_limit=args.rps)
    bench = DHCPBenchmark(target, cfg, log=lambda s: print(s, file=sys.stderr))
    launches0 = dict(kernels.LAUNCHES)
    try:
        res = bench.run()
        if fleet is not None:
            res.shed = dict(fleet.admission.stats.shed)
            slice_exhausted = fleet.pool_exhausted_total()
    finally:
        if tracer is not None:
            tele_spans.disarm()
        if fleet is not None:
            fleet_snap = fleet.stats_snapshot()
            fleet.close()
        for fn in reversed(wire_cleanup):
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
    degraded = {}
    if server.stats.pool_exhausted:
        degraded["dhcp_pool"] = server.stats.pool_exhausted
    if fleet is not None and slice_exhausted:
        degraded["fleet_slice"] = slice_exhausted
    for resource, count in nat.exhausted.items():
        if count:
            degraded[f"nat_{resource}"] = count
    res.degraded = degraded
    stage_breakdown = tracer.breakdown() if tracer is not None else {}
    if tracer is not None:
        # the SLO verdict over the stage breakdown: the vocabulary the
        # storm budgets and `run`'s live monitor gate on
        from bng_tpu_torch.telemetry import slo as slo_mod

        res.slo = slo_mod.evaluate(stage_breakdown)
    # what served the run: the card (or the CPU), its device dispatches
    # over warmup and measurement, and the kernel launches they made
    served = {"device": str(engine.device), "dispatches": int(engine.stats.batches),
              "launches": {k: kernels.LAUNCHES[k] - launches0[k] for k in launches0}}
    if args.bench_log:
        from bng_tpu_torch.telemetry import ledger as ledger_mod

        try:
            ledger_mod.append(args.bench_log, {
                "metric": "loadtest req/s",
                "value": round(res.rps, 1),
                "unit": "req/s",
                "scenario": res.scenario,
                "batch": args.batch_size,
                "subscribers": args.macs,
                "workers": workers,
                "program": res.program,
                "latency_p99_us": round(res.latency_p99_us, 1),
                "request_p99_us": res.request_p99_us,
                "shed": res.shed,
                "degraded": res.degraded,
                # only on traced runs: an empty dict would read as
                # "instrumentation on, every stage vanished"
                **({"slo": res.slo, "stage_breakdown": stage_breakdown}
                   if tracer is not None else {}),
                "env": ledger_mod.environment_fingerprint(engine.device),
            })
        except OSError as e:
            print(f"loadtest: bench-log append failed: {e}", file=sys.stderr)
    if args.json_out:
        out = {**res.to_dict(), "served": served}
        if fleet is not None:
            out["fleet"] = fleet_snap
        if tracer is not None:
            out["stage_breakdown"] = stage_breakdown
        if wire_pump is not None:
            out["wire"] = {"mode": wire_mode, "pump_path": wire_pump.path,
                           "pump_stats": dict(wire_pump.pump_stats),
                           "unmatched": target.unmatched}
        print(json.dumps(out, indent=2))
    else:
        print(res.summary())
        print(f"Served by:         {served['device']}, {served['dispatches']} dispatches, "
              f"launches {served['launches']}")
        if wire_pump is not None:
            st = wire_pump.pump_stats
            print(f"Wire:              rung={wire_mode} pump={wire_pump.path} rx={st['rx']} "
                  f"tx={st['tx']} submit_fail={st['rx_submit_fail']} "
                  f"tx_overflow={st['tx_overflow']}")
        if fleet is not None:
            adm = fleet_snap["admission"]
            print(f"Fleet:             {fleet_snap['workers']} workers, "
                  f"{adm['admitted']} admitted, {sum(adm['shed'].values())} shed")
        if tracer is not None:
            print("Stage breakdown (us):")
            for stage, st in stage_breakdown.items():
                print(f"  {stage:<12} p50 {st['p50_us']:>9.1f}   "
                      f"p99 {st['p99_us']:>9.1f}   n {st['count']}")
            if not res.slo["ok"]:
                print(f"SLO BREACHED: {', '.join(res.slo['breaches'])}")
    if args.validate:
        failures = res.meets_targets(cfg)
        for f in failures:
            print(f"TARGET FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0
    return 0


def _trace_dora(args, device):
    """Build a self-contained engine (+ scheduler) stack on `device`, arm a
    span-event-keeping tracer, and drive a full DORA exchange for `--macs`
    subscribers plus a renewal round that hits the device fast path: the
    traced workload `trace dump` / `trace export` ship. `--workers N`
    puts an inline fleet of N workers behind the slow path. Returns
    (tracer, recorder) with the tracer disarmed again."""
    import ipaddress

    from bng_tpu_torch import frames as packets
    from bng_tpu_torch.control import dhcp_codec
    from bng_tpu_torch.control.dhcp_server import DHCPServer
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.control.pool import Pool, PoolManager
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.tables import FastPathTables
    from bng_tpu_torch.telemetry import FlightRecorder, RecorderConfig
    from bng_tpu_torch.telemetry import spans as tele
    from bng_tpu_torch.utils.net import ip_to_u32, parse_mac

    net = ipaddress.ip_network(args.pool_cidr)
    server_ip = int(net.network_address + 1)
    server_mac = parse_mac("02:aa:bb:cc:dd:01")
    fastpath = FastPathTables(sub_nbuckets=1 << 10, vlan_nbuckets=64, cid_nbuckets=64,
                              max_pools=4, update_slots=max(256, 2 * args.batch_size))
    fastpath.set_server_config(server_mac, server_ip)
    pools = PoolManager(fastpath)
    pools.add_pool(Pool(pool_id=1, network=int(net.network_address),
                        prefix_len=net.prefixlen, gateway=server_ip,
                        dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")],
                     sessions_nbuckets=256, sub_nat_nbuckets=64)
    server = DHCPServer(server_mac, server_ip, pools, fastpath_tables=fastpath)
    engine = Engine(fastpath, nat, batch_size=args.batch_size,
                    slow_path=server.handle_frame, device=device)
    fleet = None
    if args.workers > 1:
        from bng_tpu_torch.control.admission import AdmissionConfig
        from bng_tpu_torch.control.fleet import FleetSpec, SlowPathFleet

        # inline workers: deterministic, and the worker-stage histogram
        # still exercises the cross-worker merge path. A generous
        # deadline keeps compile-cold first batches from being shed.
        fleet = SlowPathFleet(
            FleetSpec.from_pool_manager(server_mac, server_ip, pools),
            n_workers=args.workers, pools=pools, mode="inline",
            admission=AdmissionConfig(inbox_capacity=max(512, 2 * args.batch_size),
                                      deadline_ms=60_000.0),
            table_sink=fastpath)
        engine.slow_path_batch = fleet.handle_batch
    target = engine
    if args.scheduler:
        from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler

        target = TieredScheduler(engine, SchedulerConfig(
            bulk_batch=args.batch_size, express_device_index=_express_index(engine.device)))

    recorder = FlightRecorder(RecorderConfig(out_dir=args.trace_dir))
    recorder.set_backend("gpu" if engine.device.type == "cuda" else "cpu")
    tracer = tele.Tracer(recorder=recorder, keep_events=1 << 14)

    def discover(mac, xid):
        p = dhcp_codec.build_request(mac, dhcp_codec.DISCOVER, xid=xid)
        return packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                                  p.encode().ljust(320, b"\x00"))

    def request(mac, offer_frame, xid):
        od = packets.decode(offer_frame)
        off = dhcp_codec.decode(od.payload)
        p = dhcp_codec.build_request(mac, dhcp_codec.REQUEST, xid=xid,
                                     requested_ip=off.yiaddr, server_id=od.src_ip)
        return packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                                  p.encode().ljust(320, b"\x00"))

    macs = [(0x02C0 << 32 | i).to_bytes(6, "big") for i in range(args.macs)]
    with tele.armed(tracer):
        for base in range(0, len(macs), args.batch_size):
            chunk = macs[base: base + args.batch_size]
            res = target.process([discover(m, 0x1000 + base + k) for k, m in enumerate(chunk)])
            offers = {i: f for i, f in res["slow"] if f is not None}
            offers.update({i: f for i, f in res.get("tx", [])})
            reqs = [request(m, offers[k], 0x2000 + base + k)
                    for k, m in enumerate(chunk) if k in offers]
            if reqs:
                target.process(reqs)
        # the renewal round: cached DISCOVERs answered on the device (the
        # trace shows the fast path next to the slow one)
        target.process([discover(m, 0x3000 + k) for k, m in enumerate(macs[: args.batch_size])])
        if hasattr(target, "flush"):
            target.flush()
    if fleet is not None:
        fleet.close()
    return tracer, recorder


def run_trace(args, device) -> int:
    """`trace status|dump|export`: the operator's verbs over the telemetry
    subsystem. `status` lists the flight dumps in the trace dir; `dump`
    runs a traced DORA exchange and writes a flight-recorder dump;
    `export --format chrome` writes the exchange's spans as Chrome-trace
    JSON (Perfetto, chrome://tracing) on a torch profiler trace's timebase
    (`--base-ns` takes that trace's `baseTimeNanoseconds`)."""
    from bng_tpu_torch.telemetry import chrome_trace, default_trace_dir

    if args.trace_cmd == "status":
        out_dir = args.trace_dir or default_trace_dir()
        dumps = []
        if os.path.isdir(out_dir):
            for name in sorted(os.listdir(out_dir)):
                if not name.startswith("flight-") or not name.endswith(".json"):
                    continue
                path = os.path.join(out_dir, name)
                entry = {"file": name, "bytes": os.path.getsize(path)}
                try:
                    with open(path) as f:
                        d = json.load(f)
                    entry.update(reason=d.get("reason"),
                                 backend=d.get("meta", {}).get("backend"),
                                 records=len(d.get("records", ())))
                except (OSError, ValueError):
                    entry["error"] = "unreadable"
                dumps.append(entry)
        print(json.dumps({"trace_dir": out_dir,
                          "armed_env": os.environ.get("BNG_TELEMETRY") == "1",
                          "dumps": dumps}, indent=2))
        return 0

    tracer, recorder = _trace_dora(args, resolve_device(device))
    if args.trace_cmd == "dump":
        path = recorder.dump("cli", "trace dump DORA exchange", path=args.out or None)
        if path is None:
            print("trace dump: write failed", file=sys.stderr)
            return 1
        print(json.dumps({"dump": path, "records": int(tracer.seq),
                          "stage_breakdown": tracer.breakdown()}, indent=2))
        return 0
    if args.format != "chrome":
        print(f"trace export: unknown format {args.format!r} (supported: chrome)",
              file=sys.stderr)
        return 2
    trace = chrome_trace(tracer, label="bng-tpu-torch DORA", base_ns=args.base_ns)
    out_path = args.out or os.path.join(args.trace_dir or default_trace_dir(),
                                        "dora-trace.json")
    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    n_x = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    print(json.dumps({"trace": out_path, "events": n_x,
                      "stages": sorted({e["name"] for e in trace["traceEvents"]
                                        if e.get("ph") == "X"})}, indent=2))
    return 0


def run_checkpoint(args, device) -> int:
    """`checkpoint save|restore|info` over the warm-restart store. save and
    restore build the app from the same flag surface as `run` (the
    snapshot must see the table geometry the running process uses); info
    only reads headers."""
    from bng_tpu_torch.control.statestore import CheckpointStore
    from bng_tpu_torch.runtime import checkpoint as ckpt_mod

    cfg = _config_from_args(args)
    if not cfg.checkpoint_dir:
        print("checkpoint: --checkpoint-dir is required", file=sys.stderr)
        return 2
    store = CheckpointStore(cfg.checkpoint_dir)
    if args.ckpt_cmd == "info":
        print(json.dumps([i._asdict() for i in store.list()], indent=2))
        return 0
    # the app itself runs no checkpointer: this command is the one that
    # saves and restores
    app = BNGApp(dataclasses.replace(cfg, checkpoint_dir=""), device=device)
    try:
        c = app.components
        if args.ckpt_cmd == "save":
            # a snapshot of THIS freshly built process, not of a daemon
            print("checkpoint save: snapshotting a freshly built app "
                  "(not any running process)", file=sys.stderr)
            t0 = time.perf_counter()
            ckpt = ckpt_mod.build_checkpoint(
                store.next_seq(), app.clock(), engine=c["engine"],
                scheduler=c.get("scheduler"), dhcp=c["dhcp"], node_id=cfg.node_id)
            path = store.save(ckpt)
            print(json.dumps({"path": str(path), "seq": ckpt.seq,
                              "bytes": path.stat().st_size,
                              "duration_s": round(time.perf_counter() - t0, 3)}))
            return 0
        if not store.has_checkpoints():
            print(f"checkpoint restore: no checkpoint in {cfg.checkpoint_dir}", file=sys.stderr)
            return 1
        try:
            snap, _path = store.load_latest()
            rows = ckpt_mod.restore_checkpoint(snap, engine=c["engine"], dhcp=c["dhcp"])
        except ckpt_mod.CheckpointError as e:
            print(f"checkpoint restore REJECTED: {e}", file=sys.stderr)
            return 1
        out = {"restored_rows": rows}
        if args.audit:
            # prove the hydrated authorities agree before the snapshot is
            # trusted to serve: rc 2 on any violation
            from bng_tpu_torch.chaos.invariants import audit_app

            report = audit_app(app)
            out["audit"] = report.to_dict()
            print(json.dumps(out, indent=2))
            if not report.ok:
                print("checkpoint restore --audit: invariant violations "
                      f"{report.violations_by_kind()} — refusing this snapshot",
                      file=sys.stderr)
                return 2
            return 0
        print(json.dumps(out, indent=2))
        return 0
    finally:
        app.close()


def run_ctl(args) -> int:
    """`ctl` — runtime control of a live `run` process over its
    --ctl-listen wire (control/opsctl.py): `fleet resize N`,
    `fleet rolling-restart`, `engine swap`, `status`. Prints the
    transition report; rc 0 on ok/noop, 1 on a rejected/failed/rolled-back
    transition, 2 when the process is unreachable."""
    from bng_tpu_torch.control.opsctl import ctl_request

    if args.ctl_cmd == "status":
        op, body = "status", None
    elif args.ctl_cmd == "fleet":
        if args.fleet_cmd == "resize":
            op, body = "fleet/resize", {"n": args.n}
        else:
            op, body = "fleet/rolling-restart", {}
    else:  # engine swap
        op, body = "engine/swap", {}
    try:
        _code, doc = ctl_request(args.ctl_addr, op, body)
    except OSError as e:  # URLError subclasses OSError
        print(f"ctl: cannot reach {args.ctl_addr}: {e}", file=sys.stderr)
        return 2
    print(json.dumps(doc, indent=2, sort_keys=True))
    if op == "status":
        return 0
    return 0 if doc.get("outcome") in ("ok", "noop") else 1


def run_chaos(args, device) -> int:
    """`chaos run|audit` — the fault-injection harness (chaos/): `run`
    executes the scripted scenario suite (plus an optional fault soak) on
    `device` and prints a bit-deterministic JSON report — two runs with
    one --seed emit identical bytes, on the card and on the CPU alike;
    `audit` builds the app from the normal run flags and proves the
    cross-authority invariants hold (rc 2 on any violation)."""
    if args.chaos_cmd == "audit":
        from bng_tpu_torch.chaos.invariants import audit_app

        app = BNGApp(_config_from_args(args), device=device)
        try:
            report = audit_app(app)
            print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
            return 0 if report.ok else 2
        finally:
            app.close()

    from bng_tpu_torch.chaos.runner import (bench_lines, canonical_json, run_report,
                                            scenario_catalog)

    if args.list:
        for name, desc in scenario_catalog():
            print(f"{name:<28} {desc}")
        return 0
    # metrics=None: the one-shot CLI run has no scrape endpoint to serve
    # the bng_chaos_* families from — the report IS the output
    names = [args.scenario] if args.scenario else None
    try:
        report = run_report(args.seed, names=names, soak_epochs=args.soak_epochs,
                            storm_scale=args.storm_scale, device=resolve_device(device))
    except ValueError as e:
        print(f"chaos run: {e}", file=sys.stderr)
        print("scenario catalog:", file=sys.stderr)
        for name, desc in scenario_catalog():
            print(f"  {name:<28} {desc}", file=sys.stderr)
        return 2
    text = canonical_json(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.bench_log:
        # diffable per-scenario lines; the wallclock/run_id/schema stamp
        # lives only in the appender (telemetry/ledger.py), never in the
        # compared report bytes
        from bng_tpu_torch.telemetry import ledger as ledger_mod

        try:
            for line in bench_lines(report):
                ledger_mod.append(args.bench_log, line)
        except OSError as e:
            print(f"chaos run: bench-log append failed: {e}", file=sys.stderr)
    print(text)
    return 0 if report["ok"] else 1


def serve(app: BNGApp) -> int:
    """The run loop: start the metrics collector and its /metrics
    endpoint, drive the ring when one exists, run the operator's queued
    transitions at the batch boundary, tick once a second. With a
    checkpointer, SIGTERM takes a final snapshot and returns 0: the
    handler only sets a flag, and the save runs on the loop thread
    between beats, never from signal context."""
    from bng_tpu_torch.control.opsctl import OpsServer

    collector = app.components.get("collector")
    if collector is not None:
        collector.start()
        port = collector.serve_http(app.config.metrics_port)
        print(f"metrics on :{port}/metrics", file=sys.stderr, flush=True)
    srv = app.components.get("cluster_server")
    if srv is not None:
        print(f"cluster on {srv.url}", file=sys.stderr, flush=True)
    if app.fleet_blockers:
        # the startup status must say it, not just a log line: the
        # configured worker count is not what is running
        print(f"slowpath fleet BLOCKED (single-worker): {','.join(app.fleet_blockers)} "
              f"not yet fleet-aware", file=sys.stderr)
    if app.sharded_blockers:
        print(f"sharded serving: {','.join(app.sharded_blockers)} disabled "
              f"(engine-path features)", file=sys.stderr)
    if app.config.shards > 1:
        print(f"sharded dataplane: {app.config.shards} shards (ring-steered owner batches)",
              file=sys.stderr, flush=True)
    ops = app.components["ops"]
    if app.config.ctl_listen:
        chost, _, cport = app.config.ctl_listen.rpartition(":")
        try:
            osrv = app.components["ops_server"] = OpsServer(
                ops, chost or "127.0.0.1", int(cport or 0)).start()
            app._on_close(osrv.close)
            print(f"ctl on {osrv.addr[0]}:{osrv.addr[1]}", file=sys.stderr, flush=True)
        except OSError as e:
            print(f"ctl listener unavailable ({e}); runtime ops disabled", file=sys.stderr)
    ckptr = app.components.get("checkpointer")
    stop_flag = {"sigterm": False}
    if ckptr is not None:
        import signal

        signal.signal(signal.SIGTERM, lambda *_: stop_flag.update(sigterm=True))
    has_ring = app.components.get("ring") is not None
    last_tick = 0.0
    ctx_enter("loop")  # sanitizer ownership context
    while True:
        if stop_flag["sigterm"]:
            with app._ctl:
                ckptr.save_now(reason="sigterm")
            return 0
        moved = app.drive_once()
        # operator transitions run here, at the batch boundary, on the
        # loop thread, never on the HTTP handler thread
        moved += ops.run_pending()
        now_t = time.time()
        if now_t - last_tick >= 1.0:
            last_tick = now_t
            app.tick(now_t)
        if moved == 0:
            time.sleep(0.001 if has_ring else 1.0)


def run_perf(args) -> int:
    """`perf gate|import` over the port's ledger (`telemetry/ledger.py`, the
    reference's `run_perf`; no torch import, runs cold in milliseconds).

    gate: robust per-stage trend regression detection for the newest
    ledger line against its last-K COMPARABLE predecessors (same metric +
    backend class + device kind + batch geometry — a `gpu` line is never
    scored against a TPU or CPU cohort). rc contract: 0 clean / 1
    regression (stderr names the stage) / 2 internal / 3 incomparable
    cohort.

    import: one-shot normalizer migrating pre-schema ledger lines to the
    current schema (schema_version 0 tag, stable legacy run_ids,
    best-effort env fingerprint from the `device` field)."""
    from bng_tpu_torch.telemetry import ledger as ledger_mod

    path = args.ledger or ledger_mod.default_ledger_path()
    if args.perf_cmd == "import":
        try:
            lines = ledger_mod.read(path)
        except OSError as e:
            print(f"perf import: cannot read {path}: {e}", file=sys.stderr)
            return 2
        migrated = ledger_mod.import_legacy(lines)
        n_legacy = sum(1 for ln in migrated if ln.get("schema_version") == 0)
        out_path = args.out
        if args.in_place:
            out_path = path
            backup = path + ".bak"
            import shutil

            shutil.copyfile(path, backup)
            print(f"perf import: backup at {backup}", file=sys.stderr)
        if not out_path:
            for ln in migrated:
                print(json.dumps(ln))
        else:
            with open(out_path, "w") as f:
                for ln in migrated:
                    f.write(json.dumps(ln) + "\n")
        print(f"perf import: {len(migrated)} lines "
              f"({n_legacy} tagged schema_version 0)"
              + (f" -> {out_path}" if out_path else " -> stdout"),
              file=sys.stderr)
        return 0

    # gate
    rep = ledger_mod.gate_file(
        path, last_k=args.last_k, min_cohort=args.min_cohort,
        include_legacy=not args.no_legacy, metric=args.metric)
    if args.json_out:
        print(json.dumps(rep.to_dict(), indent=2, sort_keys=True))
    else:
        print(rep.format_text())
    if rep.regressions:
        names = ", ".join(r["key"] for r in rep.regressions)
        print(f"perf gate: REGRESSION in {names}", file=sys.stderr)
    return rep.rc


def _express_index(device, bypassed: bool = False) -> int | None:
    """The scheduler's express card for an engine on `device`: the engine's
    own (-1) for a card named by index (`--device cuda:i`, one card) or for
    a scheduler the drive loop bypasses (`--wire-if`: the native ring runs
    the engine's fused loop, which wants the DHCP tables on the engine's
    card); else the scheduler's pick, the second visible card if any."""
    return -1 if device.index is not None or bypassed else None


def _add_run_flags(p: argparse.ArgumentParser) -> None:
    defaults = BNGConfig()
    for f in dataclasses.fields(BNGConfig):
        flag = "--" + f.name.replace("_", "-")
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument(flag, dest=f.name, default=None,
                           action=argparse.BooleanOptionalAction)
        elif isinstance(default, list):
            p.add_argument(flag, dest=f.name, default=None, nargs="*")
        else:
            p.add_argument(flag, dest=f.name, default=None,
                           type=type(default))
    p.add_argument("--config", dest="config_file", default="")


def _config_from_args(args) -> BNGConfig:
    cfg = BNGConfig()
    cli_set = set()
    for f in dataclasses.fields(BNGConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
            cli_set.add(f.name)
    if args.config_file:
        cfg = load_config_file(args.config_file, cli_set, cfg)
    return cfg


def _cluster_wave(coord, n_subs: int, chunk: int = 512) -> dict:
    """Drive a synthetic DORA wave through the cluster front door —
    the `cluster run --subscribers N` smoke traffic. Returns the
    wave verdict (leased / unique / shed) for the status output."""
    from bng_tpu_torch import frames as packets
    from bng_tpu_torch.control import dhcp_codec
    from bng_tpu_torch.loadtest.harness import StormFrameFactory

    fac = StormFrameFactory(coord.server_ip)
    macs = [(0x02D6 << 32 | i).to_bytes(6, "big") for i in range(n_subs)]
    leased: dict[bytes, int] = {}
    now = coord.clock()
    for ci in range(0, n_subs, chunk):
        cmacs = macs[ci:ci + chunk]
        out = coord.handle_batch(
            [(i, fac.discover(m, ci + i + 1)) for i, m in enumerate(cmacs)],
            now=now)
        offers: dict[bytes, int] = {}
        for (_l, rep), m in zip(out, cmacs):
            if rep is not None:
                p = dhcp_codec.decode(packets.decode(rep).payload)
                if p.msg_type == dhcp_codec.OFFER:
                    offers[m] = p.yiaddr
        req = [m for m in cmacs if m in offers]
        out = coord.handle_batch(
            [(i, fac.request(m, offers[m], 0x100000 + ci + i))
             for i, m in enumerate(req)], now=now)
        for (_l, rep), m in zip(out, req):
            if rep is not None:
                p = dhcp_codec.decode(packets.decode(rep).payload)
                if p.msg_type == dhcp_codec.ACK:
                    leased[m] = p.yiaddr
    return {"subscribers": n_subs, "leased": len(leased),
            "unique_ips": len(set(leased.values())),
            "shed": coord.shed_frames,
            "ok": (len(leased) == n_subs
                   and len(set(leased.values())) == n_subs)}


def _plan_summary(plan) -> dict:
    from bng_tpu_torch.utils.net import u32_to_ip

    return {
        "space": f"{u32_to_ip(plan.space_network)}/{plan.space_prefix_len}",
        "block_prefix_len": plan.block_prefix_len,
        "blocks": plan.n_blocks,
        "epoch": plan.epoch,
        "addresses": plan.total_addresses(),
        "members": {
            iid: {"blocks": [f"{u32_to_ip(b.network)}/{b.prefix_len}"
                             for b in p.blocks],
                  "addresses": p.addresses(),
                  "nat": [list(plan.nat_range(b)) for b in p.blocks]}
            for iid, p in sorted(plan.members.items())},
        "free_blocks": [f"{u32_to_ip(b.network)}/{b.prefix_len}"
                        for b in plan.free],
    }


def run_cluster(args) -> int:
    """`cluster run|status` — the cluster-of-BNGs front door
    (bng_tpu_torch/cluster), host code only: no instance builds an engine. `run` composes N instances behind one FNV-1a32
    steering door (inline in this process, or one child process per
    instance), optionally drives a synthetic DORA wave, and prints or
    serves the coordinator status + bng_cluster_* metrics; `status`
    reads the carve plan back out of a checkpoint (or a status file a
    `run` wrote) without building anything."""
    from bng_tpu_torch.utils.net import ip_to_u32

    if args.cluster_cmd == "status":
        if args.from_checkpoint:
            from bng_tpu_torch.cluster import ClusterPlan
            from bng_tpu_torch.runtime.checkpoint import (CheckpointError,
                                                    decode_checkpoint)

            try:
                with open(args.from_checkpoint, "rb") as f:
                    ckpt = decode_checkpoint(f.read())
            except (OSError, CheckpointError) as e:
                print(f"cluster status: {e}", file=sys.stderr)
                return 2
            comp = ckpt.meta.get("components", {}).get("cluster_plan")
            if not comp:
                print("cluster status: checkpoint carries no "
                      "cluster_plan component", file=sys.stderr)
                return 1
            try:
                plan = ClusterPlan.from_dict(comp)
            except (KeyError, TypeError, ValueError) as e:
                print(f"cluster status: corrupt carve plan: {e!r}",
                      file=sys.stderr)
                return 2
            print(json.dumps(_plan_summary(plan), indent=2,
                             sort_keys=True))
            return 0
        if args.status_file:
            try:
                with open(args.status_file) as f:
                    print(f.read().rstrip())
            except OSError as e:
                print(f"cluster status: {e}", file=sys.stderr)
                return 2
            return 0
        print("cluster status: --from-checkpoint or --status-file "
              "required (a live `cluster run` writes the latter)",
              file=sys.stderr)
        return 2

    # -- cluster join ------------------------------------------------
    # run this box as a FULL SERVING MEMBER of a remote coordinator's
    # carve: announce with capped-backoff retries, hydrate
    # the carved blocks from the coordinator's handoff stream, bring up
    # a local fleet+engine stack, serve steered batches over the
    # fabric, and ship lease/HA deltas back on every reply
    if args.join:
        import socket as _socket

        from bng_tpu_torch.cluster.coordinator import DEFAULT_FABRIC_PSK
        from bng_tpu_torch.cluster.fabric import UDPTransport
        from bng_tpu_torch.cluster.member import MemberRuntime
        from bng_tpu_torch.control.deviceauth import PSKAuthenticator
        from bng_tpu_torch.control.metrics import BNGMetrics

        host_s, _, port_s = args.join.rpartition(":")
        try:
            hub = (host_s or "127.0.0.1", int(port_s))
        except ValueError:
            print(f"cluster run: bad --join {args.join!r} "
                  f"(want HOST:PORT)", file=sys.stderr)
            return 2
        hostname = _socket.gethostname()
        node_id = args.node_id or f"bng-{hostname}"
        ep = UDPTransport(node_id, PSKAuthenticator(
            psk=args.fabric_psk or DEFAULT_FABRIC_PSK))
        ep.add_peer("coordinator", hub)
        member = MemberRuntime(
            ep, node_id, hostname,
            join_deadline_s=args.join_deadline,
            log=lambda m: print(m, file=sys.stderr))
        metrics = BNGMetrics()
        print(f"cluster join: {node_id} (host {hostname}) -> "
              f"{hub[0]}:{hub[1]}", file=sys.stderr)
        last_state = member.state
        ticks = 0
        try:
            while True:
                member.tick()
                st = member.status()
                metrics.record_member(st)
                if member.state != last_state:
                    print(f"cluster join: {last_state} -> "
                          f"{member.state} (epoch {member.epoch}, "
                          f"{member.join_retries} retries)",
                          file=sys.stderr)
                    last_state = member.state
                if member.state == "gave_up":
                    return 1
                ticks += 1
                if args.once and (member.state == "serving"
                                  or ticks >= 3):
                    print(json.dumps(st, indent=2, sort_keys=True,
                                     default=str))
                    return 0 if member.state == "serving" else 1
                if args.status_file and ticks % 10 == 0:
                    with open(args.status_file, "w") as f:
                        f.write(json.dumps(st, indent=2, sort_keys=True,
                                           default=str) + "\n")
                time.sleep(0.05)
        except KeyboardInterrupt:
            return 0
        finally:
            member.close()

    # -- cluster run -------------------------------------------------
    from bng_tpu_torch.cluster import ClusterCoordinator
    from bng_tpu_torch.control.metrics import BNGMetrics

    net_s, _, plen_s = args.space.partition("/")
    try:
        space_net, space_plen = ip_to_u32(net_s), int(plen_s or "10")
    except (OSError, ValueError) as e:
        print(f"cluster run: bad --space {args.space!r}: {e}",
              file=sys.stderr)
        return 2
    fabric_bind: tuple = ("127.0.0.1", 0)
    if args.listen:
        lh, _, lp = args.listen.rpartition(":")
        try:
            fabric_bind = (lh or "127.0.0.1", int(lp))
        except ValueError:
            print(f"cluster run: bad --listen {args.listen!r} "
                  f"(want HOST:PORT)", file=sys.stderr)
            return 2
    # the fabric lane rides --listen or process mode (process members
    # beat over UDP; inline members stay on the in-process oracle
    # unless a hub address asks for remote joiners)
    use_fabric = bool(args.listen) or args.mode == "process"
    coord = ClusterCoordinator(
        mode=args.mode, space_network=space_net,
        space_prefix_len=space_plen,
        nat_base=ip_to_u32(args.nat_base) if args.nat_base else 0,
        nat_total=args.nat_total, n_workers=args.workers,
        sub_nbuckets=args.sub_nbuckets,
        fabric=use_fabric, fabric_psk=args.fabric_psk,
        fabric_bind=fabric_bind)
    if use_fabric and coord.fabric_transport is not None:
        fa = coord.fabric_transport.addr
        print(f"cluster fabric: listening on {fa[0]}:{fa[1]}",
              file=sys.stderr)
    metrics = BNGMetrics()
    expected_remotes: dict = {}
    for spec_s in (args.expect_remote or ()):
        iid, _, rhost = spec_s.partition("=")
        if not iid:
            print(f"cluster run: bad --expect-remote {spec_s!r} "
                  f"(want ID=HOST)", file=sys.stderr)
            return 2
        expected_remotes[iid] = rhost or iid
    try:
        coord.add_instances([f"bng-{i:02d}" for i in range(args.instances)],
                            remotes=expected_remotes)
        out: dict = {}
        if args.subscribers:
            out["wave"] = _cluster_wave(coord, args.subscribers)
        status = coord.status()
        metrics.record_cluster(status)
        out["status"] = status
        if args.checkpoint_out:
            from bng_tpu_torch.runtime.checkpoint import (build_checkpoint,
                                                    encode_checkpoint)

            ckpt = build_checkpoint(1, time.time(), cluster_plan=coord)
            with open(args.checkpoint_out, "wb") as f:
                f.write(encode_checkpoint(ckpt))
            out["checkpoint"] = args.checkpoint_out
        text = json.dumps(out, indent=2, sort_keys=True, default=str)
        if args.status_file:
            with open(args.status_file, "w") as f:
                f.write(text + "\n")
        print(text)
        if args.once:
            wave = out.get("wave")
            return 0 if (wave is None or wave["ok"]) else 1
        # serve: the HA/membership machinery ticks at 1 Hz (the same
        # cadence App.tick gives a single instance) until interrupted
        print(f"cluster serving: {args.instances} instances "
              f"({args.mode}); ^C to stop", file=sys.stderr)
        # with a fabric the tick must outpace the membership beats and
        # the handoff retransmit timer; without one, 1 Hz (App.tick's
        # cadence for a single instance) is plenty
        tick_s = 0.1 if use_fabric else 1.0
        try:
            last_status = 0.0
            while True:
                time.sleep(tick_s)
                coord.tick()
                if time.time() - last_status >= 1.0:
                    last_status = time.time()
                    status = coord.status()
                    metrics.record_cluster(status)
                    if args.status_file:
                        with open(args.status_file, "w") as f:
                            f.write(json.dumps(status, indent=2,
                                               sort_keys=True,
                                               default=str) + "\n")
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        coord.close()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="bng-tpu-torch", description="BNG dataplane on an NVIDIA GPU (PyTorch/CUDA)")
    parser.add_argument("--device", default=None,
                        help="where to run: the card (the default; --shards N spreads over "
                             "every visible card and the scheduler's express lane takes the "
                             "second), one card for everything (cuda:i) or cpu")
    sub = parser.add_subparsers(dest="command")

    runp = sub.add_parser("run", help="run the BNG")
    _add_run_flags(runp)
    runp.add_argument("--once", action="store_true",
                      help="build everything, print stats, exit (smoke mode)")

    statsp = sub.add_parser("stats", help="print stats for a built app")
    _add_run_flags(statsp)

    loadp = sub.add_parser("loadtest", help="DHCP load test against the "
                           "device pipeline + slow path")
    loadp.add_argument("--duration", type=float, default=10.0,
                       help="measured duration, seconds")
    loadp.add_argument("--warmup", type=float, default=1.0,
                       help="warmup duration, seconds (excluded)")
    loadp.add_argument("--batch-size", type=int, default=256,
                       help="lanes per device batch (the concurrency knob)")
    loadp.add_argument("--macs", type=int, default=10_000,
                       help="unique MAC cardinality (steers fast/slow split)")
    loadp.add_argument("--rps", type=int, default=0,
                       help="target requests/sec (0 = unlimited)")
    loadp.add_argument("--renewals", default=True, action=argparse.BooleanOptionalAction)
    loadp.add_argument("--renewal-ratio", type=float, default=0.8)
    loadp.add_argument("--pool-cidr", default="10.0.0.0/16")
    loadp.add_argument("--json", action="store_true", dest="json_out")
    loadp.add_argument("--validate", action="store_true",
                       help="exit non-zero if performance targets not met")
    loadp.add_argument("--scheduler", action="store_true",
                       help="drive the latency-tiered scheduler instead of "
                            "the engine's batch interface")
    loadp.add_argument("--bench-log", default="",
                       help="append a schema'd perf-ledger line (env: the card, "
                            "its power limit, the probe route) to this jsonl file")
    loadp.add_argument("--workers", type=int, default=1,
                       help="slow-path fleet worker count (>1 fans DHCPv4 slow lanes "
                            "across worker processes)")
    loadp.add_argument("--fleet-mode", default="process", choices=("process", "inline"),
                       help="fleet execution mode (inline = deterministic, "
                            "process = parallel)")
    loadp.add_argument("--wire", nargs="?", const="mem", default=None, metavar="IFNAME",
                       help="drive batches through the full wire loop (kernel rings -> "
                            "WirePump -> UMEM ring -> engine -> wire) instead of the engine "
                            "batch interface; bare --wire runs the memory-rung SimKernel "
                            "loopback, --wire IFNAME walks the real AF_XDP attach ladder")
    loadp.add_argument("--wire-pump", default="", choices=("", "scalar", "vector"),
                       help="wire pump implementation (default: BNG_WIRE_PUMP, scalar)")
    loadp.add_argument("--wire-peer", default="",
                       help="far-end interface for a live --wire rung (veth peer to "
                            "inject/collect on)")
    loadp.add_argument("--trace", action="store_true",
                       help="arm the span tracer: the report gains the per-stage "
                            "latency breakdown and its SLO verdict")

    tracep = sub.add_parser("trace", help="telemetry: flight-recorder status/dumps and "
                            "Chrome-trace export of a traced DORA exchange")
    trace_sub = tracep.add_subparsers(dest="trace_cmd", required=True)
    for verb, hlp in (("status", "list flight-recorder dumps in the trace dir"),
                      ("dump", "run a traced DORA exchange and write a flight-recorder dump"),
                      ("export", "run a traced DORA exchange and export its spans "
                                 "(--format chrome loads in Perfetto / chrome://tracing)")):
        vp = trace_sub.add_parser(verb, help=hlp)
        vp.add_argument("--trace-dir", default="",
                        help="flight-dump dir (default $BNG_TRACE_DIR or <tmp>/bng-flightrec)")
        if verb == "status":
            continue
        vp.add_argument("--out", default="", help="output file path")
        vp.add_argument("--format", default="chrome", help="export format (chrome)")
        vp.add_argument("--macs", type=int, default=32,
                        help="subscribers to DORA through the trace")
        vp.add_argument("--batch-size", type=int, default=64)
        vp.add_argument("--pool-cidr", default="10.0.0.0/16")
        vp.add_argument("--scheduler", action="store_true",
                        help="drive the tiered scheduler (express/bulk lanes appear as "
                             "trace threads)")
        vp.add_argument("--workers", type=int, default=1,
                        help="inline fleet workers (>1 adds the worker stage to the trace)")
        if verb == "export":
            vp.add_argument("--base-ns", type=int, default=None,
                            help="the trace's baseTimeNanoseconds: a torch profiler "
                                 "trace's, so both files' ts agree (default: the first "
                                 "span's wall-clock second)")

    ckptp = sub.add_parser("checkpoint", help="save/restore/inspect warm-restart "
                                              "snapshots of the device tables")
    ckpt_sub = ckptp.add_subparsers(dest="ckpt_cmd", required=True)
    for verb, hlp in (("save", "build a fresh app and snapshot it"),
                      ("restore", "build the app, hydrate from the latest "
                                  "checkpoint, report row counts"),
                      ("info", "list checkpoints in --checkpoint-dir "
                               "(header-only; flags corrupt files)")):
        vp = ckpt_sub.add_parser(verb, help=hlp)
        _add_run_flags(vp)
        if verb == "restore":
            vp.add_argument("--audit", action="store_true",
                            help="run the invariant auditor after hydration; "
                                 "exit rc=2 on any violation")

    chaosp = sub.add_parser("chaos", help="fault-injection scenarios and "
                                          "cross-authority invariant audits")
    chaos_sub = chaosp.add_subparsers(dest="chaos_cmd", required=True)
    crun = chaos_sub.add_parser(
        "run", help="run the scripted chaos scenarios (+ optional fault soak); "
                    "deterministic JSON report, rc 1 on failure")
    crun.add_argument("--device", default=argparse.SUPPRESS,
                      help="where the scenarios build device state: the card (the "
                           "default) or cpu")
    crun.add_argument("--seed", type=int, default=1,
                      help="fault-schedule seed; same seed -> identical schedules and "
                           "byte-identical report")
    crun.add_argument("--scenario", default="",
                      help="run one scenario by name (default: every ported one)")
    crun.add_argument("--soak-epochs", type=int, default=0,
                      help="also run the seeded fault soak for N epochs "
                           "(traffic + generated faults + audit/epoch)")
    crun.add_argument("--out", default="", help="also write the report JSON to this file")
    crun.add_argument("--list", action="store_true",
                      help="print the scenario catalog (one line each) and exit")
    crun.add_argument("--storm-scale", type=float, default=1.0,
                      help="scale factor for the storm scenarios' subscriber counts "
                           "(1.0 = the published storms: flash crowd at 100k)")
    crun.add_argument("--bench-log", default="",
                      help="append one diffable line per scenario "
                           "(scenario/shed/degraded) to this jsonl file")
    caud = chaos_sub.add_parser(
        "audit", help="build the app from run flags and audit the state authorities; "
                      "rc 2 on any violation")
    _add_run_flags(caud)

    # cluster-of-BNGs front door (bng_tpu_torch/cluster)
    clup = sub.add_parser(
        "cluster", help="compose N BNG instances into one cluster: "
                        "disjoint pool carve, HA standbys, FNV-1a32 "
                        "MAC steering (bng_tpu_torch/cluster)")
    clu_sub = clup.add_subparsers(dest="cluster_cmd", required=True)
    clrun = clu_sub.add_parser(
        "run", help="carve the space, build the instances and serve "
                    "(or --once: print status and exit)")
    clrun.add_argument("--instances", type=int, default=4,
                       help="founding member count (default 4)")
    clrun.add_argument("--mode", choices=("inline", "process"),
                       default="inline",
                       help="inline = all instances in this process "
                            "(deterministic); process = one child per "
                            "instance")
    clrun.add_argument("--space", default="10.0.0.0/10",
                       help="cluster address space CIDR to carve "
                            "(default 10.0.0.0/10)")
    clrun.add_argument("--nat-base", default="",
                       help="first NAT public IP (block index maps to "
                            "NAT slice; default: no NAT ranges)")
    clrun.add_argument("--nat-total", type=int, default=0,
                       help="NAT public IP count across the space")
    clrun.add_argument("--workers", type=int, default=1,
                       help="slow-path workers per instance")
    clrun.add_argument("--sub-nbuckets", type=int, default=0,
                       help="per-instance fast-path subscriber buckets "
                            "(0 = slow-path only)")
    clrun.add_argument("--subscribers", type=int, default=0,
                       help="drive a synthetic DORA wave of N "
                            "subscribers through the front door")
    clrun.add_argument("--once", action="store_true",
                       help="print status (+ wave verdict) and exit "
                            "instead of serving")
    clrun.add_argument("--status-file", default="",
                       help="write status JSON here (refreshed each "
                            "tick while serving)")
    clrun.add_argument("--checkpoint-out", default="",
                       help="write a checkpoint carrying the carve "
                            "plan to this file")
    # the cluster control fabric (UDP membership lane)
    clrun.add_argument("--listen", default="",
                       help="HOST:PORT for the fabric hub: process "
                            "members beat here over authenticated UDP "
                            "and remote `--join`ers announce themselves "
                            "(process mode; port 0 = ephemeral)")
    clrun.add_argument("--join", default="",
                       help="HOST:PORT of a running coordinator's "
                            "--listen: join its carve as a full remote "
                            "serving member — hydrate the carved blocks "
                            "over the fabric handoff stream and serve "
                            "them from this box")
    clrun.add_argument("--join-deadline", type=float, default=60.0,
                       help="give up the join (capped-backoff retries) "
                            "after this many seconds (default 60)")
    clrun.add_argument("--expect-remote", action="append", default=[],
                       metavar="ID=HOST",
                       help="declare a remote member slot in the "
                            "founding carve (repeatable): blocks deal "
                            "to it on the host axis now, and the slot "
                            "comes alive when that box --join's")
    clrun.add_argument("--fabric-psk", default="",
                       help="pre-shared key authenticating fabric "
                            "datagrams (>=16 chars; default: the dev "
                            "PSK — set your own off-box)")
    clrun.add_argument("--node-id", default="",
                       help="member id to announce when --join'ing "
                            "(default bng-<hostname>)")
    clstat = clu_sub.add_parser(
        "status", help="print cluster status: the carve plan from a "
                       "checkpoint, or a status file a run wrote")
    clstat.add_argument("--from-checkpoint", default="",
                        help="read the carve plan out of this "
                             "checkpoint file")
    clstat.add_argument("--status-file", default="",
                        help="print the status JSON a `cluster run "
                             "--status-file` wrote")

    ctlp = sub.add_parser("ctl", help="zero-downtime ops on a live `run` process "
                                      "(fleet resize / rolling restart / engine swap)")
    ctlp.add_argument("--ctl-addr", default="127.0.0.1:9092",
                      help="the live process's --ctl-listen address")
    ctl_sub = ctlp.add_subparsers(dest="ctl_cmd", required=True)
    ctl_sub.add_parser("status", help="what a transition would act on")
    cfp = ctl_sub.add_parser("fleet", help="slow-path fleet transitions")
    cf_sub = cfp.add_subparsers(dest="fleet_cmd", required=True)
    rzp = cf_sub.add_parser("resize", help="grow/shrink the fleet live — re-carves lease "
                                           "slices and re-shards books without dropping "
                                           "in-flight DORAs")
    rzp.add_argument("n", type=int, help="target worker count")
    cf_sub.add_parser("rolling-restart", help="replace workers one shard at a time "
                                              "(drain-then-transfer per shard)")
    cep = ctl_sub.add_parser("engine", help="engine transitions")
    ce_sub = cep.add_subparsers(dest="engine_cmd", required=True)
    ce_sub.add_parser("swap", help="blue/green engine swap: snapshot-hydrated standby + "
                                   "delta replay + audited atomic flip (rollback on failure)")

    # perf ledger + regression gate (telemetry/ledger.py)
    perfp = sub.add_parser(
        "perf", help="perf-regression ledger over bench_runs.jsonl: "
                     "schema import + per-stage trend gate")
    perf_sub = perfp.add_subparsers(dest="perf_cmd", required=True)
    pgate = perf_sub.add_parser(
        "gate", help="gate the newest ledger line against its last-K "
                     "comparable runs (median/MAD per stage); rc: 0 "
                     "clean / 1 regression / 2 internal / 3 "
                     "incomparable-cohort")
    pgate.add_argument("--ledger", default="",
                       help="ledger path (default $BNG_BENCH_LOG or the "
                            "repo's bench_runs.jsonl)")
    pgate.add_argument("--metric", default="",
                       help="gate the newest line of this metric only")
    pgate.add_argument("--last-k", type=int, default=8,
                       help="cohort depth: compare against the last K "
                            "comparable runs")
    pgate.add_argument("--min-cohort", type=int, default=3,
                       help="minimum comparable history before the "
                            "trend gate claims anything")
    pgate.add_argument("--no-legacy", action="store_true",
                       help="exclude schema_version<1 (pre-schema) "
                            "lines from cohorts")
    pgate.add_argument("--json", action="store_true", dest="json_out")
    pimp = perf_sub.add_parser(
        "import", help="one-shot normalizer: migrate pre-schema ledger "
                       "lines to the current schema (schema_version 0 "
                       "tag, legacy run_ids, env from `device`)")
    pimp.add_argument("--ledger", default="",
                      help="ledger path (default $BNG_BENCH_LOG or the "
                           "repo's bench_runs.jsonl)")
    pimp.add_argument("--out", default="",
                      help="write migrated lines here (default stdout)")
    pimp.add_argument("--in-place", action="store_true",
                      help="rewrite the ledger in place (backup at "
                           "<ledger>.bak)")

    checkp = sub.add_parser(
        "check", help="bngcheck: dataplane-invariant static analyzer "
                      "over the port (rc=1 on any non-baselined finding)")
    from bng_tpu_torch.analysis.cli import add_check_args, run_check
    add_check_args(checkp)

    demop = sub.add_parser("demo", help="device-free lifecycle demo")
    demop.add_argument("--subscribers", type=int, default=3)

    sub.add_parser("version", help="print version")

    args = parser.parse_args(argv)

    if args.command == "version":
        print(f"bng-tpu-torch {__version__}")
        return 0
    if args.command == "check":
        return run_check(args)
    if args.command == "demo":
        run_demo(args.subscribers)
        return 0
    if args.command == "perf":
        return run_perf(args)
    try:
        if args.command == "loadtest":
            return run_loadtest(args, resolve_device(args.device))
        if args.command == "checkpoint":
            return run_checkpoint(args, args.device)
        if args.command == "trace":
            return run_trace(args, args.device)
        if args.command == "chaos":
            return run_chaos(args, args.device)
        if args.command == "cluster":
            return run_cluster(args)
        if args.command == "ctl":
            return run_ctl(args)
        if args.command in ("run", "stats"):
            app = BNGApp(_config_from_args(args), device=args.device)
            try:
                if args.command == "stats" or args.once:
                    print(json.dumps(app.stats(), indent=2, default=str))
                    return 0
                return serve(app)
            except KeyboardInterrupt:
                return 0
            finally:
                app.close()
    except (NoCardError, UnservableConfigError) as e:
        print(f"bng-tpu-torch: {e}", file=sys.stderr)
        return 2
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
