"""Composition root + CLI of the port: run / stats / loadtest / checkpoint /
version (port of `bng_tpu/cli.py` at the serving stack's scope).

`BNGConfig` is the reference's flag surface, field for field, with the
same YAML overlay where the command line wins (`load_config_file`).
`BNGApp` builds what the reference's `run` builds for the subsystems the
port has: the fast-path tables, pools, the RADIUS client with its
authenticator and accounting, NAT with its compliance logger, QoS,
antispoof, the walled garden (host manager and device gate), the DHCP
server and the engine on the card (with the PPPoE session tables when
PPPoE is on), the tiered scheduler when asked, the DHCPv6 and SLAAC
servers, the PPPoE server, the slow-path demux over them, the CoA
listener, the packet ring with a memory-rung wire attachment for the
synthetic source, routing, Nexus, subscribers, policies and the ops
controller. A config that turns on a subsystem the port lacks
(`UNPORTED`) is refused at construction with one error naming each one
and the flag that turns it off; nothing degrades silently. The
reference's defaults turn on metrics, so a bare `run` refuses; the
working line is

    python -m bng_tpu_torch run --once --no-metrics-enabled

Everything runs on the card unless `--device cpu` (or `device="cpu"`)
asks for the CPU; with no card and no such request the entry points
raise (`utils/devenv.resolve_device`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import threading
import time

from bng_tpu_torch.analysis.sanitize import ctx_enter, owned_by
from bng_tpu_torch.utils.devenv import NoCardError, resolve_device

__version__ = "0.1.0"


@dataclasses.dataclass
class BNGConfig:
    """Flattened flag surface: the reference's `BNGConfig`, the same fields
    and defaults. A field that turns on a subsystem the port lacks
    (`UNPORTED`) makes `BNGApp` refuse to build."""

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


# The subsystems `run` can turn on that the port does not have yet:
# (is it on?, what it is, the flag that turns it off).
UNPORTED = (
    (lambda c: c.metrics_enabled, "metrics", "--no-metrics-enabled"),
    (lambda c: bool(c.ha_role), "HA pair", "--ha-role ''"),
    (lambda c: bool(c.cluster_listen) or c.store_mode != "memory" or bool(c.store_peers),
     "cluster listener and replicated store",
     "--cluster-listen '' --store-mode memory --store-peers"),
    (lambda c: c.slowpath_workers > 1, "slow-path fleet", "--slowpath-workers 1"),
    (lambda c: bool(c.wire_if), "AF_XDP wire", "--wire-if ''"),
    (lambda c: c.shards > 1, "sharded serving", "--shards 1"),
    (lambda c: c.telemetry_enabled, "telemetry and SLO monitor", "--no-telemetry-enabled"),
    (lambda c: bool(c.checkpoint_dir), "checkpointer (restore at start, periodic snapshots)",
     "--checkpoint-dir '' (the checkpoint command saves and restores)"),
    (lambda c: c.dns_enabled, "DNS listener", "--no-dns-enabled"),
    (lambda c: c.bgp_enabled, "BGP", "--no-bgp-enabled"),
    (lambda c: bool(c.nexus_url), "Nexus allocator", "--nexus-url ''"),
    (lambda c: bool(c.peer_pool_cidr and c.peer_pool_nodes), "peer pool", "--peer-pool-cidr ''"),
    (lambda c: c.device_auth_method != "none", "device authentication",
     "--device-auth-method none"),
)


class UnportedSubsystemError(ValueError):
    """The config turns on subsystems the port does not have."""


def unported(cfg: BNGConfig) -> list[tuple[str, str]]:
    """(subsystem, flag that turns it off) for each unported subsystem the
    config turns on."""
    return [(what, flag) for on, what, flag in UNPORTED if on(cfg)]


def check_ported(cfg: BNGConfig) -> None:
    missing = unported(cfg)
    if missing:
        raise UnportedSubsystemError(
            "bng_tpu_torch does not have these subsystems yet: "
            + "; ".join(f"{what} (turn off with {flag})" for what, flag in missing))


@dataclasses.dataclass
class WireAttachment:
    """The attach ladder's result (the reference's `runtime/xsk.py`): the
    port has no AF_XDP, so the ring always serves on the memory rung."""

    mode: str
    xsk: object
    detail: str = ""


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
        check_ported(config)
        self.device = resolve_device(device)
        self.config = config
        self.clock = clock
        self._cleanup = []
        self._last_expire = 0.0
        self._last_garden = 0.0
        self._last_acct_sync = 0.0
        self._last_acct_retry = 0.0
        # serializes the CoA listener thread's actions against the loop's
        # slow path and maintenance sweeps
        self._ctl = threading.Lock()
        self._syn_i = 0
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
        from bng_tpu_torch.utils.structlog import get_logger

        cfg = self.config
        c = self.components
        logging.getLogger("bng").setLevel(getattr(logging, cfg.log_level.upper(), logging.INFO))
        self.log = get_logger("app", node_id=cfg.node_id)

        # 1. device tables
        fastpath = c["fastpath"] = FastPathTables()
        fastpath.set_server_config(parse_mac(cfg.server_mac), ip_to_u32(cfg.server_ip))

        # 2. antispoof + walled garden
        c["antispoof"] = AntispoofTables()
        if cfg.walled_garden_enabled:
            garden = c["walledgarden"] = wg.WalledGardenManager(
                wg.WalledGardenConfig(portal_ip=cfg.portal_ip, portal_port=cfg.portal_port),
                clock=self.clock)
            self._on_close(lambda: garden.check_expired())

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

        # 5. RADIUS client and the DHCP authenticator
        authenticator = None
        if cfg.radius_server:
            from bng_tpu_torch.control.radius.client import RadiusClient, RadiusServerConfig

            secret = resolve_secret(cfg.radius_secret, cfg.radius_secret_file)
            host, _, port = cfg.radius_server.partition(":")
            radius = c["radius"] = RadiusClient(servers=[RadiusServerConfig(
                host=host, auth_port=int(port or 1812), secret=secret.encode())])

            def authenticator(username="", password="", mac=b"", circuit_id=b"", **kw):
                """A RADIUS Access-Request per new subscriber: the profile
                on an Accept, None on a Reject or when every server timed
                out. The reference serves a timeout from its resilience
                manager's cached profile; that manager comes with the
                Nexus allocator, which the port refuses, so a timeout
                refuses here."""
                res = radius.authenticate(username, password, mac=mac, circuit_id=circuit_id)
                if res is None or not res.success:
                    return None
                # the keys DHCPServer._request consumes: qos_policy (Filter-Id)
                # and lease_time (Session-Timeout caps the lease)
                profile = {"qos_policy": res.policy_name, "framed_ip": res.framed_ip,
                           **res.attributes}
                if res.session_timeout:
                    profile["lease_time"] = res.session_timeout
                return profile

        # 6. QoS
        qos = c["qos"] = QoSTables()
        policies = c["policies"] = PolicyManager()
        qos_hook = None
        if cfg.qos_enabled:
            def qos_hook(ip, policy_name):
                p = policies.get(policy_name or cfg.default_policy)
                if p is not None:
                    qos.set_subscriber(ip, p.download_bps, p.upload_bps, priority=p.priority)

        # 7. NAT + compliance logger
        nat_hook = None
        if cfg.nat_enabled:
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
            pool_manager=pool_mgr, fastpath_tables=fastpath, authenticator=authenticator,
            qos_hook=qos_hook, nat_hook=nat_hook, clock=self.clock,
            lease_jitter_frac=cfg.lease_jitter_frac)
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
        # compile in only when the walled garden and PPPoE are enabled
        pppoe_tables = None
        if cfg.pppoe_enabled:
            pppoe_tables = c["pppoe_tables"] = PPPoEFastPathTables(
                server_mac=parse_mac(cfg.server_mac))
        c["engine"] = Engine(
            fastpath=fastpath, nat=nat, qos=qos, antispoof=c["antispoof"],
            garden=GardenTables() if cfg.walled_garden_enabled else None, pppoe=pppoe_tables,
            batch_size=cfg.batch_size, slow_path=dhcp.handle_frame, clock=self.clock,
            device=self.device)
        self.log.info("engine built", batch_size=cfg.batch_size, device=str(self.device),
                      nat=cfg.nat_enabled, qos=cfg.qos_enabled)

        # 9a. the tiered scheduler over the engine's programs
        if cfg.scheduler_enabled:
            from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler

            c["scheduler"] = TieredScheduler(c["engine"], SchedulerConfig(
                express_batch=cfg.sched_express_batch,
                express_max_wait_us=cfg.sched_express_max_wait_us,
                express_aot=cfg.sched_express_aot,
                bulk_batch=cfg.batch_size,
                bulk_depth=cfg.sched_bulk_depth,
                drain_every=cfg.sched_drain_every), clock=self.clock)
            self.log.info("scheduler built", express_batch=cfg.sched_express_batch,
                          express_aot=cfg.sched_express_aot, bulk_depth=cfg.sched_bulk_depth)

        # 9b. walled-garden enforcement: one MAC-state feed drives the
        # device gate. Only explicit garden membership drops on the device
        # (UNKNOWN stays unenforced); the state maps to the lease IP at
        # each garden transition and each lease event.
        if cfg.walled_garden_enabled:
            from bng_tpu_torch.control.walledgarden import SubscriberState

            garden = c["walledgarden"]
            gt = c["engine"].garden
            gt.allow_destination(ip_to_u32(cfg.portal_ip), 0, 6)
            dns_ips = {cfg.dns_primary, cfg.dns_secondary, *garden.config.allowed_dns}
            for spec in pool_specs:
                if isinstance(spec, dict):
                    dns_ips |= {spec.get("dns_primary", ""), spec.get("dns_secondary", "")}
            for d in sorted(d for d in dns_ips if d):
                gt.allow_destination(ip_to_u32(d), 53, 0)

            def _apply_garden_ip(state, ip_u32, _gt=gt):
                _gt.set_gardened(ip_u32, state in (
                    SubscriberState.WALLED_GARDEN, SubscriberState.BLOCKED))

            def _garden_sync(mac_u64, state, _dhcp=dhcp):
                lease = _dhcp.leases.get(mac_u64)
                if lease is not None:
                    _apply_garden_ip(state, lease.ip)

            garden.on_state_change(_garden_sync)
            prev_acct = dhcp.accounting_hook

            def _lease_sync(event, lease, sid, _garden=garden, _gt=gt):
                if prev_acct is not None:
                    prev_acct(event, lease, sid)
                if event in ("start", "renew"):
                    _apply_garden_ip(_garden.get_subscriber_state(lease.mac), lease.ip)
                elif event == "stop":
                    _gt.set_gardened(lease.ip, False)

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
            c["engine"].slow_path = demux

        # 10d. the CoA/Disconnect listener (RFC 5176), over the DHCP leases
        # and the PPPoE sessions
        if cfg.radius_server and cfg.coa_enabled:
            self._build_coa(qos_hook)

        # 11c. the packet ring, for the synthetic source: the memory rung of
        # the attach ladder (the scheduler consumes frames through rx_pop,
        # which only PyRing has, so it takes the Python ring)
        if cfg.synthetic_subs:
            from bng_tpu_torch.runtime.ring import make_ring

            ring = c["ring"] = make_ring(frame_size=2048, prefer_native="scheduler" not in c)
            att = c["wire_attachment"] = WireAttachment("memory", None, "no interface requested")
            self.log.info("wire attach", mode=att.mode, interface="(none)", detail=att.detail)
            self._on_close(ring.close)
            self._on_close(lambda: c["engine"].flush_pipeline())

        # 12. routing
        if cfg.routing_platform == "linux":
            c["routing"] = RoutingManager(platform=IPRoute2Platform())
            self.log.info("routing platform", kind="linux-iproute2")
        elif cfg.routing_platform == "stub":
            c["routing"] = RoutingManager(platform=StubPlatform())
        else:  # a typo must not silently disable multi-ISP routing
            raise ValueError(f"routing_platform={cfg.routing_platform!r}: "
                             f"expected 'stub' or 'linux'")

        # 15. zero-downtime ops: the transition queue the run loop drains
        c["ops"] = OpsController(self)

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
        Calling-Station-Id over the DHCP leases, then the PPPoE sessions;
        a policy change rewrites the subscriber's QoS rows, a disconnect
        expires the lease or tears the session down (its PADT and LCP
        frames ride the demux's pending queue to the TX ring). Every verb
        runs under `_ctl`."""
        from bng_tpu_torch.control.pppoe.session import TerminateCause
        from bng_tpu_torch.control.radius.coa import CoAProcessor, CoAServer
        from bng_tpu_torch.utils.net import mac_to_u64

        cfg, c = self.config, self.components
        dhcp, pppoe_srv = c["dhcp"], c.get("pppoe")

        def _find_by_ip(ip):
            for lease in dhcp.leases.values():
                if lease.ip == ip:
                    return ("dhcp", lease)
            if pppoe_srv is not None:
                for s in pppoe_srv.sessions.all():
                    if s.assigned_ip == ip:
                        return ("pppoe", s)
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
            return True

        def _coa_disconnect(kind, obj):
            if kind == "dhcp":
                obj.expiry = 0
                dhcp.cleanup_expired(1)  # reaps only the forced lease
                return True
            frames = pppoe_srv.terminate(obj.session_id, TerminateCause.ADMIN_RESET,
                                         now=self.clock())
            if "slowpath" in c:
                # the PADT/LCP teardown frames go out with the next beat
                c["slowpath"].requeue(frames)
            return True

        class _CoASession:  # (kind, obj) with the .ip the processor reads
            def __init__(self, kind, obj):
                self.kind, self.obj = kind, obj
                self.ip = obj.ip if kind == "dhcp" else obj.assigned_ip

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
        return {"op": "fleet_resize", "outcome": "rejected",
                "error": "no slow-path fleet: not configured (--slowpath-workers <= 1)"}

    def fleet_rolling_restart(self) -> dict:
        return {"op": "fleet_rolling_restart", "outcome": "rejected",
                "error": "no slow-path fleet configured"}

    def engine_swap(self) -> dict:
        """Blue/green engine swap: hydrate a standby from an in-memory
        snapshot, replay the delta, audit, flip atomically — rollback on
        any failure with the active untouched (runtime/ops.py)."""
        from bng_tpu_torch.runtime.ops import blue_green_swap

        with self._ctl:
            report = blue_green_swap(self.components, node_id=self.config.node_id)
            self.log.info("engine swap", outcome=report.get("outcome"),
                          delta_rows=report.get("delta_rows"), error=report.get("error"))
            return report

    def ops_status(self) -> dict:
        """GET /ops/status payload."""
        with self._ctl:
            c = self.components
            return {"node_id": self.config.node_id, "fleet_blocked": [],
                    "ops": c["ops"].stats_snapshot() if "ops" in c else None}

    def close(self) -> None:
        """LIFO cleanup."""
        for fn in reversed(self._cleanup):
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown runs every step
                pass
        self._cleanup.clear()

    def drive_once(self) -> int:
        """One dataplane beat: feed the synthetic source (if configured),
        run the scheduler's beat or a double-buffered engine step over the
        ring, then put the slow-path demux's pending frames on the TX ring.
        Returns frames moved (the run loop sleeps when this stays 0)."""
        ring = self.components.get("ring")
        if ring is None:
            return 0
        if self.config.synthetic_subs:
            self._push_synthetic(ring)
        sched = self.components.get("scheduler")
        with self._ctl:
            if sched is not None and hasattr(ring, "rx_pop"):
                moved = self._drive_scheduler(ring, sched)
            else:
                moved = self.components["engine"].process_ring_pipelined(ring)
            # PPPoE negotiation's frames beyond the one inline reply (CHAP
            # Success + IPCP Conf-Req in one beat) and CoA teardowns; a full
            # TX ring re-queues the rest, in order, for the next beat
            demux = self.components.get("slowpath")
            if demux is not None:
                pending = demux.drain_pending()
                for i, frame in enumerate(pending):
                    if ring.tx_inject(frame, from_access=True):
                        moved += 1
                    else:
                        demux.requeue(pending[i:], front=True)
                        break
        return moved

    def _drive_scheduler(self, ring, sched) -> int:
        """One scheduler beat over the ring: RX frames into the lanes, poll
        (express first, bulk ring-managed), completions back out on the TX
        ring (slow-path replies too: the slow path ran inside the retire)."""
        from bng_tpu_torch.runtime.lanes import LANE_BULK, LANE_EXPRESS
        from bng_tpu_torch.runtime.ring import FLAG_DHCP_CTRL, FLAG_FROM_ACCESS

        moved = 0
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
        GARDEN_EVERY_S), and accounting: the device's NAT octet counts
        into the sessions (every ACCT_SYNC_EVERY_S), interims and spool
        retries (every ACCT_RETRY_EVERY_S)."""
        now = now if now is not None else self.clock()
        with self._ctl:
            self._tick_locked(now)

    def _tick_locked(self, now: float) -> None:
        c = self.components
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
            c["engine"].expire(int(now))
        garden = c.get("walledgarden")
        if garden is not None and now - self._last_garden >= self.GARDEN_EVERY_S:
            self._last_garden = now
            garden.check_expired()
        acct = c.get("accounting")
        if acct is not None:
            # the device's NAT octet counts into the accounting sessions
            # before interims fire, else every interim and stop reports 0
            if acct.sessions and now - self._last_acct_sync >= self.ACCT_SYNC_EVERY_S:
                self._last_acct_sync = now
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
        nat = self.components.get("nat")
        if nat is not None:  # registered only when nat_enabled
            out["nat"] = {"sessions": nat.sessions.count, "blocks": len(nat.blocks)}
        coa = self.components.get("coa")
        if coa is not None:
            out["coa"] = {**coa.stats, **coa.processor.stats}
        return out


def run_loadtest(args, device) -> int:
    """Build a self-contained engine + slow-path stack on `device` and
    load-test it (the reference's `run_loadtest`, without the fleet, the
    wire loop and the tracer)."""
    import ipaddress

    from bng_tpu_torch import kernels
    from bng_tpu_torch.control.dhcp_server import DHCPServer
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.control.pool import Pool, PoolManager
    from bng_tpu_torch.loadtest import BenchmarkConfig, DHCPBenchmark
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.tables import FastPathTables
    from bng_tpu_torch.utils.net import ip_to_u32, parse_mac

    refused = [flag for flag, on in (("--workers > 1", (args.workers or 1) > 1),
                                     ("--wire", args.wire is not None),
                                     ("--trace", args.trace)) if on]
    if refused:
        print(f"loadtest: {', '.join(refused)}: not in bng_tpu_torch yet (the slow-path "
              f"fleet, the AF_XDP wire loop and the tracer are not ported)", file=sys.stderr)
        return 2
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
    target = engine
    if args.scheduler:
        from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler

        target = TieredScheduler(engine, SchedulerConfig(bulk_batch=args.batch_size))

    cfg = BenchmarkConfig(
        batch_size=args.batch_size, duration_s=args.duration,
        warmup_s=args.warmup, unique_macs=args.macs,
        enable_renewals=args.renewals, renewal_ratio=args.renewal_ratio,
        rps_limit=args.rps)
    bench = DHCPBenchmark(target, cfg, log=lambda s: print(s, file=sys.stderr))
    launches0 = dict(kernels.LAUNCHES)
    res = bench.run()
    degraded = {}
    if server.stats.pool_exhausted:
        degraded["dhcp_pool"] = server.stats.pool_exhausted
    for resource, count in nat.exhausted.items():
        if count:
            degraded[f"nat_{resource}"] = count
    res.degraded = degraded
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
                "workers": 1,
                "program": res.program,
                "latency_p99_us": round(res.latency_p99_us, 1),
                "request_p99_us": res.request_p99_us,
                "shed": res.shed,
                "degraded": res.degraded,
                "env": ledger_mod.environment_fingerprint(engine.device),
            })
        except OSError as e:
            print(f"loadtest: bench-log append failed: {e}", file=sys.stderr)
    if args.json_out:
        print(json.dumps({**res.to_dict(), "served": served}, indent=2))
    else:
        print(res.summary())
        print(f"Served by:         {served['device']}, {served['dispatches']} dispatches, "
              f"launches {served['launches']}")
    if args.validate:
        failures = res.meets_targets(cfg)
        for f in failures:
            print(f"TARGET FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0
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


def serve(app: BNGApp) -> int:
    """The run loop: drive the ring when one exists, run the operator's
    queued transitions at the batch boundary, tick once a second."""
    from bng_tpu_torch.control.opsctl import OpsServer

    ops = app.components["ops"]
    if app.config.ctl_listen:
        chost, _, cport = app.config.ctl_listen.rpartition(":")
        try:
            osrv = app.components["ops_server"] = OpsServer(
                ops, chost or "127.0.0.1", int(cport or 0)).start()
            app._on_close(osrv.close)
            print(f"ctl on {osrv.addr[0]}:{osrv.addr[1]}", file=sys.stderr)
        except OSError as e:
            print(f"ctl listener unavailable ({e}); runtime ops disabled", file=sys.stderr)
    has_ring = app.components.get("ring") is not None
    last_tick = 0.0
    ctx_enter("loop")  # sanitizer ownership context
    while True:
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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="bng-tpu-torch", description="BNG dataplane on an NVIDIA GPU (PyTorch/CUDA)")
    parser.add_argument("--device", default=None,
                        help="where to run: the card (the default) or cpu")
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
    # the reference's flags for subsystems the port lacks: refused
    loadp.add_argument("--workers", type=int, default=1, help="not ported: refused above 1")
    loadp.add_argument("--wire", nargs="?", const="mem", default=None, metavar="IFNAME",
                       help="not ported: refused")
    loadp.add_argument("--trace", action="store_true", help="not ported: refused")

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

    sub.add_parser("version", help="print version")

    args = parser.parse_args(argv)
    if not logging.getLogger("bng").handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(levelname)s %(name)s %(message)s"))
        logging.getLogger("bng").addHandler(handler)

    if args.command == "version":
        print(f"bng-tpu-torch {__version__}")
        return 0
    try:
        if args.command == "loadtest":
            return run_loadtest(args, resolve_device(args.device))
        if args.command == "checkpoint":
            return run_checkpoint(args, args.device)
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
    except (NoCardError, UnportedSubsystemError) as e:
        print(f"bng-tpu-torch: {e}", file=sys.stderr)
        return 2
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
