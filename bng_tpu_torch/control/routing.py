"""Multi-ISP routing: platform abstraction, BGP/BFD via FRR, subscriber routes.

The port's copy of `bng_tpu/control/routing.py` (jax-free); the ICMP
probe's checksum comes from `bng_tpu_torch/frames.py`.

Parity: pkg/routing — RoutingPlatform interface (manager.go:159-179) with
an in-memory stub (netlink_stub.go:13; the Linux netlink impl is a thin
adapter the composition root supplies), Manager with upstreams / ISP
tables / policy routing / ECMP / health checks (manager.go:15-663),
BGPController driving FRR through a pluggable vtysh executor
(bgp.go:18-848: neighbors :219-321, announce/withdraw :323-399, max-paths
:431, per-neighbor BFD :451, route-maps :490, table import :517, config
generation :758-817), BFDManager (bfd.go:19-430), SubscriberRouteManager
injecting per-subscriber /32s with BGP communities by class and a retry
queue (subscriber_routes.go:16-668).

All FRR interaction goes through `executor(command) -> str` so everything
runs hermetically; production wires `lambda c: subprocess.run(["vtysh",
"-c", c], ...)` exactly like bgp.go:554-578.
"""

from __future__ import annotations

import ipaddress
import json
import threading
import time
from dataclasses import dataclass, field
from enum import Enum


# ---------------------------------------------------------------------------
# Platform abstraction (manager.go:117-190)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NextHop:
    gateway: str
    interface: str = ""
    weight: int = 1


@dataclass(frozen=True)
class Route:
    destination: str  # CIDR
    gateway: str = ""
    interface: str = ""
    table: int = 254  # main
    metric: int = 0
    nexthops: tuple = ()  # ECMP


@dataclass(frozen=True)
class PolicyRule:
    priority: int
    table: int
    src: str = ""  # CIDR
    dst: str = ""
    fwmark: int = 0


@dataclass
class InterfaceInfo:
    name: str
    index: int = 0
    mtu: int = 1500
    hwaddr: str = ""
    up: bool = True
    addresses: list[str] = field(default_factory=list)


class StubPlatform:
    """In-memory RoutingPlatform (netlink_stub.go:13): a route/rule table
    that behaves observably like the netlink one. ping() consults a
    settable reachability map."""

    def __init__(self):
        self._lock = threading.Lock()
        self.routes: dict[int, list[Route]] = {}
        self.rules: list[PolicyRule] = []
        self.interfaces: dict[str, InterfaceInfo] = {
            "lo": InterfaceInfo(name="lo", index=1)}
        self.reachable: dict[str, float] = {}  # ip -> rtt seconds

    def add_route(self, route: Route) -> None:
        with self._lock:
            table = self.routes.setdefault(route.table, [])
            if route in table:
                raise FileExistsError(f"route exists: {route}")
            table.append(route)

    def delete_route(self, route: Route) -> None:
        with self._lock:
            table = self.routes.get(route.table, [])
            try:
                table.remove(route)
            except ValueError:
                raise FileNotFoundError(f"no such route: {route}") from None

    def get_routes(self, table: int) -> list[Route]:
        with self._lock:
            return list(self.routes.get(table, []))

    def flush_table(self, table: int) -> None:
        with self._lock:
            self.routes[table] = []

    def add_rule(self, rule: PolicyRule) -> None:
        with self._lock:
            if rule in self.rules:
                raise FileExistsError(f"rule exists: {rule}")
            self.rules.append(rule)
            self.rules.sort(key=lambda r: r.priority)

    def delete_rule(self, rule: PolicyRule) -> None:
        with self._lock:
            try:
                self.rules.remove(rule)
            except ValueError:
                raise FileNotFoundError(f"no such rule: {rule}") from None

    def get_rules(self) -> list[PolicyRule]:
        with self._lock:
            return list(self.rules)

    def get_interface(self, name: str) -> InterfaceInfo:
        with self._lock:
            if name not in self.interfaces:
                raise FileNotFoundError(f"no such interface: {name}")
            return self.interfaces[name]

    def set_interface_up(self, name: str) -> None:
        self.get_interface(name).up = True

    def set_interface_down(self, name: str) -> None:
        self.get_interface(name).up = False

    def ping(self, target: str, timeout: float = 1.0) -> float:
        with self._lock:
            rtt = self.reachable.get(target)
        if rtt is None or rtt > timeout:
            raise TimeoutError(f"ping {target} timed out")
        return rtt


class IPRoute2Platform:
    """Linux RoutingPlatform over iproute2 (`ip -j`) subprocesses.

    The real-kernel counterpart of StubPlatform — the role of the
    reference's NetlinkPlatform (pkg/routing/netlink_linux.go:20-442),
    using the `ip(8)` CLI's JSON output instead of a netlink library
    (pyroute2 is not in the image; iproute2 is, and its -j output is the
    stable programmatic interface). Same observable contract as the stub:
    FileExistsError on duplicate adds, FileNotFoundError on missing
    deletes/interfaces, TimeoutError from ping.

    `runner` is injectable for hermetic tests; production uses
    subprocess.run. Requires CAP_NET_ADMIN for mutations.
    """

    def __init__(self, runner=None, ip_binary: str = "ip",
                 timeout: float = 5.0):
        import subprocess

        self._ip = ip_binary
        self._timeout = timeout
        self._runner = runner or (lambda args: subprocess.run(
            args, capture_output=True, text=True, timeout=self._timeout))

    # -- plumbing ----------------------------------------------------------
    def _run(self, *args: str, check: bool = True) -> str:
        res = self._runner([self._ip, *args])
        if check and res.returncode != 0:
            err = (res.stderr or res.stdout or "").strip()
            low = err.lower()
            if "file exists" in low:
                raise FileExistsError(err)
            if ("no such" in low or "not found" in low
                    or "cannot find" in low or "does not exist" in low):
                raise FileNotFoundError(err)
            raise RuntimeError(f"ip {' '.join(args)}: rc="
                               f"{res.returncode}: {err[:200]}")
        return res.stdout

    def _json(self, *args: str):
        out = self._run("-j", *args)
        return json.loads(out) if out.strip() else []

    @staticmethod
    def _route_args(route: Route) -> list[str]:
        args = [route.destination, "table", str(route.table)]
        if route.nexthops:  # ECMP (netlink_linux.go multipath role)
            for nh in route.nexthops:
                args.append("nexthop")
                if nh.gateway:
                    args += ["via", nh.gateway]
                if nh.interface:
                    args += ["dev", nh.interface]
                args += ["weight", str(max(1, nh.weight))]
            return args
        if route.gateway:
            args += ["via", route.gateway]
        if route.interface:
            args += ["dev", route.interface]
        if route.metric:
            args += ["metric", str(route.metric)]
        return args

    # -- routes ------------------------------------------------------------
    def add_route(self, route: Route) -> None:
        self._run("route", "add", *self._route_args(route))

    def delete_route(self, route: Route) -> None:
        self._run("route", "del", *self._route_args(route))

    def get_routes(self, table: int) -> list[Route]:
        routes = []
        for r in self._json("route", "show", "table", str(table)):
            nexthops = tuple(
                NextHop(gateway=nh.get("gateway", ""),
                        interface=nh.get("dev", ""),
                        weight=int(nh.get("weight", 1)))
                for nh in r.get("nexthops", ()))
            dst = r.get("dst", "")
            if dst == "default":
                dst = "0.0.0.0/0"
            elif "/" not in dst:
                dst += "/32"
            routes.append(Route(
                destination=dst, gateway=r.get("gateway", ""),
                interface=r.get("dev", ""), table=table,
                metric=int(r.get("metric", 0)), nexthops=nexthops))
        return routes

    def flush_table(self, table: int) -> None:
        self._run("route", "flush", "table", str(table), check=False)

    # -- policy rules (ip rule) --------------------------------------------
    @staticmethod
    def _rule_args(rule: PolicyRule) -> list[str]:
        args = ["priority", str(rule.priority)]
        args += ["from", rule.src or "all"]
        if rule.dst:
            args += ["to", rule.dst]
        if rule.fwmark:
            args += ["fwmark", str(rule.fwmark)]
        args += ["table", str(rule.table)]
        return args

    def add_rule(self, rule: PolicyRule) -> None:
        # the kernel rejects exact duplicates with EEXIST ("File exists"),
        # which _run maps to the stub's FileExistsError contract — no
        # O(total rules) pre-scan per subscriber rule
        self._run("rule", "add", *self._rule_args(rule))

    def delete_rule(self, rule: PolicyRule) -> None:
        # the kernel's own ENOENT ("No such file or directory") maps to
        # FileNotFoundError in _run — no O(total rules) pre-scan needed
        self._run("rule", "del", *self._rule_args(rule))

    def get_rules(self) -> list[PolicyRule]:
        rules = []
        for r in self._json("rule", "show"):
            table = r.get("table", "")
            if not str(table).isdigit():
                continue  # local/main/default system tables
            src = r.get("src", "")
            if src in ("all", ""):
                src = ""
            else:  # iproute2 omits srclen for /32: normalize to CIDR
                src += f"/{r.get('srclen', 32)}"
            dst = r.get("dst", "")
            if dst:
                dst += f"/{r.get('dstlen', 32)}"
            rules.append(PolicyRule(
                priority=int(r.get("priority", 0)), table=int(table),
                src=src, dst=dst, fwmark=int(r.get("fwmark", "0x0"), 16)
                if isinstance(r.get("fwmark"), str) else int(r.get("fwmark", 0))))
        return rules

    # -- interfaces --------------------------------------------------------
    def get_interface(self, name: str) -> InterfaceInfo:
        links = self._json("link", "show", "dev", name)
        if not links:
            raise FileNotFoundError(f"no such interface: {name}")
        link = links[0]
        addrs = []
        for a in self._json("addr", "show", "dev", name):
            for ai in a.get("addr_info", ()):
                addrs.append(f"{ai['local']}/{ai['prefixlen']}")
        return InterfaceInfo(
            name=name, index=int(link.get("ifindex", 0)),
            mtu=int(link.get("mtu", 1500)),
            hwaddr=link.get("address", ""),
            up="UP" in link.get("flags", ()), addresses=addrs)

    def set_interface_up(self, name: str) -> None:
        self._run("link", "set", "dev", name, "up")

    def set_interface_down(self, name: str) -> None:
        self._run("link", "set", "dev", name, "down")

    # -- health ------------------------------------------------------------
    def ping(self, target: str, timeout: float = 1.0) -> float:
        """ICMP echo probe — raw-socket first (the reference's approach,
        netlink_linux.go:237; needs CAP_NET_RAW), ping(8) as the unprivileged
        fallback. Returns RTT seconds, raises TimeoutError on no reply."""
        import os
        import socket
        import struct

        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_RAW,
                              socket.IPPROTO_ICMP)
        except PermissionError:
            return self._ping_binary(target, timeout)
        from bng_tpu_torch.frames import checksum16

        try:
            s.settimeout(timeout)
            # ident+seq+random token: a reply only counts if it echoes THIS
            # probe's token AND comes from the probed address — a late
            # reply from a previous (slower) target must never validate a
            # dead upstream (review r4)
            ident = os.getpid() & 0xFFFF
            seq = next(_PING_SEQ) & 0xFFFF
            token = os.urandom(8)
            payload = struct.pack("!HH", ident, seq) + token
            csum = checksum16(struct.pack("!BBH", 8, 0, 0) + payload)
            pkt = struct.pack("!BBH", 8, 0, csum) + payload
            t0 = time.monotonic()
            s.sendto(pkt, (target, 0))
            deadline = t0 + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"ping {target} timed out")
                s.settimeout(remaining)
                try:
                    data, addr = s.recvfrom(2048)
                except (socket.timeout, TimeoutError):
                    raise TimeoutError(f"ping {target} timed out") from None
                if addr[0] != target:
                    continue
                # strip the IP header; match echo-reply + ident/seq/token
                ihl = (data[0] & 0x0F) * 4
                icmp = data[ihl:]
                if (len(icmp) >= 16 and icmp[0] == 0
                        and icmp[4:8] == payload[:4]
                        and icmp[8:16] == token):
                    return time.monotonic() - t0
        finally:
            s.close()

    @staticmethod
    def _ping_binary(target: str, timeout: float) -> float:
        import subprocess

        t0 = time.monotonic()
        try:
            res = subprocess.run(
                ["ping", "-c", "1", "-W", str(max(1, int(timeout))), target],
                capture_output=True, text=True, timeout=timeout + 2)
        except (subprocess.TimeoutExpired, FileNotFoundError):
            raise TimeoutError(f"ping {target} unavailable/timed out") from None
        if res.returncode != 0:
            raise TimeoutError(f"ping {target} failed: rc={res.returncode}")
        return time.monotonic() - t0


# monotone ICMP sequence across all platform instances in this process
import itertools as _itertools

_PING_SEQ = _itertools.count(1)


def vtysh_executor(binary: str = "vtysh", timeout: float = 10.0,
                   runner=None):
    """Real FRR executor: `vtysh -c <line> -c <line> ...` subprocesses.

    Parity: the reference builds exactly this command per call
    (pkg/routing/bgp.go:554-578, wired in cmd/bng/main.go:884-940).
    BGPController hands multi-line configs as newline-joined strings;
    each line becomes its own -c argument, matching vtysh semantics.
    Returns stdout; raises RuntimeError on nonzero rc so controller state
    never silently diverges from FRR.
    """
    import subprocess

    # bounded argv: a bulk inject/withdraw at 1M-subscriber scale would
    # otherwise exceed ARG_MAX (execve E2BIG). Chunks re-enter config mode
    # so each invocation is a complete vtysh session.
    MAX_LINES = 400

    def _invoke(lines: list[str]) -> str:
        args = [binary]
        for line in lines:
            args += ["-c", line]
        run = runner or (lambda a: subprocess.run(
            a, capture_output=True, text=True, timeout=timeout))
        res = run(args)
        if res.returncode != 0:
            err = (res.stderr or res.stdout or "").strip()
            raise RuntimeError(f"vtysh rc={res.returncode}: {err[:200]}")
        return res.stdout

    # vtysh context-entering prefixes: a chunk boundary inside one of
    # these blocks must REPLAY the block entry (advisor r4: replaying only
    # the initial preamble re-entered the FIRST router context for lines
    # belonging to a LATER one)
    ENTER = ("router ", "address-family ", "interface ", "route-map ",
             "vrf ")

    def execute(command: str) -> str:
        lines = command.split("\n")
        if len(lines) <= MAX_LINES:
            return _invoke(lines)
        out = []
        stack: list[str] = []  # live context path, outermost first
        chunk: list[str] = []

        def depth(entry: str) -> int:
            s = entry.strip()
            if s.startswith("configure"):
                return 0
            return 2 if s.startswith("address-family ") else 1

        def track(line: str) -> None:
            s = line.strip()
            if s.startswith("configure"):
                stack.clear()
                stack.append(line)
            elif any(s.startswith(p) for p in ENTER):
                # vtysh implicitly leaves a sibling stanza when the next
                # one opens (consecutive `interface X` blocks carry no
                # `exit`): pop to ABOVE this line's depth, then push —
                # bounds the stack at [configure, level-1, addr-family]
                d = depth(line)
                while stack and depth(stack[-1]) >= d:
                    stack.pop()
                stack.append(line)
            elif s in ("end", "quit"):
                stack.clear()  # back to exec mode
            elif s in ("exit", "exit-address-family", "exit-vrf"):
                if stack:
                    stack.pop()

        for line in lines:
            if not chunk and stack:
                chunk.extend(stack)  # re-enter the CURRENT context
            chunk.append(line)
            track(line)
            if len(chunk) >= MAX_LINES:
                out.append(_invoke(chunk))
                chunk = []
        if chunk:
            out.append(_invoke(chunk))
        return "".join(out)

    return execute


class LinkState(str, Enum):
    UNKNOWN = "unknown"
    UP = "up"
    DOWN = "down"


@dataclass
class Upstream:
    """manager.go:75-101: one ISP uplink."""

    name: str
    interface: str = ""
    gateway: str = ""
    table: int = 0
    health_target: str = ""  # IP pinged by the health checker
    weight: int = 1
    state: LinkState = LinkState.UNKNOWN
    consecutive_failures: int = 0
    last_rtt: float = 0.0


@dataclass
class RoutingConfig:
    """manager.go:46-73."""

    default_table: int = 254
    enable_ecmp: bool = True
    enable_policy_routing: bool = True
    health_check_interval: float = 5.0
    health_check_timeout: float = 1.0
    failure_threshold: int = 3


class RoutingManager:
    """manager.go:15-663."""

    def __init__(self, config: RoutingConfig | None = None, platform=None):
        self.config = config or RoutingConfig()
        self.platform = platform or StubPlatform()
        self._lock = threading.Lock()
        self._upstreams: dict[str, Upstream] = {}
        self.on_upstream_up = None
        self.on_upstream_down = None
        self.stats = {"routes_added": 0, "routes_deleted": 0,
                      "rules_added": 0, "failovers": 0, "health_checks": 0}

    # -- upstreams (manager.go:258-343) ---------------------------------

    def add_upstream(self, upstream: Upstream) -> None:
        with self._lock:
            if upstream.name in self._upstreams:
                raise ValueError(f"upstream {upstream.name} exists")
            self._upstreams[upstream.name] = upstream
        if upstream.table and upstream.gateway:
            self.create_isp_table(upstream.name, upstream.table,
                                  upstream.gateway, upstream.interface)

    def remove_upstream(self, name: str) -> None:
        with self._lock:
            up = self._upstreams.pop(name, None)
        if up is not None and up.table:
            self.platform.flush_table(up.table)

    def get_upstream(self, name: str) -> Upstream | None:
        with self._lock:
            return self._upstreams.get(name)

    def list_upstreams(self) -> list[Upstream]:
        with self._lock:
            return list(self._upstreams.values())

    # -- routes (manager.go:345-519) ------------------------------------

    def set_default_gateway(self, gateway: str, interface: str = "") -> None:
        self.add_route(Route(destination="0.0.0.0/0", gateway=gateway,
                             interface=interface,
                             table=self.config.default_table))

    def set_default_gateway_ecmp(self, nexthops: list[NextHop]) -> None:
        """manager.go:360-375."""
        if not self.config.enable_ecmp:
            raise ValueError("ECMP disabled")
        self.add_route(Route(destination="0.0.0.0/0",
                             table=self.config.default_table,
                             nexthops=tuple(nexthops)))

    def add_route(self, route: Route) -> None:
        self.platform.add_route(route)
        self.stats["routes_added"] += 1

    def delete_route(self, route: Route) -> None:
        self.platform.delete_route(route)
        self.stats["routes_deleted"] += 1

    def add_policy_rule(self, rule: PolicyRule) -> None:
        if not self.config.enable_policy_routing:
            raise ValueError("policy routing disabled")
        self.platform.add_rule(rule)
        self.stats["rules_added"] += 1

    # -- per-ISP tables (manager.go:521-572) -----------------------------

    def create_isp_table(self, isp_id: str, table_id: int, gateway: str,
                         interface: str = "") -> None:
        """Default route in the ISP's table; subscribers are steered with
        per-source rules."""
        self.platform.add_route(Route(destination="0.0.0.0/0", gateway=gateway,
                                      interface=interface, table=table_id))

    def route_subscriber_to_isp(self, subscriber_ip: str, table_id: int,
                                priority: int = 1000) -> PolicyRule:
        rule = PolicyRule(priority=priority, table=table_id,
                          src=f"{subscriber_ip}/32")
        self.add_policy_rule(rule)
        return rule

    def unroute_subscriber(self, subscriber_ip: str, table_id: int,
                           priority: int = 1000) -> None:
        self.platform.delete_rule(PolicyRule(priority=priority, table=table_id,
                                             src=f"{subscriber_ip}/32"))

    # -- health checking (manager.go:592-640) ---------------------------

    def check_health(self) -> None:
        """One sweep of all upstream health targets."""
        for up in self.list_upstreams():
            if not up.health_target:
                continue
            self.stats["health_checks"] += 1
            try:
                up.last_rtt = self.platform.ping(
                    up.health_target, self.config.health_check_timeout)
                up.consecutive_failures = 0
                if up.state != LinkState.UP:
                    up.state = LinkState.UP
                    if self.on_upstream_up:
                        self.on_upstream_up(up.name)
            except Exception:
                up.consecutive_failures += 1
                if (up.state != LinkState.DOWN and up.consecutive_failures
                        >= self.config.failure_threshold):
                    up.state = LinkState.DOWN
                    self.stats["failovers"] += 1
                    if self.on_upstream_down:
                        self.on_upstream_down(up.name)

    def routing_stats(self) -> dict:
        with self._lock:
            ups = sum(1 for u in self._upstreams.values()
                      if u.state == LinkState.UP)
            return dict(self.stats, upstreams=len(self._upstreams),
                        upstreams_up=ups)


# ---------------------------------------------------------------------------
# BGP via FRR (bgp.go)
# ---------------------------------------------------------------------------

class BGPState(str, Enum):
    IDLE = "Idle"
    CONNECT = "Connect"
    ACTIVE = "Active"
    OPENSENT = "OpenSent"
    OPENCONFIRM = "OpenConfirm"
    ESTABLISHED = "Established"


def parse_bgp_state(s: str) -> BGPState:
    """bgp.go:118-136."""
    try:
        return BGPState(s.strip().capitalize().replace("Opensent", "OpenSent")
                        .replace("Openconfirm", "OpenConfirm"))
    except ValueError:
        return BGPState.IDLE


@dataclass
class BGPNeighbor:
    """bgp.go:68-96."""

    address: str
    remote_as: int
    description: str = ""
    state: BGPState = BGPState.IDLE
    bfd_enabled: bool = False
    next_hop_self: bool = False
    route_map_in: str = ""
    route_map_out: str = ""
    table_id: int = 0
    prefixes_received: int = 0
    uptime_s: float = 0.0


@dataclass
class BGPConfig:
    """bgp.go:38-66."""

    local_as: int = 65000
    router_id: str = ""
    poll_interval: float = 10.0


@dataclass
class BGPAnnouncement:
    prefix: str
    route_map: str = ""
    communities: list[str] = field(default_factory=list)


class BGPController:
    """bgp.go:18-848 with `executor(command) -> str` instead of vtysh."""

    def __init__(self, config: BGPConfig, executor):
        self.config = config
        self._exec = executor
        self._lock = threading.Lock()
        self._neighbors: dict[str, BGPNeighbor] = {}
        self._announcements: dict[str, BGPAnnouncement] = {}
        self.on_neighbor_up = None
        self.on_neighbor_down = None
        self.stats = {"commands": 0, "neighbor_transitions": 0}

    def _vtysh(self, command: str) -> str:
        self.stats["commands"] += 1
        return self._exec(command)

    def _conf(self, *lines: str) -> str:
        return self._vtysh("configure terminal\n" + "\n".join(lines))

    # -- neighbors (bgp.go:219-321) --------------------------------------

    def add_neighbor(self, neighbor: BGPNeighbor) -> None:
        with self._lock:
            if neighbor.address in self._neighbors:
                raise ValueError(f"neighbor {neighbor.address} exists")
            self._neighbors[neighbor.address] = neighbor
        lines = [f"router bgp {self.config.local_as}",
                 f"neighbor {neighbor.address} remote-as {neighbor.remote_as}"]
        if neighbor.description:
            lines.append(f"neighbor {neighbor.address} description "
                         f"{neighbor.description}")
        if neighbor.bfd_enabled:
            lines.append(f"neighbor {neighbor.address} bfd")
        lines += ["address-family ipv4 unicast",
                  f"neighbor {neighbor.address} activate"]
        if neighbor.next_hop_self:
            lines.append(f"neighbor {neighbor.address} next-hop-self")
        if neighbor.route_map_in:
            lines.append(f"neighbor {neighbor.address} route-map "
                         f"{neighbor.route_map_in} in")
        if neighbor.route_map_out:
            lines.append(f"neighbor {neighbor.address} route-map "
                         f"{neighbor.route_map_out} out")
        lines.append("exit-address-family")
        self._conf(*lines)

    def remove_neighbor(self, address: str) -> None:
        with self._lock:
            if self._neighbors.pop(address, None) is None:
                raise KeyError(address)
        self._conf(f"router bgp {self.config.local_as}",
                   f"no neighbor {address}")

    def get_neighbor(self, address: str) -> BGPNeighbor | None:
        with self._lock:
            return self._neighbors.get(address)

    def list_neighbors(self) -> list[BGPNeighbor]:
        with self._lock:
            return list(self._neighbors.values())

    # -- prefixes (bgp.go:323-399) ---------------------------------------

    def announce_prefix(self, prefix: str,
                        opts: BGPAnnouncement | None = None) -> None:
        ipaddress.ip_network(prefix)  # validate
        ann = opts or BGPAnnouncement(prefix=prefix)
        ann.prefix = prefix
        with self._lock:
            self._announcements[prefix] = ann
        self._conf(f"router bgp {self.config.local_as}",
                   "address-family ipv4 unicast",
                   f"network {prefix}"
                   + (f" route-map {ann.route_map}" if ann.route_map else ""),
                   "exit-address-family")

    def withdraw_prefix(self, prefix: str) -> None:
        with self._lock:
            if self._announcements.pop(prefix, None) is None:
                raise KeyError(prefix)
        self._conf(f"router bgp {self.config.local_as}",
                   "address-family ipv4 unicast",
                   f"no network {prefix}",
                   "exit-address-family")

    def list_announcements(self) -> list[BGPAnnouncement]:
        with self._lock:
            return list(self._announcements.values())

    # -- knobs (bgp.go:431-552) ------------------------------------------

    def enable_max_paths(self, max_paths: int) -> None:
        if not 1 <= max_paths <= 64:
            raise ValueError("max_paths out of range")
        self._conf(f"router bgp {self.config.local_as}",
                   "address-family ipv4 unicast",
                   f"maximum-paths {max_paths}",
                   "exit-address-family")

    def configure_bfd(self, address: str, min_rx: int = 300, min_tx: int = 300,
                      multiplier: int = 3) -> None:
        self._conf("bfd", f"peer {address}",
                   f"receive-interval {min_rx}",
                   f"transmit-interval {min_tx}",
                   f"detect-multiplier {multiplier}", "no shutdown")
        n = self.get_neighbor(address)
        if n is not None:
            n.bfd_enabled = True

    def create_route_map(self, name: str, seq: int, action: str,
                         match_clauses: list[str] | None = None,
                         set_clauses: list[str] | None = None) -> None:
        lines = [f"route-map {name} {action} {seq}"]
        lines += [f"match {m}" for m in (match_clauses or [])]
        lines += [f"set {s}" for s in (set_clauses or [])]
        self._conf(*lines)

    def set_neighbor_route_table(self, address: str, table_id: int) -> None:
        """bgp.go:517-552: import neighbor routes into an ISP table."""
        n = self.get_neighbor(address)
        if n is None:
            raise KeyError(address)
        n.table_id = table_id
        self._conf(f"router bgp {self.config.local_as}",
                   "address-family ipv4 unicast",
                   f"table-map isp-table-{table_id}",
                   "exit-address-family")

    def clear_neighbor(self, address: str, soft: bool = False) -> None:
        self._vtysh(f"clear bgp {address}" + (" soft" if soft else ""))

    # -- status (bgp.go:402-428, :580-756) -------------------------------

    def refresh_neighbors(self) -> None:
        """Poll FRR state JSON and fire up/down callbacks."""
        raw = self._vtysh("show bgp ipv4 unicast summary json")
        try:
            data = json.loads(raw)
        except (ValueError, TypeError):
            return
        peers = data.get("peers", data.get("ipv4Unicast", {}).get("peers", {}))
        for addr, info in peers.items():
            n = self.get_neighbor(addr)
            if n is None:
                continue
            new_state = parse_bgp_state(str(info.get("state", "Idle")))
            n.prefixes_received = int(info.get("pfxRcd", 0) or 0)
            if new_state != n.state:
                self.stats["neighbor_transitions"] += 1
                old, n.state = n.state, new_state
                if new_state == BGPState.ESTABLISHED and self.on_neighbor_up:
                    self.on_neighbor_up(addr)
                elif (old == BGPState.ESTABLISHED
                      and self.on_neighbor_down):
                    self.on_neighbor_down(addr)

    def summary(self) -> dict:
        with self._lock:
            est = sum(1 for n in self._neighbors.values()
                      if n.state == BGPState.ESTABLISHED)
            return {"local_as": self.config.local_as,
                    "neighbors": len(self._neighbors),
                    "established": est,
                    "announcements": len(self._announcements)}

    # -- config generation (bgp.go:758-817) ------------------------------

    def generate_config(self) -> str:
        with self._lock:
            out = ["! BGP configuration generated by bng-tpu", "!",
                   f"router bgp {self.config.local_as}"]
            if self.config.router_id:
                out.append(f" bgp router-id {self.config.router_id}")
            out += [" no bgp default ipv4-unicast",
                    " bgp bestpath as-path multipath-relax", "!"]
            for n in self._neighbors.values():
                out.append(f" neighbor {n.address} remote-as {n.remote_as}")
                if n.description:
                    out.append(f" neighbor {n.address} description "
                               f"{n.description}")
                if n.bfd_enabled:
                    out.append(f" neighbor {n.address} bfd")
            out += ["!", " address-family ipv4 unicast"]
            out += [f"  network {a.prefix}"
                    for a in self._announcements.values()]
            for n in self._neighbors.values():
                out.append(f"  neighbor {n.address} activate")
                if n.next_hop_self:
                    out.append(f"  neighbor {n.address} next-hop-self")
                if n.route_map_in:
                    out.append(f"  neighbor {n.address} route-map "
                               f"{n.route_map_in} in")
                if n.route_map_out:
                    out.append(f"  neighbor {n.address} route-map "
                               f"{n.route_map_out} out")
            out += [" exit-address-family", "!"]
            return "\n".join(out) + "\n"

    def write_config(self) -> None:
        self._vtysh("write memory")


# ---------------------------------------------------------------------------
# BFD via FRR (bfd.go)
# ---------------------------------------------------------------------------

class BFDState(str, Enum):
    ADMIN_DOWN = "admin_down"
    DOWN = "down"
    INIT = "init"
    UP = "up"


@dataclass
class BFDPeer:
    """bfd.go:88-119."""

    address: str
    min_rx_ms: int = 300
    min_tx_ms: int = 300
    detect_multiplier: int = 3
    multihop: bool = False
    state: BFDState = BFDState.DOWN
    linked_bgp_as: int = 0


@dataclass
class BFDConfig:
    """bfd.go:38-86."""

    min_rx_ms: int = 300
    min_tx_ms: int = 300
    detect_multiplier: int = 3


def aggressive_bfd_config() -> BFDConfig:
    """bfd.go:80-86: ~50ms detection for fast failover."""
    return BFDConfig(min_rx_ms=50, min_tx_ms=50, detect_multiplier=3)


class BFDManager:
    """bfd.go:19-430."""

    def __init__(self, config: BFDConfig | None = None, executor=None):
        self.config = config or BFDConfig()
        self._exec = executor or (lambda c: "")
        self._lock = threading.Lock()
        self._peers: dict[str, BFDPeer] = {}
        self.on_peer_up = None
        self.on_peer_down = None

    def add_peer(self, address: str, min_rx: int | None = None,
                 min_tx: int | None = None, detect_mult: int | None = None,
                 multihop: bool = False) -> BFDPeer:
        peer = BFDPeer(address=address,
                       min_rx_ms=min_rx or self.config.min_rx_ms,
                       min_tx_ms=min_tx or self.config.min_tx_ms,
                       detect_multiplier=detect_mult
                       or self.config.detect_multiplier,
                       multihop=multihop)
        with self._lock:
            if address in self._peers:
                raise ValueError(f"BFD peer {address} exists")
            self._peers[address] = peer
        self._exec("configure terminal\nbfd\n"
                   f"peer {address}{' multihop' if multihop else ''}\n"
                   f"receive-interval {peer.min_rx_ms}\n"
                   f"transmit-interval {peer.min_tx_ms}\n"
                   f"detect-multiplier {peer.detect_multiplier}\nno shutdown")
        return peer

    def remove_peer(self, address: str) -> None:
        with self._lock:
            if self._peers.pop(address, None) is None:
                raise KeyError(address)
        self._exec(f"configure terminal\nbfd\nno peer {address}")

    def link_to_bgp_neighbor(self, bgp_as: int, address: str) -> None:
        """bfd.go:317-348."""
        peer = self.get_peer(address) or self.add_peer(address)
        peer.linked_bgp_as = bgp_as
        self._exec(f"configure terminal\nrouter bgp {bgp_as}\n"
                   f"neighbor {address} bfd")

    def unlink_from_bgp_neighbor(self, bgp_as: int, address: str) -> None:
        peer = self.get_peer(address)
        if peer is not None:
            peer.linked_bgp_as = 0
        self._exec(f"configure terminal\nrouter bgp {bgp_as}\n"
                   f"no neighbor {address} bfd")

    def get_peer(self, address: str) -> BFDPeer | None:
        with self._lock:
            return self._peers.get(address)

    def list_peers(self) -> list[BFDPeer]:
        with self._lock:
            return list(self._peers.values())

    def refresh_peers(self) -> None:
        """Poll `show bfd peers json` and fire transitions (bfd.go:401+)."""
        raw = self._exec("show bfd peers json")
        try:
            data = json.loads(raw)
        except (ValueError, TypeError):
            return
        for entry in data if isinstance(data, list) else []:
            addr = entry.get("peer", "")
            peer = self.get_peer(addr)
            if peer is None:
                continue
            new = BFDState(entry.get("status", "down").lower()) \
                if entry.get("status", "").lower() in \
                ("admin_down", "down", "init", "up") else BFDState.DOWN
            if new != peer.state:
                old, peer.state = peer.state, new
                if new == BFDState.UP and self.on_peer_up:
                    self.on_peer_up(addr)
                elif old == BFDState.UP and self.on_peer_down:
                    self.on_peer_down(addr)

    def bfd_stats(self) -> dict:
        with self._lock:
            return {"peers": len(self._peers),
                    "up": sum(1 for p in self._peers.values()
                              if p.state == BFDState.UP)}


# ---------------------------------------------------------------------------
# Per-subscriber route injection (subscriber_routes.go)
# ---------------------------------------------------------------------------

@dataclass
class SubscriberRoute:
    """subscriber_routes.go:88-97."""

    session_id: str
    subscriber_id: str
    ip: str
    subscriber_class: str = ""
    community: str = ""
    injected_at: float = 0.0


@dataclass
class SubscriberRouteConfig:
    """subscriber_routes.go:39-86."""

    enabled: bool = True
    communities_by_class: dict[str, str] = field(default_factory=lambda: {
        "residential": "65000:100",
        "business": "65000:200",
        "wholesale": "65000:300",
    })
    default_community: str = "65000:100"
    graceful_shutdown_community: str = "65535:0"  # RFC 8326
    max_retries: int = 3


class SubscriberRouteManager:
    """subscriber_routes.go:16-668: /32 injection with communities, retry
    queue, bulk ops, reconcile."""

    def __init__(self, config: SubscriberRouteConfig | None = None,
                 executor=None, clock=time.time):
        self.config = config or SubscriberRouteConfig()
        self._exec = executor or (lambda c: "")
        self._clock = clock
        self._lock = threading.Lock()
        self._routes: dict[str, SubscriberRoute] = {}  # session_id ->
        self._by_ip: dict[str, str] = {}
        self._retry: list[tuple[str, SubscriberRoute, int]] = []  # (op, rt, n)
        self.stats = {"injected": 0, "withdrawn": 0, "failed": 0,
                      "retried": 0, "retry_errors": 0}

    def _community_for(self, subscriber_class: str) -> str:
        return self.config.communities_by_class.get(
            subscriber_class, self.config.default_community)

    def inject_route(self, session_id: str, subscriber_id: str, ip: str,
                     subscriber_class: str = "") -> SubscriberRoute:
        """subscriber_routes.go:183-272."""
        if not self.config.enabled:
            raise ValueError("subscriber routes disabled")
        ipaddress.ip_address(ip)
        route = SubscriberRoute(
            session_id=session_id, subscriber_id=subscriber_id, ip=ip,
            subscriber_class=subscriber_class,
            community=self._community_for(subscriber_class),
            injected_at=self._clock())
        try:
            self._exec(
                "configure terminal\n"
                f"ip route {ip}/32 Null0 tag 500\n"
                f"route-map SUBSCRIBER-{route.community.replace(':', '-')} "
                "permit 10\n"
                f"set community {route.community}")
        except Exception:
            self.stats["failed"] += 1
            with self._lock:
                self._retry.append(("inject", route, 0))
            raise
        with self._lock:
            self._routes[session_id] = route
            self._by_ip[ip] = session_id
            self.stats["injected"] += 1
        return route

    def withdraw_route(self, session_id: str) -> None:
        """subscriber_routes.go:274-366."""
        with self._lock:
            route = self._routes.pop(session_id, None)
            if route is not None:
                self._by_ip.pop(route.ip, None)
        if route is None:
            raise KeyError(session_id)
        try:
            self._exec("configure terminal\n"
                       f"no ip route {route.ip}/32 Null0 tag 500")
        except Exception:
            self.stats["failed"] += 1
            with self._lock:
                self._retry.append(("withdraw", route, 0))
            return
        with self._lock:
            self.stats["withdrawn"] += 1

    def bulk_inject(self, routes: list[SubscriberRoute]) -> int:
        """subscriber_routes.go:368-425: one config session for N routes."""
        lines = ["configure terminal"]
        for r in routes:
            r.community = r.community or self._community_for(r.subscriber_class)
            lines.append(f"ip route {r.ip}/32 Null0 tag 500")
        self._exec("\n".join(lines))
        with self._lock:
            for r in routes:
                r.injected_at = self._clock()
                self._routes[r.session_id] = r
                self._by_ip[r.ip] = r.session_id
            self.stats["injected"] += len(routes)
        return len(routes)

    def bulk_withdraw(self) -> int:
        """subscriber_routes.go:427-482: graceful-shutdown everything."""
        with self._lock:
            routes = list(self._routes.values())
            self._routes.clear()
            self._by_ip.clear()
        if not routes:
            return 0
        lines = ["configure terminal"]
        lines += [f"no ip route {r.ip}/32 Null0 tag 500" for r in routes]
        self._exec("\n".join(lines))
        with self._lock:
            self.stats["withdrawn"] += len(routes)
        return len(routes)

    def retry_pending(self) -> int:
        """One pass of the retry worker (subscriber_routes.go:599-668)."""
        with self._lock:
            pending, self._retry = self._retry, []
        done = 0
        for op, route, attempts in pending:
            if attempts >= self.config.max_retries:
                continue
            try:
                if op == "inject":
                    self.inject_route(route.session_id, route.subscriber_id,
                                      route.ip, route.subscriber_class)
                else:
                    with self._lock:
                        self._routes[route.session_id] = route
                        self._by_ip[route.ip] = route.session_id
                    self.withdraw_route(route.session_id)
                done += 1
                self.stats["retried"] += 1
            except Exception:
                # still failing: requeue with the attempt count bumped,
                # and count it — an install that never converges must
                # show up in stats, not just sit in the retry deque
                self.stats["retry_errors"] += 1
                with self._lock:
                    self._retry.append((op, route, attempts + 1))
        return done

    def get_active_routes(self) -> list[SubscriberRoute]:
        with self._lock:
            return list(self._routes.values())

    def get_route_by_ip(self, ip: str) -> SubscriberRoute | None:
        with self._lock:
            sid = self._by_ip.get(ip)
            return self._routes.get(sid) if sid else None

    def route_stats(self) -> dict:
        with self._lock:
            return dict(self.stats, active=len(self._routes))
