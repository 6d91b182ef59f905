"""Control-plane -> device-row compilers for the edge subsystem.

The port's copy of `bng_tpu/edge/compile.py`: the same rows, the same
mirror-sink calls, over the port's `EdgeTables` and control plane.

Three pieces, all single-purpose and host-side:

- `InterceptTapProgram` — compiles `control/intercept.py` warrants into
  `EdgeTables` tap rows + dense filter rows. A device row exists iff
  its warrant is ACTIVE and inside its validity window; `sync()` is the
  reconcile sweep that arms newly-active warrants (by `target_ipv4`)
  and reaps rows whose warrant expired/was revoked — the audit clause
  (`_audit_edge`) proves exactly this correspondence.
- `RouteProgram` — compiles `control/routing.py` manager state (ISP
  tables + per-class ECMP across non-DOWN upstreams) into next-hop
  rows. Link flaps arrive via the manager's `on_upstream_down/up`
  hooks and recompile ONLY the rows whose selection changed — bounded
  dirty-slot deltas through the existing drain, never a resync.
- `MirrorPump` — the host retire half of interception: the engine's
  `mirror_sink` hands it (lane, frame, wid) for every MIRROR-flagged
  lane; it resolves the warrant, parses the flow 5-tuple from the
  frame bytes and feeds `InterceptManager.record_cc` (which applies
  the authoritative filters and delivers HI3 via the configured
  exporter, e.g. `ETSIExporter`).
"""

from __future__ import annotations

import time

from bng_tpu_torch.control.intercept import (Direction, InterceptManager, Warrant,
                                       WarrantStatus)
from bng_tpu_torch.edge.tables import EdgeTables
from bng_tpu_torch.utils.net import fnv1a32, ip_to_u32, u32_to_ip

# subscriber-class wire codes (RW_CLASS word); parity with the BGP
# community split in control/routing.py SubscriberRouteManager
CLASS_CODES = {"residential": 1, "business": 2, "wholesale": 3}


def _active_in_window(w: Warrant, now: float) -> bool:
    return (w.status == WarrantStatus.ACTIVE
            and w.valid_from <= now < w.valid_until)


class InterceptTapProgram:
    """Single writer for the tap table: warrant -> device rows."""

    def __init__(self, edge: EdgeTables, manager: InterceptManager,
                 clock=time.time):
        self.edge = edge
        self.manager = manager
        self._clock = clock
        self._wid_by_warrant: dict[str, int] = {}
        self._warrant_by_wid: dict[int, str] = {}
        self._ips_by_wid: dict[int, set[int]] = {}
        self._next_wid = 1
        self.stats = {"armed": 0, "disarmed": 0, "reaped": 0, "syncs": 0,
                      "filters_dropped": 0}

    # -- identity -------------------------------------------------------
    def wid_for(self, warrant_id: str) -> int:
        """Stable device wid for a warrant (assigned on first use)."""
        wid = self._wid_by_warrant.get(warrant_id)
        if wid is None:
            wid = self._next_wid
            self._next_wid += 1
            self._wid_by_warrant[warrant_id] = wid
            self._warrant_by_wid[wid] = warrant_id
        return wid

    def warrant_for(self, wid: int) -> str | None:
        return self._warrant_by_wid.get(wid)

    def armed_ips(self, wid: int) -> set[int]:
        return set(self._ips_by_wid.get(wid, ()))

    # -- filter compilation --------------------------------------------
    @staticmethod
    def compile_filters(w: Warrant) -> list[tuple[int, int, int]]:
        """Warrant filter lists -> dense conjunct rows (port, proto,
        peer). List semantics are AND across non-empty dimensions, OR
        within one — compiled as the cartesian product with 0 standing
        for a wildcard dimension. The device match is a pre-filter (its
        single port column matches src OR dst); `record_cc` re-applies
        the exact host filters on every mirrored frame."""
        ports = sorted(set(w.filter_source_ports) | set(w.filter_dest_ports))
        protos = sorted(set(w.filter_protocols))
        peers = sorted({ip_to_u32(ip) for ip in w.filter_dest_ips
                        if ip and ":" not in ip})
        if not (ports or protos or peers):
            return []
        rows = []
        for port in ports or (0,):
            for proto in protos or (0,):
                for peer in peers or (0,):
                    rows.append((port, proto, peer))
        return rows

    # -- arming ---------------------------------------------------------
    def arm_session(self, warrant: Warrant, ipv4: str | int) -> int:
        """Arm a tap on a live session's IPv4 under `warrant`; returns
        the device wid. Explicit-arm path for session-matched warrants
        (e.g. `match_session` hits mid-storm); `sync()` covers
        IP-targeted warrants."""
        ip = ipv4 if isinstance(ipv4, int) else ip_to_u32(ipv4)
        wid = self.wid_for(warrant.id)
        rows = self.compile_filters(warrant)
        self.edge.arm_tap(ip, wid, rows)
        if rows and self.edge.set_tap_filters(wid, rows) < len(rows):
            self.stats["filters_dropped"] += 1
        self._ips_by_wid.setdefault(wid, set()).add(ip)
        self.stats["armed"] += 1
        return wid

    def disarm_session(self, warrant_id: str, ipv4: str | int) -> bool:
        ip = ipv4 if isinstance(ipv4, int) else ip_to_u32(ipv4)
        wid = self._wid_by_warrant.get(warrant_id)
        if wid is None:
            return False
        ok = self.edge.disarm_tap(ip)
        if ok:
            self.stats["disarmed"] += 1
            ips = self._ips_by_wid.get(wid, set())
            ips.discard(ip)
            if not ips:
                self.edge.set_tap_filters(wid, ())
        return ok

    # -- reconcile sweep ------------------------------------------------
    def sync(self) -> dict:
        """Make the device table agree with the warrant store: arm
        ACTIVE in-window warrants that target an IPv4; reap every row
        whose warrant is expired/revoked/suspended or gone. Bounded by
        the warrant store size, idempotent."""
        now = self._clock()
        active: dict[str, Warrant] = {
            w.id: w for w in self.manager.list_warrants()
            if _active_in_window(w, now)}
        armed_now = 0
        for w in active.values():
            if w.target_ipv4:
                ip = ip_to_u32(w.target_ipv4)
                wid = self.wid_for(w.id)
                # check the device row too, not just our bookkeeping: a
                # row lost behind our back (restore into a smaller
                # geometry, manual delete) must re-arm here
                if (ip not in self._ips_by_wid.get(wid, set())
                        or self.edge.get_tap(ip) is None):
                    self.arm_session(w, ip)
                    armed_now += 1
        reaped = 0
        for wid, ips in list(self._ips_by_wid.items()):
            wid_warrant = self._warrant_by_wid[wid]
            if wid_warrant in active:
                continue
            for ip in list(ips):
                if self.edge.disarm_tap(ip):
                    reaped += 1
                ips.discard(ip)
            self.edge.set_tap_filters(wid, ())
        self.stats["reaped"] += reaped
        self.stats["syncs"] += 1
        return {"armed": armed_now, "reaped": reaped,
                "rows": len(self.edge.tap_rows())}


class RouteProgram:
    """Single writer for the next-hop table: routing manager -> rows.

    Next-hop selection is deterministic weighted ECMP: hash the
    subscriber IP (FNV-1a32 over the 4 wire-order bytes — the same
    family as the cluster's MAC steering) modulo the total weight of
    eligible upstreams, walked in name order. Eligible = not DOWN, has
    a resolved neighbor MAC, and allowed for the subscriber's class
    (`class_tables`, empty = any). A flap changes eligibility, so
    `recompile()` after `on_upstream_down/up` rewrites exactly the
    rows whose selection moved — the bounded delta the drain ships.
    """

    def __init__(self, edge: EdgeTables, manager,
                 class_tables: dict[str, tuple[int, ...]] | None = None):
        self.edge = edge
        self.manager = manager
        self.class_tables = dict(class_tables or {})
        self._neighbors: dict[str, bytes] = {}   # gateway ip -> MAC
        self._bindings: dict[int, str] = {}      # sub ip u32 -> class
        self.stats = {"bound": 0, "recompiles": 0, "deltas": 0,
                      "flaps": 0, "unroutable": 0}

    def attach(self) -> None:
        """Install the flap hooks on the manager (health checks then
        drive bounded recompiles with no further wiring)."""
        self.manager.on_upstream_down = self.on_upstream_down
        self.manager.on_upstream_up = self.on_upstream_up

    def set_neighbor(self, gateway_ip: str, mac: bytes) -> None:
        """ARP/ND stand-in: resolved L2 next-hop for a gateway."""
        self._neighbors[gateway_ip] = bytes(mac[:6])
        self.recompile()

    # -- selection ------------------------------------------------------
    def _eligible(self, klass: str):
        from bng_tpu_torch.control.routing import LinkState

        allowed = self.class_tables.get(klass)
        out = []
        for up in sorted(self.manager.list_upstreams(),
                         key=lambda u: u.name):
            if up.state == LinkState.DOWN:
                continue
            if up.gateway not in self._neighbors:
                continue
            if allowed is not None and up.table not in allowed:
                continue
            out.append(up)
        return out

    def select(self, sub_ip: int, klass: str):
        """(upstream, mac) for a subscriber, or None if nothing routes."""
        ups = self._eligible(klass)
        total = sum(max(1, u.weight) for u in ups)
        if total == 0:
            return None
        h = fnv1a32(int(sub_ip).to_bytes(4, "big")) % total
        acc = 0
        for up in ups:
            acc += max(1, up.weight)
            if h < acc:
                return up, self._neighbors[up.gateway]
        return None  # unreachable

    def expected_row(self, sub_ip: int):
        """(mac_hi, mac_lo, table, class_code) the device row must hold
        for a bound subscriber — the audit's recompute oracle."""
        klass = self._bindings.get(sub_ip)
        if klass is None:
            return None
        sel = self.select(sub_ip, klass)
        if sel is None:
            return None
        up, mac = sel
        return (int.from_bytes(mac[:2], "big"),
                int.from_bytes(mac[2:6], "big"),
                up.table, CLASS_CODES.get(klass, 0))

    # -- binding + recompile -------------------------------------------
    def bind_subscriber(self, ip: str | int,
                        klass: str = "residential") -> bool:
        """Steer a subscriber's upstream traffic through its class's
        ECMP selection; installs the row immediately. Returns False if
        nothing is eligible (row left absent, counted unroutable)."""
        sub = ip if isinstance(ip, int) else ip_to_u32(ip)
        self._bindings[sub] = klass
        self.stats["bound"] += 1
        return self._install(sub) is not None

    def unbind_subscriber(self, ip: str | int) -> bool:
        sub = ip if isinstance(ip, int) else ip_to_u32(ip)
        self._bindings.pop(sub, None)
        return self.edge.clear_route(sub)

    def _install(self, sub: int):
        want = self.expected_row(sub)
        if want is None:
            self.stats["unroutable"] += 1
            self.edge.clear_route(sub)
            return None
        from bng_tpu_torch.edge.ops import RW_CLASS, RW_MAC_HI, RW_MAC_LO, RW_TABLE

        have = self.edge.get_route(sub)
        if have is not None and (int(have[RW_MAC_HI]), int(have[RW_MAC_LO]),
                                 int(have[RW_TABLE]),
                                 int(have[RW_CLASS])) == want:
            return want  # selection unchanged: no dirty slot
        mac = (want[0].to_bytes(2, "big") + want[1].to_bytes(4, "big"))
        self.edge.set_route(sub, mac, want[2], want[3])
        self.stats["deltas"] += 1
        return want

    def recompile(self, ips=None) -> dict:
        """Re-run selection for bound subscribers; write only changed
        rows. Returns {"checked", "rewritten"} — `rewritten` is the
        bounded delta size a flap actually ships to the device."""
        before = self.stats["deltas"]
        targets = list(self._bindings) if ips is None else list(ips)
        for sub in targets:
            if sub in self._bindings:
                self._install(sub)
        self.stats["recompiles"] += 1
        return {"checked": len(targets),
                "rewritten": self.stats["deltas"] - before}

    # -- flap hooks (manager.check_health callbacks) -------------------
    def on_upstream_down(self, name: str) -> dict:
        self.stats["flaps"] += 1
        return self.recompile()

    def on_upstream_up(self, name: str) -> dict:
        self.stats["flaps"] += 1
        return self.recompile()


class MirrorPump:
    """Host retire half of interception: MIRROR-flagged frames ->
    `record_cc`/HI3. Plugs into the engine as `mirror_sink`."""

    def __init__(self, program: InterceptTapProgram,
                 manager: InterceptManager | None = None):
        self.program = program
        self.manager = manager or program.manager
        self.stats = {"mirrored": 0, "cc_records": 0, "filtered": 0,
                      "dropped": 0}

    def __call__(self, lane: int, frame: bytes, wid: int) -> None:
        self.stats["mirrored"] += 1
        warrant_id = self.program.warrant_for(wid)
        if warrant_id is None:
            self.stats["dropped"] += 1
            return
        try:
            warrant = self.manager.get_warrant(warrant_id)
        except KeyError:
            self.stats["dropped"] += 1
            return
        flow = self._parse(frame)
        if flow is None:
            self.stats["dropped"] += 1
            return
        src, dst, sport, dport, proto = flow
        sid = f"tap-{wid}"
        session = self.manager.get_session(sid)
        if session is None:
            session = self.manager.start_intercept_session(
                warrant, sid, subscriber_id=warrant.target_subscriber_id,
                ipv4=warrant.target_ipv4)
        direction = (Direction.UPSTREAM
                     if ip_to_u32(src) in self.program.armed_ips(wid)
                     else Direction.DOWNSTREAM)
        if self.manager.record_cc(warrant, session, direction, src, dst,
                                  sport, dport, proto, frame):
            self.stats["cc_records"] += 1
        else:
            self.stats["filtered"] += 1

    @staticmethod
    def _parse(frame: bytes):
        """(src, dst, sport, dport, proto) from an IPv4 frame, or None.
        Mirrors ops/parse.py's VLAN walk (one 802.1Q or QinQ pair)."""
        if len(frame) < 34:
            return None
        off = 12
        et = int.from_bytes(frame[off:off + 2], "big")
        while et in (0x8100, 0x88A8) and len(frame) >= off + 6:
            off += 4
            et = int.from_bytes(frame[off:off + 2], "big")
        if et != 0x0800:
            return None
        l3 = off + 2
        if len(frame) < l3 + 20:
            return None
        ihl = (frame[l3] & 0x0F) * 4
        proto = frame[l3 + 9]
        src = u32_to_ip(int.from_bytes(frame[l3 + 12:l3 + 16], "big"))
        dst = u32_to_ip(int.from_bytes(frame[l3 + 16:l3 + 20], "big"))
        sport = dport = 0
        l4 = l3 + ihl
        if proto in (6, 17) and len(frame) >= l4 + 4:
            sport = int.from_bytes(frame[l4:l4 + 2], "big")
            dport = int.from_bytes(frame[l4 + 2:l4 + 4], "big")
        return src, dst, sport, dport, proto
