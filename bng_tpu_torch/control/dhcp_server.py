"""Slow-path DHCPv4 server (copy of `bng_tpu/control/dhcp_server.py`).

The engine hands it the frames its device program PASSes
(`Engine(slow_path=server.handle_frame)`) and transmits the frames it
returns. It answers DISCOVER (lease, pending offer, or a new address from
the pool cascade), REQUEST (new lease, renewal, NAK, rebinding to a
requested address), RELEASE, DECLINE and INFORM; every granted lease is
written into the device tables through `FastPathTables` (`_update_fastpath`:
the subscriber row, and the circuit-ID and VLAN rows where the lease has
them), so the client's next request is answered on the device. The
optional hooks (authenticator, QoS, NAT, release, accounting, a
distributed allocator), per-MAC lease-time jitter, the expiry sweep and
the lease book's JSON export/restore are those of the reference. Reply
bytes come from `ReplyTemplate` renders, byte-identical to the reference.
`cleanup_expired` carries the chaos point `dhcp.expire` (kind `skew`).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass
from typing import Callable

from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos.faults import fault_point
from bng_tpu_torch.control import dhcp_codec
from bng_tpu_torch.control.dhcp_codec import (
    ACK, DECLINE, DISCOVER, INFORM, NAK, OFFER, RELEASE, REQUEST, DHCPPacket,
)
from bng_tpu_torch.control.pool import Pool, PoolExhaustedError, PoolManager
from bng_tpu_torch.utils.net import mac_to_u64, prefix_to_mask
from bng_tpu_torch.utils.structlog import ErrorLog


@dataclass
class Lease:
    mac: bytes
    ip: int
    pool_id: int
    expiry: int
    circuit_id: bytes = b""
    remote_id: bytes = b""
    s_tag: int = 0
    c_tag: int = 0
    session_id: str = ""
    client_class: int = 0
    username: str = ""
    qos_policy: str = ""  # the applied rate plan


@dataclass
class ServerStats:
    discover: int = 0
    offer: int = 0
    request: int = 0
    ack: int = 0
    nak: int = 0
    release: int = 0
    decline: int = 0
    inform: int = 0
    auth_reject: int = 0
    expired_cleaned: int = 0
    # allocations refused because every pool was exhausted: the DISCOVER
    # stays unanswered, but the refusal is counted and logged
    pool_exhausted: int = 0


class DHCPServer:
    # per-MAC lease times land in one of this many buckets spread over
    # [lt, lt * (1 + jitter_frac)], so a mass bring-up cannot make a
    # synchronised expiry cliff, and the reply-template cache stays at
    # BUCKETS entries per pool
    LEASE_JITTER_BUCKETS = 16

    def __init__(
        self,
        server_mac: bytes,
        server_ip: int,
        pool_manager: PoolManager,
        fastpath_tables=None,  # FastPathTables | None
        authenticator: Callable[..., dict | None] | None = None,
        qos_hook: Callable[[int, str], None] | None = None,  # (ip, policy)
        nat_hook: Callable[[int, int], None] | None = None,  # (ip, now)
        release_hook: Callable[[Lease], None] | None = None,
        accounting_hook: Callable[[str, Lease, str], None] | None = None,  # (event, lease, sid)
        allocator=None,  # distributed allocator, optional
        lease_time_cap: int | None = None,
        clock: Callable[[], float] = time.time,
        lease_jitter_frac: float = 0.0,
    ):
        self.server_mac = server_mac
        self.server_ip = server_ip
        self.pools = pool_manager
        self.tables = fastpath_tables
        self.authenticator = authenticator
        self.qos_hook = qos_hook
        self.nat_hook = nat_hook
        self.release_hook = release_hook
        self.accounting_hook = accounting_hook
        self.allocator = allocator
        self.lease_time_cap = lease_time_cap
        self.lease_jitter_frac = lease_jitter_frac
        self.clock = clock
        self.leases: dict[int, Lease] = {}  # mac_u64 -> Lease
        self.leases_by_cid: dict[bytes, int] = {}  # circuit_id -> mac_u64
        self._offers: dict[int, tuple[int, int]] = {}  # mac -> (ip, pool_id)
        self.stats = ServerStats()
        self._session_seq = 0
        # (pool value key) -> (options list, TLV bytes)
        self._reply_opts_cache: dict[tuple, tuple[list, bytes]] = {}
        # (msg_type,) + pool value key -> ReplyTemplate
        self._reply_template_cache: dict[tuple, dhcp_codec.ReplyTemplate] = {}
        self._exhaust_log = ErrorLog("dhcp-pool",
                                     "DHCP pool exhausted — DISCOVER left unanswered")

    # ------------------------------------------------------------------
    def handle_frame(self, raw: bytes) -> bytes | None:
        """Process one slow-path frame; returns a reply frame or None."""
        try:
            dec = F.decode(raw)
            if dec.proto != 17 or dec.dst_port != 67:
                return None
            req = dhcp_codec.decode(dec.payload)
        except Exception:  # noqa: BLE001 — a malformed frame gets no reply
            return None
        if req.op != 1:
            return None
        reply = self.handle_packet(req, vlans=dec.vlans, src_mac=dec.src_mac)
        if reply is None:
            return None
        return self._frame_for_reply(req, reply, dec)

    def handle_packet(self, req: DHCPPacket, vlans: list[int] | None = None,
                      src_mac: bytes = b"") -> DHCPPacket | None:
        t = req.msg_type
        vlans = vlans or []
        if t == DISCOVER:
            return self._discover(req, vlans)
        if t == REQUEST:
            return self._request(req, vlans)
        if t == RELEASE:
            self._release(req)
            return None
        if t == DECLINE:
            self._decline(req)
            return None
        if t == INFORM:
            return self._inform(req)
        return None

    # ------------------------------------------------------------------
    def _now(self) -> int:
        return int(self.clock())

    def _mac_key(self, req: DHCPPacket) -> int:
        return mac_to_u64(req.chaddr[:6])

    def _find_lease(self, req: DHCPPacket) -> Lease | None:
        """Lease by circuit-ID, then by MAC."""
        cid, _ = req.option82()
        if cid:
            mk = self.leases_by_cid.get(cid)
            if mk is not None:
                return self.leases.get(mk)
        return self.leases.get(self._mac_key(req))

    def _allocate_ip(self, req: DHCPPacket, client_class: int) -> tuple[int, int] | None:
        """The distributed allocator first, then the local pool."""
        mac = req.chaddr[:6]
        owner = mac.hex()
        if self.allocator is not None:
            got = self.allocator.allocate(owner)
            if got is not None:
                ip = got if isinstance(got, int) else got[0]
                pool = self.pools.pool_for_ip(ip)
                if pool is not None and pool.allocate_specific(ip, owner):
                    return ip, pool.pool_id
        pool = self.pools.classify(client_class)
        if pool is None:
            return None
        try:
            return pool.allocate(owner), pool.pool_id
        except PoolExhaustedError as e:
            self.stats.pool_exhausted += 1
            self._exhaust_log.report(e, mac=owner)
            return None

    def _discover(self, req: DHCPPacket, vlans: list[int]) -> DHCPPacket | None:
        self.stats.discover += 1
        lease = self._find_lease(req)
        if lease is not None:
            ip, pool_id = lease.ip, lease.pool_id
        else:
            mk = self._mac_key(req)
            if mk in self._offers:
                ip, pool_id = self._offers[mk]
            else:
                got = self._allocate_ip(req, client_class=0)
                if got is None:
                    return None  # exhausted: stay silent
                ip, pool_id = got
                self._offers[mk] = (ip, pool_id)
        pool = self.pools.pools[pool_id]
        self.stats.offer += 1
        return self._build_reply(req, OFFER, ip, pool)

    def _request(self, req: DHCPPacket, vlans: list[int]) -> DHCPPacket | None:
        self.stats.request += 1
        now = self._now()
        mk = self._mac_key(req)
        mac = req.chaddr[:6]
        requested = req.requested_ip or req.ciaddr

        # authenticate new sessions
        profile: dict = {}
        lease = self.leases.get(mk)
        if lease is None and self.authenticator is not None:
            cid, rid = req.option82()
            result = self.authenticator(mac=mac, circuit_id=cid, remote_id=rid)
            if result is None:
                self.stats.auth_reject += 1
                self.stats.nak += 1
                return self._build_nak(req)
            profile = result

        # validate or confirm the address
        if lease is not None and (requested == 0 or requested == lease.ip):
            ip, pool_id = lease.ip, lease.pool_id
        else:
            offered = self._offers.get(mk)
            if offered is not None and (requested == 0 or requested == offered[0]):
                ip, pool_id = offered
            elif requested:
                pool = self.pools.pool_for_ip(requested)
                if pool is None or not pool.allocate_specific(requested, mac.hex()):
                    self.stats.nak += 1
                    return self._build_nak(req)
                ip, pool_id = requested, pool.pool_id
            else:
                self.stats.nak += 1
                return self._build_nak(req)

        pool = self.pools.pools[pool_id]
        lease_time = profile.get("lease_time", pool.lease_time)
        if self.lease_time_cap:
            lease_time = min(lease_time, self.lease_time_cap)
        lease_time = self._jittered_lease_time(lease_time, mk)
        cid, rid = req.option82()
        existing = self.leases.get(mk)
        is_renewal = existing is not None and existing.ip == ip
        if is_renewal:
            # RFC 2131 renewal: extend the session, do not open a new one
            lease = existing
            lease.expiry = now + lease_time
            if lease.circuit_id and lease.circuit_id != cid:
                # the subscriber moved ports: drop the stale circuit-ID
                # index and device row before a later port user inherits it
                self.leases_by_cid.pop(lease.circuit_id, None)
                if self.tables is not None:
                    self.tables.remove_circuit_id_subscriber(lease.circuit_id)
            lease.circuit_id, lease.remote_id = cid, rid
        else:
            if existing is not None:
                # the same MAC granted another address: tear the old lease
                # down rather than orphan its address and session
                old_pool = self.pools.pools.get(existing.pool_id)
                if old_pool is not None:
                    old_pool.release(existing.ip)
                if existing.circuit_id:
                    self.leases_by_cid.pop(existing.circuit_id, None)
                if self.accounting_hook is not None:
                    self.accounting_hook("stop", existing, existing.session_id)
            self._session_seq += 1
            lease = Lease(
                mac=mac, ip=ip, pool_id=pool_id, expiry=now + lease_time,
                circuit_id=cid, remote_id=rid,
                s_tag=profile.get("s_tag", 0), c_tag=profile.get("c_tag", 0),
                session_id=f"bng-{now:x}-{self._session_seq:06x}",
                username=profile.get("username", ""),
                qos_policy=profile.get("qos_policy", ""),
            )
        self.leases[mk] = lease
        if cid:
            self.leases_by_cid[cid] = mk
        self._offers.pop(mk, None)

        self._update_fastpath(lease, pool)

        # QoS and NAT wiring for new sessions only
        if not is_renewal:
            if self.qos_hook is not None:
                self.qos_hook(ip, profile.get("qos_policy", ""))
            if self.nat_hook is not None:
                self.nat_hook(ip, now)
            if self.accounting_hook is not None:
                self.accounting_hook("start", lease, lease.session_id)
        elif self.accounting_hook is not None:
            # a renewal opens no session, but lease-state consumers must
            # see the new expiry
            self.accounting_hook("renew", lease, lease.session_id)

        self.stats.ack += 1
        return self._build_reply(req, ACK, ip, pool, lease_time=lease_time)

    def _release(self, req: DHCPPacket) -> None:
        self.stats.release += 1
        mk = self._mac_key(req)
        lease = self.leases.pop(mk, None)
        if lease is None:
            return
        if lease.circuit_id:
            self.leases_by_cid.pop(lease.circuit_id, None)
        pool = self.pools.pools.get(lease.pool_id)
        if pool is not None:
            pool.release(lease.ip)
        if self.tables is not None:
            self.tables.remove_subscriber(lease.mac)
            if lease.circuit_id:
                self.tables.remove_circuit_id_subscriber(lease.circuit_id)
            if lease.s_tag or lease.c_tag:
                self.tables.remove_vlan_subscriber(lease.s_tag, lease.c_tag)
        if self.allocator is not None:
            self.allocator.release(lease.mac.hex())
        if self.release_hook is not None:
            self.release_hook(lease)
        if self.accounting_hook is not None:
            self.accounting_hook("stop", lease, lease.session_id)

    def _decline(self, req: DHCPPacket) -> None:
        """The client detected an address conflict."""
        self.stats.decline += 1
        ip = req.requested_ip
        if not ip:
            return
        pool = self.pools.pool_for_ip(ip)
        if pool is not None:
            pool.decline(ip)
        mk = self._mac_key(req)
        lease = self.leases.pop(mk, None)
        if lease is not None and self.tables is not None:
            self.tables.remove_subscriber(lease.mac)

    def _inform(self, req: DHCPPacket) -> DHCPPacket | None:
        self.stats.inform += 1
        pool = self.pools.pool_for_ip(req.ciaddr) if req.ciaddr else None
        if pool is None:
            pool = self.pools.classify(0)
        if pool is None:
            return None
        # ACK without yiaddr or lease time (RFC 2131 §4.3.5)
        return self._build_reply(req, ACK, 0, pool, include_lease=False)

    # ------------------------------------------------------------------
    def _update_fastpath(self, lease: Lease, pool: Pool) -> None:
        """Write the lease into the device tables (nil-safe)."""
        if self.tables is None:
            return
        self.tables.add_subscriber(lease.mac, pool_id=pool.pool_id, ip=lease.ip,
                                   lease_expiry=lease.expiry, client_class=lease.client_class)
        if lease.circuit_id:
            self.tables.add_circuit_id_subscriber(
                lease.circuit_id, pool_id=pool.pool_id, ip=lease.ip,
                lease_expiry=lease.expiry, client_class=lease.client_class)
        if lease.s_tag or lease.c_tag:
            self.tables.add_vlan_subscriber(
                lease.s_tag, lease.c_tag, pool_id=pool.pool_id, ip=lease.ip,
                lease_expiry=lease.expiry, client_class=lease.client_class)

    # -- the lease book as JSON --
    def export_leases(self) -> dict:
        """The lease book, JSON-serialisable (bytes as hex). Pending offers
        are dropped: a client mid-DORA across a restart re-DISCOVERs."""
        return {
            "session_seq": self._session_seq,
            "leases": [{
                "mac": l.mac.hex(), "ip": l.ip, "pool_id": l.pool_id,
                "expiry": l.expiry, "circuit_id": l.circuit_id.hex(),
                "remote_id": l.remote_id.hex(), "s_tag": l.s_tag,
                "c_tag": l.c_tag, "session_id": l.session_id,
                "client_class": l.client_class, "username": l.username,
                "qos_policy": l.qos_policy,
            } for l in self.leases.values()],
        }

    def export_offers(self) -> list[dict]:
        """The pending (un-ACKed) offers, JSON-safe."""
        return [{"mac": f"{mk:012x}", "ip": int(ip), "pool_id": int(pid)}
                for mk, (ip, pid) in self._offers.items()]

    def restore_offers(self, entries: list[dict]) -> int:
        """Re-arm transferred offers: re-claim each address under the
        client's owner tag; an address this server cannot claim drops its
        offer (the client retries its DORA)."""
        restored = 0
        for o in entries:
            mk = int(o["mac"], 16)
            ip, pid = int(o["ip"]), int(o["pool_id"])
            pool = self.pools.pools.get(pid)
            if pool is None or not pool.allocate_specific(ip, o["mac"].lower()):
                continue
            self._offers[mk] = (ip, pid)
            restored += 1
        return restored

    @staticmethod
    def parse_lease_state(state: dict) -> tuple[int, list[Lease]]:
        """export_leases() output -> (session_seq, leases), touching no
        server state."""
        leases = [Lease(
            mac=bytes.fromhex(d["mac"]), ip=int(d["ip"]),
            pool_id=int(d["pool_id"]), expiry=int(d["expiry"]),
            circuit_id=bytes.fromhex(d.get("circuit_id", "")),
            remote_id=bytes.fromhex(d.get("remote_id", "")),
            s_tag=int(d.get("s_tag", 0)), c_tag=int(d.get("c_tag", 0)),
            session_id=d.get("session_id", ""),
            client_class=int(d.get("client_class", 0)),
            username=d.get("username", ""),
            qos_policy=d.get("qos_policy", ""))
            for d in state.get("leases", [])]
        return int(state.get("session_seq", 0)), leases

    def restore_leases(self, state: dict) -> int:
        """Rebuild the lease book, the circuit-ID index and pool occupancy
        from export_leases() output (the device rows travel with the table
        state, not here). Returns the number of leases restored."""
        seq, leases = self.parse_lease_state(state)
        self._session_seq = max(self._session_seq, seq)
        for lease in leases:
            mk = mac_to_u64(lease.mac)
            self.leases[mk] = lease
            if lease.circuit_id:
                self.leases_by_cid[lease.circuit_id] = mk
            pool = self.pools.pools.get(lease.pool_id)
            if pool is not None:
                pool.allocate_specific(lease.ip, lease.mac.hex())
        return len(leases)

    def _jittered_lease_time(self, lt: int, mk: int) -> int:
        """Deterministic per-MAC lease-time spread. It only extends the
        base lease time: clients renew at half the value they were told."""
        frac = self.lease_jitter_frac
        if frac <= 0.0 or lt <= 0:
            return lt
        step = int(lt * frac) // self.LEASE_JITTER_BUCKETS
        if step <= 0:
            return lt
        bucket = ((mk * 0x9E3779B97F4A7C15) >> 33) % self.LEASE_JITTER_BUCKETS
        return lt + bucket * step

    def cleanup_expired(self, now: int | None = None, max_reaps: int | None = None) -> int:
        """Reap expired leases, at most `max_reaps` per sweep (the rest
        stay expired and owned everywhere until the next sweep)."""
        now = now if now is not None else self._now()
        fp = fault_point("dhcp.expire")
        if fp is not None and fp.kind == "skew":
            # chaos: a skewed expiry clock; early expiry costs a re-DORA, never
            # a double allocation
            now = int(now + fp.arg)
        dead = []
        for mk, l in self.leases.items():
            if l.expiry < now:
                dead.append(mk)
                if max_reaps is not None and len(dead) >= max_reaps:
                    break
        for mk in dead:
            lease = self.leases.pop(mk)
            if lease.circuit_id:
                self.leases_by_cid.pop(lease.circuit_id, None)
            pool = self.pools.pools.get(lease.pool_id)
            if pool is not None:
                pool.release(lease.ip)
            if self.tables is not None:
                self.tables.remove_subscriber(lease.mac)
                if lease.circuit_id:
                    self.tables.remove_circuit_id_subscriber(lease.circuit_id)
                if lease.s_tag or lease.c_tag:
                    self.tables.remove_vlan_subscriber(lease.s_tag, lease.c_tag)
            if self.allocator is not None:
                self.allocator.release(lease.mac.hex())
            if self.release_hook is not None:
                self.release_hook(lease)
            if self.accounting_hook is not None:
                self.accounting_hook("stop", lease, lease.session_id)
            self.stats.expired_cleaned += 1
        return len(dead)

    # ------------------------------------------------------------------
    def _static_reply_options(self, pool: Pool, lt: int,
                              include_lease: bool) -> tuple[list, bytes, tuple]:
        """The options after MSG_TYPE depend only on the pool and lease
        config: built once per key (every option-relevant value, so a
        reconfigured pool never serves a stale suffix). Returns (options,
        TLV bytes, key)."""
        key = (pool.pool_id, lt, include_lease, pool.prefix_len,
               pool.gateway, pool.dns_primary, pool.dns_secondary, self.server_ip)
        hit = self._reply_opts_cache.get(key)
        if hit is not None:
            return hit[0], hit[1], key
        opts = [(dhcp_codec.OPT_SERVER_ID, struct.pack("!I", self.server_ip))]
        if include_lease:
            opts.append((dhcp_codec.OPT_LEASE_TIME, struct.pack("!I", lt)))
        opts.append((dhcp_codec.OPT_SUBNET_MASK,
                     struct.pack("!I", prefix_to_mask(pool.prefix_len))))
        opts.append((dhcp_codec.OPT_ROUTER, struct.pack("!I", pool.gateway)))
        if pool.dns_primary:
            dns = struct.pack("!I", pool.dns_primary)
            if pool.dns_secondary:
                dns += struct.pack("!I", pool.dns_secondary)
            opts.append((dhcp_codec.OPT_DNS, dns))
        if include_lease:
            opts.append((dhcp_codec.OPT_RENEWAL_TIME, struct.pack("!I", lt // 2)))
            opts.append((dhcp_codec.OPT_REBIND_TIME, struct.pack("!I", (lt * 7) // 8)))
        hit = (opts, dhcp_codec.encode_options(opts))
        if len(self._reply_opts_cache) >= 1024:  # bounded: per-subscriber lease times
            self._reply_opts_cache.pop(next(iter(self._reply_opts_cache)))
        self._reply_opts_cache[key] = hit
        return hit[0], hit[1], key

    def _reply_template(self, msg_type: int, pool: Pool, lt: int,
                        include_lease: bool) -> dhcp_codec.ReplyTemplate:
        static_opts, static_raw, key = self._static_reply_options(pool, lt, include_lease)
        tkey = (msg_type,) + key
        tmpl = self._reply_template_cache.get(tkey)
        if tmpl is not None:
            return tmpl
        mt_raw = bytes((dhcp_codec.OPT_MSG_TYPE, 1, msg_type))
        tmpl = dhcp_codec.ReplyTemplate(
            [(dhcp_codec.OPT_MSG_TYPE, bytes([msg_type]))] + static_opts,
            siaddr=self.server_ip, options_raw=mt_raw + static_raw)
        if len(self._reply_template_cache) >= 1024:
            self._reply_template_cache.pop(next(iter(self._reply_template_cache)))
        self._reply_template_cache[tkey] = tmpl
        return tmpl

    def _build_reply(self, req: DHCPPacket, msg_type: int, ip: int, pool: Pool,
                     lease_time: int | None = None, include_lease: bool = True) -> DHCPPacket:
        lt = lease_time if lease_time is not None else pool.lease_time
        ciaddr = req.ciaddr if msg_type == ACK else 0
        tmpl = self._reply_template(msg_type, pool, lt, include_lease)
        p = DHCPPacket(op=2, xid=req.xid, flags=req.flags, ciaddr=ciaddr, yiaddr=ip,
                       siaddr=self.server_ip, giaddr=req.giaddr, chaddr=req.chaddr)
        # a fresh list of the shared option tuples: the snapshot check keeps
        # the render valid until a caller changes the options
        p.options = list(tmpl.options)
        p.set_encoded(tmpl.render(req.xid, req.chaddr, yiaddr=ip, flags=req.flags,
                                  ciaddr=ciaddr, giaddr=req.giaddr))
        return p

    def _build_nak(self, req: DHCPPacket) -> DHCPPacket:
        p = DHCPPacket(op=2, xid=req.xid, flags=req.flags, giaddr=req.giaddr, chaddr=req.chaddr)
        p.options.append((dhcp_codec.OPT_MSG_TYPE, bytes([NAK])))
        p.options.append((dhcp_codec.OPT_SERVER_ID, struct.pack("!I", self.server_ip)))
        return p

    def _frame_for_reply(self, req: DHCPPacket, reply: DHCPPacket,
                         dec: F.DecodedPacket) -> bytes:
        """L2/L3 reply addressing, as the device compose addresses it."""
        payload = reply.encode()
        if req.giaddr:
            return F.udp_packet(self.server_mac, dec.src_mac, self.server_ip, req.giaddr,
                                67, 67, payload, vlans=dec.vlans or None)
        use_bcast = bool(req.flags & 0x8000) or req.ciaddr == 0
        dst_mac = b"\xff" * 6 if use_bcast else req.chaddr[:6]
        return F.udp_packet(self.server_mac, dst_mac, self.server_ip, 0xFFFFFFFF,
                            67, 68, payload, vlans=dec.vlans or None)
