"""Scripted chaos scenarios (copy of `bng_tpu/chaos/scenarios.py`).

Every scenario is a function `(seed) -> dict` — or `(seed, device)` for
the five that build device state (an engine, a scheduler or a sharded
cluster), where `device=None` means the card: it builds its own small
component stack (inline fleet / parent server / NAT manager / engine) on
a `SimClock`, arms a pinned `FaultPlan`, drives real protocol traffic
through the real code paths, and finishes with a cross-authority
invariant audit. The contract the suite enforces:

    faults may degrade SERVICE (lost DORAs, shed frames, late replies)
    but never CONSISTENCY (the closing audit must be clean).

Reports contain no wallclock, no filesystem paths and no object ids —
two runs with the same seed emit byte-identical JSON, on the card and on
the CPU alike, and equal to the reference's.

Scenario list:

    dora_worker_crash         kill a fleet worker at every scatter hit
                              (plus a fault-free control sweep)
    corrupt_restore_cold_start truncation/bit-flip/io-error on the
                              checkpoint write+read paths: reject, fall
                              back to the previous good file, cold-start
                              semantics, then a clean restore
    fleet_reshard_under_kill  kill a worker mid-traffic, checkpoint the
                              books, restore onto a smaller fleet
    nat_expiry_under_skew     forward/backward clock skew over the NAT
                              expiry sweep; EIM/reverse/block bookkeeping
                              must survive both directions
    ha_delta_drop_reconnect   replication stream dies mid-delta + peer
                              timeout on reconnect; replay_since heals
    fleet_resize_under_kill   LIVE resize (shrink + grow) with a worker
                              killed at every transfer hit; in-flight
                              DORAs (un-ACKed OFFERs) must complete on
                              the new owners, zero drops
    rolling_restart_under_kill rolling worker replacement with a kill at
                              every rotation hit; books+offers+slices
                              move verbatim, the dead shard heals
    engine_swap_crash_rollback blue/green engine swap: clean flip serves
                              renewals on-device from the hydrated
                              standby; crash-mid-swap and snapshot
                              io_error roll back with the active
                              untouched
    sharded_swap_crash_rollback the same discipline on a 2-shard cluster
                              behind its steered ring
    intercept_tap_live        warrant-compiled taps mirror on the live
                              sharded serving path, filter at the
                              device, and provably reap on expiry
    route_flap_rewrite        next-hop rewrite rides a link flap as
                              bounded dirty-slot deltas; traffic
                              re-forwards via the survivor
    devloop_storm             express OFFER storm through the device-
                              resident serving loop against a saturated
                              bulk lane, with a mid-storm injected
                              ring dispatch failure; reply bytes must
                              match a fault-free control sweep and the
                              ring cursor audit must close clean
    cluster_failover_redora   DORA a town through a 3-instance cluster,
                              kill a member, its standby promotes and
                              the flash crowd re-DORAs sticky
    cluster_partial_partition sever exactly the a<->b fabric link while
                              both still reach c (NEAT): mutual
                              suspicion but no accusation quorum, so no
                              demotion, no failover, no double-carve
    cluster_gray_member       a member beats perfectly but its serving
                              word stalls: GRAY verdict off its own
                              signed beats, standby promotes, the
                              flash crowd re-DORAs sticky
    cluster_host_loss         two remote members join over the fabric,
                              then their whole host vanishes: group
                              promotion, the spool replays once
"""

from __future__ import annotations

import random

import numpy as np

from bng_tpu_torch import frames as packets
from bng_tpu_torch.chaos.faults import (BITFLIP, DROP_DELTA, FAIL, IO_ERROR, KILL, SKEW,
                                        TRUNCATE, FaultPlan, FaultSpec, SimClock, armed)
from bng_tpu_torch.chaos.invariants import audit_invariants
from bng_tpu_torch.control import dhcp_codec
from bng_tpu_torch.control.pool import Pool, PoolManager
from bng_tpu_torch.utils.net import ip_to_u32

SERVER_MAC = bytes.fromhex("02aabbccdd01")
SERVER_IP = ip_to_u32("10.0.0.1")


# ---------------------------------------------------------------------------
# shared builders (the reference's geometry, so reports match it)
# ---------------------------------------------------------------------------

def _mac(i: int) -> bytes:
    return (0x02C5 << 32 | i).to_bytes(6, "big")


def _discover(mac: bytes, xid: int) -> bytes:
    p = dhcp_codec.build_request(mac, dhcp_codec.DISCOVER, xid=xid)
    return packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                              p.encode().ljust(300, b"\x00"))


def _request(mac: bytes, ip: int, xid: int) -> bytes:
    p = dhcp_codec.build_request(mac, dhcp_codec.REQUEST, xid=xid,
                                 requested_ip=ip, server_id=SERVER_IP)
    return packets.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                              p.encode().ljust(300, b"\x00"))


def _renew(mac: bytes, ip: int, xid: int) -> bytes:
    p = dhcp_codec.build_request(mac, dhcp_codec.REQUEST, xid=xid, ciaddr=ip)
    return packets.udp_packet(mac, b"\xff" * 6, ip, SERVER_IP, 68, 67,
                              p.encode().ljust(300, b"\x00"))


def _release(mac: bytes, ip: int, xid: int) -> bytes:
    p = dhcp_codec.build_request(mac, dhcp_codec.RELEASE, xid=xid, ciaddr=ip)
    return packets.udp_packet(mac, b"\xff" * 6, ip, SERVER_IP, 68, 67,
                              p.encode().ljust(300, b"\x00"))


def _reply(frame: bytes) -> dhcp_codec.DHCPPacket:
    return dhcp_codec.decode(packets.decode(frame).payload)


def _make_fastpath():
    from bng_tpu_torch.runtime.tables import FastPathTables

    fp = FastPathTables(sub_nbuckets=512, vlan_nbuckets=64, cid_nbuckets=64,
                        max_pools=16)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    return fp


def _make_pools(fastpath=None, cidr_net: str = "10.0.0.0",
                prefix_len: int = 20):
    pools = PoolManager(fastpath)
    pools.add_pool(Pool(pool_id=1, network=ip_to_u32(cidr_net),
                        prefix_len=prefix_len, gateway=SERVER_IP,
                        dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    return pools


def build_fleet(n_workers: int, clock, slice_size: int = 64):
    """Inline fleet + parent pools + host fast-path tables — the
    deterministic stack every fleet scenario runs on."""
    from bng_tpu_torch.control.fleet import FleetSpec, SlowPathFleet

    fastpath = _make_fastpath()
    pools = _make_pools(fastpath)
    spec = FleetSpec.from_pool_manager(SERVER_MAC, SERVER_IP, pools,
                                       slice_size=slice_size,
                                       low_watermark=max(1, slice_size // 4))
    fleet = SlowPathFleet(spec, n_workers, pools, mode="inline",
                          table_sink=fastpath, clock=clock)
    return fleet, pools, fastpath


def dora_with_retries(fleet, macs, clock, rounds: int = 6) -> dict:
    """Drive each MAC through DORA, retransmitting lost exchanges once
    per round (the client-retry behavior every fault scenario leans on).
    Returns {mac: leased_ip}."""
    offers: dict[bytes, int] = {}
    leased: dict[bytes, int] = {}
    xid = 1
    for _ in range(rounds):
        batch, batch_macs = [], []
        for m in macs:
            if m in leased:
                continue
            if m in offers:
                batch.append((len(batch), _request(m, offers[m], xid)))
            else:
                batch.append((len(batch), _discover(m, xid)))
            batch_macs.append(m)
            xid += 1
        if not batch:
            break
        out = fleet.handle_batch(batch, now=clock())
        for (_lane, rep), m in zip(out, batch_macs):
            if rep is None:
                continue
            p = _reply(rep)
            if p.msg_type == dhcp_codec.OFFER:
                offers[m] = p.yiaddr
            elif p.msg_type == dhcp_codec.ACK:
                leased[m] = p.yiaddr
            elif p.msg_type == dhcp_codec.NAK:
                offers.pop(m, None)
        clock.advance(1.0)
    return leased


# ---------------------------------------------------------------------------
# 1. DORA under worker crash, killed at every fault-point hit
# ---------------------------------------------------------------------------

def dora_worker_crash(seed: int) -> dict:
    """Sweep the kill fault across scatter hits 0 (control: no fault)
    through 6. Each killed shard loses service — clients retransmit,
    survivors complete — but every sweep must audit clean."""
    n_macs, workers = 12, 3
    macs = [_mac((seed % 97) * 100 + i) for i in range(n_macs)]
    sweeps = []
    for hit in range(0, 7):
        clock = SimClock()
        fleet, pools, fastpath = build_fleet(workers, clock)
        specs = ([] if hit == 0
                 else [FaultSpec("fleet.scatter", KILL, at_hit=hit)])
        with armed(FaultPlan(seed=seed, specs=specs), log=False) as inj:
            leased = dora_with_retries(fleet, macs, clock)
        audit = audit_invariants(pools=pools, fleet=fleet,
                                 fastpath=fastpath)
        sweeps.append({
            "kill_at_hit": hit,
            "leased": len(leased),
            "unique_ips": len(set(leased.values())),
            "faults": len(inj.injected),
            "worker_failures": fleet.worker_failures,
            "audit_ok": audit.ok,
            "violations": audit.violations_by_kind(),
        })
    control = sweeps[0]
    ok = (all(s["audit_ok"] for s in sweeps)
          and control["leased"] == n_macs
          and all(s["unique_ips"] == s["leased"] for s in sweeps)
          and any(s["faults"] for s in sweeps[1:]))
    return {"name": "dora_worker_crash", "seed": seed, "ok": ok,
            "sweeps": sweeps}


# ---------------------------------------------------------------------------
# 2. corrupt restore -> reject -> fall back / cold start -> clean restore
# ---------------------------------------------------------------------------

def _build_server_stack(clock):
    """Parent-only stack (no fleet): DHCP server + pools + fast path +
    NAT, the single-worker authority set."""
    from bng_tpu_torch.control.dhcp_server import DHCPServer
    from bng_tpu_torch.control.nat import NATManager

    fastpath = _make_fastpath()
    pools = _make_pools(fastpath)
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")],
                     ports_per_subscriber=64,
                     sessions_nbuckets=256, sub_nat_nbuckets=64)
    server = DHCPServer(SERVER_MAC, SERVER_IP, pools,
                        fastpath_tables=fastpath,
                        nat_hook=lambda ip, now: nat.allocate_nat(ip,
                                                                  int(now)),
                        clock=clock)
    return server, pools, fastpath, nat


def _dora_server(server, macs) -> dict:
    leased = {}
    for i, m in enumerate(macs):
        off = server.handle_frame(_discover(m, 1000 + i))
        ip = _reply(off).yiaddr
        ack = server.handle_frame(_request(m, ip, 2000 + i))
        assert _reply(ack).msg_type == dhcp_codec.ACK
        leased[m] = ip
    return leased


def corrupt_restore_cold_start(seed: int) -> dict:
    """A corrupt snapshot must never silently serve traffic: write-side
    truncation lands a bad file that load_latest skips in favor of the
    previous good one; read-side bit-flips reject at decode; io_error
    surfaces; and the good checkpoint restores state-identical into a
    fresh (cold-started) stack that audits clean."""
    import tempfile

    from bng_tpu_torch.control.statestore import CheckpointStore
    from bng_tpu_torch.runtime.checkpoint import (CheckpointError,
                                            build_checkpoint,
                                            restore_checkpoint)

    clock = SimClock()
    server, pools, fastpath, nat = _build_server_stack(clock)
    macs = [_mac((seed % 89) * 100 + i) for i in range(8)]
    leased = _dora_server(server, macs)

    out = {"name": "corrupt_restore_cold_start", "seed": seed}
    with tempfile.TemporaryDirectory() as td:
        store = CheckpointStore(td)
        good = store.save(build_checkpoint(
            store.next_seq(), clock(), fastpath=fastpath, nat=nat,
            dhcp=server, node_id="chaos"))

        # 1. write-side truncation: the NEWER file on disk is corrupt
        plan = FaultPlan(seed, [
            FaultSpec("ckpt.write", TRUNCATE, at_hit=1, arg=97.0)])
        with armed(plan, log=False):
            bad = store.save(build_checkpoint(
                store.next_seq(), clock.advance(10.0), fastpath=fastpath,
                nat=nat, dhcp=server, node_id="chaos"))
        try:
            store.load(bad)
            out["truncated_rejected"] = False
        except CheckpointError:
            out["truncated_rejected"] = True
        ckpt, path = store.load_latest()
        out["fallback_to_good"] = (str(path) == str(good)
                                   and ckpt.seq == 1)

        # 2. read-side bit flip: a good file corrupted in transit rejects
        plan = FaultPlan(seed, [
            FaultSpec("ckpt.read", BITFLIP, at_hit=1,
                      arg=float(101 + seed % 997))])
        with armed(plan, log=False):
            try:
                store.load(good)
                out["bitflip_rejected"] = False
            except CheckpointError:
                out["bitflip_rejected"] = True

        # 3. io_error on save surfaces (the PeriodicCheckpointer failure
        # counter path) instead of landing a half-written file
        plan = FaultPlan(seed, [FaultSpec("ckpt.write", IO_ERROR)])
        with armed(plan, log=False):
            try:
                store.save(build_checkpoint(
                    store.next_seq(), clock(), dhcp=server,
                    node_id="chaos"))
                out["io_error_surfaced"] = False
            except OSError:
                out["io_error_surfaced"] = True
        out["files_on_disk"] = len(store.list())

        # 4. the good checkpoint restores into a FRESH stack (the warm
        # path a clean restart takes; a rejected one cold-starts empty)
        clock2 = SimClock()
        server2, pools2, fastpath2, nat2 = _build_server_stack(clock2)
        rows = restore_checkpoint(ckpt, fastpath=fastpath2, nat=nat2,
                                  dhcp=server2)
        out["restored_leases"] = rows.get("dhcp.leases", 0)
        renew_ok = 0
        for i, m in enumerate(macs):
            ack = server2.handle_frame(_renew(m, leased[m], 3000 + i))
            if ack is not None and _reply(ack).msg_type == dhcp_codec.ACK \
                    and _reply(ack).yiaddr == leased[m]:
                renew_ok += 1
        out["renewed_after_restore"] = renew_ok
        audit = audit_invariants(pools=pools2, dhcp=server2,
                                 fastpath=fastpath2, nat=nat2)
        out["audit_ok"] = audit.ok
        out["violations"] = audit.violations_by_kind()

    out["ok"] = (out["truncated_rejected"] and out["fallback_to_good"]
                 and out["bitflip_rejected"] and out["io_error_surfaced"]
                 and out["restored_leases"] == len(macs)
                 and out["renewed_after_restore"] == len(macs)
                 and out["audit_ok"])
    return out


# ---------------------------------------------------------------------------
# 3. fleet reshard under kill
# ---------------------------------------------------------------------------

def fleet_reshard_under_kill(seed: int) -> dict:
    """Kill a worker mid-traffic, checkpoint every lease book (the dead
    worker's included), restore onto a SMALLER fleet: the MAC hash
    re-shards every subscriber onto its new owner and renewals ACK the
    original addresses."""
    clock = SimClock()
    fleet, pools, fastpath = build_fleet(4, clock)
    macs = [_mac((seed % 83) * 100 + i) for i in range(24)]
    leased = dora_with_retries(fleet, macs, clock)
    out = {"name": "fleet_reshard_under_kill", "seed": seed,
           "leased_before": len(leased)}

    plan = FaultPlan(seed, [FaultSpec("fleet.scatter", KILL, at_hit=1)])
    with armed(plan, log=False) as inj:
        # renewal round under the kill: the dead shard's lanes are lost
        batch = [(i, _renew(m, leased[m], 5000 + i))
                 for i, m in enumerate(macs)]
        replies = fleet.handle_batch(batch, now=clock.advance(30.0))
    out["renew_lost_to_kill"] = sum(1 for _l, r in replies if r is None)
    out["faults"] = len(inj.injected)
    audit1 = audit_invariants(pools=pools, fleet=fleet, fastpath=fastpath)
    out["audit_after_kill_ok"] = audit1.ok

    state = fleet.export_state()  # inline books: dead worker's included
    clock2 = SimClock(clock())
    fleet2, pools2, fastpath2 = build_fleet(3, clock2)
    restored = fleet2.restore_state(state)
    out["restored"] = restored

    renew_ok = 0
    out2 = fleet2.handle_batch(
        [(i, _renew(m, leased[m], 6000 + i)) for i, m in enumerate(macs)],
        now=clock2.advance(30.0))
    for (_lane, rep), m in zip(out2, macs):
        if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK \
                and _reply(rep).yiaddr == leased[m]:
            renew_ok += 1
    out["renewed_after_reshard"] = renew_ok
    audit2 = audit_invariants(pools=pools2, fleet=fleet2,
                              fastpath=fastpath2)
    out["audit_ok"] = audit2.ok
    out["violations"] = audit2.violations_by_kind()
    out["ok"] = (out["leased_before"] == len(macs)
                 and out["faults"] >= 1
                 and out["renew_lost_to_kill"] >= 1
                 and out["audit_after_kill_ok"]
                 and restored == len(macs)
                 and renew_ok == len(macs)
                 and audit2.ok)
    return out


# ---------------------------------------------------------------------------
# 4. NAT expiry under clock skew
# ---------------------------------------------------------------------------

def nat_expiry_under_skew(seed: int) -> dict:
    """Forward skew mass-expires sessions; backward skew must expire
    nothing; both directions must leave the allocator/EIM/session/
    reverse bookkeeping mutually consistent and the port blocks
    reusable."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.ops.parse import PROTO_UDP

    clock = SimClock()
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1"),
                                 ip_to_u32("203.0.113.2")],
                     ports_per_subscriber=64,
                     sessions_nbuckets=256, sub_nat_nbuckets=64)
    rng = random.Random(seed)
    subs = [ip_to_u32("10.1.0.10") + i for i in range(8)]
    for s in subs:
        nat.allocate_nat(s, int(clock()))

    def make_flows(tag: int) -> int:
        n = 0
        for s in subs:
            base_port = 5000 + (tag * 16) + rng.randrange(0, 4)
            dsts = [ip_to_u32("93.184.216.34"), ip_to_u32("1.1.1.1")]
            # two flows share one internal endpoint (EIM refcount 2),
            # a third uses its own port
            for dst, dport in ((dsts[0], 80), (dsts[1], 443)):
                if nat.handle_new_flow(s, dst, base_port, dport,
                                       PROTO_UDP, 128, int(clock())):
                    n += 1
            if nat.handle_new_flow(s, dsts[0], base_port + 1000 + tag, 80,
                                   PROTO_UDP, 128, int(clock())):
                n += 1
        return n

    out = {"name": "nat_expiry_under_skew", "seed": seed}
    out["flows_created"] = make_flows(0)
    out["audit_fresh_ok"] = audit_invariants(nat=nat,
                                             check_roundtrip=False).ok

    # forward skew: every UDP session is idle far past its timeout
    with armed(FaultPlan(seed, [
            FaultSpec("nat.expire", SKEW, at_hit=1, arg=7200.0)]),
            log=False):
        out["expired_forward"] = nat.expire_sessions(int(clock()))
    audit_f = audit_invariants(nat=nat, check_roundtrip=False)
    out["audit_forward_ok"] = audit_f.ok
    out["sessions_after_forward"] = int(np.count_nonzero(nat.sessions.used))

    # recreate on the freed ports — the blocks must be reusable
    out["flows_recreated"] = make_flows(1)
    # backward skew: (now - last_seen) goes negative, nothing may expire
    with armed(FaultPlan(seed, [
            FaultSpec("nat.expire", SKEW, at_hit=1, arg=-7200.0)]),
            log=False):
        out["expired_backward"] = nat.expire_sessions(
            int(clock.advance(30.0)))
    audit_b = audit_invariants(nat=nat, check_roundtrip=False)
    out["audit_ok"] = audit_b.ok
    out["violations"] = audit_b.violations_by_kind()

    out["ok"] = (out["flows_created"] == 24
                 and out["audit_fresh_ok"]
                 and out["expired_forward"] == 24
                 and out["sessions_after_forward"] == 0
                 and out["audit_forward_ok"]
                 and out["flows_recreated"] == 24
                 and out["expired_backward"] == 0
                 and out["audit_ok"])
    return out


# ---------------------------------------------------------------------------
# 5. HA replication: stream death mid-delta + peer timeout on reconnect
# ---------------------------------------------------------------------------

def ha_delta_drop_reconnect(seed: int) -> dict:
    """The replication stream dies mid-delta (drop_delta kills every
    subscriber callback, exactly like an SSE connection breaking), then
    the first reconnect attempt times out (ha.connect fail -> backoff).
    The second reconnect heals via replay_since with zero full syncs —
    and the stores must end identical."""
    from bng_tpu_torch.control.ha import (ActiveSyncer, InMemorySessionStore,
                                    SessionState, StandbySyncer)

    clock = SimClock()
    active = ActiveSyncer(InMemorySessionStore(), replay_buffer=64)
    standby = StandbySyncer(InMemorySessionStore(),
                            transport=lambda: active,
                            backoff_initial_s=1.0)
    standby.tick(clock())
    out = {"name": "ha_delta_drop_reconnect", "seed": seed,
           "connected_initially": standby.connected}

    def push(i: int) -> None:
        active.push_change(SessionState(
            session_id=f"s-{i:04d}", mac=_mac(i).hex(),
            ip=ip_to_u32("10.2.0.1") + i, lease_expiry=clock() + 3600,
            updated_at=clock()))

    for i in range(6):
        push(i)
    out["delivered_before_fault"] = standby.last_seq

    plan = FaultPlan(seed, [
        # hits count from arming: the 2nd armed push (session seq 8)
        # dies mid-delivery; seq 7 lands, 8-12 reach only the replay log
        FaultSpec("ha.push", DROP_DELTA, at_hit=2),
        # the standby's FIRST reconnect attempt times out
        FaultSpec("ha.connect", FAIL, at_hit=1)])
    with armed(plan, log=False) as inj:
        for i in range(6, 12):
            push(i)
        out["standby_seq_after_drop"] = standby.last_seq
        # the broken stream is observed (no subscriber left on the
        # active — the on_stream_end role) and the standby reconnects
        out["stream_died"] = not active._subscribers
        if out["stream_died"]:
            standby.disconnect()
        standby.tick(clock.advance(1.0))  # injected peer timeout
        out["first_reconnect_failed"] = not standby.connected
        standby.tick(clock.advance(5.0))  # backoff elapsed: heals
    out["faults"] = len(inj.injected)
    out["healed"] = (standby.connected
                     and standby.last_seq == active._seq)
    out["full_syncs_during_heal"] = standby.stats["full_syncs"] - 1
    audit = audit_invariants(ha_pair=(active, standby),
                             check_roundtrip=False)
    out["audit_ok"] = audit.ok
    out["violations"] = audit.violations_by_kind()
    out["ok"] = (out["connected_initially"]
                 and out["delivered_before_fault"] == 6
                 and out["stream_died"]
                 and out["standby_seq_after_drop"] == 7
                 and out["first_reconnect_failed"]
                 and out["healed"]
                 and out["full_syncs_during_heal"] == 0
                 and out["audit_ok"])
    return out


# ---------------------------------------------------------------------------
# 6. LIVE fleet resize under kill — the zero-downtime elasticity proof
# ---------------------------------------------------------------------------

def _start_inflight(fleet, clock, macs) -> dict:
    """Open an in-flight DORA per MAC (DISCOVER only) -> {mac: offered
    ip}. These are the exchanges a transition must NOT drop."""
    out = fleet.handle_batch(
        [(i, _discover(m, 0x5000 + i)) for i, m in enumerate(macs)],
        now=clock())
    offers = {}
    for (_lane, rep), m in zip(out, macs):
        if rep is not None and _reply(rep).msg_type == dhcp_codec.OFFER:
            offers[m] = _reply(rep).yiaddr
    return offers


def _complete_inflight(fleet, clock, offers) -> int:
    """REQUEST each outstanding OFFER; count ACKs of the OFFERED ip."""
    macs = sorted(offers)
    out = fleet.handle_batch(
        [(i, _request(m, offers[m], 0x6000 + i))
         for i, m in enumerate(macs)], now=clock())
    done = 0
    for (_lane, rep), m in zip(out, macs):
        if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK \
                and _reply(rep).yiaddr == offers[m]:
            done += 1
    return done


def _renew_all(fleet, clock, leased) -> int:
    macs = sorted(leased)
    out = fleet.handle_batch(
        [(i, _renew(m, leased[m], 0x7000 + i))
         for i, m in enumerate(macs)], now=clock.advance(30.0))
    return sum(1 for (_l, rep), m in zip(out, macs)
               if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK
               and _reply(rep).yiaddr == leased[m])


def fleet_resize_under_kill(seed: int) -> dict:
    """Sweep the kill fault across fleet.resize transfer hits 0 (control)
    through 4 on a 4->2 shrink, then grow 2->5 clean. The acceptance
    bar: ZERO dropped in-flight DORAs (every un-ACKed OFFER completes on
    its new owner), every lease renews its original address, and every
    audit is clean — kill included, because an inline worker's book
    survives its death and the transfer HEALS the shard."""
    n_macs, workers = 16, 4
    sweeps = []
    for hit in range(0, 5):
        clock = SimClock()
        fleet, pools, fastpath = build_fleet(workers, clock)
        macs = [_mac((seed % 79) * 100 + i) for i in range(n_macs)]
        leased = dora_with_retries(fleet, macs, clock)
        inflight = [_mac((seed % 79) * 100 + 500 + i) for i in range(4)]
        offers = _start_inflight(fleet, clock, inflight)
        specs = ([] if hit == 0
                 else [FaultSpec("fleet.resize", KILL, at_hit=hit)])
        with armed(FaultPlan(seed=seed, specs=specs), log=False) as inj:
            rep = fleet.resize(2)
        sweep = {
            "kill_at_hit": hit,
            "resize_outcome": rep["outcome"],
            "leases_moved": rep.get("leases_moved", 0),
            "offers_moved": rep.get("offers_moved", 0),
            "faults": len(inj.injected),
            "inflight_completed": _complete_inflight(fleet, clock, offers),
            "renewed": _renew_all(fleet, clock, leased),
        }
        # grow back past the original count — elasticity both ways
        rep2 = fleet.resize(5)
        sweep["grow_outcome"] = rep2["outcome"]
        sweep["renewed_after_grow"] = _renew_all(fleet, clock, leased)
        audit = audit_invariants(pools=pools, fleet=fleet,
                                 fastpath=fastpath)
        sweep["audit_ok"] = audit.ok
        sweep["violations"] = audit.violations_by_kind()
        sweeps.append(sweep)
    ok = (all(s["audit_ok"] for s in sweeps)
          and all(s["resize_outcome"] == "ok"
                  and s["grow_outcome"] == "ok" for s in sweeps)
          and all(s["renewed"] == n_macs for s in sweeps)
          and all(s["renewed_after_grow"] == n_macs for s in sweeps)
          and all(s["inflight_completed"] == 4 for s in sweeps)
          and all(s["offers_moved"] == 4 for s in sweeps)
          and any(s["faults"] for s in sweeps[1:]))
    return {"name": "fleet_resize_under_kill", "seed": seed, "ok": ok,
            "sweeps": sweeps}


# ---------------------------------------------------------------------------
# 7. rolling worker restart under kill
# ---------------------------------------------------------------------------

def rolling_restart_under_kill(seed: int) -> dict:
    """Replace every worker one shard at a time with a kill injected at
    each rotation hit in turn. Books, un-ACKed OFFERs and granted slices
    move verbatim into the replacement (no re-shard: same slot, same
    MAC owner), so renewals and in-flight DORAs survive every sweep —
    and a killed shard comes back HEALED (its book was still knowable
    inline), which the report pins via the `healed` list."""
    n_macs, workers = 18, 3
    sweeps = []
    for hit in range(0, 4):
        clock = SimClock()
        fleet, pools, fastpath = build_fleet(workers, clock)
        macs = [_mac((seed % 71) * 100 + i) for i in range(n_macs)]
        leased = dora_with_retries(fleet, macs, clock)
        inflight = [_mac((seed % 71) * 100 + 600 + i) for i in range(3)]
        offers = _start_inflight(fleet, clock, inflight)
        specs = ([] if hit == 0
                 else [FaultSpec("fleet.restart", KILL, at_hit=hit)])
        with armed(FaultPlan(seed=seed, specs=specs), log=False) as inj:
            rep = fleet.rolling_restart()
        audit = audit_invariants(pools=pools, fleet=fleet,
                                 fastpath=fastpath)
        sweeps.append({
            "kill_at_hit": hit,
            "outcome": rep["outcome"],
            "replaced": len(rep.get("replaced", ())),
            "healed": len(rep.get("healed", ())),
            "lost": len(rep.get("lost", ())),
            "faults": len(inj.injected),
            "inflight_completed": _complete_inflight(fleet, clock, offers),
            "renewed": _renew_all(fleet, clock, leased),
            "audit_ok": audit.ok,
            "violations": audit.violations_by_kind(),
        })
    ok = (all(s["audit_ok"] for s in sweeps)
          and all(s["outcome"] == "ok" for s in sweeps)
          and all(s["renewed"] == n_macs for s in sweeps)
          and all(s["inflight_completed"] == 3 for s in sweeps)
          and all(s["lost"] == 0 for s in sweeps)
          and all(s["healed"] == 1 for s in sweeps[1:])
          and any(s["faults"] for s in sweeps[1:]))
    return {"name": "rolling_restart_under_kill", "seed": seed, "ok": ok,
            "sweeps": sweeps}


# ---------------------------------------------------------------------------
# 8. blue/green engine swap: clean flip + crash rollback + snapshot fault
# ---------------------------------------------------------------------------

def engine_swap_crash_rollback(seed: int, device=None) -> dict:
    """Three swaps on one live engine stack: (a) clean — the standby
    hydrates from the in-memory snapshot, audits clean, flips, and
    serves renewals ON DEVICE from the hydrated chain; (b) crash at the
    flip barrier (ops.swap fail) — rolled back, active untouched; (c)
    snapshot encode io_error — failed before a standby ever existed.
    After every failure the ACTIVE engine must still serve and audit
    clean (the rollback re-sync heals any consumed delta)."""
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.ops import blue_green_swap

    clock = SimClock()
    server, pools, fastpath, nat = _build_server_stack(clock)
    eng = Engine(fastpath, nat, batch_size=32,
                 slow_path=server.handle_frame, clock=clock, device=device)
    macs = [_mac((seed % 61) * 100 + i) for i in range(6)]
    leased = {}
    for i, m in enumerate(macs):
        out = eng.process([_discover(m, 0x800 + i)])
        off = (out["slow"] or out["tx"])[0][1]
        ip = _reply(off).yiaddr
        out = eng.process([_request(m, ip, 0x900 + i)])
        leased[m] = ip
    components = {"engine": eng, "pools": pools, "dhcp": server}
    out_rep: dict = {"name": "engine_swap_crash_rollback", "seed": seed,
                     "leased": len(leased)}

    def _renew_one(i: int) -> tuple[bool, str]:
        m = macs[i % len(macs)]
        res = components["engine"].process(
            [_renew(m, leased[m], 0xA00 + i)],
            now=clock.advance(30.0))
        path = "tx" if res["tx"] else "slow"
        rep = (res["tx"] or res["slow"])[0][1]
        ok = (rep is not None
              and _reply(rep).msg_type == dhcp_codec.ACK
              and _reply(rep).yiaddr == leased[m])
        return ok, path

    # (a) clean swap
    rep = blue_green_swap(components)
    out_rep["swap_outcome"] = rep["outcome"]
    out_rep["swap_audit_ok"] = rep.get("audit_ok", False)
    out_rep["swapped_engine"] = components["engine"] is not eng
    ok_renew, path = _renew_one(0)
    out_rep["renew_after_swap"] = ok_renew
    # the standby's device chain came from the snapshot: a renewal must
    # hit the device fast path, proving the hydration actually carried
    # the subscriber rows (a slow-path ACK would mask an empty chain)
    out_rep["renew_path_after_swap"] = path

    # (b) crash mid-swap -> rollback
    active = components["engine"]
    plan = FaultPlan(seed, [FaultSpec("ops.swap", FAIL, at_hit=1)])
    with armed(plan, log=False):
        rep_b = blue_green_swap(components)
    out_rep["crash_outcome"] = rep_b["outcome"]
    out_rep["crash_kept_active"] = components["engine"] is active
    out_rep["renew_after_crash"] = _renew_one(1)[0]

    # (c) io_error on the in-memory snapshot encode
    plan = FaultPlan(seed, [FaultSpec("ops.snapshot", IO_ERROR, at_hit=1)])
    with armed(plan, log=False):
        rep_c = blue_green_swap(components)
    out_rep["snapshot_fault_outcome"] = rep_c["outcome"]
    out_rep["renew_after_snapshot_fault"] = _renew_one(2)[0]

    audit = audit_invariants(engine=components["engine"], pools=pools,
                             dhcp=server, nat=nat)
    out_rep["audit_ok"] = audit.ok
    out_rep["violations"] = audit.violations_by_kind()
    out_rep["ok"] = (out_rep["swap_outcome"] == "ok"
                     and out_rep["swap_audit_ok"]
                     and out_rep["swapped_engine"]
                     and out_rep["renew_after_swap"]
                     and out_rep["renew_path_after_swap"] == "tx"
                     and out_rep["crash_outcome"] == "rolled_back"
                     and out_rep["crash_kept_active"]
                     and out_rep["renew_after_crash"]
                     and out_rep["snapshot_fault_outcome"] == "failed"
                     and out_rep["renew_after_snapshot_fault"]
                     and out_rep["audit_ok"])
    return out_rep


def sharded_swap_crash_rollback(seed: int, device=None) -> dict:
    """The sharded serving path's swap discipline: DORA
    through a 2-shard cluster's STEERED ring (ring-classified control
    batches on the sharded DHCP fast lane, slow-path misses answered by
    the host server writing rows to their OWNER shards), then (a) a
    clean sharded blue/green swap — standby hydrated from the in-memory
    sharded snapshot, partition-audited BEFORE the flip, renewals served
    ON DEVICE by the standby with zero missteers; (b) a chaos crash at
    the flip barrier (ops.swap fail) — the active cluster keeps serving,
    untouched; (c) an io_error on the snapshot encode — failed before a
    standby ever existed. Final cross-authority sharded audit clean."""
    import numpy as np

    from bng_tpu_torch.control.dhcp_server import DHCPServer
    from bng_tpu_torch.parallel.sharded import ShardedCluster, ShardedFastPathSink
    from bng_tpu_torch.runtime.ops import sharded_blue_green_swap
    from bng_tpu_torch.utils.net import ip_to_u32, parse_mac

    clock = SimClock()
    server_mac = parse_mac("02:aa:bb:cc:dd:01")
    server_ip = ip_to_u32("10.0.0.1")
    cl = ShardedCluster(2, batch_per_shard=8, sub_nbuckets=64,
                        vlan_nbuckets=64, cid_nbuckets=64,
                        nat_sessions_nbuckets=64, qos_nbuckets=64,
                        spoof_nbuckets=64, garden_enabled=False, device=device)
    # resolver: post-swap DORA writes must land on the SERVING cluster
    cl_ref = {"cluster": cl}
    sink = ShardedFastPathSink(lambda: cl_ref["cluster"])
    sink.set_server_config(server_mac, server_ip)
    pools = _make_pools(sink)
    server = DHCPServer(server_mac, server_ip, pools,
                        fastpath_tables=sink, clock=clock)
    ring = cl.make_ring(nframes=256, frame_size=2048, depth=64)

    def _drive(frame: bytes) -> bytes | None:
        """One frame through the steered ring; returns the reply frame
        (device TX or slow-path inject), if any."""
        assert ring.rx_push(frame, from_access=True)
        cl_ref["cluster"].process_ring(ring, int(clock()), 0,
                                       pkt_slot=2048,
                                       slow_path=server.handle_frame)
        got = ring.tx_pop()
        return got[0] if got is not None else None

    macs = [_mac((seed % 61) * 100 + i) for i in range(6)]
    cl_ref.update(pools=pools, dhcp=server)
    # DORA: DISCOVER punts to the host server (OFFER via TX inject),
    # REQUEST binds the lease; the sink lands each row on its owner
    for i, m in enumerate(macs):
        offer = _drive(_discover(m, 0x800 + i))
        assert offer is not None, "DORA discover went unanswered"
        ack = _drive(_request(m, _reply(offer).yiaddr, 0x900 + i))
        assert ack is not None and _reply(ack).msg_type == dhcp_codec.ACK

    def _renew_on_device(i: int) -> bool:
        """A cached DISCOVER must be answered BY THE CLUSTER (verdict TX on
        the sharded DHCP fast lane), proving the serving cluster's
        device chain carries the subscriber rows."""
        m = macs[i % len(macs)]
        clock.advance(5.0)
        tx_before = cl_ref["cluster"].telemetry.verdicts[:, 2].sum()
        assert ring.rx_push(_discover(m, 0xA00 + i), from_access=True)
        cl_ref["cluster"].process_ring(ring, int(clock()), 0,
                                      pkt_slot=2048,
                                      slow_path=server.handle_frame)
        reply = ring.tx_pop()
        on_dev = (cl_ref["cluster"].telemetry.verdicts[:, 2].sum()
                  > tx_before)
        return bool(reply is not None and on_dev)

    out_rep: dict = {"name": "sharded_swap_crash_rollback", "seed": seed,
                     "leased": len(server.leases),
                     "renew_before_swap": _renew_on_device(0)}

    # (a) clean swap
    active = cl_ref["cluster"]
    rep = sharded_blue_green_swap(cl_ref, clock=clock)
    out_rep["swap_outcome"] = rep["outcome"]
    out_rep["swap_audit_ok"] = rep.get("audit_ok", False)
    out_rep["swapped_cluster"] = cl_ref["cluster"] is not active
    out_rep["renew_after_swap"] = _renew_on_device(1)

    # (b) crash at the flip barrier -> active keeps serving
    active = cl_ref["cluster"]
    plan = FaultPlan(seed, [FaultSpec("ops.swap", FAIL, at_hit=1)])
    with armed(plan, log=False):
        rep_b = sharded_blue_green_swap(cl_ref, clock=clock)
    out_rep["crash_outcome"] = rep_b["outcome"]
    out_rep["crash_kept_active"] = cl_ref["cluster"] is active
    out_rep["renew_after_crash"] = _renew_on_device(2)

    # (c) io_error on the snapshot encode
    plan = FaultPlan(seed, [FaultSpec("ops.snapshot", IO_ERROR, at_hit=1)])
    with armed(plan, log=False):
        rep_c = sharded_blue_green_swap(cl_ref, clock=clock)
    out_rep["snapshot_fault_outcome"] = rep_c["outcome"]
    out_rep["renew_after_snapshot_fault"] = _renew_on_device(3)

    audit = audit_invariants(cluster=cl_ref["cluster"], pools=pools,
                             dhcp=server, check_roundtrip=False)
    snap = cl_ref["cluster"].telemetry.snapshot()
    out_rep["missteers"] = int(snap["missteer_total"])
    out_rep["audit_ok"] = audit.ok
    out_rep["violations"] = audit.violations_by_kind()
    out_rep["ok"] = (out_rep["renew_before_swap"]
                     and out_rep["swap_outcome"] == "ok"
                     and out_rep["swap_audit_ok"]
                     and out_rep["swapped_cluster"]
                     and out_rep["renew_after_swap"]
                     and out_rep["crash_outcome"] == "failed"
                     and out_rep["crash_kept_active"]
                     and out_rep["renew_after_crash"]
                     and out_rep["snapshot_fault_outcome"] == "failed"
                     and out_rep["renew_after_snapshot_fault"]
                     and out_rep["missteers"] == 0
                     and out_rep["audit_ok"])
    return out_rep


# ---------------------------------------------------------------------------
# 10. edge protection on the sharded serving path
# ---------------------------------------------------------------------------

def _build_edge_cluster(clock, device=None):
    """2-shard edge-enabled cluster + steered ring + host DHCP server —
    the shared stack for the two edge scenarios."""
    from bng_tpu_torch.control.dhcp_server import DHCPServer
    from bng_tpu_torch.parallel.sharded import ShardedCluster, ShardedFastPathSink

    cl = ShardedCluster(2, batch_per_shard=8, sub_nbuckets=64,
                        vlan_nbuckets=64, cid_nbuckets=64,
                        nat_sessions_nbuckets=64, qos_nbuckets=64,
                        spoof_nbuckets=64, garden_enabled=False,
                        edge_enabled=True, edge_nbuckets=64, device=device)
    sink = ShardedFastPathSink(lambda: cl)
    sink.set_server_config(SERVER_MAC, SERVER_IP)
    pools = _make_pools(sink)
    server = DHCPServer(SERVER_MAC, SERVER_IP, pools,
                        fastpath_tables=sink, clock=clock)
    ring = cl.make_ring(nframes=256, frame_size=2048, depth=64)

    def drive(frame: bytes, from_access: bool = True) -> bytes | None:
        assert ring.rx_push(frame, from_access=from_access)
        cl.process_ring(ring, int(clock()), 0, pkt_slot=2048,
                        slow_path=server.handle_frame)
        got = ring.tx_pop()
        return got[0] if got is not None else None

    def dora(macs) -> dict:
        leased = {}
        for i, m in enumerate(macs):
            offer = drive(_discover(m, 0x800 + i))
            assert offer is not None, "DORA discover went unanswered"
            ip = _reply(offer).yiaddr
            ack = drive(_request(m, ip, 0x900 + i))
            assert ack is not None \
                and _reply(ack).msg_type == dhcp_codec.ACK
            leased[m] = ip
        return leased

    return cl, pools, server, ring, drive, dora


def _data(mac: bytes, src_ip: int, dst_ip: int, sport: int,
          dport: int) -> bytes:
    return packets.udp_packet(mac, SERVER_MAC, src_ip, dst_ip, sport,
                              dport, b"edge-scenario-payload")


def intercept_tap_live(seed: int, device=None) -> dict:
    """Warrant-compiled taps mirror on the live sharded serving path,
    filter at the device, and reap on expiry. A warrant with a port
    filter arms mid-service against a leased subscriber: matching
    upstream frames MIRROR to RecordCC through the ring retire,
    non-matching and non-target frames do not, the warrant's expiry
    (bounded `expire_warrants(max_reaps=)` sweep + `sync()`) provably
    removes the device row, and the `_audit_edge` warrant<->row clause
    plus the missteer counter close the loop."""
    from bng_tpu_torch.control.intercept import InterceptManager, Warrant
    from bng_tpu_torch.edge.compile import InterceptTapProgram, MirrorPump
    from bng_tpu_torch.utils.net import u32_to_ip

    clock = SimClock()
    cl, pools, server, ring, drive, dora = _build_edge_cluster(clock, device)
    macs = [_mac((seed % 53) * 100 + i) for i in range(6)]
    leased = dora(macs)

    target_mac = macs[seed % len(macs)]
    bystander = macs[(seed + 1) % len(macs)]
    target_ip = leased[target_mac]

    im = InterceptManager(clock=clock)
    im.add_warrant(Warrant(
        id="W-STORM-1", liid="LIID-17", target_ipv4=u32_to_ip(target_ip),
        valid_from=clock() - 1.0, valid_until=clock() + 600.0,
        filter_dest_ports=[443]))
    program = InterceptTapProgram(cl, im, clock=clock)
    pump = MirrorPump(program)
    cl.mirror_sink = pump
    sync0 = program.sync()

    peer = ip_to_u32("198.51.100.7")
    # matching flow (dst port 443) from the target: must mirror
    drive(_data(target_mac, target_ip, peer, 40001, 443))
    mirrored_match = pump.stats["mirrored"]
    # non-matching port from the target: device filter rejects the lane
    drive(_data(target_mac, target_ip, peer, 40002, 9999))
    # a bystander's matching flow: no tap row, never mirrored
    drive(_data(bystander, leased[bystander], peer, 40003, 443))
    mirrored_total = pump.stats["mirrored"]
    edge_stats = np.asarray(cl.stats.get("edge", np.zeros(4)))

    audit_live = audit_invariants(cluster=cl, pools=pools, dhcp=server,
                                  tap_program=program,
                                  check_roundtrip=False)

    # expiry: bounded sweep flips the warrant, sync reaps the row, and
    # the audit would have flagged the stale row had it survived
    clock.advance(700.0)
    expired = im.expire_warrants(max_reaps=4)
    sync1 = program.sync()
    drive(_data(target_mac, target_ip, peer, 40004, 443))
    mirrored_after = pump.stats["mirrored"]

    audit = audit_invariants(cluster=cl, pools=pools, dhcp=server,
                             tap_program=program, check_roundtrip=False)
    snap = cl.telemetry.snapshot()
    out_rep = {
        "name": "intercept_tap_live", "seed": seed,
        "leased": len(leased),
        "armed": sync0["armed"],
        "mirrored_match": mirrored_match,
        "mirrored_total": mirrored_total,
        "tap_filtered": int(edge_stats[1]),
        "cc_records": im.stats()["cc_records"],
        "expired": expired,
        "reaped": sync1["reaped"],
        "rows_after_reap": len(cl.tap_rows()),
        "mirrored_after_expiry": mirrored_after - mirrored_total,
        "missteers": int(snap["missteer_total"]),
        "audit_live_ok": audit_live.ok,
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
    }
    out_rep["ok"] = (out_rep["armed"] == 1
                     and out_rep["mirrored_match"] == 1
                     and out_rep["mirrored_total"] == 1
                     and out_rep["tap_filtered"] >= 1
                     and out_rep["cc_records"] == 1
                     and out_rep["expired"] == 1
                     and out_rep["reaped"] == 1
                     and out_rep["rows_after_reap"] == 0
                     and out_rep["mirrored_after_expiry"] == 0
                     and out_rep["missteers"] == 0
                     and out_rep["audit_live_ok"]
                     and out_rep["audit_ok"])
    return out_rep


def route_flap_rewrite(seed: int, device=None) -> dict:
    """Next-hop rewrite rides a link flap on the live sharded serving
    path as bounded dirty-slot deltas — never a resync. Subscribers
    bind to per-class ECMP next hops compiled into chip-local device
    rows; data frames forward (verdict FWD) with the gateway MAC
    stamped; killing an upstream's health target recompiles ONLY the
    rows whose selection changed (dirty slots bounded by the bound
    count), traffic re-forwards via the survivor, recovery flaps back,
    and `_audit_edge` proves every row equals the routing program's
    compiled expectation."""
    from bng_tpu_torch.control.routing import (RoutingManager, StubPlatform,
                                         Upstream)
    from bng_tpu_torch.edge.compile import RouteProgram
    from bng_tpu_torch.edge.ops import RW_MAC_HI, RW_MAC_LO

    clock = SimClock()
    cl, pools, server, ring, drive, dora = _build_edge_cluster(clock, device)
    macs = [_mac((seed % 47) * 100 + i) for i in range(8)]
    leased = dora(macs)

    platform = StubPlatform()
    manager = RoutingManager(None, platform)
    mac_a, mac_b = bytes.fromhex("02dd0000000a"), bytes.fromhex(
        "02dd0000000b")
    manager.add_upstream(Upstream(name="ispA", interface="eth1",
                                  gateway="192.0.2.1", table=100,
                                  health_target="192.0.2.1"))
    manager.add_upstream(Upstream(name="ispB", interface="eth2",
                                  gateway="192.0.2.2", table=101,
                                  health_target="192.0.2.2"))
    platform.reachable["192.0.2.1"] = 0.001
    platform.reachable["192.0.2.2"] = 0.001
    manager.check_health()

    program = RouteProgram(cl, manager)
    program.attach()
    program.set_neighbor("192.0.2.1", mac_a)
    program.set_neighbor("192.0.2.2", mac_b)
    classes = ("residential", "business")
    for i, m in enumerate(macs):
        assert program.bind_subscriber(leased[m], classes[i % 2])

    def _forward_all(xid: int) -> int:
        fwd0 = int(cl.telemetry.verdicts[:, 3].sum())
        for i, m in enumerate(macs):
            drive(_data(m, leased[m], ip_to_u32("203.0.113.9"),
                        41000 + xid + i, 443))
        return int(cl.telemetry.verdicts[:, 3].sum()) - fwd0

    fwd_before = _forward_all(0)
    rewrites_before = int(np.asarray(cl.stats["edge"])[2])
    audit_live = audit_invariants(cluster=cl, pools=pools, dhcp=server,
                                  route_program=program,
                                  check_roundtrip=False)

    # flap: ispA's health target dies; threshold failures mark it DOWN
    # and the manager hook recompiles ONLY the rows that moved
    deltas_before = program.stats["deltas"]
    del platform.reachable["192.0.2.1"]
    for _ in range(manager.config.failure_threshold):
        manager.check_health()
    dirty_after_flap = cl.pending_dirty()
    moved = program.stats["deltas"] - deltas_before
    on_b = sum(1 for m in macs
               if (r := cl.get_route(leased[m])) is not None
               and (int(r[RW_MAC_HI]), int(r[RW_MAC_LO]))
               == (int.from_bytes(mac_b[:2], "big"),
                   int.from_bytes(mac_b[2:6], "big")))
    fwd_during = _forward_all(100)

    # recovery: the target answers again, selection heals (bounded)
    platform.reachable["192.0.2.1"] = 0.001
    manager.check_health()
    fwd_after = _forward_all(200)

    audit = audit_invariants(cluster=cl, pools=pools, dhcp=server,
                             route_program=program, check_roundtrip=False)
    snap = cl.telemetry.snapshot()
    out_rep = {
        "name": "route_flap_rewrite", "seed": seed,
        "leased": len(leased),
        "bound": len(macs),
        "fwd_before": fwd_before,
        "rewrites_before": rewrites_before,
        "flaps": program.stats["flaps"],
        "moved_rows": moved,
        "dirty_after_flap": dirty_after_flap,
        "on_survivor": on_b,
        "fwd_during_flap": fwd_during,
        "fwd_after_recovery": fwd_after,
        "unroutable": program.stats["unroutable"],
        "missteers": int(snap["missteer_total"]),
        "audit_live_ok": audit_live.ok,
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
    }
    n = len(macs)
    out_rep["ok"] = (out_rep["fwd_before"] == n
                     and out_rep["rewrites_before"] >= n
                     and out_rep["flaps"] == 2
                     and 0 < out_rep["moved_rows"] <= n
                     and 0 < out_rep["dirty_after_flap"] <= 2 * n
                     and out_rep["on_survivor"] == n
                     and out_rep["fwd_during_flap"] == n
                     and out_rep["fwd_after_recovery"] == n
                     and out_rep["unroutable"] == 0
                     and out_rep["missteers"] == 0
                     and out_rep["audit_live_ok"]
                     and out_rep["audit_ok"])
    return out_rep


def cluster_failover_redora(seed: int) -> dict:
    """Cluster-of-BNGs failover (bng_tpu_torch/cluster): DORA a town through
    the cluster front door, kill one member mid-service, let the
    health-monitor/failover machinery promote its standby, and land the
    flash-crowd re-DORA on the promoted instance. Renewals must ACK
    with the ORIGINAL addresses (the replicated session books make
    stickiness through failover real), fresh subscribers must keep
    leasing cluster-wide, and `_audit_cluster` must stay clean — plus
    the carve's never-half-allocate discipline: removing a member with
    live leases is refused, and a joiner with no free blocks waits."""
    from bng_tpu_torch.cluster import ClusterCoordinator, instance_for_mac

    n_macs = 48
    clock = SimClock()
    coord = ClusterCoordinator(
        clock=clock, sub_nbuckets=512, slice_size=64,
        space_network=ip_to_u32("10.64.0.0"), space_prefix_len=16)
    coord.add_instances(["bng-a", "bng-b", "bng-c"])
    macs = [_mac((seed % 89) * 100 + i) for i in range(n_macs)]
    leased = dora_with_retries(coord, macs, clock)
    audit_before = audit_invariants(bng_cluster=coord)

    ids = coord.member_ids()
    victim = ids[seed % len(ids)]
    victim_macs = [m for m in macs if instance_for_mac(m, ids) == victim]
    coord.kill_instance(victim)
    # outage window: the dead member's subscribers shed (clients
    # retransmit), everyone else keeps serving
    out = coord.handle_batch(
        [(k, _renew(m, leased[m], 0x30000 + k))
         for k, m in enumerate(victim_macs)], now=clock())
    outage_shed = sum(1 for _l, rep in out if rep is None)
    ticks = 0
    while coord.members[victim].role != "promoted" and ticks < 64:
        clock.advance(1.0)
        coord.tick()
        ticks += 1
    promoted = coord.members[victim].role == "promoted"

    # the flash crowd reconnects: renewals land on the promoted standby
    # and must come back with the addresses the dead active handed out
    out = coord.handle_batch(
        [(k, _renew(m, leased[m], 0x40000 + k))
         for k, m in enumerate(victim_macs)], now=clock())
    sticky = sum(
        1 for (_l, rep), m in zip(out, victim_macs)
        if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK
        and _reply(rep).yiaddr == leased[m])

    fresh = [_mac((seed % 89) * 100 + 10_000 + i) for i in range(24)]
    fresh_leased = dora_with_retries(coord, fresh, clock)

    # never-half-allocate, exercised live: a member holding leases may
    # not leave (its blocks would move half-drained), and a joiner with
    # nothing on the free list stays pending instead of stealing
    survivor = next(i for i in ids if i != victim)
    refused = not coord.remove_instance(survivor)
    coord.add_instance("bng-x")
    joiner_pending = coord.members["bng-x"].pending
    coord.remove_instance("bng-x")  # empty member: clean leave

    audit_after = audit_invariants(bng_cluster=coord)
    out_rep = {
        "name": "cluster_failover_redora", "seed": seed,
        "instances": len(ids),
        "victim": victim,
        "leased": len(leased),
        "victim_subs": len(victim_macs),
        "outage_shed": outage_shed,
        "promoted": promoted,
        "failovers": coord.failovers,
        "sticky_acks": sticky,
        "fresh_leased": len(fresh_leased),
        "fresh_unique": len(set(fresh_leased.values())),
        "remove_refused": refused,
        "joiner_pending": joiner_pending,
        "recarves": coord.recarves,
        "audit_before_ok": audit_before.ok,
        "audit_ok": audit_after.ok,
        "violations": audit_after.violations_by_kind(),
    }
    coord.close()
    out_rep["ok"] = (
        out_rep["leased"] == n_macs
        and out_rep["victim_subs"] > 0
        and out_rep["outage_shed"] == out_rep["victim_subs"]
        and promoted and coord.failovers == 1
        and sticky == out_rep["victim_subs"]
        and out_rep["fresh_leased"] == len(fresh)
        and out_rep["fresh_unique"] == len(fresh)
        and refused and joiner_pending
        and audit_before.ok and audit_after.ok)
    return out_rep


def _build_devloop_stack(clock, devloop_k: int, device=None):
    """Tiered scheduler with the devloop express lane armed + 32
    pre-provisioned subscribers — geometry pinned to tests/test_express
    (sub 256 / vlan 64 / cid 64, engine B=32, express B=8)."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler
    from bng_tpu_torch.runtime.tables import FastPathTables

    base = int(clock())
    fp = FastPathTables(sub_nbuckets=256, vlan_nbuckets=64,
                        cid_nbuckets=64, max_pools=8)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    fp.add_pool(1, ip_to_u32("10.0.0.0"), 24, SERVER_IP,
                ip_to_u32("8.8.8.8"), ip_to_u32("8.8.4.4"), 3600)
    subs = []
    for i in range(32):
        mac = _mac(0xD00 + i)
        ip = ip_to_u32("10.0.0.0") + 10 + i
        fp.add_subscriber(mac, 1, ip, base + 600)
        subs.append((mac, ip))
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")],
                     sessions_nbuckets=64, sub_nat_nbuckets=64)
    eng = Engine(fp, nat, batch_size=32, pkt_slot=512, clock=clock, device=device)
    sched = TieredScheduler(eng, SchedulerConfig(
        express_batch=8, bulk_batch=32, express_aot=True,
        express_loop="devloop", devloop_k=devloop_k), clock=clock)
    return sched, subs


def _devloop_sweep(seed: int, rounds: int, devloop_k: int,
                   plan: FaultPlan | None, device=None) -> dict:
    """One storm sweep on a FRESH stack: each round submits a full
    ring's worth of express DHCP (k slots x express batch) interleaved
    with a saturated bulk batch, all through `process()` (which
    flushes, so partial rings never carry across rounds). Returns the
    deterministic digest the scenario diffs: reply byte hash, verdict
    counts, loop/fallback counters, cursor audit."""
    import hashlib

    clock = SimClock()
    sched, subs = _build_devloop_stack(clock, devloop_k, device)
    per_round = devloop_k * sched.express.cfg.batch
    tx_sha = hashlib.sha256()
    counts = {"tx": 0, "slow": 0, "fwd": 0, "dropped": 0}
    peer = ip_to_u32("198.51.100.9")

    def storm() -> None:
        for r in range(rounds):
            frames, kinds = [], []
            for j in range(per_round):
                mac, ip = subs[(seed + r * 7 + j) % len(subs)]
                xid = 0xD0000 + r * 256 + j
                if (r + j) % 3 == 2:  # renew REQUESTs ride the storm too
                    frames.append(_renew(mac, ip, xid))
                else:
                    frames.append(_discover(mac, xid))
                kinds.append(True)
            for j in range(sched.bulk.cfg.batch):  # saturate the bulk lane
                mac, ip = subs[(seed + j) % len(subs)]
                frames.append(packets.udp_packet(
                    mac, SERVER_MAC, ip, peer, 40000 + j, 443,
                    b"devloop-storm-bulk"))
                kinds.append(True)
            out = sched.process(frames, now=clock())
            for verdict in ("tx", "fwd"):
                for i, frame in out[verdict]:
                    tx_sha.update(i.to_bytes(4, "big"))
                    tx_sha.update(frame)
                counts[verdict] += len(out[verdict])
            counts["slow"] += len(out["slow"])
            counts["dropped"] += len(out["dropped"])
            clock.advance(0.01)

    if plan is not None:
        with armed(plan, log=False) as inj:
            storm()
        injected = [list(t) for t in inj.injected]
    else:
        storm()
        injected = []

    sched.quiesce(now=clock())
    pump = sched._devloop
    audit = pump.audit() if pump is not None else {"consistent": False}
    stats = pump.stats() if pump is not None else {}
    return {
        "loop": sched.express_loop,
        "counts": counts,
        "reply_sha": tx_sha.hexdigest(),
        "ring_dispatches": stats.get("dispatches", 0),
        "ring_batches": stats.get("batches", 0),
        "fallback_slots": stats.get("fallback_slots", 0),
        "fallbacks": dict(sorted(sched.express_fallbacks.items())),
        "injected": injected,
        "cursor_seq": audit.get("seq", -1),
        "audit_consistent": bool(audit.get("consistent", False)),
    }


def devloop_storm(seed: int, device=None) -> dict:
    """Express OFFER storm through the device-resident serving loop
    (devloop/) against a saturated bulk lane, with a mid-storm injected
    ``devloop.dispatch`` failure. The control sweep serves every round
    through full descriptor rings; the faulted sweep loses its second
    ring dispatch to the injected fault, which must degrade LOUDLY
    (fallback counter + per-batch re-dispatch of every staged slot) and
    never silently: reply bytes must be byte-identical to the control
    sweep, the express frames all still answer, and the quiesce-time
    cursor audit must close consistent in both sweeps — faults degrade
    service, never consistency."""
    rounds, devloop_k = 6, 4
    fault_round = 2 + seed % 3  # mid-storm: ring dispatch 2, 3 or 4
    control = _devloop_sweep(seed, rounds, devloop_k, None, device)
    faulted = _devloop_sweep(
        seed, rounds, devloop_k,
        FaultPlan(seed, [FaultSpec("devloop.dispatch", FAIL,
                                   at_hit=fault_round)]), device)

    out_rep = {
        "name": "devloop_storm", "seed": seed,
        "rounds": rounds, "devloop_k": devloop_k,
        "fault_round": fault_round,
        "control": control, "faulted": faulted,
        "replies_identical": control["reply_sha"] == faulted["reply_sha"],
    }
    out_rep["ok"] = (
        control["loop"] == "devloop" and faulted["loop"] == "devloop"
        and out_rep["replies_identical"]
        and control["counts"]["tx"] > 0
        and control["counts"] == faulted["counts"]
        and control["fallback_slots"] == 0 and not control["fallbacks"]
        and faulted["fallback_slots"] == devloop_k
        and faulted["fallbacks"].get("devloop_miss", 0) == 1
        and faulted["injected"] == [["devloop.dispatch", "fail",
                                     fault_round]]
        and faulted["ring_dispatches"] == control["ring_dispatches"] - 1
        and faulted["cursor_seq"] == control["cursor_seq"] - devloop_k
        and control["audit_consistent"]
        and faulted["audit_consistent"])
    return out_rep


def cluster_partial_partition(seed: int) -> dict:
    """The NEAT shape (Alquraan OSDI'18) on the cluster control fabric:
    three members beat over a SimTransport mesh, then the a<->b link is
    severed while BOTH still reach c. a and b accuse each other, but c
    accuses neither — no quorum forms on either side, so nobody is
    demoted to down, the coordinator fails nothing over, and the carve
    plan keeps one owner per block (no double-carve). Service continues
    through the split (renewals ACK cluster-wide), and when the link
    heals both suspicion episodes close as observed partitions."""
    from bng_tpu_torch.cluster import ClusterCoordinator
    from bng_tpu_torch.cluster.fabric import FailureDetector, SimTransport

    n_macs = 36
    clock = SimClock()
    ids = ["bng-a", "bng-b", "bng-c"]
    hub = SimTransport(clock, seed=seed)
    dets: dict = {}
    for nid in ids:
        ep = hub.endpoint(nid)
        for peer in ids:
            if peer != nid:
                ep.add_peer(peer)
        # mesh quorum: observers of X are the 2 others -> majority 2
        dets[nid] = FailureDetector(nid, ep, clock=clock,
                                    beat_interval_s=0.5,
                                    suspicion_threshold=3,
                                    startup_grace_s=0.0)
    for nid in ids:
        for peer in ids:
            if peer != nid:
                dets[nid].watch(peer, now=clock())

    # the data plane the fabric protects: an inline cluster serving
    # leases under the same member names
    coord = ClusterCoordinator(
        clock=clock, sub_nbuckets=512, slice_size=64,
        space_network=ip_to_u32("10.80.0.0"), space_prefix_len=16)
    coord.add_instances(ids)
    macs = [_mac((seed % 89) * 100 + i) for i in range(n_macs)]
    leased = dora_with_retries(coord, macs, clock)
    epoch_before = coord.plan.epoch

    counters = {nid: 0 for nid in ids}

    def fabric_round(rounds: int) -> None:
        for _ in range(rounds):
            for nid in ids:
                counters[nid] += 1
                dets[nid].beat(served=counters[nid], work=counters[nid])
            for nid in ids:
                dets[nid].tick(clock())
            clock.advance(0.5)

    fabric_round(4)  # warm: everyone sees everyone up
    warm_ok = all(v.state == "up"
                  for d in dets.values() for v in d.views.values())

    hub.partition("bng-a", "bng-b")
    fabric_round(8)  # 4s of split: 3-beat suspicion windows expire

    # the quorum ledger mid-split, per observer
    states_during = {nid: {p: v.state
                           for p, v in sorted(dets[nid].views.items())}
                     for nid in ids}
    accusers_at_c = {p: sorted(v.accused_by)
                     for p, v in sorted(dets["bng-c"].views.items())}
    down_verdicts = sum(d.verdicts["down"] for d in dets.values())
    # a coordinator acting on the fabric would only carve out members
    # the detector demoted to DOWN; none were, so nothing is killed
    for nid in ids:
        for peer, v in dets[nid].views.items():
            if v.state == "down":
                coord.kill_instance(peer)
    for _ in range(4):
        clock.advance(1.0)
        coord.tick()

    # service through the split: every subscriber renews, cluster-wide
    out = coord.handle_batch(
        [(k, _renew(m, leased[m], 0x50000 + k))
         for k, m in enumerate(macs)], now=clock())
    renew_acks = sum(
        1 for (_l, rep), m in zip(out, macs)
        if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK
        and _reply(rep).yiaddr == leased[m])

    hub.heal_all()
    fabric_round(6)
    healed_ok = all(v.state == "up"
                    for d in dets.values() for v in d.views.values())
    partitions_observed = sum(
        v.partitions_observed
        for d in dets.values() for v in d.views.values())

    audit = audit_invariants(bng_cluster=coord)
    out_rep = {
        "name": "cluster_partial_partition", "seed": seed,
        "instances": len(ids),
        "leased": len(leased),
        "warm_ok": warm_ok,
        "states_during": states_during,
        "accusers_at_c": accusers_at_c,
        "down_verdicts": down_verdicts,
        "failovers": coord.failovers,
        "epoch_before": epoch_before,
        "epoch_after": coord.plan.epoch,
        "renew_acks": renew_acks,
        "healed_ok": healed_ok,
        "partitions_observed": partitions_observed,
        "link_cut_datagrams": hub.stats["cut"],
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
    }
    coord.close()
    out_rep["ok"] = (
        out_rep["leased"] == n_macs and warm_ok
        # each split side suspects the other; the common neighbour
        # keeps both up — the quorum evidence that blocks demotion
        and states_during["bng-a"]["bng-b"] == "suspect"
        and states_during["bng-b"]["bng-a"] == "suspect"
        and states_during["bng-c"] == {"bng-a": "up", "bng-b": "up"}
        and accusers_at_c == {"bng-a": ["bng-b"], "bng-b": ["bng-a"]}
        and down_verdicts == 0
        and out_rep["failovers"] == 0
        and out_rep["epoch_after"] == epoch_before
        and renew_acks == n_macs
        and healed_ok and partitions_observed >= 2
        and out_rep["link_cut_datagrams"] > 0
        and audit.ok)
    return out_rep


# ---------------------------------------------------------------------------
# 14. cluster gray member: beating but not serving -> demoted, sticky re-DORA
# ---------------------------------------------------------------------------

def cluster_gray_member(seed: int) -> dict:
    """Gray failure (Huang HotOS'17) through the fabric detector: a
    member keeps beating — its heartbeats are perfect — but its
    serving-health word stalls (work accepted keeps climbing, replies
    produced does not). The detector reads the stall off the member's
    own signed beats, issues a GRAY verdict with no quorum needed, the
    HA probe goes false, and the standby promotes exactly as if the
    member had died. The wedged member's subscribers re-DORA sticky
    onto the promoted standby (original addresses), and the healthy
    member never flaps."""
    from bng_tpu_torch.cluster import ClusterCoordinator, instance_for_mac
    from bng_tpu_torch.cluster.fabric import SimTransport

    n_macs = 32
    clock = SimClock()
    hub = SimTransport(clock, seed=seed)
    ids = ["bng-a", "bng-b"]
    coord = ClusterCoordinator(
        clock=clock, sub_nbuckets=512, slice_size=64,
        space_network=ip_to_u32("10.96.0.0"), space_prefix_len=16,
        fabric_endpoint=hub.endpoint("coordinator"),
        fabric_beat_interval_s=0.5, fabric_gray_beats=4,
        fabric_startup_grace_s=2.0,
        ha_probe_interval_s=0.5, ha_failure_threshold=2,
        ha_failover_delay_s=1.0)
    coord.add_instances(ids)
    # inline members do not beat on their own (the flag oracle serves
    # them); this scenario IS the fabric lane, so watch them and speak
    # their beats from the sim endpoints
    eps = {}
    for iid in ids:
        coord.fabric_detector.watch(iid, now=clock())
        eps[iid] = hub.endpoint(iid)
        eps[iid].add_peer("coordinator")

    macs = [_mac((seed % 89) * 100 + i) for i in range(n_macs)]
    leased = dora_with_retries(coord, macs, clock)
    victim = ids[seed % len(ids)]
    healthy = next(i for i in ids if i != victim)
    victim_macs = [m for m in macs if instance_for_mac(m, ids) == victim]

    served = {iid: 0 for iid in ids}
    work = {iid: 0 for iid in ids}

    def beat_round(wedged: str = "") -> None:
        for iid in ids:
            work[iid] += 8  # batches keep arriving either way
            if iid != wedged:
                served[iid] += 8  # ...but only healthy members reply
            eps[iid].send("coordinator", "beat",
                          {"served": served[iid], "work": work[iid],
                           "accuse": []})
        coord.tick(clock())
        clock.advance(0.5)

    for _ in range(4):
        beat_round()
    warm_states = {p: v["state"] for p, v in
                   coord.fabric_detector.status()["peers"].items()}

    # wedge: the victim's replies stop while its intake keeps climbing
    rounds = 0
    while coord.members[victim].role != "promoted" and rounds < 40:
        beat_round(wedged=victim)
        rounds += 1
    promoted = coord.members[victim].role == "promoted"
    gray_events = [e for e in coord.fabric_events if e == (victim, "gray")]

    # the promoted slot is fresh (detector view was reset): beats
    # resume with a healthy serving word and it must read up again
    for _ in range(4):
        beat_round()
    post_state = coord.fabric_detector.views[victim].state

    # the wedged member's flash crowd lands on the promoted standby
    # and must keep its addresses (replicated books = sticky re-DORA)
    out = coord.handle_batch(
        [(k, _renew(m, leased[m], 0x60000 + k))
         for k, m in enumerate(victim_macs)], now=clock())
    sticky = sum(
        1 for (_l, rep), m in zip(out, victim_macs)
        if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK
        and _reply(rep).yiaddr == leased[m])

    audit = audit_invariants(bng_cluster=coord)
    out_rep = {
        "name": "cluster_gray_member", "seed": seed,
        "victim": victim,
        "leased": len(leased),
        "victim_subs": len(victim_macs),
        "warm_states": warm_states,
        "promoted": promoted,
        "gray_verdicts": coord.fabric_detector.verdicts["gray"],
        "gray_events": [list(e) for e in gray_events],
        "failovers": coord.failovers,
        "healthy_role": coord.members[healthy].role,
        "healthy_state": coord.fabric_detector.views[healthy].state,
        "post_promote_state": post_state,
        "sticky_acks": sticky,
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
    }
    coord.close()
    out_rep["ok"] = (
        out_rep["leased"] == n_macs
        and out_rep["victim_subs"] > 0
        and warm_states == {"bng-a": "up", "bng-b": "up"}
        and promoted and out_rep["failovers"] == 1
        and out_rep["gray_verdicts"] >= 1
        and len(gray_events) >= 1
        and out_rep["healthy_role"] == "active"
        and out_rep["healthy_state"] == "up"
        and post_state == "up"
        and sticky == out_rep["victim_subs"]
        and audit.ok)
    return out_rep


def cluster_host_loss(seed: int) -> dict:
    """Multi-box host loss: two remote members `--join` a
    coordinator over the SimTransport fabric, hydrate their carved
    blocks through the chunked handoff stream, and serve steered DORAs
    from their own stacks (missteers must be 0 — the placement law
    re-checked on the remote box). Then the whole remote HOST vanishes
    (every beta link cut at once — the box died, not a process): the
    detector downs both members by accusation quorum, `_check_host_loss`
    promotes their surviving-host HA halves AS A GROUP, the accounting
    spool the lost box left behind replays exactly once, the flash
    crowd's renewals ACK their ORIGINAL addresses, and the audit stays
    clean. FATE+DESTINI one level up: the per-process kill lane can
    never see a box disappearing with both of its HA halves' state."""
    import tempfile

    from bng_tpu_torch.cluster import (ClusterCoordinator, MemberRuntime,
                                 instance_for_mac)
    from bng_tpu_torch.cluster.fabric import SimTransport
    from bng_tpu_torch.control.radius import packet as rp
    from bng_tpu_torch.control.radius.accounting import AccountingManager
    from bng_tpu_torch.control.radius.client import (RadiusClient,
                                               RadiusServerConfig)
    from bng_tpu_torch.control.radius.packet import RadiusPacket

    n_macs = 32
    clock = SimClock()
    hub = SimTransport(clock, seed=seed)
    coord = ClusterCoordinator(
        clock=clock, sub_nbuckets=512, slice_size=64,
        space_network=ip_to_u32("10.112.0.0"), space_prefix_len=16,
        fabric_endpoint=hub.endpoint("coordinator"),
        fabric_beat_interval_s=0.5, fabric_suspicion_threshold=3,
        fabric_startup_grace_s=2.0,
        ha_probe_interval_s=0.5, ha_failure_threshold=2,
        ha_failover_delay_s=1.0)
    # the founding carve declares the remote slots (blocks interleave
    # on the host axis NOW; the boxes join into them)
    coord.add_instances(["bng-a"], host="alpha",
                        remotes={"bng-r1": "beta", "bng-r2": "beta"})
    remote_ids = ("bng-r1", "bng-r2")
    members = {iid: MemberRuntime(hub.endpoint(iid), iid, "beta",
                                  clock=clock)
               for iid in remote_ids}
    # single-threaded determinism: the coordinator's reply wait chains
    # the members' own ticks (the two "boxes" run in lockstep)
    coord.remote_waiter = lambda: [m.tick(clock())
                                   for m in members.values()]
    join_ticks = 0
    while not all(m.state == "serving" for m in members.values()) \
            and join_ticks < 200:
        clock.advance(0.25)
        for m in members.values():
            m.tick(clock())
        coord.tick()
        join_ticks += 1

    macs = [_mac((seed % 89) * 100 + i) for i in range(n_macs)]
    leased = dora_with_retries(coord, macs, clock)
    ids = coord.member_ids()
    remote_macs = [m for m in macs
                   if instance_for_mac(m, ids) in remote_ids]
    missteers = sum(m.missteers for m in members.values())
    handoff_rx = sum(m.handoff.stats()["completed"]
                     for m in members.values())

    # the lost box's accounting story: its RADIUS lane was already dark,
    # so session stops SPOOLED instead of sending — the spool is the
    # state a dead host leaves behind for the survivor to replay
    class _AcctServer:
        def __init__(self):
            self.stops = 0

        def __call__(self, data, host, port, timeout):
            req = RadiusPacket.decode(data)
            if req.get_int(rp.ACCT_STATUS_TYPE) == rp.ACCT_STOP:
                self.stops += 1
            return RadiusPacket(rp.ACCOUNTING_RESPONSE, req.id).encode(
                b"chaos-secret", request_auth=req.authenticator)

    live = _AcctServer()
    spool = tempfile.mktemp(prefix="bng-chaos-hostloss-", suffix=".spool")

    def _client(transport):
        return RadiusClient(
            [RadiusServerConfig("10.0.0.5", secret=b"chaos-secret",
                                timeout_s=0.05, retries=1)],
            transport=transport, clock=clock)

    lost_acct = AccountingManager(_client(lambda *a: None),
                                  interim_interval_s=60,
                                  spool_path=spool, clock=clock)
    for i, m in enumerate(remote_macs[:4]):
        sid = f"s-{m.hex()}"
        lost_acct.start(sid, f"sub-{i}", leased[m])
        lost_acct.update_counters(sid, 1000 + i, 2000 + i)
        lost_acct.stop(sid)  # dark RADIUS: spools
    # the dark transport spooled BOTH halves of each session's story
    # (start + stop) — all 8 records must replay exactly once
    spooled = len(lost_acct.pending)

    replay_rounds: list = []

    def _on_host_loss(host, _ids):
        # the surviving host recovers the dead box's spool: exactly-once
        # replay through a fresh manager on the SAME spool path
        survivor = AccountingManager(_client(live), interim_interval_s=60,
                                     spool_path=spool, clock=clock)
        replay_rounds.append(survivor.retry_tick())
        replay_rounds.append(survivor.retry_tick())

    coord.on_host_loss = _on_host_loss

    # the whole beta host vanishes: every link cut in the same instant
    for iid in remote_ids:
        hub.partition("coordinator", iid)
    coord.remote_waiter = None  # nothing left to chain — the box is gone
    loss_ticks = 0
    while coord.host_losses == 0 and loss_ticks < 120:
        clock.advance(0.5)
        coord.tick()
        loss_ticks += 1

    roles = {iid: coord.members[iid].role for iid in remote_ids}
    # flash crowd: the lost host's subscribers renew against the
    # promoted surviving-host halves and must keep their addresses
    out = coord.handle_batch(
        [(k, _renew(m, leased[m], 0x70000 + k))
         for k, m in enumerate(remote_macs)], now=clock())
    sticky = sum(
        1 for (_l, rep), m in zip(out, remote_macs)
        if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK
        and _reply(rep).yiaddr == leased[m])
    fresh = [_mac((seed % 89) * 100 + 20_000 + i) for i in range(12)]
    fresh_leased = dora_with_retries(coord, fresh, clock)

    audit = audit_invariants(bng_cluster=coord)
    out_rep = {
        "name": "cluster_host_loss", "seed": seed,
        "join_ticks": join_ticks,
        "handoff_completed": handoff_rx,
        "leased": len(leased),
        "remote_subs": len(remote_macs),
        "missteers": missteers,
        "host_losses": coord.host_losses,
        "lost_hosts": sorted(coord._lost_hosts),
        "loss_ticks": loss_ticks,
        "roles": roles,
        "failovers": coord.failovers,
        "spooled": spooled,
        "replay_rounds": replay_rounds,
        "acct_stops": live.stops,
        "sticky_acks": sticky,
        "fresh_leased": len(fresh_leased),
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
    }
    coord.close()
    out_rep["ok"] = (
        out_rep["handoff_completed"] == len(remote_ids)
        and out_rep["leased"] == n_macs
        and out_rep["remote_subs"] > 0
        and missteers == 0
        and out_rep["host_losses"] == 1
        and out_rep["lost_hosts"] == ["beta"]
        and roles == {"bng-r1": "promoted", "bng-r2": "promoted"}
        and out_rep["failovers"] == len(remote_ids)
        and spooled == 8
        and replay_rounds == [8, 0]
        and live.stops == 4
        and sticky == out_rep["remote_subs"]
        and out_rep["fresh_leased"] == len(fresh)
        and audit.ok)
    return out_rep


SCENARIOS = {
    "dora_worker_crash": dora_worker_crash,
    "corrupt_restore_cold_start": corrupt_restore_cold_start,
    "fleet_reshard_under_kill": fleet_reshard_under_kill,
    "nat_expiry_under_skew": nat_expiry_under_skew,
    "ha_delta_drop_reconnect": ha_delta_drop_reconnect,
    "fleet_resize_under_kill": fleet_resize_under_kill,
    "rolling_restart_under_kill": rolling_restart_under_kill,
    "engine_swap_crash_rollback": engine_swap_crash_rollback,
    "sharded_swap_crash_rollback": sharded_swap_crash_rollback,
    "intercept_tap_live": intercept_tap_live,
    "route_flap_rewrite": route_flap_rewrite,
    "cluster_failover_redora": cluster_failover_redora,
    "devloop_storm": devloop_storm,
    "cluster_partial_partition": cluster_partial_partition,
    "cluster_gray_member": cluster_gray_member,
    "cluster_host_loss": cluster_host_loss,
}
