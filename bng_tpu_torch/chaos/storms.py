"""Subscriber-lifecycle storm suite — the traffic shapes that break
real BNGs at the ISP edge (copy of `bng_tpu/chaos/storms.py`).

The scripted scenarios (chaos/scenarios.py) prove recovery from FAULTS:
kills, corruption, skew. This module proves graceful degradation under
LOAD SHAPES — the storms that take down production BNGs with no fault
injected at all:

    flash_crowd_reconnect   an access-network outage heals and >=100k
                            subscribers re-DORA at once; admission must
                            shed DHCP-correctly (DISCOVERs first, never
                            a REQUEST whose OFFER was sent) while the
                            fleet autoscaler grows under the load
    lease_expiry_avalanche  a mass bring-up scheduled a synchronized
                            lease cliff; the bounded expiry sweep must
                            amortize the reap over ticks (service
                            continues mid-cliff) and the lease-time
                            jitter must prevent the next cliff
    cgnat_port_exhaustion   EIM churn drives the CGNAT allocator to
                            block and port exhaustion; every refused
                            verdict is COUNTED (never silent), the
                            block accounting stays exact, and expiry
                            makes the blocks reusable
    coa_policy_flap         RADIUS CoA bursts rewrite QoS device rows
                            mid-traffic; after the flap the host and
                            device QoS mirrors must agree bit-exact on
                            every config word
    dual_stack_bringup      interleaved DORA + SOLICIT/REQUEST + RS/RA
                            per subscriber; the v4 and v6 lease books
                            must both agree with their pool bitmaps
    cluster_scale_storm     4M+ subscribers steered across a 4-instance
                            cluster (vectorized), a sampled DORA wave
                            through the front door, the audit clean
    production_day          one compressed production day on a single
                            engine: diurnal IPoE/PPPoE/dual-stack/CGNAT
                            churn with CoA waves, intercept taps armed
                            mid-storm, an ISP uplink flap re-steered as
                            bounded route deltas, and a spoofed-source
                            DDoS burst the antispoof stage counts; the
                            edge audit closes the day

The Jepsen split: the GENERATORS here are dumb — they build
frames (loadtest.harness.StormFrameFactory) and retry like clients do.
All the intelligence lives in the CHECKERS: a cross-authority
invariant-audit epilogue (chaos/invariants.py — extended with v6/PPPoE
lease-vs-pool and NAT block-accounting checks for this suite) and a
per-stage telemetry budget that FAILS the scenario when the
stage_breakdown blows past its envelope (Dapper's lesson: the
unbudgeted stage is where the regression hides).

Determinism: everything runs on SimClock logical time and seeded
schedules; reports carry no wallclock, so `bng chaos run --seed S` is
byte-identical across runs — storms included, on the card and on the
CPU alike. The telemetry budget is the one wall-clock observer: only its
BOOLEAN verdict (and the names of breached stages) lands in the report,
and the envelopes are sized one to two orders above the observed means
so a passing run cannot flap.

Every scenario takes `(seed, scale=1.0)`, and the two that build an
engine (`coa_policy_flap`, `production_day`) also `device` (None = the
card): scale=1.0 is the published storm (flash crowd at 100k
subscribers); the tests run reduced scales of the SAME code.
"""

from __future__ import annotations

from bng_tpu_torch.chaos.faults import FaultPlan, FaultSpec, SimClock, SKEW, armed
from bng_tpu_torch.chaos.invariants import audit_invariants
from bng_tpu_torch.chaos.scenarios import (SERVER_IP, SERVER_MAC, _mac, _reply,
                                     _build_server_stack)
from bng_tpu_torch.control import dhcp_codec
from bng_tpu_torch.loadtest.harness import StormFrameFactory
from bng_tpu_torch.telemetry import spans as tele
from bng_tpu_torch.utils.net import ip_to_u32


# ---------------------------------------------------------------------------
# the stage budget: re-homed onto the SLO engine (telemetry/slo.py) so
# storm budgets and production SLOs share one vocabulary and one
# evaluator. Re-exported here because storms ARE the budget's main
# author.
# ---------------------------------------------------------------------------

from bng_tpu_torch.telemetry.slo import BudgetLine, check_budget  # noqa: E402,F401


class _traced:
    """Arm a fresh Tracer for the scenario body, disarm on exit. Storm
    scenarios run standalone (bng chaos run) — a leaked tracer would
    poison the next scenario's budget."""

    def __enter__(self):
        self.prev = tele.tracer()
        return tele.arm(tele.Tracer())

    def __exit__(self, *exc):
        tele.disarm()
        if self.prev is not None:
            tele.arm(self.prev)


# ---------------------------------------------------------------------------
# shared builders
# ---------------------------------------------------------------------------

def _build_storm_fleet(workers: int, clock, *, prefix_len: int,
                       sub_nbuckets: int, slice_size: int,
                       inbox: int, fallback=None):
    """Inline fleet on a pool big enough for the storm's subscriber
    count (the scenarios.build_fleet geometry tops out at a /20)."""
    from bng_tpu_torch.control.admission import AdmissionConfig
    from bng_tpu_torch.control.fleet import FleetSpec, SlowPathFleet
    from bng_tpu_torch.control.pool import Pool, PoolManager
    from bng_tpu_torch.runtime.tables import FastPathTables

    fastpath = FastPathTables(sub_nbuckets=sub_nbuckets, vlan_nbuckets=64,
                              cid_nbuckets=64, max_pools=16)
    fastpath.set_server_config(SERVER_MAC, SERVER_IP)
    pools = PoolManager(fastpath)
    pools.add_pool(Pool(pool_id=1, network=ip_to_u32("10.0.0.0"),
                        prefix_len=prefix_len, gateway=SERVER_IP,
                        dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    spec = FleetSpec.from_pool_manager(
        SERVER_MAC, SERVER_IP, pools, slice_size=slice_size,
        low_watermark=max(1, slice_size // 4))
    fleet = SlowPathFleet(spec, workers, pools, mode="inline",
                          table_sink=fastpath, clock=clock,
                          admission=AdmissionConfig(inbox_capacity=inbox),
                          fallback=fallback)
    return fleet, pools, fastpath


class _ShedSignal:
    """The fleet as the flash crowd's autoscaler reads it: the admission
    shed counters and the worker count, with the busy reading pinned at
    0. A live busy reading is wall time, and the autoscaler re-baselines
    (decides nothing) when a resize's per-worker stats reset leaves it
    below the previous look — so whether the storm grows to 5 or 6
    workers would turn on the host's speed. (The reference's storm reads
    the live value; its tests hold it to this pinned one.)"""

    def __init__(self, fleet):
        self._fleet = fleet

    @property
    def admission(self):
        return self._fleet.admission

    @property
    def n(self) -> int:
        return self._fleet.n

    def busy_seconds_total(self) -> float:
        return 0.0


# ---------------------------------------------------------------------------
# 1. flash-crowd mass-reconnect
# ---------------------------------------------------------------------------

def flash_crowd_reconnect(seed: int, scale: float = 1.0) -> dict:
    """An outage heals and every subscriber re-DORAs at once. The
    admission controller must shed the overload DHCP-correctly: only
    DISCOVERs shed (clients retransmit those by design), never a
    REQUEST whose OFFER was sent, and never a half-allocation. The
    fleet autoscaler grows on the shed signal, and after the surge a
    calm round proves admission recovered to steady state."""
    n_subs = max(1_000, int(round(100_000 * scale)))
    workers = 4
    chunk = max(512, n_subs // 6)
    inbox = max(32, chunk // (8 * workers))
    rounds_max = 5

    with _traced() as tracer:
        clock = SimClock()
        fleet, pools, fastpath = _build_storm_fleet(
            workers, clock, prefix_len=15, sub_nbuckets=1 << 15,
            slice_size=max(256, inbox * 4), inbox=inbox)

        from bng_tpu_torch.control.opsctl import AutoscaleConfig, FleetAutoscaler

        # watermark autoscaler on the shed signal alone: busy_hi is
        # unreachable, busy_lo impossible and the busy reading pinned, so
        # every decision is a deterministic function of the (seeded) shed
        # counters — the wall-clock busy fraction can never flip a bit
        scaler = FleetAutoscaler(_ShedSignal(fleet), AutoscaleConfig(
            min_workers=workers, max_workers=workers + 2,
            busy_hi=1e18, busy_lo=-1.0, cooldown_s=0.0), clock=clock)
        scaler.target(clock())  # baseline look

        fac = StormFrameFactory(SERVER_IP)
        base = (seed % 89) * 1_000_000
        macs = [_mac(base + i) for i in range(n_subs)]
        offers: dict[bytes, int] = {}
        leased: dict[bytes, int] = {}
        req_after_offer_shed = 0
        xid = 1
        rounds = []
        for rnd in range(rounds_max):
            pend = [m for m in macs if m not in leased]
            if not pend:
                break
            shed_before = fleet.admission.shed_total()
            for ci in range(0, len(pend), chunk):
                batch, batch_macs = [], []
                for k, m in enumerate(pend[ci:ci + chunk]):
                    if m in offers:
                        batch.append((k, fac.request(m, offers[m], xid + k)))
                    else:
                        batch.append((k, fac.discover(m, xid + k)))
                    batch_macs.append(m)
                xid += len(batch)
                out = fleet.handle_batch(batch, now=clock())
                for (_lane, rep), m in zip(out, batch_macs):
                    if rep is None:
                        if m in offers:
                            # the invariant this storm exists to prove:
                            # an OFFERed client's REQUEST never sheds
                            req_after_offer_shed += 1
                        continue
                    p = _reply(rep)
                    if p.msg_type == dhcp_codec.OFFER:
                        offers[m] = p.yiaddr
                    elif p.msg_type == dhcp_codec.ACK:
                        leased[m] = p.yiaddr
                        offers.pop(m, None)
                    elif p.msg_type == dhcp_codec.NAK:
                        offers.pop(m, None)
            clock.advance(5.0)
            target = scaler.target(clock())
            if target is not None and target != fleet.n:
                fleet.resize(target)
            rounds.append({
                "round": rnd,
                "pending": len(pend),
                "leased": len(leased),
                "offers_open": len(offers),
                "shed_delta": fleet.admission.shed_total() - shed_before,
                "workers": fleet.n,
            })

        # the surge is over: a calm round must shed NOTHING and every
        # renewal must ACK — admission recovered to steady state
        calm = sorted(leased)[:min(256, len(leased))]
        shed_before = fleet.admission.shed_total()
        out = fleet.handle_batch(
            [(k, fac.renew(m, leased[m], 0x70000 + k))
             for k, m in enumerate(calm)], now=clock.advance(30.0))
        calm_acks = sum(
            1 for (_l, rep), m in zip(out, calm)
            if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK
            and _reply(rep).yiaddr == leased[m])
        calm_shed = fleet.admission.shed_total() - shed_before

        audit = audit_invariants(pools=pools, fleet=fleet,
                                 fastpath=fastpath)
        budget = check_budget(tracer, (
            # per-frame envelopes (per=chunk amortizes the batch laps);
            # observed means are ~2-15us/frame isolated but 60-110us
            # late in a full tier-1 process (heap/GC pressure), and the
            # admit mean covers only a couple of laps — the envelope
            # must sit an order above the WORST healthy observation or
            # one GC pause flakes the bit-determinism gate
            BudgetLine("admit", limit_us=500.0, per=chunk),
            BudgetLine("fleet", limit_us=2_000.0, per=chunk),
            # per-frame worker handler latency (its histogram is
            # already per-frame): observed ~40-90us
            BudgetLine("worker", limit_us=5_000.0),
        ))

    out_rep = {
        "name": "flash_crowd_reconnect", "seed": seed,
        "subscribers": n_subs,
        "rounds": rounds,
        "leased": len(leased),
        "unique_ips": len(set(leased.values())),
        "req_after_offer_shed": req_after_offer_shed,
        "shed": dict(sorted(fleet.admission.stats.shed.items())),
        "workers_final": fleet.n,
        "calm_acks": calm_acks,
        "calm_expected": len(calm),
        "calm_shed": calm_shed,
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
        "budget": budget,
    }
    out_rep["ok"] = (
        req_after_offer_shed == 0
        and out_rep["unique_ips"] == out_rep["leased"]
        and out_rep["leased"] > 0
        and sum(out_rep["shed"].values()) > 0  # the storm actually shed
        and out_rep["workers_final"] > workers  # autoscaler grew
        and calm_acks == len(calm) and calm_shed == 0
        and audit.ok and budget["ok"])
    return out_rep


# ---------------------------------------------------------------------------
# 2. lease-expiry avalanche
# ---------------------------------------------------------------------------

def lease_expiry_avalanche(seed: int, scale: float = 1.0) -> dict:
    """A jitterless mass bring-up schedules one synchronized lease
    cliff. The bounded sweep (cleanup_expired max_reaps) must amortize
    the cliff across ticks — with service continuing between sweeps —
    under dhcp.expire clock skew in both directions; then the same
    bring-up WITH lease-time jitter proves the next cliff never forms.
    A NAT session cliff rides the same clock through nat.expire."""
    n = max(400, int(round(20_000 * scale)))
    reap_budget = max(64, n // 8)

    with _traced() as tracer:
        clock = SimClock()
        # the shared /20 stack (scenarios._build_server_stack) tops out
        # around 4k subscribers; the avalanche needs room for n
        from bng_tpu_torch.control.dhcp_server import DHCPServer
        from bng_tpu_torch.control.nat import NATManager
        from bng_tpu_torch.control.pool import Pool, PoolManager
        from bng_tpu_torch.runtime.tables import FastPathTables

        fastpath = FastPathTables(sub_nbuckets=1 << 15, vlan_nbuckets=64,
                                  cid_nbuckets=64, max_pools=16)
        fastpath.set_server_config(SERVER_MAC, SERVER_IP)
        pools = PoolManager(fastpath)
        pools.add_pool(Pool(pool_id=1, network=ip_to_u32("10.0.0.0"),
                            prefix_len=15, gateway=SERVER_IP,
                            dns_primary=ip_to_u32("1.1.1.1"),
                            lease_time=600))
        nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")],
                         ports_per_subscriber=64,
                         sessions_nbuckets=256, sub_nat_nbuckets=256)
        server = DHCPServer(SERVER_MAC, SERVER_IP, pools,
                            fastpath_tables=fastpath, clock=clock)
        fac = StormFrameFactory(SERVER_IP)
        base = (seed % 83) * 1_000_000
        macs = [_mac(base + i) for i in range(n)]

        def dora_all(ms, xbase):
            for i, m in enumerate(ms):
                off = server.handle_frame(fac.discover(m, xbase + i))
                ip = _reply(off).yiaddr
                server.handle_frame(fac.request(m, ip, xbase + n + i))

        t0 = tele.t()
        dora_all(macs, 0x1000)
        tele.lap(tele.SLOW, t0)
        out = {"name": "lease_expiry_avalanche", "seed": seed,
               "subscribers": n, "reap_budget": reap_budget}
        exps = {l.expiry for l in server.leases.values()}
        out["cliff_expiries"] = len(exps)  # jitterless: ONE cliff

        # backward skew first: the cliff is in the future AND the clock
        # stepped back — nothing may expire
        with armed(FaultPlan(seed, [
                FaultSpec("dhcp.expire", SKEW, at_hit=1, arg=-7200.0)]),
                log=False):
            out["reaped_backward_skew"] = server.cleanup_expired(
                int(clock()), max_reaps=reap_budget)

        # past the cliff: every lease is expired at once. Sweep with the
        # budget; between sweeps a FRESH subscriber must still be served
        # (the tick the bounded reap protects)
        clock.advance(600.0 + 1200.0)
        sweeps = []
        mid_service_ok = 0
        guard = 0
        # the mid-cliff fresh DORAs below add UNexpired leases, so the
        # loop ends on reap progress, not on an empty book
        while sum(sweeps) < n and guard < (n // reap_budget) + 4:
            guard += 1
            t0 = tele.t()
            reaped = server.cleanup_expired(int(clock()),
                                            max_reaps=reap_budget)
            tele.lap(tele.OPS, t0)  # the sweep IS an ops stall
            sweeps.append(reaped)
            fresh = _mac(base + 500_000 + guard)
            off = server.handle_frame(fac.discover(fresh, 0x90000 + guard))
            ack = (server.handle_frame(fac.request(
                fresh, _reply(off).yiaddr, 0x91000 + guard))
                if off is not None else None)
            if ack is not None and _reply(ack).msg_type == dhcp_codec.ACK:
                mid_service_ok += 1
            clock.advance(1.0)
        out["sweeps"] = sweeps
        out["mid_cliff_doras"] = mid_service_ok
        audit_mid = audit_invariants(pools=pools, dhcp=server,
                                     fastpath=fastpath,
                                     check_roundtrip=False)
        out["audit_after_cliff_ok"] = audit_mid.ok

        # jittered re-bring-up: the SAME generator cannot form a cliff
        from bng_tpu_torch.utils.net import mac_to_u64

        server.lease_jitter_frac = 0.5
        jmacs = macs[: max(200, n // 4)]
        dora_all(jmacs, 0x200000)
        jexps = {server.leases[mac_to_u64(m)].expiry for m in jmacs
                 if mac_to_u64(m) in server.leases}
        out["jitter_expiries"] = len(jexps)
        out["jitter_buckets_min"] = server.LEASE_JITTER_BUCKETS // 2

        # NAT cliff under nat.expire skew, same discipline
        from bng_tpu_torch.ops.parse import PROTO_UDP

        subs = [ip_to_u32("10.1.0.10") + i for i in range(32)]
        for s in subs:
            nat.allocate_nat(s, int(clock()))
            nat.handle_new_flow(s, ip_to_u32("1.1.1.1"), 5000, 53,
                                PROTO_UDP, 64, int(clock()))
        with armed(FaultPlan(seed, [
                FaultSpec("nat.expire", SKEW, at_hit=1, arg=-7200.0)]),
                log=False):
            out["nat_expired_backward"] = nat.expire_sessions(int(clock()))
        with armed(FaultPlan(seed, [
                FaultSpec("nat.expire", SKEW, at_hit=1, arg=7200.0)]),
                log=False):
            out["nat_expired_forward"] = nat.expire_sessions(int(clock()))

        audit = audit_invariants(pools=pools, dhcp=server,
                                 fastpath=fastpath, nat=nat,
                                 check_roundtrip=(scale <= 0.2))
        budget = check_budget(tracer, (
            # per-reap teardown envelope: observed ~20-60us/reap on CPU
            BudgetLine("ops", limit_us=2_000.0, per=reap_budget),
            # DORA generator laps amortized per subscriber (~100-250us
            # observed through the full slow path)
            BudgetLine("slow_path", limit_us=10_000.0, per=n),
        ))

    out["audit_ok"] = audit.ok
    out["violations"] = audit.violations_by_kind()
    out["budget"] = budget
    out["ok"] = (
        out["cliff_expiries"] == 1
        and out["reaped_backward_skew"] == 0
        and all(s <= reap_budget for s in sweeps)
        and len(sweeps) >= (n + reap_budget - 1) // reap_budget
        and sum(sweeps) == n
        and mid_service_ok == len(sweeps)  # service survived the cliff
        and out["audit_after_cliff_ok"]
        and out["jitter_expiries"] >= out["jitter_buckets_min"]
        and out["nat_expired_backward"] == 0
        and out["nat_expired_forward"] == len(subs)
        and audit.ok and budget["ok"])
    return out


# ---------------------------------------------------------------------------
# 3. CGNAT port-block exhaustion
# ---------------------------------------------------------------------------

def cgnat_port_exhaustion(seed: int, scale: float = 1.0) -> dict:
    """EIM churn until the CGNAT allocator exhausts: first the port
    space inside each subscriber's block, then the block space itself.
    Every refusal is a COUNTED degraded verdict (nat.exhausted +
    rate-limited ErrorLog — never silent), the block accounting stays
    exact (the auditor's nat-block-accounting check proves exhaustion
    is real, not a leak), and expiry + release make the blocks
    reusable."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.ops.parse import PROTO_UDP

    span = 64
    blocks_per_ip = 8
    n_subs = 20  # 16 get blocks, 4 are refused
    churn_rounds = max(1, int(round(2 * scale)))

    with _traced() as tracer:
        clock = SimClock()
        nat = NATManager(
            public_ips=[ip_to_u32("203.0.113.1"), ip_to_u32("203.0.113.2")],
            ports_per_subscriber=span,
            port_range=(1024, 1024 + span * blocks_per_ip - 1),
            sessions_nbuckets=1 << 11, sub_nat_nbuckets=256)
        subs = [ip_to_u32("10.9.0.10") + i for i in range(n_subs)]
        out = {"name": "cgnat_port_exhaustion", "seed": seed,
               "churn_rounds": churn_rounds}

        t0 = tele.t()
        granted = [s for s in subs if nat.allocate_nat(s, int(clock()))]
        refused_block = [s for s in subs if s not in granted]
        out["blocks_granted"] = len(granted)
        out["blocks_refused"] = len(refused_block)
        out["counted_block"] = int(nat.exhausted["block"])

        # port churn: each granted subscriber opens more distinct
        # endpoints than its block holds — EIM reuse keeps shared
        # endpoints cheap, the overflow must be refused AND counted
        flows_ok = flows_refused = 0
        dst = ip_to_u32("93.184.216.34")
        for s in granted:
            for p in range(span + 16):
                got = nat.handle_new_flow(s, dst, 2000 + p, 80,
                                          PROTO_UDP, 64, int(clock()))
                if got is None:
                    flows_refused += 1
                else:
                    flows_ok += 1
        out["flows_ok"] = flows_ok
        out["flows_refused"] = flows_refused
        out["counted_port"] = int(nat.exhausted["port"])
        tele.lap(tele.OPS, t0)
        audit_full = audit_invariants(nat=nat, check_roundtrip=False)
        out["audit_exhausted_ok"] = audit_full.ok

        # heal: expire the sessions, release a few blocks, and the
        # previously refused subscribers must now be served
        reuse_ok = 0
        for _ in range(churn_rounds):
            clock.advance(7200.0)
            nat.expire_sessions(int(clock()))
            for s in granted[:len(refused_block)]:
                nat.release_nat(s, int(clock()))
            for s in refused_block:
                if nat.allocate_nat(s, int(clock())) is not None:
                    reuse_ok += 1
            # swap roles for the next round so release/alloc churns
            granted, refused_block = (
                refused_block + granted[len(refused_block):],
                granted[:len(refused_block)])
        out["reused_after_release"] = reuse_ok

        audit = audit_invariants(nat=nat, check_roundtrip=False)
        budget = check_budget(tracer, (
            # whole churn phase (one lap): ~1300 flow punts, observed
            # low single-digit ms total on CPU
            BudgetLine("ops", limit_us=5_000_000.0),
        ))

    out["audit_ok"] = audit.ok
    out["violations"] = audit.violations_by_kind()
    out["budget"] = budget
    expect_granted = 2 * blocks_per_ip
    out["ok"] = (
        out["blocks_granted"] == expect_granted
        and out["blocks_refused"] == n_subs - expect_granted
        and out["counted_block"] == out["blocks_refused"]
        and out["flows_ok"] == expect_granted * span
        and out["flows_refused"] == expect_granted * 16
        and out["counted_port"] == out["flows_refused"]
        and out["audit_exhausted_ok"]
        and out["reused_after_release"]
        == churn_rounds * (n_subs - expect_granted)
        and audit.ok and budget["ok"])
    return out


# ---------------------------------------------------------------------------
# 4. CoA policy-flap storm
# ---------------------------------------------------------------------------

def coa_policy_flap(seed: int, scale: float = 1.0, device=None) -> dict:
    """RADIUS CoA bursts rewrite QoS device rows while renewals ride
    the device fast path. The flap storm interleaves authenticated
    CoA-Requests (policy flip via Filter-Id), NAK'd lookups for unknown
    sessions, bad-authenticator drops and a Disconnect teardown with
    live engine batches — then proves the host and device QoS mirrors
    agree bit-exact on every config word (the new qos-mirror audit)."""
    from bng_tpu_torch.control.radius import packet as rp
    from bng_tpu_torch.control.radius.coa import CoAProcessor, CoAServer
    from bng_tpu_torch.control.radius.packet import RadiusPacket
    from bng_tpu_torch.control.radius.policy import PolicyManager, QoSPolicy
    from bng_tpu_torch.runtime.engine import Engine, QoSTables
    from bng_tpu_torch.utils.net import u32_to_ip

    n_subs = 12
    flap_rounds = max(4, int(round(24 * scale)))
    secret = b"storm-secret"

    # warm-up runs UNtraced: the first engine.process pays the kernel
    # load, and a budget that averaged it into the dispatch stage would
    # measure the build, not the storm
    clock = SimClock()
    server, pools, fastpath, nat = _build_server_stack(clock)
    qos = QoSTables()
    policies = PolicyManager([
        QoSPolicy("gold", download_bps=400_000_000,
                  upload_bps=200_000_000),
        QoSPolicy("bronze", download_bps=50_000_000,
                  upload_bps=10_000_000),
    ])

    def qos_hook(ip, policy_name):
        p = policies.get(policy_name or "bronze")
        if p is not None:
            qos.set_subscriber(ip, p.download_bps, p.upload_bps)
        return True

    server.qos_hook = qos_hook
    eng = Engine(fastpath, nat, qos=qos, batch_size=32,
                 slow_path=server.handle_frame, clock=clock, device=device)
    fac = StormFrameFactory(SERVER_IP)
    base = (seed % 71) * 1_000_000
    macs = [_mac(base + i) for i in range(n_subs)]
    leased: dict[bytes, int] = {}
    for i, m in enumerate(macs):
        res = eng.process([fac.discover(m, 0x800 + i)])
        off = (res["slow"] or res["tx"])[0][1]
        ip = _reply(off).yiaddr
        eng.process([fac.request(m, ip, 0x900 + i)])
        leased[m] = ip

    def find_by_ip(ip):
        for mk, lease in server.leases.items():
            if lease.ip == ip:
                return lease
        return None

    def disconnect(lease):
        # the cli's CoA teardown idiom: force-expire so the client
        # re-DORAs, and drop the QoS rows both sides
        lease.expiry = 0
        server.cleanup_expired(1)
        qos.remove_subscriber(lease.ip)
        return True

    proc = CoAProcessor(find_by_ip=find_by_ip, qos_update=qos_hook,
                        disconnect=disconnect,
                        policy_manager=policies)
    coa = CoAServer(secret, proc)

    def coa_raw(code, ip, policy=None, bad_secret=False):
        req = RadiusPacket(code, (ip + code) & 0xFF)
        req.add(rp.FRAMED_IP_ADDRESS, ip)
        if policy is not None:
            req.add(rp.FILTER_ID, policy)
        return req.encode(b"wrong" if bad_secret else secret)

    with _traced() as tracer:
        # the flap storm: every round flips a deterministic subset's
        # policy between gold and bronze, mid-traffic
        renew_ok = 0
        renew_total = 0
        unknown_ip = ip_to_u32("172.31.0.1")
        for rnd in range(flap_rounds):
            policy = ("gold", "bronze")[rnd % 2]
            for i, m in enumerate(macs):
                if (i + rnd) % 3 == 0:
                    coa.handle_raw(coa_raw(rp.COA_REQUEST, leased[m],
                                           policy))
            # interleaved renewals must stay on the device fast path
            batch = [(fac.renew(m, leased[m], 0xA000 + rnd * 64 + i))
                     for i, m in enumerate(macs)]
            res = eng.process(batch, now=clock.advance(30.0))
            renew_total += len(batch)
            renew_ok += sum(
                1 for _l, f in res["tx"]
                if f is not None
                and _reply(f).msg_type == dhcp_codec.ACK)
            # storm noise: unknown session -> NAK; bad auth -> dropped
            coa.handle_raw(coa_raw(rp.COA_REQUEST, unknown_ip, "gold"))
            coa.handle_raw(coa_raw(rp.COA_REQUEST, leased[macs[0]],
                                   "gold", bad_secret=True))

        out = {"name": "coa_policy_flap", "seed": seed,
               "flap_rounds": flap_rounds,
               "coa_ack": proc.stats["coa_ack"],
               "coa_nak": proc.stats["coa_nak"],
               "bad_auth": coa.stats["bad_auth"],
               "renew_ok": renew_ok, "renew_total": renew_total}

        # disconnect storm tail: tear one session down over CoA
        victim = macs[-1]
        coa.handle_raw(coa_raw(rp.DISCONNECT_REQUEST, leased[victim]))
        out["disc_ack"] = proc.stats["disc_ack"]
        out["victim_gone"] = find_by_ip(leased[victim]) is None

        # the LAST flap that touched macs[0] decides its policy — the
        # host QoS row must hold exactly that round's rate
        from bng_tpu_torch.ops.qtable import QW_RATE_HI, QW_RATE_LO

        last_flip = max(r for r in range(flap_rounds) if r % 3 == 0)
        expect_policy = "gold" if last_flip % 2 == 0 else "bronze"
        probe_ip = leased[macs[0]]
        slot = qos.up._find(probe_ip)
        rate = (int(qos.up.rows[slot][QW_RATE_LO])
                | (int(qos.up.rows[slot][QW_RATE_HI]) << 32))
        out["probe_rate_matches"] = (
            rate == policies.get(expect_policy).upload_bps)
        out["probe_ip"] = u32_to_ip(probe_ip)

        audit = audit_invariants(engine=eng, pools=pools, dhcp=server,
                                 nat=nat)
        budget = check_budget(tracer, (
            # warm-path envelopes (~0.5-10ms observed per stage on CPU)
            BudgetLine("dispatch", limit_us=500_000.0),
            BudgetLine("device_wait", limit_us=2_000_000.0),
            BudgetLine("reply", limit_us=200_000.0),
            BudgetLine("total", limit_us=5_000_000.0),
        ))

    out["audit_ok"] = audit.ok
    out["violations"] = audit.violations_by_kind()
    out["budget"] = budget
    expected_acks = sum(
        sum(1 for i in range(n_subs) if (i + rnd) % 3 == 0)
        for rnd in range(flap_rounds))
    out["ok"] = (
        out["coa_ack"] == expected_acks
        and out["coa_nak"] == flap_rounds  # one unknown-session NAK/round
        and out["bad_auth"] == flap_rounds
        and renew_ok == renew_total  # flaps never knocked renewals off
        and out["disc_ack"] == 1 and out["victim_gone"]
        and out["probe_rate_matches"]
        and audit.ok and budget["ok"])
    return out


# ---------------------------------------------------------------------------
# 5. dual-stack bring-up storm
# ---------------------------------------------------------------------------

def _solicit6(mac: bytes, xid: int, duid: bytes) -> bytes:
    from bng_tpu_torch.control.dhcpv6 import protocol as p6
    from bng_tpu_torch.control.dhcpv6.protocol import DHCPv6Message, IANA, IAPD
    from bng_tpu_torch.frames import udp6_packet
    from bng_tpu_torch.control.slaac import link_local

    m = DHCPv6Message(p6.SOLICIT, xid & 0xFFFFFF)
    m.add(p6.OPT_CLIENTID, duid)
    m.add_ia_na(IANA(1))
    m.add_ia_pd(IAPD(1))
    return udp6_packet(mac, bytes.fromhex("333300010002"), link_local(mac),
                       bytes.fromhex("ff02000000000000"
                                     "0000000000010002"),
                       546, 547, m.encode())


def _request6(mac: bytes, xid: int, duid: bytes, server_duid: bytes,
              adv) -> bytes:
    from bng_tpu_torch.control.dhcpv6 import protocol as p6
    from bng_tpu_torch.control.dhcpv6.protocol import DHCPv6Message, IANA, IAPD
    from bng_tpu_torch.frames import udp6_packet
    from bng_tpu_torch.control.slaac import link_local

    m = DHCPv6Message(p6.REQUEST, xid & 0xFFFFFF)
    m.add(p6.OPT_CLIENTID, duid)
    m.add(p6.OPT_SERVERID, server_duid)
    m.add_ia_na(IANA(1))
    m.add_ia_pd(IAPD(1))
    return udp6_packet(mac, bytes.fromhex("333300010002"), link_local(mac),
                       bytes.fromhex("ff02000000000000"
                                     "0000000000010002"),
                       546, 547, m.encode())


def _rs_frame(mac: bytes) -> bytes:
    import struct as _s

    from bng_tpu_torch.control.slaac import link_local

    icmp = _s.pack(">BBHI", 133, 0, 0, 0)
    ip6 = _s.pack(">IHBB", 0x60000000, len(icmp), 58, 255) \
        + link_local(mac) \
        + bytes.fromhex("ff020000000000000000000000000002")
    return bytes.fromhex("333300000002") + mac + b"\x86\xdd" + ip6 + icmp


def dual_stack_bringup(seed: int, scale: float = 1.0) -> dict:
    """Every subscriber brings up v4 and v6 at once: DORA through the
    fleet, SOLICIT/REQUEST (IA_NA + IA_PD) and RS/RA through the
    parent demux fallback, interleaved in the same batches — the
    mixed-protocol slow queue a real dual-stack BNG sees after an
    access-node reboot. The checker proves BOTH books agree with their
    pool bitmaps (v4 cross-authority audit + the new v6 lease-vs-pool
    audit) and every subscriber ends fully dual-stacked."""
    from bng_tpu_torch.control.dhcpv6 import protocol as p6
    from bng_tpu_torch.control.dhcpv6.protocol import (DHCPv6Message,
                                                 generate_duid_ll)
    from bng_tpu_torch.control.dhcpv6.server import (AddressPool6, DHCPv6Server,
                                               DHCPv6ServerConfig,
                                               PrefixPool6)
    from bng_tpu_torch.control.slaac import (PrefixConfig, SLAACConfig,
                                       SLAACServer)
    from bng_tpu_torch.control.slowpath import SlowPathDemux

    n_subs = max(250, int(round(4_000 * scale)))
    workers = 3
    chunk = 512

    with _traced() as tracer:
        clock = SimClock()
        v6 = DHCPv6Server(
            DHCPv6ServerConfig(server_mac=SERVER_MAC, rapid_commit=False),
            address_pool=AddressPool6("2001:db8:100::/64"),
            prefix_pool=PrefixPool6("2001:db8:f000::/40",
                                    delegated_len=56),
            clock=clock)
        slaac = SLAACServer(SLAACConfig(
            server_mac=SERVER_MAC,
            prefixes=[PrefixConfig(
                prefix=bytes.fromhex("20010db8010000000000000000000000"))],
            managed=True))
        demux = SlowPathDemux(dhcpv6=v6, slaac=slaac, clock=clock)
        fleet, pools, fastpath = _build_storm_fleet(
            workers, clock, prefix_len=18, sub_nbuckets=1 << 13,
            slice_size=512, inbox=1 << 16, fallback=demux)

        fac = StormFrameFactory(SERVER_IP)
        server_duid = v6.duid.encode()
        base = (seed % 67) * 1_000_000
        macs = [_mac(base + i) for i in range(n_subs)]
        duids = {m: generate_duid_ll(m).encode() for m in macs}
        leased4: dict[bytes, int] = {}
        leased6_na: dict[bytes, bytes] = {}
        leased6_pd: dict[bytes, bytes] = {}
        ra_seen = 0
        xid = 1
        for ci in range(0, n_subs, chunk):
            cm = macs[ci:ci + chunk]
            # wave 1: DISCOVER + SOLICIT + RS interleaved per subscriber
            batch = []
            for m in cm:
                batch.append((len(batch), fac.discover(m, xid)))
                batch.append((len(batch), _solicit6(m, xid + 1, duids[m])))
                batch.append((len(batch), _rs_frame(m)))
                xid += 2
            out1 = fleet.handle_batch(batch, now=clock())
            offers: dict[bytes, int] = {}
            for (lane, rep) in out1:
                if rep is None:
                    continue
                m = cm[lane // 3]
                kind = lane % 3
                if kind == 0:
                    offers[m] = _reply(rep).yiaddr
                elif kind == 1:
                    adv = DHCPv6Message.decode(rep[62:])
                    assert adv.msg_type == p6.ADVERTISE
                elif kind == 2:
                    ra_seen += 1
            # wave 2: REQUEST (v4) + REQUEST (v6) interleaved
            batch = []
            for m in cm:
                batch.append((len(batch), fac.request(m, offers[m], xid)))
                batch.append((len(batch), _request6(m, xid + 1, duids[m],
                                                    server_duid, None)))
                xid += 2
            out2 = fleet.handle_batch(batch, now=clock())
            for (lane, rep) in out2:
                if rep is None:
                    continue
                m = cm[lane // 2]
                if lane % 2 == 0:
                    p = _reply(rep)
                    if p.msg_type == dhcp_codec.ACK:
                        leased4[m] = p.yiaddr
                else:
                    rep6 = DHCPv6Message.decode(rep[62:])
                    ias = rep6.ia_nas()
                    if ias and ias[0].addresses:
                        leased6_na[m] = ias[0].addresses[0].address
                    pds = rep6.ia_pds()
                    if pds and pds[0].prefixes:
                        leased6_pd[m] = pds[0].prefixes[0].prefix
            clock.advance(1.0)

        # cross-book checks: the same subscriber set, fully dual-stacked
        dual = sum(1 for m in macs
                   if m in leased4 and m in leased6_na and m in leased6_pd)
        audit = audit_invariants(pools=pools, fleet=fleet,
                                 fastpath=fastpath, dhcpv6=v6,
                                 check_roundtrip=(scale <= 0.2))
        budget = check_budget(tracer, (
            # 500us/frame: the flash-crowd rationale — the dual-stack
            # admit mean covers TWO laps, so one full-suite GC pause
            # inside either lap flakes a tighter envelope
            BudgetLine("admit", limit_us=500.0, per=chunk),
            BudgetLine("fleet", limit_us=5_000.0, per=chunk),
            BudgetLine("worker", limit_us=5_000.0),
        ))

    pool = pools.pools[1]
    out_rep = {
        "name": "dual_stack_bringup", "seed": seed,
        "subscribers": n_subs,
        "leased_v4": len(leased4),
        "leased_v6_na": len(leased6_na),
        "leased_v6_pd": len(leased6_pd),
        "dual_stacked": dual,
        "ra_seen": ra_seen,
        "rs_answered": slaac.stats.rs_received,
        "v4_pool_fleet_owned": sum(
            1 for owner in pool._allocated.values()
            if owner.startswith("fleet:")),
        "v6_allocated_na": len(v6.addr_pool._allocated),
        "v6_allocated_pd": len(v6.prefix_pool._allocated),
        "demux": dict(sorted(demux.stats.items())),
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
        "budget": budget,
    }
    out_rep["ok"] = (
        dual == n_subs
        and len(leased4) == n_subs
        and ra_seen == n_subs and slaac.stats.rs_received == n_subs
        # the v6 books agree with the v6 pool bitmaps EXACTLY
        and out_rep["v6_allocated_na"] == n_subs
        and out_rep["v6_allocated_pd"] == n_subs
        and audit.ok and budget["ok"])
    return out_rep


# ---------------------------------------------------------------------------
# 6. cluster-scale storm: 4M+ subscribers across a cluster of BNGs
# ---------------------------------------------------------------------------

def cluster_scale_storm(seed: int, scale: float = 1.0) -> dict:
    """4M+ subscribers steered across a 4-instance cluster
    (bng_tpu_torch/cluster). The full population is steered VECTORIZED
    (`steer_macs_u48` — one numpy pass over every MAC) and pinned
    bit-exact against the scalar `instance_for_mac` on a seeded sample;
    a sampled per-instance DORA wave then runs FULL FRAMES through the
    cluster front door, each wave under its own tracer so every
    instance gets its OWN SLO verdict (one overloaded member cannot
    hide behind the cluster mean). Mid-storm one member dies: the
    standby promotes and the victim's whole wave renews sticky. The
    `_audit_cluster` epilogue proves no IP is owned by two instances
    and every lease sits inside its owner's carve."""
    import random

    import numpy as np

    from bng_tpu_torch.cluster import ClusterCoordinator, instance_for_mac
    from bng_tpu_torch.cluster.plan import steer_macs_u48

    n_members = 4
    n_steered = max(40_000, int(round(4_200_000 * scale)))
    per_inst = max(250, int(round(6_000 * scale)))
    chunk = max(256, per_inst // 4)

    clock = SimClock()
    # a /9 space carves into 4 x /11 blocks: 8.4M addresses, so the 4M+
    # steered population fits the plan with room for growth blocks
    coord = ClusterCoordinator(
        clock=clock, space_network=ip_to_u32("10.0.0.0"),
        space_prefix_len=9, nat_base=ip_to_u32("100.64.0.0"),
        nat_total=1 << 14, sub_nbuckets=1 << 13, slice_size=256,
        inbox_capacity=1 << 15)
    coord.add_instances(["bng-%02d" % i for i in range(n_members)])
    ids = coord.member_ids()

    # ---- steer the WHOLE population in one vectorized pass ----------
    base = (seed % 89) * 8_000_000
    mac_u48 = ((np.uint64(0x02C5) << np.uint64(32)) + np.uint64(base)
               + np.arange(n_steered, dtype=np.uint64))
    steer = steer_macs_u48(mac_u48, len(ids))
    counts = np.bincount(steer, minlength=len(ids))
    steered = {ids[k]: int(counts[k]) for k in range(len(ids))}
    rng = random.Random(seed)
    sample = rng.sample(range(n_steered), min(512, n_steered))
    steer_identity = all(
        ids[int(steer[j])] == instance_for_mac(
            int(mac_u48[j]).to_bytes(6, "big"), ids)
        for j in sample)
    # FNV-1a32 over a contiguous MAC range lands near-uniform; a
    # member starving below 80% of its fair share means the steering
    # family regressed
    fair = n_steered / len(ids)
    spread_ok = all(int(c) >= int(0.8 * fair) for c in counts)

    # ---- sampled per-instance full-frame DORA waves -----------------
    fac = StormFrameFactory(SERVER_IP)
    waves: dict[str, list] = {}
    leases: dict[str, dict] = {}
    slo: dict[str, dict] = {}
    for k, iid in enumerate(ids):
        idx = np.flatnonzero(steer == k)[:per_inst]
        wave = [int(mac_u48[j]).to_bytes(6, "big") for j in idx]
        waves[iid] = wave
        got: dict[bytes, int] = {}
        xid = 1
        with _traced() as tracer:
            for ci in range(0, len(wave), chunk):
                cmacs = wave[ci:ci + chunk]
                out = coord.handle_batch(
                    [(i, fac.discover(m, xid + i))
                     for i, m in enumerate(cmacs)], now=clock())
                offers: dict[bytes, int] = {}
                for (_l, rep), m in zip(out, cmacs):
                    if rep is not None:
                        p = _reply(rep)
                        if p.msg_type == dhcp_codec.OFFER:
                            offers[m] = p.yiaddr
                req_macs = [m for m in cmacs if m in offers]
                out = coord.handle_batch(
                    [(i, fac.request(m, offers[m], 0x100000 + xid + i))
                     for i, m in enumerate(req_macs)], now=clock())
                for (_l, rep), m in zip(out, req_macs):
                    if rep is not None:
                        p = _reply(rep)
                        if p.msg_type == dhcp_codec.ACK:
                            got[m] = p.yiaddr
                xid += len(cmacs)
                clock.advance(1.0)
            # each instance gets its OWN verdict — envelopes match
            # flash_crowd_reconnect (same stages, same per-frame cost)
            slo[iid] = check_budget(tracer, (
                BudgetLine("admit", limit_us=500.0, per=chunk),
                BudgetLine("fleet", limit_us=2_000.0, per=chunk),
                BudgetLine("worker", limit_us=5_000.0),
            ))
        leases[iid] = got

    # carve containment, end to end: every ACKed address must sit in
    # the plan blocks of the instance that served it
    carve_ok = all(
        coord.plan.owner_of(ip) == iid
        for iid, got in leases.items() for ip in got.values())
    all_ips = [ip for got in leases.values() for ip in got.values()]
    unique_ok = len(all_ips) == len(set(all_ips))

    # ---- storm-scale failover: kill a member mid-service ------------
    victim = ids[seed % len(ids)]
    coord.kill_instance(victim)
    ticks = 0
    while coord.members[victim].role != "promoted" and ticks < 64:
        clock.advance(1.0)
        coord.tick()
        ticks += 1
    promoted = coord.members[victim].role == "promoted"

    # the victim's WHOLE wave renews through the promoted standby and
    # must come back with the addresses the dead active handed out
    vwave = [m for m in waves[victim] if m in leases[victim]]
    sticky = 0
    for ci in range(0, len(vwave), chunk):
        cmacs = vwave[ci:ci + chunk]
        out = coord.handle_batch(
            [(i, fac.renew(m, leases[victim][m], 0x200000 + ci + i))
             for i, m in enumerate(cmacs)], now=clock())
        sticky += sum(
            1 for (_l, rep), m in zip(out, cmacs)
            if rep is not None and _reply(rep).msg_type == dhcp_codec.ACK
            and _reply(rep).yiaddr == leases[victim][m])

    audit = audit_invariants(bng_cluster=coord)
    out_rep = {
        "name": "cluster_scale_storm", "seed": seed,
        "instances": len(ids),
        "subscribers": n_steered,
        "plan_addresses": coord.plan.total_addresses(),
        "steered": steered,
        "steer_identity": steer_identity,
        "spread_ok": spread_ok,
        "wave_per_instance": per_inst,
        "leased": {iid: len(got) for iid, got in sorted(leases.items())},
        "unique_ips": len(set(all_ips)),
        "carve_ok": carve_ok,
        "slo": {iid: slo[iid] for iid in sorted(slo)},
        "victim": victim,
        "promoted": promoted,
        "failovers": coord.failovers,
        "sticky_acks": sticky,
        "sticky_expected": len(vwave),
        "shed_frames": coord.shed_frames,
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
    }
    coord.close()
    out_rep["ok"] = (
        len(ids) >= 4
        and out_rep["plan_addresses"] >= n_steered
        and steer_identity and spread_ok
        and all(len(leases[i]) == len(waves[i]) for i in ids)
        and unique_ok and carve_ok
        and all(v["ok"] for v in slo.values())
        and promoted and coord.failovers == 1
        and sticky == len(vwave) and sticky > 0
        and audit.ok)
    return out_rep


# ---------------------------------------------------------------------------
# 7. production day: the composite edge-protection storm
# ---------------------------------------------------------------------------

def production_day(seed: int, scale: float = 1.0, device=None) -> dict:
    """One compressed production day on a single engine proves the edge
    subsystem under composite churn. Morning: IPoE DORA plus dual-stack
    SOLICIT/REQUEST and PPPoE discovery share one slow queue while every
    lease carves a CGNAT block and binds a next-hop route (ECMP by
    subscriber class). Midday: CoA policy waves rewrite QoS rows with
    renewals riding the device path. Afternoon: two intercept warrants
    arm mid-storm — matching flows mirror to RecordCC, non-matching
    flows are filtered ON DEVICE. Evening: an ISP uplink dies and the
    route table re-steers as bounded dirty-slot deltas (never a
    resync); a spoofed-source DDoS burst is dropped and counted by the
    antispoof stage. Night: the short warrant expires, the bounded reap
    removes its tap rows, and the edge audit plus per-stage SLO budget
    close the day."""
    from bng_tpu_torch import frames as packets
    from bng_tpu_torch.control.dhcpv6.server import (AddressPool6, DHCPv6Server,
                                               DHCPv6ServerConfig,
                                               PrefixPool6)
    from bng_tpu_torch.control.intercept import InterceptManager, Warrant
    from bng_tpu_torch.control.pppoe import codec as pcodec
    from bng_tpu_torch.control.pppoe.auth import LocalVerifier
    from bng_tpu_torch.control.pppoe.server import PPPoEServer, PPPoEServerConfig
    from bng_tpu_torch.control.radius import packet as rp
    from bng_tpu_torch.control.radius.coa import CoAProcessor, CoAServer
    from bng_tpu_torch.control.radius.packet import RadiusPacket
    from bng_tpu_torch.control.radius.policy import PolicyManager, QoSPolicy
    from bng_tpu_torch.control.routing import (RoutingManager, StubPlatform,
                                         Upstream)
    from bng_tpu_torch.control.slaac import PrefixConfig, SLAACConfig, SLAACServer
    from bng_tpu_torch.control.slowpath import SlowPathDemux
    from bng_tpu_torch.edge.compile import InterceptTapProgram, MirrorPump, RouteProgram
    from bng_tpu_torch.edge.tables import EdgeTables
    from bng_tpu_torch.edge.ops import EST_ROUTE_REWRITES, EST_TAP_FILTERED
    from bng_tpu_torch.ops.antispoof import (AST_DROPPED, AST_V4_VIOL,
                                       MODE_DISABLED, MODE_STRICT)
    from bng_tpu_torch.runtime.engine import (AntispoofTables, Engine, QoSTables)
    from bng_tpu_torch.utils.net import u32_to_ip

    import numpy as np

    n_subs = max(6, int(round(12 * scale)))
    n_v6 = max(2, int(round(4 * scale)))
    n_ppp = max(2, int(round(4 * scale)))
    coa_waves = max(2, int(round(6 * scale)))
    ddos = max(8, int(round(24 * scale)))
    secret = b"day-secret"

    # ---- build the whole stack UNtraced: the first process() pays the
    # fused-pipeline compile and must not land in a budget stage -------
    clock = SimClock()
    server, pools, fastpath, nat = _build_server_stack(clock)
    qos = QoSTables()
    spoof = AntispoofTables(nbuckets=256)
    # per-binding STRICT, default DISABLED: control planes (v6 SOLICIT,
    # PPPoE discovery) come from not-yet-bound MACs and must reach the
    # slow path; only a BOUND subscriber spoofing a foreign source is a
    # violation — exactly the reference's per-subscriber mode column
    spoof.set_config(MODE_DISABLED, True)
    edge = EdgeTables(nbuckets=256)
    policies = PolicyManager([
        QoSPolicy("gold", download_bps=400_000_000,
                  upload_bps=200_000_000),
        QoSPolicy("bronze", download_bps=50_000_000,
                  upload_bps=10_000_000),
    ])

    def qos_hook(ip, policy_name):
        p = policies.get(policy_name or "bronze")
        if p is not None:
            qos.set_subscriber(ip, p.download_bps, p.upload_bps)
        return True

    server.qos_hook = qos_hook

    im = InterceptManager(clock=clock)
    platform = StubPlatform()
    rman = RoutingManager(None, platform)
    rman.add_upstream(Upstream(name="ispA", interface="eth1",
                               gateway="192.0.2.1", table=100,
                               health_target="192.0.2.1", weight=1))
    rman.add_upstream(Upstream(name="ispB", interface="eth2",
                               gateway="192.0.2.2", table=101,
                               health_target="192.0.2.2", weight=1))
    platform.reachable["192.0.2.1"] = 0.001
    platform.reachable["192.0.2.2"] = 0.001
    for _ in range(3):
        rman.check_health()
    mac_a = bytes.fromhex("02dd0000000a")
    mac_b = bytes.fromhex("02dd0000000b")
    tap_prog = InterceptTapProgram(edge, im, clock=clock)
    route_prog = RouteProgram(edge, rman)
    route_prog.attach()
    route_prog.set_neighbor("192.0.2.1", mac_a)
    route_prog.set_neighbor("192.0.2.2", mac_b)
    pump = MirrorPump(tap_prog, manager=im)

    v6 = DHCPv6Server(
        DHCPv6ServerConfig(server_mac=SERVER_MAC, rapid_commit=False),
        address_pool=AddressPool6("2001:db8:100::/64"),
        prefix_pool=PrefixPool6("2001:db8:f000::/40", delegated_len=56),
        clock=clock)
    slaac = SLAACServer(SLAACConfig(
        server_mac=SERVER_MAC,
        prefixes=[PrefixConfig(
            prefix=bytes.fromhex("20010db8010000000000000000000000"))],
        managed=True))
    ppp = PPPoEServer(
        PPPoEServerConfig(our_ip=ip_to_u32("10.64.0.1"),
                          dns_primary=ip_to_u32("1.1.1.1"),
                          echo_interval_s=30.0),
        LocalVerifier({"alice": b"secret123"}),
        lambda username, mac: ip_to_u32("10.64.0.100"),
        magic_source=lambda: 0xDEADBEEF,
        challenge_source=lambda: b"C" * 16)
    demux = SlowPathDemux(dhcp=server, dhcpv6=v6, slaac=slaac, pppoe=ppp,
                          clock=clock)
    eng = Engine(fastpath, nat, qos=qos, antispoof=spoof, edge=edge,
                 mirror_sink=pump, batch_size=32, slow_path=demux,
                 clock=clock, device=device)

    fac = StormFrameFactory(SERVER_IP)
    base = (seed % 61) * 1_000_000
    macs = [_mac(base + i) for i in range(n_subs)]
    ppp_macs = [_mac(base + 0x10000 + i) for i in range(n_ppp)]
    v6_macs = [_mac(base + 0x20000 + i) for i in range(n_v6)]
    ext_ip = ip_to_u32("198.51.100.9")

    def data(mac, src_ip, dport, sport=40000):
        return packets.udp_packet(mac, SERVER_MAC, src_ip, ext_ip,
                                  sport, dport, b"production-day")

    # warm-up: ONE lease pays the kernel load outside the tracer
    leased: dict[bytes, int] = {}

    def dora(m, i):
        res = eng.process([fac.discover(m, 0x800 + i)])
        off = (res["slow"] or res["tx"])[0][1]
        ip = _reply(off).yiaddr
        eng.process([fac.request(m, ip, 0x900 + i)])
        leased[m] = ip

    dora(macs[0], 0)

    with _traced() as tracer:
        # ---- morning: bring-up wave — IPoE + dual-stack + PPPoE ------
        for i, m in enumerate(macs[1:], start=1):
            dora(m, i)
        for m in macs:
            spoof.add_binding(m, leased[m], MODE_STRICT)
            route_prog.bind_subscriber(
                leased[m], "business" if leased[m] % 2 else "residential")

        from bng_tpu_torch.control.dhcpv6.protocol import (DHCPv6Message,
                                                     generate_duid_ll)
        from bng_tpu_torch.control.dhcpv6 import protocol as p6

        server_duid = v6.duid.encode()
        v6_leased = 0
        ra_seen = 0
        for i, m in enumerate(v6_macs):
            duid = generate_duid_ll(m).encode()
            res = eng.process([_solicit6(m, 0x600 + i, duid),
                               _rs_frame(m)])
            replies = [f for _l, f in res["slow"] if f is not None]
            ra_seen += sum(1 for f in replies if f[12:14] == b"\x86\xdd"
                           and f[20] != 17)
            res = eng.process([_request6(m, 0x700 + i, duid,
                                         server_duid, None)])
            for _l, f in res["slow"]:
                if f is None or f[20] != 17:
                    continue
                msg = DHCPv6Message.decode(f[62:])
                if msg.msg_type == p6.REPLY:
                    ias = msg.ia_nas()
                    if ias and ias[0].addresses:
                        v6_leased += 1

        ppp_sessions = 0
        for i, m in enumerate(ppp_macs):
            padi = pcodec.PPPoEPacket(pcodec.CODE_PADI, 0,
                                      pcodec.serialize_tags(
                [pcodec.Tag(pcodec.TAG_SERVICE_NAME, b""),
                 pcodec.Tag(pcodec.TAG_HOST_UNIQ, b"HU%02d" % i)]))
            res = eng.process([pcodec.eth_frame(
                b"\xff" * 6, m, pcodec.ETH_PPPOE_DISCOVERY, padi.encode())])
            pado = next((f for _l, f in res["slow"] if f is not None), None)
            if pado is None:
                continue
            _d, src, _e, payload = pcodec.parse_eth(pado)
            tags = pcodec.parse_tags(pcodec.PPPoEPacket.decode(payload).payload)
            cookie = pcodec.find_tag(tags, pcodec.TAG_AC_COOKIE)
            out_tags = [pcodec.Tag(pcodec.TAG_SERVICE_NAME, b"")]
            if cookie is not None:
                out_tags.append(cookie)
            padr = pcodec.PPPoEPacket(pcodec.CODE_PADR, 0,
                                      pcodec.serialize_tags(out_tags))
            res = eng.process([pcodec.eth_frame(
                src, m, pcodec.ETH_PPPOE_DISCOVERY, padr.encode())])
            for _l, f in res["slow"]:
                if f is None:
                    continue
                pads = pcodec.PPPoEPacket.decode(pcodec.parse_eth(f)[3])
                if pads.code == pcodec.CODE_PADS and pads.session_id:
                    ppp_sessions += 1
            demux.drain_pending()  # LCP conf-reqs beyond the ring contract

        # every lease carved a CGNAT block at DORA time (nat_hook); a
        # first flow per subscriber proves the blocks actually translate
        nat_flows = sum(
            1 for i, m in enumerate(macs)
            if nat.handle_new_flow(leased[m], ext_ip, 40000 + i, 80, 17,
                                   100, int(clock())) is not None)

        def forward_wave(dport, sport=41000):
            """One upstream data frame per subscriber; returns (fwd
            count, dst MACs of the forwarded frames)."""
            res = eng.process([data(m, leased[m], dport,
                                    sport=sport + i)
                               for i, m in enumerate(macs)],
                              now=clock.advance(1.0))
            out_macs = [bytes(f[:6]) for _l, f in res["fwd"]]
            return len(res["fwd"]), out_macs

        fwd_morning, wave_macs = forward_wave(8080)
        on_isps = sum(1 for mm in wave_macs if mm in (mac_a, mac_b))
        classes_split = len(set(wave_macs)) == 2  # ECMP split by class

        # ---- midday: CoA policy waves with renewals on the device ----
        def find_by_ip(ip):
            for _mk, lease in server.leases.items():
                if lease.ip == ip:
                    return lease
            return None

        proc = CoAProcessor(find_by_ip=find_by_ip, qos_update=qos_hook,
                            policy_manager=policies)
        coa = CoAServer(secret, proc)
        renew_ok = renew_total = 0
        for rnd in range(coa_waves):
            policy = ("gold", "bronze")[rnd % 2]
            for i, m in enumerate(macs):
                if (i + rnd) % 3 == 0:
                    req = RadiusPacket(rp.COA_REQUEST,
                                       (leased[m] + rnd) & 0xFF)
                    req.add(rp.FRAMED_IP_ADDRESS, leased[m])
                    req.add(rp.FILTER_ID, policy)
                    coa.handle_raw(req.encode(secret))
            batch = [fac.renew(m, leased[m], 0xA000 + rnd * 64 + i)
                     for i, m in enumerate(macs)]
            res = eng.process(batch, now=clock.advance(30.0))
            renew_total += len(batch)
            renew_ok += sum(1 for _l, f in res["tx"]
                            if f is not None
                            and _reply(f).msg_type == dhcp_codec.ACK)

        # ---- afternoon: taps armed MID-storm -------------------------
        now = clock()
        im.add_warrant(Warrant(id="W-DAY-1", liid="LIID-D1",
                               target_ipv4=u32_to_ip(leased[macs[0]]),
                               valid_from=now - 1.0,
                               valid_until=now + 100_000.0,
                               filter_dest_ports=[443]))
        im.add_warrant(Warrant(id="W-DAY-2", liid="LIID-D2",
                               target_ipv4=u32_to_ip(leased[macs[1]]),
                               valid_from=now - 1.0,
                               valid_until=now + 600.0))
        sync_rep = tap_prog.sync()
        filtered_before = int(np.asarray(eng.stats.edge)[EST_TAP_FILTERED])
        # matching flow mirrors; non-matching is filtered ON DEVICE
        eng.process([data(macs[0], leased[macs[0]], 443, sport=42000),
                     data(macs[0], leased[macs[0]], 9999, sport=42001),
                     data(macs[1], leased[macs[1]], 8080, sport=42002),
                     data(macs[2], leased[macs[2]], 443, sport=42003)],
                    now=clock.advance(1.0))
        filtered_on_device = (int(np.asarray(eng.stats.edge)[EST_TAP_FILTERED])
                              - filtered_before)
        mirrored_day = pump.stats["mirrored"]
        cc_records = im.stats()["cc_records"]

        # ---- evening rush: uplink dies + DDoS burst ------------------
        del platform.reachable["192.0.2.1"]
        for _ in range(rman.config.failure_threshold):
            rman.check_health()
        dirty_after_flap = edge.dirty_count()
        deltas = route_prog.stats["deltas"]
        fwd_evening, wave_macs = forward_wave(8081, sport=43000)
        on_survivor = sum(1 for mm in wave_macs if mm == mac_b)

        viol_before = np.asarray(eng.stats.spoof)[
            [AST_DROPPED, AST_V4_VIOL]].astype(np.int64)
        burst = [data(macs[i % n_subs],
                      ip_to_u32("172.16.9.9") + i,  # NOT the binding
                      53, sport=44000 + i)
                 for i in range(ddos)]
        eng.process(burst, now=clock.advance(1.0))
        viol_delta = (np.asarray(eng.stats.spoof)[
            [AST_DROPPED, AST_V4_VIOL]].astype(np.int64) - viol_before)

        # ---- night: the short warrant expires; bounded reap ----------
        clock.advance(700.0)
        expired = im.expire_warrants(max_reaps=4)
        reap_rep = tap_prog.sync()
        mirrored_before_night = pump.stats["mirrored"]
        eng.process([data(macs[1], leased[macs[1]], 8080, sport=45000)],
                    now=clock())
        mirrored_at_night = pump.stats["mirrored"] - mirrored_before_night

        audit = audit_invariants(engine=eng, pools=pools, dhcp=server,
                                 nat=nat, dhcpv6=v6,
                                 tap_program=tap_prog,
                                 route_program=route_prog)
        budget = check_budget(tracer, (
            # the coa_policy_flap envelopes: same engine, same stages
            BudgetLine("dispatch", limit_us=500_000.0),
            BudgetLine("device_wait", limit_us=2_000_000.0),
            BudgetLine("reply", limit_us=200_000.0),
            BudgetLine("total", limit_us=5_000_000.0),
        ))

    out = {
        "name": "production_day", "seed": seed,
        "subscribers": n_subs,
        "leased": len(leased),
        "v6_leased": v6_leased,
        "ra_seen": ra_seen,
        "ppp_sessions": ppp_sessions,
        "nat_flows": nat_flows,
        "routes_bound": route_prog.stats["bound"],
        "fwd_morning": fwd_morning,
        "ecmp_on_isps": on_isps,
        "ecmp_split": classes_split,
        "coa_ack": proc.stats["coa_ack"],
        "renew_ok": renew_ok, "renew_total": renew_total,
        "taps_armed": sync_rep["armed"],
        "mirrored": mirrored_day,
        "cc_records": cc_records,
        "filtered_on_device": filtered_on_device,
        "route_flaps": route_prog.stats["flaps"],
        "route_deltas": deltas,
        "dirty_after_flap": dirty_after_flap,
        "fwd_evening": fwd_evening,
        "on_survivor": on_survivor,
        "spoof_dropped": int(viol_delta[0]),
        "spoof_v4_viol": int(viol_delta[1]),
        "warrants_expired": expired,
        "taps_reaped": reap_rep["reaped"],
        "tap_rows_after_reap": reap_rep["rows"],
        "mirrored_after_expiry": mirrored_at_night,
        "edge_rewrites": int(np.asarray(eng.stats.edge)[EST_ROUTE_REWRITES]),
        "demux": dict(sorted(demux.stats.items())),
        "audit_ok": audit.ok,
        "violations": audit.violations_by_kind(),
        "budget": budget,
    }
    out["ok"] = (
        len(leased) == n_subs
        and v6_leased == n_v6 and ra_seen == n_v6
        and ppp_sessions == n_ppp
        and nat_flows == n_subs
        and out["routes_bound"] == n_subs
        and fwd_morning == n_subs and on_isps == n_subs
        and classes_split
        and renew_ok == renew_total
        and out["taps_armed"] == 2
        # W-DAY-1 matched once (443), W-DAY-2 has no filters (any flow);
        # the 9999 flow died on the DEVICE filter predicate, and the
        # untargeted macs[2] flow never mirrors
        and mirrored_day == 2 and cc_records == 2
        and filtered_on_device >= 1
        and out["route_flaps"] == 1 and deltas >= 1
        and 0 < dirty_after_flap <= 2 * n_subs
        and fwd_evening == n_subs and on_survivor == n_subs
        and out["spoof_dropped"] == ddos
        and out["spoof_v4_viol"] == ddos
        and expired == 1
        and out["taps_reaped"] == 1 and out["tap_rows_after_reap"] == 1
        and mirrored_at_night == 0
        and audit.ok and budget["ok"])
    return out


# ---------------------------------------------------------------------------
# registry (merged into the runner's catalog next to SCENARIOS)
# ---------------------------------------------------------------------------

STORMS = {
    "flash_crowd_reconnect": flash_crowd_reconnect,
    "lease_expiry_avalanche": lease_expiry_avalanche,
    "cgnat_port_exhaustion": cgnat_port_exhaustion,
    "coa_policy_flap": coa_policy_flap,
    "dual_stack_bringup": dual_stack_bringup,
    "cluster_scale_storm": cluster_scale_storm,
    "production_day": production_day,
}
