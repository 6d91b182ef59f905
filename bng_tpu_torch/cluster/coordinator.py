"""ClusterCoordinator: N BNG instances composed into one system.

The composition root above the single-process boundary:

- **Membership** lives in a shared Nexus store (`MemoryStore` embedded,
  or any Store-shaped remote). Instances register under
  `cluster/instances/`; every membership change elects a carver
  (`elect_carver`: lowest sorted id) which writes the carve plan to
  `cluster/plan`. All members — carver included — apply the plan via
  the store watch, so the plan document is the only authority.
- **Carving** follows `plan.replan`'s never-half-allocate discipline:
  whole blocks only, survivors never disturbed, a leaver's blocks
  return to the free list only after its leases drained
  (`remove_instance` refuses a live book without `force=True`).
- **HA pairing**: each member gets an `ActiveSyncer` fed by its fleet's
  lease events (the TableEventLog replay discipline, relayed by the
  coordinator after every batch) and a `StandbySyncer` mirroring it.
  A `HealthMonitor`/`FailoverController` pair watches liveness; on
  promote, a fresh instance hydrates its lease books from the
  replicated sessions (`InlineInstance.hydrate_sessions`) and takes
  over the same member slot — steering is untouched, so the flash
  crowd's re-DORA lands on the promoted standby with sticky addresses.
- **Steering**: `instance_for_mac` over the sorted plan membership —
  the same FNV-1a32 family as worker and device sharding.

Checkpoint interop: the carve plan rides `runtime/checkpoint.py` as the
`cluster_plan` component (`checkpoint_plan`/`parse_plan`/`restore_plan`)
so a restarted coordinator resumes the exact carve epoch.

A copy of `bng_tpu/cluster/coordinator.py` with its imports renamed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable

from bng_tpu_torch.control.ha import (ActiveSyncer, FailoverController,
                                HealthMonitor, InMemorySessionStore, Role,
                                StandbySyncer)
from bng_tpu_torch.control.nexus import MemoryStore, TypedStore
from bng_tpu_torch.telemetry import spans as tele
from bng_tpu_torch.telemetry.recorder import TRIG_HOST_LOSS, TRIG_MEMBER_SUSPECT
from bng_tpu_torch.utils.net import ip_to_u32

from .fabric import FailureDetector
from .handoff import HandoffManager, build_handoff_checkpoint
from .instance import InlineInstance, InstanceSpec, ProcessInstance
from .plan import (ClusterPlan, InstancePlan, elect_carver, initial_plan,
                   instance_for_mac, replan)

_MEMBERS_PREFIX = "cluster/instances/"
_PLAN_KEY = "cluster/plan"

DEFAULT_SERVER_MAC = bytes.fromhex("02aabbccdd01")
DEFAULT_SERVER_IP = ip_to_u32("10.0.0.1")

# dev/test PSK for the fabric when the operator supplies none; a real
# multi-host deployment passes its own via `bng cluster run --fabric-psk`
DEFAULT_FABRIC_PSK = "bng-cluster-fabric-dev-psk"


@dataclass
class InstanceEntity:
    """Membership record in the Nexus store."""

    id: str
    joined_at: float = 0.0
    state: str = "up"


class _Member:
    """Coordinator-side slot for one instance: the serving stack plus
    its HA pair and failover machinery."""

    def __init__(self, instance_id: str):
        self.id = instance_id
        self.spec: InstanceSpec | None = None
        self.instance = None  # InlineInstance | ProcessInstance | None
        self.alive = True
        self.role = "active"  # active | promoted
        self.remote = False   # fabric-joined, served on another host
        self.serving_remote = False  # joiner runs a full serving stack
        self.hydrated_epoch = 0      # last plan epoch a handoff shipped
        self.handoff_xid = ""        # in-flight carve transfer id
        self.host = ""
        self.store: InMemorySessionStore | None = None
        self.syncer: ActiveSyncer | None = None
        self.standby_store: InMemorySessionStore | None = None
        self.standby: StandbySyncer | None = None
        self.monitor: HealthMonitor | None = None
        self.failover: FailoverController | None = None

    @property
    def pending(self) -> bool:
        return self.instance is None


class ClusterCoordinator:
    """Compose N instances behind one front door (inline mode for
    deterministic tests, process mode for real serving)."""

    def __init__(self, *, mode: str = "inline",
                 clock: Callable[[], float] | None = None,
                 store=None,
                 space_network: int = ip_to_u32("10.0.0.0"),
                 space_prefix_len: int = 10,
                 block_prefix_len: int | None = None,
                 nat_base: int = 0, nat_total: int = 0,
                 server_mac: bytes = DEFAULT_SERVER_MAC,
                 server_ip: int = DEFAULT_SERVER_IP,
                 ha: bool = True, n_workers: int = 1,
                 slice_size: int = 256, inbox_capacity: int = 4096,
                 sub_nbuckets: int = 0, lease_time: int = 3600,
                 ha_failover_delay_s: float = 2.0,
                 ha_probe_interval_s: float = 0.5,
                 ha_failure_threshold: int = 3,
                 fabric: bool = False,
                 fabric_psk: str = "",
                 fabric_bind: tuple = ("127.0.0.1", 0),
                 fabric_endpoint=None,
                 fabric_beat_interval_s: float = 0.5,
                 fabric_suspicion_threshold: int = 3,
                 fabric_gray_beats: int = 4,
                 fabric_startup_grace_s: float = 30.0):
        if mode not in ("inline", "process"):
            raise ValueError(f"cluster mode {mode!r}: expected "
                             f"'inline' or 'process'")
        import time

        self.mode = mode
        self.clock = clock or time.time
        self.store = store if store is not None else MemoryStore()
        self.space_network = space_network
        self.space_prefix_len = space_prefix_len
        self.block_prefix_len = block_prefix_len
        self.nat_base = nat_base
        self.nat_total = nat_total
        self.server_mac = server_mac
        self.server_ip = server_ip
        self.ha = ha
        self.n_workers = n_workers
        self.slice_size = slice_size
        self.inbox_capacity = inbox_capacity
        self.sub_nbuckets = sub_nbuckets
        self.lease_time = lease_time
        self.ha_failover_delay_s = ha_failover_delay_s
        self.ha_probe_interval_s = ha_probe_interval_s
        self.ha_failure_threshold = ha_failure_threshold

        self.members: dict[str, _Member] = {}
        self.plan: ClusterPlan | None = None
        self.recarves = 0
        self.failovers = 0
        self.refused_removes = 0
        self.shed_frames = 0
        self.host_losses = 0
        self.steered: dict[str, int] = {}
        self._hosts: dict[str, str] = {}
        self._lost_hosts: set = set()
        # host-loss hook (chaos + ops): called once per lost host with
        # (host, [member_ids]) AFTER the group promotion — the seam the
        # accounting-spool replay and alerting wire into
        self.on_host_loss = None
        # deterministic tests chain the remote members' own tick onto
        # the front door's reply wait (single-threaded SimTransport)
        self.remote_waiter = None
        self.fabric_events: list = []  # last 64 (peer, verdict) pairs

        # -- control fabric: the real-transport membership lane. The
        # coordinator is the star hub — members beat TO it, so it is
        # the sole observer and quorum is 1 (pipe-oracle semantics).
        # `fabric_endpoint` injects a SimTransport endpoint for the
        # deterministic chaos lane; `fabric=True` builds the UDP lane.
        self.fabric_beat_interval_s = fabric_beat_interval_s
        self.fabric_psk = fabric_psk or DEFAULT_FABRIC_PSK
        self.fabric_transport = fabric_endpoint
        self.fabric_detector: FailureDetector | None = None
        self.handoff: HandoffManager | None = None
        # real-transport mode waits on remote replies with a short
        # sleep; an injected SimTransport endpoint is single-threaded
        # and must never sleep (the test drives both sides itself)
        self._fabric_real = fabric and fabric_endpoint is None
        if fabric and fabric_endpoint is None:
            from bng_tpu_torch.control.deviceauth import PSKAuthenticator

            from .fabric import UDPTransport
            self.fabric_transport = UDPTransport(
                "coordinator", PSKAuthenticator(psk=self.fabric_psk),
                bind=fabric_bind, clock=self.clock)
        if self.fabric_transport is not None:
            self.handoff = HandoffManager(self.fabric_transport,
                                          clock=self.clock)
            self.fabric_detector = FailureDetector(
                "coordinator", self.fabric_transport, clock=self.clock,
                beat_interval_s=fabric_beat_interval_s,
                suspicion_threshold=fabric_suspicion_threshold,
                gray_beats=fabric_gray_beats,
                startup_grace_s=fabric_startup_grace_s, quorum=1,
                on_verdict=self._on_fabric_verdict,
                on_message=self._on_fabric_message)

        self._hold_recarve = False
        self.registry = TypedStore(self.store, _MEMBERS_PREFIX.rstrip("/"),
                                   InstanceEntity)
        self._cancel_members = self.store.watch(_MEMBERS_PREFIX,
                                                self._on_membership)
        self._cancel_plan = self.store.watch(_PLAN_KEY, self._on_plan)

    # -- membership -------------------------------------------------------
    def add_instances(self, instance_ids: list, host: str = "",
                      remotes: dict | None = None) -> None:
        """Register a founding (or joining) batch in one carve: blocks
        deal across the whole batch instead of the first registrant
        swallowing the space. `host` tags the batch's placement for the
        plan's host axis (blocks interleave across hosts).

        `remotes` ({instance_id: host}) declares EXPECTED remote slots
        in the same carve: the founding deal interleaves their blocks
        on the host axis now, and the slot comes alive when its box
        `--join`s into it (multi-box deployment — the initial
        carve deals every block, so a slot declared later could only
        ever wait on the free list)."""
        remotes = dict(remotes or {})
        for iid in list(instance_ids) + sorted(remotes):
            if iid in self.members:
                raise ValueError(f"instance {iid!r} already registered")
        for iid in instance_ids:
            self.members[iid] = _Member(iid)
            self.members[iid].host = host
            self._hosts[iid] = host
        for iid, rhost in sorted(remotes.items()):
            m = self.members[iid] = _Member(iid)
            m.remote = True
            m.host = rhost
            self._hosts[iid] = rhost
        # hold the carve until the whole batch registered: the founding
        # set must carve TOGETHER, or the first registrant's initial
        # plan swallows every block and the rest join empty-handed
        self._hold_recarve = True
        try:
            for iid in list(instance_ids) + sorted(remotes):
                self.registry.put(iid, InstanceEntity(id=iid,
                                                      joined_at=self.clock()))
        finally:
            self._hold_recarve = False
        self._recarve()
        if self.plan is not None:
            # a restored plan may already cover this membership (carve
            # unchanged -> no new epoch): build the instances anyway
            self._apply_plan()

    def add_instance(self, instance_id: str, host: str = "") -> None:
        self.add_instances([instance_id], host=host)

    def add_remote_instance(self, instance_id: str, host: str,
                            addr: tuple | None = None,
                            serving: bool = False) -> None:
        """A fabric-joined member served on another host: it takes part
        in the carve (its blocks interleave on the host axis) and the
        failure detector watches its beats. With `serving=True` (the
        `--join` runtime) the coordinator streams its carve
        over the handoff lane and fronts it with a `RemoteInstance`
        handle, so steered frames are SERVED across the fabric; an
        announce-only joiner keeps the beat-only shape — frames steered its
        way are shed and counted."""
        if instance_id in self.members:
            raise ValueError(f"instance {instance_id!r} already registered")
        m = _Member(instance_id)
        m.remote = True
        m.serving_remote = serving
        m.host = host
        self.members[instance_id] = m
        self._hosts[instance_id] = host
        if addr is not None and self.fabric_transport is not None:
            self.fabric_transport.add_peer(instance_id, addr)
        if self.fabric_detector is not None:
            self.fabric_detector.watch(instance_id, now=self.clock())
        self.registry.put(instance_id,
                          InstanceEntity(id=instance_id,
                                         joined_at=self.clock()))

    def remove_instance(self, instance_id: str, force: bool = False) -> bool:
        """Leave. Refused while the instance still holds leases — a
        block must drain before its addresses transfer (`force=True`
        drops the sessions, the operator's explicit loss)."""
        m = self.members.get(instance_id)
        if m is None:
            raise KeyError(f"unknown instance {instance_id!r}")
        held = m.instance.lease_count() if m.instance is not None else 0
        if not held and m.remote and m.store is not None:
            # a remote member's authoritative books live off-box; the
            # HA mirror on this host is the drain evidence we hold
            held = len(m.store)
        if m.instance is not None and not force and held:
            self.refused_removes += 1
            return False
        if m.instance is not None:
            m.instance.close()
        del self.members[instance_id]
        self.registry.delete(instance_id)
        return True

    def _on_membership(self, _key: str, _value) -> None:
        if not self._hold_recarve:
            self._recarve()

    def _recarve(self) -> None:
        ids = sorted(self.registry.list())
        carver = elect_carver(ids)
        if carver is None or carver not in self.members:
            return  # carver hosted elsewhere (or empty cluster)
        if self.plan is None:
            new = initial_plan(self.space_network, self.space_prefix_len,
                               ids, block_prefix_len=self.block_prefix_len,
                               nat_base=self.nat_base,
                               nat_total=self.nat_total, hosts=self._hosts)
        else:
            new = replan(self.plan, ids, hosts=self._hosts)
            if new is self.plan:
                return
        self.recarves += 1
        self.store.put(_PLAN_KEY, json.dumps(new.to_dict(),
                                             sort_keys=True).encode())

    # -- plan application -------------------------------------------------
    def _on_plan(self, _key: str, value: bytes | None) -> None:
        if value is None:
            return
        incoming = ClusterPlan.from_dict(json.loads(value))
        if self.plan is not None and incoming.epoch <= self.plan.epoch:
            return
        self.plan = incoming
        self._apply_plan()

    def _apply_plan(self) -> None:
        for iid, iplan in self.plan.members.items():
            m = self.members.get(iid)
            if m is None or not iplan.blocks:
                continue
            if m.remote:
                # serving joiners hydrate over the handoff stream; a
                # new epoch (join carve or replan block move) ships a
                # fresh carve checkpoint
                if (m.serving_remote and self.handoff is not None
                        and m.hydrated_epoch < self.plan.epoch):
                    self._start_handoff(m)
                continue
            if m.instance is None:
                m.spec = self._spec_for(iplan)
                m.instance = self._build_instance(m.spec)
                # only process members beat over the fabric; inline
                # members stay on the in-process flag oracle (watching
                # them would read their silence as failure)
                if self.fabric_detector is not None and self.mode == "process":
                    self.fabric_detector.watch(iid, now=self.clock())
                if self.ha:
                    self._wire_ha(m)
            elif hasattr(m.instance, "apply_plan"):
                # inline members adopt carve changes live; a process
                # member restarts on its next roll to pick them up
                m.spec = self._spec_for(iplan)
                m.instance.apply_plan(iplan)

    def _start_handoff(self, m: _Member) -> None:
        """Stream the member's carve to it as a verified checkpoint:
        the plan document, its spec parameters, and any HA sessions
        this host already mirrors for its slot (standby bootstrap /
        replan move — empty at first join). The receiver hydrates all
        of it or none of it."""
        iplan = self.plan.members[m.id]
        m.spec = self._spec_for(iplan)
        sessions = []
        if m.store is not None:
            sessions = [{"session_id": s.session_id, "mac": s.mac,
                         "ip": s.ip, "pool_id": s.pool_id,
                         "username": s.username,
                         "lease_expiry": s.lease_expiry,
                         "qos_policy": s.qos_policy}
                        for s in m.store.all()]
        data = build_handoff_checkpoint(self.plan.epoch, {
            "cluster_plan": self.plan.to_dict(),
            "member": {
                "instance_id": m.id,
                "spec": {"server_mac": self.server_mac.hex(),
                         "server_ip": self.server_ip,
                         "n_workers": self.n_workers,
                         "slice_size": self.slice_size,
                         "inbox_capacity": self.inbox_capacity,
                         "lease_time": self.lease_time,
                         "sub_nbuckets": self.sub_nbuckets},
                "sessions": sessions,
            },
        })
        sender = self.handoff.send(m.id, data, kind="carve",
                                   meta={"instance_id": m.id,
                                         "epoch": self.plan.epoch})
        m.handoff_xid = sender.xid
        m.hydrated_epoch = self.plan.epoch

    def _remote_pump(self) -> None:
        """Drive the fabric while a RemoteInstance waits for replies:
        drain the transport (the detector routes rbatch replies back
        through `_on_fabric_message`), let an injected waiter advance
        the far side (sim tests), breathe in real-UDP mode."""
        if self.fabric_detector is not None:
            self.fabric_detector.tick(self.clock())
        if self.remote_waiter is not None:
            self.remote_waiter()
        elif self._fabric_real:
            import time as _time

            _time.sleep(0.002)

    def _spec_for(self, iplan: InstancePlan) -> InstanceSpec:
        spec = InstanceSpec.from_plan(
            iplan, self.plan, server_mac=self.server_mac,
            server_ip=self.server_ip, n_workers=self.n_workers,
            slice_size=self.slice_size, inbox_capacity=self.inbox_capacity,
            lease_time=self.lease_time, sub_nbuckets=self.sub_nbuckets)
        if self.mode == "process" and self.fabric_transport is not None:
            # the child beats back to this address over the UDP fabric
            spec.fabric_addr = tuple(self.fabric_transport.addr)
            spec.fabric_psk = self.fabric_psk
            spec.beat_interval_s = self.fabric_beat_interval_s
        return spec

    def _build_instance(self, spec: InstanceSpec):
        if self.mode == "process":
            return ProcessInstance(spec)
        return InlineInstance(spec, clock=self.clock)

    # -- HA pairing -------------------------------------------------------
    def _wire_ha(self, m: _Member, checkpoint: dict | None = None) -> None:
        m.store = InMemorySessionStore()
        m.syncer = ActiveSyncer(m.store)
        if checkpoint is not None:
            m.syncer.restore_state(checkpoint)

        def transport(mm=m):
            if not mm.alive:
                raise ConnectionError(f"active {mm.id} down")
            return mm.syncer

        m.standby_store = InMemorySessionStore()
        m.standby = StandbySyncer(m.standby_store, transport)
        if checkpoint is not None:
            m.standby.bootstrap_state(checkpoint)
        m.failover = FailoverController(
            role=Role.STANDBY, failover_delay_s=self.ha_failover_delay_s,
            auto_failback=False,
            on_role_change=lambda role, iid=m.id: self._on_role_change(
                iid, role))
        # with a fabric, liveness comes from the detector (beats over
        # the transport), not the parent-side flag alone: a SIGKILL'd
        # process member stops beating, the detector demotes it, and
        # THIS probe goes false — no pipe heartbeat on the probe path.
        # `mm.alive` stays in the conjunction as the chaos kill verb.
        m.monitor = HealthMonitor(
            probe=lambda mm=m: mm.alive and self._fabric_probe(mm.id),
            interval_s=self.ha_probe_interval_s,
            failure_threshold=self.ha_failure_threshold,
            on_event=m.failover.handle_health_event)
        m.standby.tick(self.clock())

    def _fabric_probe(self, instance_id: str) -> bool:
        if self.fabric_detector is None:
            return True  # inline pipe-oracle mode: the flag decides
        return self.fabric_detector.probe(instance_id)

    def _relay_sessions(self, m: _Member, now: float) -> None:
        """Worker lease events -> SessionStates -> ActiveSyncer push:
        the parent-side single-writer replay, same discipline as the
        fleet's table-event relay."""
        if m.syncer is None or m.instance is None:
            return
        events = m.instance.drain_session_events()
        for op, payload in m.instance.session_states(events, now):
            if op == "put":
                m.syncer.push_change(payload)
            else:
                m.syncer.push_change(None, session_id=payload)

    def _on_role_change(self, instance_id: str, role: Role) -> None:
        if role == Role.ACTIVE:
            self._promote(instance_id)

    def _promote(self, instance_id: str) -> None:
        """Standby takes over the member slot: fresh stack on the same
        carve, lease books hydrated from the replicated sessions, HA
        pair re-wired with the promoted side as the new active."""
        m = self.members[instance_id]
        if m.standby is None or m.spec is None:
            return
        m.standby.disconnect()
        ckpt = m.standby.checkpoint_state()
        sessions = m.standby_store.all()
        promoted = self._build_instance(m.spec)
        if isinstance(promoted, InlineInstance):
            promoted.hydrate_sessions(sessions, now=self.clock())
        if m.instance is not None:
            m.instance.close()
        m.instance = promoted
        m.alive = True
        m.role = "promoted"
        self.failovers += 1
        if m.remote:
            # the slot moved hosts: it now serves LOCALLY on the
            # survivor, so the detector must stop expecting beats from
            # the dead box (a reset would re-demote the promoted slot)
            m.remote = False
            m.serving_remote = False
            m.handoff_xid = ""
            if self.fabric_detector is not None:
                self.fabric_detector.forget(m.id)
        elif self.fabric_detector is not None:
            # the slot is a new process with fresh counters: wipe the
            # old view AND the transport's replay floor, or the new
            # child's seq=1 beats all read as replays of the dead one
            self.fabric_detector.reset(m.id, now=self.clock())
        if self.fabric_detector is not None:
            reset_peer = getattr(self.fabric_transport, "reset_peer", None)
            if reset_peer is not None:
                reset_peer(m.id)
        self._wire_ha(m, checkpoint=ckpt)

    def kill_instance(self, instance_id: str) -> None:
        """Chaos verb: the instance stops answering (books frozen, the
        real crash shape). Health probes see it; failover owns
        recovery."""
        self.members[instance_id].alive = False

    # -- fabric verdicts --------------------------------------------------
    def _on_fabric_verdict(self, peer_id: str, state: str) -> None:
        """Detector transition: record it, flight-record it. Demotion
        itself flows through the probe path — the HealthMonitor /
        FailoverController machinery owns failover, same as ever."""
        self.fabric_events.append((peer_id, state))
        del self.fabric_events[:-64]
        tele.trigger(TRIG_MEMBER_SUSPECT, f"{peer_id} -> {state}")

    def _on_fabric_message(self, msg) -> None:
        """Non-beat fabric traffic. `join`: a member on another host
        announces itself — it enters the carve as a remote member (a
        `serving` joiner additionally gets the handoff stream and a
        RemoteInstance front). Handoff acks and remote-serving replies
        route to their owners; a re-sent join (the member's backoff
        retrying into an already-registered slot) is idempotent."""
        if msg.kind == "join":
            iid = str(msg.body.get("instance_id", ""))
            if not iid:
                return
            m = self.members.get(iid)
            if m is None:
                self.add_remote_instance(
                    iid, host=str(msg.body.get("host", "")),
                    serving=bool(msg.body.get("serving", False)))
                return
            if not m.remote:
                return  # a local member's id: not joinable from outside
            # a pre-declared slot (co-carved at founding) comes alive —
            # or a registered joiner's backoff re-sent the announce
            if bool(msg.body.get("serving", False)):
                m.serving_remote = True
            if self.fabric_detector is not None \
                    and iid not in self.fabric_detector.views:
                self.fabric_detector.watch(iid, now=self.clock())
            if (m.serving_remote and self.handoff is not None
                    and self.plan is not None
                    and iid in self.plan.members
                    and self.plan.members[iid].blocks
                    and m.hydrated_epoch < self.plan.epoch):
                self._start_handoff(m)
            return
        if self.handoff is not None and self.handoff.handle(msg):
            return
        if msg.kind in ("rbatch_reply", "rexpire_reply"):
            m = self.members.get(msg.src)
            if m is not None and m.instance is not None \
                    and hasattr(m.instance, "deliver"):
                m.instance.deliver(msg.body)

    def tick(self, now: float | None = None) -> None:
        """Drive the fabric detector, standby reconnects, health probes
        and failover state machines (all tick(now)-based,
        SimClock-compatible)."""
        now = now if now is not None else self.clock()
        if self.fabric_detector is not None:
            self.fabric_detector.tick(now)
        if self.handoff is not None:
            self.handoff.pump(now)
            self._adopt_hydrated_remotes()
        self._check_host_loss()
        for _iid, m in sorted(self.members.items()):
            if m.standby is not None:
                m.standby.tick(now)
            if m.monitor is not None:
                m.monitor.tick(now)
            if m.failover is not None:
                m.failover.tick(now)

    def _adopt_hydrated_remotes(self) -> None:
        """A serving joiner whose carve handoff the receiver fully
        acked becomes a steering target: front it with a
        RemoteInstance and wire its HA pair on THIS host (the
        surviving-host half that host-loss promotion hydrates from)."""
        from .member import RemoteInstance

        for iid, m in sorted(self.members.items()):
            if not (m.remote and m.serving_remote and m.handoff_xid
                    and m.instance is None):
                continue
            sender = self.handoff.senders.get((iid, m.handoff_xid))
            if sender is None or not sender.done:
                continue
            m.instance = RemoteInstance(
                self.fabric_transport, iid, m.spec, clock=self.clock,
                pump=self._remote_pump)
            m.alive = True
            if self.ha:
                self._wire_ha(m)

    def _check_host_loss(self) -> None:
        """The plan's host axis driving failure handling: when EVERY
        fabric-watched remote member on a host is DOWN by accusation
        quorum, the box is gone — promote the surviving-host HA halves
        as a group (no per-member failover-delay stagger; their state
        is already here)."""
        if self.fabric_detector is None:
            return
        by_host: dict[str, list] = {}
        for iid, m in sorted(self.members.items()):
            if m.remote and m.host and iid in self.fabric_detector.views:
                by_host.setdefault(m.host, []).append(m)
        for host, group in sorted(by_host.items()):
            if host in self._lost_hosts:
                continue
            if not all(self.fabric_detector.views[m.id].state == "down"
                       for m in group):
                continue
            self._lost_hosts.add(host)
            self.host_losses += 1
            tele.trigger(TRIG_HOST_LOSS,
                         f"host {host} lost: "
                         f"{[m.id for m in group]} down by quorum")
            for m in group:
                m.alive = False
                if m.standby is not None and m.spec is not None:
                    self._promote(m.id)
            if self.on_host_loss is not None:
                self.on_host_loss(host, [m.id for m in group])

    # -- the front door ---------------------------------------------------
    def member_ids(self) -> tuple:
        if self.plan is not None:
            return self.plan.serving_ids()
        return tuple(sorted(self.members))

    def handle_batch(self, items: list, now: float | None = None) -> list:
        """[(lane, frame)] -> [(lane, reply)] in lane order: steer each
        frame to its member by source MAC, serve per member, relay
        session events, re-merge."""
        now = now if now is not None else self.clock()
        ids = self.member_ids()
        groups: dict[str, list] = {}
        results: list = []
        for item in items:
            lane, frame = item[0], item[1]
            if len(frame) < 12 or not ids:
                self.shed_frames += 1
                results.append((lane, None))
                continue
            iid = instance_for_mac(frame[6:12], ids)
            groups.setdefault(iid, []).append((lane, frame))
        for iid in sorted(groups):
            m = self.members.get(iid)
            if m is None or m.instance is None or not m.alive:
                self.shed_frames += len(groups[iid])
                results.extend((lane, None) for lane, _f in groups[iid])
                continue
            self.steered[iid] = self.steered.get(iid, 0) + len(groups[iid])
            results.extend(m.instance.handle_batch(groups[iid], now))
            self._relay_sessions(m, now)
        results.sort(key=lambda r: r[0])
        return results

    def expire(self, now: int, max_reaps: int | None = None) -> int:
        total = 0
        for _iid, m in sorted(self.members.items()):
            if m.instance is not None and m.alive:
                total += m.instance.expire(now, max_reaps)
                self._relay_sessions(m, float(now))
        return total

    # -- checkpoint interop (runtime/checkpoint.py 'cluster_plan') --------
    def checkpoint_plan(self) -> dict:
        if self.plan is None:
            return {}
        return self.plan.to_dict()

    @staticmethod
    def parse_plan(state: dict) -> int:
        """Dry-parse (restore pre-check): raises on a corrupt plan,
        touches nothing. Returns the member count."""
        if not state:
            return 0
        return len(ClusterPlan.from_dict(state).members)

    def restore_plan(self, state: dict) -> int:
        """Resume a checkpointed carve: the plan document goes back
        through the store so every watcher applies it — restore is just
        a replayed carve."""
        if not state:
            return 0
        incoming = ClusterPlan.from_dict(state)
        self.store.put(_PLAN_KEY, json.dumps(incoming.to_dict(),
                                             sort_keys=True).encode())
        return len(incoming.members)

    # -- introspection ----------------------------------------------------
    def status(self) -> dict:
        members = {}
        for iid, m in sorted(self.members.items()):
            entry: dict = {"alive": m.alive, "role": m.role,
                           "pending": m.pending, "remote": m.remote,
                           "serving_remote": m.serving_remote,
                           "host": m.host,
                           "steered": self.steered.get(iid, 0)}
            if m.instance is not None:
                entry.update(m.instance.status())
            if m.syncer is not None:
                entry["ha"] = {
                    "active_sessions": len(m.store),
                    "standby_sessions": len(m.standby_store),
                    "standby_connected": bool(m.standby.connected),
                    "failover_state": m.failover.state.value,
                }
            members[iid] = entry
        out = {
            "mode": self.mode,
            "instances": len(self.members),
            "members": members,
            "recarves": self.recarves,
            "failovers": self.failovers,
            "refused_removes": self.refused_removes,
            "shed_frames": self.shed_frames,
            "host_losses": self.host_losses,
            "lost_hosts": sorted(self._lost_hosts),
        }
        if self.plan is not None:
            out["plan"] = {
                "epoch": self.plan.epoch,
                "blocks": self.plan.n_blocks,
                "free_blocks": len(self.plan.free),
                "addresses": self.plan.total_addresses(),
                "n_hosts": self.plan.n_hosts,
                "members": {iid: p.addresses()
                            for iid, p in sorted(self.plan.members.items())},
            }
        if self.fabric_detector is not None:
            out["fabric"] = self.fabric_detector.status()
            out["fabric"]["transport"] = dict(self.fabric_transport.stats)
            if self.handoff is not None:
                out["fabric"]["handoff"] = self.handoff.stats()
        return out

    def close(self) -> None:
        self._cancel_members()
        self._cancel_plan()
        if self.fabric_transport is not None:
            self.fabric_transport.close()
        for m in self.members.values():
            if m.instance is not None:
                m.instance.close()
