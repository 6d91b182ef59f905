"""One cluster member: a carved slice of the address space served by an
inline slow-path fleet, with session events drained for HA replication.

`InstanceSpec` is picklable (the `FleetSpec` mold) so process mode can
ship it to a child; `InlineInstance` is the in-process build both modes
share — process mode runs one inside the child and speaks a small pipe
verb protocol (`_instance_child`).

The HA seam: the fleet's `lease_hook` funnels worker lease events into
`_session_events`; the coordinator drains them after every batch and
pushes `SessionState`s through the instance's `ActiveSyncer` — the same
single-writer replay discipline as the fleet's TableEventLog, which is
what lets replication work identically for inline and process members.
Promotion is the reverse seam: `hydrate_sessions` rebuilds lease books
from replicated `SessionState`s via `SlowPathFleet.restore_state`, so a
promoted standby answers renewals with the original addresses.

A copy of `bng_tpu/cluster/instance.py` with its imports renamed.
"""

from __future__ import annotations

import multiprocessing as mp
from dataclasses import dataclass, field
from typing import Callable

from bng_tpu_torch.control.admission import AdmissionConfig
from bng_tpu_torch.control.fleet import FleetSpec, FleetPoolSpec, SlowPathFleet
from bng_tpu_torch.control.ha import SessionState
from bng_tpu_torch.control.pool import Pool, PoolManager

from .plan import CarvedBlock, InstancePlan


@dataclass
class InstanceSpec:
    """Everything needed to build (or rebuild) one member's stack —
    picklable, like `FleetSpec`."""

    instance_id: str
    server_mac: bytes
    server_ip: int
    blocks: list = field(default_factory=list)      # [(network, prefix_len, pool_id)]
    nat_ranges: list = field(default_factory=list)  # [(start_ip, count)]
    n_workers: int = 1
    slice_size: int = 256
    inbox_capacity: int = 4096
    lease_time: int = 3600
    dns_primary: int = 0
    sub_nbuckets: int = 0  # >0 builds FastPathTables as the table sink
    # control fabric: when set, a process child beats its
    # serving-health word to this coordinator address over the UDP
    # fabric — the probe path the pipe heartbeat used to simulate
    fabric_addr: tuple = ()
    fabric_psk: str = ""
    beat_interval_s: float = 0.5

    @classmethod
    def from_plan(cls, iplan: InstancePlan, cluster_plan, *, server_mac: bytes,
                  server_ip: int, **kw) -> "InstanceSpec":
        return cls(
            instance_id=iplan.instance_id,
            server_mac=server_mac, server_ip=server_ip,
            blocks=[(b.network, b.prefix_len, b.pool_id)
                    for b in iplan.blocks],
            nat_ranges=[cluster_plan.nat_range(b) for b in iplan.blocks
                        if cluster_plan.nat_total > 0],
            **kw)


def _build_pools(spec: InstanceSpec):
    fastpath = None
    if spec.sub_nbuckets > 0:
        from bng_tpu_torch.runtime.tables import FastPathTables

        fastpath = FastPathTables(sub_nbuckets=spec.sub_nbuckets,
                                  vlan_nbuckets=64, cid_nbuckets=64,
                                  max_pools=max(16, len(spec.blocks) + 1))
        fastpath.set_server_config(spec.server_mac, spec.server_ip)
    pools = PoolManager(fastpath)
    for network, prefix_len, pool_id in spec.blocks:
        pools.add_pool(Pool(pool_id=pool_id, network=network,
                            prefix_len=prefix_len, gateway=spec.server_ip,
                            dns_primary=spec.dns_primary,
                            lease_time=spec.lease_time))
    return pools, fastpath


class InlineInstance:
    """One member: carved pools + inline fleet + session-event drain."""

    def __init__(self, spec: InstanceSpec, clock: Callable[[], float]):
        if not spec.blocks:
            raise ValueError(
                f"instance {spec.instance_id}: empty carve (no blocks)")
        self.spec = spec
        self.clock = clock
        self._session_events: list = []
        self.pools, self.fastpath = _build_pools(spec)
        self.fleet = self._build_fleet(self.pools, self.fastpath)
        self.batches = 0
        self.replies = 0

    def _build_fleet(self, pools, fastpath) -> SlowPathFleet:
        fspec = FleetSpec(
            server_mac=self.spec.server_mac, server_ip=self.spec.server_ip,
            pools=[FleetPoolSpec(pool_id=p.pool_id, network=p.network,
                                 prefix_len=p.prefix_len, gateway=p.gateway,
                                 dns_primary=p.dns_primary,
                                 dns_secondary=p.dns_secondary,
                                 lease_time=p.lease_time,
                                 client_class=p.client_class)
                   for p in pools.pools.values()],
            slice_size=self.spec.slice_size,
            low_watermark=max(1, self.spec.slice_size // 4))
        return SlowPathFleet(
            fspec, self.spec.n_workers, pools, mode="inline",
            table_sink=fastpath, clock=self.clock,
            admission=AdmissionConfig(inbox_capacity=self.spec.inbox_capacity),
            lease_hook=self._on_lease_event)

    # -- HA seam ----------------------------------------------------------
    def _on_lease_event(self, event: str, lease: dict, sid: str) -> None:
        self._session_events.append((event, lease, sid))

    def drain_session_events(self) -> list:
        out, self._session_events = self._session_events, []
        return out

    def session_states(self, events: list, now: float) -> list:
        """Lease events -> (op, SessionState|session_id) replication
        records (the cli `_ha_lease` closure shape, minus NAT which the
        carve plan owns cluster-side)."""
        out = []
        for event, lease, sid in events:
            if event == "stop":
                out.append(("delete", sid))
            else:
                out.append(("put", SessionState(
                    session_id=sid, mac=lease["mac"], ip=lease["ip"],
                    pool_id=lease["pool_id"],
                    username=lease.get("username") or "",
                    lease_expiry=float(lease["expiry"]),
                    qos_policy=lease.get("qos_policy") or "",
                    session_kind="ipoe", updated_at=now)))
        return out

    # -- serving ----------------------------------------------------------
    def handle_batch(self, items: list, now: float | None = None) -> list:
        self.batches += 1
        out = self.fleet.handle_batch(items, now)
        self.replies += sum(1 for _lane, rep in out if rep is not None)
        return out

    def expire(self, now: int, max_reaps: int | None = None) -> int:
        return self.fleet.expire(now, max_reaps)

    # -- promotion / carve changes ----------------------------------------
    def hydrate_sessions(self, sessions: list, now: float) -> int:
        """Rebuild lease books from replicated SessionStates (standby
        promotion). Routed through `SlowPathFleet.restore_state` so the
        re-shard, parent-pool claims and table rebuild all follow the
        checkpoint-restore discipline."""
        leases = []
        for s in sessions:
            if not s.mac or not s.ip:
                continue
            leases.append({"mac": s.mac, "ip": s.ip, "pool_id": s.pool_id,
                           "expiry": s.lease_expiry,
                           "session_id": s.session_id,
                           "username": s.username,
                           "qos_policy": s.qos_policy})
        state = {"workers": [{"worker_id": 0, "session_seq": len(leases),
                              "leases": leases, "offers": []}]}
        return self.fleet.restore_state(state)

    def apply_plan(self, iplan: InstancePlan) -> bool:
        """Adopt a re-carve. Added blocks rebuild the fleet through
        export/restore (the resize transfer discipline: leases survive,
        the new blocks arrive whole). A block may only LEAVE once it
        holds no leases — half-drained shrink is refused."""
        want = [(b.network, b.prefix_len, b.pool_id) for b in iplan.blocks]
        if want == self.spec.blocks:
            return True
        removed = [b for b in self.spec.blocks if b not in want]
        if removed:
            held = {lease.ip for _w, book in _books(self.fleet)
                    for lease in book.values()}
            for network, prefix_len, pool_id in removed:
                blk = CarvedBlock(network=network, prefix_len=prefix_len,
                                  index=pool_id - 1)
                if any(blk.contains(ip) for ip in held):
                    return False  # not drained — keep serving the old carve
        state = self.fleet.export_state()
        self.spec.blocks = want
        self.pools, self.fastpath = _build_pools(self.spec)
        self.fleet = self._build_fleet(self.pools, self.fastpath)
        self.fleet.restore_state(state)
        return True

    # -- introspection ----------------------------------------------------
    def lease_count(self) -> int:
        return sum(len(book) for _w, book in _books(self.fleet))

    def export_state(self) -> dict:
        return self.fleet.export_state()

    def status(self) -> dict:
        return {
            "instance_id": self.spec.instance_id,
            "blocks": list(self.spec.blocks),
            "addresses": sum(1 << (32 - pl) for _n, pl, _p in self.spec.blocks),
            "nat_ranges": list(self.spec.nat_ranges),
            "workers": self.spec.n_workers,
            "leases": self.lease_count(),
            "batches": self.batches,
            "replies": self.replies,
        }

    def close(self) -> None:
        self.fleet.close()


def _books(fleet: SlowPathFleet):
    """[(worker_id, {mac_u64: Lease})] of the instance's inline fleet: the
    inline branch of the audit's `_fleet_worker_books`, read here so a
    process child never imports the audit module (which imports torch)."""
    return [(w, dict(worker.server.leases)) for w, worker in enumerate(fleet._inline)]


# ---------------------------------------------------------------------------
# process mode: the fleet.py child mold
# ---------------------------------------------------------------------------

def _beat_loop(spec: InstanceSpec, inst: InlineInstance, stop) -> None:
    """Child-side heartbeat: one signed UDP datagram per interval to
    the coordinator, carrying the serving-health word (`work` = batches
    accepted, `served` = replies produced). A SIGKILL takes this thread
    with the process — the beats just stop, which IS the failure signal
    the coordinator's detector consumes."""
    from bng_tpu_torch.control.deviceauth import PSKAuthenticator

    from .fabric import UDPTransport

    ep = UDPTransport(spec.instance_id,
                      PSKAuthenticator(psk=spec.fabric_psk))
    ep.add_peer("coordinator", spec.fabric_addr)
    try:
        while not stop.wait(spec.beat_interval_s):
            ep.send("coordinator", "beat",
                    {"served": inst.replies, "work": inst.batches,
                     "accuse": []})
    finally:
        ep.close()


def _instance_child(spec: InstanceSpec, conn) -> None:
    """Child loop: verbs in, results out. The clock is wall time in the
    child — process mode is the real-serving lane, not the deterministic
    test lane."""
    import threading
    import time

    inst = InlineInstance(spec, clock=time.time)
    stop_beats = threading.Event()
    if spec.fabric_addr:
        threading.Thread(target=_beat_loop, args=(spec, inst, stop_beats),
                         daemon=True).start()
    try:
        while True:
            msg = conn.recv()
            verb = msg[0]
            if verb == "batch":
                _verb, items, now = msg
                out = inst.handle_batch(items, now)
                conn.send(("result", out, inst.drain_session_events()))
            elif verb == "expire":
                _verb, now, max_reaps = msg
                conn.send(("expired", inst.expire(now, max_reaps),
                           inst.drain_session_events()))
            elif verb == "status":
                conn.send(("status", inst.status()))
            elif verb == "export":
                conn.send(("state", inst.export_state()))
            elif verb == "stop":
                stop_beats.set()
                conn.send(("bye",))
                return
    except (EOFError, KeyboardInterrupt):
        stop_beats.set()
        return


class ProcessInstance:
    """Parent-side handle for a child-process member. Same surface as
    `InlineInstance` for the verbs the coordinator uses; session events
    ride back on each reply (the fleet's table-event relay discipline
    across the pipe)."""

    def __init__(self, spec: InstanceSpec, start_method: str | None = None):
        self.spec = spec
        ctx = mp.get_context(start_method or "spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_instance_child, args=(spec, child),
                                 daemon=True)
        self._proc.start()
        child.close()
        self._session_events: list = []
        self.batches = 0

    @property
    def pid(self) -> int | None:
        return self._proc.pid

    def _gather(self, want: str):
        tag, *rest = self._conn.recv()
        if tag != want:
            raise OSError(f"instance {self.spec.instance_id}: expected "
                          f"{want!r}, got {tag!r}")
        return rest

    def handle_batch(self, items: list, now: float | None = None) -> list:
        self.batches += 1
        self._conn.send(("batch", items, now))
        out, events = self._gather("result")
        self._session_events.extend(events)
        return out

    def expire(self, now: int, max_reaps: int | None = None) -> int:
        self._conn.send(("expire", now, max_reaps))
        n, events = self._gather("expired")
        self._session_events.extend(events)
        return n

    def drain_session_events(self) -> list:
        out, self._session_events = self._session_events, []
        return out

    def session_states(self, events: list, now: float) -> list:
        return InlineInstance.session_states(self, events, now)

    def status(self) -> dict:
        self._conn.send(("status",))
        return self._gather("status")[0]

    def export_state(self) -> dict:
        self._conn.send(("export",))
        return self._gather("state")[0]

    def lease_count(self) -> int:
        return int(self.status()["leases"])

    def close(self) -> None:
        try:
            self._conn.send(("stop",))
            self._gather("bye")
        except (OSError, EOFError, ValueError):
            pass
        self._proc.join(timeout=5)
        if self._proc.is_alive():
            self._proc.terminate()
