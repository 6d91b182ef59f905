"""Blue/green engine swap with delta replay (port of `bng_tpu/runtime/ops.py`).

1. **snapshot**: at the quiesce barrier (the scheduler's or the engine's;
   nothing in flight, device-written words folded back) an in-memory
   checkpoint of every engine-owned host mirror goes through the codec
   (`roundtrip_checkpoint`), so a snapshot that could never restore
   aborts the swap here (chaos point `ops.snapshot`, io_error).

2. **hydrate**: geometry-identical empty mirrors (`clone_mirrors`) take
   the snapshot through the verify-then-hydrate gate and are uploaded by
   a hydrator engine; the standby engine shares the live host managers
   and adopts that device chain with no upload of its own
   (`Engine(..., device_tables=...)`), and with the dense config arrays
   that chain holds as its last shipped ones.

3. **delta replay** (`replay_delta_since`): the live mirrors kept moving
   while the standby hydrated. Every sparse mirror is diffed against the
   snapshot arrays, exactly the changed slots are marked dirty, and they
   ship through the bounded update drain (`engine.process([])`, one full
   fused step of empty lanes per drain); a bulk build falls back to one
   full upload. Steps run only while a slot is dirty, as the reference's
   do: a dense config change since the snapshot with no dirty slot
   reaches the standby at the next drain after the flip, and the audit
   before the flip finds it.

4. **audit, then flip or roll back**: the standby must pass the invariant
   audit before it serves. The flip re-points the composition root and
   the scheduler (`adopt_engine` rebuilds its replica, express graph and
   ring program). On any failure (an audit violation, chaos point
   `ops.swap`, any exception) the standby is dropped and, once the
   replay has consumed dirty marks, the active engine heals with one
   `resync_tables` upload.

`sharded_blue_green_swap` does the same for a `ShardedCluster`: a
standby from `clone_empty()` hydrated through the sharded restore,
audited, and flipped, or dropped with the active cluster untouched.
The standby engine is built without the edge stage, as the reference's
is: the snapshot leaves the tap and route tables out, and they leave
the dataplane at the flip.
"""

from __future__ import annotations

import time

import numpy as np

from bng_tpu_torch.chaos import invariants
from bng_tpu_torch.chaos.faults import FaultInjectedError, fault_point
from bng_tpu_torch.runtime.checkpoint import (CheckpointError, build_checkpoint,
                                              restore_checkpoint, roundtrip_checkpoint)
from bng_tpu_torch.telemetry import spans as tele
from bng_tpu_torch.utils.structlog import get_logger

_log = get_logger("ops.swap")

# bounded drain passes for the delta replay: update_slots per table per
# step, so this covers update_slots * max steps changed rows before the
# resync fallback takes over
MAX_REPLAY_STEPS = 256


def clone_mirrors(engine) -> dict:
    """Fresh, EMPTY host-mirror objects geometry-identical to the
    engine's — the hydration targets for the standby's device chain.
    Only components the engine actually has are cloned (restore rejects
    a component with no target, and rightly so)."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.runtime.engine import AntispoofTables, GardenTables, QoSTables
    from bng_tpu_torch.runtime.tables import FastPathTables, PPPoEFastPathTables

    fp = engine.fastpath
    nat = engine.nat
    out = {
        "fastpath": FastPathTables(
            sub_nbuckets=fp.sub.nbuckets, vlan_nbuckets=fp.vlan.nbuckets,
            cid_nbuckets=fp.cid.nbuckets, max_pools=len(fp.pools),
            stash=fp.sub.stash, update_slots=fp.update_slots),
        "nat": NATManager(
            public_ips=list(nat.public_ips),
            ports_per_subscriber=nat.ports_per_subscriber,
            port_range=tuple(nat.port_range), flags=nat.flags,
            sessions_nbuckets=nat.sessions.nbuckets,
            sub_nat_nbuckets=nat.sub_nat.nbuckets,
            stash=nat.sessions.stash, update_slots=nat.update_slots),
        "qos": QoSTables(nbuckets=engine.qos.up.nbuckets,
                         update_slots=engine.qos.update_slots),
        "antispoof": AntispoofTables(
            nbuckets=engine.antispoof.bindings.nbuckets,
            stash=engine.antispoof.bindings.stash,
            update_slots=engine.antispoof.update_slots),
    }
    if engine.garden is not None:
        out["garden"] = GardenTables(
            nbuckets=engine.garden.subscribers.nbuckets,
            stash=engine.garden.subscribers.stash,
            update_slots=engine.garden.update_slots,
            max_allowed=engine.garden.allowed.shape[0])
    if engine.pppoe is not None:
        out["pppoe"] = PPPoEFastPathTables(
            nbuckets=engine.pppoe.by_sid.nbuckets,
            stash=engine.pppoe.by_sid.stash,
            update_slots=engine.pppoe.update_slots)
    return out


def _changed_slots(table, arrays: dict, name: str) -> np.ndarray:
    """Slot indexes whose host row differs from the snapshot arrays.
    A table absent from the snapshot (shouldn't happen — the snapshot
    came from the same engine) degrades to every occupied slot."""
    if hasattr(table, "keys"):  # HostTable
        snap_k = arrays.get(f"{name}.keys")
        snap_v = arrays.get(f"{name}.vals")
        snap_u = arrays.get(f"{name}.used")
        if snap_k is None or snap_v is None or snap_u is None:
            return np.nonzero(table.used)[0]
        changed = ((table.keys != snap_k).any(axis=1)
                   | (table.vals != snap_v).any(axis=1)
                   | (table.used != snap_u))
        return np.nonzero(changed)[0]
    # HostQTable: one packed row array
    snap_r = arrays.get(f"{name}.rows")
    if snap_r is None:
        return np.nonzero(table.rows.any(axis=1))[0]
    return np.nonzero((table.rows != snap_r).any(axis=1))[0]


def replay_delta_since(engine, arrays: dict,
                       max_steps: int = MAX_REPLAY_STEPS) -> dict:
    """Ship every host-mirror row that changed since `arrays` (a
    checkpoint's array dict) to the engine's device chain through the
    normal bounded update drain. The engine's chain is assumed to be AT
    the snapshot state (adopt_device_tables); after this it is current.

    Returns {"rows": slots re-shipped, "steps": empty drain steps run,
    "resync": whether a bulk-sized delta forced one full upload}.
    """
    rows = 0
    resync = False
    for name, table in engine.host_mirror_tables().items():
        if table._dirty_all:
            resync = True
            continue
        rows += table.mark_dirty(_changed_slots(table, arrays, name))
    if resync:
        # a bulk build happened during hydration: bounded deltas can't
        # express it — one full upload, the same path a cold start takes
        engine.resync_tables()
        return {"rows": rows, "steps": 0, "resync": True}
    steps = 0
    # the reference's loop: steps run only while a slot is dirty, so a
    # dense config array changed since the snapshot with no dirty slot
    # stays at the snapshot's words (the audit then finds it)
    while engine.pending_dirty() > 0 and steps < max_steps:
        # an empty batch runs the full update drain and nothing else —
        # the cheapest way to ship deltas without a second drain path
        engine.process([])
        steps += 1
    if engine.pending_dirty() > 0:
        raise CheckpointError(
            f"delta replay did not converge in {max_steps} steps "
            f"({engine.pending_dirty()} slots still dirty)")
    return {"rows": rows, "steps": steps, "resync": False}


def blue_green_swap(components, *, metrics=None, node_id: str = "bluegreen") -> dict:
    """Hydrate a standby engine from an in-memory snapshot, replay the
    delta, audit, and flip — or roll back with the active untouched.

    `components` is the composition root's dict: needs "engine"; uses
    "scheduler", "pools", "dhcp" when present. On success
    components["engine"] IS the standby. Callers serialize against the
    dataplane loop; the flip itself is one dict store + one scheduler
    re-point at the quiesce barrier. The report carries frames_deferred,
    the quiesce_s / hydrate_s / audit_s / flip_s / duration_s split,
    restored_rows, delta_rows / delta_steps / delta_resync, audit_ok and
    violations (the reference's fields, plus audit_s). With `metrics`
    (BNGMetrics), the report feeds the bng_ops_* families.
    """
    from bng_tpu_torch.runtime.engine import Engine

    eng = components["engine"]
    sched = components.get("scheduler")
    report: dict = {"op": "engine_swap", "outcome": "failed"}
    t_all = time.perf_counter()
    consumed_delta = False
    try:
        # 1. quiesce + in-memory snapshot (codec round-trip verified)
        t0 = tele.t()
        t_q = time.perf_counter()
        deferred = sched.quiesce() if sched is not None else eng.quiesce()
        eng.fold_device_authoritative()
        report["frames_deferred"] = deferred
        ckpt = build_checkpoint(
            0, eng.clock(), fastpath=eng.fastpath, nat=eng.nat, qos=eng.qos,
            antispoof=eng.antispoof, garden=eng.garden, pppoe=eng.pppoe,
            node_id=node_id)
        ckpt = roundtrip_checkpoint(ckpt)  # ops.snapshot chaos point
        report["quiesce_s"] = time.perf_counter() - t_q
        tele.lap(tele.OPS, t0)

        # 2. standby hydration: clone mirrors -> verified restore ->
        # device upload; the standby engine shares the LIVE host
        # managers (they stay the single-writer authority) and adopts
        # the snapshot-built device chain in place of its init upload.
        t0 = tele.t()
        t_h = time.perf_counter()
        tmp = clone_mirrors(eng)
        report["restored_rows"] = restore_checkpoint(ckpt, **tmp)
        hydrator = Engine(
            tmp["fastpath"], tmp["nat"], qos=tmp["qos"],
            antispoof=tmp["antispoof"], garden=tmp.get("garden"),
            pppoe=tmp.get("pppoe"), batch_size=eng.B, pkt_slot=eng.L,
            clock=eng.clock, device=eng.device)
        # the standby is built without the edge stage, as the
        # reference's is: taps and routes leave the dataplane at the flip
        standby = Engine(
            eng.fastpath, eng.nat, qos=eng.qos, antispoof=eng.antispoof,
            garden=eng.garden, pppoe=eng.pppoe, batch_size=eng.B,
            pkt_slot=eng.L, slow_path=eng.slow_path,
            violation_sink=eng.violation_sink, clock=eng.clock,
            device=eng.device, device_tables=hydrator.tables)
        standby.slow_path_batch = eng.slow_path_batch
        standby.stats = eng.stats  # operational counters never reset
        report["hydrate_s"] = time.perf_counter() - t_h
        tele.lap(tele.OPS, t0)

        # 3. delta replay at the barrier: host mirrors moved while the
        # standby hydrated; ship exactly the changed slots
        t0 = tele.t()
        consumed_delta = True
        delta = replay_delta_since(standby, ckpt.arrays)
        report["delta_rows"] = delta["rows"]
        report["delta_steps"] = delta["steps"]
        report["delta_resync"] = delta["resync"]
        tele.lap(tele.OPS, t0)

        # 4. chaos flip barrier + audit — the steady-state hypothesis
        fp = fault_point("ops.swap")
        if fp is not None and fp.kind == "fail":
            raise FaultInjectedError("chaos: injected crash mid-swap")
        t0 = tele.t()
        t_a = time.perf_counter()
        audit_rep = invariants.audit_invariants(
            engine=standby, pools=components.get("pools"),
            dhcp=components.get("dhcp"), nat=eng.nat, check_roundtrip=False)
        report["audit_ok"] = audit_rep.ok
        report["violations"] = audit_rep.violations_by_kind()
        report["audit_s"] = time.perf_counter() - t_a
        tele.lap(tele.OPS, t0)
        if not audit_rep.ok:
            raise CheckpointError(
                f"standby failed the invariant audit: "
                f"{audit_rep.violations_by_kind()}")

        # 5. the flip: one reference store + scheduler re-point
        t0 = tele.t()
        t_f = time.perf_counter()
        components["engine"] = standby
        if sched is not None:
            sched.adopt_engine(standby)
        report["flip_s"] = time.perf_counter() - t_f
        tele.lap(tele.OPS, t0)
        report["outcome"] = "ok"
    except Exception as e:  # noqa: BLE001 — ANY failure must run the heal
        # rollback: the active engine keeps serving. If the replay/audit
        # already consumed dirty marks into the (now discarded) standby
        # chain, re-sync the ACTIVE chain from the host mirrors — the
        # same full-upload heal a bulk build uses — so no delta is lost.
        # Catching only the expected types would leave the active device
        # chain silently missing those rows on an unexpected one (a
        # device failure surfaces as a plain RuntimeError).
        report["outcome"] = "rolled_back" if consumed_delta else "failed"
        report["error"] = f"{type(e).__name__}: {e}"[:300]
        _log.error("engine swap did not flip", outcome=report["outcome"],
                   error=report["error"], healed=consumed_delta)
        if consumed_delta:
            eng.resync_tables()
    report["duration_s"] = time.perf_counter() - t_all
    if metrics is not None:
        metrics.record_transition(report)
    return report


def sharded_blue_green_swap(components, *, metrics=None, node_id: str = "bluegreen",
                            clock=time.time) -> dict:
    """Blue/green swap for the sharded serving path: hydrate a STANDBY
    ShardedCluster from an in-memory sharded snapshot
    and flip the composition root's cluster reference — or discard the
    standby with the active cluster untouched.

    Differences from the engine swap that make this one simpler, not
    weaker: callers hold the app's control lock for the whole
    transition (the sharded drive loop cannot run concurrently), so the
    host authorities cannot move between snapshot and flip — no delta
    replay pass is needed; and the standby is an empty geometry clone
    (`clone_empty`), hydrated and uploaded once. The same failure surfaces stay
    armed: the snapshot round-trips through the versioned codec
    (`ops.snapshot` io_error), the restore runs the full
    all-verified-then-hydrate gate, the cross-authority sharded audit
    must pass BEFORE the flip, and the `ops.swap` chaos point crashes
    at the flip barrier — any failure leaves the ACTIVE cluster
    serving (it was never mutated)."""
    from bng_tpu_torch.runtime.checkpoint import (build_sharded_checkpoint,
                                                  restore_sharded_checkpoint)

    cl = components["cluster"]
    report: dict = {"op": "sharded_swap", "outcome": "failed",
                    "shards": cl.n}
    t_all = time.perf_counter()
    try:
        # 1. quiesce + in-memory snapshot, codec round-trip verified
        t0 = tele.t()
        t_q = time.perf_counter()
        report["frames_deferred"] = cl.quiesce()
        # the DHCP lease book is NOT part of the snapshot: the live
        # server keeps the host authority across the flip (engine-swap
        # discipline — only the device-backed shard state swaps)
        ckpt = build_sharded_checkpoint(cl, 0, clock(), node_id=node_id)
        ckpt = roundtrip_checkpoint(ckpt)  # ops.snapshot chaos point
        report["quiesce_s"] = time.perf_counter() - t_q
        tele.lap(tele.OPS, t0)

        # 2. standby hydration: geometry clone + verified restore + one
        # full device upload (inside restore_sharded_checkpoint)
        t0 = tele.t()
        t_h = time.perf_counter()
        standby = cl.clone_empty()
        report["restored_rows"] = restore_sharded_checkpoint(
            ckpt, standby, now=int(clock()))
        report["hydrate_s"] = time.perf_counter() - t_h
        tele.lap(tele.OPS, t0)

        # 3. chaos flip barrier + the sharded cross-authority audit —
        # the standby must prove the partition invariants BEFORE serving
        fp = fault_point("ops.swap")
        if fp is not None and fp.kind == "fail":
            raise FaultInjectedError("chaos: injected crash mid-swap")
        t0 = tele.t()
        t_a = time.perf_counter()
        audit_rep = invariants.audit_invariants(
            cluster=standby, pools=components.get("pools"),
            dhcp=components.get("dhcp"), check_roundtrip=False)
        report["audit_ok"] = audit_rep.ok
        report["violations"] = audit_rep.violations_by_kind()
        report["audit_s"] = time.perf_counter() - t_a
        tele.lap(tele.OPS, t0)
        if not audit_rep.ok:
            raise CheckpointError(
                f"standby cluster failed the invariant audit: "
                f"{audit_rep.violations_by_kind()}")

        # 4. the flip: one reference store (the drive loop reads
        # components["cluster"] every beat)
        t0 = tele.t()
        t_f = time.perf_counter()
        components["cluster"] = standby
        report["flip_s"] = time.perf_counter() - t_f
        tele.lap(tele.OPS, t0)
        report["outcome"] = "ok"
    except Exception as e:  # noqa: BLE001 — ANY failure keeps the active
        # the active cluster was never mutated (the snapshot reads, the
        # standby owns every write): discard the standby and keep serving
        report["outcome"] = "failed"
        report["error"] = f"{type(e).__name__}: {e}"[:300]
        _log.error("sharded swap did not flip", error=report["error"])
    report["duration_s"] = time.perf_counter() - t_all
    if metrics is not None:
        metrics.record_transition(report)
    return report
