"""Remote serving member: the `--join` runtime and its coordinator hook
(copy of `bng_tpu/cluster/member.py`).

An announce-only `--join`ed box beats into the carve but every frame
steered its way is shed. This module is the serving half:

- **`MemberRuntime`** runs on the joining box. It announces itself with
  capped exponential backoff (deterministic jitter, loud give-up),
  hydrates its carved blocks from the coordinator's handoff stream
  (`cluster/handoff` — verified checkpoint bytes, never half-hydrated),
  brings up its own `InlineInstance` fleet+engine stack, serves steered
  batches locally, and ships lease/HA deltas back on each reply — the
  `ProcessInstance` pipe discipline re-homed onto the fabric.

- **`RemoteInstance`** is the coordinator-side handle with the
  `InlineInstance` verb surface: `handle_batch` fans frames out as
  signed `rbatch` datagrams, waits (deadline-bounded) for the member's
  replies, and drains the session events that rode back so the
  coordinator's ActiveSyncer/StandbySyncer pair keeps the member's HA
  half on a SURVIVING host — which is exactly what host-loss promotion
  hydrates from.

Steering stays one function: the member re-checks `instance_for_mac`
on every frame it serves and counts `missteers` (must be 0 — the same
placement law end to end).
"""

from __future__ import annotations

import base64
import time
from typing import Callable

from bng_tpu_torch.utils.net import fnv1a32

from .handoff import HandoffManager, parse_handoff_checkpoint
from .instance import InlineInstance, InstanceSpec
from .plan import ClusterPlan, instance_for_mac

# rbatch fan-out: frames per datagram. 8 DHCP frames at ~600 B each
# base64-inflate to ~6.4 KiB — under the transport's MAX_DATAGRAM with
# envelope headroom.
RBATCH_GROUP = 8

JOIN_BACKOFF_BASE_S = 0.5
JOIN_BACKOFF_CAP_S = 8.0
JOIN_DEADLINE_S = 60.0


def _join_delay(node_id: str, attempt: int,
                base_s: float = JOIN_BACKOFF_BASE_S,
                cap_s: float = JOIN_BACKOFF_CAP_S) -> float:
    """Capped exponential backoff with deterministic jitter: the jitter
    is a hash of (node_id, attempt), so a whole rack rejoining after a
    power event de-synchronizes WITHOUT losing replayability (chaos
    runs under a seed must see identical retry timelines)."""
    raw = min(cap_s, base_s * (2 ** min(attempt, 16)))
    frac = (fnv1a32(f"{node_id}/{attempt}".encode()) % 1000) / 1000.0
    return raw * (0.5 + 0.5 * frac)


def _b64(frame) -> str | None:
    return None if frame is None else base64.b64encode(
        bytes(frame)).decode("ascii")


def _unb64(s) -> bytes | None:
    return None if s is None else base64.b64decode(s)


class MemberRuntime:
    """The joining box's loop: join -> hydrate -> serve -> beat.

    Everything is `tick(now)`-driven over an injected transport+clock,
    so the SimTransport chaos lane runs it byte-deterministically and
    the CLI runs the same object over UDP at wall-clock cadence.
    """

    def __init__(self, transport, node_id: str, host: str, *,
                 clock: Callable[[], float] = time.time,
                 beat_interval_s: float = 0.5,
                 join_deadline_s: float = JOIN_DEADLINE_S,
                 join_backoff_base_s: float = JOIN_BACKOFF_BASE_S,
                 join_backoff_cap_s: float = JOIN_BACKOFF_CAP_S,
                 log: Callable[[str], None] | None = None):
        self.transport = transport
        self.node_id = node_id
        self.host = host
        self.clock = clock
        self.beat_interval_s = beat_interval_s
        self.join_deadline_s = join_deadline_s
        self.join_backoff_base_s = join_backoff_base_s
        self.join_backoff_cap_s = join_backoff_cap_s
        self.log = log or (lambda _msg: None)
        self.handoff = HandoffManager(transport, clock=clock,
                                      on_complete=self._on_handoff)
        self.instance: InlineInstance | None = None
        self.plan: ClusterPlan | None = None
        self.state = "joining"  # joining | hydrating | serving | gave_up
        self.join_retries = 0
        self.missteers = 0
        self.batches_served = 0
        self.epoch = 0
        self._started = float(clock())
        self._next_join = float(clock())
        self._next_beat = float(clock())
        self._join_attempt = 0

    # -- fabric loop -------------------------------------------------------
    def tick(self, now: float | None = None) -> None:
        now = float(now if now is not None else self.clock())
        for msg in self.transport.poll():
            if self.handoff.handle(msg):
                if self.state == "joining":
                    self.state = "hydrating"
                continue
            if msg.kind == "rbatch":
                self._serve_rbatch(msg)
            elif msg.kind == "rexpire":
                self._serve_rexpire(msg)
        self.handoff.pump(now)
        if self.state == "joining":
            self._drive_join(now)
        if self.state in ("hydrating", "serving") and now >= self._next_beat:
            served = self.instance.replies if self.instance else 0
            work = self.instance.batches if self.instance else 0
            self.transport.send("coordinator", "beat",
                                {"served": served, "work": work,
                                 "accuse": []})
            self._next_beat = now + self.beat_interval_s

    def _drive_join(self, now: float) -> None:
        if now < self._next_join:
            return
        if now - self._started > self.join_deadline_s:
            self.state = "gave_up"
            self.log(f"cluster join: GIVING UP after "
                     f"{self._join_attempt} attempts over "
                     f"{self.join_deadline_s:.0f}s — coordinator "
                     f"unreachable")
            return
        if self._join_attempt > 0:
            self.join_retries += 1
        self.transport.send("coordinator", "join",
                            {"instance_id": self.node_id,
                             "host": self.host, "serving": True})
        self._join_attempt += 1
        self._next_join = now + _join_delay(
            self.node_id, self._join_attempt,
            self.join_backoff_base_s, self.join_backoff_cap_s)

    # -- hydration (handoff completion) ------------------------------------
    def _on_handoff(self, _src: str, manifest: dict, data: bytes) -> None:
        """A verified carve checkpoint arrived whole: build (or re-plan)
        the serving stack. Corrupt streams never reach here — the
        receiver already rejected them back to re-request."""
        comps = parse_handoff_checkpoint(data)
        plan_doc = comps.get("cluster_plan")
        member = comps.get("member") or {}
        if not plan_doc or member.get("instance_id") != self.node_id:
            return
        self.plan = ClusterPlan.from_dict(plan_doc)
        self.epoch = self.plan.epoch
        iplan = self.plan.members.get(self.node_id)
        if iplan is None or not iplan.blocks:
            return
        spec_kw = dict(member.get("spec") or {})
        spec = InstanceSpec.from_plan(
            iplan, self.plan,
            server_mac=bytes.fromhex(spec_kw.pop("server_mac", "02aabbccdd01")),
            server_ip=int(spec_kw.pop("server_ip", 0)), **spec_kw)
        if self.instance is None:
            self.instance = InlineInstance(spec, clock=self.clock)
        else:
            ok = self.instance.apply_plan(iplan)
            if not ok:
                return  # un-drained shrink: keep serving the old carve
        sessions = member.get("sessions") or []
        if sessions:
            self.instance.hydrate_sessions(
                [_SessionView(s) for s in sessions], now=self.clock())
        self.state = "serving"

    # -- serving verbs -----------------------------------------------------
    def _serve_rbatch(self, msg) -> None:
        if self.instance is None:
            self.transport.send(msg.src, "rbatch_reply", {
                "bid": msg.body.get("bid"), "replies": None,
                "events": [], "error": "not serving"})
            return
        items = [(int(lane), _unb64(fr))
                 for lane, fr in (msg.body.get("items") or ())]
        ids = self.plan.serving_ids() if self.plan else (self.node_id,)
        for _lane, frame in items:
            if frame is not None and len(frame) >= 12 \
                    and instance_for_mac(frame[6:12], ids) != self.node_id:
                self.missteers += 1
        now = msg.body.get("now")
        out = self.instance.handle_batch(items,
                                         float(now) if now is not None
                                         else self.clock())
        self.batches_served += 1
        self.transport.send(msg.src, "rbatch_reply", {
            "bid": msg.body.get("bid"),
            "replies": [[lane, _b64(rep)] for lane, rep in out],
            "events": self.instance.drain_session_events()})

    def _serve_rexpire(self, msg) -> None:
        n = 0
        events: list = []
        if self.instance is not None:
            n = self.instance.expire(int(msg.body.get("now", 0)),
                                     msg.body.get("max_reaps"))
            events = self.instance.drain_session_events()
        self.transport.send(msg.src, "rexpire_reply", {
            "bid": msg.body.get("bid"), "expired": n, "events": events})

    # -- introspection -----------------------------------------------------
    def status(self) -> dict:
        out = {
            "node_id": self.node_id, "host": self.host,
            "state": self.state, "epoch": self.epoch,
            "join_retries": self.join_retries,
            "missteers": self.missteers,
            "batches_served": self.batches_served,
            "handoff": self.handoff.stats(),
        }
        if self.instance is not None:
            out["instance"] = self.instance.status()
        return out

    def close(self) -> None:
        if self.instance is not None:
            self.instance.close()
        self.transport.close()


class _SessionView:
    """Duck-typed SessionState over the handoff's JSON session dicts
    (`InlineInstance.hydrate_sessions` reads attributes)."""

    __slots__ = ("session_id", "mac", "ip", "pool_id", "username",
                 "lease_expiry", "qos_policy")

    def __init__(self, d: dict):
        self.session_id = d.get("session_id", "")
        self.mac = d.get("mac", "")
        self.ip = int(d.get("ip", 0))
        self.pool_id = int(d.get("pool_id", 0))
        self.username = d.get("username", "")
        self.lease_expiry = float(d.get("lease_expiry", 0.0))
        self.qos_policy = d.get("qos_policy", "")


# ---------------------------------------------------------------------------
# coordinator-side handle
# ---------------------------------------------------------------------------

class RemoteInstance:
    """`InlineInstance` verb surface for a member served on another
    host: batches fan out as signed datagram groups, replies + session
    events ride back. The wait is deadline-bounded — a dead remote
    sheds its frames (reply None) instead of wedging the front door;
    the detector demotes it on the beat lane, not here."""

    def __init__(self, transport, instance_id: str, spec: InstanceSpec, *,
                 clock: Callable[[], float] = time.time,
                 pump: Callable[[], None] | None = None,
                 reply_timeout_s: float = 5.0,
                 max_pump_idle: int = 2000):
        self.transport = transport
        self.instance_id = instance_id
        self.spec = spec
        self.clock = clock
        # called while waiting for replies: the coordinator passes its
        # fabric drain (detector tick routes rbatch_reply back here);
        # deterministic tests chain the member's own tick onto it
        self.pump = pump or (lambda: None)
        self.reply_timeout_s = reply_timeout_s
        self.max_pump_idle = max_pump_idle
        self._bid = 0
        self._mail: dict[int, dict] = {}
        self._session_events: list = []
        self.batches = 0
        self.shed_batches = 0
        self.closed = False

    def deliver(self, body: dict) -> None:
        """Coordinator routes `rbatch_reply`/`rexpire_reply` here."""
        bid = body.get("bid")
        if bid is not None:
            self._mail[int(bid)] = body

    def _await(self, bid: int) -> dict | None:
        deadline = float(self.clock()) + self.reply_timeout_s
        idle = 0
        while bid not in self._mail:
            self.pump()
            idle += 1
            if bid in self._mail:
                break
            if float(self.clock()) > deadline or idle > self.max_pump_idle:
                return None
        return self._mail.pop(bid, None)

    def handle_batch(self, items: list, now: float | None = None) -> list:
        self.batches += 1
        groups = [items[i:i + RBATCH_GROUP]
                  for i in range(0, len(items), RBATCH_GROUP)]
        results: list = []
        for group in groups:
            self._bid += 1
            bid = self._bid
            self.transport.send(self.instance_id, "rbatch", {
                "bid": bid, "now": now,
                "items": [[lane, _b64(frame)] for lane, frame in group]})
            reply = self._await(bid)
            if reply is None or reply.get("replies") is None:
                self.shed_batches += 1
                results.extend((lane, None) for lane, _f in group)
                continue
            results.extend((int(lane), _unb64(rep))
                           for lane, rep in reply["replies"])
            self._session_events.extend(
                tuple(ev) for ev in reply.get("events", ()))
        return results

    def expire(self, now: int, max_reaps: int | None = None) -> int:
        self._bid += 1
        bid = self._bid
        self.transport.send(self.instance_id, "rexpire",
                            {"bid": bid, "now": int(now),
                             "max_reaps": max_reaps})
        reply = self._await(bid)
        if reply is None:
            return 0
        self._session_events.extend(
            tuple(ev) for ev in reply.get("events", ()))
        return int(reply.get("expired", 0))

    def drain_session_events(self) -> list:
        out, self._session_events = self._session_events, []
        return out

    def session_states(self, events: list, now: float) -> list:
        return InlineInstance.session_states(self, events, now)

    def status(self) -> dict:
        return {"instance_id": self.instance_id, "remote_serving": True,
                "blocks": list(self.spec.blocks),
                "batches": self.batches,
                "shed_batches": self.shed_batches}

    def export_state(self) -> dict:
        return {}

    def lease_count(self) -> int:
        # the authoritative books live on the remote box; the HA store
        # mirrors them, which is what removal/drain decisions consult
        return 0

    def close(self) -> None:
        self.closed = True
