"""Partition-aware membership: heartbeats, suspicion, gray detection.

The detector runs the same on the UDP fabric and the SimTransport.
Three failure shapes, three rules:

- **Dead** (crash / SIGKILL / full partition): beats stop. Local
  suspicion is the missed-beat count (`(now - last_seen) /
  beat_interval`); at `suspicion_threshold` the peer becomes *suspect*.
  A suspect is only demoted to *down* when a **quorum of observers
  accuses it** — each beat piggybacks the sender's own suspect set, so
  accusations travel on the beats themselves, no extra protocol.

- **Partial partition** (NEAT, Alquraan OSDI'18): A↔B dead while both
  reach C. A accuses B and B accuses A, but C accuses neither — no
  quorum forms on either side, nobody is demoted, and the carve plan
  never double-assigns a block across the split. In the coordinator's
  star topology (process members beat to the parent) the parent is the
  sole observer and passes `quorum=1`: there is no second vantage
  point, so local suspicion decides — exactly the pipe-oracle semantics
  it replaces.

- **Gray member** (Huang HotOS'17): beats keep arriving but the
  serving-health word stalls. Each beat carries two cumulative
  counters: `work` (batches accepted) and `served` (replies produced).
  If `work` advances across `gray_beats` consecutive beats while
  `served` does not, the member is wedged-in-serving — verdict *gray*.
  Gray needs no quorum: the evidence is the member's own signed beat,
  not an absence that a partition could explain.

Verdicts feed the coordinator through its existing HealthMonitor /
FailoverController machinery: `probe(peer)` returns False for gray and
down members, so a gray member is demoted exactly like a dead one.

A copy of `bng_tpu/cluster/fabric/membership.py` with its imports renamed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

PEER_UP = "up"
PEER_SUSPECT = "suspect"
PEER_GRAY = "gray"
PEER_DOWN = "down"


@dataclass
class PeerView:
    """What this detector knows about one watched peer."""

    last_seen: float = 0.0
    beats_rx: int = 0
    served: int = -1
    work: int = -1
    stalled_beats: int = 0
    accused_by: set = field(default_factory=set)
    state: str = PEER_UP
    # suspect episodes that healed (beats resumed before any demotion):
    # the observable signature of a transient link partition
    partitions_observed: int = 0


class FailureDetector:
    """Heartbeat + suspicion failure detector over a fabric endpoint.

    `beat()` sends this node's serving-health word (and its current
    suspect set) to every peer on the endpoint; `tick(now)` drains the
    endpoint and advances every watched peer's state machine, returning
    the verdict transitions that happened this tick.
    """

    def __init__(self, node_id: str, endpoint, *,
                 clock: Callable[[], float] = time.time,
                 beat_interval_s: float = 0.5,
                 suspicion_threshold: int = 3,
                 gray_beats: int = 4,
                 startup_grace_s: float = 30.0,
                 quorum: int | None = None,
                 on_verdict: Callable[[str, str], None] | None = None,
                 on_message: Callable[[object], None] | None = None):
        self.node_id = node_id
        self.endpoint = endpoint
        self.clock = clock
        self.beat_interval_s = beat_interval_s
        self.suspicion_threshold = suspicion_threshold
        self.gray_beats = gray_beats
        self.startup_grace_s = startup_grace_s
        self._quorum = quorum
        self.on_verdict = on_verdict
        self.on_message = on_message
        self.views: dict[str, PeerView] = {}
        self.beats_tx = 0
        self.beats_rx = 0
        self.verdicts = {PEER_SUSPECT: 0, PEER_GRAY: 0, PEER_DOWN: 0}

    # -- membership of the watch set --------------------------------------
    def watch(self, peer_id: str, now: float | None = None) -> None:
        """Start watching a peer; the grace clock starts NOW (a freshly
        built member must get a full suspicion window before its first
        beat is due, or every join reads as a failure)."""
        v = self.views.get(peer_id)
        if v is None:
            v = self.views[peer_id] = PeerView()
        v.last_seen = float(now if now is not None else self.clock())

    def forget(self, peer_id: str) -> None:
        self.views.pop(peer_id, None)

    def reset(self, peer_id: str, now: float | None = None) -> None:
        """Wipe a peer's history (standby promotion: the slot is a new
        process with fresh counters)."""
        self.views[peer_id] = PeerView()
        self.watch(peer_id, now)

    def quorum_for(self, peer_id: str) -> int:
        """Observers of X = this node plus every other watched peer.
        Majority of them must accuse X before a down verdict — unless
        an explicit quorum was configured (the coordinator star passes
        1: it is the only observer)."""
        if self._quorum is not None:
            return self._quorum
        observers = 1 + sum(1 for p in self.views if p != peer_id)
        return observers // 2 + 1

    # -- sending ----------------------------------------------------------
    def suspects(self) -> list:
        return sorted(p for p, v in self.views.items()
                      if v.state in (PEER_SUSPECT, PEER_DOWN))

    def beat(self, served: int = 0, work: int = 0, backlog: bool = False,
             now: float | None = None) -> int:
        """One heartbeat to every peer: the serving-health word plus
        this node's accusation set. Returns peers reached."""
        del now  # the endpoint stamps ts from its own clock
        body = {"served": int(served), "work": int(work),
                "backlog": bool(backlog), "accuse": self.suspects()}
        sent = 0
        for peer in sorted(self.endpoint.peers):
            if self.endpoint.send(peer, "beat", body):
                sent += 1
        self.beats_tx += sent
        return sent

    # -- receiving + the state machine ------------------------------------
    def _absorb_beat(self, msg) -> None:
        v = self.views.get(msg.src)
        if v is not None:
            self.beats_rx += 1
            v.beats_rx += 1
            v.last_seen = float(self.clock())
            served = int(msg.body.get("served", 0))
            work = int(msg.body.get("work", 0))
            if v.work >= 0 and work > v.work and served <= v.served:
                # input advanced, output did not: the gray signature
                v.stalled_beats += 1
            elif served > v.served:
                v.stalled_beats = 0
            v.served = max(v.served, served)
            v.work = max(v.work, work)
        # accusations refresh with every beat: a peer that stops
        # accusing X (its link healed) withdraws its vote
        accused = set(msg.body.get("accuse", ()) or ())
        for target, tv in self.views.items():
            if target == msg.src:
                continue
            if target in accused:
                tv.accused_by.add(msg.src)
            else:
                tv.accused_by.discard(msg.src)

    def suspicion(self, peer_id: str, now: float | None = None) -> int:
        """Missed-beat count for a peer (0 = fresh)."""
        v = self.views.get(peer_id)
        if v is None:
            return 0
        now = float(now if now is not None else self.clock())
        return max(0, int((now - v.last_seen) / self.beat_interval_s))

    def tick(self, now: float | None = None) -> list:
        """Drain the endpoint, advance every watched peer's state.
        Returns [(peer_id, new_state)] for transitions this tick."""
        now = float(now if now is not None else self.clock())
        for msg in self.endpoint.poll():
            if msg.kind == "beat":
                self._absorb_beat(msg)
            elif self.on_message is not None:
                self.on_message(msg)
        out = []
        for peer in sorted(self.views):
            v = self.views[peer]
            if v.state == PEER_DOWN:
                continue  # terminal until reset()
            new = v.state
            missed = int((now - v.last_seen) / self.beat_interval_s)
            # a peer that has NEVER beaten gets the startup grace
            # instead of the missed-beat window: a spawning process
            # member needs seconds to import before its first beat,
            # and suspecting it mid-start flaps the failover machinery
            if v.beats_rx == 0 and (now - v.last_seen) < self.startup_grace_s:
                continue
            if v.stalled_beats >= self.gray_beats:
                new = PEER_GRAY
            elif missed >= self.suspicion_threshold:
                v.accused_by.add(self.node_id)
                new = (PEER_DOWN
                       if len(v.accused_by) >= self.quorum_for(peer)
                       else PEER_SUSPECT)
            elif v.state in (PEER_SUSPECT, PEER_UP):
                v.accused_by.discard(self.node_id)
                if v.state == PEER_SUSPECT:
                    v.partitions_observed += 1  # healed: beats resumed
                new = PEER_UP
            if new != v.state:
                v.state = new
                if new in self.verdicts:
                    self.verdicts[new] += 1
                out.append((peer, new))
                if self.on_verdict is not None:
                    self.on_verdict(peer, new)
        return out

    # -- the probe the coordinator's HealthMonitor consumes ---------------
    def probe(self, peer_id: str) -> bool:
        """False once the fabric has demoted the peer (gray or down) —
        the HealthMonitor failure-threshold machinery owns what happens
        next, same as the pipe-flag oracle it replaces."""
        v = self.views.get(peer_id)
        return v is None or v.state not in (PEER_GRAY, PEER_DOWN)

    # -- introspection (collect_fabric scrape source) ---------------------
    def status(self) -> dict:
        return {
            "node_id": self.node_id,
            "beats_tx": self.beats_tx,
            "beats_rx": self.beats_rx,
            "verdicts": dict(self.verdicts),
            "partitions_observed": sum(v.partitions_observed
                                       for v in self.views.values()),
            "peers": {p: {"state": v.state, "beats_rx": v.beats_rx,
                          "stalled_beats": v.stalled_beats,
                          "accused_by": sorted(v.accused_by),
                          "served": v.served, "work": v.work}
                      for p, v in sorted(self.views.items())},
        }
