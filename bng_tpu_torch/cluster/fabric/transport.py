"""Fabric transports: authenticated UDP datagrams + deterministic sim.

`UDPTransport` is the production lane: one datagram socket per node
(loopback multiport by default, so tests and single-host clusters need
no privileges), every message HMAC-signed with the existing
`control/deviceauth.py` PSK signer and checked for timestamp skew and
per-source sequence replay on receive. The wire format is one JSON
object per datagram — small (beats are ~200 bytes), debuggable with
tcpdump, and versioned (`v`) so a rolling restart across fabric
versions degrades to counted drops instead of crashes.

`SimTransport` is the deterministic twin the chaos scenarios drive: an
in-memory hub with per-link drop probability, delivery delay and
severed-link knobs. Partitions are **per directed link**, so the NEAT
shape — A↔B dead while both still reach C — is a first-class
configuration (`partition("a", "b")` cuts exactly that pair), not a
binary netsplit.

Both expose the same endpoint surface (`send` / `poll` / `add_peer` /
`stats`), so `membership.FailureDetector` runs unchanged on either.

A copy of `bng_tpu/cluster/fabric/transport.py` with its imports renamed.
"""

from __future__ import annotations

import json
import random
import socket
import time
from dataclasses import dataclass, field
from typing import Callable

FABRIC_VERSION = 1
MAX_DATAGRAM = 8192


@dataclass
class FabricMessage:
    """One verified fabric datagram."""

    src: str
    seq: int
    ts: float
    kind: str
    body: dict = field(default_factory=dict)


def _canonical(src: str, seq: int, ts: float, kind: str, body: dict) -> str:
    """The signed byte string: canonical JSON of everything but the
    signature. sort_keys + tight separators make signer and verifier
    byte-identical regardless of dict insertion order."""
    return json.dumps({"v": FABRIC_VERSION, "src": src, "seq": seq,
                       "ts": ts, "kind": kind, "body": body},
                      sort_keys=True, separators=(",", ":"))


class UDPTransport:
    """One node's fabric endpoint: a non-blocking UDP socket plus the
    peer address book. `bind=("127.0.0.1", 0)` (the default) takes an
    ephemeral loopback port — the multiport shape process-mode clusters
    and tests use; a real multi-host deployment binds its fabric
    address via `bng cluster run --listen`."""

    def __init__(self, node_id: str, authenticator,
                 bind: tuple = ("127.0.0.1", 0),
                 clock: Callable[[], float] = time.time,
                 max_skew_s: float = 300.0):
        self.node_id = node_id
        self.authenticator = authenticator
        self.clock = clock
        self.max_skew_s = max_skew_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(bind)
        self._sock.setblocking(False)
        self.addr: tuple = self._sock.getsockname()
        self.peers: dict[str, tuple] = {}
        self._seq = 0
        self._last_seq: dict[str, int] = {}
        self.stats = {"tx": 0, "tx_errors": 0, "rx": 0, "rx_bad_sig": 0,
                      "rx_replay": 0, "rx_skew": 0, "rx_malformed": 0}

    def add_peer(self, node_id: str, addr: tuple) -> None:
        self.peers[node_id] = (addr[0], int(addr[1]))

    def reset_peer(self, node_id: str) -> None:
        """Forget a peer's replay floor (member slot re-occupied by a
        fresh process whose seq restarts at 1)."""
        self._last_seq.pop(node_id, None)

    def send(self, dst: str, kind: str, body: dict) -> bool:
        addr = self.peers.get(dst)
        if addr is None:
            self.stats["tx_errors"] += 1
            return False
        self._seq += 1
        ts = float(self.clock())
        payload = _canonical(self.node_id, self._seq, ts, kind, body)
        sig = self.authenticator.sign_message(payload)
        wire = json.dumps({"v": FABRIC_VERSION, "src": self.node_id,
                           "seq": self._seq, "ts": ts, "kind": kind,
                           "body": body, "sig": sig},
                          separators=(",", ":")).encode()
        try:
            self._sock.sendto(wire, addr)
        except OSError:
            self.stats["tx_errors"] += 1
            return False
        self.stats["tx"] += 1
        return True

    def _verify(self, raw: bytes) -> FabricMessage | None:
        try:
            d = json.loads(raw)
            src = str(d["src"])
            seq = int(d["seq"])
            ts = float(d["ts"])
            kind = str(d["kind"])
            body = d["body"]
            sig = str(d["sig"])
            if int(d.get("v", 0)) != FABRIC_VERSION \
                    or not isinstance(body, dict):
                raise ValueError("bad version/body")
        except (KeyError, TypeError, ValueError, json.JSONDecodeError):
            self.stats["rx_malformed"] += 1
            return None
        expected = self.authenticator.sign_message(
            _canonical(src, seq, ts, kind, body))
        import hmac as _hmac

        if not _hmac.compare_digest(sig, expected):
            self.stats["rx_bad_sig"] += 1
            return None
        if abs(float(self.clock()) - ts) > self.max_skew_s:
            self.stats["rx_skew"] += 1
            return None
        if seq <= self._last_seq.get(src, 0):
            # replayed or reordered-behind datagram: beats are
            # idempotent state, only the freshest matters
            self.stats["rx_replay"] += 1
            return None
        self._last_seq[src] = seq
        self.stats["rx"] += 1
        return FabricMessage(src=src, seq=seq, ts=ts, kind=kind, body=body)

    def poll(self, max_msgs: int = 256) -> list[FabricMessage]:
        out: list[FabricMessage] = []
        while len(out) < max_msgs:
            try:
                raw, _peer = self._sock.recvfrom(MAX_DATAGRAM)
            except BlockingIOError:
                break
            except OSError:
                break
            msg = self._verify(raw)
            if msg is not None:
                # learned peer addressing: the datagram passed the PSK
                # signature + replay floor, so its source address is the
                # authenticated peer's current binding — record it so a
                # joiner we have never been told about (bng cluster run
                # --join from another box) can be answered
                self.peers[msg.src] = (_peer[0], int(_peer[1]))
                out.append(msg)
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# deterministic sim
# ---------------------------------------------------------------------------

class _SimEndpoint:
    """One node's view of the hub — the UDPTransport surface minus
    sockets. Peer addressing is by node id (the hub IS the network), so
    `add_peer` just records reachability intent for `send`'s fan-out
    callers."""

    def __init__(self, hub: "SimTransport", node_id: str):
        self.hub = hub
        self.node_id = node_id
        self.peers: dict[str, str] = {}
        self.stats = {"tx": 0, "tx_errors": 0, "rx": 0, "rx_dropped": 0,
                      "rx_cut": 0}

    @property
    def addr(self) -> tuple:
        return ("sim", 0)

    def add_peer(self, node_id: str, addr: tuple = ("sim", 0)) -> None:
        self.peers[node_id] = node_id

    def reset_peer(self, node_id: str) -> None:
        pass  # the hub has no replay floor (surface parity with UDP)

    def send(self, dst: str, kind: str, body: dict) -> bool:
        return self.hub._send(self, dst, kind, body)

    def poll(self, max_msgs: int = 256) -> list:
        return self.hub._poll(self, max_msgs)

    def close(self) -> None:
        pass


class SimTransport:
    """Deterministic in-memory datagram hub with per-link faults.

    Fault knobs are keyed per DIRECTED link `(src, dst)`:
      - `set_drop(a, b, p)` — seeded-RNG drop probability,
      - `set_delay(a, b, s)` — delivery latency (messages surface from
        `poll` only once the clock passes send+delay),
      - `partition(a, b)` — sever a↔b (both directions) while every
        other link stays up: the *partial* partition shape
        (`partition_oneway` cuts a single direction for asymmetric
        splits).

    All ordering is (deliver_at, send order): two runs with the same
    seed and clock produce byte-identical delivery sequences.
    """

    def __init__(self, clock: Callable[[], float], seed: int = 0):
        self.clock = clock
        self._rng = random.Random(seed)
        self._queues: dict[str, list] = {}
        self._endpoints: dict[str, _SimEndpoint] = {}
        self._order = 0
        self._drop: dict[tuple, float] = {}
        self._delay: dict[tuple, float] = {}
        self._cut: set[tuple] = set()
        self._seq: dict[str, int] = {}
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0, "cut": 0}

    def endpoint(self, node_id: str) -> _SimEndpoint:
        ep = self._endpoints.get(node_id)
        if ep is None:
            ep = self._endpoints[node_id] = _SimEndpoint(self, node_id)
            self._queues[node_id] = []
        return ep

    # -- fault knobs ------------------------------------------------------
    def set_drop(self, a: str, b: str, p: float) -> None:
        """Drop probability on BOTH directions of link a↔b."""
        self._drop[(a, b)] = p
        self._drop[(b, a)] = p

    def set_delay(self, a: str, b: str, delay_s: float) -> None:
        self._delay[(a, b)] = delay_s
        self._delay[(b, a)] = delay_s

    def partition(self, a: str, b: str) -> None:
        """Sever exactly the a↔b link; a and b keep every other link —
        the partial-partition (NEAT) shape."""
        self._cut.add((a, b))
        self._cut.add((b, a))

    def partition_oneway(self, a: str, b: str) -> None:
        self._cut.add((a, b))

    def heal(self, a: str, b: str) -> None:
        self._cut.discard((a, b))
        self._cut.discard((b, a))

    def heal_all(self) -> None:
        self._cut.clear()

    # -- datagram path ----------------------------------------------------
    def _send(self, ep: _SimEndpoint, dst: str, kind: str,
              body: dict) -> bool:
        if dst not in self._queues:
            ep.stats["tx_errors"] += 1
            return False
        link = (ep.node_id, dst)
        self.stats["sent"] += 1
        ep.stats["tx"] += 1
        if link in self._cut:
            self.stats["cut"] += 1
            return True  # datagram semantics: the sender never learns
        p = self._drop.get(link, 0.0)
        if p > 0.0 and self._rng.random() < p:
            self.stats["dropped"] += 1
            return True
        self._seq[ep.node_id] = self._seq.get(ep.node_id, 0) + 1
        self._order += 1
        deliver_at = float(self.clock()) + self._delay.get(link, 0.0)
        msg = FabricMessage(src=ep.node_id, seq=self._seq[ep.node_id],
                            ts=float(self.clock()), kind=kind,
                            body=dict(body))
        self._queues[dst].append((deliver_at, self._order, msg))
        return True

    def _poll(self, ep: _SimEndpoint, max_msgs: int) -> list:
        now = float(self.clock())
        q = self._queues[ep.node_id]
        due = [item for item in q if item[0] <= now]
        if not due:
            return []
        due.sort(key=lambda t: (t[0], t[1]))
        due = due[:max_msgs]
        taken = set(id(item) for item in due)
        self._queues[ep.node_id] = [item for item in q
                                    if id(item) not in taken]
        out = [msg for _at, _o, msg in due]
        ep.stats["rx"] += len(out)
        self.stats["delivered"] += len(out)
        return out
