"""Admission control for the slow-path worker fleet (copy of
`bng_tpu/control/admission.py`).

The reference never needs this: its slow path is concurrent Go behind a
kernel UDP socket whose receive buffer IS the admission policy (overflow
= silent tail drop, pkg/dhcp/server.go:302 reads as fast as it can). The
batch re-host funnels every PASS lane through Python workers, so overload
has to be shaped deliberately — and DHCP gives us a protocol-aware way
to shed that a socket buffer cannot:

- **DISCOVER is free to shed.** Clients retransmit DISCOVERs by design
  (RFC 2131 §4.1 backoff); dropping one costs a retry, never state.
- **REQUEST must not be shed once we OFFERed.** The server has already
  promised an address; shedding the REQUEST strands the client mid-DORA
  until its offer times out, and a later retry can race the offer
  expiry into a NAK storm. The controller tracks OFFERed/ACKed client
  MACs (fed back from worker results) and always admits their
  REQUEST/RELEASE/DECLINE traffic.
- **Never half-allocate.** Shedding happens BEFORE a frame reaches a
  worker — an admitted frame always runs the full handler, so an
  address is either fully leased or untouched. (Worker-side exhaustion
  stays silent per the server's normal pool-exhausted path.)

Deadline shedding: a frame that waited longer than `deadline_ms` in the
scheduler/ring queues is answered too late to matter (the client already
retransmitted); stale DISCOVERs are dropped instead of burning worker
time on replies nobody is listening for. REQUESTs are exempt — late is
still better than stranded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from bng_tpu_torch.chaos.faults import fault_point
from bng_tpu_torch.control import dhcp_codec

# shed reasons (the bng_slowpath_shed_total label values)
SHED_INBOX_FULL = "inbox_full"
SHED_DEADLINE = "deadline"
SHED_REQUEST_OVERFLOW = "request_overflow"


def _bootp_off(frame: bytes) -> int | None:
    """Offset of the BOOTP payload in an Eth/IPv4/UDP frame (0-2 VLAN
    tags), or None when the frame isn't shaped like one. Mirrors the
    ring classifier's walk (runtime/ring.py classify_dhcp) but accepts
    either UDP port pair so it peeks replies too."""
    if len(frame) < 14:
        return None
    off = 12
    et = (frame[off] << 8) | frame[off + 1]
    for _ in range(2):
        if et not in (0x8100, 0x88A8):
            break
        off += 4
        if len(frame) < off + 2:
            return None
        et = (frame[off] << 8) | frame[off + 1]
    off += 2
    if et != 0x0800 or len(frame) < off + 20 or (frame[off] >> 4) != 4:
        return None
    ihl = (frame[off] & 0x0F) * 4
    if ihl < 20 or frame[off + 9] != 17:
        return None
    if ((frame[off + 6] << 8) | frame[off + 7]) & 0x3FFF:
        return None  # fragment: no parseable L4
    l4 = off + ihl
    bootp = l4 + 8
    if len(frame) < bootp + 240:
        return None
    return bootp


def peek_dhcp(frame: bytes) -> tuple[int, int] | None:
    """Cheap (msg_type, mac_u64) peek without a full codec decode — the
    admission decision must cost nanoseconds, not a parse. Returns None
    for anything that isn't a plausible DHCPv4 frame (those are admitted
    as-is; the worker's per-frame isolation owns malformed input)."""
    bootp = _bootp_off(frame)
    if bootp is None:
        return None
    if int.from_bytes(frame[bootp + 236 : bootp + 240], "big") != dhcp_codec.DHCP_MAGIC:
        return None
    mac = int.from_bytes(frame[bootp + 28 : bootp + 34], "big")
    # option scan for 53 (bounded: options are TLV until END)
    i = bootp + 240
    end = len(frame)
    for _ in range(64):
        if i >= end:
            break
        code = frame[i]
        if code == dhcp_codec.OPT_END:
            break
        if code == dhcp_codec.OPT_PAD:
            i += 1
            continue
        if i + 1 >= end:
            break
        ln = frame[i + 1]
        if code == dhcp_codec.OPT_MSG_TYPE and ln >= 1 and i + 2 < end:
            return frame[i + 2], mac
        i += 2 + ln
    return 0, mac


def peek_reply(frame: bytes) -> tuple[int, int] | None:
    """(msg_type, client mac_u64) of a server-built reply frame. Replies
    from DHCPServer always carry OPT_MSG_TYPE as the first option, so
    this is a fixed-offset read."""
    bootp = _bootp_off(frame)
    if bootp is None or frame[bootp] != 2:  # BOOTREPLY only
        return None
    o = bootp + 240
    if len(frame) < o + 3 or frame[o] != dhcp_codec.OPT_MSG_TYPE:
        return None
    return frame[o + 2], int.from_bytes(frame[bootp + 28 : bootp + 34], "big")


@dataclass
class AdmissionConfig:
    # per-worker inbox bound: DISCOVER/INFORM admitted while the worker's
    # backlog is below this
    inbox_capacity: int = 512
    # hard bound for lease-mutating messages from UNKNOWN clients (a
    # known client's REQUEST/RELEASE/DECLINE is never shed)
    request_hard_capacity: int = 2048
    # queue-age deadline: a DISCOVER older than this at admission time is
    # answered too late to matter (client already retransmitted)
    deadline_ms: float = 50.0
    # how long an un-ACKed OFFER protects its client's REQUESTs
    offer_ttl_s: float = 60.0
    offer_cap: int = 1 << 16  # bounded OFFER tracking (FIFO eviction)
    # bounded leased-MAC tracking: sized for the subscriber scale
    # target; release/expiry feedback trims it in normal operation,
    # the cap is the backstop against MAC-randomizing churn
    lease_cap: int = 1 << 20


@dataclass
class AdmissionStats:
    admitted: int = 0
    unparsed: int = 0  # admitted without a DHCP peek (worker isolates)
    shed: dict = field(default_factory=lambda: {
        SHED_INBOX_FULL: 0, SHED_DEADLINE: 0, SHED_REQUEST_OVERFLOW: 0})


class AdmissionController:
    """Per-worker bounded-inbox + deadline shedding, DHCP-correct.

    The fleet calls `admit()` for every frame BEFORE it reaches a worker
    inbox and feeds OFFER/ACK observations back from worker results
    (`note_offer`/`note_ack`) so the never-shed-after-OFFER invariant
    holds across batches and across workers.
    """

    # lease-mutating message types: shedding one can strand client state
    _PROTECTED = (dhcp_codec.REQUEST, dhcp_codec.RELEASE, dhcp_codec.DECLINE)

    def __init__(self, cfg: AdmissionConfig | None = None,
                 clock: Callable[[], float] | None = None):
        import time

        self.cfg = cfg or AdmissionConfig()
        self.clock = clock or time.time
        self.stats = AdmissionStats()
        # mac_u64 -> offer timestamp (insertion-ordered: FIFO eviction)
        self._offered: dict[int, float] = {}
        # mac_u64 -> True, insertion-ordered for FIFO eviction at cap
        self._leased: dict[int, bool] = {}

    # -- observations from worker results --------------------------------

    def note_offer(self, mac_u64: int, now: float | None = None) -> None:
        now = now if now is not None else self.clock()
        self._offered.pop(mac_u64, None)  # re-offer refreshes FIFO order
        self._offered[mac_u64] = now
        while len(self._offered) > self.cfg.offer_cap:
            self._offered.pop(next(iter(self._offered)))

    def note_ack(self, mac_u64: int) -> None:
        self._offered.pop(mac_u64, None)
        self._leased.pop(mac_u64, None)  # refresh FIFO order
        self._leased[mac_u64] = True
        while len(self._leased) > self.cfg.lease_cap:
            self._leased.pop(next(iter(self._leased)))

    def note_release(self, mac_u64: int) -> None:
        self._offered.pop(mac_u64, None)
        self._leased.pop(mac_u64, None)

    def is_known(self, mac_u64: int, now: float | None = None) -> bool:
        """Client with a live OFFER or lease — its lease-mutating
        traffic is never shed."""
        if mac_u64 in self._leased:
            return True
        ts = self._offered.get(mac_u64)
        if ts is None:
            return False
        now = now if now is not None else self.clock()
        if now - ts > self.cfg.offer_ttl_s:
            del self._offered[mac_u64]
            return False
        return True

    # -- the decision -----------------------------------------------------

    def admit(self, frame: bytes, inbox_depth: int, now: float,
              enq_t: float | None = None) -> tuple[bool, str | None]:
        """(admitted, shed_reason). `inbox_depth` is the target worker's
        current backlog; `enq_t` (when the caller tracked it — the
        scheduler's lanes do) enables deadline shedding."""
        fp = fault_point("admission.admit")
        if fp is not None and fp.kind == "force_shed":
            # chaos: shed a frame the policy would admit. Service-only
            # degradation by construction — a shed frame never reached a
            # worker, so no allocation can be half-done.
            return self._shed("chaos")
        # fast path: no inbox pressure, no deadline breach — admit
        # without peeking. The peek exists to decide WHAT to shed; when
        # nothing sheds it is pure per-frame overhead on the parent,
        # which is the fleet's serial section.
        if inbox_depth < self.cfg.inbox_capacity and (
                enq_t is None
                or (now - enq_t) * 1000.0 <= self.cfg.deadline_ms):
            self.stats.admitted += 1
            return True, None
        peek = peek_dhcp(frame)
        if peek is None:
            # non-DHCP / unparsable: admit — the worker's per-frame
            # isolation owns poison input, and v6/SLAAC/PPPoE frames ride
            # the same PASS lanes
            self.stats.unparsed += 1
            self.stats.admitted += 1
            return True, None
        msg_type, mac = peek
        if msg_type in self._PROTECTED:
            if self.is_known(mac, now):
                self.stats.admitted += 1
                return True, None  # never shed after OFFER/lease
            if inbox_depth >= self.cfg.request_hard_capacity:
                return self._shed(SHED_REQUEST_OVERFLOW)
            self.stats.admitted += 1
            return True, None
        # DISCOVER / INFORM / unknown: the shed-first class
        if inbox_depth >= self.cfg.inbox_capacity:
            return self._shed(SHED_INBOX_FULL)
        if (enq_t is not None
                and (now - enq_t) * 1000.0 > self.cfg.deadline_ms):
            return self._shed(SHED_DEADLINE)
        self.stats.admitted += 1
        return True, None

    def _shed(self, reason: str) -> tuple[bool, str]:
        self.stats.shed[reason] = self.stats.shed.get(reason, 0) + 1
        return False, reason

    def shed_total(self) -> int:
        """Cumulative shed count across every reason — the watermark the
        fleet autoscaler scales up on (shedding means the worker set is
        underwater NOW; queue depth alone lags a burst)."""
        return sum(self.stats.shed.values())

    def stats_snapshot(self) -> dict:
        return {
            "admitted": self.stats.admitted,
            "unparsed": self.stats.unparsed,
            "shed": dict(self.stats.shed),
            "offers_tracked": len(self._offered),
            "leases_tracked": len(self._leased),
        }
