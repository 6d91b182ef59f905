"""Chunked, signed, resumable state transfer over the fabric transport.

Checkpoint bytes are framed into sequenced chunks that ride the same
authenticated datagram lane as the membership beats — every frame is
PSK-HMAC-signed by the transport, and the payload carries its own
defense in depth: a per-chunk CRC32, a manifest with the whole-payload
SHA-256, and (for checkpoint payloads) the `runtime/checkpoint.py`
structural gate run on the assembled bytes BEFORE anything hydrates.

The protocol is receiver-driven and never half-hydrates:

- **manifest** (`xfer_manifest`): transfer id, total length, chunk
  geometry, payload digest, purpose + caller meta. A receiver holding
  partial state for the same (src, xid, digest) keeps its chunks and
  ACKs its cursor — that IS resume; a different digest resets it.
- **chunks** (`xfer_chunk`): base64 payload slices sized under the
  transport's `MAX_DATAGRAM`, each with its own CRC32. A corrupt chunk
  is dropped and re-requested — rejection is always re-request, never
  partial acceptance.
- **acks** (`xfer_ack`): the receiver's contiguous cursor plus an
  explicit gap list (`need`). The sender retransmits needs first, then
  streams a bounded window past the highest ack. `reject=True` wipes
  both sides back to zero (assembled payload failed the digest or the
  checkpoint gate: the only safe cursor is 0).

`HandoffManager` multiplexes senders and receivers per node and owns
the cursor/manifest mutations (`set_manifest` / `accept_chunk` are on
the bngcheck single-writer allowlist — a second writer would desync the
ack cursor from the assembled bytes).

A copy of `bng_tpu/cluster/handoff/protocol.py` with its imports renamed.
"""

from __future__ import annotations

import base64
import hashlib
import time
import zlib
from typing import Callable

# 4 KiB of raw payload per chunk: base64 inflates it to ~5.5 KiB and
# the signed JSON envelope stays safely under MAX_DATAGRAM (8 KiB).
# PERF_NOTES §22 has the sizing curve — bigger chunks amortize the
# HMAC+JSON overhead, smaller ones re-request less on corruption.
DEFAULT_CHUNK_SIZE = 4096
DEFAULT_WINDOW = 8
_MAX_NEED = 128  # gap list cap per ack (datagram bound)

KIND_MANIFEST = "xfer_manifest"
KIND_CHUNK = "xfer_chunk"
KIND_ACK = "xfer_ack"


class HandoffError(RuntimeError):
    """A transfer that cannot proceed (bad geometry, oversized chunk)."""


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# checkpoint payload helpers (the restore verification surface)
# ---------------------------------------------------------------------------

def build_handoff_checkpoint(seq: int, components: dict,
                             arrays: dict | None = None) -> bytes:
    """Wrap handoff state in the checkpoint container so the receiver
    reuses `verify_checkpoint_bytes` (magic + header CRC + payload CRC)
    as its hydration gate — the exact rejection surface restore has."""
    from bng_tpu_torch.runtime.checkpoint import Checkpoint, encode_checkpoint

    return encode_checkpoint(Checkpoint(
        meta={"seq": int(seq), "kind": "fabric_handoff",
              "components": components},
        arrays=arrays or {}))


def parse_handoff_checkpoint(data: bytes) -> dict:
    """Verify + decode handoff bytes -> the components dict. Raises
    `CheckpointError` on any structural corruption (callers treat that
    as reject-to-re-request, never partial hydration)."""
    from bng_tpu_torch.runtime.checkpoint import decode_checkpoint

    return dict(decode_checkpoint(data).meta.get("components", {}))


def verify_handoff_bytes(data: bytes) -> None:
    """The default assembled-payload gate: full checkpoint structural
    validation (header CRC, payload length, payload CRC32)."""
    from bng_tpu_torch.runtime.checkpoint import verify_checkpoint_bytes

    verify_checkpoint_bytes(data)


# ---------------------------------------------------------------------------
# sender
# ---------------------------------------------------------------------------

class StateSender:
    """One outbound transfer: manifest + windowed chunk stream, driven
    by receiver acks and a retransmit timer (`pump`)."""

    def __init__(self, transport, dst: str, xid: str, data: bytes, *,
                 kind: str = "carve", meta: dict | None = None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 window: int = DEFAULT_WINDOW,
                 retry_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.time):
        if chunk_size <= 0 or chunk_size > 5120:
            # 5120 raw -> ~6.9 KiB base64: the ceiling that still fits
            # the signed envelope in one datagram
            raise HandoffError(f"chunk_size {chunk_size} out of (0, 5120]")
        self.transport = transport
        self.dst = dst
        self.xid = xid
        self.data = data
        self.kind = kind
        self.meta = dict(meta or {})
        self.chunk_size = chunk_size
        self.window = window
        self.retry_interval_s = retry_interval_s
        self.clock = clock
        self.n_chunks = max(1, (len(data) + chunk_size - 1) // chunk_size)
        self.acked = 0          # receiver's contiguous cursor
        self.sent_high = 0      # chunks streamed past the cursor
        self.need: list[int] = []
        self.done = False
        self.rejected = 0
        self._manifest_acked = False
        self._last_progress = float(clock())
        self.stats = {"tx_chunks": 0, "retx_chunks": 0, "acks_rx": 0,
                      "manifests_tx": 0, "rejects_rx": 0}
        self._send_manifest()

    # -- wire --------------------------------------------------------------
    def _send_manifest(self) -> None:
        self.stats["manifests_tx"] += 1
        self.transport.send(self.dst, KIND_MANIFEST, {
            "xid": self.xid, "kind": self.kind,
            "total_len": len(self.data), "n_chunks": self.n_chunks,
            "chunk_size": self.chunk_size, "digest": _digest(self.data),
            "meta": self.meta})

    def _send_chunk(self, seq: int, retx: bool = False) -> None:
        lo = seq * self.chunk_size
        raw = self.data[lo: lo + self.chunk_size]
        self.stats["retx_chunks" if retx else "tx_chunks"] += 1
        self.transport.send(self.dst, KIND_CHUNK, {
            "xid": self.xid, "seq": seq,
            "crc": zlib.crc32(raw) & 0xFFFFFFFF,
            "data": base64.b64encode(raw).decode("ascii")})

    # -- ack absorption ----------------------------------------------------
    def on_ack(self, body: dict) -> None:
        if str(body.get("xid", "")) != self.xid or self.done:
            return
        self.stats["acks_rx"] += 1
        self._last_progress = float(self.clock())
        if body.get("reject"):
            # assembled payload failed the digest/checkpoint gate: the
            # only safe resume point is zero — restart the stream
            self.rejected += 1
            self.stats["rejects_rx"] += 1
            self.acked = 0
            self.sent_high = 0
            self.need = []
            self._send_manifest()
            return
        if body.get("done"):
            self.done = True
            self._manifest_acked = True
            self.acked = self.n_chunks
            return
        self._manifest_acked = True
        self.acked = max(self.acked, int(body.get("cursor", 0)))
        self.sent_high = max(self.sent_high, self.acked)
        need = [int(s) for s in (body.get("need") or ())
                if 0 <= int(s) < self.n_chunks]
        self.need = need

    # -- drive -------------------------------------------------------------
    def pump(self, now: float | None = None) -> int:
        """Advance the stream: retransmit requested gaps, then fill the
        window past the highest chunk in flight. Time-based fallback:
        no ack progress for `retry_interval_s` re-sends the manifest
        (lost-datagram recovery). Returns chunks sent this call."""
        if self.done:
            return 0
        now = float(now if now is not None else self.clock())
        sent = 0
        if not self._manifest_acked:
            if now - self._last_progress >= self.retry_interval_s:
                self._send_manifest()
                self._last_progress = now
            return 0
        for seq in self.need[: self.window]:
            self._send_chunk(seq, retx=True)
            sent += 1
        self.need = self.need[self.window:]
        while (sent < self.window and self.sent_high < self.n_chunks):
            self._send_chunk(self.sent_high)
            self.sent_high += 1
            sent += 1
        if sent == 0 and now - self._last_progress >= self.retry_interval_s:
            # everything streamed but the ack went quiet: nudge from
            # the receiver's last known cursor
            for seq in range(self.acked,
                             min(self.acked + self.window, self.n_chunks)):
                self._send_chunk(seq, retx=True)
                sent += 1
            self._last_progress = now
        return sent


# ---------------------------------------------------------------------------
# receiver
# ---------------------------------------------------------------------------

class _Transfer:
    """Receiver-side state for one (src, xid) stream."""

    __slots__ = ("src", "xid", "kind", "total_len", "n_chunks",
                 "chunk_size", "digest", "meta", "chunks", "cursor",
                 "complete", "delivered")

    def __init__(self, src: str, xid: str):
        self.src = src
        self.xid = xid
        self.kind = ""
        self.total_len = 0
        self.n_chunks = 0
        self.chunk_size = 0
        self.digest = ""
        self.meta: dict = {}
        self.chunks: dict[int, bytes] = {}
        self.cursor = 0
        self.complete = False
        self.delivered = False


class StateReceiver:
    """Inbound transfers for one node: ACK-cursor bookkeeping, gap
    re-requests, corruption rejection, resume. The single writer of the
    transfer cursor/manifest state (bngcheck BNG040 allowlist)."""

    def __init__(self, transport, *, ack_every: int = 4,
                 verify: Callable[[bytes], None] | None = verify_handoff_bytes,
                 on_complete: Callable[[str, dict, bytes], None] | None = None):
        self.transport = transport
        self.ack_every = ack_every
        self.verify = verify
        self.on_complete = on_complete
        self.transfers: dict[tuple, _Transfer] = {}
        self.stats = {"rx_chunks": 0, "rx_corrupt": 0, "rx_dup": 0,
                      "rx_orphan": 0, "resumes": 0, "rejects": 0,
                      "completed": 0, "acks_tx": 0}

    # -- manifest / chunk mutators (single-writer surface) -----------------
    def set_manifest(self, src: str, body: dict) -> _Transfer:
        """Adopt (or resume) a transfer from its manifest. Same digest
        on an in-progress transfer keeps the chunks already banked —
        the resume path; anything else starts clean."""
        xid = str(body.get("xid", ""))
        key = (src, xid)
        t = self.transfers.get(key)
        digest = str(body.get("digest", ""))
        if t is not None and not t.complete and t.digest == digest \
                and t.chunks:
            self.stats["resumes"] += 1
        elif t is None or t.digest != digest:
            t = self.transfers[key] = _Transfer(src, xid)
        t.kind = str(body.get("kind", ""))
        t.total_len = int(body.get("total_len", 0))
        t.n_chunks = int(body.get("n_chunks", 0))
        t.chunk_size = int(body.get("chunk_size", 0))
        t.digest = digest
        t.meta = dict(body.get("meta") or {})
        if t.n_chunks <= 0 or t.chunk_size <= 0:
            self.stats["rx_orphan"] += 1
            del self.transfers[key]
            return t
        self._ack(t)
        return t

    def accept_chunk(self, src: str, body: dict) -> None:
        """Bank one chunk: CRC-gate it, advance the contiguous cursor,
        re-request on any mismatch. Completion assembles + verifies the
        whole payload before a single byte is handed to the caller."""
        xid = str(body.get("xid", ""))
        t = self.transfers.get((src, xid))
        if t is None or t.complete:
            self.stats["rx_orphan" if t is None else "rx_dup"] += 1
            return
        try:
            seq = int(body["seq"])
            raw = base64.b64decode(str(body["data"]), validate=True)
            crc = int(body["crc"])
        except (KeyError, TypeError, ValueError):
            self.stats["rx_corrupt"] += 1
            self._ack(t)
            return
        if seq < 0 or seq >= t.n_chunks:
            self.stats["rx_orphan"] += 1
            return
        if (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
            # corrupt in flight: drop it; the gap list re-requests it
            self.stats["rx_corrupt"] += 1
            self._ack(t)
            return
        if seq in t.chunks:
            # duplicate = the sender missed an ack (retransmit storm):
            # re-ack so it re-learns the cursor instead of looping
            self.stats["rx_dup"] += 1
            self._ack(t)
            return
        self.stats["rx_chunks"] += 1
        t.chunks[seq] = raw
        while t.cursor in t.chunks:
            t.cursor += 1
        if len(t.chunks) >= t.n_chunks:
            self._finish(t)
        elif t.cursor >= t.n_chunks or len(t.chunks) % self.ack_every == 0 \
                or t.cursor != seq + 1:
            # cadence ack, plus an immediate one on out-of-order arrival
            # so the sender learns the gap without waiting a window
            self._ack(t)

    # -- completion --------------------------------------------------------
    def _finish(self, t: _Transfer) -> None:
        data = b"".join(t.chunks[i] for i in range(t.n_chunks))
        reason = ""
        if len(data) != t.total_len:
            reason = f"assembled {len(data)} != manifest {t.total_len}"
        elif _digest(data) != t.digest:
            reason = "payload digest mismatch"
        elif self.verify is not None:
            try:
                self.verify(data)
            except Exception as e:  # CheckpointError and kin
                reason = f"checkpoint gate: {e}"
        if reason:
            # never half-hydrate: wipe the banked chunks and make the
            # sender restart the stream from zero
            self.stats["rejects"] += 1
            t.chunks.clear()
            t.cursor = 0
            self.stats["acks_tx"] += 1
            self.transport.send(t.src, KIND_ACK, {
                "xid": t.xid, "cursor": 0, "need": [], "reject": True,
                "reason": reason})
            return
        t.complete = True
        self.stats["completed"] += 1
        self.stats["acks_tx"] += 1
        self.transport.send(t.src, KIND_ACK,
                            {"xid": t.xid, "cursor": t.n_chunks,
                             "need": [], "done": True})
        if self.on_complete is not None and not t.delivered:
            t.delivered = True
            self.on_complete(t.src, {"xid": t.xid, "kind": t.kind,
                                     "meta": t.meta}, data)

    def _ack(self, t: _Transfer) -> None:
        need = sorted(s for s in range(t.cursor, min(t.n_chunks,
                                                     t.cursor + 4096))
                      if s not in t.chunks and s < max(t.chunks, default=0))
        self.stats["acks_tx"] += 1
        self.transport.send(t.src, KIND_ACK, {
            "xid": t.xid, "cursor": t.cursor, "need": need[:_MAX_NEED],
            "done": t.complete})


# ---------------------------------------------------------------------------
# manager: one node's send+receive multiplexer
# ---------------------------------------------------------------------------

class HandoffManager:
    """Both halves behind one `handle(msg)` / `pump(now)` surface, the
    shape the coordinator's and member's fabric loops drive."""

    def __init__(self, transport, *,
                 clock: Callable[[], float] = time.time,
                 verify: Callable[[bytes], None] | None = verify_handoff_bytes,
                 on_complete: Callable[[str, dict, bytes], None] | None = None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 window: int = DEFAULT_WINDOW):
        self.transport = transport
        self.clock = clock
        self.chunk_size = chunk_size
        self.window = window
        self.receiver = StateReceiver(transport, verify=verify,
                                      on_complete=on_complete)
        self.senders: dict[tuple, StateSender] = {}
        self._xid_seq = 0

    def send(self, dst: str, data: bytes, *, kind: str = "carve",
             meta: dict | None = None, xid: str = "") -> StateSender:
        if not xid:
            self._xid_seq += 1
            xid = f"{kind}-{self._xid_seq}"
        s = StateSender(self.transport, dst, xid, data, kind=kind,
                        meta=meta, chunk_size=self.chunk_size,
                        window=self.window, clock=self.clock)
        self.senders[(dst, xid)] = s
        return s

    def handle(self, msg) -> bool:
        """Route one fabric message; True when it was handoff traffic."""
        if msg.kind == KIND_MANIFEST:
            self.receiver.set_manifest(msg.src, msg.body)
        elif msg.kind == KIND_CHUNK:
            self.receiver.accept_chunk(msg.src, msg.body)
        elif msg.kind == KIND_ACK:
            s = self.senders.get((msg.src, str(msg.body.get("xid", ""))))
            if s is not None:
                s.on_ack(msg.body)
        else:
            return False
        return True

    def pump(self, now: float | None = None) -> int:
        sent = 0
        for key in sorted(self.senders):
            sent += self.senders[key].pump(now)
        return sent

    def prune(self) -> None:
        self.senders = {k: s for k, s in self.senders.items() if not s.done}

    def stats(self) -> dict:
        out = dict(self.receiver.stats)
        out["tx_chunks"] = sum(s.stats["tx_chunks"]
                               for s in self.senders.values())
        out["retx_chunks"] = sum(s.stats["retx_chunks"]
                                 for s in self.senders.values())
        out["senders_done"] = sum(1 for s in self.senders.values() if s.done)
        out["senders_live"] = sum(1 for s in self.senders.values()
                                  if not s.done)
        return out
