"""AF_XDP socket ladder + wire pump — the wire attach path with
graceful fallback and the batch-native pump that feeds it (copy of
`bng_tpu/runtime/xsk.py`).

Role parity: pkg/ebpf/loader.go:294-315 attaches XDP driver-mode first,
falls back to generic mode, then to a stub on dev machines. Here the
rungs are AF_XDP bind modes feeding the dataplane's UMEM
(csrc/bngxsk.cpp, built with g++ at first use by runtime/nativelib.py):

    zerocopy  NIC DMA straight into the bngring UMEM (production NICs)
    copy      generic AF_XDP, one kernel copy (veth/dev kernels)
    memory    no AF_XDP (containers without CAP_NET_RAW, CI, macOS):
              the in-memory bngring alone — synthetic sources and the
              wire pump keep the same API

`open_wire(ring, ifname)` walks the ladder and reports which rung it
landed on; every consumer keeps working on any rung.

The WIRE PUMP is the glue loop on a live rung: feed the
kernel fill ring from the ring's free pool, drain kernel RX into the
ring (classification/steering happen there), move TX/FWD verdict
descriptors to the kernel TX ring, and reap completions back to the
pool. Two implementations behind ``BNG_WIRE_PUMP`` (resolved at
construction, snapshotted per pump):

- ``scalar`` (default) — the original per-frame ctypes loop: reserve
  per frame, normalize copy-mode headroom with a per-frame memmove,
  submit per frame, pop TX descriptors per frame. This is the A/B
  baseline cohort and the bit-identity oracle.
- ``vector`` — a handful of array-in/array-out ctypes calls over the
  native batch verbs (bngring.h rx_reserve_batch / rx_submit_batch /
  frame_free_batch / out_pop_desc_batch): headroom-aware descriptors
  make the per-frame memmove disappear entirely, and no per-frame
  Python runs on the unpressured path.

Chaos-armed rounds (faults.any_armed()) force the scalar path so
per-call fault-point hit accounting is preserved — the
fleet/admission discipline. The pump's two phases are named telemetry
stages (``wire_rx`` / ``wire_tx``, spans.py) with DEFAULT_SLOS budgets,
so the kernel<->UMEM hop answers to the same SLO gate as every other
stage (Dapper: the unbudgeted stage is where the regression hides).
"""

from __future__ import annotations

import ctypes as C
import os
from collections import deque
from dataclasses import dataclass

import numpy as np

from bng_tpu_torch.chaos import faults
from bng_tpu_torch.runtime import nativelib
from bng_tpu_torch.telemetry import spans as tele

MODE_ZEROCOPY = "zerocopy"
MODE_COPY = "copy"
MODE_MEMORY = "memory"

_U64_MAX = 0xFFFFFFFFFFFFFFFF

_ERRS = {
    -1: "socket(AF_XDP) failed (kernel support / CAP_NET_RAW)",
    -2: "UMEM registration rejected",
    -3: "ring setsockopts failed",
    -4: "ring mmap failed",
    -5: "interface not found",
    -6: "bind failed in both zerocopy and copy modes",
}

# ---------------------------------------------------------------------------
# pump path selection (the BNG_TABLE_IMPL mold)
# ---------------------------------------------------------------------------

WIRE_PUMPS = ("scalar", "vector")

# Default from BNG_WIRE_PUMP; "scalar" until the vector cohort has
# baselined in the ledger (flip once --wire-ab history exists — the
# flip-after-measurement discipline every impl selector follows).
WIRE_PUMP = os.environ.get("BNG_WIRE_PUMP", "scalar")


def resolved_wire_pump() -> str:
    """The pump path WirePump constructions resolve against. Resolution
    happens at CONSTRUCTION time (snapshotted per pump instance): an
    env flip after construction needs a new attach."""
    if WIRE_PUMP not in WIRE_PUMPS:
        raise ValueError(
            f"BNG_WIRE_PUMP={WIRE_PUMP!r}: expected one of {WIRE_PUMPS}")
    return WIRE_PUMP


def current_wire_pump_label() -> str:
    """Best-effort label for fingerprints/bench lines — never raises
    (ledger.environment_fingerprint calls this via sys.modules)."""
    try:
        return resolved_wire_pump()
    except Exception:  # noqa: BLE001 — a bad env var must not sink a line
        return WIRE_PUMP


def _configure(lib: C.CDLL) -> None:
    lib.bng_xsk_probe.restype = C.c_int
    lib.bng_xsk_probe.argtypes = []
    lib.bng_xsk_open.restype = C.c_void_p
    lib.bng_xsk_open.argtypes = [C.c_char_p, C.c_uint32, C.c_void_p,
                                 C.c_uint64, C.c_uint32, C.c_uint32,
                                 C.POINTER(C.c_int)]
    lib.bng_xsk_mode.restype = C.c_int
    lib.bng_xsk_mode.argtypes = [C.c_void_p]
    lib.bng_xsk_fd.restype = C.c_int
    lib.bng_xsk_fd.argtypes = [C.c_void_p]
    lib.bng_xsk_close.argtypes = [C.c_void_p]
    lib.bng_xsk_fill.restype = C.c_uint32
    lib.bng_xsk_fill.argtypes = [C.c_void_p, C.POINTER(C.c_uint64), C.c_uint32]
    lib.bng_xsk_rx.restype = C.c_uint32
    lib.bng_xsk_rx.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                               C.POINTER(C.c_uint32), C.c_uint32]
    lib.bng_xsk_tx.restype = C.c_uint32
    lib.bng_xsk_tx.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                               C.POINTER(C.c_uint32), C.c_uint32]
    lib.bng_xsk_complete.restype = C.c_uint32
    lib.bng_xsk_complete.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                                     C.c_uint32]


def load_native():
    """Load (building if needed) the xsk library, or None off-Linux."""
    return nativelib.load("bngxsk", _configure)


def probe() -> str:
    """Cheapest rung check: can this kernel/container create an AF_XDP
    socket at all? (One syscall, no interface required.)"""
    lib = load_native()
    if lib is None:
        return MODE_MEMORY
    mode = lib.bng_xsk_probe()
    return MODE_MEMORY if mode == 2 else MODE_COPY


@dataclass
class WireAttachment:
    """Result of walking the attach ladder."""

    mode: str  # zerocopy | copy | memory
    xsk: "XskSocket | None"  # None on the memory rung
    detail: str = ""


def _u64p(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint64))


def _u32p(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint32))


# ---------------------------------------------------------------------------
# kernel ports: the four AF_XDP ring verbs the pump moves frames through
# ---------------------------------------------------------------------------

class XskKernel:
    """The real kernel's rings, via the native bngxsk verbs. Array
    arguments are NumPy buffers owned by the pump (zero per-call
    allocation); every method is one ctypes call."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    def fill(self, addrs: np.ndarray, n: int) -> int:
        return int(self._lib.bng_xsk_fill(self._h, _u64p(addrs), n))

    def rx(self, out_addrs: np.ndarray, out_lens: np.ndarray) -> int:
        return int(self._lib.bng_xsk_rx(self._h, _u64p(out_addrs),
                                        _u32p(out_lens), len(out_addrs)))

    def tx(self, addrs: np.ndarray, lens: np.ndarray, n: int) -> int:
        return int(self._lib.bng_xsk_tx(self._h, _u64p(addrs),
                                        _u32p(lens), n))

    def complete(self, out_addrs: np.ndarray) -> int:
        return int(self._lib.bng_xsk_complete(self._h, _u64p(out_addrs),
                                              len(out_addrs)))


class _FifoU64:
    """Fixed-capacity NumPy FIFO — SimKernelRings' ring storage. Bulk
    push/pop so the sim kernel's verbs cost the same O(1)-ish work for
    both pump cohorts (a per-frame sim would dilute the A/B ratio)."""

    def __init__(self, cap: int, dtype=np.uint64):
        self.buf = np.zeros(cap, dtype=dtype)
        self.cap = cap
        self.h = 0
        self.n = 0

    def push(self, arr: np.ndarray, k: int) -> int:
        k = min(k, self.cap - self.n)
        if k:
            pos = (self.h + self.n + np.arange(k)) % self.cap
            self.buf[pos] = arr[:k]
            self.n += k
        return k

    def pop_into(self, out: np.ndarray, k: int) -> int:
        k = min(k, self.n)
        if k:
            pos = (self.h + np.arange(k)) % self.cap
            out[:k] = self.buf[pos]
            self.h = (self.h + k) % self.cap
            self.n -= k
        return k


class SimKernelRings:
    """Deterministic in-process stand-in for the kernel's AF_XDP rings —
    the memory rung's wire kernel (tests, the smoke's wire phases,
    `loadtest --wire` without privileges).

    Same four verbs as XskKernel over the ring's REAL UMEM: fill
    stockpiles the pump's free frames, `inject()` plays the far end of
    the wire (frames land at chunk_base + headroom, the copy-mode
    shape), rx hands the pump headroom-offset descriptors, tx reads
    egress frames out of the UMEM, complete reports them sent. Fault
    knobs drive the identity corpus: ``tx_room`` throttles the TX ring
    (kernel TX stall), ``inject(..., claim_len=)`` forges a corrupt RX
    descriptor length (the kernel-misbehavior guard the leak fix pins).

    CONTRACT: delivery happens at inject() time (the far end produces
    asynchronously, outside pump cost), and ``drain_egress()`` must be
    called after a pump round BEFORE the next inject — a completed
    frame returns to the free pool and may be refilled/overwritten.
    """

    def __init__(self, ring, headroom: int = 256, ring_size: int = 2048,
                 tx_room: int | None = None):
        self.umem = ring.umem_view()  # NativeRing only
        self.frame_size = ring.frame_size
        self.headroom = min(headroom, ring.frame_size - 64)
        self.ring_size = ring_size
        self.tx_room = tx_room  # None = no stall
        self._fill = _FifoU64(ring_size)
        self._rx_a = _FifoU64(ring_size)
        self._rx_l = _FifoU64(ring_size, dtype=np.uint32)
        self._cq = _FifoU64(ring_size)
        self._pending: deque = deque()  # injected frames awaiting fill
        self._sent_a: list[int] = []
        self._sent_l: list[int] = []

    # -- far end ----------------------------------------------------------

    def inject(self, frame: bytes, claim_len: int | None = None) -> None:
        """Queue one far-end frame; delivered into UMEM as soon as a
        fill address is available (outside pump laps by contract)."""
        self._pending.append((bytes(frame), claim_len))
        self._deliver()

    def inject_many(self, frames) -> None:
        self._pending.extend((bytes(f), None) for f in frames)
        self._deliver()

    def _deliver(self) -> None:
        one_a = np.zeros(1, dtype=np.uint64)
        one_l = np.zeros(1, dtype=np.uint32)
        while self._pending and self._fill.n:
            if self._rx_a.n >= self.ring_size:
                break  # RX ring full: the real kernel would drop — hold
            frame, claim = self._pending.popleft()
            self._fill.pop_into(one_a, 1)
            base = int(one_a[0])
            room = self.frame_size - self.headroom
            data = frame[:room]
            a = base + self.headroom
            self.umem[a:a + len(data)] = np.frombuffer(data, dtype=np.uint8)
            one_a[0] = a
            one_l[0] = claim if claim is not None else len(data)
            self._rx_a.push(one_a, 1)
            self._rx_l.push(one_l, 1)

    def deliver(self) -> None:
        """Public poke: deliver pending injected frames with whatever
        fill addresses the last pump round stocked (drivers that inject
        before the first fill call this between pump rounds, outside
        the pump's laps by contract)."""
        self._deliver()

    def drain_egress(self) -> list[bytes]:
        """Frames that left the wire since the last drain, TX order.
        Reads the UMEM NOW — call before the next inject round."""
        out = [bytes(self.umem[a:a + ln])
               for a, ln in zip(self._sent_a, self._sent_l)]
        self._sent_a.clear()
        self._sent_l.clear()
        return out

    # -- the four kernel verbs (pump side) --------------------------------

    def fill(self, addrs: np.ndarray, n: int) -> int:
        taken = self._fill.push(addrs, n)
        return taken

    def rx(self, out_addrs: np.ndarray, out_lens: np.ndarray) -> int:
        n = self._rx_a.pop_into(out_addrs, len(out_addrs))
        self._rx_l.pop_into(out_lens, n)
        return n

    def tx(self, addrs: np.ndarray, lens: np.ndarray, n: int) -> int:
        if self.tx_room is not None:
            n = min(n, self.tx_room)
        n = min(n, self._cq.cap - self._cq.n)
        if n:
            self._sent_a.extend(int(a) for a in addrs[:n])
            self._sent_l.extend(int(x) for x in lens[:n])
            self._cq.push(addrs, n)
        return n

    def complete(self, out_addrs: np.ndarray) -> int:
        return self._cq.pop_into(out_addrs, len(out_addrs))


# ---------------------------------------------------------------------------
# the pump
# ---------------------------------------------------------------------------

class WirePump:
    """One wire-pump loop over (ring, kernel) — see the module
    docstring. ``pump()`` runs one round of four phases:

        (a) feed the kernel fill ring from the ring free pool
        (b) drain kernel RX -> ring submit (zero-copy: the frame is
            already in UMEM; classification/steering run in the ring)
        (c) TX/FWD verdict descriptors -> kernel TX ring (zero-copy)
        (d) reap TX completions -> frames back to the free pool

    (a)+(b) lap the ``wire_rx`` stage, (c)+(d) ``wire_tx``. Returns
    frames moved (rx + tx).

    ``_tx_pending`` (descriptors the kernel TX ring refused) is bounded
    by ``tx_pending_cap``: overflow frames are DROPPED back to the free
    pool and counted (``tx_overflow`` in pump_stats + the bng_wire_*
    family) instead of growing without limit under a kernel TX stall —
    the frames are retransmit-recoverable, the memory is not.
    """

    def __init__(self, ring, kernel, path: str | None = None,
                 tx_pending_cap: int = 4096):
        if not hasattr(ring, "umem_view"):
            raise ValueError("WirePump needs a NativeRing (UMEM-backed)")
        self.ring = ring
        self.kernel = kernel
        self.path = path or resolved_wire_pump()
        if self.path not in WIRE_PUMPS:
            raise ValueError(f"unknown wire pump {self.path!r}: "
                             f"expected one of {WIRE_PUMPS}")
        self.tx_pending_cap = int(tx_pending_cap)
        self.last_path = self.path  # what the LAST round actually ran
        self._txq: list[tuple[int, int]] = []  # (addr, len) awaiting slots
        self.pump_stats = {"filled": 0, "rx": 0, "tx": 0, "completed": 0,
                           "rx_submit_fail": 0, "tx_overflow": 0}
        self._cap = 0  # scratch capacity (grown to the largest budget)

    def tx_pending(self) -> int:
        """Verdict descriptors awaiting kernel TX slots (bounded by
        tx_pending_cap) — the bng_wire_tx_pending gauge's source."""
        return len(self._txq)

    # -- scratch ----------------------------------------------------------

    def _ensure(self, budget: int) -> None:
        if budget <= self._cap:
            return
        self._cap = budget
        self._ra = np.zeros(budget, dtype=np.uint64)   # reserve/fill
        self._rxa = np.zeros(budget, dtype=np.uint64)  # kernel RX addrs
        self._rxl = np.zeros(budget, dtype=np.uint32)  # kernel RX lens
        self._ok = np.zeros(budget, dtype=np.uint8)    # submit outcomes
        self._ta = np.zeros(budget, dtype=np.uint64)   # TX addrs
        self._tl = np.zeros(budget, dtype=np.uint32)   # TX lens
        self._ca = np.zeros(budget, dtype=np.uint64)   # completions

    # -- entry ------------------------------------------------------------

    def pump(self, budget: int = 64, from_access: bool = True) -> int:
        """One wire-pump round; returns frames moved (rx + tx)."""
        self._ensure(budget)
        if (self.path == "vector" and not faults.any_armed()):
            # chaos-armed rounds take the scalar oracle so per-call
            # fault-point hit accounting is preserved (the fleet's mold)
            self.last_path = "vector"
            return self._pump_vector(budget, from_access)
        self.last_path = "scalar"
        return self._pump_scalar(budget, from_access)

    # -- scalar (the per-frame oracle) ------------------------------------

    def _pump_scalar(self, budget: int, from_access: bool) -> int:
        ring, kernel, st = self.ring, self.kernel, self.pump_stats
        rlib, rh = ring._lib, ring._h
        fsz = ring.frame_size
        moved = 0
        t0 = tele.t()
        # (a) fill
        addrs = []
        for _ in range(budget):
            a = rlib.bng_ring_rx_reserve(rh)
            if a == _U64_MAX:
                break
            addrs.append(a)
        if addrs:
            arr = np.array(addrs, dtype=np.uint64)
            pushed = kernel.fill(arr, len(addrs))
            st["filled"] += pushed
            for a in addrs[pushed:]:  # fill ring full: hand frames back
                rlib.bng_ring_frame_free(rh, a)
        # (b) RX. The kernel places the packet at chunk_base + headroom
        # and reports THAT address; the scalar path keeps chunk-based
        # descriptors (the historical shape), so normalize: slide the
        # bytes to the chunk start and submit the base. The vector path
        # submits the offset address as-is (headroom-aware descriptors)
        # and skips this memmove entirely.
        n = kernel.rx(self._rxa[:budget], self._rxl[:budget])
        fl = 0x1 if from_access else 0  # FLAG_FROM_ACCESS
        umem_base = C.addressof(ring.umem_ptr.contents)
        usz = ring.umem_size
        for i in range(n):
            a = int(self._rxa[i])
            ln = int(self._rxl[i])
            if a >= usz:
                # garbage descriptor address (kernel misbehavior):
                # nothing of ours to recycle — frame_free counts the
                # ring's bad_desc like the vector path's
                # rx_submit_batch, and memmove must never see it
                st["rx_submit_fail"] += 1
                rlib.bng_ring_frame_free(rh, a)
                continue
            off = a % fsz
            base = a - off
            if ln > fsz - off:
                # a length that cannot fit the chunk room (kernel
                # misbehavior): drop AND return the frame — an
                # unreturned frame drains the fill pool permanently
                st["rx_submit_fail"] += 1
                rlib.bng_ring_frame_free(rh, base)
                continue
            if off:
                C.memmove(umem_base + base, umem_base + a, ln)
            if rlib.bng_ring_rx_submit(rh, base, ln, fl) != 0:
                # rx-full: bngring recycled the frame internally — the
                # pool is whole either way
                st["rx_submit_fail"] += 1
        st["rx"] += n
        moved += n
        tele.lap(tele.WIRE_RX, t0)
        t0 = tele.t()
        # (c) TX: retries first, then fresh verdict descriptors
        txq = self._txq
        addr = C.c_uint64()
        ln_c = C.c_uint32()
        while len(txq) < budget:
            got = rlib.bng_ring_tx_pop_desc(rh, C.byref(addr),
                                            C.byref(ln_c), None)
            if not got:
                got = rlib.bng_ring_fwd_pop_desc(rh, C.byref(addr),
                                                 C.byref(ln_c), None)
            if not got:
                break
            txq.append((addr.value, ln_c.value))
        if txq:
            k = len(txq)
            self._ensure(k)
            self._ta[:k] = [a for a, _ in txq]
            self._tl[:k] = [l for _, l in txq]
            sent = kernel.tx(self._ta, self._tl, k)
            st["tx"] += sent
            moved += sent
            del txq[:sent]  # unsent stay pending for the next round
        self._bound_pending()
        # (d) completions
        c = kernel.complete(self._ca[:budget])
        for i in range(c):
            a = int(self._ca[i])
            rlib.bng_ring_frame_free(rh, a - a % fsz)
        st["completed"] += c
        tele.lap(tele.WIRE_TX, t0)
        return moved

    def _bound_pending(self) -> None:
        """Satellite: the pending-TX queue is explicitly bounded. Frames
        beyond the cap (kernel TX stalled for multiple rounds) drop back
        to the free pool, newest first, and are counted."""
        txq = self._txq
        cap = self.tx_pending_cap
        if len(txq) <= cap:
            return
        drop = txq[cap:]
        del txq[cap:]
        k = len(drop)
        drop_a = np.array([a for a, _ in drop], dtype=np.uint64)
        self.ring.frame_free_batch(drop_a, k)
        self.pump_stats["tx_overflow"] += k

    # -- vector (array-in/array-out over the native batch verbs) ----------

    def _pump_vector(self, budget: int, from_access: bool) -> int:
        ring, kernel, st = self.ring, self.kernel, self.pump_stats
        moved = 0
        t0 = tele.t()
        # (a) fill: one reserve call, one kernel call, one free call
        m = ring.rx_reserve_batch(self._ra[:budget])
        if m:
            pushed = kernel.fill(self._ra, m)
            st["filled"] += pushed
            if pushed < m:
                ring.frame_free_batch(self._ra[pushed:m], m - pushed)
        # (b) RX -> submit: headroom-offset addresses go in as-is; every
        # failed frame is recycled inside the ring verb
        n = kernel.rx(self._rxa[:budget], self._rxl[:budget])
        if n:
            fl = 0x1 if from_access else 0
            ok = ring.rx_submit_batch(self._rxa, self._rxl, fl,
                                      self._ok, n)
            st["rx_submit_fail"] += n - ok
        st["rx"] += n
        moved += n
        tele.lap(tele.WIRE_RX, t0)
        t0 = tele.t()
        # (c) TX: pending retries first (rare — kernel stalls), then one
        # batch pop of fresh verdict descriptors
        txq = self._txq
        p = len(txq)
        if p:
            self._ensure(p + budget)
            self._ta[:p] = np.array([a for a, _ in txq], dtype=np.uint64)
            self._tl[:p] = np.array([l for _, l in txq], dtype=np.uint32)
            txq.clear()
        fresh = ring.out_pop_desc_batch(self._ta[p:], self._tl[p:],
                                        max(0, budget - p))
        k = p + fresh
        if k:
            sent = kernel.tx(self._ta, self._tl, k)
            st["tx"] += sent
            moved += sent
            if sent < k:  # kernel TX stalled: keep the tail pending
                txq.extend(zip(self._ta[sent:k].tolist(),
                               self._tl[sent:k].tolist()))
                self._bound_pending()
        # (d) completions: one kernel call, one batch free
        c = kernel.complete(self._ca[:budget])
        if c:
            ring.frame_free_batch(self._ca, c)
            st["completed"] += c
        tele.lap(tele.WIRE_TX, t0)
        return moved


class XskSocket:
    """A bound AF_XDP socket over a NativeRing's UMEM."""

    def __init__(self, lib, handle, ring, pump_path: str | None = None):
        self._lib = lib
        self._h = handle
        self.ring = ring  # keeps the UMEM alive
        self.mode = MODE_ZEROCOPY if lib.bng_xsk_mode(handle) == 0 else MODE_COPY
        self.kernel = XskKernel(lib, handle)
        self.wire_pump = WirePump(ring, self.kernel, path=pump_path)

    def pump(self, budget: int = 64, from_access: bool = True) -> int:
        """One wire-pump round (see WirePump.pump)."""
        return self.wire_pump.pump(budget, from_access=from_access)

    @property
    def pump_stats(self) -> dict:
        return self.wire_pump.pump_stats

    @property
    def pump_path(self) -> str:
        return self.wire_pump.path

    @property
    def fd(self) -> int:
        return self._lib.bng_xsk_fd(self._h)

    def close(self) -> None:
        if self._h is not None:
            self._lib.bng_xsk_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def open_wire(ring, ifname: str = "", queue: int = 0,
              ring_size: int = 2048,
              pump_path: str | None = None) -> WireAttachment:
    """Walk the attach ladder for `ring` (a NativeRing or PyRing).

    With a NativeRing and a usable NIC queue this binds AF_XDP over the
    ring's UMEM (zerocopy, then copy). Anything else lands on the memory
    rung: the in-memory ring keeps serving the same assemble/complete API
    (the reference's stub rung, loader.go:312-315). ``pump_path``
    overrides BNG_WIRE_PUMP for the attached socket's pump.
    """
    if not ifname:
        return WireAttachment(MODE_MEMORY, None, "no interface requested")
    lib = load_native()
    if lib is None:
        return WireAttachment(MODE_MEMORY, None, "no native xsk library")
    umem = getattr(ring, "umem_ptr", None)
    if umem is None:
        return WireAttachment(MODE_MEMORY, None,
                              "ring has no native UMEM (PyRing)")
    err = C.c_int(0)
    h = lib.bng_xsk_open(ifname.encode(), queue, umem,
                         ring.umem_size, ring.frame_size, ring_size,
                         C.byref(err))
    if not h:
        detail = _ERRS.get(err.value, f"error {err.value}")
        return WireAttachment(MODE_MEMORY, None,
                              f"AF_XDP open on {ifname!r} failed: {detail}")
    sock = XskSocket(lib, h, ring, pump_path=pump_path)
    return WireAttachment(sock.mode, sock, f"bound {ifname}:{queue}")
