"""Packet rings for the engine's ring loops (port of
`bng_tpu/runtime/ring.py`).

- `NativeRing`: the reference's C++ ring (`csrc/bngring.{h,cpp}`, a
  byte-for-byte copy of `native/bngring.{h,cpp}`), an AF_XDP-style UMEM
  with SPSC descriptor rings, bound with ctypes. `runtime/nativelib.py`
  builds it with `g++` at first use into `bng_tpu_torch/_build/`.
- `PyRing`: the same API in Python, with two host paths
  (`BNG_HOST_PATH` or the `host_path` argument): `scalar`, the per-frame
  oracle over deques, and `vector`, a structure-of-arrays store that
  classifies, steers, stages and demuxes whole batches with numpy
  (`runtime/hostpath.py`) and falls back to the scalar decisions under
  pressure exactly where the reference does.
- `make_ring` gives a `NativeRing` when the library loads, else a
  `PyRing`.

A ring has `n_shards` RX queues: `shard_of` steers each frame to its
owner shard (the sharded step's placement: upstream by FNV-1a32 of the
source IP, downstream by NAT public-IP ownership, else by the destination
IP, DHCP control and non-IPv4 by the source MAC), and `assemble_sharded`
lays shard i's lanes at rows i*b..(i+1)*b.
"""

from __future__ import annotations

import ctypes as C
from collections import deque

import numpy as np

from bng_tpu_torch.runtime import hostpath, nativelib
from bng_tpu_torch.utils.net import fnv1a32

FLAG_FROM_ACCESS = 0x1
# set by the ring on RX when the frame parses as IPv4/UDP dst:67 — the
# consumer may route an all-control batch through the DHCP-only device
# program (BNG_DESC_F_DHCP_CTRL in bngring.h)
FLAG_DHCP_CTRL = 0x2

# the vectorized kernels redeclare the flag bits (circular-import break);
# a drift here would silently mis-classify the whole vector path
assert hostpath.FLAG_FROM_ACCESS == FLAG_FROM_ACCESS
assert hostpath.FLAG_DHCP_CTRL == FLAG_DHCP_CTRL

VERDICT_PASS, VERDICT_DROP, VERDICT_TX, VERDICT_FWD = 0, 1, 2, 3


def classify_dhcp(frame: bytes) -> int:
    """Genuine-DHCP classifier (0-2 VLAN tags) — the PyRing mirror of
    bngring.cpp's classify_dhcp; must agree bit-for-bit. Strict on
    purpose: IPv4 non-fragment UDP dst:67 with BOOTREQUEST op AND the
    DHCP magic cookie — natable port-67 transit, fragments, and non-DHCP
    floods stay on the fused pipeline (NAT/antispoof/QoS treatment).
    Callers gate on from_access (the fused path only answers access-side
    DHCP: dhcp_tx = is_reply & from_access)."""
    if len(frame) < 14:
        return 0
    off = 12
    et = (frame[off] << 8) | frame[off + 1]
    for _ in range(2):
        if et not in (0x8100, 0x88A8):
            break
        off += 4
        if len(frame) < off + 2:
            return 0
        et = (frame[off] << 8) | frame[off + 1]
    off += 2  # L3 start
    if et != 0x0800 or len(frame) < off + 20 or (frame[off] >> 4) != 4:
        return 0
    ihl = (frame[off] & 0x0F) * 4
    if ihl < 20 or frame[off + 9] != 17:
        return 0
    if ((frame[off + 6] << 8) | frame[off + 7]) & 0x3FFF:
        return 0  # fragmented: no parseable L4
    l4 = off + ihl
    if len(frame) < l4 + 8:
        return 0
    dport = (frame[l4 + 2] << 8) | frame[l4 + 3]
    if dport != 67:
        return 0
    bootp = l4 + 8
    if len(frame) < bootp + 240 or frame[bootp] != 1:
        return 0
    magic = int.from_bytes(frame[bootp + 236 : bootp + 240], "big")
    return FLAG_DHCP_CTRL if magic == 0x63825363 else 0


def shard_of(frame: bytes, flags: int, n_shards: int,
             pub_ips: dict[int, int] | None = None) -> int:
    """Owner-shard steering decision — the PyRing mirror of bngring.cpp's
    bng_ring_shard_of; must agree bit-for-bit (spec in bngring.h).

    The subscriber-affinity placement chip-local NAT/QoS/antispoof state
    depends on (parallel/sharded.py): upstream by FNV-1a32(src IP),
    downstream by NAT-public-IP ownership (pub_ips: host-order IP ->
    shard) falling back to FNV-1a32(dst IP), DHCP-control and non-IPv4
    frames by FNV-1a32(src MAC). `flags` are the descriptor flags AFTER
    classification (FROM_ACCESS | DHCP_CTRL)."""
    if n_shards == 1 or len(frame) < 14:
        return 0
    if not (flags & FLAG_DHCP_CTRL):
        off = 12
        et = (frame[off] << 8) | frame[off + 1]
        for _ in range(2):
            if et not in (0x8100, 0x88A8):
                break
            off += 4
            if len(frame) < off + 2:
                break
            et = (frame[off] << 8) | frame[off + 1]
        off += 2  # L3 start
        if et == 0x0800 and len(frame) >= off + 20 and (frame[off] >> 4) == 4:
            if flags & FLAG_FROM_ACCESS:
                return fnv1a32(frame[off + 12 : off + 16]) % n_shards
            dst = frame[off + 16 : off + 20]
            if pub_ips:
                s = pub_ips.get(int.from_bytes(dst, "big"))
                if s is not None and s < n_shards:
                    return s
            return fnv1a32(dst) % n_shards
        if (et == 0x8864 and (flags & FLAG_FROM_ACCESS)
                and len(frame) >= off + 8 + 20
                and frame[off] == 0x11 and frame[off + 1] == 0
                and ((frame[off + 6] << 8) | frame[off + 7]) == 0x0021
                and (frame[off + 8] >> 4) == 4):
            # PPPoE session DATA (PPP proto IPv4): steer by the INNER
            # source IP — the same affinity key the decap'd packet's
            # chip-local NAT/QoS/session state is placed with. PPPoE
            # control (discovery/LCP/auth/IPCP) falls through to the
            # sticky MAC hash; any shard's slow path handles it.
            return fnv1a32(frame[off + 8 + 12 : off + 8 + 16]) % n_shards
    return fnv1a32(frame[6:12]) % n_shards


class RingStats(C.Structure):
    _fields_ = [
        ("rx", C.c_uint64),
        ("tx", C.c_uint64),
        ("fwd", C.c_uint64),
        ("drop", C.c_uint64),
        ("slow", C.c_uint64),
        ("fill_empty", C.c_uint64),
        ("rx_full", C.c_uint64),
        ("tx_full", C.c_uint64),
        ("bad_desc", C.c_uint64),
    ]


class Desc(C.Structure):
    """Python mirror of bng_desc — layout asserted against the C side."""

    _fields_ = [
        ("addr", C.c_uint64),
        ("len", C.c_uint32),
        ("flags", C.c_uint32),
    ]


def _configure(lib: C.CDLL) -> None:
    lib.bng_ring_create.restype = C.c_void_p
    lib.bng_ring_create.argtypes = [C.c_uint32, C.c_uint32, C.c_uint32]
    lib.bng_ring_destroy.argtypes = [C.c_void_p]
    lib.bng_ring_umem.restype = C.POINTER(C.c_uint8)
    lib.bng_ring_umem.argtypes = [C.c_void_p]
    lib.bng_ring_umem_size.restype = C.c_uint64
    lib.bng_ring_umem_size.argtypes = [C.c_void_p]
    lib.bng_ring_frame_size.restype = C.c_uint32
    lib.bng_ring_frame_size.argtypes = [C.c_void_p]
    lib.bng_ring_rx_push.restype = C.c_int
    lib.bng_ring_rx_push.argtypes = [C.c_void_p, C.POINTER(C.c_uint8),
                                     C.c_uint32, C.c_uint32]
    lib.bng_batch_assemble.restype = C.c_uint32
    lib.bng_batch_assemble.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint8), C.POINTER(C.c_uint32),
        C.POINTER(C.c_uint32), C.c_uint32, C.c_uint32]
    lib.bng_ring_create_sharded.restype = C.c_void_p
    lib.bng_ring_create_sharded.argtypes = [C.c_uint32, C.c_uint32,
                                            C.c_uint32, C.c_uint32]
    lib.bng_ring_n_shards.restype = C.c_uint32
    lib.bng_ring_n_shards.argtypes = [C.c_void_p]
    lib.bng_ring_steer_pub_ip.restype = C.c_int
    lib.bng_ring_steer_pub_ip.argtypes = [C.c_void_p, C.c_uint32, C.c_uint32]
    lib.bng_ring_shard_of.restype = C.c_uint32
    lib.bng_ring_shard_of.argtypes = [C.c_void_p, C.POINTER(C.c_uint8),
                                      C.c_uint32, C.c_uint32]
    lib.bng_batch_assemble_sharded.restype = C.c_uint32
    lib.bng_batch_assemble_sharded.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint8), C.POINTER(C.c_uint32),
        C.POINTER(C.c_uint32), C.c_uint32, C.c_uint32]
    lib.bng_ring_shard_rx_pending.restype = C.c_uint32
    lib.bng_ring_shard_rx_pending.argtypes = [C.c_void_p, C.c_uint32]
    lib.bng_ring_rx_reserve.restype = C.c_uint64
    lib.bng_ring_rx_reserve.argtypes = [C.c_void_p]
    lib.bng_ring_rx_submit.restype = C.c_int
    lib.bng_ring_rx_submit.argtypes = [C.c_void_p, C.c_uint64, C.c_uint32,
                                       C.c_uint32]
    # batch wire verbs (the AF_XDP wire pump)
    lib.bng_ring_rx_reserve_batch.restype = C.c_uint32
    lib.bng_ring_rx_reserve_batch.argtypes = [C.c_void_p,
                                              C.POINTER(C.c_uint64),
                                              C.c_uint32]
    lib.bng_ring_rx_submit_batch.restype = C.c_uint32
    lib.bng_ring_rx_submit_batch.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint64), C.POINTER(C.c_uint32),
        C.c_uint32, C.POINTER(C.c_uint8), C.c_uint32]
    lib.bng_ring_frame_free_batch.restype = C.c_uint32
    lib.bng_ring_frame_free_batch.argtypes = [C.c_void_p,
                                              C.POINTER(C.c_uint64),
                                              C.c_uint32]
    lib.bng_ring_out_pop_desc_batch.restype = C.c_uint32
    lib.bng_ring_out_pop_desc_batch.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint64), C.POINTER(C.c_uint32),
        C.c_uint32]
    for name in ("tx_pop_desc", "fwd_pop_desc"):
        fn = getattr(lib, f"bng_ring_{name}")
        fn.restype = C.c_int
        fn.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                       C.POINTER(C.c_uint32), C.POINTER(C.c_uint32)]
    lib.bng_ring_frame_free.restype = C.c_int
    lib.bng_ring_frame_free.argtypes = [C.c_void_p, C.c_uint64]
    lib.bng_ring_tx_inject.restype = C.c_int
    lib.bng_ring_tx_inject.argtypes = [C.c_void_p, C.POINTER(C.c_uint8),
                                       C.c_uint32, C.c_uint32]
    lib.bng_batch_complete.restype = C.c_int
    lib.bng_batch_complete.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint8), C.POINTER(C.c_uint8),
        C.POINTER(C.c_uint32), C.c_uint32, C.c_uint32]
    for name in ("tx", "fwd", "slow"):
        fn = getattr(lib, f"bng_ring_{name}_pop")
        fn.restype = C.c_int
        fn.argtypes = [C.c_void_p, C.POINTER(C.c_uint8), C.c_uint32,
                       C.POINTER(C.c_uint32)]
    for name in ("rx_pending", "tx_pending", "fwd_pending",
                 "slow_pending", "free_frames"):
        fn = getattr(lib, f"bng_ring_{name}")
        fn.restype = C.c_uint32
        fn.argtypes = [C.c_void_p]
    lib.bng_ring_get_stats.argtypes = [C.c_void_p, C.POINTER(RingStats)]
    lib.bng_wire_pump.restype = C.c_int
    lib.bng_wire_pump.argtypes = [C.c_void_p, C.c_void_p, C.c_uint32]
    for name in ("desc_size", "desc_addr_off", "desc_len_off",
                 "desc_flags_off", "stats_size", "version"):
        fn = getattr(lib, f"bng_abi_{name}")
        fn.restype = C.c_uint32
        fn.argtypes = []


def _configure_submit_each(lib: C.CDLL) -> None:
    lib.bng_rx_submit_each.restype = C.c_uint32
    lib.bng_rx_submit_each.argtypes = [
        C.c_void_p, C.c_void_p, C.POINTER(C.c_uint64), C.POINTER(C.c_uint32),
        C.POINTER(C.c_uint32), C.POINTER(C.c_uint8), C.c_uint32]


def load_native():
    """Load (building if needed) the native library, or None."""
    return nativelib.load("bngring", _configure)


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint8))


def _u32p(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint32))


def _u64p(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint64))


class NativeRing:
    """One port's ring pair backed by the C++ UMEM/SPSC implementation."""

    def __init__(self, nframes: int = 4096, frame_size: int = 2048,
                 depth: int = 1024, n_shards: int = 1):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native ring library unavailable")
        self._lib = lib
        self._h = lib.bng_ring_create_sharded(nframes, frame_size, depth,
                                              n_shards)
        if not self._h:
            raise RuntimeError("bng_ring_create failed (sizes must be pow2, "
                               "1 <= n_shards <= 64)")
        self.frame_size = frame_size
        self.depth = depth
        self.n_shards = n_shards

    @property
    def umem_ptr(self):
        """Raw UMEM base pointer (the AF_XDP registration area)."""
        return self._lib.bng_ring_umem(self._h)

    @property
    def umem_size(self) -> int:
        return self._lib.bng_ring_umem_size(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.bng_ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    # -- producer --
    def rx_push(self, frame: bytes, from_access: bool = True) -> bool:
        buf = np.frombuffer(frame, dtype=np.uint8)
        fl = FLAG_FROM_ACCESS if from_access else 0
        return self._lib.bng_ring_rx_push(self._h, _u8p(buf), len(frame), fl) == 0

    def rx_push_batch(self, frames: list[bytes],
                      from_access: bool = True) -> int:
        """Batch producer: classification/steering already happen in C++
        per push, so the native ring just loops; the PyRing vector path
        overrides this with one vectorized classify+steer+stage pass.
        Returns frames accepted (stops at the first refusal, like a
        filling RX ring)."""
        n = 0
        for f in frames:
            if not self.rx_push(f, from_access=from_access):
                break
            n += 1
        return n

    def tx_inject(self, frame: bytes, from_access: bool = True) -> bool:
        buf = np.frombuffer(frame, dtype=np.uint8)
        fl = FLAG_FROM_ACCESS if from_access else 0
        return self._lib.bng_ring_tx_inject(self._h, _u8p(buf), len(frame), fl) == 0

    # -- batch wire verbs (an AF_XDP wire pump) ---------------------------
    def umem_view(self) -> np.ndarray:
        """Zero-copy uint8 view over the whole UMEM (the vector pump's
        and the sim kernel's frame access — no per-frame ctypes)."""
        if self._umem_view is None:
            self._umem_view = np.ctypeslib.as_array(
                self.umem_ptr, shape=(self.umem_size,))
        return self._umem_view

    _umem_view = None

    def rx_reserve_batch(self, out_addrs: np.ndarray) -> int:
        """Pop up to len(out_addrs) free frames into out_addrs (uint64).
        Returns the count reserved (one fill_empty stat on a dry pool)."""
        return int(self._lib.bng_ring_rx_reserve_batch(
            self._h, _u64p(out_addrs), len(out_addrs)))

    def rx_submit_batch(self, addrs: np.ndarray, lens: np.ndarray,
                        flags, out_ok: np.ndarray, n: int) -> int:
        """Submit n received frames. Returns count submitted; out_ok[:n]
        marks per-frame outcomes.

        `flags` one word for the whole batch: the headroom-aware batch
        submit (see bngring.h), every failed frame already recycled to
        the fill pool. `flags` a uint32 array of one word a frame (a
        two-port box's RX, access and core frames interleaved): each
        frame in order as the scalar `rx_submit` takes it (one C loop,
        csrc/ringsubmit.cpp), so the ring holds what `rx_push` of each
        frame with its own direction gives."""
        if np.ndim(flags) == 0:
            return int(self._lib.bng_ring_rx_submit_batch(
                self._h, _u64p(addrs), _u32p(lens), flags, _u8p(out_ok), n))
        each = nativelib.load("ringsubmit", _configure_submit_each)
        if each is None:
            raise RuntimeError("native per-frame submit library unavailable")
        fl = np.ascontiguousarray(flags[:n], dtype=np.uint32)
        return int(each.bng_rx_submit_each(
            self._h, C.cast(self._lib.bng_ring_rx_submit, C.c_void_p), _u64p(addrs),
            _u32p(lens), _u32p(fl), _u8p(out_ok), n))

    def frame_free_batch(self, addrs: np.ndarray, n: int) -> int:
        """Return n frames to the fill pool (chunk-base normalized)."""
        return int(self._lib.bng_ring_frame_free_batch(
            self._h, _u64p(addrs), n))

    def out_pop_desc_batch(self, addrs: np.ndarray, lens: np.ndarray,
                           cap: int) -> int:
        """Drain up to cap TX-then-FWD descriptors (frames stay in
        UMEM). Returns count popped."""
        return int(self._lib.bng_ring_out_pop_desc_batch(
            self._h, _u64p(addrs), _u32p(lens), cap))

    # -- steering --
    def steer_pub_ip(self, ip: int, shard: int) -> bool:
        """Register a NAT public IP (host order) as owned by `shard`."""
        return self._lib.bng_ring_steer_pub_ip(self._h, ip, shard) == 0

    def shard_of(self, frame: bytes, flags: int) -> int:
        buf = np.frombuffer(frame, dtype=np.uint8)
        return int(self._lib.bng_ring_shard_of(self._h, _u8p(buf),
                                               len(frame), flags))

    # -- consumer --
    def assemble(self, out: np.ndarray, out_len: np.ndarray,
                 out_flags: np.ndarray) -> int:
        """Fill out[B, slot] (uint8 C-contiguous) from RX; returns count."""
        B, slot = out.shape
        return int(self._lib.bng_batch_assemble(
            self._h, _u8p(out), _u32p(out_len), _u32p(out_flags), B, slot))

    def assemble_sharded(self, out: np.ndarray, out_len: np.ndarray,
                         out_flags: np.ndarray) -> int:
        """Sharded assemble: out is [n_shards*b, slot]; shard i's lanes land
        at rows i*b..(i+1)*b (ShardedCluster.step's layout), padding rows
        zeroed. Returns the number of REAL frames staged; when nonzero the
        opened window must be completed with n = out.shape[0]."""
        B, slot = out.shape
        if B % self.n_shards:
            raise ValueError(f"batch {B} not divisible by {self.n_shards} shards")
        if B // self.n_shards > self.depth:
            # the C side refuses (total rows > in-flight capacity) by
            # returning 0 — which a caller cannot tell from "no traffic";
            # surface the geometry error loudly instead of stalling forever
            raise ValueError(
                f"b_per_shard {B // self.n_shards} exceeds ring depth "
                f"{self.depth}")
        return int(self._lib.bng_batch_assemble_sharded(
            self._h, _u8p(out), _u32p(out_len), _u32p(out_flags),
            B // self.n_shards, slot))

    def complete(self, verdict: np.ndarray, out: np.ndarray,
                 out_len: np.ndarray, n: int) -> None:
        slot = out.shape[1]
        rc = self._lib.bng_batch_complete(
            self._h, _u8p(verdict.astype(np.uint8, copy=False)), _u8p(out),
            _u32p(out_len), n, slot)
        if rc != 0:
            raise RuntimeError("batch_complete: no batch in flight / n mismatch")

    def _pop(self, which: str) -> tuple[bytes, int] | None:
        # one reused staging row (was a fresh np.zeros per pop — a pure
        # allocation on the reply drain; the C side overwrites [0, rc))
        buf = self._pop_buf
        if buf is None:
            buf = self._pop_buf = np.zeros((self.frame_size,),
                                           dtype=np.uint8)
        fl = C.c_uint32(0)
        rc = getattr(self._lib, f"bng_ring_{which}_pop")(
            self._h, _u8p(buf), self.frame_size, C.byref(fl))
        if rc <= 0:
            return None
        return bytes(buf[:rc]), fl.value

    _pop_buf = None  # lazy per-ring reply staging row

    def tx_pop(self):
        return self._pop("tx")

    def fwd_pop(self):
        return self._pop("fwd")

    def slow_pop(self):
        return self._pop("slow")

    def tx_pop_batch(self, limit: int | None = None) -> list:
        """Drain up to `limit` TX frames as [(bytes, flags)] — the C side
        pops per frame either way; the PyRing vector path overrides this
        with one gather."""
        out = []
        while limit is None or len(out) < limit:
            got = self.tx_pop()
            if got is None:
                break
            out.append(got)
        return out

    # -- introspection --
    def rx_pending(self) -> int:
        return self._lib.bng_ring_rx_pending(self._h)

    def shard_rx_pending(self, shard: int) -> int:
        return self._lib.bng_ring_shard_rx_pending(self._h, shard)

    def tx_pending(self) -> int:
        return self._lib.bng_ring_tx_pending(self._h)

    def fwd_pending(self) -> int:
        return self._lib.bng_ring_fwd_pending(self._h)

    def slow_pending(self) -> int:
        return self._lib.bng_ring_slow_pending(self._h)

    def free_frames(self) -> int:
        return self._lib.bng_ring_free_frames(self._h)

    def stats(self) -> dict:
        s = RingStats()
        self._lib.bng_ring_get_stats(self._h, C.byref(s))
        return {f: getattr(s, f) for f, _ in RingStats._fields_}


def wire_pump(a, b, budget: int = 256) -> int:
    """Loopback cable between two rings (tests/demo): moves TX+FWD output
    of each ring into the peer's RX, flipping the from_access flag (a
    frame leaving the access side arrives at the core side)."""
    if isinstance(a, NativeRing) and isinstance(b, NativeRing):
        return a._lib.bng_wire_pump(a._h, b._h, budget)
    moved = 0
    for src, dst in ((a, b), (b, a)):
        for _ in range(budget):
            got = src.tx_pop() or src.fwd_pop()
            if got is None:
                break
            frame, fl = got
            dst.rx_push(frame, from_access=(fl & FLAG_FROM_ACCESS) == 0)
            moved += 1
    return moved


class PyRing:
    """Pure-Python ring with the NativeRing API.

    Two host paths, selected per instance by BNG_HOST_PATH (or the
    `host_path` argument):

    - ``scalar`` (default) — the per-frame implementation: frames live
      as bytes in deques, classify/steer run the scalar functions per
      push, assemble/complete loop per frame. It is the oracle the
      vector path is pinned bit-identical against.
    - ``vector`` — batch-native structure-of-arrays staging: every
      frame lives in one preallocated [nframes, frame_size] uint8
      matrix with length/flag columns; `rx_push_batch` classifies and
      steers the whole batch with vectorized field extraction
      (runtime/hostpath.py), and assemble/assemble_sharded/complete
      are vectorized gathers/scatters. Pressured edge cases (free-pool
      exhaustion or per-shard backpressure mid-batch) fall back to the
      per-frame scalar decisions, so the two paths can never disagree.
    """

    def __init__(self, nframes: int = 4096, frame_size: int = 2048,
                 depth: int = 1024, n_shards: int = 1,
                 host_path: str | None = None):
        if not 1 <= n_shards <= 64:
            raise RuntimeError("1 <= n_shards <= 64")
        self.frame_size = frame_size
        self.depth = depth
        self.n_shards = n_shards
        self.nframes = nframes
        self.host_path = host_path or hostpath.resolved_host_path()
        if self.host_path not in hostpath.HOST_PATHS:
            raise ValueError(f"unknown host path {self.host_path!r}")
        self._vec = self.host_path == "vector"
        self._free = nframes
        self._tx: deque = deque()
        self._fwd: deque = deque()
        self._slow: deque = deque()
        # FIFO of batches; scalar entries are [(frame, fl) | None] lists
        # (None = sharded-assemble padding lane), vector entries are
        # (slot-id array, valid-lane mask) pairs
        self._inflight: list = []
        self._pub_ips: dict[int, int] = {}
        self._pub_sorted = None  # (keys u64 sorted, vals i64) mirror
        self._stats = {k: 0 for k, _ in RingStats._fields_}
        if self._vec:
            # SoA frame store: slot-indexed, preallocated once. The
            # invariant: a slot reachable from an RX queue is ZERO
            # beyond its _len (assemble gathers full-width rows, so a
            # stale tail would leak prior occupants into the device).
            # _ext tracks each slot's possibly-nonzero extent so every
            # writer restores the invariant with a plain rectangular
            # copy — no masked scatters on the hot path.
            self._buf = np.zeros((nframes, frame_size), dtype=np.uint8)
            self._len = np.zeros((nframes,), dtype=np.uint32)
            self._ext = np.zeros((nframes,), dtype=np.uint32)
            self._fl = np.zeros((nframes,), dtype=np.uint32)
            self._slot_stack = np.arange(nframes, dtype=np.uint32)
            # per-shard RX as bounded circular slot queues (depth each):
            # assemble converts queue slices to gathers with no
            # per-frame conversion cost
            self._rxq = np.zeros((n_shards, depth), dtype=np.uint32)
            self._rxh = np.zeros((n_shards,), dtype=np.int64)  # heads
            self._rxc = np.zeros((n_shards,), dtype=np.int64)  # counts
            self._spill: dict[int, bytes] = {}  # replies > frame_size
        else:
            self._rx: list[deque[tuple[bytes, int]]] = [
                deque() for _ in range(n_shards)]

    def close(self) -> None:
        pass

    # -- steering --
    def steer_pub_ip(self, ip: int, shard: int) -> bool:
        if shard >= self.n_shards:
            return False
        self._pub_ips[ip] = shard
        self._pub_sorted = None
        return True

    def shard_of(self, frame: bytes, flags: int) -> int:
        return shard_of(frame, flags, self.n_shards, self._pub_ips)

    def _pub_arrays(self):
        """Sorted-array mirror of the pub-IP steer map (rebuilt lazily
        after steer_pub_ip) — the vector path's O(log n) membership."""
        if self._pub_sorted is None:
            keys = np.fromiter(self._pub_ips.keys(), dtype=np.uint64,
                               count=len(self._pub_ips))
            vals = np.fromiter(self._pub_ips.values(), dtype=np.int64,
                               count=len(self._pub_ips))
            order = np.argsort(keys)
            self._pub_sorted = (keys[order], vals[order])
        return self._pub_sorted

    # -- producer ---------------------------------------------------------

    def rx_push(self, frame: bytes, from_access: bool = True) -> bool:
        if len(frame) > self.frame_size:
            self._stats["bad_desc"] += 1
            return False
        fl = FLAG_FROM_ACCESS if from_access else 0
        if from_access:  # direction gate — see classify_dhcp docstring
            fl |= classify_dhcp(frame)
        shard = self.shard_of(frame, fl)
        if self._free == 0 or self._shard_depth(shard) >= self.depth:
            self._stats["fill_empty" if self._free == 0 else "rx_full"] += 1
            return False
        self._free -= 1
        if self._vec:
            self._enqueue_slot(shard, self._stage_slot(frame, fl))
        else:
            self._rx[shard].append((frame, fl))
        return True

    def rx_push_batch(self, frames: list[bytes],
                      from_access: bool = True) -> int:
        """Batch producer. Scalar: the per-frame loop. Vector: ONE
        vectorized classify+steer pass over the whole batch, staged
        into the SoA store with a single ragged scatter — per-frame
        Python only on the pressured fallback (free-pool or per-shard
        backpressure mid-batch), where admission order matters."""
        if not self._vec:
            return self._push_scalar(frames, from_access)
        return self._rx_push_batch_vec(frames, from_access)

    def _push_scalar(self, frames: list[bytes], from_access: bool) -> int:
        """Per-frame push loop — the scalar batch producer AND the
        vector path's pressured fallback (one copy of the stop-at-
        first-refusal semantics)."""
        n = 0
        for f in frames:
            if not self.rx_push(f, from_access=from_access):
                break
            n += 1
        return n

    def _rx_push_batch_vec(self, frames: list[bytes],
                           from_access: bool) -> int:
        n = len(frames)
        if n == 0:
            return 0
        lens = hostpath.frame_lens(frames)
        if (int(lens.max()) > self.frame_size or self._free < n
                or n > self.nframes):
            # size rejection / free-pool pressure: per-frame decisions
            # (a rejected frame frees no slot; order matters) — the
            # scalar oracle takes over for the WHOLE batch
            return self._push_scalar(frames, from_access)
        # width floor 1: an all-empty batch must classify (to nothing)
        # instead of indexing a zero-width matrix — the scalar oracle
        # ACCEPTS zero-length frames (they hash to shard 0 and ride the
        # slow path), so the vector path must too
        buf = np.empty((n, max(int(lens.max()), 1)), dtype=np.uint8)
        hostpath.pack_into(frames, buf, np.empty((n,), np.uint32),
                           lens=lens)
        fl = np.full(n, FLAG_FROM_ACCESS if from_access else 0,
                     dtype=np.uint32)
        if from_access:
            fl |= hostpath.classify_dhcp_batch(buf, lens)
        if self.n_shards > 1:
            keys, vals = self._pub_arrays()
            shards = hostpath.shard_of_batch(buf, lens, fl, self.n_shards,
                                             keys, vals)
        else:
            shards = np.zeros(n, dtype=np.int64)
        counts = np.bincount(shards, minlength=self.n_shards)
        if ((self._rxc + counts) > self.depth).any():
            # per-shard backpressure mid-batch: scalar decisions
            return self._push_scalar(frames, from_access)
        slots = self._alloc_slots(n)
        self._scatter_frames(slots, buf, lens)
        self._fl[slots] = fl
        for s in np.nonzero(counts)[0]:
            self._enqueue_slots(int(s), slots[shards == s])
        self._free -= n
        return n

    def tx_inject(self, frame: bytes, from_access: bool = True) -> bool:
        if (len(frame) > self.frame_size or self._free == 0
                or len(self._tx) >= self.depth):
            return False
        self._free -= 1
        fl = FLAG_FROM_ACCESS if from_access else 0
        if self._vec:
            slot = self._stage_slot(frame, fl)
            self._tx.append(int(slot))
        else:
            self._tx.append((frame, fl))
        self._stats["tx"] += 1
        return True

    # -- vector SoA plumbing ---------------------------------------------

    def _alloc_slots(self, k: int) -> np.ndarray:
        free = self.nframes - self._used_slots
        assert k <= free
        out = self._slot_stack[free - k: free].copy()
        self._used_slots += k
        return out

    def _release_slots(self, slots: np.ndarray) -> None:
        k = len(slots)
        if k == 0:
            return
        free = self.nframes - self._used_slots
        self._slot_stack[free: free + k] = slots
        self._used_slots -= k

    def _release_slot(self, slot: int) -> None:
        """Single-slot release — the per-frame pop fast path (no array
        ceremony)."""
        self._slot_stack[self.nframes - self._used_slots] = slot
        self._used_slots -= 1

    _used_slots = 0

    def _stage_slot(self, frame: bytes, fl: int) -> int:
        """Single-frame SoA staging (the per-frame producer APIs)."""
        slot = int(self._alloc_slots(1)[0])
        row = self._buf[slot]
        prev = int(self._ext[slot])
        row[: len(frame)] = np.frombuffer(frame, dtype=np.uint8)
        if prev > len(frame):
            row[len(frame): prev] = 0  # restore the zero-tail invariant
        self._len[slot] = len(frame)
        self._ext[slot] = len(frame)
        self._fl[slot] = fl
        return slot

    def _scatter_frames(self, slots: np.ndarray, buf: np.ndarray,
                        lens: np.ndarray) -> None:
        """Packed rows -> SoA slots in ONE rectangular copy. `buf` rows
        are already zero beyond each frame's length (pack_into), so
        copying through the previous occupants' extent both stages the
        frames and restores the zero-tail invariant — no mask."""
        prev = self._ext[slots]
        w = min(int(max(int(lens.max()), int(prev.max()))), self.frame_size)
        src = buf[:, :w] if buf.shape[1] >= w else np.pad(
            buf, ((0, 0), (0, w - buf.shape[1])))
        self._buf[slots, :w] = src
        self._len[slots] = lens
        self._ext[slots] = lens

    def _enqueue_slot(self, shard: int, slot: int) -> None:
        pos = (self._rxh[shard] + self._rxc[shard]) % self.depth
        self._rxq[shard, pos] = slot
        self._rxc[shard] += 1

    def _enqueue_slots(self, shard: int, slots: np.ndarray) -> None:
        k = len(slots)
        pos = (self._rxh[shard] + self._rxc[shard]
               + np.arange(k)) % self.depth
        self._rxq[shard, pos] = slots
        self._rxc[shard] += k

    def _peek_slots(self, shard: int, k: int) -> np.ndarray:
        pos = (self._rxh[shard] + np.arange(k)) % self.depth
        return self._rxq[shard, pos]

    def _advance(self, shard: int, k: int) -> None:
        self._rxh[shard] = (self._rxh[shard] + k) % self.depth
        self._rxc[shard] -= k

    def _shard_depth(self, shard: int) -> int:
        return (int(self._rxc[shard]) if self._vec
                else len(self._rx[shard]))

    MAX_INFLIGHT = 2  # two assemble..complete windows (double buffering)

    def _stage(self, out, out_len, out_flags, row_i, frame, fl, slot):
        # writes the row in place: no per-frame allocation
        copy = min(len(frame), slot)
        out[row_i, :copy] = np.frombuffer(frame[:copy], dtype=np.uint8)
        out[row_i, copy:] = 0
        out_len[row_i] = copy
        out_flags[row_i] = fl

    # -- consumer ---------------------------------------------------------

    def assemble(self, out: np.ndarray, out_len: np.ndarray,
                 out_flags: np.ndarray) -> int:
        if len(self._inflight) >= self.MAX_INFLIGHT:
            return 0
        if self._vec:
            return self._assemble_vec(out, out_len, out_flags)
        B, slot = out.shape
        batch = []
        n = 0
        # round-robin over shard queues (n_shards==1: plain drain)
        idle, s = 0, 0
        while n < B and idle < self.n_shards:
            if not self._rx[s]:
                idle += 1
            else:
                idle = 0
                frame, fl = self._rx[s].popleft()
                self._stage(out, out_len, out_flags, n, frame, fl, slot)
                batch.append((frame, fl))
                n += 1
            s = (s + 1) % self.n_shards
        if n:
            self._inflight.append(batch)
        self._stats["rx"] += n
        return n

    def _assemble_vec(self, out, out_len, out_flags) -> int:
        """Vectorized assemble: the scalar round-robin drain order is
        exactly lexicographic (queue position, shard) starting at shard
        0 — one lexsort reproduces it bit-for-bit, then one gather
        stages the whole batch."""
        B, slot_w = out.shape
        total = int(self._rxc.sum())
        if total == 0:
            return 0
        if self.n_shards == 1:
            n = min(B, total)
            chosen = self._peek_slots(0, n).astype(np.int64)
            self._advance(0, n)
        else:
            live = np.nonzero(self._rxc)[0]
            # a shard can contribute at most B lanes to this batch: in
            # the (round, shard) lex order any item with per-shard index
            # >= B can never make the first B, so clipping bounds the
            # sort at B*n_live instead of the whole backlog (identical
            # drain order; deep queues made this O(total log total))
            counts = np.minimum(self._rxc[live], B)
            total = int(counts.sum())
            pend = [self._peek_slots(int(s), int(c))
                    for s, c in zip(live, counts)]
            shards_rep = np.repeat(live, counts)
            offs = np.concatenate(([0], np.cumsum(counts[:-1])))
            rounds = np.arange(total) - np.repeat(offs, counts)
            order = np.lexsort((shards_rep, rounds))[:B]
            n = len(order)
            chosen = np.concatenate(pend).astype(np.int64)[order]
            popped = np.bincount(shards_rep[order],
                                 minlength=self.n_shards)
            for s in np.nonzero(popped)[0]:
                self._advance(int(s), int(popped[s]))
        self._gather_rows(chosen, out, out_len, out_flags, 0, n, slot_w)
        self._inflight.append((chosen, np.ones(n, dtype=bool)))
        self._stats["rx"] += n
        return n

    def _gather_rows(self, slots, out, out_len, out_flags, base, n,
                     slot_w) -> None:
        w = min(slot_w, self.frame_size)
        out[base: base + n, :w] = self._buf[slots, :w]
        if slot_w > w:
            out[base: base + n, w:] = 0
        out_len[base: base + n] = np.minimum(self._len[slots], slot_w)
        out_flags[base: base + n] = self._fl[slots]

    def assemble_sharded(self, out: np.ndarray, out_len: np.ndarray,
                         out_flags: np.ndarray) -> int:
        """Per-shard lane ranges — see NativeRing.assemble_sharded."""
        if len(self._inflight) >= self.MAX_INFLIGHT:
            return 0
        B, slot = out.shape
        if B % self.n_shards:
            raise ValueError(f"batch {B} not divisible by {self.n_shards} shards")
        b = B // self.n_shards
        if b > self.depth:  # NativeRing parity: geometry error, not "empty"
            raise ValueError(f"b_per_shard {b} exceeds ring depth {self.depth}")
        if self._vec:
            return self._assemble_sharded_vec(out, out_len, out_flags, b,
                                              slot)
        batch: list[tuple[bytes, int] | None] = []
        got = 0
        for s in range(self.n_shards):
            for _ in range(b):
                if self._rx[s]:
                    frame, fl = self._rx[s].popleft()
                    self._stage(out, out_len, out_flags, len(batch), frame,
                                fl, slot)
                    batch.append((frame, fl))
                    got += 1
                else:
                    out[len(batch)] = 0
                    out_len[len(batch)] = 0
                    out_flags[len(batch)] = 0
                    batch.append(None)  # padding lane
        if got:
            self._inflight.append(batch)
        self._stats["rx"] += got
        return got

    def _assemble_sharded_vec(self, out, out_len, out_flags, b,
                              slot_w) -> int:
        """Vectorized sharded assemble: one gather per LIVE shard (bound
        by n_shards, never by frames), padding lanes zeroed wholesale."""
        B = b * self.n_shards
        slots = np.zeros(B, dtype=np.int64)
        valid = np.zeros(B, dtype=bool)
        got = 0
        for s in range(self.n_shards):
            k = min(int(self._rxc[s]), b)
            base = s * b
            if k:
                sl = self._peek_slots(s, k).astype(np.int64)
                self._advance(s, k)
                self._gather_rows(sl, out, out_len, out_flags, base, k,
                                  slot_w)
                slots[base: base + k] = sl
                valid[base: base + k] = True
                got += k
            if k < b:
                out[base + k: base + b] = 0
                out_len[base + k: base + b] = 0
                out_flags[base + k: base + b] = 0
        if got:
            self._inflight.append((slots, valid))
        self._stats["rx"] += got
        return got

    def complete(self, verdict: np.ndarray, out: np.ndarray,
                 out_len: np.ndarray, n: int) -> None:
        # retires the OLDEST outstanding batch (FIFO, like the C side)
        if self._vec:
            if not self._inflight or n != len(self._inflight[0][0]):
                raise RuntimeError("batch_complete: n mismatch")
            return self._complete_vec(verdict, out, out_len, n)
        if not self._inflight or n != len(self._inflight[0]):
            raise RuntimeError("batch_complete: n mismatch")
        batch = self._inflight.pop(0)
        for i in range(n):
            if batch[i] is None:  # sharded-assemble padding lane
                continue
            frame, fl = batch[i]
            v = int(verdict[i])
            if v in (VERDICT_TX, VERDICT_FWD):
                payload = bytes(out[i, : int(out_len[i])])
                dst, stat = (self._tx, "tx") if v == VERDICT_TX else (self._fwd, "fwd")
            elif v == VERDICT_PASS:
                payload, dst, stat = frame, self._slow, "slow"
            else:
                self._stats["drop"] += 1
                self._free += 1
                continue
            if len(dst) < self.depth:
                dst.append((payload, fl))  # frame stays held until popped
                self._stats[stat] += 1
            else:
                self._stats["tx_full"] += 1
                self._free += 1

    def _complete_vec(self, verdict, out, out_len, n) -> None:
        """Vectorized verdict demux: masked rank accounting reproduces
        the scalar lane-order queue-capacity semantics (the first
        `room` lanes of each verdict class are accepted), and TX/FWD
        payloads scatter back into the SoA store in one ragged write —
        no per-frame reply-buffer rebuild."""
        slots, valid = self._inflight.pop(0)
        vv = np.asarray(verdict)[:n]
        ol = np.asarray(out_len)[:n].astype(np.int64)
        freed = np.zeros(n, dtype=bool)
        for code, dst, stat in ((VERDICT_TX, self._tx, "tx"),
                                (VERDICT_FWD, self._fwd, "fwd"),
                                (VERDICT_PASS, self._slow, "slow")):
            m = valid & (vv == code)
            cnt = int(m.sum())
            if not cnt:
                continue
            room = self.depth - len(dst)
            if cnt > room:
                rank = np.cumsum(m) - 1
                acc = m & (rank < room)
                over = m & ~acc
                self._stats["tx_full"] += int(over.sum())
                freed |= over
                m = acc
                cnt = room
                if cnt <= 0:
                    continue
            if code != VERDICT_PASS:
                lanes = np.nonzero(m)[0]
                sl = slots[lanes]
                ll = ol[lanes]
                fit = ll <= self.frame_size
                if fit.all():
                    self._scatter_rows_from(out, lanes, sl, ll)
                else:
                    self._scatter_rows_from(out, lanes[fit], sl[fit],
                                            ll[fit])
                    for lane, slot in zip(lanes[~fit], sl[~fit]):
                        # reply wider than the UMEM slot: spill to bytes
                        # (per-frame on exactly these lanes; scalar
                        # parity — it stores the bytes either way)
                        self._spill[int(slot)] = bytes(
                            out[int(lane), : int(ol[lane])])
                dst.extend(sl.tolist())
            else:
                dst.extend(slots[m].tolist())
            self._stats[stat] += cnt
        drop = valid & ~np.isin(vv, (VERDICT_TX, VERDICT_FWD, VERDICT_PASS))
        ndrop = int(drop.sum())
        if ndrop:
            self._stats["drop"] += ndrop
            freed |= drop
        if freed.any():
            self._release_slots(slots[freed])
            self._free += int(freed.sum())

    def _scatter_rows_from(self, out, lanes, sl, ll) -> None:
        """TX/FWD payload write-back: out rows -> SoA slots in one
        rectangular copy. Device rows carry no zero guarantee beyond
        out_len, so the written width becomes the slot's possibly-dirty
        extent (_ext): pops read only [:len], and the next RX occupant
        zeroes through _ext before the slot can reach assemble again."""
        n_l = len(lanes)
        if n_l == 0:
            return
        prev = self._ext[sl]
        w = min(int(max(int(ll.max()), int(prev.max()))), self.frame_size)
        src = out if n_l == len(out) else out[lanes]
        if src.shape[1] >= w:
            src = src[:, :w]
        else:
            src = np.pad(src, ((0, 0), (0, w - src.shape[1])))
        self._buf[sl, :w] = src
        self._len[sl] = ll
        self._ext[sl] = w

    def _pop(self, q: deque):
        if not q:
            return None
        item = q.popleft()
        self._free += 1
        if not self._vec:
            return item
        slot = item
        sp = self._spill.pop(slot, None) if self._spill else None
        payload = (sp if sp is not None
                   else bytes(self._buf[slot, : self._len[slot]]))
        fl = int(self._fl[slot])
        self._release_slot(slot)
        return payload, fl

    def tx_pop(self):
        return self._pop(self._tx)

    def fwd_pop(self):
        return self._pop(self._fwd)

    def slow_pop(self):
        return self._pop(self._slow)

    def tx_pop_batch(self, limit: int | None = None) -> list:
        """Drain up to `limit` TX frames as [(bytes, flags)]. Vector:
        one SoA gather + one tobytes for the whole drain (the reply
        consumer's per-frame bytes() rebuild was ~5x the scalar pop
        cost); scalar: the per-frame loop."""
        k = len(self._tx)
        if limit is not None:
            k = min(k, limit)
        if k == 0:
            return []
        if not self._vec:
            out = []
            for _ in range(k):
                out.append(self._pop(self._tx))
            return out
        slots = np.fromiter((self._tx.popleft() for _ in range(k)),
                            dtype=np.int64, count=k)
        lens = self._len[slots].tolist()
        fls = self._fl[slots].tolist()
        W = self.frame_size
        big = self._buf[slots].tobytes()
        out = [(big[i * W: i * W + lens[i]], fls[i]) for i in range(k)]
        if self._spill:
            for i, s in enumerate(slots.tolist()):
                sp = self._spill.pop(int(s), None)
                if sp is not None:
                    out[i] = (sp, fls[i])
        self._release_slots(slots.astype(np.uint32))
        self._free += k
        return out

    def rx_pop(self):
        """Frame-level RX consumer (round-robin over shard queues) for
        the tiered scheduler, which stages frames in its own lanes
        instead of the ring's FIFO assemble..complete windows (two lanes
        retire out of order — FIFO complete would deadlock them).
        Returns (frame, flags) or None. PyRing only: the native ring's
        batch assemble is its contract, so a loop over it runs the
        engine's pipelined loop instead."""
        for off in range(self.n_shards):
            s = (self._rx_pop_next + off) % self.n_shards
            if self._shard_depth(s):
                self._rx_pop_next = (s + 1) % self.n_shards
                if self._vec:
                    slot = int(self._peek_slots(s, 1)[0])
                    self._advance(s, 1)
                    frame = bytes(self._buf[slot, : int(self._len[slot])])
                    fl = int(self._fl[slot])
                    self._release_slot(slot)
                else:
                    frame, fl = self._rx[s].popleft()
                self._free += 1
                self._stats["rx"] += 1
                return frame, fl
        return None

    _rx_pop_next = 0  # round-robin cursor for rx_pop

    def rx_pending(self) -> int:
        return (int(self._rxc.sum()) if self._vec
                else sum(len(q) for q in self._rx))

    def shard_rx_pending(self, shard: int) -> int:
        return self._shard_depth(shard) if shard < self.n_shards else 0

    def tx_pending(self) -> int:
        return len(self._tx)

    def fwd_pending(self) -> int:
        return len(self._fwd)

    def slow_pending(self) -> int:
        return len(self._slow)

    def free_frames(self) -> int:
        return self._free

    def stats(self) -> dict:
        return dict(self._stats)


def make_ring(nframes: int = 4096, frame_size: int = 2048,
              depth: int = 1024, prefer_native: bool = True,
              n_shards: int = 1):
    """NativeRing when the toolchain allows, PyRing otherwise."""
    if prefer_native:
        try:
            return NativeRing(nframes, frame_size, depth, n_shards)
        except RuntimeError:
            pass
    return PyRing(nframes, frame_size, depth, n_shards)
