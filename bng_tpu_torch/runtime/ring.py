"""Packet rings for the engine's ring loops (port of
`bng_tpu/runtime/ring.py`).

- `NativeRing`: the reference's C++ ring (`csrc/bngring.{h,cpp}`, a
  byte-for-byte copy of `native/bngring.{h,cpp}`), an AF_XDP-style UMEM
  with SPSC descriptor rings, bound with ctypes. `runtime/nativelib.py`
  builds it with `g++` at first use into `bng_tpu_torch/_build/`.
- `PyRing`: the same API in Python, per frame over deques.
- `make_ring` gives a `NativeRing` when the library loads, else a
  `PyRing`.

The engine's zero-copy ring loop (`runtime/engine.py`) reads a
`NativeRing`'s frames where they lie: `map_umem` registers the UMEM with
the card once (pinned, mapped for every card; `close` unregisters it),
`assemble_desc` takes a batch's descriptors off RX with no frame copied
(`csrc/ringdesc.cpp`), and `complete(..., out=None, ...)` retires a batch
whose TX/FWD bytes the card already wrote back (`ops/umem.py`). A `PyRing`
has no UMEM and maps none.

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

from bng_tpu_torch.runtime import nativelib
from bng_tpu_torch.utils.net import fnv1a32

FLAG_FROM_ACCESS = 0x1
# set by the ring on RX when the frame parses as IPv4/UDP dst:67 — the
# consumer may route an all-control batch through the DHCP-only device
# program (BNG_DESC_F_DHCP_CTRL in bngring.h)
FLAG_DHCP_CTRL = 0x2

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


def _configure_desc(lib: C.CDLL) -> None:
    lib.bng_batch_assemble_desc.restype = C.c_uint32
    lib.bng_batch_assemble_desc.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint64), C.POINTER(C.c_uint32), C.POINTER(C.c_uint32),
        C.c_uint32]


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
        self._desc_lib = None  # csrc/ringdesc.cpp, loaded at the first assemble_desc
        self._umem_map = None  # ops/umem.Umem once registered with the card

    @property
    def umem_ptr(self):
        """Raw UMEM base pointer (the AF_XDP registration area)."""
        return self._lib.bng_ring_umem(self._h)

    @property
    def umem_size(self) -> int:
        return self._lib.bng_ring_umem_size(self._h)

    def close(self) -> None:
        if self._h:
            try:
                if self._umem_map is not None:  # the card lets go of the UMEM before it is freed
                    from bng_tpu_torch.ops import umem as umem_ops

                    self._umem_map = None
                    umem_ops.unregister(C.cast(self.umem_ptr, C.c_void_p).value)
            finally:
                self._lib.bng_ring_destroy(self._h)
                self._h = None

    def map_umem(self, device):
        """The UMEM as `device` reads it (`ops/umem.Umem`), for the engine's
        zero-copy ring loop. The CPU reads it where it lies. On a card it is
        registered once, at the first call, as pinned host memory mapped for
        every card (the whole page-rounded allocation `bng_ring_create`
        makes; `close` unregisters it); raises with the CUDA error if the
        card refuses."""
        from bng_tpu_torch.ops import umem as umem_ops

        if device.type == "cpu":
            return umem_ops.Umem(0, self.umem_view(), self.frame_size)
        if self._umem_map is None:
            page = 4096
            size = (self.umem_size + page - 1) & ~(page - 1)
            base = umem_ops.register(C.cast(self.umem_ptr, C.c_void_p).value, size, device)
            self._umem_map = umem_ops.Umem(base, self.umem_view(), self.frame_size)
        return self._umem_map

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
        per push, so the native ring just loops. Returns frames accepted
        (stops at the first refusal, like a filling RX ring)."""
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

    def assemble_desc(self, addrs: np.ndarray, lens: np.ndarray,
                      flags: np.ndarray) -> int:
        """The next batch's descriptors off RX (uint64 UMEM offsets, uint32
        lengths and flags; up to len(addrs) lanes), opening the window
        `assemble` opens, with no frame copied: the card reads the frames
        from the mapped UMEM. Returns the count."""
        if self._desc_lib is None:
            self._desc_lib = nativelib.load("ringdesc", _configure_desc)
            if self._desc_lib is None:
                raise RuntimeError("native descriptor-assemble library unavailable")
        return int(self._desc_lib.bng_batch_assemble_desc(
            self._h, _u64p(addrs), _u32p(lens), _u32p(flags), len(addrs)))

    def complete(self, verdict: np.ndarray, out: np.ndarray | None,
                 out_len: np.ndarray, n: int) -> None:
        """Retire the oldest batch. `out` [B, slot] holds the TX/FWD lanes'
        bytes, copied back over their frames; None when they are already
        there (the zero-copy loop), and the ring copies nothing."""
        rc = self._lib.bng_batch_complete(
            self._h, _u8p(verdict.astype(np.uint8, copy=False)),
            None if out is None else _u8p(out), _u32p(out_len), n,
            0 if out is None else out.shape[1])
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
        pops per frame."""
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
    """Pure-Python ring with the NativeRing API: frames live as bytes in
    deques, classify/steer run the scalar functions per push, and
    assemble/complete loop per frame."""

    def __init__(self, nframes: int = 4096, frame_size: int = 2048,
                 depth: int = 1024, n_shards: int = 1):
        if not 1 <= n_shards <= 64:
            raise RuntimeError("1 <= n_shards <= 64")
        self.frame_size = frame_size
        self.depth = depth
        self.n_shards = n_shards
        self._free = nframes
        self._tx: deque = deque()
        self._fwd: deque = deque()
        self._slow: deque = deque()
        # FIFO of batches, each a [(frame, fl) | None] list (None =
        # sharded-assemble padding lane)
        self._inflight: list = []
        self._pub_ips: dict[int, int] = {}
        self._stats = {k: 0 for k, _ in RingStats._fields_}
        self._rx: list[deque[tuple[bytes, int]]] = [
            deque() for _ in range(n_shards)]

    def close(self) -> None:
        pass

    def map_umem(self, device):
        """None: the frames live in Python objects, not in a UMEM a card
        could map, so the engine's ring loops copy them."""
        return None

    # -- steering --
    def steer_pub_ip(self, ip: int, shard: int) -> bool:
        if shard >= self.n_shards:
            return False
        self._pub_ips[ip] = shard
        return True

    def shard_of(self, frame: bytes, flags: int) -> int:
        return shard_of(frame, flags, self.n_shards, self._pub_ips)

    # -- producer ---------------------------------------------------------

    def rx_push(self, frame: bytes, from_access: bool = True) -> bool:
        if len(frame) > self.frame_size:
            self._stats["bad_desc"] += 1
            return False
        fl = FLAG_FROM_ACCESS if from_access else 0
        if from_access:  # direction gate — see classify_dhcp docstring
            fl |= classify_dhcp(frame)
        shard = self.shard_of(frame, fl)
        if self._free == 0 or len(self._rx[shard]) >= self.depth:
            self._stats["fill_empty" if self._free == 0 else "rx_full"] += 1
            return False
        self._free -= 1
        self._rx[shard].append((frame, fl))
        return True

    def rx_push_batch(self, frames: list[bytes],
                      from_access: bool = True) -> int:
        """Per-frame push loop; stops at the first refusal."""
        n = 0
        for f in frames:
            if not self.rx_push(f, from_access=from_access):
                break
            n += 1
        return n

    def tx_inject(self, frame: bytes, from_access: bool = True) -> bool:
        if (len(frame) > self.frame_size or self._free == 0
                or len(self._tx) >= self.depth):
            return False
        self._free -= 1
        self._tx.append((frame, FLAG_FROM_ACCESS if from_access else 0))
        self._stats["tx"] += 1
        return True

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

    def complete(self, verdict: np.ndarray, out: np.ndarray,
                 out_len: np.ndarray, n: int) -> None:
        # retires the OLDEST outstanding batch (FIFO, like the C side)
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

    def _pop(self, q: deque):
        if not q:
            return None
        self._free += 1
        return q.popleft()

    def tx_pop(self):
        return self._pop(self._tx)

    def fwd_pop(self):
        return self._pop(self._fwd)

    def slow_pop(self):
        return self._pop(self._slow)

    def tx_pop_batch(self, limit: int | None = None) -> list:
        """Drain up to `limit` TX frames as [(bytes, flags)]."""
        k = len(self._tx)
        if limit is not None:
            k = min(k, limit)
        out = []
        for _ in range(k):
            out.append(self._pop(self._tx))
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
            if self._rx[s]:
                self._rx_pop_next = (s + 1) % self.n_shards
                frame, fl = self._rx[s].popleft()
                self._free += 1
                self._stats["rx"] += 1
                return frame, fl
        return None

    _rx_pop_next = 0  # round-robin cursor for rx_pop

    def rx_pending(self) -> int:
        return sum(len(q) for q in self._rx)

    def shard_rx_pending(self, shard: int) -> int:
        return len(self._rx[shard]) if shard < self.n_shards else 0

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
