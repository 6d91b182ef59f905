/* bngxsk — AF_XDP socket scaffold for the zero-copy wire path.
 *
 * Role parity: the reference's loader picks its attach rung at runtime —
 * driver native mode, then generic/SKB mode, then a stub for dev boxes
 * (pkg/ebpf/loader.go:294-315 ladder). Here the same ladder applies to
 * the AF_XDP *socket* that feeds the dataplane's ring:
 *
 *     rung 0  XDP_ZEROCOPY bind  — NIC DMAs straight into the UMEM the
 *                                  batch assembler stages to the card
 *     rung 1  XDP_COPY bind      — generic mode, one kernel copy
 *     rung 2  unavailable        — caller falls back to the in-memory
 *                                  bngring (tests, CI, pods without a NIC)
 *
 * No libbpf/libxdp in the image: UMEM registration, ring mmaps and the
 * bind are done with raw setsockopt/mmap against <linux/if_xdp.h>, which
 * is all AF_XDP actually needs (the library only adds convenience).
 * Everything degrades cleanly: on kernels/containers without AF_XDP
 * support (no CAP_NET_RAW, no NIC queue), open() reports the failed rung
 * and the Python side (bng_tpu_torch/runtime/xsk.py) steps down the ladder.
 *
 * C ABI via ctypes, matching bngring.cpp's binding style. A copy of
 * native/bngxsk.cpp, these comments aside.
 */
#include <cstring>
#include <new>

#ifdef __linux__
#include <errno.h>
#include <linux/if_xdp.h>
#include <net/if.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <unistd.h>
#endif

#include <stdint.h>

extern "C" {

/* ladder rungs (returned by bng_xsk_mode) */
enum bng_xsk_mode {
  BNG_XSK_ZEROCOPY = 0,
  BNG_XSK_COPY = 1,
  BNG_XSK_UNAVAILABLE = 2,
};

/* error codes from bng_xsk_open (negative) */
enum bng_xsk_err {
  BNG_XSK_E_SOCKET = -1,   /* socket(AF_XDP) failed: kernel/caps */
  BNG_XSK_E_UMEM = -2,     /* XDP_UMEM_REG rejected */
  BNG_XSK_E_RINGS = -3,    /* ring size setsockopts failed */
  BNG_XSK_E_MMAP = -4,     /* ring mmap failed */
  BNG_XSK_E_IFACE = -5,    /* interface does not exist */
  BNG_XSK_E_BIND = -6,     /* both zerocopy and copy binds failed */
};

struct bng_xsk {
#ifdef __linux__
  int fd = -1;
  int mode = BNG_XSK_UNAVAILABLE;
  uint32_t ifindex = 0;
  uint32_t queue = 0;
  /* mapped rings (producer/consumer pointers + descriptor arrays) */
  void *rx_map = nullptr, *tx_map = nullptr;
  void *fr_map = nullptr, *cr_map = nullptr;
  size_t rx_map_len = 0, tx_map_len = 0, fr_map_len = 0, cr_map_len = 0;
  uint32_t ring_size = 0;
  /* cached ring views */
  uint32_t *rx_prod = nullptr, *rx_cons = nullptr;
  xdp_desc *rx_ring = nullptr;
  uint32_t *tx_prod = nullptr, *tx_cons = nullptr;
  xdp_desc *tx_ring = nullptr;
  uint32_t *fr_prod = nullptr, *fr_cons = nullptr;
  uint64_t *fr_ring = nullptr;
  uint32_t *cr_prod = nullptr, *cr_cons = nullptr;
  uint64_t *cr_ring = nullptr;
#else
  int fd = -1;
  int mode = BNG_XSK_UNAVAILABLE;
#endif
};

/* Rung probe: can this kernel/container create an AF_XDP socket at all?
 * Cheap (one socket syscall), no interface needed. */
int bng_xsk_probe(void) {
#ifdef __linux__
  int fd = socket(AF_XDP, SOCK_RAW, 0);
  if (fd < 0) return BNG_XSK_UNAVAILABLE;
  close(fd);
  return BNG_XSK_COPY; /* socket works; bind mode resolved at open() */
#else
  return BNG_XSK_UNAVAILABLE;
#endif
}

#ifdef __linux__
static bool map_ring(int fd, uint64_t pgoff, size_t desc_size,
                     uint32_t entries, const xdp_ring_offset &off,
                     void **map, size_t *map_len, uint32_t **prod,
                     uint32_t **cons, void **ring) {
  size_t len = off.desc + static_cast<size_t>(entries) * desc_size;
  void *m = mmap(nullptr, len, PROT_READ | PROT_WRITE,
                 MAP_SHARED | MAP_POPULATE, fd, pgoff);
  if (m == MAP_FAILED) return false;
  *map = m;
  *map_len = len;
  *prod = reinterpret_cast<uint32_t *>(static_cast<uint8_t *>(m) + off.producer);
  *cons = reinterpret_cast<uint32_t *>(static_cast<uint8_t *>(m) + off.consumer);
  *ring = static_cast<uint8_t *>(m) + off.desc;
  return true;
}
#endif

/* Open an AF_XDP socket bound to ifname/queue over the caller's UMEM
 * (the bngring frame area — zero-copy through to the batch assembler).
 * Tries XDP_ZEROCOPY first, then XDP_COPY (the driver->generic ladder).
 * Returns a handle, or nullptr with *err set to the failed rung. */
bng_xsk *bng_xsk_open(const char *ifname, uint32_t queue, void *umem_area,
                      uint64_t umem_size, uint32_t frame_size,
                      uint32_t ring_size, int *err) {
#ifndef __linux__
  if (err) *err = BNG_XSK_E_SOCKET;
  (void)ifname; (void)queue; (void)umem_area; (void)umem_size;
  (void)frame_size; (void)ring_size;
  return nullptr;
#else
  auto fail = [&](int e, bng_xsk *s) -> bng_xsk * {
    if (err) *err = e;
    if (s) {
      /* unmap everything mapped so far — a retrying supervisor must not
       * accumulate ring mappings across failed opens */
      if (s->rx_map) munmap(s->rx_map, s->rx_map_len);
      if (s->tx_map) munmap(s->tx_map, s->tx_map_len);
      if (s->fr_map) munmap(s->fr_map, s->fr_map_len);
      if (s->cr_map) munmap(s->cr_map, s->cr_map_len);
      if (s->fd >= 0) close(s->fd);
      delete s;
    }
    return nullptr;
  };

  /* kernel UMEM constraints up front: page-aligned area, power-of-two
   * chunk in [2048, page]. bngring allocates page-aligned since r3; a
   * mismatched frame_size is a config error, not a bind-mode problem. */
  if ((reinterpret_cast<uint64_t>(umem_area) & 4095) != 0 ||
      frame_size < 2048 || frame_size > 4096 ||
      (frame_size & (frame_size - 1)) != 0)
    return fail(BNG_XSK_E_UMEM, nullptr);

  uint32_t ifindex = if_nametoindex(ifname);
  if (ifindex == 0) return fail(BNG_XSK_E_IFACE, nullptr);

  auto *s = new (std::nothrow) bng_xsk();
  if (!s) return fail(BNG_XSK_E_SOCKET, nullptr);
  s->fd = socket(AF_XDP, SOCK_RAW, 0);
  if (s->fd < 0) return fail(BNG_XSK_E_SOCKET, s);
  s->ifindex = ifindex;
  s->queue = queue;
  s->ring_size = ring_size;

  xdp_umem_reg reg{};
  reg.addr = reinterpret_cast<uint64_t>(umem_area);
  reg.len = umem_size;
  reg.chunk_size = frame_size;
  reg.headroom = 0;
  if (setsockopt(s->fd, SOL_XDP, XDP_UMEM_REG, &reg, sizeof(reg)) != 0)
    return fail(BNG_XSK_E_UMEM, s);

  if (setsockopt(s->fd, SOL_XDP, XDP_UMEM_FILL_RING, &ring_size,
                 sizeof(ring_size)) != 0 ||
      setsockopt(s->fd, SOL_XDP, XDP_UMEM_COMPLETION_RING, &ring_size,
                 sizeof(ring_size)) != 0 ||
      setsockopt(s->fd, SOL_XDP, XDP_RX_RING, &ring_size,
                 sizeof(ring_size)) != 0 ||
      setsockopt(s->fd, SOL_XDP, XDP_TX_RING, &ring_size,
                 sizeof(ring_size)) != 0)
    return fail(BNG_XSK_E_RINGS, s);

  xdp_mmap_offsets offs{};
  socklen_t optlen = sizeof(offs);
  if (getsockopt(s->fd, SOL_XDP, XDP_MMAP_OFFSETS, &offs, &optlen) != 0)
    return fail(BNG_XSK_E_RINGS, s);

  void *ring_ptr;
  if (!map_ring(s->fd, XDP_PGOFF_RX_RING, sizeof(xdp_desc), ring_size,
                offs.rx, &s->rx_map, &s->rx_map_len, &s->rx_prod,
                &s->rx_cons, &ring_ptr))
    return fail(BNG_XSK_E_MMAP, s);
  s->rx_ring = static_cast<xdp_desc *>(ring_ptr);
  if (!map_ring(s->fd, XDP_PGOFF_TX_RING, sizeof(xdp_desc), ring_size,
                offs.tx, &s->tx_map, &s->tx_map_len, &s->tx_prod,
                &s->tx_cons, &ring_ptr))
    return fail(BNG_XSK_E_MMAP, s);
  s->tx_ring = static_cast<xdp_desc *>(ring_ptr);
  if (!map_ring(s->fd, XDP_UMEM_PGOFF_FILL_RING, sizeof(uint64_t), ring_size,
                offs.fr, &s->fr_map, &s->fr_map_len, &s->fr_prod,
                &s->fr_cons, &ring_ptr))
    return fail(BNG_XSK_E_MMAP, s);
  s->fr_ring = static_cast<uint64_t *>(ring_ptr);
  if (!map_ring(s->fd, XDP_UMEM_PGOFF_COMPLETION_RING, sizeof(uint64_t),
                ring_size, offs.cr, &s->cr_map, &s->cr_map_len, &s->cr_prod,
                &s->cr_cons, &ring_ptr))
    return fail(BNG_XSK_E_MMAP, s);
  s->cr_ring = static_cast<uint64_t *>(ring_ptr);

  sockaddr_xdp sxdp{};
  sxdp.sxdp_family = AF_XDP;
  sxdp.sxdp_ifindex = ifindex;
  sxdp.sxdp_queue_id = queue;
  /* rung 0: zero-copy driver mode */
  sxdp.sxdp_flags = XDP_ZEROCOPY;
  if (bind(s->fd, reinterpret_cast<sockaddr *>(&sxdp), sizeof(sxdp)) == 0) {
    s->mode = BNG_XSK_ZEROCOPY;
    return s;
  }
  /* rung 1: generic copy mode */
  sxdp.sxdp_flags = XDP_COPY;
  if (bind(s->fd, reinterpret_cast<sockaddr *>(&sxdp), sizeof(sxdp)) == 0) {
    s->mode = BNG_XSK_COPY;
    return s;
  }
  return fail(BNG_XSK_E_BIND, s);
#endif
}

int bng_xsk_mode(bng_xsk *s) { return s ? s->mode : BNG_XSK_UNAVAILABLE; }
int bng_xsk_fd(bng_xsk *s) { return s ? s->fd : -1; }

void bng_xsk_close(bng_xsk *s) {
  if (!s) return;
#ifdef __linux__
  if (s->rx_map) munmap(s->rx_map, s->rx_map_len);
  if (s->tx_map) munmap(s->tx_map, s->tx_map_len);
  if (s->fr_map) munmap(s->fr_map, s->fr_map_len);
  if (s->cr_map) munmap(s->cr_map, s->cr_map_len);
  if (s->fd >= 0) close(s->fd);
#endif
  delete s;
}

#ifdef __linux__
/* Submit free frame addrs to the kernel fill ring. Returns count taken. */
uint32_t bng_xsk_fill(bng_xsk *s, const uint64_t *addrs, uint32_t n) {
  uint32_t prod = __atomic_load_n(s->fr_prod, __ATOMIC_RELAXED);
  uint32_t cons = __atomic_load_n(s->fr_cons, __ATOMIC_ACQUIRE);
  uint32_t free_slots = s->ring_size - (prod - cons);
  if (n > free_slots) n = free_slots;
  for (uint32_t i = 0; i < n; i++)
    s->fr_ring[(prod + i) & (s->ring_size - 1)] = addrs[i];
  __atomic_store_n(s->fr_prod, prod + n, __ATOMIC_RELEASE);
  return n;
}

/* Drain received descriptors: out_addrs/out_lens arrays of cap entries. */
uint32_t bng_xsk_rx(bng_xsk *s, uint64_t *out_addrs, uint32_t *out_lens,
                    uint32_t cap) {
  uint32_t cons = __atomic_load_n(s->rx_cons, __ATOMIC_RELAXED);
  uint32_t prod = __atomic_load_n(s->rx_prod, __ATOMIC_ACQUIRE);
  uint32_t n = prod - cons;
  if (n > cap) n = cap;
  for (uint32_t i = 0; i < n; i++) {
    const xdp_desc &d = s->rx_ring[(cons + i) & (s->ring_size - 1)];
    out_addrs[i] = d.addr;
    out_lens[i] = d.len;
  }
  __atomic_store_n(s->rx_cons, cons + n, __ATOMIC_RELEASE);
  return n;
}

/* Queue frames for transmit; kick with sendto. Returns count queued. */
uint32_t bng_xsk_tx(bng_xsk *s, const uint64_t *addrs, const uint32_t *lens,
                    uint32_t n) {
  uint32_t prod = __atomic_load_n(s->tx_prod, __ATOMIC_RELAXED);
  uint32_t cons = __atomic_load_n(s->tx_cons, __ATOMIC_ACQUIRE);
  uint32_t free_slots = s->ring_size - (prod - cons);
  if (n > free_slots) n = free_slots;
  for (uint32_t i = 0; i < n; i++) {
    xdp_desc &d = s->tx_ring[(prod + i) & (s->ring_size - 1)];
    d.addr = addrs[i];
    d.len = lens[i];
    d.options = 0;
  }
  __atomic_store_n(s->tx_prod, prod + n, __ATOMIC_RELEASE);
  if (n) sendto(s->fd, nullptr, 0, MSG_DONTWAIT, nullptr, 0);
  return n;
}

/* Reclaim completed TX frame addrs. */
uint32_t bng_xsk_complete(bng_xsk *s, uint64_t *out_addrs, uint32_t cap) {
  uint32_t cons = __atomic_load_n(s->cr_cons, __ATOMIC_RELAXED);
  uint32_t prod = __atomic_load_n(s->cr_prod, __ATOMIC_ACQUIRE);
  uint32_t n = prod - cons;
  if (n > cap) n = cap;
  for (uint32_t i = 0; i < n; i++)
    out_addrs[i] = s->cr_ring[(cons + i) & (s->ring_size - 1)];
  __atomic_store_n(s->cr_cons, cons + n, __ATOMIC_RELEASE);
  return n;
}
#else
uint32_t bng_xsk_fill(bng_xsk *, const uint64_t *, uint32_t) { return 0; }
uint32_t bng_xsk_rx(bng_xsk *, uint64_t *, uint32_t *, uint32_t) { return 0; }
uint32_t bng_xsk_tx(bng_xsk *, const uint64_t *, const uint32_t *, uint32_t) {
  return 0;
}
uint32_t bng_xsk_complete(bng_xsk *, uint64_t *, uint32_t) { return 0; }
#endif

} /* extern "C" */
