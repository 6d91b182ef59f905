/* Descriptor-only batch assemble over a bngring ring: the zero-copy ring
 * loop's way in (runtime/engine.py).
 *
 * bng_batch_assemble_desc does what bng_batch_assemble does (round-robin
 * pop over the shard queues, one in-flight window opened, `rx` counted)
 * but copies no frame: it writes each lane's descriptor (UMEM offset,
 * length, flags) and the card reads the frames from the mapped UMEM
 * itself (csrc/umem.cu). Lane lengths are the descriptors' own; the
 * reader clamps them to its slot as stage_frame does. Returns the lanes
 * written; 0 opens no window.
 *
 * The ring's state is private to bngring.cpp, and that file stays the
 * reference's byte-for-byte copy, so this source includes it: the entry
 * reads a ring made by the ring library through the very definitions that
 * library was compiled from (runtime/nativelib.py builds both with the
 * same compiler and flags, and keys this build by bngring.cpp's bytes
 * too). Built on first use, bound in runtime/ring.py. */
#include "bngring.cpp"

extern "C" uint32_t bng_batch_assemble_desc(bng_ring *r, uint64_t *addrs,
                                            uint32_t *lens, uint32_t *flags,
                                            uint32_t max_batch) {
  if (r->inflight_count >= bng_ring::MAX_INFLIGHT) return 0; /* windows full */
  if (max_batch > r->inflight_cap) max_batch = r->inflight_cap;
  uint32_t tail =
      (r->inflight_head + r->inflight_count) % bng_ring::MAX_INFLIGHT;
  uint32_t n = 0;
  bng_desc d;
  uint32_t idle = 0;
  for (uint32_t s = 0; n < max_batch && idle < r->n_shards;
       s = (s + 1) % r->n_shards) {
    if (!r->rxq[s].pop(&d)) {
      idle++;
      continue;
    }
    idle = 0;
    addrs[n] = d.addr;
    lens[n] = d.len;
    flags[n] = d.flags;
    r->inflight[tail][n] = d;
    n++;
  }
  if (n == 0) return 0; /* empty assemble opens no window */
  r->inflight_n[tail] = n;
  r->inflight_count++;
  r->stats.rx += n;
  return n;
}
