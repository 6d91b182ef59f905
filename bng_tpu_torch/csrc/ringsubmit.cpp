/* Batch RX submit with one flags word per frame, over a bngring ring.
 *
 * A two-port box's RX interleaves access-side and core-side frames.
 * bngring.cpp's batch submit takes one flags word for the whole batch, so
 * this loop submits each frame with its own flags through the ring's
 * scalar verb (bng_ring_rx_submit, passed in as a function pointer: the
 * ring library is a byte-for-byte copy of the reference's and gains no
 * symbol). Every frame is classified, steered and queued exactly as that
 * verb does it, in the order given. out_ok[i] = 1 submitted / 0 refused;
 * returns the count submitted. Built on first use by
 * runtime/nativelib.py, bound in runtime/ring.py. */
#include <stdint.h>

typedef int (*bng_rx_submit_fn)(void *ring, uint64_t addr, uint32_t len,
                                uint32_t flags);

extern "C" uint32_t bng_rx_submit_each(void *ring, bng_rx_submit_fn submit,
                                       const uint64_t *addrs,
                                       const uint32_t *lens,
                                       const uint32_t *flags, uint8_t *out_ok,
                                       uint32_t n) {
  uint32_t ok_n = 0;
  for (uint32_t i = 0; i < n; i++) {
    out_ok[i] = submit(ring, addrs[i], lens[i], flags[i]) == 0 ? 1 : 0;
    ok_n += out_ok[i];
  }
  return ok_n;
}
