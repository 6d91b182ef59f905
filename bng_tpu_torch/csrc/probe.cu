// K1: fused bucketized-cuckoo table probe for Hopper (sm_90a).
//
// Replaces: bng_tpu/ops/pallas_table.py:_probe_jit (pl.pallas_call at :261,
// body _probe_kernel :81-192), bit-identical to ops/table.py:xla_lookup.
//
// What bounds it on this card: bytes, fetched by dependent scattered
// reads. Each lane reads its K query words, two packed bucket rows (4 ways
// x KW words: 128 B, or 256 B for K=8) and, on a hit, one V-word value
// row, and writes found/slot/vals. There is nearly no arithmetic (two
// lowbias32 hashes and a few compares), so the floor is the row traffic
// over HBM's 3.35 TB/s; in practice the latency of each lane's chain
// (query -> bucket rows -> value row) has to be hidden by many such
// chains in flight.
//
// What the design does about it:
// - Eight threads per query lane (256-thread blocks, 32 lanes each: 256
//   blocks at B = 8192 for 132 SMs). Thread c owns candidate c: b1 ways
//   0-3, then b2 ways 0-3. It reads that way's key words and used word
//   with 16-byte loads (way strides are 32 B and 64 B, so they align),
//   and a group-masked __ballot_sync takes the lowest matching candidate,
//   which keeps the reference's first-match order.
// - Both bucket rows are read at once (speculatively): a lane pays one
//   memory latency for both, and bytes beyond the bound only on a b1 hit.
//   Reading b2 only after b1 missed was timed against it on the main
//   path's eight calls on the H100 and was about 10% slower, so that
//   order was dropped.
// - Each block compacts the used stash rows (word K != 0) into shared
//   memory in stash order, with __ballot_sync/__popc prefixes, keeping
//   each row's stash index; the count stays in the kernel (no host sync,
//   no table field). Lanes that miss both buckets scan only those rows,
//   split over the group's 8 threads (entry s to thread s mod 8, one
//   ballot per round of 8, so the first match wins); with an empty stash
//   a miss costs nothing more. The entries are 9 words apart, so the 8
//   threads hit 8 different banks.
// - The group copies the winning value row with 16-byte loads and stores
//   (V is a multiple of 4: 2 vectors for V = 8, 4 for V = 16; zeros on a
//   miss); one thread writes found and slot. Ragged B is
//   masked in-kernel: no lane padding as the TPU's 128-lane tiles needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kWays = 4;
constexpr int kGroup = 8;                       // threads per query lane, one per candidate way
constexpr int kBlock = 256;
constexpr int kLanesPerBlock = kBlock / kGroup;  // 32
constexpr int kMaxStash = kBlock;               // one thread per stash row while compacting
constexpr int kStashStride = 9;                 // 8 key words + the stash index
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_words(const uint32_t (&q)[8], int K, uint32_t seed) {
  uint32_t h = mix32(q[0] ^ seed);
#pragma unroll
  for (int k = 1; k < 8; ++k)
    if (k < K) h = mix32(h ^ q[k]);
  return h;
}

// Word k of a way: a key word (k < K) to compare, or the used word (k == K).
template <int k>
__device__ __forceinline__ void take(uint32_t x, int K, const uint32_t (&q)[8], bool& m,
                                     uint32_t& used) {
  if (k < K) m = m && x == q[k & 7];
  if (k == K) used = x;
}

// Words 0..K of one way (K key words, then the used word), read as 16-byte
// vectors: two cover K <= 7 (KW = 8), three cover K = 8 (KW = 16).
__device__ __forceinline__ bool way_matches(const uint32_t* way, const uint32_t (&q)[8], int K) {
  const uint4* p = reinterpret_cast<const uint4*>(way);
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  bool m = true;
  uint32_t used = 0u;
  take<0>(a.x, K, q, m, used);
  take<1>(a.y, K, q, m, used);
  take<2>(a.z, K, q, m, used);
  take<3>(a.w, K, q, m, used);
  take<4>(b.x, K, q, m, used);
  take<5>(b.y, K, q, m, used);
  take<6>(b.z, K, q, m, used);
  take<7>(b.w, K, q, m, used);
  if (K >= 8) take<8>(__ldg(p + 2).x, K, q, m, used);
  return m && used != 0u;
}

__global__ void __launch_bounds__(kBlock) probe_kernel(
    const uint32_t* __restrict__ krows, const uint32_t* __restrict__ stash_rows,
    const uint32_t* __restrict__ vals, const uint32_t* __restrict__ query,
    int B, int K, int KW, int V, int nbuckets, int stash,
    bool* __restrict__ found_out, int32_t* __restrict__ slot_out,
    uint32_t* __restrict__ vals_out) {
  __shared__ uint32_t s_stash[kMaxStash * kStashStride];
  __shared__ int s_warp_used[kBlock / 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wlane = tid & 31;

  // 1. compact the used stash rows, in stash order
  const bool used = tid < stash && stash_rows[(size_t)tid * KW + K] != 0u;
  const unsigned used_bits = __ballot_sync(0xFFFFFFFFu, used);
  if (wlane == 0) s_warp_used[warp] = __popc(used_bits);
  __syncthreads();
  int n_used = 0, base = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) {
    const int n = s_warp_used[w];
    base += w < warp ? n : 0;
    n_used += n;
  }
  if (used) {
    uint32_t* e = s_stash + (base + __popc(used_bits & ((1u << wlane) - 1u))) * kStashStride;
    for (int k = 0; k < K; ++k) e[k] = stash_rows[(size_t)tid * KW + k];
    e[8] = (uint32_t)tid;
  }
  __syncthreads();

  // 2. the bucket ways: a group of 8 threads per query lane
  const int i = blockIdx.x * kLanesPerBlock + (tid >> 3);
  if (i >= B) return;  // whole groups leave together
  const int c = tid & (kGroup - 1);
  const int gshift = wlane & ~(kGroup - 1);
  const unsigned gmask = 0xFFu << gshift;

  uint32_t q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = k < K ? query[(size_t)i * K + k] : 0u;
  const uint32_t mask = (uint32_t)nbuckets - 1u;
  const uint32_t b1 = hash_words(q, K, kSeed1) & mask;
  const uint32_t b2 = hash_words(q, K, kSeed2) & mask;
  const uint32_t* way = krows + ((size_t)(c < kWays ? b1 : b2) * kWays + (c & 3)) * KW;

  const unsigned hits = (__ballot_sync(gmask, way_matches(way, q, K)) >> gshift) & 0xFFu;

  long long slot = -1;
  if (hits != 0u) {
    const int cand = __ffs(hits) - 1;
    slot = (long long)(cand < kWays ? b1 : b2) * kWays + (cand & 3);
  } else {
    // 3. the used stash rows, 8 per round, first match wins
    for (int s0 = 0; s0 < n_used; s0 += kGroup) {
      bool m = s0 + c < n_used;
      if (m) {
        const uint32_t* e = s_stash + (s0 + c) * kStashStride;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < K) m = m && e[k] == q[k];
      }
      const unsigned sh = (__ballot_sync(gmask, m) >> gshift) & 0xFFu;
      if (sh != 0u) {
        slot = (long long)nbuckets * kWays + s_stash[(s0 + __ffs(sh) - 1) * kStashStride + 8];
        break;
      }
    }
  }

  // 4. outputs: one thread writes found/slot, the group copies the value row
  const bool hit = slot >= 0;
  if (c == 0) {
    found_out[i] = hit;
    slot_out[i] = hit ? (int32_t)slot : (int32_t)(b1 * kWays);
  }
  uint4* dst = reinterpret_cast<uint4*>(vals_out + (size_t)i * V);  // V % 4 == 0
  const uint4* src = reinterpret_cast<const uint4*>(vals + (size_t)(hit ? slot : 0) * V);
  for (int w = c; w < (V >> 2); w += kGroup)
    dst[w] = hit ? __ldg(src + w) : make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace

// `stream` belongs to card `device`, where every pointer lives.
extern "C" int bng_probe(const void* krows, const void* stash_rows, const void* vals,
                         const void* query, int B, int K, int KW, int V, int nbuckets,
                         int stash, void* found, void* slot, void* vals_out, void* stream,
                         int device) {
  const bng::DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int grid = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  probe_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)krows, (const uint32_t*)stash_rows, (const uint32_t*)vals,
      (const uint32_t*)query, B, K, KW, V, nbuckets, stash, (bool*)found,
      (int32_t*)slot, (uint32_t*)vals_out);
  return (int)cudaGetLastError();
}
