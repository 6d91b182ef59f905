// K1: fused bucketized-cuckoo table probe for Hopper (sm_90a).
//
// Replaces: bng_tpu/ops/pallas_table.py:_probe_jit (pl.pallas_call at :261,
// body _probe_kernel :81-192), bit-identical to ops/table.py:xla_lookup.
//
// What bounds it on this card: bytes. Each lane reads its K query words,
// two packed bucket rows (4 ways x KW words: 128 B, or 256 B for K=8) and,
// on a hit, one V-word value row, and writes found/slot/vals. There is
// nearly no arithmetic (two lowbias32 hashes and a few compares), so the
// floor is the scattered row traffic over HBM's 3.35 TB/s.
//
// What the design does about it: one thread per query lane, 128 lanes a
// block. The bucket index is recomputed in-kernel with native uint32
// wrap (no host-side index staging, unlike the TPU kernel's scalar
// prefetch). Each bucket row is one contiguous 128/256 B line, read way by
// way in candidate order and abandoned at the first match; only the
// winning value row is fetched (the TPU kernel DMA'd both 4-way value
// blocks). The stash (<= 256 rows) is staged once per block in shared
// memory, compacted to its K key words + used flag, and scanned only by
// lanes that missed both buckets. Ragged B is masked in-kernel: no lane
// padding as the TPU's 128-lane tiles needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWays = 4;
constexpr int kBlock = 128;
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

__device__ __forceinline__ uint32_t hash_words(const uint32_t* q, int K, uint32_t seed) {
  uint32_t h = mix32(q[0] ^ seed);
  for (int k = 1; k < K; ++k) h = mix32(h ^ q[k]);
  return h;
}

__global__ void __launch_bounds__(kBlock) probe_kernel(
    const uint32_t* __restrict__ krows, const uint32_t* __restrict__ stash_rows,
    const uint32_t* __restrict__ vals, const uint32_t* __restrict__ query,
    int B, int K, int KW, int V, int nbuckets, int stash,
    bool* __restrict__ found_out, int32_t* __restrict__ slot_out,
    uint32_t* __restrict__ vals_out) {
  extern __shared__ uint32_t s_stash[];  // [stash][K + 1]: key words + used
  const int SW = K + 1;
  for (int t = threadIdx.x; t < stash * SW; t += blockDim.x) {
    const int r = t / SW, c = t - r * SW;
    s_stash[t] = stash_rows[(size_t)r * KW + c];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;

  uint32_t q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = k < K ? query[(size_t)i * K + k] : 0u;

  const uint32_t mask = (uint32_t)nbuckets - 1u;
  const uint32_t b1 = hash_words(q, K, kSeed1) & mask;
  const uint32_t b2 = hash_words(q, K, kSeed2) & mask;

  long long slot = -1;
  for (int side = 0; side < 2 && slot < 0; ++side) {
    const uint32_t b = side == 0 ? b1 : b2;
    const uint32_t* row = krows + (size_t)b * kWays * KW;
    for (int w = 0; w < kWays; ++w) {
      const uint32_t* way = row + w * KW;
      bool m = way[K] != 0u;
      for (int k = 0; k < K && m; ++k) m = way[k] == q[k];
      if (m) {
        slot = (long long)b * kWays + w;
        break;
      }
    }
  }
  if (slot < 0) {
    for (int s = 0; s < stash; ++s) {
      const uint32_t* e = s_stash + s * SW;
      bool m = e[K] != 0u;
      for (int k = 0; k < K && m; ++k) m = e[k] == q[k];
      if (m) {
        slot = (long long)nbuckets * kWays + s;
        break;
      }
    }
  }

  const bool hit = slot >= 0;
  found_out[i] = hit;
  slot_out[i] = hit ? (int32_t)slot : (int32_t)(b1 * kWays);
  uint32_t* dst = vals_out + (size_t)i * V;
  if (hit) {
    const uint32_t* src = vals + (size_t)slot * V;
    for (int v = 0; v < V; ++v) dst[v] = src[v];
  } else {
    for (int v = 0; v < V; ++v) dst[v] = 0u;
  }
}

}  // namespace

extern "C" int bng_probe(const void* krows, const void* stash_rows, const void* vals,
                         const void* query, int B, int K, int KW, int V, int nbuckets,
                         int stash, void* found, void* slot, void* vals_out, void* stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  const size_t smem = (size_t)stash * (K + 1) * sizeof(uint32_t);
  probe_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)krows, (const uint32_t*)stash_rows, (const uint32_t*)vals,
      (const uint32_t*)query, B, K, KW, V, nbuckets, stash, (bool*)found,
      (int32_t*)slot, (uint32_t*)vals_out);
  return (int)cudaGetLastError();
}
