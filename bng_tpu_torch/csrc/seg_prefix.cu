// K2: same-slot inclusive prefix sums and segment totals for Hopper (sm_90a).
//
// Replaces: bng_tpu/ops/pallas_qos.py:seg_prefix_total (pl.pallas_call at
// :127, body _seg_kernel :54-93), which contracted [256 x 256] f32
// equality tiles against value tiles on the MXU, carrying each row block's
// sum across the sequential j grid dimension.
//
// What bounds it on this card: the function needs only O(B) bytes (slot
// and vec in, two f32 vectors out: 128 KiB at B = 8192, ~0.04 us at
// 3.35 TB/s) and O(B) adds, so one call is bound by latency: the launch
// and the chain of dependent block-wide steps inside it. The TPU's
// equality formulation is B^2 work (67 M compare-adds at B = 8192).
//
// What the design does about it. Route 1, B <= kBOne (8192, the main
// path's batch): one CTA of 1024 threads takes the whole batch in about
// 210 KiB of dynamic shared memory (opted into above 48 KiB). On the main
// path nearly every lane has its slot to itself (QoS gives unlimited lanes
// unique negative ids, and few subscribers send twice in a batch), and a
// lone lane's prefix and total are its own word. So:
//   1. Lanes are loaded coalesced, all loads in flight at once. Each lane
//      sets its bit (a hash of its slot id) in a 2^19-bit filter with one
//      atomicOr; a lane that finds its bit already set also sets it in a
//      second filter. After one barrier, a lane whose bit is clear in the
//      second filter is alone in its slot. The rest (truly shared slots
//      plus ~1.5% collisions) do the same under another hash in a pair of
//      2^16-bit filters. Every lane of a shared slot is in that rest, so
//      the second pair sees only it. A lane found alone writes its outputs
//      at once; the others (shared slots plus a handful of double
//      collisions) are the candidates. Shared-memory atomics that return a
//      value are the costly part of this step, hence a single pass over
//      all lanes.
//   2. Candidates are compacted in lane order (ballots, and one warp's
//      scan of the 256 per-warp counts).
//   3. Up to 32 candidates (the main path's case): one warp sorts them by
//      (slot id, candidate index) with a bitonic network of shuffles and
//      takes a segmented scan by shuffles, with no block barrier. More
//      candidates: a bitonic sort in shared memory, one barrier a stage,
//      then one CUB block scan with a segmented operator. Either way equal
//      ids end up together, in lane order; grouping is by equality of the
//      32 id bits alone.
//   4. Sums are uint64, exact for any uint32 input (the TPU's f32
//      accumulation is exact below 2^24). Each tail stores its segment
//      total at its head, and both outputs are converted once to f32,
//      rounding to nearest; the output not asked for is zeros.
// The work is O(B) for lone lanes and O(n log^2 n) for n candidates: no
// B^2 sweep. Two designs came out slower on the card and were dropped: a
// shared-memory hash table with linear probing (each probe step waits for
// an atomic round trip), and a CUB block radix sort plus segmented scan of
// the whole batch (one SM spends several microseconds on each pass).
// Route 2, B > kBOne: the equality sweep (64-bit partial sums, 8 warps
// split the j range of 32 lanes i, broadcast loads), chosen by B alone.
// CUB's block scan is a part of this kernel; no device-wide sort or scan
// is called.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

// ---- route 1: one CTA; filter out lone slots, sort and scan the rest ----

#ifndef BNG_B_ONE
#error "build with -DBNG_B_ONE=<largest B of route 1> (bng_tpu_torch/kernels.py passes it)"
#endif
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBOne = BNG_B_ONE;                  // largest B of route 1
constexpr int kItems = kBOne / kThreads;          // lanes per thread
static_assert(kItems * kThreads == kBOne, "route 1 takes kItems lanes a thread");
constexpr int kBitsA = 19;                        // the first pair of filters: all lanes
constexpr int kBitsB = 16;                        // the second pair: the first's candidates
constexpr int kWordsA = 1 << (kBitsA - 5);
constexpr int kWordsB = 1 << (kBitsB - 5);
constexpr uint32_t kSeedB = 0x85EBCA6Bu;          // the second pair's hash
static_assert(kItems * kWarps == 32 * 8, "warp 0 scans the lane-group counts, 8 a thread");

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

struct SegItem {
  unsigned long long sum;  // inclusive sum since the segment head
  int head;                // sorted position of the segment head (-1: not a head, before the scan)
};

// Segmented inclusive scan: a head restarts the sum and names the segment.
struct SegOp {
  __device__ __forceinline__ SegItem operator()(const SegItem& a, const SegItem& b) const {
    return b.head >= 0 ? b : SegItem{a.sum + b.sum, a.head};
  }
};

using SegScanT = cub::BlockScan<SegItem, kThreads>;

struct ScanSmem {
  union {
    struct {  // per hash: a lane's bit in `seen`, and in `twice` when seen before
      uint32_t seen_a[kWordsA];
      uint32_t twice_a[kWordsA];
      uint32_t seen_b[kWordsB];
      uint32_t twice_b[kWordsB];
    } filter;
    struct {  // candidates (lanes whose slot may be shared), in lane order
      uint32_t lane[kBOne];
      uint32_t vec[kBOne];
      unsigned long long total[kBOne];  // segment total by sorted head position
    } cand;
  } a;
  unsigned long long sorted[kBOne];  // slot id << 32 | candidate index
  int base[kItems * kWarps];         // candidates before each (item, warp) lane group
  int n_cand;
  SegScanT::TempStorage seg;
};

// One stage of a bitonic sort of v[0, n2) in shared memory: pairs (i, i|d)
// sorted up where bit k of i is clear, down where it is set.
__device__ __forceinline__ void bitonic_stage(unsigned long long* v, int n2, int k, int d) {
  for (int t = threadIdx.x; t < n2 / 2; t += kThreads) {
    const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
    const int l = i | d;
    const unsigned long long x = v[i], y = v[l];
    if ((x > y) == ((i & k) == 0)) {
      v[i] = y;
      v[l] = x;
    }
  }
  __syncthreads();
}

// Segmented scan of the n sorted candidates, kItems per thread, and their
// outputs.
__device__ __forceinline__ void scan_candidates(ScanSmem& sm, int n, int want_prefix,
                                                int want_total, float* __restrict__ pref_out,
                                                float* __restrict__ tot_out) {
  constexpr int I = kItems;
  const int tid = threadIdx.x;
  SegItem it[I];
  uint32_t idx[I];
  bool tail[I];
#pragma unroll
  for (int j = 0; j < I; ++j) {
    const int q = tid * I + j;
    idx[j] = 0u;
    tail[j] = false;
    it[j].sum = 0ull;
    it[j].head = q;  // past n: lone heads that touch nothing
    if (q < n) {
      const unsigned long long e = sm.sorted[q];
      const uint32_t key = (uint32_t)(e >> 32);
      idx[j] = (uint32_t)e;
      it[j].sum = sm.a.cand.vec[idx[j]];
      it[j].head = (q == 0 || (uint32_t)(sm.sorted[q - 1] >> 32) != key) ? q : -1;
      tail[j] = q == n - 1 || (uint32_t)(sm.sorted[q + 1] >> 32) != key;
    }
  }
  SegScanT(sm.seg).InclusiveScan(it, it, SegOp());
  if (want_total) {
#pragma unroll
    for (int j = 0; j < I; ++j)
      if (tail[j]) sm.a.cand.total[it[j].head] = it[j].sum;
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < I; ++j) {
    if (tid * I + j < n) {
      const uint32_t lane = sm.a.cand.lane[idx[j]];
      pref_out[lane] = want_prefix ? __ull2float_rn(it[j].sum) : 0.0f;
      tot_out[lane] = want_total ? __ull2float_rn(sm.a.cand.total[it[j].head]) : 0.0f;
    }
  }
}

// Up to 32 candidates, one per lane of the calling warp: bitonic sort by
// shuffles, then a segmented scan by shuffles (segments are contiguous
// once sorted), totals through shared memory by head lane.
__device__ __forceinline__ void scan_few(ScanSmem& sm, int n, int want_prefix, int want_total,
                                         float* __restrict__ pref_out,
                                         float* __restrict__ tot_out) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  unsigned long long x = lane < n ? sm.sorted[lane] : ~0ull;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      const unsigned long long y = __shfl_xor_sync(kAll, x, d);
      const bool take_min = ((lane & d) == 0) == ((lane & k) == 0);
      x = take_min ? (y < x ? y : x) : (y > x ? y : x);
    }
  }
  const uint32_t key = (uint32_t)(x >> 32), idx = (uint32_t)x;
  const bool valid = lane < n;
  const uint32_t prev_key = __shfl_up_sync(kAll, key, 1);
  const uint32_t next_key = __shfl_down_sync(kAll, key, 1);
  const bool head = lane == 0 || prev_key != key;
  const bool tail = valid && (lane == n - 1 || next_key != key);
  unsigned long long sum = valid ? sm.a.cand.vec[idx] : 0ull;
  bool seen_head = head;  // a head lies between the window's start and this lane
  int head_at = head ? lane : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long s = __shfl_up_sync(kAll, sum, o);
    const bool h = __shfl_up_sync(kAll, seen_head, o);
    const int at = __shfl_up_sync(kAll, head_at, o);
    if (lane >= o) {
      if (!seen_head) sum += s;
      seen_head = seen_head || h;
      head_at = max(head_at, at);
    }
  }
  if (want_total && tail) sm.a.cand.total[head_at] = sum;
  __syncwarp();
  if (valid) {
    const uint32_t at = sm.a.cand.lane[idx];
    pref_out[at] = want_prefix ? __ull2float_rn(sum) : 0.0f;
    tot_out[at] = want_total ? __ull2float_rn(sm.a.cand.total[head_at]) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 1) seg_scan_kernel(
    const int32_t* __restrict__ slot, const uint32_t* __restrict__ vec, int B,
    int want_prefix, int want_total, float* __restrict__ pref_out,
    float* __restrict__ tot_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wlane = tid & 31;

  uint4* filter = reinterpret_cast<uint4*>(&sm.a.filter);
  for (int w = tid; w < (2 * kWordsA + 2 * kWordsB) / 4; w += kThreads)
    filter[w] = make_uint4(0u, 0u, 0u, 0u);
  uint32_t key[kItems], val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {  // lane j*kThreads + tid: coalesced
    const int p = j * kThreads + tid;
    key[j] = p < B ? (uint32_t)__ldg(slot + p) : 0u;
    val[j] = p < B ? __ldg(vec + p) : 0u;
  }
  __syncthreads();

  // 1. filters: a lane whose bit nobody else set has its slot to itself.
  //    Lanes sharing a slot share every bit, so a slot's lanes are all
  //    candidates of the first pair, and the second pair needs to see only
  //    those candidates.
  uint32_t bit[kItems], old[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    bit[j] = mix32(key[j]) >> (32 - kBitsA);
    old[j] = j * kThreads + tid < B
                 ? atomicOr(&sm.a.filter.seen_a[bit[j] >> 5], 1u << (bit[j] & 31)) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (old[j] >> (bit[j] & 31) & 1u) atomicOr(&sm.a.filter.twice_a[bit[j] >> 5], 1u << (bit[j] & 31));
  __syncthreads();
  unsigned cand = 0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j * kThreads + tid < B && (sm.a.filter.twice_a[bit[j] >> 5] >> (bit[j] & 31) & 1u)) {
      cand |= 1u << j;
      bit[j] = mix32(key[j] ^ kSeedB) >> (32 - kBitsB);
      if (atomicOr(&sm.a.filter.seen_b[bit[j] >> 5], 1u << (bit[j] & 31)) >> (bit[j] & 31) & 1u)
        atomicOr(&sm.a.filter.twice_b[bit[j] >> 5], 1u << (bit[j] & 31));
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = j * kThreads + tid;
    if ((cand >> j & 1u) && !(sm.a.filter.twice_b[bit[j] >> 5] >> (bit[j] & 31) & 1u))
      cand &= ~(1u << j);
    if (p < B && !(cand >> j & 1u)) {  // prefix = total = its own word
      pref_out[p] = want_prefix ? __uint2float_rn(val[j]) : 0.0f;
      tot_out[p] = want_total ? __uint2float_rn(val[j]) : 0.0f;
    }
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, cand >> j & 1u);
    if (wlane == 0) sm.base[j * kWarps + warp] = __popc(bal);
  }
  __syncthreads();  // the filters are read: their space takes the candidates

  // 2. compact the candidates in lane order: warp 0 scans the counts of
  //    the kItems * kWarps lane groups, 8 per thread
  if (warp == 0) {
    int c[8], run = 0;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      c[g] = sm.base[wlane * 8 + g];
      run += c[g];
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (wlane >= o) incl += t;
    }
    run = incl - run;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      sm.base[wlane * 8 + g] = run;
      run += c[g];
    }
    if (wlane == 31) sm.n_cand = incl;
  }
  __syncthreads();
  const int n = sm.n_cand;
  if (n == 0) return;
  const unsigned below = (1u << wlane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, cand >> j & 1u);
    if (cand >> j & 1u) {
      const int at = sm.base[j * kWarps + warp] + __popc(bal & below);
      sm.a.cand.lane[at] = j * kThreads + tid;
      sm.a.cand.vec[at] = val[j];
      sm.sorted[at] = (unsigned long long)key[j] << 32 | (uint32_t)at;
    }
  }
  __syncthreads();
  if (n <= 32) {  // the common case: one warp sorts and scans them in registers
    if (warp == 0) scan_few(sm, n, want_prefix, want_total, pref_out, tot_out);
    return;
  }
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int q = n + tid; q < n2; q += kThreads) sm.sorted[q] = ~0ull;  // pads sort last
  __syncthreads();

  // 3. bitonic sort of (slot id, candidate index): equal ids end up
  //    together, in lane order
  for (int k = 2; k <= n2; k <<= 1)
    for (int d = k >> 1; d > 0; d >>= 1) bitonic_stage(sm.sorted, n2, k, d);

  // 4. segmented scan over the sorted candidates
  scan_candidates(sm, n, want_prefix, want_total, pref_out, tot_out);
}

// ---- route 2: the equality sweep, for B > kBOne ----

constexpr int kLanes = 32;  // lanes i per block (one warp's width)
constexpr int kParts = 8;   // warps per block, each one part of the j range

__global__ void __launch_bounds__(kLanes * kParts) seg_sweep_kernel(
    const int32_t* __restrict__ slot, const uint32_t* __restrict__ vec, int B,
    int want_prefix, int want_total, float* __restrict__ pref_out,
    float* __restrict__ tot_out) {
  __shared__ unsigned long long s_pref[kParts][kLanes];
  __shared__ unsigned long long s_tot[kParts][kLanes];
  const int lane = threadIdx.x & (kLanes - 1);
  const int part = threadIdx.x / kLanes;
  const int i = blockIdx.x * kLanes + lane;
  const bool valid = i < B;

  unsigned long long p = 0, t = 0;
  if (valid) {
    const int32_t si = slot[i];
    const int chunk = (B + kParts - 1) / kParts;
    const int j0 = part * chunk;
    int j1 = min(B, j0 + chunk);
    if (!want_total) j1 = min(j1, i + 1);  // prefix only needs j <= i
    for (int j = j0; j < j1; ++j) {
      if (__ldg(slot + j) == si) {
        const unsigned long long v = __ldg(vec + j);
        t += v;
        if (j <= i) p += v;
      }
    }
  }
  s_pref[part][lane] = p;
  s_tot[part][lane] = t;
  __syncthreads();
  if (part == 0 && valid) {
    unsigned long long P = 0, T = 0;
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      P += s_pref[q][lane];
      T += s_tot[q][lane];
    }
    pref_out[i] = want_prefix ? __ull2float_rn(P) : 0.0f;
    tot_out[i] = want_total ? __ull2float_rn(T) : 0.0f;
  }
}

}  // namespace

extern "C" int bng_seg_prefix(const void* slot, const void* vec, int B, int want_prefix,
                              int want_total, void* pref, void* tot, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= kBOne) {
    // once per process: route 1 opts into more than 48 KiB of shared memory
    static const cudaError_t e = cudaFuncSetAttribute(
        seg_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(ScanSmem));
    if (e != cudaSuccess) return (int)e;
    seg_scan_kernel<<<1, kThreads, sizeof(ScanSmem), s>>>(
        (const int32_t*)slot, (const uint32_t*)vec, B, want_prefix, want_total,
        (float*)pref, (float*)tot);
  } else {
    seg_sweep_kernel<<<(B + kLanes - 1) / kLanes, kLanes * kParts, 0, s>>>(
        (const int32_t*)slot, (const uint32_t*)vec, B, want_prefix, want_total,
        (float*)pref, (float*)tot);
  }
  return (int)cudaGetLastError();
}
