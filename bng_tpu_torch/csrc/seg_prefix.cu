// K2: same-slot inclusive prefix sums and segment totals for Hopper (sm_90a).
//
// Replaces: bng_tpu/ops/pallas_qos.py:seg_prefix_total (pl.pallas_call at
// :127, body _seg_kernel :54-93), which contracted [256 x 256] f32
// equality tiles against value tiles on the MXU, carrying each row block's
// sum across the sequential j grid dimension.
//
// What bounds it on this card: the function needs only its bytes, O(B)
// (slot and vec in, two f32 vectors out: 128 KiB at B = 8192, ~0.04 us at
// 3.35 TB/s), so in practice the launch itself is its floor. This first
// design does not reach that floor: the equality formulation below does
// B^2 compare-and-add steps (67 M at B = 8192), so it is bound by its own
// operations. A segmented scan over the lanes sorted by slot is O(B) and
// is the redesign.
//
// What the design does about it: a block owns 32 lanes i (one per thread
// of a warp) and splits the j range across its 8 warps. All threads of a
// warp walk the same j at the same time, so slot[j] and vec[j] are
// broadcast loads served from L1; each thread keeps its lane's partial
// sums in 64-bit integer registers (exact for any uint32 input, unlike the
// TPU's f32 accumulation, which is exact only below 2^24). The 8 partial
// sums of a lane are added in shared memory in a fixed order and converted
// to f32 once (round to nearest). Blocks share nothing, so no order between
// them matters: the sequential j sweep of the TPU grid became the loop
// inside the block. Ragged B is masked in-kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // lanes i per block (one warp's width)
constexpr int kParts = 8;   // warps per block, each one part of the j range

__global__ void __launch_bounds__(kLanes * kParts) seg_kernel(
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
  const int grid = (B + kLanes - 1) / kLanes;
  seg_kernel<<<grid, kLanes * kParts, 0, (cudaStream_t)stream>>>(
      (const int32_t*)slot, (const uint32_t*)vec, B, want_prefix, want_total,
      (float*)pref, (float*)tot);
  return (int)cudaGetLastError();
}
