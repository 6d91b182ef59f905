// The zero-copy ring's movers: a batch's frames between the ring's UMEM and
// a ring program's [B, L] buffers, by descriptor (runtime/engine.py's
// zero-copy ring loop, ops/umem.py's wrappers).
//
// Replaces no TPU kernel. The JAX reference moves frames with host copies
// (the ring's batch assemble into a staging buffer, its upload, the
// outputs' download and the ring's complete back into the frames); here the
// ring's UMEM is host memory registered with the card as mapped pinned
// memory (`bng_umem_register`), so these kernels read and write it over the
// host link, and the host copies no frame byte.
//
// - gather: lane i < n of `pkt` gets min(len_i, L) bytes from UMEM at
//   addr_i and zeros to L, `length[i]` that count, and `fa[i]` (when given)
//   the descriptor's from-access bit: the bytes, lengths and flags the
//   ring's batch assemble would stage. Lanes >= n get length 0 and zeros.
//   It also writes the batch's clock into the program's `now_s` / `now_us`.
// - scatter: lane i < n whose verdict is TX or FWD writes min(out_len_i,
//   frame_size - addr_i % frame_size, L) bytes of its `out_pkt` row back
//   over its frame, the clamp of the ring's batch complete; PASS and DROP
//   lanes are never written, nor is any byte past that count.
//
// The descriptors are one buffer of B lanes: addrs (u64) [B], lens (u32)
// [B], flags (u32) [B], back to back, written by the ring into pinned host
// memory. The gather's entry queues their one H2D copy into the program's
// device buffer and the kernel behind it, so a batch's upload is one call;
// the scatter reads the addrs from the same device buffer. (Read in place
// over the link instead, the descriptors cost 3 small requests a lane and
// tripled the mix's gather on the H100: 0.097 -> 0.304 ms.)
//
// What bounds them on this card: the host link (PCIe), not HBM. The
// IPoE mix's live bytes are ~2.0 MB a batch each way and the PPPoE cell's
// ~7.8 MB; a read over PCIe takes a microsecond or more, so the link is
// full only with many requests in flight. What the design does about it:
// - One warp a lane, 8 lanes a 256-thread block, so an SM holds 64 lanes
//   and the card all 8,192 lanes of a batch at once; each thread issues all
//   of its lane's 16-byte loads (up to kUnroll) before it stores any.
// - 16-byte loads and stores where the frame and the row are both 16-byte
//   aligned (frames at chunk bases, L % 16 == 0: the main path); a
//   headroom-offset descriptor or a ragged L takes coalesced byte copies
//   (each warp instruction moves 32 consecutive bytes).
// - Only live bytes cross the link: gather reads the chunks that hold
//   [0, min(len, L)) and writes the zero tail from registers; scatter
//   writes exactly the clamped count.
// - Host-memory loads go through `ld.global.cv` (`__ldcv`): no cached copy
//   of a host line outlives the kernel, so a frame the host rewrote before
//   a later launch is read fresh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kLanesPerBlock = kBlock / kWarp;  // 8
constexpr int kUnroll = 4;                      // 16-byte chunks a thread holds at once
constexpr uint32_t kFromAccess = 0x1u;          // BNG_DESC_F_FROM_ACCESS
constexpr int kDescBytes = 16;                  // a lane's descriptor: addr, len, flags
constexpr int32_t kVerdictTx = 2, kVerdictFwd = 3;

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
}

// bytes [0, keep) of v kept, the rest zero (little-endian words)
__device__ __forceinline__ uint32_t keep_low(uint32_t w, int keep) {
  return keep >= 4 ? w : (keep <= 0 ? 0u : (w & ((1u << (8 * keep)) - 1u)));
}

__global__ void __launch_bounds__(kBlock)
gather_kernel(const uint8_t* __restrict__ umem, const uint64_t* __restrict__ addrs,
              const uint32_t* __restrict__ lens, const uint32_t* __restrict__ flags, int n,
              int B, int L, uint8_t* __restrict__ pkt, int64_t* __restrict__ length,
              bool* __restrict__ fa, int64_t* __restrict__ now_s, long long now_s_val,
              int64_t* __restrict__ now_us,
              long long now_us_val) {
  const int lane = blockIdx.x * kLanesPerBlock + threadIdx.x / kWarp;
  const int t = threadIdx.x % kWarp;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *now_s = now_s_val;
    if (now_us != nullptr) *now_us = now_us_val;
  }
  if (lane >= B) return;
  uint8_t* dst = pkt + (size_t)lane * L;
  const uint8_t* src = nullptr;
  uint64_t addr = 0;
  int live = 0;
  if (lane < n) {
    addr = addrs[lane];
    src = umem + addr;
    live = (int)min(lens[lane], (uint32_t)L);
  }
  if (t == 0) {
    length[lane] = live;
    if (fa != nullptr) fa[lane] = lane < n && (flags[lane] & kFromAccess) != 0u;
  }
  if ((L & 15) == 0 && aligned16(src, dst)) {
    const int chunks = L >> 4;
    const int live_chunks = (live + 15) >> 4;
    for (int base = 0; base < chunks; base += kWarp * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * kWarp + t;
        v[u] = c < live_chunks ? __ldcv(reinterpret_cast<const uint4*>(src) + c)
                               : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * kWarp + t;
        if (c >= chunks) continue;
        const int keep = live - 16 * c;  // bytes of this chunk inside the frame
        if (keep < 16) {
          v[u].x = keep_low(v[u].x, keep);
          v[u].y = keep_low(v[u].y, keep - 4);
          v[u].z = keep_low(v[u].z, keep - 8);
          v[u].w = keep_low(v[u].w, keep - 12);
        }
        reinterpret_cast<uint4*>(dst)[c] = v[u];
      }
    }
  } else {
    for (int k = t; k < L; k += kWarp) dst[k] = k < live ? __ldcv(src + k) : (uint8_t)0;
  }
}

__global__ void __launch_bounds__(kBlock)
scatter_kernel(uint8_t* __restrict__ umem, const uint64_t* __restrict__ addrs, int n, int L,
               uint32_t frame_size, const int32_t* __restrict__ verdict,
               const uint8_t* __restrict__ out_pkt, const int64_t* __restrict__ out_len) {
  const int lane = blockIdx.x * kLanesPerBlock + threadIdx.x / kWarp;
  const int t = threadIdx.x % kWarp;
  if (lane >= n) return;
  const int32_t v = verdict[lane];
  if (v != kVerdictTx && v != kVerdictFwd) return;
  const uint64_t addr = addrs[lane];
  // the ring's complete: a u32 length clamped to the chunk's room, copied up to the slot
  uint32_t len = (uint32_t)out_len[lane];
  const uint32_t room = frame_size - (uint32_t)(addr % frame_size);
  len = min(len, room);
  const int w = (int)min(len, (uint32_t)L);
  uint8_t* dst = umem + addr;
  const uint8_t* src = out_pkt + (size_t)lane * L;
  if (aligned16(src, dst)) {
    const int full = w >> 4;
    for (int c = t; c < full; c += kWarp)
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
    const int k = 16 * full + t;
    if (k < w) dst[k] = src[k];
  } else {
    for (int k = t; k < w; k += kWarp) dst[k] = src[k];
  }
}

}  // namespace

// `stream` belongs to card `device`, where `desc`, `pkt`, `length`, `fa`,
// `now_s` and `now_us` live; `desc_host` is the pinned host buffer the
// descriptors are copied from, `umem` the UMEM's address on that card.
// `fa` and `now_us` may be null.
extern "C" int bng_umem_gather(const void* umem, const void* desc_host, void* desc, int n, int B,
                               int L, void* pkt, void* length, void* fa, void* now_s,
                               long long now_s_val, void* now_us, long long now_us_val,
                               void* stream, int device) {
  const bng::DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const cudaError_t err = cudaMemcpyAsync(desc, desc_host, (size_t)kDescBytes * B,
                                          cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* d = (const uint8_t*)desc;
  const int grid = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  gather_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)umem, (const uint64_t*)d, (const uint32_t*)(d + 8 * (size_t)B),
      (const uint32_t*)(d + 12 * (size_t)B), n, B, L, (uint8_t*)pkt, (int64_t*)length,
      (bool*)fa, (int64_t*)now_s, now_s_val, (int64_t*)now_us, now_us_val);
  return (int)cudaGetLastError();
}

// `addrs` the descriptors' addrs on card `device` (the gather's copy).
extern "C" int bng_umem_scatter(void* umem, const void* addrs, int n, int L, int frame_size,
                                const void* verdict, const void* out_pkt, const void* out_len,
                                void* stream, int device) {
  const bng::DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (n <= 0) return (int)cudaSuccess;
  const int grid = (n + kLanesPerBlock - 1) / kLanesPerBlock;
  scatter_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (uint8_t*)umem, (const uint64_t*)addrs, n, L, (uint32_t)frame_size,
      (const int32_t*)verdict, (const uint8_t*)out_pkt, (const int64_t*)out_len);
  return (int)cudaGetLastError();
}

// Pins and maps `size` bytes of host memory at `host` for every card
// (Portable | Mapped) and writes their address on card `device` (the host
// address itself under unified addressing). Returns the CUDA error.
extern "C" int bng_umem_register(void* host, size_t size, void** dev_ptr, int device) {
  const bng::DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = cudaHostRegister(host, size, cudaHostRegisterPortable | cudaHostRegisterMapped);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no sticky error for the next launch's check
    return (int)err;
  }
  err = cudaHostGetDevicePointer(dev_ptr, host, 0);
  if (err != cudaSuccess) {
    cudaHostUnregister(host);
    cudaGetLastError();
  }
  return (int)err;
}

extern "C" int bng_umem_unregister(void* host) {
  const cudaError_t err = cudaHostUnregister(host);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
