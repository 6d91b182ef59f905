// The launch on its inputs' card, shared by the C entries of probe.cu and
// seg_prefix.cu.
#pragma once

#include <cuda_runtime.h>

namespace bng {

// Makes `device` current for the launch and restores the caller's card
// after: a launch into a stream of another card than the current one fails.
struct DeviceScope {
  int prev = -1;
  bool switched = false;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched) cudaSetDevice(prev);
  }
};

}  // namespace bng
