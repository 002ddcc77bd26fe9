// Helpers shared by the hand-written Hopper kernels of this package.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i2i {

using bf16 = __nv_bfloat16;

// Eight bf16 values moved as one 16-byte word.
union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ Pack8 zero8() {
  Pack8 p;
  p.u = make_uint4(0u, 0u, 0u, 0u);
  return p;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

}  // namespace i2i
