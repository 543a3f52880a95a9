// s16.15 fixed-point helpers shared by the kernels.  The reference does its
// fixed-point arithmetic in int32 and lets XLA wrap on overflow; signed
// overflow is undefined in C++, so products and sums go through uint32 and
// are cast back (two's complement on every CUDA target).  `>>` on int32 is
// an arithmetic shift under nvcc, as in the reference.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// Grid for a grid-stride loop over n elements: enough blocks to fill the
// 132 SMs many times over, never more than the work needs.
inline unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return static_cast<unsigned>(blocks < 132 * 32 ? blocks : 132 * 32);
}
