// s16.15 fixed-point exp and ln for Hopper (sm_90a).
//
// fx_exp replaces the Pallas kernel
// repro/kernels/explog/explog.py::_fx_exp_kernel (via fx_exp_pallas and
// explog/ops.py::fx_exp): clip to +-15, range-reduce by LN2 with a floor
// divide, a 15-step shift-add ladder over ln(1 + 2^-k), a first-order
// remainder and a saturating 2^n shift.
//
// fx_log replaces repro/kernels/explog/explog.py::_fx_log_kernel (via
// fx_log_pallas and explog/ops.py::fx_log): normalise x to z in [1, 2)
// with shifts of 15/8/4/2/1 down and 8/4/2/1/1 up, then the same ladder
// run the other way (take the factor 1 + 2^-k while w (1 + 2^-k) <= z,
// adding ln(1 + 2^-k)), a first-order remainder (z - w) / w floor-divided,
// and -2^30 for x <= 0.  Every intermediate stays inside int32 (z < 2^16),
// so nothing wraps; the divide is written as a floor all the same.
//
// Bound: on the synfire path fx_exp computes one element, the LIF decay
// alpha, so it is bound by launch latency; on a 1 M-element sample either
// function reads and writes 8 MB (>= 2.5 us at 3.35 TB/s) against 60-80
// integer operations per element, still memory-bound.  Design: one
// thread per element, grid-stride over flat int32; the ladder's table
// sits in __constant__ memory, where every thread of a warp reads the same
// entry at once (a broadcast).  C++ `/` truncates, so the floor divide is written out; the
// 2^n shift goes through uint32 to reproduce the reference's wrap.
#include "fixed_point.cuh"

namespace {
constexpr int32_t kFxOne = 1 << 15;
constexpr int32_t kLn2 = 22713;                 // round(ln 2 * 2^15)
constexpr int32_t kMaxExpArg = 15 << 15;
constexpr int32_t kInt32Max = 0x7FFFFFFF;
constexpr int32_t kLogBad = -(1 << 30);         // ln of x <= 0
}  // namespace

// round(ln(1 + 2^-k) * 2^15), k = 1..15
__constant__ int32_t kLogTable[15] = {13286, 7312, 3860, 1987, 1008,
                                      508,   255,  128,  64,   32,
                                      16,    8,    4,    2,    1};

__global__ void fx_exp_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t xi = min(max(x[i], -kMaxExpArg), kMaxExpArg);
    int32_t q = xi / kLn2;                      // truncates toward zero
    if (xi % kLn2 != 0 && xi < 0) q -= 1;       // floor
    int32_t r = xi - q * kLn2;                  // r in [0, ln2)
    int32_t acc = kFxOne;
#pragma unroll
    for (int k = 1; k <= 15; ++k) {
      const int32_t lk = kLogTable[k - 1];
      if (r >= lk) {
        r -= lk;
        acc += acc >> k;
      }
    }
    acc = wrap_add(acc, wrap_mul(acc, r) >> 15);
    const int32_t e = min(max(q, -31), 31);
    int32_t out;
    if (e >= 0) {
      out = e >= 16 ? kInt32Max
                    : static_cast<int32_t>(static_cast<uint32_t>(acc)
                                           << min(e, 15));
    } else {
      out = acc >> min(-e, 31);
    }
    y[i] = out;
  }
}

extern "C" int repro_fx_exp(const void* x, void* y, int64_t n, void* stream) {
  const int threads = 256;
  fx_exp_kernel<<<grid_for(n, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

__global__ void fx_log_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t xi = x[i];
    int32_t z = max(xi, 1);
    int32_t e = 0;                              // z = x 2^-e, z in [1, 2)
    const int down[5] = {15, 8, 4, 2, 1}, up[5] = {8, 4, 2, 1, 1};
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int shift = down[j];
      if (z >= (kFxOne << shift)) {
        z >>= shift;
        e += shift;
      }
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int shift = up[j];
      if (z < (kFxOne >> (shift - 1))) {
        z <<= shift;
        e -= shift;
      }
    }
    int32_t acc = e * kLn2;
    int32_t w = kFxOne;
#pragma unroll
    for (int k = 1; k <= 15; ++k) {
      const int32_t w_next = w + (w >> k);
      if (w_next <= z) {
        w = w_next;
        acc += kLogTable[k - 1];
      }
    }
    const int32_t num = (z - w) << 15;          // 0 <= z - w < 2^15
    int32_t q = num / w;                        // truncates toward zero
    if (num % w != 0 && num < 0) q -= 1;        // floor
    y[i] = xi <= 0 ? kLogBad : acc + q;
  }
}

extern "C" int repro_fx_log(const void* x, void* y, int64_t n, void* stream) {
  const int threads = 256;
  fx_log_kernel<<<grid_for(n, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
