// MAC-array GEMM, int8/uint8 x int8/uint8 -> int32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/mac_gemm/mac_gemm.py::
// _mac_gemm_kernel and the padding of mac_gemm/ops.py::mac_gemm.  That
// kernel walks a sequential (M/BM, N/BN, K/BK) grid with the int32
// accumulator tile carried in VMEM scratch across the K steps.  Here
// blocks run in parallel, so each block owns one 64 x 64 output tile and
// loops over K itself, the accumulator in registers (output-stationary,
// as in the paper's MAC array).  Per K step of 32 bytes the block stages
// A (64 rows x 32 k) and B transposed (64 cols x 32 k) in shared memory,
// four k-values packed per 32-bit word, and each of 256 threads computes
// a 4 x 4 sub-tile with dp4a: four 8-bit products summed into int32 in one
// instruction.  dp4a's PTX form takes the signedness of each operand
// (s32/u32), so all four int8/uint8 pairings are exact.  Tiles are
// bounds-checked and zero-filled at the ragged edges (a zero byte is zero
// either way), so any M, K, N works without padding in the wrapper.  Sums
// wrap as the reference's int32 accumulation does.
//
// Bound: operations at large sizes (2 M N K over the int8 tensor-core
// rate: 69 us at 4096^3 against 30 us of bytes), bytes and launch latency
// on the hybrid path's (600, 1) x (1, 256).  This first version uses the
// CUDA cores' dp4a, not the tensor cores; mma/wgmma on s8/u8 is a later
// step (PERF.md).
#include "dp4a.cuh"
#include "fixed_point.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int KW = BK / 4;         // packed words per tile row
constexpr int LD = KW + 1;         // padded row stride: no bank conflicts

}  // namespace

template <bool AS, bool BS>
__global__ void __launch_bounds__(THREADS)
    mac_gemm_kernel(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ b, int32_t* __restrict__ out,
                    int M, int N, int K) {
  __shared__ uint32_t as[BM * LD];   // as[m][kw]: k = 4 kw .. 4 kw + 3
  __shared__ uint32_t bs[BN * LD];   // bs[n][kw]: B transposed
  uint8_t* as_b = reinterpret_cast<uint8_t*>(as);
  uint8_t* bs_b = reinterpret_cast<uint8_t*>(bs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int32_t acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    // constant trip counts, unrolled: each thread's 8 + 8 byte loads are
    // independent and in flight together
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      as_b[r * LD * 4 + c] =
          (m < M && k < K) ? a[static_cast<int64_t>(m) * K + k] : 0;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      bs_b[c * LD * 4 + r] =
          (k < K && n < N) ? b[static_cast<int64_t>(k) * N + n] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * LD + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * LD + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = dp4a<AS, BS>(av[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
}

extern "C" int repro_mac_gemm(const void* a, const void* b, void* out,
                              int32_t M, int32_t N, int32_t K,
                              int32_t a_signed, int32_t b_signed,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  if (a_signed && b_signed) {
    mac_gemm_kernel<true, true><<<grid, THREADS, 0, s>>>(pa, pb, po, M, N, K);
  } else if (a_signed) {
    mac_gemm_kernel<true, false><<<grid, THREADS, 0, s>>>(pa, pb, po, M, N,
                                                          K);
  } else if (b_signed) {
    mac_gemm_kernel<false, true><<<grid, THREADS, 0, s>>>(pa, pb, po, M, N,
                                                          K);
  } else {
    mac_gemm_kernel<false, false><<<grid, THREADS, 0, s>>>(pa, pb, po, M, N,
                                                           K);
  }
  return static_cast<int>(cudaGetLastError());
}
