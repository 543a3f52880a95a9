// MAC-array GEMM, int8/uint8 x int8/uint8 -> int32, on Hopper's int8
// tensor cores (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/mac_gemm/mac_gemm.py::
// _mac_gemm_kernel and the padding of mac_gemm/ops.py::mac_gemm.  That
// kernel walks a sequential (M/BM, N/BN, K/BK) grid with the int32
// accumulator tile carried in VMEM scratch across the K steps.  Here
// blocks run in parallel, so each block owns one 128 x 256 output tile
// (or, split K, one range of K steps of it) and loops over K itself, the
// accumulator in registers (output-stationary, as in the paper's MAC
// array).
//
// Bound: operations at large sizes (2 M N K over the int8 tensor-core
// rate: 69 us at 4096^3 against 30 us of bytes); bytes and launch latency
// at M = 1 (the Fig. 22/23 FC rows: 2 MB of B at 1x4096x512, 0.6 us).
//
// Design.  Two launches a call:
// 1. imma_pack_kernel (imma.cuh, shared with mac_conv.cu).  wgmma takes
//    8-bit operands K-major only, and the op's B is (K, N) row-major, so
//    B is transposed into a (N, Kp) scratch, Kp = K rounded up to 16 and
//    zero-filled: 4 x 4 byte squares by 32-bit loads and __byte_perm, or
//    bytes through shared memory when N % 4 != 0.  A is used in place
//    when its rows are 16-byte aligned (K % 16 == 0), else copied to a
//    zero-padded (M, Kp) scratch.  Under split K the same launch zeroes
//    the output.
// 2. mac_gemm_kernel.  Two consumer warpgroups (256 threads), each a
//    64 x 256 slice of the tile, multiply with wgmma.mma_async
//    m64n256k32 s32 (imma.cuh; one instantiation per s8/u8 pairing, no
//    .satfinite, so sums wrap as the reference's int32 sums do).  A 4-stage
//    ring of 128-byte K tiles (A 16 KB + B 32 KB a stage) is filled by
//    16-byte cp.async, zero-filled past M, N and Kp, two tiles ahead of
//    the product, so copies overlap the tensor cores.  Small outputs
//    (fewer tiles than SMs, e.g. M = 1) split K across blocks and add
//    their pieces with int32 atomicAdd into the zeroed output: exact and
//    independent of order, as int32 addition wraps modulo 2^32.
// Products with K <= 32 (the hybrid encode's K = 1: one k step of the
// tensor cores, mostly zeros) take one launch of mac_gemm_dp4a_kernel
// instead, chosen by the wrapper: two launches cost more than the whole
// product there (PERF.md).  It is this op's first, CUDA-core kernel: 64 x
// 64 tiles, A and B transposed staged a byte at a time in shared memory,
// dp4a in its four signedness forms (dp4a.cuh), ragged edges zero-filled.
#include <cuda_runtime.h>

#include "dp4a.cuh"
#include "imma.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = imma::kTileK, STAGES = 4;
constexpr int THREADS = 256;                     // two warpgroups
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + alignment

}  // namespace

// a: (M, Kp) row-major, bt: (N, Kp) row-major (B transposed), Kp % 16 ==
// 0; block z takes K tiles [z kps, (z + 1) kps); split: add into out
template <bool AS, bool BS>
__global__ void __launch_bounds__(THREADS, 1)
    mac_gemm_kernel(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ bt,
                    int32_t* __restrict__ out, int M, int N, int Kp,
                    int kps, int split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_tiles = (Kp + BK - 1) / BK;
  const int kt0 = blockIdx.z * kps;
  const int nkt = min(k_tiles, kt0 + kps) - kt0;

  auto load = [&](int i) {         // local K tile i into stage i % STAGES
    const uint32_t sa = base + (i % STAGES) * STAGE_BYTES;
    const int k0 = (kt0 + i) * BK;
    imma::load_tile<BM, THREADS>(sa, a, Kp, m0, M, k0, Kp, tid);
    imma::load_tile<BN, THREADS>(sa + A_BYTES, bt, Kp, n0, N, k0, Kp, tid);
  };

  int32_t acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  // Tile i + STAGES - 2 is loaded in iteration i, into the stage that
  // tile i - 2 used: every warpgroup's wait<1> of iteration i - 1,
  // ordered by the barrier, has retired the products that read it.
#pragma unroll
  for (int i = 0; i < STAGES - 2; ++i) {
    if (i < nkt) load(i);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    sm90::cp_async_wait<STAGES - 3>();   // tile i has landed
    sm90::fence_proxy_async();
    __syncthreads();
    const uint32_t sa = base + (i % STAGES) * STAGE_BYTES;
    sm90::wgmma_fence();
    imma::mma_tile<AS, BS, BN>(acc, sa + wg * 64 * BK, sa + A_BYTES);
    sm90::wgmma_commit();
    if (i + STAGES - 2 < nkt) load(i + STAGES - 2);
    sm90::cp_async_commit();
    sm90::wgmma_wait<1>();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  imma::store_m64n<BN>(acc, out, M, N, m0 + wg * 64, n0, tid % 128,
                        split > 1);
}

namespace {

template <bool AS, bool BS>
int launch(const uint8_t* a, const uint8_t* bt, int32_t* out, int M, int N,
           int Kp, int kps, int split, cudaStream_t s) {
  auto kernel = mac_gemm_kernel<AS, BS>;
  static bool configured = false;    // above 48 KB only when allowed
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(a, bt, out, M, N, Kp, kps, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, K), b: (K, N) row-major 8-bit; bt: (N, Kp) scratch, ap: (M, Kp)
// scratch or null (then a's rows are 16-byte aligned and K == Kp), Kp =
// K rounded up to 16; out: (M, N) int32
extern "C" int repro_mac_gemm(const void* a, const void* b, void* ap,
                              void* bt, void* out, int32_t M, int32_t N,
                              int32_t K, int32_t a_signed, int32_t b_signed,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Kp = (K + 15) / 16 * 16;
  const int k_tiles = (Kp + BK - 1) / BK;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int split, kps;
  imma::split_k(k_tiles, tiles, imma::sm_count(), &split, &kps);
  const auto* pa = static_cast<const uint8_t*>(a);
  auto* pap = static_cast<uint8_t*>(ap);
  auto* pbt = static_cast<uint8_t*>(bt);
  auto* po = static_cast<int32_t*>(out);
  const int err = imma::pack(pa, static_cast<const uint8_t*>(b), pap, pbt,
                             po, M, N, K, Kp, split > 1, s);
  if (err) return err;
  const uint8_t* a_op = ap ? pap : pa;
  if (a_signed && b_signed) {
    return launch<true, true>(a_op, pbt, po, M, N, Kp, kps, split, s);
  } else if (a_signed) {
    return launch<true, false>(a_op, pbt, po, M, N, Kp, kps, split, s);
  } else if (b_signed) {
    return launch<false, true>(a_op, pbt, po, M, N, Kp, kps, split, s);
  }
  return launch<false, false>(a_op, pbt, po, M, N, Kp, kps, split, s);
}

// ---------------------------------------------------- K <= 32: CUDA cores

namespace {

constexpr int DP_BM = 64, DP_BN = 64, DP_BK = 32, DP_THREADS = 256;
constexpr int DP_KW = DP_BK / 4;   // packed words per tile row
constexpr int DP_LD = DP_KW + 1;   // padded row stride: no bank conflicts

}  // namespace

template <bool AS, bool BS>
__global__ void __launch_bounds__(DP_THREADS)
    mac_gemm_dp4a_kernel(const uint8_t* __restrict__ a,
                         const uint8_t* __restrict__ b,
                         int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ uint32_t as[DP_BM * DP_LD];   // as[m][kw]: k = 4 kw .. + 3
  __shared__ uint32_t bs[DP_BN * DP_LD];   // bs[n][kw]: B transposed
  uint8_t* as_b = reinterpret_cast<uint8_t*>(as);
  uint8_t* bs_b = reinterpret_cast<uint8_t*>(bs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * DP_BM, n0 = blockIdx.x * DP_BN;
  int32_t acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += DP_BK) {
#pragma unroll
    for (int i = 0; i < DP_BM * DP_BK / DP_THREADS; ++i) {
      const int e = threadIdx.x + i * DP_THREADS;
      const int r = e / DP_BK, c = e % DP_BK;
      const int m = m0 + r, k = k0 + c;
      as_b[r * DP_LD * 4 + c] =
          (m < M && k < K) ? a[static_cast<int64_t>(m) * K + k] : 0;
    }
#pragma unroll
    for (int i = 0; i < DP_BK * DP_BN / DP_THREADS; ++i) {
      const int e = threadIdx.x + i * DP_THREADS;
      const int r = e / DP_BN, c = e % DP_BN;
      const int k = k0 + r, n = n0 + c;
      bs_b[c * DP_LD * 4 + r] =
          (k < K && n < N) ? b[static_cast<int64_t>(k) * N + n] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < DP_KW; ++kw) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * DP_LD + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * DP_LD + kw];
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

// a: (M, K), b: (K, N) row-major 8-bit, out: (M, N) int32; any shape
extern "C" int repro_mac_gemm_dp4a(const void* a, const void* b, void* out,
                                   int32_t M, int32_t N, int32_t K,
                                   int32_t a_signed, int32_t b_signed,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + DP_BN - 1) / DP_BN, (M + DP_BM - 1) / DP_BM);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  if (a_signed && b_signed) {
    mac_gemm_dp4a_kernel<true, true><<<grid, DP_THREADS, 0, s>>>(pa, pb, po,
                                                                 M, N, K);
  } else if (a_signed) {
    mac_gemm_dp4a_kernel<true, false><<<grid, DP_THREADS, 0, s>>>(pa, pb, po,
                                                                  M, N, K);
  } else if (b_signed) {
    mac_gemm_dp4a_kernel<false, true><<<grid, DP_THREADS, 0, s>>>(pa, pb, po,
                                                                  M, N, K);
  } else {
    mac_gemm_dp4a_kernel<false, false><<<grid, DP_THREADS, 0, s>>>(
        pa, pb, po, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
