// MAC-array 2-D convolution (the paper's CONV fetch mode), int8/uint8 NHWC
// input x int8/uint8 HWIO weights -> NHWC int32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/mac_conv/mac_conv.py::
// _conv_kernel and the padding and blocking of mac_conv/ops.py::
// mac_conv2d.  That kernel keeps the padded image resident in VMEM and
// re-slices it for each of the KH x KW taps (the TPU's stand-in for the
// PE's shift register), one MXU dot per tap into an int32 scratch tile
// carried over a sequential grid.  Here the convolution is an implicit
// GEMM: the output (B Ho Wo, Cout) is a matrix product of the patch matrix
// (B Ho Wo, KH KW Cin) with the weights, which in HWIO order already are a
// row-major (KH KW Cin, Cout) matrix.  The patch matrix never exists in
// device memory.  Padding is index arithmetic: a tap outside the image
// reads 0, as do the ragged edges of M, N and K, so the wrapper pads and
// blocks nothing.  Sums wrap as the reference's int32 accumulation does.
//
// Bound: operations at the paper's large layers (VGG-16 conv3 at 56 x 56 x
// 256 -> 256: 2 M N K = 3.44 GOP over the int8 tensor-core rate, 1.7 us,
// against 4.4 MB of bytes), launch latency at the small ones (LeNet).
//
// Two kernels; the wrapper picks one by shape (kernels/mac_conv/ops.py):
//
// mac_conv_igmma_kernel, Cin % 16 == 0: the int8 tensor cores.  Every
// 16-byte chunk of a patch row's k then lies in one tap (kh, kw) and is
// contiguous in NHWC x, so the patch rows are K-major as they stand: each
// chunk is one 16-byte cp.async (src-size 0, a zero fill, for taps outside
// the image and for ragged M and K) into the 128-byte swizzled tiles of
// sm90.cuh.  Each thread decodes its four rows' (image, ih0, iw0) once and
// its one chunk's (kh, kw, cin) once a K tile.  8-bit wgmma takes K-major
// operands only, so the weights are transposed to (Cout, K) by the
// operand pack that mac_gemm.cu uses (imma.cuh), one launch that also
// zeroes a split-K output.  Then, as in mac_gemm.cu: 128-pixel x N-channel
// output tiles from two warpgroups, wgmma.mma_async m64nNk32 s32 with N
// = 64, 128 or 256 chosen by Cout (imma.cuh; one instantiation per s8/u8
// pairing and N, no .satfinite), a 4-stage ring of 128-byte K tiles two
// tiles ahead of the product, and split K with int32 atomicAdd (exact in
// any order) when the output has fewer tiles than the card has SMs, as
// VGG-16 conv3 at batch 1 does (23 tiles of 128 x 256).
//
// mac_conv_kernel, any Cin (LeNet's 1 and 6, MobileNetV2's 24): the CUDA
// cores' dp4a.  Each block owns a 64-pixel x 64-channel output tile,
// walks K = (kh, kw, cin) in steps of 32 bytes (eight 4-byte groups), and
// stages the patch bytes it needs and the weight bytes in shared memory,
// four k-values packed per 32-bit word.  Each of 256 threads computes a
// 4 x 4 sub-tile with dp4a in the signedness form of each operand
// (dp4a.cuh).  Each block decodes its 64 pixels' (image, row, column) once
// into shared memory; each thread decodes the (kh, kw, cin) of its one k
// column once per step.
#include "dp4a.cuh"
#include "imma.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int KWORDS = BK / 4;     // packed words per tile row
constexpr int LD = KWORDS + 1;     // padded row stride: no bank conflicts
constexpr int kOutside = -(1 << 30);  // a row origin no tap reaches

struct ConvShape {
  int H, W, Cin, KW, Ho, Wo, sh, sw, pad_top, pad_left;
  int M, N, K;                     // B Ho Wo, Cout, KH KW Cin
};

}  // namespace

template <bool XS, bool WS>
__global__ void __launch_bounds__(THREADS)
    mac_conv_kernel(const uint8_t* __restrict__ x,
                    const uint8_t* __restrict__ w, int32_t* __restrict__ out,
                    ConvShape s) {
  __shared__ uint32_t as[BM * LD];   // as[pixel][kw]: patch bytes
  __shared__ uint32_t bs[BN * LD];   // bs[cout][kw]: weights transposed
  __shared__ int row_img[BM], row_ih[BM], row_iw[BM];
  uint8_t* as_b = reinterpret_cast<uint8_t*>(as);
  uint8_t* bs_b = reinterpret_cast<uint8_t*>(bs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (threadIdx.x < BM) {
    const int m = m0 + threadIdx.x;
    if (m < s.M) {
      const int ow = m % s.Wo, t = m / s.Wo;
      row_img[threadIdx.x] = (t / s.Ho) * s.H;   // image b's first row
      row_ih[threadIdx.x] = (t % s.Ho) * s.sh - s.pad_top;
      row_iw[threadIdx.x] = ow * s.sw - s.pad_left;
    } else {
      row_img[threadIdx.x] = 0;
      row_ih[threadIdx.x] = kOutside;
      row_iw[threadIdx.x] = kOutside;
    }
  }
  __syncthreads();
  const int c = threadIdx.x % BK;    // this thread's k column when staging
  int32_t acc[4][4] = {};
  for (int k0 = 0; k0 < s.K; k0 += BK) {
    const int k = k0 + c;
    const int ci = k % s.Cin, tap = k / s.Cin;
    const int dh = k < s.K ? tap / s.KW : kOutside, dw = tap % s.KW;
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int r = threadIdx.x / BK + i * (THREADS / BK);
      const int ih = row_ih[r] + dh, iw = row_iw[r] + dw;
      const bool inside = ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      as_b[r * LD * 4 + c] =
          inside ? x[(static_cast<int64_t>(row_img[r] + ih) * s.W + iw) *
                         s.Cin +
                     ci]
                 : 0;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / BN, cc = e % BN;
      const int kk = k0 + r, n = n0 + cc;
      bs_b[cc * LD * 4 + r] =
          (kk < s.K && n < s.N) ? w[static_cast<int64_t>(kk) * s.N + n] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KWORDS; ++kw) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * LD + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * LD + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = dp4a<XS, WS>(av[i], bv[j], acc[i][j]);
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
      if (m < s.M && n < s.N) {
        out[static_cast<int64_t>(m) * s.N + n] = acc[i][j];
      }
    }
  }
}

extern "C" int repro_mac_conv(const void* x, const void* w, void* out,
                              int32_t B, int32_t H, int32_t W, int32_t Cin,
                              int32_t KH, int32_t KW, int32_t Cout,
                              int32_t sh, int32_t sw, int32_t pad_top,
                              int32_t pad_left, int32_t Ho, int32_t Wo,
                              int32_t x_signed, int32_t w_signed,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvShape s{H,  W,  Cin,     KW,       Ho,
                    Wo, sh, sw,      pad_top,  pad_left,
                    B * Ho * Wo,     Cout,     KH * KW * Cin};
  const dim3 grid((s.M + BM - 1) / BM, (s.N + BN - 1) / BN);
  const auto* px = static_cast<const uint8_t*>(x);
  const auto* pw = static_cast<const uint8_t*>(w);
  auto* po = static_cast<int32_t*>(out);
  if (x_signed && w_signed) {
    mac_conv_kernel<true, true><<<grid, THREADS, 0, st>>>(px, pw, po, s);
  } else if (x_signed) {
    mac_conv_kernel<true, false><<<grid, THREADS, 0, st>>>(px, pw, po, s);
  } else if (w_signed) {
    mac_conv_kernel<false, true><<<grid, THREADS, 0, st>>>(px, pw, po, s);
  } else {
    mac_conv_kernel<false, false><<<grid, THREADS, 0, st>>>(px, pw, po, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- Cin % 16 == 0: wgmma

namespace {

constexpr int TC_BM = 128, TC_BK = imma::kTileK, TC_STAGES = 4;
constexpr int TC_THREADS = 256;                  // two warpgroups
constexpr int TC_A_BYTES = TC_BM * TC_BK;
constexpr int TC_ROWS = TC_BM * 8 / TC_THREADS;  // patch rows a thread stages

template <int TN>
struct TcSmem {
  static constexpr int kStage = TC_A_BYTES + TN * TC_BK;
  static constexpr int kBytes = TC_STAGES * kStage + 1024;   // + alignment
};

}  // namespace

// x: NHWC, Cin % 16 == 0; bt: (Cout, K) row-major (the weights
// transposed), K = KH KW Cin; block (x, y, z) takes pixel tile x, channel
// tile y and K tiles [z kps, (z + 1) kps); split: add into out
template <bool XS, bool WS, int TN>
__global__ void __launch_bounds__(TC_THREADS, 1)
    mac_conv_igmma_kernel(const uint8_t* __restrict__ x,
                          const uint8_t* __restrict__ bt,
                          int32_t* __restrict__ out, ConvShape s, int kps,
                          int split) {
  using L = TcSmem<TN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * TC_BM, n0 = blockIdx.y * TN;
  const int k_tiles = (s.K + TC_BK - 1) / TC_BK;
  const int kt0 = blockIdx.z * kps;
  const int nkt = min(k_tiles, kt0 + kps) - kt0;

  // this thread stages 16-byte chunk `chunk` of patch rows tid / 8 + 32 x:
  // each row's first input pixel (offset pix, at ih0, iw0) decoded once
  const int chunk = tid & 7;
  int64_t pix[TC_ROWS];
  int ih0[TC_ROWS], iw0[TC_ROWS];
#pragma unroll
  for (int r = 0; r < TC_ROWS; ++r) {
    const int m = m0 + (tid >> 3) + 32 * r;
    if (m < s.M) {
      const int ow = m % s.Wo, t = m / s.Wo;
      ih0[r] = (t % s.Ho) * s.sh - s.pad_top;
      iw0[r] = ow * s.sw - s.pad_left;
      pix[r] = ((static_cast<int64_t>(t / s.Ho) * s.H + ih0[r]) * s.W +
                iw0[r]) * s.Cin;
    } else {
      ih0[r] = kOutside;
      iw0[r] = 0;
      pix[r] = 0;
    }
  }

  auto load = [&](int i) {         // local K tile i into stage i % STAGES
    const uint32_t sa = base + (i % TC_STAGES) * L::kStage;
    const int k0 = (kt0 + i) * TC_BK, k = k0 + 16 * chunk;
    const int tap = k / s.Cin, ci = k - tap * s.Cin;
    const int dh = tap / s.KW, dw = tap - dh * s.KW;
    const int64_t koff = (static_cast<int64_t>(dh) * s.W + dw) * s.Cin + ci;
#pragma unroll
    for (int r = 0; r < TC_ROWS; ++r) {
      const int ih = ih0[r] + dh, iw = iw0[r] + dw;
      const bool in = k < s.K && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      sm90::cp_async16(sa + sm90::sw128((tid >> 3) + 32 * r, chunk),
                       in ? x + pix[r] + koff : x, in ? 16 : 0);
    }
    imma::load_tile<TN, TC_THREADS>(sa + TC_A_BYTES, bt, s.K, n0, s.N, k0,
                                    s.K, tid);
  };

  int32_t acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
  // Tile i + STAGES - 2 is loaded in iteration i, into the stage that
  // tile i - 2 used: every warpgroup's wait<1> of iteration i - 1,
  // ordered by the barrier, has retired the products that read it.
#pragma unroll
  for (int i = 0; i < TC_STAGES - 2; ++i) {
    if (i < nkt) load(i);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    sm90::cp_async_wait<TC_STAGES - 3>();   // tile i has landed
    sm90::fence_proxy_async();
    __syncthreads();
    const uint32_t sa = base + (i % TC_STAGES) * L::kStage;
    sm90::wgmma_fence();
    imma::mma_tile<XS, WS, TN>(acc, sa + wg * 64 * TC_BK, sa + TC_A_BYTES);
    sm90::wgmma_commit();
    if (i + TC_STAGES - 2 < nkt) load(i + TC_STAGES - 2);
    sm90::cp_async_commit();
    sm90::wgmma_wait<1>();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  imma::store_m64n<TN>(acc, out, s.M, s.N, m0 + wg * 64, n0, tid % 128,
                       split > 1);
}

namespace {

template <bool XS, bool WS, int TN>
int launch_tc(const uint8_t* x, const uint8_t* bt, int32_t* out,
              const ConvShape& s, int kps, int split, cudaStream_t st) {
  auto kernel = mac_conv_igmma_kernel<XS, WS, TN>;
  constexpr int smem = TcSmem<TN>::kBytes;
  static bool configured = false;    // above 48 KB only when allowed
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((s.M + TC_BM - 1) / TC_BM, (s.N + TN - 1) / TN, split);
  kernel<<<grid, TC_THREADS, smem, st>>>(x, bt, out, s, kps, split);
  return static_cast<int>(cudaGetLastError());
}

template <int TN>
int launch_tc_signs(const uint8_t* x, const uint8_t* bt, int32_t* out,
                    const ConvShape& s, int kps, int split, int xs, int ws,
                    cudaStream_t st) {
  if (xs && ws) return launch_tc<true, true, TN>(x, bt, out, s, kps, split,
                                                 st);
  if (xs) return launch_tc<true, false, TN>(x, bt, out, s, kps, split, st);
  if (ws) return launch_tc<false, true, TN>(x, bt, out, s, kps, split, st);
  return launch_tc<false, false, TN>(x, bt, out, s, kps, split, st);
}

}  // namespace

// x: (B, H, W, Cin) NHWC with Cin % 16 == 0, w: (KH, KW, Cin, Cout) HWIO,
// bt: (Cout, KH KW Cin) scratch, out: (B, Ho, Wo, Cout) int32
extern "C" int repro_mac_conv_igmma(const void* x, const void* w, void* bt,
                                    void* out, int32_t B, int32_t H,
                                    int32_t W, int32_t Cin, int32_t KH,
                                    int32_t KW, int32_t Cout, int32_t sh,
                                    int32_t sw, int32_t pad_top,
                                    int32_t pad_left, int32_t Ho, int32_t Wo,
                                    int32_t x_signed, int32_t w_signed,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvShape s{H,  W,  Cin,     KW,       Ho,
                    Wo, sh, sw,      pad_top,  pad_left,
                    B * Ho * Wo,     Cout,     KH * KW * Cin};
  const int bn = Cout <= 64 ? 64 : Cout <= 128 ? 128 : 256;
  const int tiles = ((s.M + TC_BM - 1) / TC_BM) * ((s.N + bn - 1) / bn);
  int split, kps;
  imma::split_k((s.K + TC_BK - 1) / TC_BK, tiles, imma::sm_count(), &split,
                &kps);
  auto* pbt = static_cast<uint8_t*>(bt);
  auto* po = static_cast<int32_t*>(out);
  const int err = imma::pack(nullptr, static_cast<const uint8_t*>(w),
                             nullptr, pbt, po, s.M, s.N, s.K, s.K, split > 1,
                             st);
  if (err) return err;
  const auto* px = static_cast<const uint8_t*>(x);
  if (bn == 64) {
    return launch_tc_signs<64>(px, pbt, po, s, kps, split, x_signed,
                               w_signed, st);
  }
  if (bn == 128) {
    return launch_tc_signs<128>(px, pbt, po, s, kps, split, x_signed,
                                w_signed, st);
  }
  return launch_tc_signs<256>(px, pbt, po, s, kps, split, x_signed, w_signed,
                              st);
}
