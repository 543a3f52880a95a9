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
// device memory: each block owns a 64-pixel x 64-channel output tile,
// walks K = (kh, kw, cin) in steps of 32 bytes (eight 4-byte groups), and
// stages the patch bytes it needs and the weight bytes in shared memory,
// four k-values packed per 32-bit word.  Each of 256 threads computes a
// 4 x 4 sub-tile with dp4a in the signedness form of each operand
// (dp4a.cuh), so every int8/uint8 pairing is exact and sums wrap as the
// reference's int32 accumulation does.  Padding is index arithmetic: a tap
// outside the image reads 0, as do the ragged edges of M, N and K, so the
// wrapper pads and blocks nothing.  Each block decodes its 64 pixels'
// (image, row, column) once into shared memory; each thread decodes the
// (kh, kw, cin) of its one k column once per step.
//
// Bound: operations at the paper's large layers (VGG-16 conv3 at 56 x 56 x
// 256 -> 256: 2 M N K = 3.44 GOP over the int8 tensor-core rate, 1.7 us,
// against 4.4 MB of bytes), launch latency at the small ones (LeNet).  This
// first version uses the CUDA cores' dp4a, as mac_gemm.cu does; mma/wgmma
// on s8/u8 is the later step (PERF.md).
#include "dp4a.cuh"
#include "fixed_point.cuh"

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
