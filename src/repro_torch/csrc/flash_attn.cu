// Fused softmax attention (flash attention), float32 or bfloat16 in and
// out, float32 inside, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attn/flash_attn.py::
// _flash_kernel (via flash_attention_pallas and flash_attn/ops.py::
// flash_attention_kernel).  That kernel walks a (B H, q block, kv block)
// grid whose kv axis runs in order on the TPU core, carrying the online
// softmax's m, l and acc in VMEM scratch from one grid step to the next.
// Blocks on the card run in parallel and carry nothing, so each block owns
// one (batch x head, 64-query tile) and loops over the kv tiles itself,
// with m, l and acc in registers.  Per kv tile it stages K in shared
// memory, computes its 64 x 64 scores (each of 256 threads a 4 x 4
// sub-tile), scales them by 1/sqrt(D), masks them to -1e30, takes the row
// max and row sum with shuffles across the 16 threads of a row, writes
// p = exp(s - m) (0 under the mask) to shared memory, stages V over K and
// adds p V into acc (each thread 4 rows x D/16 columns).  The output is
// acc / max(l, 1e-30) in the input type, as in the reference.  Under the
// causal mask the kv tiles wholly above the diagonal are skipped: there p
// is 0, m is unchanged and the correction is 1, so skipping is exact; the
// heaviest query tiles are scheduled first.  Rows and columns past S are
// bounds-checked (zero-filled, masked), so any S works.  q, k, v and the
// output are read and written in the op's (B, S, H, D) layout, without a
// transpose.
//
// Bound: operations.  A causal prefill at S = 4096, 32 heads of 128 is
// 4 S^2 D H / 2 = 137 GFLOP, 139 us at the bf16 tensor-core rate, against
// 134 MB of bytes (40 us).  This first version multiplies on the CUDA
// cores in float32 (at best 2 ms at 67 TFLOP/s); mma/wgmma on bf16 is the
// later step (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;   // BQ == BK: stage()
constexpr float kNeg = -1e30f;     // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max / sum over the 16 threads of one score row (lanes 0-15 or 16-31);
// the xor butterfly leaves the same value in every lane
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Shared memory of one block: Q (BQ x ld), K or V (BK x ld), P (BQ x BK+1)
constexpr size_t smem_bytes(int nc) {
  return (static_cast<size_t>(BQ + BK) * (16 * nc + 1) +
          static_cast<size_t>(BQ) * (BK + 1)) *
         sizeof(float);
}

// Stage rows [r0, r0 + 64) of one (batch, head) as float; zeros past S.
// Threads (ty, tx) take rows ty + 16 i and columns tx + 16 j.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t row_stride, int r0, int S,
                                      int D, int tx, int ty) {
  for (int r = ty; r < BQ; r += 16) {
    const bool in = r0 + r < S;
    const T* row = src + static_cast<int64_t>(r0 + r) * row_stride;
    for (int c = tx; c < D; c += 16) {
      dst[r * ld + c] = in ? to_float(row[c]) : 0.f;
    }
  }
}

}  // namespace

// NC = columns of D per thread / 16: D <= 16 NC
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int H, int D, float scale, int causal) {
  constexpr int LD = 16 * NC + 1;  // padded row stride: no bank conflicts
  constexpr int LDP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* kvs = qs + BQ * LD;
  float* ps = kvs + BK * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (S + BQ - 1) / BQ;
  const int q0 = (n_tiles - 1 - blockIdx.x) * BQ;   // longest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  stage(qs, LD, q + base, row_stride, q0, S, D, tx, ty);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = causal ? min(n_tiles, (q0 + BQ - 1) / BK + 1)
                          : (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's P V has finished
    stage(kvs, LD, k + base, row_stride, k0, S, D, tx, ty);
    __syncthreads();
    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        keep[j] = col < S && (!causal || col <= row);
        s[i][j] = keep[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                 // K is read, P is written
    stage(kvs, LD, v + base, row_stride, k0, S, D, tx, ty);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = kvs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* out = o + base + static_cast<int64_t>(row) * row_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[col] = from_float<T>(acc[i][c] / l_safe);
    }
  }
}

namespace {

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int D, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_attn_kernel<T, NC>;
  const size_t smem = smem_bytes(NC);
  static bool configured = false;    // above 48 KB only when allowed
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_nc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int D, float scale, int causal, cudaStream_t st) {
  if (D <= 16) return launch<T, 1>(q, k, v, o, B, S, H, D, scale, causal, st);
  if (D <= 32) return launch<T, 2>(q, k, v, o, B, S, H, D, scale, causal, st);
  if (D <= 64) return launch<T, 4>(q, k, v, o, B, S, H, D, scale, causal, st);
  return launch<T, 8>(q, k, v, o, B, S, H, D, scale, causal, st);
}

}  // namespace

// q, k, v, o: (B, S, H, D) contiguous, D <= 128; bf16 != 0 selects
// bfloat16, else float32
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* o, int32_t B, int32_t S, int32_t H,
                                int32_t D, float scale, int32_t causal,
                                int32_t bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_nc<__nv_bfloat16>(q, k, v, o, B, S, H, D, scale, causal,
                                    st);
  }
  return launch_nc<float>(q, k, v, o, B, S, H, D, scale, causal, st);
}
