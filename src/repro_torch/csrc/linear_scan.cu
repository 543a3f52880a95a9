// The RG-LRU recurrence of RecurrentGemma's recurrent blocks (Griffin,
// arXiv:2402.19427), gates and scan in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes the recurrence with a
// chunked jax.lax.associative_scan (repro/models/rglru.py::rg_lru, its
// gates in ::_gates), which XLA lowers to a tree of elementwise passes.
// On the card a scan on the hot path is a kernel: a host loop over 4096
// positions in each of 18 layers would be ~10^5 launches a prefill.
//
// Per (batch b, channel c), in float32:
//   i_t = sigmoid(xi_t), g_t = sigmoid(xa_t)      (xi, xa: the gates'
//                                                  pre-activations u W + b)
//   log a_t = -8 softplus(lam_c) g_t,  a_t = exp(log a_t)
//   b_t = sqrt(max(1 - exp(2 log a_t), 1e-12)) i_t u_t
//   h_t = a_t h_{t-1} + b_t,  y_t = h_t
// with the reference's operation order; h_t is a product and a sum, each
// rounded (no FMA), as the plain version computes it.
//
// Design.  One thread per (b, c), channels on neighbouring lanes, so each
// position's three loads and one store are coalesced across a warp; the
// thread walks S in order.  a_t and b_t do not depend on h, so only one
// multiply-add a step is serial: the thread loads the next U positions
// into registers while it computes the current U (double buffering),
// keeping 3 U loads in flight.  Blocks of one warp spread the (B w) / 32
// warps over every SM.  S = 1 is the decode step.
//
// Bound: bytes.  At RecurrentGemma-2B's prefill (B 4, S 4096, w 2560) the
// kernel reads three float32 (B, S, w) tensors and writes one: 671 MB,
// 200 us at 3.35 TB/s; its ~30 operations an element are 10 us of the
// float32 rate.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LS_THREADS = 32, LS_U = 16;

// log(1 + exp(x)) as jax.nn.softplus computes it: max(x, 0) +
// log1p(exp(-|x|))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace

__global__ void __launch_bounds__(LS_THREADS)
    linear_scan_kernel(const float* __restrict__ xi,
                       const float* __restrict__ xa,
                       const float* __restrict__ u,
                       const float* __restrict__ lam,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_final, int S, int W) {
  const int c = blockIdx.x * LS_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  const float neg_c_sp = -8.f * softplus(lam[c]);
  float h = h0[static_cast<int64_t>(b) * W + c];
  const int64_t base = static_cast<int64_t>(b) * S * W + c;
  float ci[LS_U], ca[LS_U], cu[LS_U];
  auto load = [&](float (&vi)[LS_U], float (&va)[LS_U], float (&vu)[LS_U],
                  int t0) {
#pragma unroll
    for (int j = 0; j < LS_U; ++j) {
      if (t0 + j < S) {
        const int64_t at = base + static_cast<int64_t>(t0 + j) * W;
        vi[j] = __ldg(xi + at);
        va[j] = __ldg(xa + at);
        vu[j] = __ldg(u + at);
      }
    }
  };
  load(ci, ca, cu, 0);
  for (int t0 = 0; t0 < S; t0 += LS_U) {
    float ni[LS_U], na[LS_U], nu[LS_U];
    if (t0 + LS_U < S) load(ni, na, nu, t0 + LS_U);
#pragma unroll
    for (int j = 0; j < LS_U; ++j) {
      if (t0 + j < S) {
        const float gate_i = sigmoid(ci[j]);
        const float gate_a = sigmoid(ca[j]);
        const float log_a = neg_c_sp * gate_a;
        const float a = expf(log_a);
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
        const float bt = __fmul_rn(__fmul_rn(beta, gate_i), cu[j]);
        h = __fadd_rn(__fmul_rn(a, h), bt);
        y[base + static_cast<int64_t>(t0 + j) * W] = h;
      }
    }
#pragma unroll
    for (int j = 0; j < LS_U; ++j) {
      ci[j] = ni[j];
      ca[j] = na[j];
      cu[j] = nu[j];
    }
  }
  h_final[static_cast<int64_t>(b) * W + c] = h;
}

// xi, xa, u, y: (B, S, W) float32 contiguous; lam: (W,); h0, h_final:
// (B, W)
extern "C" int repro_linear_scan(const void* xi, const void* xa,
                                 const void* u, const void* lam,
                                 const void* h0, void* y, void* h_final,
                                 int32_t B, int32_t S, int32_t W,
                                 void* stream) {
  const dim3 grid((W + LS_THREADS - 1) / LS_THREADS, B);
  linear_scan_kernel<<<grid, LS_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xa),
      static_cast<const float*>(u), static_cast<const float*>(lam),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_final), S, W);
  return static_cast<int>(cudaGetLastError());
}
