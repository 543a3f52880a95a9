// Fused s16.15 LIF neuron update for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/lif/lif.py::_lif_kernel (via
// lif_step_pallas and lif/ops.py::lif_step).  Per neuron:
//   v1 = fx_mul(v, alpha) + i_syn, floored at v_min when given;
//   spike if out of refractory and v1 >= v_th, then reset or hold;
//   the refractory counter counts down.
//
// Bound: memory.  On the main path (4096 PEs x 250 neurons = 1,024,000
// neurons) it reads three int32 arrays and writes three: 24.6 MB per tick,
// >= 7.3 us at 3.35 TB/s, against a handful of integer operations per
// neuron.  Design: one thread per neuron over flat contiguous int32 (no
// (R, 128) tile padding), grid-stride, neighbouring threads on neighbouring
// words so every load and store coalesces; nothing is staged in shared
// memory because nothing is reused.
#include "fixed_point.cuh"

__device__ __forceinline__ int32_t fx_mul(int32_t a, int32_t b) {
  const int32_t ah = a >> 15;          // arithmetic shift (floor)
  const int32_t al = a & 0x7FFF;
  return wrap_add(wrap_mul(ah, b), wrap_mul(al, b) >> 15);
}

__global__ void lif_step_kernel(const int32_t* __restrict__ v,
                                const int32_t* __restrict__ rc,
                                const int32_t* __restrict__ i_syn,
                                int32_t* __restrict__ v_out,
                                int32_t* __restrict__ rc_out,
                                int32_t* __restrict__ spikes, int64_t n,
                                int32_t alpha, int32_t v_th, int32_t v_reset,
                                int32_t ref_ticks, int32_t has_v_min,
                                int32_t v_min) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t vi = v[i];
    const int32_t ri = rc[i];
    const bool active = ri <= 0;
    int32_t v1 = wrap_add(fx_mul(vi, alpha), i_syn[i]);
    if (has_v_min) v1 = max(v1, v_min);
    const bool spike = active && (v1 >= v_th);
    v_out[i] = spike ? v_reset : (active ? v1 : vi);
    rc_out[i] = spike ? ref_ticks : max(wrap_add(ri, -1), 0);
    spikes[i] = spike ? 1 : 0;
  }
}

extern "C" int repro_lif_step(const void* v, const void* rc,
                              const void* i_syn, void* v_out, void* rc_out,
                              void* spikes, int64_t n, int32_t alpha,
                              int32_t v_th, int32_t v_reset,
                              int32_t ref_ticks, int32_t has_v_min,
                              int32_t v_min, void* stream) {
  const int threads = 256;
  lif_step_kernel<<<grid_for(n, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(rc),
      static_cast<const int32_t*>(i_syn), static_cast<int32_t*>(v_out),
      static_cast<int32_t*>(rc_out), static_cast<int32_t*>(spikes), n, alpha,
      v_th, v_reset, ref_ticks, has_v_min, v_min);
  return static_cast<int>(cudaGetLastError());
}
