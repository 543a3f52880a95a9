// Event-driven int32 synaptic accumulation of the synfire tick, for Hopper
// (sm_90a).
//
// New: it has no Pallas counterpart.  It replaces the two int32 einsums of
// repro/core/snn.py (dense tick: i_ff = arr_exc . w_ff, i_in = arr_inh .
// w_inh added into columns [:NE]; event tick: the same einsums over the
// compacted lanes' weight slabs), which XLA ran outside any Pallas kernel.
//
// Bound: bytes.  The dense einsum reads every weight every tick: 983 MB of
// int32 at 4096 PEs, >= 0.29 ms at 3.35 TB/s.  The PE of the paper only
// walks the synapse rows of spikes that arrived, and so does this kernel:
// it reads the packed delay-line words, the weight rows of the set bits and
// writes i_syn, about 4 MB per tick at 4096 PEs during a wave (>= ~1.3 us).
//
// Design: one block per PE, one thread per target neuron.  The block
// stages the PE's spike words (WE exc + WI inh) in shared memory; every
// thread walks the same set bits with __ffs, so the walk is uniform across
// the block, and for each set bit reads its own column of the weight row:
// the block's reads of one row are contiguous and coalesce.  Sums stay in
// a register and wrap as uint32, as the reference's int32 adds wrap.  A PE
// with no set bits reads no weights and writes zeros.
//
// Event mode passes the tick's compacted input set: a list of n_lanes PE
// ids (sentinel >= P on unused lanes) and a device flag that says whether
// the set fit the list.  The output is zeroed first; when the flag is set,
// block k handles PE pes[k] only, so PEs outside the set keep the zero
// rows the dense einsum gives them.  When the set overflowed, the blocks
// cover all P PEs in a grid-stride loop, which is the dense result: the
// overflow fallback needs no host branch, so the tick stays capturable.
#include "fixed_point.cuh"

__device__ void accumulate_pe(int64_t p, uint32_t* words,
                              const int32_t* __restrict__ exc_words,
                              const int32_t* __restrict__ inh_words,
                              const int32_t* __restrict__ w_ff,
                              const int32_t* __restrict__ w_inh,
                              int32_t* __restrict__ out, int NE, int NI,
                              int N, int WE, int WI) {
  __syncthreads();                    // the previous PE's walk is done
  for (int j = threadIdx.x; j < WE + WI; j += blockDim.x) {
    words[j] = static_cast<uint32_t>(j < WE ? exc_words[p * WE + j]
                                            : inh_words[p * WI + j - WE]);
  }
  __syncthreads();
  const int32_t* wf = w_ff + p * NE * N;
  const int32_t* wi = w_inh + p * NI * NE;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    uint32_t acc = 0;
    for (int j = 0; j < WE; ++j) {
      for (uint32_t bits = words[j]; bits; bits &= bits - 1) {
        const int e = j * 32 + __ffs(bits) - 1;
        if (e < NE) acc += static_cast<uint32_t>(wf[int64_t(e) * N + n]);
      }
    }
    if (n < NE) {
      for (int j = 0; j < WI; ++j) {
        for (uint32_t bits = words[WE + j]; bits; bits &= bits - 1) {
          const int s = j * 32 + __ffs(bits) - 1;
          if (s < NI) acc += static_cast<uint32_t>(wi[int64_t(s) * NE + n]);
        }
      }
    }
    out[p * N + n] = static_cast<int32_t>(acc);
  }
}

__global__ void syn_accum_kernel(const int32_t* __restrict__ exc_words,
                                 const int32_t* __restrict__ inh_words,
                                 const int32_t* __restrict__ w_ff,
                                 const int32_t* __restrict__ w_inh,
                                 int32_t* __restrict__ out,
                                 const int32_t* __restrict__ pes,
                                 const bool* __restrict__ fits, int P,
                                 int NE, int NI, int N, int WE, int WI) {
  extern __shared__ uint32_t words[];           // [WE exc | WI inh]
  if (pes == nullptr) {
    accumulate_pe(blockIdx.x, words, exc_words, inh_words, w_ff, w_inh, out,
                  NE, NI, N, WE, WI);
  } else if (*fits) {
    const int p = pes[blockIdx.x];
    if (p >= 0 && p < P) {
      accumulate_pe(p, words, exc_words, inh_words, w_ff, w_inh, out, NE,
                    NI, N, WE, WI);
    }
  } else {
    for (int64_t p = blockIdx.x; p < P; p += gridDim.x) {
      accumulate_pe(p, words, exc_words, inh_words, w_ff, w_inh, out, NE,
                    NI, N, WE, WI);
    }
  }
}

extern "C" int repro_syn_accum(const void* exc_words, const void* inh_words,
                               const void* w_ff, const void* w_inh, void* out,
                               const void* pes, const void* fits,
                               int32_t n_lanes, int32_t P, int32_t NE,
                               int32_t NI, int32_t N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int WE = (NE + 31) / 32;
  const int WI = (NI + 31) / 32;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = sizeof(uint32_t) * (WE + WI);
  int blocks = P;
  if (pes != nullptr) {
    cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(int32_t) * P * N, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    blocks = n_lanes;
  }
  if (blocks > 0) {
    syn_accum_kernel<<<blocks, threads, smem, s>>>(
        static_cast<const int32_t*>(exc_words),
        static_cast<const int32_t*>(inh_words),
        static_cast<const int32_t*>(w_ff), static_cast<const int32_t*>(w_inh),
        static_cast<int32_t*>(out), static_cast<const int32_t*>(pes),
        static_cast<const bool*>(fits), P, NE, NI, N, WE, WI);
  }
  return static_cast<int>(cudaGetLastError());
}
