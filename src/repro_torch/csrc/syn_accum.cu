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
// writes i_syn, about 4 MB per tick at 4096 PEs during a wave (>= ~1.3 us),
// nearly all of it the zero rows of PEs that received nothing.
//
// Design: a tick's set bits sit on a few PEs (a synfire wave lights one or
// two of 4096), so the work is spread over (PE, set bit) items, not over
// PEs.  A block of 8 warps owns up to 8 PEs (fewer on small meshes, so
// that the grid still fills the card; the grid depends on P alone):
//   1. warp w, alone, loads PE w's spike words (and in the event form the
//      overflow flag and the list, all loads in flight together), clears
//      the bits at or above NE in the last exc word and at or above NI in
//      the last inh word, and counts the rest; a PE with none, or one
//      outside the event tick's list, gets a zero row.  A block whose PEs
//      all have none (most blocks of a tick) stores its rows, which are
//      contiguous, in 16-byte stores: one load latency, one barrier and
//      the stores are all such a block does;
//   2. the block then takes its PEs with set bits one after another: warp
//      0 lists the set bits in ascending order in shared memory (exc row e
//      as e, inh row s as NE + s), the 8 warps split the list, and each
//      lane holds 8 columns of a 256-column chunk.  A warp loads the rows of
//      4 listed bits (32 independent loads a lane) before it adds any, so
//      the loads' latency overlaps instead of adding up bit after bit;
//   3. the warps' partial rows meet in shared memory and are summed into
//      i_syn.
// 8 warps a block, at most 64 registers a thread, put all 512 blocks of a
// 4096-PE mesh on the card at once; 16 or 32 warps a block were slower on
// a tick's input (more PEs a block wait for its busy one).
// Sums wrap as uint32, as the reference's int32 adds do; integer addition
// mod 2^32 is order-free, so any split of the bits gives the same bits.
// Nothing is zeroed beforehand: every row of the output is written once.
//
// Event mode passes the tick's compacted input set: a list of n_lanes PE
// ids (sentinel >= P on unused lanes) and a device flag that says whether
// the set fit the list.  While it fits, rows of unlisted PEs are zero;
// when it overflowed, every PE is computed, which is the dense result.
// Both are decided on the device from the flag, with no host branch and
// the same grid, so the tick stays capturable.
#include "fixed_point.cuh"

constexpr int SA_WARPS = 8;                   // warps a block, PEs a block
constexpr int SA_THREADS = SA_WARPS * 32;
constexpr int SA_COLS = 8;                    // columns a lane holds
constexpr int SA_SPAN = 32 * SA_COLS;         // columns a pass covers
constexpr int SA_BATCH = 4;                   // rows loaded before added
constexpr unsigned FULL_MASK = 0xffffffffu;

// The low `bits` bits set (all for bits >= 32, none for bits <= 0).
__device__ __forceinline__ uint32_t low_bits(int bits) {
  return bits >= 32 ? FULL_MASK : bits <= 0 ? 0u : (1u << bits) - 1u;
}

// 64 registers a thread: four blocks an SM
__global__ void __launch_bounds__(SA_THREADS, 32 / SA_WARPS)
syn_accum_kernel(const int32_t* __restrict__ exc_words,
                 const int32_t* __restrict__ inh_words,
                 const int32_t* __restrict__ w_ff,
                 const int32_t* __restrict__ w_inh,
                 int32_t* __restrict__ out, const int32_t* __restrict__ pes,
                 const bool* __restrict__ fits, int n_lanes, int P, int NE,
                 int NI, int N, int WE, int WI, int per_block) {
  extern __shared__ int32_t smem[];
  const int W = WE + WI;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);  // [per_block][W]
  int32_t* rows = smem + SA_WARPS * W;                  // [W * 32]
  uint32_t* part = reinterpret_cast<uint32_t*>(rows + W * 32);
  __shared__ int count[SA_WARPS];

  // 1. each warp on its PE alone: all its loads first (the words and, in
  //    the event form, the overflow flag and the list), so that their
  //    latencies overlap
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t p = p0 + warp;
  const bool mine = warp < per_block && p < P;
  int cnt = 0;
  if (mine) {
    // the first 32 words, the event form's flag and list (loaded whatever
    // the flag says), then any further words
    uint32_t x = 0;
    if (lane < W) {
      x = static_cast<uint32_t>(lane < WE ? exc_words[p * WE + lane]
                                          : inh_words[p * WI + lane - WE]);
    }
    const bool event = pes != nullptr;
    const bool fit = event && *fits;
    bool hit = false;
    for (int k = lane; event && k < n_lanes; k += 32) hit |= pes[k] == p;
    for (int j = lane; j < W; j += 32) {
      const bool exc = j < WE;
      if (j >= 32) {
        x = static_cast<uint32_t>(exc ? exc_words[p * WE + j]
                                      : inh_words[p * WI + j - WE]);
      }
      x &= low_bits((exc ? NE : NI) - 32 * (exc ? j : j - WE));
      words[warp * W + j] = x;
      cnt += __popc(x);
    }
    cnt = static_cast<int>(__reduce_add_sync(FULL_MASK, cnt));
    if (fit && !__any_sync(FULL_MASK, hit)) cnt = 0;
  }
  if (lane == 0) count[warp] = cnt;
  __syncthreads();

  // zero rows: a block with nothing to add (most of a tick's) stores its
  // rows, which are contiguous, in 16-byte stores; else each idle PE's
  // warp stores its row
  bool busy = false;
  for (int q = 0; q < per_block; ++q) busy |= count[q] > 0;
  if (!busy) {
    int32_t* base = out + p0 * N;
    const int64_t last = p0 + per_block < P ? p0 + per_block : P;
    const int64_t len = (last - p0) * N;
    const int64_t align = -reinterpret_cast<uintptr_t>(base) % 16 / 4;
    const int64_t head = align < len ? align : len;
    const int64_t quads = (len - head) / 4;
    int4* body = reinterpret_cast<int4*>(base + head);
    for (int64_t e = threadIdx.x; e < head; e += SA_THREADS) base[e] = 0;
    for (int64_t c = threadIdx.x; c < quads; c += SA_THREADS) {
      body[c] = make_int4(0, 0, 0, 0);
    }
    for (int64_t e = head + 4 * quads + threadIdx.x; e < len;
         e += SA_THREADS) {
      base[e] = 0;
    }
    return;
  }
  if (mine && cnt == 0) {
    for (int n = lane; n < N; n += 32) out[p * N + n] = 0;
  }

  // 2. the block's PEs with set bits, all warps on each
  for (int q = 0; q < per_block; ++q) {
    const int nb = count[q];                        // uniform
    if (nb == 0) continue;
    const int64_t pq = p0 + q;
    if (warp == 0) {                                // list the set bits
      int base = 0;
      for (int j0 = 0; j0 < W; j0 += 32) {
        const int j = j0 + lane;
        uint32_t x = j < W ? words[q * W + j] : 0u;
        const int c = __popc(x);
        int incl = c;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(FULL_MASK, incl, d);
          if (lane >= d) incl += y;
        }
        int at = base + incl - c;
        const int first = j < WE ? 32 * j : NE + 32 * (j - WE);
        for (; x; x &= x - 1) rows[at++] = first + __ffs(x) - 1;
        base += __shfl_sync(FULL_MASK, incl, 31);
      }
    }
    __syncthreads();                                // rows[] is ready
    const int32_t* wf = w_ff + pq * NE * N;
    const int32_t* wi = w_inh + pq * NI * NE;
    for (int n0 = 0; n0 < N; n0 += SA_SPAN) {
      uint32_t acc[SA_COLS] = {};
      for (int i0 = warp * SA_BATCH; i0 < nb; i0 += SA_WARPS * SA_BATCH) {
        int32_t v[SA_BATCH][SA_COLS];
#pragma unroll
        for (int u = 0; u < SA_BATCH; ++u) {
          const int r = i0 + u < nb ? rows[i0 + u] : -1;
          const int32_t* src = r < 0    ? wf
                               : r < NE ? wf + int64_t(r) * N
                                        : wi + int64_t(r - NE) * NE;
          const int len = r < 0 ? 0 : r < NE ? N : NE;
#pragma unroll
          for (int c = 0; c < SA_COLS; ++c) {
            const int n = n0 + 32 * c + lane;
            v[u][c] = n < len ? __ldg(src + n) : 0;
          }
        }
#pragma unroll
        for (int u = 0; u < SA_BATCH; ++u) {
#pragma unroll
          for (int c = 0; c < SA_COLS; ++c) {
            acc[c] += static_cast<uint32_t>(v[u][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < SA_COLS; ++c) {
        part[warp * SA_SPAN + 32 * c + lane] = acc[c];
      }
      __syncthreads();
      for (int n = threadIdx.x; n < SA_SPAN && n0 + n < N; n += SA_THREADS) {
        uint32_t s = 0;
#pragma unroll
        for (int w = 0; w < SA_WARPS; ++w) s += part[w * SA_SPAN + n];
        out[pq * N + n0 + n] = static_cast<int32_t>(s);
      }
      __syncthreads();                   // part[] and rows[] are free again
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
  // PEs a block: at least two blocks an SM on the 132 SMs while that
  // leaves a block no more than SA_WARPS PEs
  int per_block = (P + 2 * 132 - 1) / (2 * 132);
  if (per_block < 1) per_block = 1;
  if (per_block > SA_WARPS) per_block = SA_WARPS;
  const int blocks = (P + per_block - 1) / per_block;
  const size_t smem = sizeof(int32_t) * ((SA_WARPS + 32) * (WE + WI) +
                                         SA_WARPS * SA_SPAN);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        syn_accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (blocks > 0) {
    syn_accum_kernel<<<blocks, SA_THREADS, smem, s>>>(
        static_cast<const int32_t*>(exc_words),
        static_cast<const int32_t*>(inh_words),
        static_cast<const int32_t*>(w_ff), static_cast<const int32_t*>(w_inh),
        static_cast<int32_t*>(out), static_cast<const int32_t*>(pes),
        static_cast<const bool*>(fits), n_lanes, P, NE, NI, N, WE, WI,
        per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
