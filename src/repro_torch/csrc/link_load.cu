// Per-link NoC loads from the multicast-tree incidence, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/link_load/link_load.py::_prefix_sum_kernel together with
// the boundary differences around it in link_load/ops.py::link_loads_csc
// and the flit weighting of repro/chip/mesh_noc.py::noc_loads.  That
// kernel takes a prefix sum with a carry across a sequential grid because
// the TPU has no scatter-add.  Here blocks run in parallel and in no
// order, so each link's sum is a direct segmented sum over its sources.
// Every term and every link's sum is an integer below 2^24 in float32, so
// any order of the sum gives the reference's bits; no atomics, and the
// launch shape depends on tensor shapes alone.
//
// noc_link_loads_kernel: thread (b, l) sums row b of the per-source
// counts w (B, n_src) over link l's sources and, when a flits-per-packet
// row fl (n_src,) is given, the same counts weighted by it, in one pass:
// one index load serves both sums.  The engine's tick calls it with one
// row, the tick's packets, and the run's flits (computed once where the
// payload bits are static): its NoC accounting is one launch.  The public
// link_loads_csc calls it with B rows (the grid's y) and no flits.  Two
// routes, by the plan given (MeshNoc.device_plan picks it by fan-in):
//  * padded: a link-major table ids[k * n_links + l] of each link's
//    sources, padded with the sentinel n_src.  Slot k of every link of a
//    warp is one coalesced load with no pointer to wait for; then the
//    counts and flits of that source: two dependent trips to memory at
//    fan-in 1.  A link's slots fill in order, so its first sentinel ends
//    it, and each slot waits for the one before.
//  * CSC: link_ptr (int32), then src_sorted, then the counts: three
//    dependent trips, and the entries' loads need not wait on each other.
// On the 4096-PE ring (fan-in 1) the padded route is the faster, on the
// 4096-PE farm (fan-in 64) the CSC route, by 3x.
//
// Bound: latency.  On the main path (4096 sources, 3968 links, 1054
// entries, fan-in 1) the kernel moves about 60 KB, some 20 ns at HBM
// rate; its time is the launch and the chain of dependent loads.  The
// plan and the flits row are the same every tick, while the tick streams
// tens of MB through L2 (LIF state, synaptic rows) and would evict them:
// their loads carry an L2 evict_last policy, so they stay L2 hits where
// the packets, written just before, already are.  Staging the packet rows
// in shared memory would save one more trip, but every block would read
// all 32 KB of them to use a few dozen entries; at about 21 bytes a cycle
// from L2 to one SM that costs more than the trip it saves.
#include "fixed_point.cuh"


// A read-only load under an L2 cache policy (here evict_last: keep).
__device__ __forceinline__ int32_t load_kept(const int32_t* p,
                                             uint64_t policy) {
  int32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float load_kept(const float* p, uint64_t policy) {
  return __int_as_float(
      load_kept(reinterpret_cast<const int32_t*>(p), policy));
}

template <bool kPadded>
__global__ void noc_link_loads_kernel(const float* __restrict__ w,
                                      const float* __restrict__ fl,
                                      const int32_t* __restrict__ ids,
                                      const int32_t* __restrict__ link_ptr,
                                      float* __restrict__ out, int n_src,
                                      int n_links, int fan) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n_links) return;
  uint64_t keep;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  const int b = blockIdx.y;
  const float* wb = w + static_cast<int64_t>(b) * n_src;
  float sum = 0.0f, weighted = 0.0f;
  auto add = [&](int s) {
    const float p = wb[s];
    sum += p;
    if (fl != nullptr) weighted += p * load_kept(fl + s, keep);
  };
  if constexpr (kPadded) {
    for (int k = 0; k < fan; ++k) {
      const int s = load_kept(ids + static_cast<int64_t>(k) * n_links + l,
                              keep);
      if (s >= n_src) break;
      add(s);
    }
  } else {
    const int end = load_kept(link_ptr + l + 1, keep);
    for (int e = load_kept(link_ptr + l, keep); e < end; ++e) {
      add(load_kept(ids + e, keep));
    }
  }
  out[static_cast<int64_t>(b) * n_links + l] = sum;
  if (fl != nullptr) {
    out[static_cast<int64_t>(gridDim.y + b) * n_links + l] = weighted;
  }
}

// w: (batch, n_src) counts, batch < 65536 (the grid's y); fl: (n_src,)
// flits per packet or null; ids: the padded table (fan, n_links) when
// link_ptr is null, else src_sorted (nnz,) with link_ptr (n_links + 1,);
// out: (batch, n_links) sums, then, with fl, (batch, n_links) flit sums.
extern "C" int repro_noc_link_loads(const void* w, const void* fl,
                                    const void* ids, const void* link_ptr,
                                    void* out, int64_t batch, int64_t n_src,
                                    int64_t n_links, int64_t fan,
                                    void* stream) {
  const int threads = 128;
  const dim3 grid(static_cast<unsigned>((n_links + threads - 1) / threads),
                  static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, threads, 0, s>>>(
        static_cast<const float*>(w), static_cast<const float*>(fl),
        static_cast<const int32_t*>(ids),
        static_cast<const int32_t*>(link_ptr), static_cast<float*>(out),
        static_cast<int>(n_src), static_cast<int>(n_links),
        static_cast<int>(fan));
  };
  if (link_ptr == nullptr) {
    args(noc_link_loads_kernel<true>);
  } else {
    args(noc_link_loads_kernel<false>);
  }
  return static_cast<int>(cudaGetLastError());
}
