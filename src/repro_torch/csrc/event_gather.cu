// Event-mode accounting for Hopper (sm_90a): the active-lane compaction
// and the NoC link loads of the active sources' multicast trees.
//
// 1. compact_lanes_kernel
//
// New: it has no Pallas counterpart.  It replaces the reference's tag
// sorts: the two-level compaction of the event tick's input set
// (repro/core/snn.py, ``compact``: the active 64-lane chunks by a chunk-tag
// sort, then the set lanes of the first kc of them by a lane-tag sort) and
// the one-level ``active_source_set`` of repro/kernels/event_gather/ops.py
// (kc = every chunk).  On the card those were about a dozen launches and
// 50 us a tick, for a list of at most 1024 ids.
//
// Bound: latency.  It reads P bytes and writes cap_eff ids; one block
// does it in a few passes over shared memory:
//   1. each warp ballots 32 mask bytes at a time into bit words;
//   2. thread t takes chunk t (64 lanes, two words): whether it is active
//      and how many lanes it holds; one block-wide exclusive scan gives
//      both each active chunk's rank and the total lanes;
//   3. the chunks ranked below kc are selected; a second scan over their
//      lane counts gives each its first output slot, and the thread writes
//      its lane ids there in ascending order, as far as slot cap_eff;
//   4. the rest of the list gets the sentinel P, and thread 0 writes fits
//      (no more than cap_eff lanes in no more than kc chunks) and the lane
//      count.
// The list is the sorts' bit for bit, both overflow kinds included.  One
// block of 1024 threads holds 1024 chunks: P up to 65536, which the
// wrapper enforces (the reference sorts uint16 tags below that size).  A
// leading batch axis gives one block a row.  The grid depends on the
// shapes alone and nothing is read back to the host.
//
// 2. event_link_loads_smem_kernel, event_link_loads_kernel
//
// Replaces the Pallas kernel
// repro/kernels/event_gather/event_gather.py::_onehot_accum_kernel together
// with the gather stage around it (event_gather/ops.py::gather_entries).
// The TPU has no scatter-add, so that kernel materialises the gathered
// (cap * L) entries and reduces a one-hot (M, 128) hit mask per block of
// link lanes.  Here a thread takes a source: it reads the source's
// weights and, when one is nonzero, its padded row of link ids (16-byte
// loads, four in flight: 16 slots), and adds each nonzero weight into
// those links' counts.  The sources are the listed lanes' (idx given,
// sentinel ids >= P skipped) or every source (idx null: no compaction
// runs in front of the kernel, and a quiet source reads no row).
// Sentinel link ids (>= n_links) are skipped.  On the 4096-PE mesh the
// smem route has a thread for each source: two load latencies (three with
// a listed idx), then the adds.
//
// Bound: latency.  At 4096 PEs it reads at most P * (L + 2) * 4 bytes and
// writes batch * n_links floats: well under a megabyte.  Two routes,
// chosen by shape on the host (kernels/event_gather/ops.py::route):
//   * smem, for one or two rows whose counts fit in 48 KB (2 x 3968 for
//     the 4096-PE ring and farm): a cluster of 8 blocks of 512 threads,
//     each with a zeroed int32 histogram in its shared memory, splits the
//     sources; after cluster.sync() block r sums range r of the histograms
//     over distributed shared memory and writes it as float.  One launch,
//     no memset, no global atomics.  The integer histogram matters: shared
//     float atomics are a compare-and-swap loop, which stalls where
//     sources share links.  Fewer blocks (down to one, without a cluster)
//     were slower on the farm's rows: each SM holds more sources; the
//     cluster's barriers and remote reads are a fixed part of the time,
//     whatever the activity.
//   * global, for larger meshes (or more than two rows): the output is
//     zeroed by cudaMemsetAsync and the sources add with global float
//     atomicAdd, two rows a launch.
// Determinism: every term is an integer-valued float32 (a packet or flit
// count) and every link's sum stays below 2^24, so every partial sum is
// exact in float32 and in int32, and any order of the atomics, and of the
// cluster's sum, gives the same bits.  The plain version's tests check
// that bound on their inputs.
#include <cooperative_groups.h>

#include "fixed_point.cuh"

namespace cg = cooperative_groups;

constexpr unsigned FULL_MASK = 0xffffffffu;

// ---------------------------------------------------------------- compaction

constexpr int CP_THREADS = 1024;
constexpr int CP_CHUNK = 64;
constexpr int CP_MAX_P = CP_THREADS * CP_CHUNK;

// Exclusive prefix sum of v over the block (1024 threads); *total gets the
// block's sum.  `scratch` holds 32 ints of shared memory.
__device__ int block_exclusive_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = scratch[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, s, d);
      if (lane >= d) s += y;
    }
    scratch[lane] = s;
  }
  __syncthreads();
  const int ex = x - v + (warp ? scratch[warp - 1] : 0);
  *total = scratch[31];
  __syncthreads();                                  // scratch is free again
  return ex;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_lanes_kernel(const bool* __restrict__ mask, int P, int kc, int cap,
                     int32_t* __restrict__ idx, bool* __restrict__ fits,
                     int32_t* __restrict__ n_active) {
  __shared__ uint32_t bits[CP_MAX_P / 32];
  __shared__ int scratch[32];
  const int row = blockIdx.x;
  mask += static_cast<int64_t>(row) * P;
  idx += static_cast<int64_t>(row) * cap;
  const int nc = (P + CP_CHUNK - 1) / CP_CHUNK;
  const int t = threadIdx.x;

  // 1. the mask as bit words, 32 lanes a word
#pragma unroll 4
  for (int base = 0; base < nc * CP_CHUNK; base += CP_THREADS) {
    const int i = base + t;
    const unsigned b = __ballot_sync(FULL_MASK, i < P && mask[i]);
    if (t % 32 == 0) bits[i / 32] = b;
  }
  __syncthreads();

  // 2. chunk t: active?  how many lanes?  Ranks and totals by one scan of
  //    both counts packed in an int (<= 1024 chunks: 11 bits from bit 17;
  //    <= 65536 lanes: 17 bits)
  const uint64_t m = t < nc ? (static_cast<uint64_t>(bits[2 * t + 1]) << 32
                               | bits[2 * t])
                            : 0;
  const int lanes = __popcll(m);
  int total;
  const int before = block_exclusive_scan((int(m != 0) << 17) | lanes, &total,
                                          scratch);
  const int chunks = total >> 17, set = total & 0x1FFFF;

  // 3. the first kc active chunks write their lanes in ascending order
  const int mine = m != 0 && (before >> 17) < kc ? lanes : 0;
  int listed;
  int at = block_exclusive_scan(mine, &listed, scratch);
  for (uint64_t x = mine ? m : 0; x && at < cap; x &= x - 1, ++at) {
    idx[at] = t * CP_CHUNK + __ffsll(static_cast<long long>(x)) - 1;
  }

  // 4. sentinels after the listed lanes; the flags
  for (int q = listed + t; q < cap; q += CP_THREADS) idx[q] = P;
  if (t == 0) {
    if (fits != nullptr) fits[row] = set <= cap && chunks <= kc;
    if (n_active != nullptr) n_active[row] = set;
  }
}

extern "C" int repro_compact_lanes(const void* mask, void* idx, void* fits,
                                   void* n_active, int32_t rows, int32_t P,
                                   int32_t kc, int32_t cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > CP_MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    compact_lanes_kernel<<<rows, CP_THREADS, 0, s>>>(
        static_cast<const bool*>(mask), P, kc, cap,
        static_cast<int32_t*>(idx), static_cast<bool*>(fits),
        static_cast<int32_t*>(n_active));
  }
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- link loads

constexpr int EG_CLUSTER = 8;
constexpr int EG_THREADS = 512;
constexpr int EG_QUADS = 4;           // row quads a thread has in flight

// Lane k's source (idx[k], or k when idx is null) adds its weights into
// the links of its tree: `add(b, lid, v)` for each nonzero weight and each
// valid link id.  Nothing for a sentinel or out-of-range source, nor for a
// quiet one (all weights zero): its row is not read.  The row's link ids
// are loaded EG_QUADS quads at a time (one 16-byte load each when VEC:
// L % 4 == 0 and the rows 16-byte aligned) before any is added, so their
// loads are in flight together.
template <int B, bool VEC, typename Add>
__device__ __forceinline__ void add_source(const int32_t* __restrict__ idx,
                                           const float* __restrict__ w,
                                           const int32_t* __restrict__ rows,
                                           int k, int n_src, int L,
                                           int n_links, Add add) {
  const int s = idx == nullptr ? k : idx[k];
  if (s < 0 || s >= n_src) return;
  float v[B];
  bool any = false;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    v[b] = w[b * n_src + s];
    any |= v[b] != 0.0f;
  }
  if (!any) return;
  const int32_t* row = rows + static_cast<int64_t>(s) * L;
  for (int j0 = 0; j0 < L; j0 += 4 * EG_QUADS) {
    int4 lid[EG_QUADS];
#pragma unroll
    for (int m = 0; m < EG_QUADS; ++m) {
      const int j = j0 + 4 * m;
      if (j >= L) {
        lid[m] = make_int4(-1, -1, -1, -1);
      } else if (VEC) {
        lid[m] = __ldg(reinterpret_cast<const int4*>(row + j));
      } else {
        lid[m] = make_int4(row[j], j + 1 < L ? row[j + 1] : -1,
                           j + 2 < L ? row[j + 2] : -1,
                           j + 3 < L ? row[j + 3] : -1);
      }
    }
#pragma unroll
    for (int m = 0; m < EG_QUADS; ++m) {
      const int ids[4] = {lid[m].x, lid[m].y, lid[m].z, lid[m].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (ids[t] < 0 || ids[t] >= n_links) continue;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (v[b] != 0.0f) add(b, ids[t], v[b]);
        }
      }
    }
  }
}

template <int B, bool VEC>
__global__ void __cluster_dims__(EG_CLUSTER, 1, 1)
__launch_bounds__(EG_THREADS)
event_link_loads_smem_kernel(const int32_t* __restrict__ idx,
                             const float* __restrict__ w,
                             const int32_t* __restrict__ rows,
                             float* __restrict__ out, int n_src, int n_items,
                             int L, int n_links) {
  // The counts are integers below 2^24 (see above), so the histogram
  // holds them as int32: shared-memory integer atomics are single
  // instructions, float ones a compare-and-swap loop that stalls when
  // sources share links.  Each count converts back to float exactly.
  extern __shared__ int32_t hist[];                 // (B, n_links)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int total = B * n_links;
  for (int e = threadIdx.x; e < total; e += EG_THREADS) hist[e] = 0;
  __syncthreads();
  for (int k = rank * EG_THREADS + threadIdx.x; k < n_items;
       k += EG_CLUSTER * EG_THREADS) {
    add_source<B, VEC>(idx, w, rows, k, n_src, L, n_links,
                       [&](int b, int lid, float v) {
      atomicAdd(hist + b * n_links + lid, __float2int_rn(v));
    });
  }
  cluster.sync();                       // every histogram is complete
  const int span = (total + EG_CLUSTER - 1) / EG_CLUSTER;
  const int end = min(total, (rank + 1) * span);
  for (int e = rank * span + threadIdx.x; e < end; e += EG_THREADS) {
    int sum = 0;
#pragma unroll
    for (int r = 0; r < EG_CLUSTER; ++r) {
      sum += cluster.map_shared_rank(hist, r)[e];
    }
    out[e] = static_cast<float>(sum);
  }
  // No block leaves while its histogram may still be read.  The remote
  // reads are done (their sums are stored); a relaxed arrival does not wait
  // for the stores to land, as cluster.sync()'s release would.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int B, bool VEC>
__global__ void event_link_loads_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const int32_t* __restrict__ rows,
                                        float* __restrict__ out, int n_src,
                                        int n_items, int L, int n_links) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n_items;
       k += blockDim.x * gridDim.x) {
    add_source<B, VEC>(idx, w, rows, k, n_src, L, n_links,
                       [&](int b, int lid, float v) {
      atomicAdd(out + b * n_links + lid, v);
    });
  }
}

template <int B, bool VEC>
int launch_link_loads(const int32_t* idx, const float* w,
                      const int32_t* rows, float* out, int32_t n_src,
                      int32_t n_items, int32_t L, int32_t n_links,
                      int32_t route, cudaStream_t s) {
  if (route == 0) {
    const size_t smem = sizeof(int32_t) * B * n_links;
    event_link_loads_smem_kernel<B, VEC>
        <<<EG_CLUSTER, EG_THREADS, smem, s>>>(idx, w, rows, out, n_src,
                                              n_items, L, n_links);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 128;                 // the caller zeroed the output
  if (n_items > 0) {
    event_link_loads_kernel<B, VEC>
        <<<grid_for(n_items, threads), threads, 0, s>>>(
            idx, w, rows, out, n_src, n_items, L, n_links);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int launch_link_loads_vec(const int32_t* idx, const float* w,
                          const int32_t* rows, float* out, int32_t n_src,
                          int32_t n_items, int32_t L, int32_t n_links,
                          int32_t route, cudaStream_t s) {
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  return vec ? launch_link_loads<B, true>(idx, w, rows, out, n_src, n_items,
                                          L, n_links, route, s)
             : launch_link_loads<B, false>(idx, w, rows, out, n_src, n_items,
                                           L, n_links, route, s);
}

// route: 0 = smem (the caller checked that batch <= 2 and that the batch *
// n_links counts fit in 48 KB), 1 = global, two rows a launch.  idx may be
// null: every source.
extern "C" int repro_event_link_loads(const void* idx, const void* w,
                                      const void* rows, void* out,
                                      int32_t batch, int32_t n_src,
                                      int32_t n_items, int32_t L,
                                      int32_t n_links, int32_t route,
                                      void* stream) {
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* r = static_cast<const int32_t*>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    cudaError_t rc =
        cudaMemsetAsync(out, 0, sizeof(float) * batch * n_links, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  for (int b0 = 0; b0 < batch; b0 += 2) {
    const auto* wp = static_cast<const float*>(w) + int64_t(b0) * n_src;
    auto* o = static_cast<float*>(out) + int64_t(b0) * n_links;
    const int rc = batch - b0 == 1
        ? launch_link_loads_vec<1>(i, wp, r, o, n_src, n_items, L, n_links,
                                   route, s)
        : launch_link_loads_vec<2>(i, wp, r, o, n_src, n_items, L, n_links,
                                   route, s);
    if (rc != 0) return rc;
  }
  return 0;
}
