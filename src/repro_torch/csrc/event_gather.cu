// Event-mode NoC link loads from a compacted active-source buffer, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/event_gather/event_gather.py::_onehot_accum_kernel together
// with the gather stage around it (event_gather/ops.py::gather_entries).
// The TPU has no scatter-add, so that kernel materialises the gathered
// (cap * L) entries and reduces a one-hot (M, 128) hit mask per block of
// link lanes.  Hopper has native float atomicAdd, so the design is one
// thread per gathered entry (active lane k, tree slot j): it reads idx[k]
// and padded_rows[idx[k], j], skips sentinel ids (idx[k] >= P, link id >=
// n_links) and weight-0 rows, and adds its weight into the zeroed output.
// Gather and accumulation go in one launch, so the entry arrays are never
// written to device memory; a leading batch axis (packets and flits) is
// handled by the same thread, one atomic per row.
//
// Determinism: every term is an integer-valued float32 (a packet or flit
// count) and every link's sum stays below 2^24, so every partial sum is
// exact and any order of the atomics gives the same bits.  The plain
// version's test checks that bound on its inputs.
//
// Bound: launch latency on the main path.  At 4096 PEs with every source
// active it reads cap * 4 + P * (L + 2) * 4 bytes and writes 2 * n_links
// floats: well under a megabyte, a fraction of a microsecond of HBM time.
#include "fixed_point.cuh"

__global__ void event_link_loads_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const int32_t* __restrict__ rows,
                                        float* __restrict__ out,
                                        int64_t batch, int64_t n_src,
                                        int64_t cap, int64_t L,
                                        int64_t n_links) {
  const int64_t total = cap * L;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t k = i / L;
    const int64_t s = idx[k];
    if (s < 0 || s >= n_src) continue;
    const int64_t lid = rows[s * L + (i - k * L)];
    if (lid < 0 || lid >= n_links) continue;
    for (int64_t b = 0; b < batch; ++b) {
      const float v = w[b * n_src + s];
      if (v != 0.0f) atomicAdd(out + b * n_links + lid, v);
    }
  }
}

extern "C" int repro_event_link_loads(const void* idx, const void* w,
                                      const void* rows, void* out,
                                      int64_t batch, int64_t n_src,
                                      int64_t cap, int64_t L,
                                      int64_t n_links, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc =
      cudaMemsetAsync(out, 0, sizeof(float) * batch * n_links, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int threads = 256;
  if (cap * L > 0) {
    event_link_loads_kernel<<<grid_for(cap * L, threads), threads, 0, s>>>(
        static_cast<const int32_t*>(idx), static_cast<const float*>(w),
        static_cast<const int32_t*>(rows), static_cast<float*>(out), batch,
        n_src, cap, L, n_links);
  }
  return static_cast<int>(cudaGetLastError());
}
