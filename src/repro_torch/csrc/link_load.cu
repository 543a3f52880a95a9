// Per-link NoC loads from the link-major (CSC) multicast incidence, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/link_load/link_load.py::_prefix_sum_kernel together with
// the boundary differences around it in link_load/ops.py::link_loads_csc.
// That kernel takes a prefix sum with a carry across a sequential grid
// because the TPU has no scatter-add, and it is exact only while the
// running total of all entries stays below 2^24.  Here blocks run in
// parallel and in no order, so the design is a direct segmented sum: one
// thread per (batch row, link) adds w[b, src_sorted[e]] over its entries
// e in [link_ptr[l], link_ptr[l+1]) in a fixed order.  Deterministic, no
// atomics, and exact whenever each link's own sum is an integer < 2^24.
// A leading batch axis (packets and flits) goes in one launch.
//
// Bound: launch latency.  On the main path (4096 sources, 3968 links,
// nnz in the thousands, batch 2) it moves tens of kilobytes, a few
// nanoseconds of memory time.
#include "fixed_point.cuh"

__global__ void link_loads_csc_kernel(const float* __restrict__ w,
                                      const int32_t* __restrict__ src_sorted,
                                      const int64_t* __restrict__ link_ptr,
                                      float* __restrict__ out, int64_t batch,
                                      int64_t n_src, int64_t n_links) {
  const int64_t total = batch * n_links;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t b = i / n_links;
    const int64_t l = i - b * n_links;
    const float* wb = w + b * n_src;
    float acc = 0.0f;
    for (int64_t e = link_ptr[l]; e < link_ptr[l + 1]; ++e) {
      acc += wb[src_sorted[e]];
    }
    out[i] = acc;
  }
}

extern "C" int repro_link_loads_csc(const void* w, const void* src_sorted,
                                    const void* link_ptr, void* out,
                                    int64_t batch, int64_t n_src,
                                    int64_t n_links, void* stream) {
  const int threads = 128;
  link_loads_csc_kernel<<<grid_for(batch * n_links, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int32_t*>(src_sorted),
      static_cast<const int64_t*>(link_ptr), static_cast<float*>(out), batch,
      n_src, n_links);
  return static_cast<int>(cudaGetLastError());
}
