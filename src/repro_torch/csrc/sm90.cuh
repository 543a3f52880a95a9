// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (mac_gemm.cu through imma.cuh, flash_attn.cu): 16-byte cp.async with
// zero fill, the 128-byte swizzled shared-memory layout that wgmma reads,
// its matrix descriptor, wgmma's fence / commit / wait, and for the
// warp-specialised kernels mbarriers, TMA tile loads and setmaxnreg.
//
// Layout.  A tile is stored as rows of 128 bytes (128 int8 or 64 bf16
// values along the row), 16-byte chunk c of row r at r * 128 +
// ((c ^ (r % 8)) * 16) from a 1024-byte-aligned base: the 128-byte swizzle
// (CUTLASS's Swizzle<3,4,3>), which spreads a column of chunks over all
// shared-memory banks.  Wider rows are split into 128-byte column blocks
// stored one after another.  wgmma applies the same XOR to the addresses
// it computes, so a descriptor whose start moves along a row by a k step
// (32 bytes) still finds every chunk.
#pragma once
#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0-7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// copy 16 bytes global -> shared without the registers; bytes past
// src_bytes (0 or 16) are written as zeros and not read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes (plain stores and cp.async)
// visible to the async proxy, through which wgmma reads its operands;
// each writer fences before the barrier that precedes the wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile starting at shared
// address addr: lbo and sbo in bytes (leading / stride byte offsets; for
// a K-major tile sbo is the step between 8-row groups, 1024, and lbo is
// unused; for an MN-major tile sbo is the step between groups of 8 k rows
// and lbo the step between 64-wide column blocks), layout 1 = SWIZZLE_128B
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A wgmma writes its accumulators (and reads a register operand) after
// the asm statement that issued it has retired.  An empty asm that
// "modifies" each register, placed after the wgmma_wait, keeps the
// compiler from reading or reusing those registers any earlier.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// mbarrier at shared address bar: a phase completes once ``count``
// arrivals (and the bytes announced by expect_tx) have landed
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// the initialised barriers visible to TMA (then __syncthreads)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive, and expect ``bytes`` of TMA transfers to complete this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity ``parity`` (0 for the first) completes
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: the box of a 4-d tensor map (a __grid_constant__ kernel parameter)
// at coordinates c0..c3 (innermost first) into shared memory at dst,
// completing on barrier bar; elements outside the tensor land as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// move this warpgroup's registers a thread to N (producers give theirs up,
// consumers take them)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace sm90
