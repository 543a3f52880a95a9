// s16.15 fixed-point exp and ln for Hopper (sm_90a).
//
// fx_exp replaces the Pallas kernel
// repro/kernels/explog/explog.py::_fx_exp_kernel (via fx_exp_pallas and
// explog/ops.py::fx_exp): clip to +-15, range-reduce by LN2 with a floor
// divide, a 15-step shift-add ladder over ln(1 + 2^-k), a first-order
// remainder and a saturating 2^n shift.
//
// fx_log replaces repro/kernels/explog/explog.py::_fx_log_kernel (via
// fx_log_pallas and explog/ops.py::fx_log): normalise x to z in [1, 2)
// with shifts of 15/8/4/2/1 down and 8/4/2/1/1 up, then the same ladder
// run the other way (take the factor 1 + 2^-k while w (1 + 2^-k) <= z,
// adding ln(1 + 2^-k)), a first-order remainder (z - w) / w floor-divided,
// and -2^30 for x <= 0.  Every intermediate stays inside int32 (z < 2^16),
// so nothing wraps.
//
// Bound: on a 1 M-element sample either function reads and writes 8 MB
// (>= 2.5 us at 3.35 TB/s).  An SM issues 128 lanes a cycle, half to its
// 64-lane INT32 pipe and half as IMADs to the FMA pipe, so integer work
// of 80 operations an element also takes 2.5 us; fewer than about 20 an
// element leave the bytes the bound.
//
// fx_exp is a table lookup, bitwise equal to the reference:
//  * after the clamp, r = x - floor(x / LN2) LN2 lies in [0, LN2), and the
//    ladder's mantissa depends on r alone.  Its final remainder is 0 for
//    every r (the table ends in 2 and 1, so the last steps take whatever
//    is left), so the first-order term (y r) >> 15 never adds anything,
//    and the mantissa M[r] lies in [2^15, 2^16).
//  * M[r] is within a few units of floor(2^15 exp(r 2^-15)), which the
//    card computes in four instructions (I2F, FFMA, MUFU.EX2, F2I) as
//    floor(2^(15 + r log2(e) 2^-15)); the table holds the difference, one
//    int8 per residue: 22,720 bytes, where M itself as uint16 takes
//    45,426.  At 2^20 elements a block's share of the data (16 KB in,
//    16 KB out) is smaller than a 45 KB table.  Both uint16 designs stay
//    below, timed beside this one by chip_smoke.py (fx_exp_routes; H100
//    SXM at 700 W, 2^20 elements, L2 flushed): this table 5.47 us cold,
//    2.97 warm; M filled in every block 6.14 and 3.25; M multicast
//    across clusters of four blocks 6.81 and 4.97.
//    fx_exp_build_table_kernel runs the reference's ladder and the same
//    exp_approx, once per device, and counts every residue with a
//    remainder left, a mantissa outside [2^15, 2^16) or a difference
//    outside int8; the wrapper refuses a table with any.  Against the
//    exact exp the differences lie in [-7, 2]; tests/test_torch_fxexp.py
//    checks every r with the approximation moved by up to 4 ulp either
//    way, and chip_smoke.py reads the card's table.
//  * the floor division without the int32 division routine: with the
//    clamp, u = x + 22 LN2 lies in [8166, 991206], and
//    floor(u / LN2) = umulhi(u, 3025558) >> 4 for every u < 2^20 (checked
//    exhaustively); n = q - 22, and r = u - q LN2 is one IMAD.
//  * the saturating 2^n shift without branches: n lies in [-22, 21], so the
//    reference's clamp of n to +-31 never acts; M 2^n for n < 16 is
//    (M << 16) >> (16 - n) as uint32 with PTX's clamped shift (an amount
//    of 32 or more gives 0, as M >> 16.. does), and n >= 16 gives
//    INT32_MAX.  M 2^15 < 2^31, so the reference's left shift never wraps.
//  Two routes, chosen by the wrapper by the element count:
//  * fx_exp_table_kernel: the table in 22 KB of static shared memory,
//    filled once per block while each thread's first four elements are
//    already on their way; a persistent grid of a few blocks an SM, four
//    elements a thread as int4 where both pointers are 16-byte aligned,
//    one element a thread for the tail and for unaligned views.  22.5
//    SASS instructions an element; random residues spread the lookups
//    3.5-way over the 32 banks on average (chip_smoke.py counts them).
//  * fx_exp_ladder_kernel, for the few elements of the paths (the LIF
//    decay alpha: one), where filling the table costs more than the
//    ladder (see EXP_TABLE_MIN_N in kernels/explog/ops.py): the same
//    division and shift around a select-free ladder whose take bit, a
//    sign shift, feeds IMADs, one element a thread.  The wrapper takes
//    the table from 2^15 elements on, where the two cross.
//
// fx_log cuts the instructions an element, each step bitwise equal to the
// reference's (tests/test_torch_fxlog.py writes them out in torch):
//  * normalisation in one shift: with lead = __clz(z) (z >= 1, so
//    msb = 31 - lead), z << lead puts the msb at bit 31 and >> 16 leaves
//    z 2^(15 - msb) truncated, in [2^15, 2^16).  The reference's down
//    shifts 15/8/4/2/1 are a greedy split of msb - 15 <= 15, and truncating
//    right shifts compose; its up shifts 8/4/2/1/1 are exact left shifts
//    adding up to 15 - msb (the last 1 never fires).  e = msb - 15.
//  * the ladder without selects: take = (w + t - z - 1) >>> 31 is 1 when
//    w + t <= z (t = w >> k), and w += t * take, acc += ln(1 + 2^-k) * take
//    are IMADs, which run on the FMA pipe and leave the INT32 pipe to
//    the shift, the three-input add and the sign shift: five instructions
//    a step.  Written as C++ arithmetic, nvcc turns t * take into a mask
//    and an add, two INT32 instructions, so the IMADs are PTX mad.lo (read
//    in cuobjdump -sass).  w stays in [2^15, 2^16), so the last step's
//    t = w >> 15 is 1.
//  * the remainder without the int32 division routine: r = z - w is in
//    [0, 2^15) and w in [2^15, 2^16), so num = r 2^15 < 2^30 and the
//    quotient q = floor(num / w) < 2^15.  float32 holds r, w and w 2^-15
//    exactly; r times the approximate reciprocal of w 2^-15 (rcp.approx,
//    within 1 ulp, and the product's rounding, half an ulp) is within
//    2^15 * 2^-22 < 0.01 of num / w, so its truncation q0 is q - 1, q or
//    q + 1, and one correction step each way (rem = num - q0 w, +1 if
//    rem >= w, -1 if rem < 0) gives q.  tests/test_torch_fxlog.py checks
//    every z in [2^15, 2^16) with the estimate moved by up to 4 ulp
//    either way; the card test runs every int32.
//  * four elements a thread, loaded and stored as int4 where both pointers
//    are 16-byte aligned, so four independent ladders hide each other's
//    latency; the rest (tail, unaligned views) one element a thread.
#include <cooperative_groups.h>

#include "fixed_point.cuh"

namespace cg = cooperative_groups;

namespace {
constexpr int32_t kFxOne = 1 << 15;
constexpr int32_t kLn2 = 22713;                 // round(ln 2 * 2^15)
constexpr int32_t kMaxExpArg = 15 << 15;
constexpr int32_t kInt32Max = 0x7FFFFFFF;
constexpr int32_t kLogBad = -(1 << 30);         // ln of x <= 0
// floor(x / LN2) for clamped x: u = x + kExpBias in [8166, 991206],
// q = umulhi(u, kExpMagic) >> kExpShift, n = q - 22
constexpr int32_t kExpBias = 22 * kLn2;
constexpr uint32_t kExpMagic = 3025558;         // ceil(2^36 / LN2)
constexpr int kExpShift = 4;
// the table: one int8 correction a residue, padded to whole 16-byte words
constexpr int kExpTableEntries = 22720;
constexpr int kExpTableWords = kExpTableEntries / 16;
constexpr int kExpTableThreads = 512;
// log2(e) 2^-15: 2^(15 + r kExpLog2eFx) is 2^15 exp(r 2^-15)
constexpr float kExpLog2eFx = 1.4426950408889634f / 32768.0f;
}  // namespace

// round(ln(1 + 2^-k) * 2^15), k = 1..15
__constant__ int32_t kLogTable[15] = {13286, 7312, 3860, 1987, 1008,
                                      508,   255,  128,  64,   32,
                                      16,    8,    4,    2,    1};

// a * b + c as one IMAD
__device__ __forceinline__ int32_t imad(int32_t a, int32_t b, int32_t c) {
  int32_t d;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a >> s for uint32 with PTX's clamp: s >= 32 gives 0
__device__ __forceinline__ uint32_t shr_clamp(uint32_t a, uint32_t s) {
  uint32_t d;
  asm("shr.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(s));
  return d;
}

// (q, r): q = floor(u / LN2) of u = clamp(x) + 22 LN2, r = u - q LN2
__device__ __forceinline__ int32_t exp_reduce(int32_t x, int32_t* r) {
  const int32_t u = min(max(x, -kMaxExpArg), kMaxExpArg) + kExpBias;
  const int32_t q = static_cast<int32_t>(
      __umulhi(static_cast<uint32_t>(u), kExpMagic) >> kExpShift);
  *r = imad(q, -kLn2, u);
  return q;
}

// M 2^n, saturating, for a mantissa m < 2^16 and n = q - 22
__device__ __forceinline__ int32_t exp_scale(uint32_t m, int32_t q) {
  const uint32_t s = shr_clamp(m << 16, static_cast<uint32_t>(38 - q));
  return q >= 38 ? kInt32Max : static_cast<int32_t>(s);
}

// the reference's ladder over r in [0, LN2): the mantissa, and in *r what
// is left of r (0 for every r), without selects
__device__ __forceinline__ int32_t exp_ladder(int32_t* r) {
  int32_t rr = *r, y = kFxOne;
#pragma unroll
  for (int k = 1; k <= 15; ++k) {
    const int32_t lk = kLogTable[k - 1];
    const int32_t take =
        static_cast<int32_t>(static_cast<uint32_t>(lk - 1 - rr) >> 31);
    rr = imad(take, -lk, rr);
    y = imad(y >> k, take, y);
  }
  *r = rr;
  return y;
}

// floor(2^15 exp(r 2^-15)) for r in [0, LN2), from the card's ex2.approx:
// the table stores the mantissa minus this.  The same instructions in
// the table's build and in its lookups give the same bits.
__device__ __forceinline__ int32_t exp_approx(int32_t r) {
  const float t = __fmaf_rn(__int2float_rn(r), kExpLog2eFx, 15.0f);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  return __float2int_rd(e);
}

// table[r] = M[r] - exp_approx(r); with mant, also M[r] itself (uint16,
// the measured alternative below)
__global__ void fx_exp_build_table_kernel(int8_t* __restrict__ table,
                                          uint16_t* __restrict__ mant,
                                          int32_t* __restrict__ bad) {
  const int32_t r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= kExpTableEntries) return;
  int32_t rem = r;
  const int32_t m = r < kLn2 ? exp_ladder(&rem) : 0;
  const int32_t d = r < kLn2 ? m - exp_approx(r) : 0;
  if (r < kLn2 && (rem != 0 || m < kFxOne || m >= 2 * kFxOne || d < -128 ||
                   d > 127)) {
    atomicAdd(bad, 1);
  }
  table[r] = static_cast<int8_t>(d);
  if (mant != nullptr) mant[r] = static_cast<uint16_t>(m);
}

extern "C" int repro_fx_exp_build_table(void* table, void* mant, void* bad,
                                        void* stream) {
  const int threads = 256;
  fx_exp_build_table_kernel<<<(kExpTableEntries + threads - 1) / threads,
                              threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(table), static_cast<uint16_t*>(mant),
      static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ int32_t fx_exp_table_one(int32_t x,
                                                    const int8_t* sm) {
  int32_t r;
  const int32_t q = exp_reduce(x, &r);
  return exp_scale(static_cast<uint32_t>(exp_approx(r) + sm[r]), q);
}

__device__ __forceinline__ int4 fx_exp_table_four(int4 v, const int8_t* sm) {
  v.x = fx_exp_table_one(v.x, sm);
  v.y = fx_exp_table_one(v.y, sm);
  v.z = fx_exp_table_one(v.z, sm);
  v.w = fx_exp_table_one(v.w, sm);
  return v;
}

__global__ void __launch_bounds__(kExpTableThreads)
fx_exp_table_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                    int64_t n, const int8_t* __restrict__ table) {
  __shared__ __align__(16) int8_t sm[kExpTableEntries];
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* y4 = reinterpret_cast<int4*>(y);
  // the first four elements in flight while the table fills; the fill's
  // loads all issue before its stores
  int4 v = make_int4(0, 0, 0, 0);
  if (tid < n4) v = __ldg(x4 + tid);
  constexpr int kFill = (kExpTableWords + kExpTableThreads - 1) /
                        kExpTableThreads;
  const int4* t4 = reinterpret_cast<const int4*>(table);
  int4* s4 = reinterpret_cast<int4*>(sm);
  int4 w[kFill];
#pragma unroll
  for (int k = 0; k < kFill; ++k) {
    const int i = threadIdx.x + k * kExpTableThreads;
    if (i < kExpTableWords) w[k] = __ldg(t4 + i);
  }
#pragma unroll
  for (int k = 0; k < kFill; ++k) {
    const int i = threadIdx.x + k * kExpTableThreads;
    if (i < kExpTableWords) s4[i] = w[k];
  }
  __syncthreads();
  for (int64_t i = tid; i < n4; i += stride) {
    const int64_t j = i + stride;
    const int4 next = j < n4 ? __ldg(x4 + j) : v;
    y4[i] = fx_exp_table_four(v, sm);
    v = next;
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) {
    y[i] = fx_exp_table_one(x[i], sm);
  }
}

extern "C" int repro_fx_exp_table(const void* x, void* y, int64_t n,
                                  const void* table, int max_blocks,
                                  void* stream) {
  const int64_t units = (n + 3) / 4;
  const int64_t need = (units + kExpTableThreads - 1) / kExpTableThreads;
  const int blocks = static_cast<int>(need < max_blocks ? need : max_blocks);
  fx_exp_table_kernel<<<blocks, kExpTableThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(y), n,
      static_cast<const int8_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

// The mantissa table itself, M[r] as uint16 (45,440 bytes padded), in
// shared memory: the design the table route was measured against and is
// kept for (chip_smoke.py's fx_exp_routes line times both).  Every block
// fills its own copy from L2 (fx_exp_mantissa_kernel), or a cluster of
// kMantCluster blocks loads it once, each block one chunk with a bulk
// copy multicast into every block of the cluster
// (fx_exp_mantissa_multicast_kernel).  Same reduction, scale and
// persistent grid as fx_exp_table_kernel.
constexpr int kMantBytes = 2 * kExpTableEntries;
constexpr int kMantCluster = 4;
static_assert(kMantBytes % (16 * kMantCluster) == 0, "bulk copy chunks");

__device__ __forceinline__ int32_t fx_exp_mant_one(int32_t x,
                                                   const uint16_t* sm) {
  int32_t r;
  const int32_t q = exp_reduce(x, &r);
  return exp_scale(sm[r], q);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

template <bool kMulticast>
__device__ __forceinline__ void fx_exp_mantissa_body(
    const int32_t* __restrict__ x, int32_t* __restrict__ y, int64_t n,
    const uint16_t* __restrict__ mant) {
  __shared__ __align__(128) uint16_t sm[kMantBytes / 2];
  __shared__ __align__(8) uint64_t bar;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* y4 = reinterpret_cast<int4*>(y);
  int4 v = make_int4(0, 0, 0, 0);
  if (tid < n4) v = __ldg(x4 + tid);
  if constexpr (kMulticast) {
    cg::cluster_group cluster = cg::this_cluster();
    const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();                 // every block's barrier is ready
    if (threadIdx.x == 0) {
      constexpr uint32_t kChunk = kMantBytes / kMantCluster;
      const uint32_t off = cluster.block_rank() * kChunk;
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(sm)) + off;
      const uint16_t mask = (1u << kMantCluster) - 1;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(static_cast<uint32_t>(kMantBytes))
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
          "l"(reinterpret_cast<const char*>(mant) + off), "r"(kChunk),
          "r"(b), "h"(mask)
          : "memory");
    }
    mbar_wait(b, 0);
  } else {
    constexpr int kWords = kMantBytes / 16;
    constexpr int kFill = (kWords + kExpTableThreads - 1) / kExpTableThreads;
    const int4* t4 = reinterpret_cast<const int4*>(mant);
    int4* s4 = reinterpret_cast<int4*>(sm);
    int4 w[kFill];
#pragma unroll
    for (int k = 0; k < kFill; ++k) {
      const int i = threadIdx.x + k * kExpTableThreads;
      if (i < kWords) w[k] = __ldg(t4 + i);
    }
#pragma unroll
    for (int k = 0; k < kFill; ++k) {
      const int i = threadIdx.x + k * kExpTableThreads;
      if (i < kWords) s4[i] = w[k];
    }
    __syncthreads();
  }
  for (int64_t i = tid; i < n4; i += stride) {
    const int64_t j = i + stride;
    const int4 next = j < n4 ? __ldg(x4 + j) : v;
    v.x = fx_exp_mant_one(v.x, sm);
    v.y = fx_exp_mant_one(v.y, sm);
    v.z = fx_exp_mant_one(v.z, sm);
    v.w = fx_exp_mant_one(v.w, sm);
    y4[i] = v;
    v = next;
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) {
    y[i] = fx_exp_mant_one(x[i], sm);
  }
  // no block leaves while a copy into its cluster may still be landing
  if constexpr (kMulticast) cg::this_cluster().sync();
}

__global__ void __launch_bounds__(kExpTableThreads)
fx_exp_mantissa_kernel(const int32_t* __restrict__ x,
                       int32_t* __restrict__ y, int64_t n,
                       const uint16_t* __restrict__ mant) {
  fx_exp_mantissa_body<false>(x, y, n, mant);
}

__global__ void __cluster_dims__(kMantCluster, 1, 1)
    __launch_bounds__(kExpTableThreads)
fx_exp_mantissa_multicast_kernel(const int32_t* __restrict__ x,
                                 int32_t* __restrict__ y, int64_t n,
                                 const uint16_t* __restrict__ mant) {
  fx_exp_mantissa_body<true>(x, y, n, mant);
}

extern "C" int repro_fx_exp_mantissa(const void* x, void* y, int64_t n,
                                     const void* mant, int multicast,
                                     int max_blocks, void* stream) {
  const int64_t units = (n + 3) / 4;
  const int64_t need = (units + kExpTableThreads - 1) / kExpTableThreads;
  int blocks = static_cast<int>(need < max_blocks ? need : max_blocks);
  const auto* xi = static_cast<const int32_t*>(x);
  auto* yi = static_cast<int32_t*>(y);
  const auto* m = static_cast<const uint16_t*>(mant);
  auto s = static_cast<cudaStream_t>(stream);
  if (multicast) {
    blocks = (blocks + kMantCluster - 1) / kMantCluster * kMantCluster;
    fx_exp_mantissa_multicast_kernel<<<blocks, kExpTableThreads, 0, s>>>(
        xi, yi, n, m);
  } else {
    fx_exp_mantissa_kernel<<<blocks, kExpTableThreads, 0, s>>>(xi, yi, n,
                                                               m);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void fx_exp_ladder_kernel(const int32_t* __restrict__ x,
                                     int32_t* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int32_t r;
    const int32_t q = exp_reduce(x[i], &r);
    y[i] = exp_scale(static_cast<uint32_t>(exp_ladder(&r)), q);
  }
}

extern "C" int repro_fx_exp_ladder(const void* x, void* y, int64_t n,
                                   void* stream) {
  const int threads = 256;
  fx_exp_ladder_kernel<<<grid_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// leading zeros of z != 0 in one FLO (__clz adds a subtraction)
__device__ __forceinline__ int32_t clz(uint32_t z) {
  int32_t d;
  asm("bfind.shiftamt.u32 %0, %1;" : "=r"(d) : "r"(z));
  return d;
}

// 1 / x within 1 ulp, x normal: one MUFU.RCP (__fdividef adds a
// denormal guard)
__device__ __forceinline__ float rcp_approx(float x) {
  float d;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(d) : "f"(x));
  return d;
}

__device__ __forceinline__ int32_t fx_log_one(int32_t x) {
  const uint32_t z0 = static_cast<uint32_t>(max(x, 1));
  const int32_t lead = clz(z0);                 // 31 - msb, in [1, 31]
  const int32_t z = static_cast<int32_t>((z0 << lead) >> 16);
  const int32_t nz1 = -z - 1;                   // w + t + nz1 < 0: take
  int32_t acc = imad(lead, -kLn2, 16 * kLn2);   // e ln 2, e = msb - 15
  int32_t w = kFxOne;
#pragma unroll
  for (int k = 1; k <= 14; ++k) {
    const int32_t t = w >> k;
    const int32_t take =
        static_cast<int32_t>(static_cast<uint32_t>(w + t + nz1) >> 31);
    w = imad(t, take, w);
    acc = imad(kLogTable[k - 1], take, acc);
  }
  const int32_t take = static_cast<int32_t>(                 // t = 1
      static_cast<uint32_t>(w - z) >> 31);
  w += take;
  acc += take;                                  // ln(1 + 2^-15) = 1
  const int32_t r = z - w;                      // [0, 2^15)
  const float w15 = __int2float_rn(w) * (1.0f / kFxOne);   // exact
  int32_t q = __float2int_rz(__int2float_rn(r) * rcp_approx(w15));
  const int32_t rem = imad(q, -w, r << 15);
  q += (rem >= w) - (rem < 0);
  return x <= 0 ? kLogBad : acc + q;
}

__global__ void fx_log_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ y, int64_t n) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* y4 = reinterpret_cast<int4*>(y);
  for (int64_t i = tid; i < n4; i += stride) {
    int4 v = x4[i];
    v.x = fx_log_one(v.x);
    v.y = fx_log_one(v.y);
    v.z = fx_log_one(v.z);
    v.w = fx_log_one(v.w);
    y4[i] = v;
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) {
    y[i] = fx_log_one(x[i]);
  }
}

extern "C" int repro_fx_log(const void* x, void* y, int64_t n, void* stream) {
  const int threads = 256;
  fx_log_kernel<<<grid_for((n + 3) / 4, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
