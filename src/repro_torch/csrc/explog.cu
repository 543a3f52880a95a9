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
// Bound: on the synfire path fx_exp computes one element, the LIF decay
// alpha, so it is bound by launch latency.  On a 1 M-element sample either
// function reads and writes 8 MB (>= 2.5 us at 3.35 TB/s) against 60-80
// integer operations per element.  An SM issues 128 lanes a cycle, half
// to its 64-lane INT32 pipe and half as IMADs to the FMA pipe, so 80
// operations an element take at least 2.5 us too: fx_log's bytes and its
// integer work bound it alike, and only a mix that keeps both pipes busy
// reaches the second.  fx_exp: one thread per element, grid-stride; the
// ladder's table sits in __constant__ memory, where every thread of a warp
// reads the same entry at once (a broadcast).  C++ `/` truncates, so its
// floor divide is written out; the 2^n shift goes through uint32 to
// reproduce the reference's wrap.
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
#include "fixed_point.cuh"

namespace {
constexpr int32_t kFxOne = 1 << 15;
constexpr int32_t kLn2 = 22713;                 // round(ln 2 * 2^15)
constexpr int32_t kMaxExpArg = 15 << 15;
constexpr int32_t kInt32Max = 0x7FFFFFFF;
constexpr int32_t kLogBad = -(1 << 30);         // ln of x <= 0
}  // namespace

// round(ln(1 + 2^-k) * 2^15), k = 1..15
__constant__ int32_t kLogTable[15] = {13286, 7312, 3860, 1987, 1008,
                                      508,   255,  128,  64,   32,
                                      16,    8,    4,    2,    1};

__global__ void fx_exp_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t xi = min(max(x[i], -kMaxExpArg), kMaxExpArg);
    int32_t q = xi / kLn2;                      // truncates toward zero
    if (xi % kLn2 != 0 && xi < 0) q -= 1;       // floor
    int32_t r = xi - q * kLn2;                  // r in [0, ln2)
    int32_t acc = kFxOne;
#pragma unroll
    for (int k = 1; k <= 15; ++k) {
      const int32_t lk = kLogTable[k - 1];
      if (r >= lk) {
        r -= lk;
        acc += acc >> k;
      }
    }
    acc = wrap_add(acc, wrap_mul(acc, r) >> 15);
    const int32_t e = min(max(q, -31), 31);
    int32_t out;
    if (e >= 0) {
      out = e >= 16 ? kInt32Max
                    : static_cast<int32_t>(static_cast<uint32_t>(acc)
                                           << min(e, 15));
    } else {
      out = acc >> min(-e, 31);
    }
    y[i] = out;
  }
}

extern "C" int repro_fx_exp(const void* x, void* y, int64_t n, void* stream) {
  const int threads = 256;
  fx_exp_kernel<<<grid_for(n, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// a * b + c as one IMAD
__device__ __forceinline__ int32_t imad(int32_t a, int32_t b, int32_t c) {
  int32_t d;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
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
