// dp4a in its four PTX signedness forms: four 8-bit products summed into an
// int32 accumulator in one instruction, each operand read as s8 or u8.
// Shared by the MAC-array kernels (mac_gemm.cu, mac_conv.cu) so that every
// int8/uint8 pairing of their operands is exact; the sum wraps as the
// reference's int32 accumulation does.
#pragma once
#include <cstdint>

template <bool AS, bool BS>
__device__ __forceinline__ int32_t dp4a(uint32_t a, uint32_t b, int32_t c) {
  int32_t d;
  if constexpr (AS && BS) {
    asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else if constexpr (AS) {
    asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else if constexpr (BS) {
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else {
    asm("dp4a.u32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  }
  return d;
}
