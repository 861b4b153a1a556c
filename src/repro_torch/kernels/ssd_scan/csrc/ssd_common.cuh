// What the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// kernels share: their tile limits, the decay below which expf is 0, the
// three-term bf16 split of an f32 operand, and the mma.sync m16n8k16 bf16
// product with f32 accumulation.  Each library includes it once.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int MAX_L = 128;  // chunk rows
constexpr int MAX_N = 128;  // state size
constexpr int MAX_P = 64;   // head dim
// expf(x) is exactly 0 below this (e^-110 is far under f32's least
// denormal): a block of products whose decays all lie below it adds 0
constexpr float EXP_ZERO = -110.f;
constexpr unsigned FULL = 0xffffffffu;

// v as TT bf16 terms of decreasing size, each the rounded remainder of the
// ones before (the remainders are exact in f32); three rebuild an f32 to
// ~2^-24, one is exact for a value that came from bf16
template <int TT>
__device__ __forceinline__ void split(float v, __nv_bfloat16 (&t)[TT]) {
  float r = v;
#pragma unroll
  for (int k = 0; k < TT; ++k) {
    t[k] = __float2bfloat16_rn(r);
    r = __fsub_rn(r, __bfloat162float(t[k]));
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
