// Per-block symmetric int8 quantization of the compression plugin's wire
// format, and its inverse, written by hand for Hopper (sm_90a).
//
// Replaces: repro/kernels/quant/quant.py::quantize_pallas (body
// _quant_kernel) and ::dequantize_pallas (body _dequant_kernel), the JAX
// package's Pallas TPU kernels, and the plain wire encode of
// repro/core/plugins.py::quantize_int8 / dequantize_int8.
//
// Layout (stacked ranks): x (P, n) read through two strides, f32 or bf16;
// codes q (P, nb, block) int8 and scales s (P, nb) f32 with
// nb = ceil(n / block).  Blocks never cross ranks, and the tail of a rank's
// last block is read as zero without a padded copy of x.
//
// What bounds them on this card: device-memory bytes.  Quantize reads 4 B
// (f32) and writes 1 B per element plus 4 B per block, against ~4 flop per
// element; dequantize moves the same bytes the other way.
//
// What the design does about it:
// - quantize: one warp per block, each lane striding the block, so the
//   loads of a warp cover consecutive addresses; a warp-shuffle max of |x|,
//   then the codes from a second pass over the same block (served by the
//   cache the first pass filled);
// - dequantize: four consecutive elements per thread, consecutive threads
//   on consecutive elements;
// - where the layout is aligned (unit inner stride, lengths and strides
//   multiples of 4) both move 4 elements per load and store: 16-byte f32
//   (8-byte bf16) accesses and 4-byte code accesses; anything else takes a
//   scalar path with the same arithmetic;
// - both launch on the caller's stream and allocate nothing, so a CUDA
//   graph can capture them.
//
// Numerics, held bitwise to the JAX package's plain version:
// - scale = amax / 127 and x / scale are IEEE divisions (__fdiv_rn); the
//   build has no --use_fast_math;
// - codes round half to even (rintf), as jnp.round and torch.round do;
// - the max propagates NaN, as jnp.max does, so a block holding a NaN gets
//   the scale JAX gives it (amax > 0 is false: 1.0) and not the scale of
//   its finite values; its codes are implementation-defined on both sides;
// - bf16 is widened to f32 before abs and max, and dequantize rounds the
//   f32 product to bf16 to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements, 16 B (f32) or 8 B (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  m = max_nan(m, fabsf(v.x));
  m = max_nan(m, fabsf(v.y));
  m = max_nan(m, fabsf(v.z));
  return max_nan(m, fabsf(v.w));
}

__device__ __forceinline__ signed char code(float v, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
  return (signed char)(int)r;
}

// One warp per quant block of `block` elements of rank p.  vec: x has unit
// inner stride, n, block and the row stride are multiples of 4 and the base
// is aligned, so each lane moves 4 elements at a time.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, long long sx0,
                                long long sx1, signed char* __restrict__ q,
                                float* __restrict__ s, int n, int block,
                                int nb, long long n_warps, bool vec) {
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;          // whole warps exit together
  const long long p = warp / nb;
  const int first = (int)(warp - p * nb) * block;   // element within rank
  const T* xr = x + p * sx0;
  signed char* qb = q + warp * (long long)block;

  float amax = 0.0f;
  if (vec) {
    for (int i = 4 * lane; i < block; i += 128)
      if (first + i < n) amax = abs_max4(amax, load4(xr + first + i));
  } else {
    for (int i = lane; i < block; i += 32) {
      const int j = first + i;
      amax = max_nan(amax, fabsf(j < n ? to_f32(xr[j * sx1]) : 0.0f));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;

  if (vec) {
    for (int i = 4 * lane; i < block; i += 128) {
      const float4 v = first + i < n ? load4(xr + first + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      char4 c;
      c.x = code(v.x, scale);
      c.y = code(v.y, scale);
      c.z = code(v.z, scale);
      c.w = code(v.w, scale);
      *reinterpret_cast<char4*>(qb + i) = c;
    }
  } else {
    for (int i = lane; i < block; i += 32) {
      const int j = first + i;
      qb[i] = code(j < n ? to_f32(xr[j * sx1]) : 0.0f, scale);
    }
  }
  if (lane == 0) s[warp] = scale;
}

// Four consecutive elements of rank blockIdx.y per thread.  vec: n and
// block are multiples of 4, so the four share a quant block and move as
// one 4-byte code load and one 16-byte (f32) or 8-byte (bf16) store.
template <typename T>
__global__ void dequantize_kernel(const signed char* __restrict__ q,
                                  const float* __restrict__ s,
                                  T* __restrict__ out, int n, int block,
                                  int nb, bool vec) {
  // 64-bit: the grid covers up to n + 4 * kThreads - 1 elements, which
  // would wrap a 32-bit index for n near INT_MAX.
  const long long j = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (j >= n) return;
  const long long p = blockIdx.y;
  const signed char* qr = q + p * nb * (long long)block;
  const float* sr = s + p * nb;
  T* outr = out + p * n;
  if (vec) {
    const char4 c = *reinterpret_cast<const char4*>(qr + j);
    const float sc = sr[j / block];
    store4(outr + j, make_float4(__fmul_rn((float)c.x, sc),
                                 __fmul_rn((float)c.y, sc),
                                 __fmul_rn((float)c.z, sc),
                                 __fmul_rn((float)c.w, sc)));
  } else {
    for (long long k = j; k < j + 4 && k < n; ++k)
      store(outr + k, __fmul_rn((float)qr[k], sr[k / block]));
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// x_is_bf16: 0 for float32 input, 1 for bfloat16.  Returns the CUDA error
// of the launch (0 on success).
int quantize_launch(const void* x, int x_is_bf16, long long sx0,
                    long long sx1, signed char* q, float* s, long long P,
                    int n, int block, int nb, int vec, cudaStream_t stream) {
  const long long n_warps = P * nb;
  if (n_warps == 0) return 0;
  const unsigned grid = (unsigned)((n_warps * 32 + kThreads - 1) / kThreads);
  if (x_is_bf16)
    quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), sx0, sx1, q, s, n, block, nb,
        n_warps, vec != 0);
  else
    quantize_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), sx0, sx1, q, s, n, block, nb, n_warps,
        vec != 0);
  return (int)cudaGetLastError();
}

// out_is_bf16: 0 for a float32 output, 1 for bfloat16.  `out` is a
// contiguous (P, n) buffer; P is at most 65535 (the grid's y extent).
int dequantize_launch(const signed char* q, const float* s, void* out,
                      int out_is_bf16, int P, int n, int block, int nb,
                      int vec, cudaStream_t stream) {
  if ((long long)P * n == 0) return 0;
  const dim3 grid((unsigned)(((long long)n + 4 * kThreads - 1) /
                             (4 * kThreads)),
                  (unsigned)P);
  if (out_is_bf16)
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        q, s, static_cast<__nv_bfloat16*>(out), n, block, nb, vec != 0);
  else
    dequantize_kernel<float><<<grid, kThreads, 0, stream>>>(
        q, s, static_cast<float*>(out), n, block, nb, vec != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
