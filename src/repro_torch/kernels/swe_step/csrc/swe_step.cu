// Shallow-water element update (Rusanov flux through three edges + the
// explicit update), written by hand for Hopper (sm_90a).
//
// Replaces: repro/kernels/swe_step/swe_step.py::swe_step_pallas (body
// _flux_kernel), the JAX package's Pallas TPU kernel.
//
// What bounds it on this card: device-memory bytes.  Each element slot must
// read about 68 B once (own state 12, normals 24, neigh_idx 12, edge_type
// 12, area and valid 8) and write 12 B, plus up to 36 B of neighbour rows
// where they miss in cache, against about 260 flop: three orders of
// magnitude below the card's f32 rate for the bytes it moves.
//
// What the design does about it:
// - one thread per (rank, element) slot of the stacked (P, E) state, so
//   every byte is loaded once into registers and used from there;
// - the neighbour gather [state | halo][neigh_idx] is fused into the kernel
//   (the Pallas version leaves it to XLA), so the gathered (E, 3, 3)
//   neighbour array never travels through device memory; edges of type 1
//   (land) and 2 (sea) read no neighbour at all;
// - h_sea is read from a device pointer, so a CUDA graph that captures the
//   launch keeps following the tide instead of freezing the value;
// - an optional row list (P, n_rows) restricts the update to those rows and
//   writes them over an earlier result: the overlapped schedule's boundary
//   pass runs the same instructions as the full pass, which keeps all
//   schedules bitwise-equal.  Duplicate rows write identical values.
// No atomics, no shared memory: the gather is irregular and every output
// row has exactly one writer.

#include <cuda_runtime.h>

namespace {

constexpr float kG = 9.81f;
constexpr float kHalfG = 0.5f * 9.81f;

// max that propagates NaN, as jnp.maximum and torch.clamp do (fmaxf would
// return the other operand and hide a blown-up state)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__global__ void swe_step_kernel(const float* __restrict__ state,
                                const float* __restrict__ halo,
                                const float* __restrict__ normals,
                                const int* __restrict__ neigh_idx,
                                const int* __restrict__ edge_type,
                                const float* __restrict__ area,
                                const float* __restrict__ valid,
                                const float* __restrict__ h_sea,
                                const int* __restrict__ rows,
                                float* __restrict__ out,
                                int P, int E, int H, int n, float dt) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (tid >= (long long)P * n) return;
  const int p = (int)(tid / n);
  const int e = rows != nullptr ? rows[tid] : (int)(tid - (long long)p * n);
  const float* st = state + (size_t)p * E * 3;
  const float* hl = halo + (size_t)p * H * 3;
  const size_t slot = (size_t)p * E + e;

  const float u0 = st[(size_t)e * 3 + 0];
  const float u1 = st[(size_t)e * 3 + 1];
  const float u2 = st[(size_t)e * 3 + 2];
  const float hsea = *h_sea;
  const float h_l = max_nan(u0, 1e-8f);
  const float c_l = sqrtf(kG * h_l);
  float d0 = 0.f, d1 = 0.f, d2 = 0.f;

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float nx = normals[slot * 6 + 2 * j];
    const float ny = normals[slot * 6 + 2 * j + 1];
    const int et = edge_type[slot * 3 + j];
    const float nlen = max_nan(sqrtf(nx * nx + ny * ny), 1e-12f);
    const float nhx = nx / nlen;
    const float nhy = ny / nlen;
    const float qn_l = u1 * nhx + u2 * nhy;

    // ghost state: reflective land, prescribed sea level, else neighbour
    float r0, r1, r2;
    if (et == 1) {
      r0 = u0;
      r1 = u1 - 2.f * qn_l * nhx;
      r2 = u2 - 2.f * qn_l * nhy;
    } else if (et == 2) {
      r0 = hsea;
      r1 = u1;
      r2 = u2;
    } else {
      const int k = neigh_idx[slot * 3 + j];
      const float* src = k < E ? st + (size_t)k * 3 : hl + (size_t)(k - E) * 3;
      r0 = src[0];
      r1 = src[1];
      r2 = src[2];
    }

    const float h_r = max_nan(r0, 1e-8f);
    const float un_l = qn_l / h_l;
    const float un_r = (r1 * nhx + r2 * nhy) / h_r;
    const float lam = max_nan(fabsf(un_l) + c_l, fabsf(un_r) + sqrtf(kG * h_r));

    // physical fluxes along the scaled normal
    const float s_l = (u1 * nx + u2 * ny) / h_l;
    const float s_r = (r1 * nx + r2 * ny) / h_r;
    const float p_l = kHalfG * h_l * h_l;
    const float p_r = kHalfG * h_r * h_r;
    const float c = lam * nlen;
    d0 += 0.5f * (h_l * s_l + h_r * s_r - c * (r0 - u0));
    d1 += 0.5f * ((u1 * s_l + p_l * nx) + (r1 * s_r + p_r * nx) - c * (r1 - u1));
    d2 += 0.5f * ((u2 * s_l + p_l * ny) + (r2 * s_r + p_r * ny) - c * (r2 - u2));
  }

  const float v = valid[slot];
  const float k = dt / max_nan(area[slot], 1e-12f);
  float* o = out + slot * 3;
  o[0] = max_nan((u0 - k * d0) * v, 1e-6f) * v;
  o[1] = (u1 - k * d1) * v;
  o[2] = (u2 - k * d2) * v;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `rows` may be null (update every
// element); otherwise it is (P, n_rows) and only those rows of `out` are
// written.  Launches on `stream` and returns cudaGetLastError().
extern "C" int swe_step_launch(const void* state, const void* halo,
                               const void* normals, const void* neigh_idx,
                               const void* edge_type, const void* area,
                               const void* valid, const void* h_sea,
                               const void* rows, void* out, int P, int E,
                               int H, int n, float dt, void* stream) {
  const long long total = (long long)P * n;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  swe_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)state, (const float*)halo, (const float*)normals,
      (const int*)neigh_idx, (const int*)edge_type, (const float*)area,
      (const float*)valid, (const float*)h_sea, (const int*)rows,
      (float*)out, P, E, H, n, dt);
  return (int)cudaGetLastError();
}
