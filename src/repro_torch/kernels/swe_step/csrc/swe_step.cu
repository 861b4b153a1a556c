// Shallow-water element update (Rusanov flux through three edges + the
// explicit update), written by hand for Hopper (sm_90a).
//
// Replaces: repro/kernels/swe_step/swe_step.py::swe_step_pallas (body
// _flux_kernel), the JAX package's Pallas TPU kernel.
//
// What bounds it on this card: device-memory bytes.  Each element slot must
// read 68 B once (own state 12, normals 24, neigh_idx 12, edge_type 12, area
// and valid 8) and write 12 B, plus the neighbour rows it gathers where they
// miss in cache, against about 260 flop: three orders of magnitude below the
// card's f32 rate for the bytes it moves.  At the main path's full shape
// (48 ranks x 5,644 slots, 21.8 MB) the bound is ~6.5 us.  Timed alone
// behind a cache flush it sits well above that (the launch, and reads that
// queue behind the flush's write-back); in the main path its ~22 MB of
// inputs are found in the 50 MB L2, and what remains is latency: about one
// wave of warps, each waiting on its tile's copy, then on its neighbours.
//
// The full pass (no row list):
// - flat tiles of 32 slots, one per lane, over the stacked P * E slots:
//   every tile starts on a 16-byte boundary of every per-slot array
//   whatever E is (12-byte rows, 4 slots = 48 bytes); a tile may straddle
//   two ranks, and each lane finds its rank with one 32-bit division;
// - each warp walks its tiles on its own, persistent (as many blocks as fit
//   on the card): its lanes copy the tile's six contiguous arrays into the
//   warp's shared-memory buffer with 16-byte cp.async (136 coalesced copies
//   a tile instead of 17 strided 4-byte loads a slot; Hopper's bulk copies
//   were no faster from DRAM and slower from L2), and the warp starts as
//   soon as its own tile has landed (no block-wide barrier);
// - lanes read their slot from shared memory, neighbour and halo rows
//   through the read-only path (edges of type 1, land, and 2, sea, read
//   none; neigh_idx is in hand before the edge type is looked at, so no
//   load waits on another);
// - outputs go to shared memory and leave as 24 coalesced 16-byte stores.
// The ragged last tile, and launches whose arrays are not 16-byte aligned
// (a view at an odd offset), take the per-thread path.
//
// The row-list pass (the overlapped schedule's boundary rows, scattered):
// one thread per listed row on a (row blocks, P) grid, the rank on
// blockIdx.y, loading its own record and neighbours directly.  Duplicate
// rows write identical values.
//
// Every path inlines one function for the arithmetic, element_update, with
// every rounding written out, so the schedules stay bitwise equal; it is
// within 1e-5 of ref.swe_step_ref.  h_sea is read from a device pointer, so
// a CUDA graph that captures the launch follows the tide.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;               // slots per tile: one per lane
constexpr int kRowThreads = 128;
// A buffer holds a tile's record, in 32-bit words per slot: state 3,
// normals 6, neigh_idx 3, edge_type 3, area 1, valid 1 (the 68 bytes
// copied), then the 3 output words.
constexpr int kNrm = 3 * kTile, kIdx = 9 * kTile, kEt = 12 * kTile,
              kArea = 15 * kTile, kValid = 16 * kTile, kOut = 17 * kTile;
constexpr int kBufWords = 20 * kTile;

constexpr float kG = 9.81f;
constexpr float kHalfG = 0.5f * 9.81f;

struct Args {
  const float* state;
  const float* halo;
  const float* normals;
  const int* neigh_idx;
  const int* edge_type;
  const float* area;
  const float* valid;
  const float* h_sea;
  float* out;
  int E, H;
  float dt;
};

// One slot's inputs.
struct Slot {
  float u[3], n[6], area, valid;
  int et[3], k[3];
};

// max that propagates NaN, as jnp.maximum and torch.clamp do (fmaxf would
// return the other operand and hide a blown-up state)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

template <bool kGlobal, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kGlobal) return __ldg(p);
  else return *p;
}

// slot i of per-slot arrays that start at the given pointers (device
// memory, or a tile's buffer in shared memory)
template <bool kGlobal>
__device__ __forceinline__ Slot load_slot(const float* st, const float* nrm,
                                          const int* nidx, const int* et,
                                          const float* area,
                                          const float* valid, int i) {
  Slot s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.u[c] = ld<kGlobal>(st + 3 * (size_t)i + c);
    s.et[c] = ld<kGlobal>(et + 3 * (size_t)i + c);
    s.k[c] = ld<kGlobal>(nidx + 3 * (size_t)i + c);
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) s.n[c] = ld<kGlobal>(nrm + 6 * (size_t)i + c);
  s.area = ld<kGlobal>(area + i);
  s.valid = ld<kGlobal>(valid + i);
  return s;
}

// The neighbour rows ([state | halo][k] of rank p) of the edges that read
// one; zeros for land and sea edges.
__device__ __forceinline__ void fetch_neighbours(const Args& a, const Slot& s,
                                                 int p, float (&nb)[3][3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    nb[j][0] = nb[j][1] = nb[j][2] = 0.f;
    if (s.et[j] == 1 || s.et[j] == 2) continue;
    const int k = s.k[j];
    const float* row = k < a.E ? a.state + 3 * ((size_t)p * a.E + k)
                               : a.halo + 3 * ((size_t)p * a.H + (k - a.E));
#pragma unroll
    for (int c = 0; c < 3; ++c) nb[j][c] = __ldg(row + c);
  }
}

// The arithmetic of every path: dg_solver.rusanov, physical_flux and
// reflect, and ref.element_update, with the divisions hoisted: one IEEE
// reciprocal of h_l a slot and of |n| and h_r an edge, each quotient a
// product with it (within an ulp or two of the plain version's quotient;
// the plain version's 19 divisions a slot take the IEEE slow path whenever
// the dividend is 0, which is every momentum of water at rest).  Every
// rounding is written out (__fmul_rn and __fadd_rn are never contracted,
// __fmaf_rn is one fused rounding), so every call site computes
// bit-identical values whatever the compiler schedules around it.
__device__ __forceinline__ void element_update(const Slot& s,
                                               const float (&nb)[3][3],
                                               float hsea, float dt,
                                               float (&o)[3]) {
  const float u0 = s.u[0], u1 = s.u[1], u2 = s.u[2];
  const float h_l = max_nan(u0, 1e-8f);
  const float inv_hl = __frcp_rn(h_l);
  const float c_l = __fsqrt_rn(__fmul_rn(kG, h_l));
  const float p_l = __fmul_rn(__fmul_rn(kHalfG, h_l), h_l);
  float d0 = 0.f, d1 = 0.f, d2 = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float nx = s.n[2 * j], ny = s.n[2 * j + 1];
    const float nlen =
        max_nan(__fsqrt_rn(__fmaf_rn(nx, nx, __fmul_rn(ny, ny))), 1e-12f);
    const float inv_n = __frcp_rn(nlen);
    const float nhx = __fmul_rn(nx, inv_n);
    const float nhy = __fmul_rn(ny, inv_n);
    const float qn_l = __fmaf_rn(u1, nhx, __fmul_rn(u2, nhy));

    // ghost state: reflective land, prescribed sea level, else neighbour
    float r0, r1, r2;
    if (s.et[j] == 1) {
      const float q2 = __fmul_rn(-2.f, qn_l);
      r0 = u0;
      r1 = __fmaf_rn(q2, nhx, u1);
      r2 = __fmaf_rn(q2, nhy, u2);
    } else if (s.et[j] == 2) {
      r0 = hsea;
      r1 = u1;
      r2 = u2;
    } else {
      r0 = nb[j][0];
      r1 = nb[j][1];
      r2 = nb[j][2];
    }

    const float h_r = max_nan(r0, 1e-8f);
    const float inv_hr = __frcp_rn(h_r);
    const float un_l = __fmul_rn(qn_l, inv_hl);
    const float un_r = __fmul_rn(__fmaf_rn(r1, nhx, __fmul_rn(r2, nhy)),
                                 inv_hr);
    const float lam = max_nan(__fadd_rn(fabsf(un_l), c_l),
                              __fadd_rn(fabsf(un_r),
                                        __fsqrt_rn(__fmul_rn(kG, h_r))));

    // physical fluxes along the scaled normal, then
    // 0.5 * (f(u_l) + f(u_r) - lam * |n| * (u_r - u_l))
    const float s_l = __fmul_rn(__fmaf_rn(u1, nx, __fmul_rn(u2, ny)), inv_hl);
    const float s_r = __fmul_rn(__fmaf_rn(r1, nx, __fmul_rn(r2, ny)), inv_hr);
    const float p_r = __fmul_rn(__fmul_rn(kHalfG, h_r), h_r);
    const float mc = -__fmul_rn(lam, nlen);
    const float f0 = __fmul_rn(
        0.5f, __fmaf_rn(mc, __fsub_rn(r0, u0),
                        __fmaf_rn(h_l, s_l, __fmul_rn(h_r, s_r))));
    const float f1 = __fmul_rn(
        0.5f, __fmaf_rn(mc, __fsub_rn(r1, u1),
                        __fmaf_rn(u1, s_l, __fmaf_rn(p_l, nx, __fmaf_rn(
                            r1, s_r, __fmul_rn(p_r, nx))))));
    const float f2 = __fmul_rn(
        0.5f, __fmaf_rn(mc, __fsub_rn(r2, u2),
                        __fmaf_rn(u2, s_l, __fmaf_rn(p_l, ny, __fmaf_rn(
                            r2, s_r, __fmul_rn(p_r, ny))))));
    d0 = j == 0 ? f0 : __fadd_rn(d0, f0);
    d1 = j == 0 ? f1 : __fadd_rn(d1, f1);
    d2 = j == 0 ? f2 : __fadd_rn(d2, f2);
  }

  // dt / area: one IEEE division a slot, dividend and divisor both normal
  const float v = s.valid;
  const float mk = -__fdiv_rn(dt, max_nan(s.area, 1e-12f));
  o[0] = __fmul_rn(max_nan(__fmul_rn(__fmaf_rn(mk, d0, u0), v), 1e-6f), v);
  o[1] = __fmul_rn(__fmaf_rn(mk, d1, u1), v);
  o[2] = __fmul_rn(__fmaf_rn(mk, d2, u2), v);
}

// Slot g (rank p) straight from device memory: the row-list pass, the
// ragged last tile and unaligned launches.
__device__ __forceinline__ void update_from_global(const Args& a, int p,
                                                   int g, float hsea) {
  const Slot s = load_slot<true>(a.state, a.normals, a.neigh_idx,
                                 a.edge_type, a.area, a.valid, g);
  float nb[3][3], o[3];
  fetch_neighbours(a, s, p, nb);
  element_update(s, nb, hsea, a.dt, o);
#pragma unroll
  for (int c = 0; c < 3; ++c) a.out[3 * (size_t)g + c] = o[c];
}

// every lane: copy its share of tile `tile`'s six arrays into `buf`, 16
// bytes at a time, and commit them as one group
__device__ __forceinline__ void copy_tile(const Args& a, int tile, float* buf,
                                          int lane) {
  const size_t base = (size_t)tile * kTile;
  const float* src[6] = {a.state + 3 * base, a.normals + 6 * base,
                         reinterpret_cast<const float*>(a.neigh_idx) + 3 * base,
                         reinterpret_cast<const float*>(a.edge_type) + 3 * base,
                         a.area + base, a.valid + base};
  const int off[6] = {0, kNrm, kIdx, kEt, kArea, kValid};
  const int words[6] = {3 * kTile, 6 * kTile, 3 * kTile, 3 * kTile, kTile,
                        kTile};
#pragma unroll
  for (int k = 0; k < 6; ++k)
    for (int c = 4 * lane; c < words[k]; c += 4 * 32)
      cp_async::copy16(cp_async::smem_u32(buf + off[k] + c), src[k] + c);
  cp_async::commit_group();
}

__global__ void __launch_bounds__(kThreads)
    swe_full_kernel(Args a, int total, int n_tiles, int staged) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = smem + warp * kBufWords;
  const int first = blockIdx.x * kWarps + warp;   // this warp's first tile
  const int stride = gridDim.x * kWarps;
  const int n_full = total / kTile;   // tiles wholly inside the slots
  const float hsea = __ldg(a.h_sea);

  if (staged && first < n_full) copy_tile(a, first, buf, lane);
  for (int tile = first; tile < n_tiles; tile += stride) {
    const int base = tile * kTile;
    const int g = base + lane;
    if (!(staged && tile < n_full)) {
      if (g < total) update_from_global(a, g / a.E, g, hsea);
      continue;
    }
    cp_async::wait_group<0>();   // this lane's share of the tile has landed,
    __syncwarp();                // and every other lane's
    const Slot sl = load_slot<false>(
        buf, buf + kNrm, reinterpret_cast<const int*>(buf + kIdx),
        reinterpret_cast<const int*>(buf + kEt), buf + kArea, buf + kValid,
        lane);
    float nb[3][3], o[3];
    fetch_neighbours(a, sl, g / a.E, nb);
    element_update(sl, nb, hsea, a.dt, o);
    float* out = buf + kOut;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * lane + c] = o[c];
    __syncwarp();
    if (lane < 3 * kTile / 4)
      reinterpret_cast<float4*>(a.out + 3 * (size_t)base)[lane] =
          reinterpret_cast<const float4*>(out)[lane];
    __syncwarp();   // every lane is done with the buffer
    if (tile + stride < n_full) copy_tile(a, tile + stride, buf, lane);
  }
}

__global__ void __launch_bounds__(kRowThreads)
    swe_rows_kernel(Args a, const int* __restrict__ rows, int n) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= n) return;
  update_from_global(a, p, p * a.E + __ldg(rows + p * n + i), __ldg(a.h_sea));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Persistent grid of the full pass: as many blocks as fit on the current
// device at once.  Worked out at a device's first launch and kept, so later
// launches (every step of the host-scheduled mode) query nothing more than
// the current device.
cudaError_t persistent_blocks(bool staged, int smem, int* cap) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> caps[kMaxDevices][2];   // 0: not worked out yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* slot =
      dev >= 0 && dev < kMaxDevices ? &caps[dev][staged] : nullptr;
  if (slot != nullptr && (*cap = slot->load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, swe_full_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  *cap = sms * (per_sm > 0 ? per_sm : 1);
  if (slot != nullptr) slot->store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `rows` may be null (update every
// element); otherwise it is (P, n_rows) and only those rows of `out` are
// written.  Launches on `stream` and returns a cudaError_t:
// cudaErrorInvalidValue where the slot counts overflow 32-bit indices.
extern "C" int swe_step_launch(const void* state, const void* halo,
                               const void* normals, const void* neigh_idx,
                               const void* edge_type, const void* area,
                               const void* valid, const void* h_sea,
                               const void* rows, void* out, int P, int E,
                               int H, int n, float dt, void* stream) {
  if (P <= 0 || n <= 0) return cudaSuccess;
  if ((long long)P * E > INT_MAX - kTile || (long long)P * H > INT_MAX ||
      (long long)P * n > INT_MAX || (long long)E + H > INT_MAX)
    return cudaErrorInvalidValue;
  const Args a{(const float*)state, (const float*)halo, (const float*)normals,
               (const int*)neigh_idx, (const int*)edge_type,
               (const float*)area, (const float*)valid, (const float*)h_sea,
               (float*)out, E, H, dt};
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows != nullptr) {
    if (P > 65535) return cudaErrorInvalidValue;
    const dim3 grid((n + kRowThreads - 1) / kRowThreads, P);
    swe_rows_kernel<<<grid, kRowThreads, 0, st>>>(a, (const int*)rows, n);
    return (int)cudaGetLastError();
  }
  const int total = P * E;
  const int n_tiles = (total + kTile - 1) / kTile;
  const int blocks = (n_tiles + kWarps - 1) / kWarps;
  const bool staged = aligned16(state) && aligned16(normals) &&
                      aligned16(neigh_idx) && aligned16(edge_type) &&
                      aligned16(area) && aligned16(valid) && aligned16(out);
  // the per-thread path needs no shared memory
  const int smem = staged ? kWarps * kBufWords * 4 : 0;
  int cap = 0;
  const cudaError_t err = persistent_blocks(staged, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  swe_full_kernel<<<blocks < cap ? blocks : cap, kThreads, smem, st>>>(
      a, total, n_tiles, staged ? 1 : 0);
  return (int)cudaGetLastError();
}
