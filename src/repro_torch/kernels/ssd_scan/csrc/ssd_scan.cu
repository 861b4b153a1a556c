// Mamba2 SSD chunked scan (state-space duality, forward), written by hand
// for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (body
// _kernel), the JAX package's Pallas TPU kernel, with its layout wrapper
// repro/kernels/ssd_scan/ops.py::ssd_chunked; it computes what
// repro/models/ssm.py::ssd_chunked_ref computes.
//
// Layout, the model's, read in place through strides (unit inner stride):
// x (R, Bt, S, H, P) f32 or bf16; dt (R, Bt, S, H) f32 (post-softplus);
// A (R, H) f32 (negative); B and C (R, Bt, S, G, N) in x's dtype.  R is the
// stacked tensor-parallel ranks.  Head h reads B/C group h / (H / G): the
// per-head broadcast copies of the JAX wrapper are never made.  Outputs,
// contiguous: y (R, Bt, S, H, P) f32 (the model's reference keeps y in f32;
// the Pallas kernel rounds it to x's dtype) and the final state
// h_final (R, Bt, H, N, P) f32.
//
// Per chunk c of L rows, with cum the running sum of dt * A over the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . h_{c-1}
//   S_c   = sum_j B_j^T exp(cum_{L-1} - cum_j) dt_j x_j
//   h_c   = exp(cum_{L-1}) h_{c-1} + S_c
// The exponent of the decay is only formed for j <= i, where it is <= 0 (dt
// > 0, A < 0): future entries, whose exp would overflow, are never
// evaluated, and they contribute exactly 0, as the reference's
// exp(where(mask, diff, -inf)) makes them for finite inputs.  The running
// sum cum is taken in row order in f32, a rounded product then a rounded
// sum (no FMA contraction), as the plain version's product and cumsum
// compute it: exp(cum_i - cum_j) reads the differences of nearby rows at
// |cum| ~ 1e3, and a tree-shaped scan rounds them apart (it doubled the
// error against float64).
//
// What bounds it on this card: bytes.  At the serving shape (R 4, Bt 8, H 6,
// S 2048, P 64, N 128, chunk 128, bf16) it must move ~192 MB (x 50 MB, y in
// f32 101 MB, B and C 17 MB each, h_final 6 MB): ~57 us at 3.35 TB/s,
// against ~17 GFLOP of products, which take ~17 us on the tensor cores but
// ~260 us on fp32 FMA.  The first version (one block per (rank, batch,
// head) walking the 16 chunks in order, fp32 FMA, one block per SM) took
// 3.8 ms on an H100.
//
// What the design does about it: the chunk-parallel form, three kernels
// per call (one ssd_scan_launch), every product on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulation):
// 1. ssd_states_kernel, one block per (rank, batch, chunk, group): B is
//    staged once for the group's heads; one thread per head takes the
//    chunk's cum (sequential) while the other warps stage B, and keeps it
//    in a scratch (R, Bt, H, S) f32 for pass 3; per head, S_c = B^T (w . x),
//    w_j = exp(cum_{L-1} - cum_j) dt_j, into a scratch (R, Bt, H, nc, N, P)
//    f32, the next head's x loaded while this head's products run;
// 2. ssd_handoff_kernel, one thread per (rank, batch, head, 4 state
//    elements): h_c = exp(cum_{L-1}) h_{c-1} + S_c over the chunks in
//    order, the same rounded product and sum as the plain version, every
//    chunk's S_c loaded before the chain runs; it overwrites the scratch
//    with each chunk's incoming state h_{c-1} and writes h_final;
// 3. ssd_outputs_kernel, one block per (rank, batch, chunk, group): C . B^T
//    (L x L over N) once, kept in registers, then for each head of the
//    group y = ((C . B^T) o exp(cum_i - cum_j) dt_j)_{j <= i} . x
//    + exp(cum_i) (C . h_{c-1}); C . B^T is computed once per group, not
//    once per head (6 heads share it at the serving shape), and W is built
//    in registers as the A operand of W . x; a head's bf16 x is copied by
//    cp.async while its incoming state is loaded and split.
// Exactness: with bf16 x, B and C (the model's), every product has one
// exactly-bf16 operand; the other, f32, is split into three bf16 terms
// hi + mid + lo (each the rounded remainder of the last), which rebuild it
// to ~2^-24, and the three products accumulate in f32: an f32-grade
// result.  C . B^T is exact per product.  With f32 inputs both operands
// are split, and the six products of terms of order <= 2 are taken.
// Products that are exactly 0 are skipped: a 16 x 16 block of W, a row
// block's inter-chunk term or a 16-row block of the state product whose
// decays are all below EXP_ZERO (expf is 0 there; with a finite state the
// skipped term is exactly 0).  How much this saves depends on the data:
// steep decays (large |A| dt) skip most of a chunk's triangle.
// Tiles are 16 x 16, so L, N and P are zero-padded to multiples of 16 in
// shared memory, where rows are padded by 16 bytes (ldmatrix reads 8 rows
// from distinct banks); x, B, C and the states are loaded 16 bytes at a
// time (ops.py pads N and P to multiples of 8 and aligns every row).
// Passes 1 and 3 take ~100 and ~108 KB of shared memory (bf16), so two
// blocks of 8 warps share an SM; there are R Bt nc G = 512 blocks each at
// the serving shape, and R Bt H N P / 4 = 393,216 threads in pass 2.
// They launch on the caller's stream and allocate nothing: the wrapper
// allocates the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int LDN = MAX_N + 8;  // bf16 per padded smem row of B or C
constexpr int LDP = MAX_P + 8;  // bf16 per padded smem row of x, w.x, h

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* hout;
  float* states;  // (R, Bt, H, nc, N, P) scratch
  float* cum;     // (R, Bt, H, S) scratch
  int R, Bt, S, H, P, G, N, L, nc;
  int Lp, Np, Pp;  // L, N, P padded to multiples of 16
  long long xs0, xs1, xs2, xs3;
  long long ds0, ds1, ds2, ds3;
  long long as0, as1;
  long long bs0, bs1, bs2, bs3;
  long long cs0, cs1, cs2, cs3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// (d0 | d1) += A . B for A of TA terms and a B fragment pair (two n-tiles:
// regs 0-1 and 2-3) of TB terms: the products of terms of order <= 2,
// smallest first
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float (&d0)[4], float (&d1)[4],
                                          const uint32_t (&a)[TA][4],
                                          const uint32_t (&b)[TB][4]) {
#pragma unroll
  for (int order = 2; order >= 0; --order)
#pragma unroll
    for (int ia = 0; ia < TA; ++ia) {
      const int ib = order - ia;
      if (ib < 0 || ib >= TB) continue;
      mma(d0, a[ia], b[ib][0], b[ib][1]);
      mma(d1, a[ia], b[ib][2], b[ib][3]);
    }
}

// ldmatrix lane addresses (lane l, matrix q = l / 8, row l % 8) of a 16 x 16
// operand tile at (r0, c0) of a row-major bf16 smem tile with row stride ld
// - A, stored [m][k]: a0..a3 = (m, k) blocks (0,0) (8,0) (0,8) (8,8)
__device__ __forceinline__ const __nv_bfloat16* a_rowmajor(
    const __nv_bfloat16* s, int ld, int m0, int k0, int lane) {
  const int q = lane >> 3;
  return s + (m0 + (q & 1) * 8 + (lane & 7)) * ld + k0 + (q >> 1) * 8;
}
// - A, stored [k][m] (transposed: ldmatrix .trans)
__device__ __forceinline__ const __nv_bfloat16* a_colmajor(
    const __nv_bfloat16* s, int ld, int m0, int k0, int lane) {
  const int q = lane >> 3;
  return s + (k0 + (q >> 1) * 8 + (lane & 7)) * ld + m0 + (q & 1) * 8;
}
// - B pair (n-tiles n0, n0 + 8), stored [n][k]: b0, b1 of each tile
__device__ __forceinline__ const __nv_bfloat16* b_nk(const __nv_bfloat16* s,
                                                     int ld, int n0, int k0,
                                                     int lane) {
  const int q = lane >> 3;
  return s + (n0 + (q >> 1) * 8 + (lane & 7)) * ld + k0 + (q & 1) * 8;
}
// - B pair, stored [k][n] (ldmatrix .trans)
__device__ __forceinline__ const __nv_bfloat16* b_kn(const __nv_bfloat16* s,
                                                     int ld, int n0, int k0,
                                                     int lane) {
  const int q = lane >> 3;
  return s + (k0 + (q & 1) * 8 + (lane & 7)) * ld + n0 + (q >> 1) * 8;
}

// 16 bytes of T as f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(e[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

// VE consecutive values as TT bf16 term planes `plane` elements apart,
// one 16- or 8-byte store per plane at dst
template <int VE, int TT>
__device__ __forceinline__ void store_vec_terms(__nv_bfloat16* dst, int plane,
                                                const float (&f)[VE]) {
  __nv_bfloat16 t[VE][TT];
#pragma unroll
  for (int e = 0; e < VE; ++e) split<TT>(f[e], t[e]);
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    uint32_t w[VE / 2];
#pragma unroll
    for (int e = 0; e < VE / 2; ++e)
      w[e] = pack2(t[2 * e][tt], t[2 * e + 1][tt]);
    if constexpr (VE == 8)
      *reinterpret_cast<uint4*>(dst + tt * plane) =
          make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(dst + tt * plane) = make_uint2(w[0], w[1]);
  }
}

// Stage rows [0, rows_p) x columns [0, cols_p) of a row-major global tile
// (row stride ld elements; rows >= rows or columns >= cols read as 0) into
// TT bf16 term planes in shared memory (row stride lds, planes `plane`
// elements apart).  16-byte loads (the wrapper aligns every row and pads
// the columns to whole vectors), a batch of them in flight per thread
// before any is stored; MAXC is the widest the tile gets.  Thread t of
// nthr takes part (nthr a multiple of MAXC / (16 / sizeof(T))).
template <typename T, int TT, int MAXC>
__device__ __forceinline__ void stage(const T* g, long long ld, int rows,
                                      int rows_p, int cols, int cols_p,
                                      __nv_bfloat16* s, int lds, int plane,
                                      int t, int nthr) {
  constexpr int VE = 16 / sizeof(T);      // elements per vector
  constexpr int VPR = MAXC / VE;          // vector slots per row
  constexpr int BATCH = 8;
  const int rpp = nthr / VPR;             // rows per pass
  const int col = (t % VPR) * VE, r0 = t / VPR;
  if (col >= cols_p) return;
  for (int rb = r0; rb < rows_p; rb += BATCH * rpp) {
    uint4 u[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int r = rb + k * rpp;
      u[k] = make_uint4(0, 0, 0, 0);
      if (r < rows && col < cols)
        u[k] = *reinterpret_cast<const uint4*>(g + r * ld + col);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int r = rb + k * rpp;
      if (r >= rows_p) continue;
      float f[VE];
      unpack<T>(u[k], f);
      store_vec_terms<VE, TT>(s + r * lds + col, plane, f);
    }
  }
}

// ---------------------------------------------------------------------
// Pass 1: one block per (rank, batch, chunk, group), group fastest
// ---------------------------------------------------------------------

constexpr int MAX_HPG = 8;  // heads per group that pass 1 stages at once

template <int TI>
struct StatesSmem {
  static constexpr size_t B_ELEMS = static_cast<size_t>(TI) * MAX_L * LDN;
  static constexpr size_t V_ELEMS = 3ull * MAX_L * LDP;
  static constexpr size_t BYTES =
      2 * (B_ELEMS + V_ELEMS) + sizeof(float) * 3 * MAX_HPG * MAX_L;
};

template <typename T, int TI>
__global__ void __launch_bounds__(THREADS, 2) ssd_states_kernel(const Args a) {
  using SM = StatesSmem<TI>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem);  // [j][n]
  __nv_bfloat16* sV = sB + SM::B_ELEMS;                          // [j][p]
  float* sDt = reinterpret_cast<float*>(sV + SM::V_ELEMS);  // [head][j]
  float* sCum = sDt + MAX_HPG * MAX_L;
  float* sW = sCum + MAX_HPG * MAX_L;

  long long blk = blockIdx.x;
  const int g = static_cast<int>(blk % a.G);
  blk /= a.G;
  const int c = static_cast<int>(blk % a.nc);
  blk /= a.nc;
  const int bt = static_cast<int>(blk % a.Bt);
  const long long r = blk / a.Bt;
  const long long s0 = static_cast<long long>(c) * a.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int hpg = a.H / a.G;
  const T* Bm = static_cast<const T*>(a.b) + r * a.bs0 + bt * a.bs1 +
                g * a.bs3 + s0 * a.bs2;
  const int n0 = 16 * warp;  // this warp's state rows [n0, n0 + 16)

  for (int h0 = 0; h0 < hpg; h0 += MAX_HPG) {
    const int nh = min(MAX_HPG, hpg - h0);
    __syncthreads();  // the last heads are done with sDt, sW, sV
    for (int e = tid; e < nh * a.L; e += THREADS) {
      const int hh = e / a.L, i = e - hh * a.L;
      const int h = g * hpg + h0 + hh;
      sDt[hh * MAX_L + i] =
          a.dt[r * a.ds0 + bt * a.ds1 + h * a.ds3 + (s0 + i) * a.ds2];
    }
    __syncthreads();
    if (tid < nh) {
      // the running sum of dt * A in row order, one thread per head, while
      // the other warps stage B
      const int h = g * hpg + h0 + tid;
      const float A = a.a[r * a.as0 + h * a.as1];
      float run = 0.f;
      for (int i = 0; i < a.L; ++i) {
        run = __fadd_rn(run, __fmul_rn(sDt[tid * MAX_L + i], A));
        sCum[tid * MAX_L + i] = run;
      }
    } else if (warp > 0 && h0 == 0) {
      stage<T, TI, MAX_N>(Bm, a.bs2, a.L, a.Lp, a.N, a.Np, sB, LDN,
                          MAX_L * LDN, tid - 32, THREADS - 32);
    }
    __syncthreads();
    for (int e = tid; e < nh * a.L; e += THREADS) {
      const int hh = e / a.L, i = e - hh * a.L;
      const long long rbh = (r * a.Bt + bt) * a.H + g * hpg + h0 + hh;
      const float cum = sCum[hh * MAX_L + i];
      a.cum[rbh * a.S + s0 + i] = cum;
      sW[hh * MAX_L + i] = expf(sCum[hh * MAX_L + a.L - 1] - cum) *
                           sDt[hh * MAX_L + i];
    }

    // x of a head: each thread loads whole 16-byte vectors, all of them
    // in flight at once; the next head's are loaded before this head's
    // products run
    constexpr int VE = 16 / sizeof(T), VPR = MAX_P / VE;
    constexpr int RPP = THREADS / VPR, XV = MAX_L / RPP;
    const int col = (tid % VPR) * VE, jr = tid / VPR;
    uint4 xv[XV];
    auto load_x = [&](int hh) {
      const int h = g * hpg + h0 + hh;
      const T* X = static_cast<const T*>(a.x) + r * a.xs0 + bt * a.xs1 +
                   h * a.xs3 + s0 * a.xs2;
#pragma unroll
      for (int k = 0; k < XV; ++k) {
        const int j = jr + k * RPP;
        xv[k] = make_uint4(0, 0, 0, 0);
        if (j < a.L && col < a.P)
          xv[k] = *reinterpret_cast<const uint4*>(X + j * a.xs2 + col);
      }
    };
    load_x(0);
    for (int hh = 0; hh < nh; ++hh) {
      const int h = g * hpg + h0 + hh;
      const long long rbh = (r * a.Bt + bt) * a.H + h;
      __syncthreads();  // sW is in; the last head's MMA is done with sV
      // V = w . x, in three term planes
      if (col < a.Pp) {
        const float* w = sW + hh * MAX_L;
#pragma unroll
        for (int k = 0; k < XV; ++k) {
          const int j = jr + k * RPP;
          if (j >= a.Lp) continue;
          float f[VE];
          unpack<T>(xv[k], f);
          const float wj = j < a.L ? w[j] : 0.f;
#pragma unroll
          for (int e = 0; e < VE; ++e) f[e] *= wj;
          store_vec_terms<VE, 3>(sV + j * LDP + col, MAX_L * LDP, f);
        }
      }
      __syncthreads();
      if (hh + 1 < nh) load_x(hh + 1);

      // S_c (N x P) = B^T (N x L) . (w . x) (L x P): warp w owns n rows
      // [16 w, 16 w + 16), every p
      if (n0 >= a.Np) continue;
      float acc[MAX_P / 8][4];
#pragma unroll
      for (int t = 0; t < MAX_P / 8; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      for (int k0 = 0; k0 < a.Lp; k0 += 16) {
        // rows whose weight w_j is 0 (a decay that underflowed) add nothing
        const int jw = k0 + (lane & 15);
        if (!__any_sync(FULL, jw < a.L && sW[hh * MAX_L + jw] != 0.f))
          continue;
        uint32_t af[TI][4];
#pragma unroll
        for (int ia = 0; ia < TI; ++ia)
          ldsm_x4_t(af[ia],
                    a_colmajor(sB + ia * MAX_L * LDN, LDN, n0, k0, lane));
#pragma unroll
        for (int pt = 0; pt < MAX_P / 16; ++pt) {
          if (16 * pt >= a.Pp) continue;
          uint32_t bf[3][4];
#pragma unroll
          for (int ib = 0; ib < 3; ++ib)
            ldsm_x4_t(bf[ib],
                      b_kn(sV + ib * MAX_L * LDP, LDP, 16 * pt, k0, lane));
          mma_terms<TI, 3>(acc[2 * pt], acc[2 * pt + 1], af, bf);
        }
      }
      float* ST = a.states + (rbh * a.nc + c) * a.N * a.P;
#pragma unroll
      for (int t = 0; t < MAX_P / 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + gq + 8 * e, p = 8 * t + 2 * cq;
          if (n < a.N && p < a.P)
            *reinterpret_cast<float2*>(ST + n * a.P + p) =
                make_float2(acc[t][2 * e], acc[t][2 * e + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------
// Pass 2: the state hand-off, one thread per (rank, batch, head, n, p)
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) ssd_handoff_kernel(const Args a) {
  // four state elements (16 bytes) per thread
  const long long np4 = static_cast<long long>(a.N) * a.P / 4;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= static_cast<long long>(a.R) * a.Bt * a.H * np4) return;
  const long long rbh = e / np4, k = e - rbh * np4;
  float4* __restrict__ st =
      reinterpret_cast<float4*>(a.states) + rbh * a.nc * np4 + k;
  const float* __restrict__ cum = a.cum + rbh * a.S + a.L - 1;
  // a batch of chunks' states and decays is loaded before the chain uses
  // it: the loads do not wait on the chain
  constexpr int BATCH = 16;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += BATCH) {
    float4 sv[BATCH];
    float dk[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = c0 + u;
      if (c < a.nc) {
        sv[u] = st[c * np4];
        dk[u] = expf(cum[static_cast<long long>(c) * a.L]);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = c0 + u;
      if (c >= a.nc) break;
      st[c * np4] = h;  // chunk c's incoming state
      h.x = __fadd_rn(__fmul_rn(h.x, dk[u]), sv[u].x);
      h.y = __fadd_rn(__fmul_rn(h.y, dk[u]), sv[u].y);
      h.z = __fadd_rn(__fmul_rn(h.z, dk[u]), sv[u].z);
      h.w = __fadd_rn(__fmul_rn(h.w, dk[u]), sv[u].w);
    }
  }
  reinterpret_cast<float4*>(a.hout)[e] = h;
}

// ---------------------------------------------------------------------
// Pass 3: one block per (rank, batch, chunk, group), group fastest
// ---------------------------------------------------------------------

template <int TI>
struct OutputsSmem {
  static constexpr size_t C_ELEMS = static_cast<size_t>(TI) * MAX_L * LDN;
  static constexpr size_t X_ELEMS = static_cast<size_t>(TI) * MAX_L * LDP;
  static constexpr size_t H_ELEMS = 3ull * MAX_N * LDP;
  // B is read only for C . B^T; x and the incoming state take its place
  static constexpr size_t U_ELEMS =
      C_ELEMS > X_ELEMS + H_ELEMS ? C_ELEMS : X_ELEMS + H_ELEMS;
  static constexpr size_t BYTES =
      2 * (C_ELEMS + U_ELEMS) + sizeof(float) * 3 * MAX_L;
};

template <typename T, int TI>
__global__ void __launch_bounds__(THREADS, 2)
ssd_outputs_kernel(const Args a) {
  using SM = OutputsSmem<TI>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem);  // [i][n]
  __nv_bfloat16* sB = sC + SM::C_ELEMS;                          // [j][n]
  __nv_bfloat16* sX = sB;                                        // [j][p]
  __nv_bfloat16* sH = sX + SM::X_ELEMS;                          // [n][p]
  float* sCum = reinterpret_cast<float*>(sB + SM::U_ELEMS);
  float* sDt = sCum + MAX_L;
  float* sEc = sDt + MAX_L;  // exp(cum_i)

  long long blk = blockIdx.x;
  const int g = static_cast<int>(blk % a.G);
  blk /= a.G;
  const int c = static_cast<int>(blk % a.nc);
  blk /= a.nc;
  const int bt = static_cast<int>(blk % a.Bt);
  const long long r = blk / a.Bt;
  const long long s0 = static_cast<long long>(c) * a.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const T* Bm = static_cast<const T*>(a.b) + r * a.bs0 + bt * a.bs1 +
                g * a.bs3 + s0 * a.bs2;
  const T* Cm = static_cast<const T*>(a.c) + r * a.cs0 + bt * a.cs1 +
                g * a.cs3 + s0 * a.cs2;

  stage<T, TI, MAX_N>(Cm, a.cs2, a.L, a.Lp, a.N, a.Np, sC, LDN, MAX_L * LDN,
                      tid, THREADS);
  stage<T, TI, MAX_N>(Bm, a.bs2, a.L, a.Lp, a.N, a.Np, sB, LDN, MAX_L * LDN,
                      tid, THREADS);
  __syncthreads();

  // C . B^T for this warp's rows i in [16 w, 16 w + 16) and every column
  // j <= 16 w + 15: 16 n8-tiles of 4 registers, static indices
  const int i0 = 16 * warp;
  const bool rows = i0 < a.Lp;
  float cb[MAX_L / 8][4];
#pragma unroll
  for (int t = 0; t < MAX_L / 8; ++t)
    cb[t][0] = cb[t][1] = cb[t][2] = cb[t][3] = 0.f;
  if (rows) {
    for (int k0 = 0; k0 < a.Np; k0 += 16) {
      uint32_t af[TI][4];
#pragma unroll
      for (int ia = 0; ia < TI; ++ia)
        ldsm_x4(af[ia], a_rowmajor(sC + ia * MAX_L * LDN, LDN, i0, k0, lane));
#pragma unroll
      for (int jt = 0; jt < MAX_L / 16; ++jt) {
        if (jt > warp) continue;
        uint32_t bf[TI][4];
#pragma unroll
        for (int ib = 0; ib < TI; ++ib)
          ldsm_x4(bf[ib], b_nk(sB + ib * MAX_L * LDN, LDN, 16 * jt, k0, lane));
        mma_terms<TI, TI>(cb[2 * jt], cb[2 * jt + 1], af, bf);
      }
    }
  }
  const int ia0 = i0 + gq, ia1 = ia0 + 8;  // this thread's rows

  const int hpg = a.H / a.G;
  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = (r * a.Bt + bt) * a.H + h;
    __syncthreads();  // C . B^T is done with sB; the last head with sX, sH
    const T* X = static_cast<const T*>(a.x) + r * a.xs0 + bt * a.xs1 +
                 h * a.xs3 + s0 * a.xs2;
    const float* DT = a.dt + r * a.ds0 + bt * a.ds1 + h * a.ds3 +
                      s0 * a.ds2;
    const float* CUM = a.cum + rbh * a.S + s0;
    for (int i = tid; i < a.L; i += THREADS) {
      sCum[i] = CUM[i];
      sDt[i] = DT[i * a.ds2];
      sEc[i] = expf(CUM[i]);
    }
    if constexpr (TI == 1) {
      // bf16 x is copied as it is: cp.async, in flight while the state
      // loads below go through registers
      constexpr int VPR = MAX_P / 8, RPP = THREADS / VPR;
      const int col = (tid % VPR) * 8;
      if (col < a.Pp) {
        for (int j = tid / VPR; j < a.Lp; j += RPP) {
          const bool in = j < a.L && col < a.P;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                       :: "r"(smem_u32(sX + j * LDP + col)),
                          "l"(in ? X + j * a.xs2 + col : X),
                          "r"(in ? 16 : 0)
                       : "memory");
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      stage<T, TI, MAX_P>(X, a.xs2, a.L, a.Lp, a.P, a.Pp, sX, LDP,
                          MAX_L * LDP, tid, THREADS);
    }
    stage<float, 3, MAX_P>(a.states + (rbh * a.nc + c) * a.N * a.P, a.P,
                           a.N, a.Np, a.P, a.Pp, sH, LDP, MAX_N * LDP, tid,
                           THREADS);
    if constexpr (TI == 1)
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (!rows) continue;

    float y[MAX_P / 8][4];
#pragma unroll
    for (int t = 0; t < MAX_P / 8; ++t)
      y[t][0] = y[t][1] = y[t][2] = y[t][3] = 0.f;
    // inter-chunk: C (L x N) . h_{c-1} (N x P), then times exp(cum_i); a
    // row block whose exp(cum_i) are all 0 takes no product (with a finite
    // state it is exactly 0)
    const bool inter =
        __any_sync(FULL, (ia0 < a.L && !(sCum[ia0] < EXP_ZERO)) ||
                             (ia1 < a.L && !(sCum[ia1] < EXP_ZERO)));
    for (int k0 = 0; inter && k0 < a.Np; k0 += 16) {
      uint32_t af[TI][4];
#pragma unroll
      for (int ia = 0; ia < TI; ++ia)
        ldsm_x4(af[ia], a_rowmajor(sC + ia * MAX_L * LDN, LDN, i0, k0, lane));
#pragma unroll
      for (int pt = 0; pt < MAX_P / 16; ++pt) {
        if (16 * pt >= a.Pp) continue;
        uint32_t bf[3][4];
#pragma unroll
        for (int ib = 0; ib < 3; ++ib)
          ldsm_x4_t(bf[ib],
                    b_kn(sH + ib * MAX_N * LDP, LDP, 16 * pt, k0, lane));
        mma_terms<TI, 3>(y[2 * pt], y[2 * pt + 1], af, bf);
      }
    }
    const float e0 = ia0 < a.L ? sEc[ia0] : 0.f;
    const float e1 = ia1 < a.L ? sEc[ia1] : 0.f;
#pragma unroll
    for (int t = 0; t < MAX_P / 8; ++t) {
      y[t][0] *= e0;
      y[t][1] *= e0;
      y[t][2] *= e1;
      y[t][3] *= e1;
    }
    // intra-chunk: W (L x L, j <= i) . x (L x P), W = (C . B^T) o
    // exp(cum_i - cum_j) dt_j built from the cb fragments (the accumulator
    // layout of keys 16 kt .. 16 kt + 15 is the A layout of k-step kt)
    const float cum0 = ia0 < a.L ? sCum[ia0] : 0.f;
    const float cum1 = ia1 < a.L ? sCum[ia1] : 0.f;
#pragma unroll
    for (int kt = 0; kt < MAX_L / 16; ++kt) {
      if (kt > warp || 16 * kt >= a.Lp) continue;
      // a block of W whose decays all underflow is 0: no products
      bool live = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? ia1 : ia0;
        const float cum_i = (q & 1) ? cum1 : cum0;
        const int j = 16 * kt + 8 * (q >> 1) + 2 * cq;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          live |= j + e <= row && row < a.L &&
                  !(cum_i - sCum[j + e] < EXP_ZERO);
      }
      if (!__any_sync(FULL, live)) continue;
      // A register q holds keys (2c, 2c + 1) + 8 (q >> 1) of row g + 8 (q & 1)
      uint32_t af[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? ia1 : ia0;
        const float cum_i = (q & 1) ? cum1 : cum0;
        const int j = 16 * kt + 8 * (q >> 1) + 2 * cq;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          w[e] = j + e <= row && row < a.L
                     ? cb[2 * kt + (q >> 1)][2 * (q & 1) + e] *
                           expf(cum_i - sCum[j + e]) * sDt[j + e]
                     : 0.f;
        // three bf16 terms, two keys at a time
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const __nv_bfloat162 t = __floats2bfloat162_rn(w[0], w[1]);
          af[k][q] = *reinterpret_cast<const uint32_t*>(&t);
          w[0] = __fsub_rn(w[0], __low2float(t));
          w[1] = __fsub_rn(w[1], __high2float(t));
        }
      }
#pragma unroll
      for (int pt = 0; pt < MAX_P / 16; ++pt) {
        if (16 * pt >= a.Pp) continue;
        uint32_t bf[TI][4];
#pragma unroll
        for (int ib = 0; ib < TI; ++ib)
          ldsm_x4_t(bf[ib], b_kn(sX + ib * MAX_L * LDP, LDP, 16 * pt,
                                 16 * kt, lane));
        mma_terms<3, TI>(y[2 * pt], y[2 * pt + 1], af, bf);
      }
    }
    float* Y = a.y + ((r * a.Bt + bt) * a.S + s0) * a.H * a.P +
               static_cast<long long>(h) * a.P;
#pragma unroll
    for (int t = 0; t < MAX_P / 8; ++t) {
      const int p = 8 * t + 2 * cq;
      if (p >= a.P) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = e ? ia1 : ia0;
        if (i >= a.L) continue;
        *reinterpret_cast<float2*>(Y + static_cast<long long>(i) * a.H * a.P +
                                   p) = make_float2(y[t][2 * e],
                                                    y[t][2 * e + 1]);
      }
    }
  }
}

template <typename T, int TI>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t s1 = StatesSmem<TI>::BYTES, s3 = OutputsSmem<TI>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_kernel<T, TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_outputs_kernel<T, TI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s3));
  if (err != cudaSuccess) return err;
  const long long rb = static_cast<long long>(a.R) * a.Bt;
  ssd_states_kernel<T, TI><<<static_cast<unsigned>(rb * a.nc * a.G),
                             THREADS, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long elems = rb * a.H * a.N * a.P / 4;
  ssd_handoff_kernel<<<static_cast<unsigned>((elems + THREADS - 1) / THREADS),
                       THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_outputs_kernel<T, TI><<<static_cast<unsigned>(rb * a.nc * a.G),
                              THREADS, s3, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16; dt and A are float32.
// Strides in elements, four each for x, dt, B, C (ranks, batch, sequence,
// head or group) and two for A; every inner stride is 1.  y and h_final
// are contiguous; `states` (R, Bt, H, S / L, N, P) and `cum` (R, Bt, H, S)
// are f32 scratch.  L is the chunk: 1..128 and divides S; N <= 128,
// P <= 64, H % G == 0.  Launches the three passes in order; returns the
// CUDA error of the launches (0 on success).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* hout, void* states, void* cum, int dtype,
    int R, int Bt, int S, int H, int P, int G, int N, int L, long long xs0,
    long long xs1, long long xs2, long long xs3, long long ds0,
    long long ds1, long long ds2, long long ds3, long long as0,
    long long as1, long long bs0, long long bs1, long long bs2,
    long long bs3, long long cs0, long long cs1, long long cs2,
    long long cs3, void* stream) {
  if (R <= 0 || Bt <= 0 || H <= 0 || S <= 0 || G <= 0 || H % G != 0 ||
      L <= 0 || L > MAX_L || S % L != 0 || N <= 0 || N > MAX_N || P <= 0 ||
      P > MAX_P || N % 8 != 0 || P % 8 != 0)
    return cudaErrorInvalidValue;
  const int nc = S / L;
  const long long rb = static_cast<long long>(R) * Bt;
  if (rb * nc * G > 2147483647LL ||
      (rb * H * N * P / 4 + THREADS - 1) / THREADS > 2147483647LL)
    return cudaErrorInvalidValue;
  auto pad16 = [](int v) { return (v + 15) / 16 * 16; };
  Args args{x,   static_cast<const float*>(dt), static_cast<const float*>(a),
            b,   c,   static_cast<float*>(y),   static_cast<float*>(hout),
            static_cast<float*>(states), static_cast<float*>(cum),
            R,   Bt,  S,   H,   P,   G,   N,   L,   nc,
            pad16(L), pad16(N), pad16(P),
            xs0, xs1, xs2, xs3, ds0, ds1, ds2, ds3, as0, as1,
            bs0, bs1, bs2, bs3, cs0, cs1, cs2, cs3};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, 3>(args, st);
  if (dtype == 1) return launch<__nv_bfloat16, 1>(args, st);
  return cudaErrorInvalidValue;
}

