// Mamba2 SSD chunked scan, backward: the gradients of ssd_scan.cu's scan,
// written by hand for Hopper (sm_90a).
//
// Replaces: no TPU kernel.  The JAX package trains mamba2 by jax.grad of
// its jnp path repro/models/ssm.py::ssd_chunked_ref (ssd_scan_pallas has
// no VJP); this kernel computes that gradient for the port's CUDA forward,
// whose plain version's autograd (kernels/ssd_scan/ref.py) serves the CPU.
//
// Layout: the forward's (x (R, Bt, S, H, P), dt (R, Bt, S, H) f32, A (R, H)
// f32, B and C (R, Bt, S, G, N) in x's dtype, read through strides), the
// cotangents dy (R, Bt, S, H, P) f32 and dh_final (R, Bt, H, N, P) f32 or
// none, contiguous, and what the forward kept under autograd: cum (R, Bt,
// H, S), the running sum of dt * A over each chunk, and states (R, Bt, H,
// nc, N, P), each chunk's incoming state h_{c-1}.  Outputs, contiguous:
// dx in x's dtype, ddt f32, dA (R, H) f32, dB and dC in x's dtype, summed
// over the H / G heads of their group.
//
// Per chunk c of L rows (D_ij = exp(cum_i - cum_j) for j <= i, else 0;
// cL = cum_{L-1}; g_c the gradient of the state leaving chunk c):
//   g_{c-1} = exp(cL) g_c + U_c,     U_c = sum_i exp(cum_i) C_i^T dy_i
//   M_ij = dy_i . x_j,  Z_ij = D_ij dt_j M_ij,  W_ij = (C_i . B_j) Z_ij
//   dx_j = dt_j [sum_{i>=j} (C_i . B_j) D_ij dy_i + exp(cL - cum_j) B_j g_c]
//   dC_i = sum_{j<=i} Z_ij B_j + exp(cum_i) h_{c-1} dy_i
//   dB_j = sum_{i>=j} Z_ij C_i + exp(cL - cum_j) dt_j g_c x_j
//   dcum_i = sum_{j<i} W_ij - sum_{k>i} W_ki + exp(cum_i) dy_i . (C_i h_{c-1})
//            - s_i,   s_j = exp(cL - cum_j) dt_j (B_j g_c) . x_j,
//   and row L-1 adds sum_j s_j + exp(cL) <h_{c-1}, g_c>;
//   ddt_j = sum_{i>=j} (C_i . B_j) D_ij M_ij + exp(cL - cum_j) (B_j g_c) . x_j
//           + A rc_j,   dA = sum rc_j dt_j,   rc_j = sum_{i>=j} dcum_i.
// The exponent is only formed for j <= i, where it is <= 0, as in the
// forward: a future entry, whose exp would overflow, is never evaluated.
//
// What bounds it on this card: bytes.  At the training shape (R 8, Bt 4,
// S 2048, H 6, P 64, N 128, chunk 128, bf16) it must move ~272 MB (dy in
// f32 101 MB, x and dx 50 MB each, B, C, dB, dC 17 MB each): ~81 us at
// 3.35 TB/s, against ~53 GFLOP of products, ~53 us on the tensor cores.
// Any design here moves more: the chunk-state gradients (101 MB) are
// written by U, rewritten by the hand-off and read by the gradients, and
// each head's x and dy are read once a pass.
//
// Both routes below keep the forward's exactness rule: an f32 operand
// (dy, the states, a decay-weighted matrix, and every operand of an f32
// call) is split into three bf16 terms whose products of order <= 2
// accumulate in f32 on the tensor cores, smallest first; a bf16 operand is
// taken as it is.  Five kernels per call (one ssd_scan_bwd_launch), the
// route picked by dtype:
// b0. (the forward) keeps cum and the incoming states for the backward:
//     100.7 MB f32 at the training shape, which under remat per block lives
//     only for the recomputed block, during its backward; rerunning passes
//     1-2 here would cost their time again for no memory that matters.
// b1. U, one block per (rank, batch, chunk, group): per head, U_c = C^T
//     (exp(cum) o dy), N x P over the chunk's rows, warp w owning state
//     rows [16 w, 16 w + 16), into a scratch (R, Bt, H, nc, N, P) f32;
// b2. the hand-off, one thread per (rank, batch, head, 4 state elements):
//     the chunks last to first, g_{c-1} = exp(cL) g_c + U_c in the
//     forward's rounded product-then-sum order, overwriting U_c with g_c;
//     a thread loads 16 chunks' U_c before it stores a g over them, so
//     the loads are in flight together;
// b3. the gradients, one block per (rank, batch, chunk, group), warp w
//     owning 16 rows of the chunk.  C and B are staged once for the group.
//     Rows-i pass, per head in order: C.B^T and M one 16 x 16 tile at a
//     time over the j <= i triangle, Z built in registers as the A operand
//     of Z.B (dC), the row sums of W, then C.h_{c-1} and dy.h^T; dC
//     accumulates over the group's heads in registers.  Rows-j pass, per
//     head: B.C^T and x.dy^T tiles over i >= j, the A operands of
//     (C.B^T o D).dy (dx) and Z^T.C (dB), the column sums of W and the
//     direct ddt, then B.g_c and x.g_c^T; dB accumulates over the heads.
//     The two passes restage x and dy per head (from L2): holding both dC
//     and dB in one pass would not fit the registers.  Each row's dcum goes
//     to a scratch (R, Bt, H, S), the per-(chunk, head) terms of row L-1
//     to another (R, Bt, H, nc);
// b4. ddt and one dA partial per (rank, batch, chunk, head), the reverse
//     cumsum of dcum;
// b5. ssd_bwd_da_kernel, one thread per (rank, head): dA, the partials
//     summed over (batch, chunk) in order.
// Determinism: no atomics; every output element has one writer and every
// sum runs in a fixed order (warp shuffles in a fixed ladder or
// butterfly), so two runs are bitwise equal.  Sums over tiles and heads
// (U, dC, dB, dx and the state terms) add each k-step's (or chain's)
// products into their accumulator with IEEE adds: carried through the
// tensor cores' accumulation instead, dB's 144 calls at the training shape
// drifted to 6x the f32 plain version's error against float64 (f32 inputs,
// shallow decay).  Tiles whose decays all lie below EXP_ZERO add exactly 0
// and are skipped, as in the forward; how much that saves depends on the
// data (steep decays skip most of a chunk's triangle).  L, N and P are
// zero-padded to multiples of 16 in shared memory (the wrapper pads N and P
// to multiples of 8 and aligns every row, as for the forward).  b1 and b3
// launch 8 warps a block; every kernel launches on the caller's stream and
// allocates nothing: the wrapper allocates the scratch.
//
// f32 calls (launch_f32): every product mma.sync, operands read from
// shared memory as f32 and split into terms as their fragments load (the
// f32 call's five tiles, C, B, x, dy and h or g, fill 226 KB as they are;
// term planes would not fit); b4 one thread per chunk, its rows in order.
// Both routes share b2 and b5.
//
// bf16 calls, the training route (bfr::launch).  On the kernels above,
// bf16 took 2.50 ms at the training shape (steep decay), 31x its bound:
// not bytes but instructions held it, every fragment register built from
// two scalar shared-memory loads and split into terms on every use, the
// dense products on mma.sync, each head's staging waited for.  So:
// - each f32 tile is split once, as a head is staged, into three bf16
//   term planes in shared memory (hi, mid, lo; U's dy after its exp(cum)
//   row scale), every tile 128-byte swizzled (16-byte chunk c of row r
//   stored at chunk c ^ (r % 8)): the layout wgmma reads, conflict-free
//   for ldmatrix;
// - every mma.sync fragment is one ldmatrix.x4 (.trans where a product
//   reads a tile across its stored rows);
// - the four dense chunk-state products, C.h_{c-1}, dy.h^T, B.g_c and
//   x.g_c^T, run on wgmma from shared memory, each warpgroup on 64 rows
//   (a warp's 16 rows of the m64 accumulator lie as the mma.sync
//   accumulators of dC and dB do).  Their row scales (exp(cum_i);
//   exp(cL - cum_j) dt_j) leave the operands and scale each product's
//   sum: x.g^T is three products (x is exact in bf16), not six.  Each
//   product is one chain over its whole depth inside the tensor cores (8
//   k-steps for C.h and B.g, 4 for dy.h^T and x.g^T) before its IEEE add
//   into the accumulator: on the card, the training-shape float64 gate
//   passed on both decays with chains of 1, 2, 4 and 8 k-steps, and the
//   longest was the fastest.  A warpgroup whose rows all decay to 0 skips
//   the product;
// - while a head computes, cp.async brings the next head's x and dy rows
//   into a 48 KB landing area and a bulk L2 prefetch its state tiles
//   (TMA bulk copies row by row, 256 a head into an mbarrier, were tried
//   first and dropped; the reading that found them slower was not kept);
// - the triangle stays on mma.sync, one 16 x 16 tile at a time: its Z and
//   decay-masked operands are built in registers, and skipping tiles
//   needs that granularity (a tile is skipped when the decay between its
//   16-row blocks, from each block's cum range, lies below EXP_ZERO).
//   Warp w works one row block in both passes, so a pass waits on the
//   warp with 8 tiles while the mean is 4.5: balancing it would need a
//   second 64-register accumulator.  The tiles' 16-row blocks 4-7 are
//   stored in reverse (prow), which evens the load of an SM
//   sub-partition's two warps: on the card the call took 2.4 % less time
//   at the shallow decay than with the blocks in order, 0.6 % less at the
//   steep one;
// - U (two blocks an SM, its next head's dy landing by cp.async) reads
//   its fragments by ldmatrix; ddt runs one warp a chunk.
// The grads kernel's shared memory: C and B 32 KB each, x 16, dy's planes
// 48, the state's planes 48, the landing area 48, with the row data 227
// KB; 255 registers, one 8-warp block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_common.cuh"
#include "../../flash_attention/csrc/hopper.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dy;      // (R, Bt, S, H, P)
  const float* dh;      // (R, Bt, H, N, P), or null: a zero cotangent
  const float* states;  // (R, Bt, H, nc, N, P): h_{c-1}, from the forward
  const float* cum;     // (R, Bt, H, S), from the forward
  void* dx;             // (R, Bt, S, H, P)
  float* ddt;           // (R, Bt, S, H)
  float* da;            // (R, H)
  void* db;             // (R, Bt, S, G, N)
  void* dc;             // (R, Bt, S, G, N)
  float* grad;          // (R, Bt, H, nc, N, P) scratch: U_c, then g_c
  float* dcum;          // (R, Bt, H, S) scratch
  float* ddtd;          // (R, Bt, H, S) scratch: ddt less A rc
  float* tail;          // (R, Bt, H, nc) scratch: row L-1's extra dcum
  float* dapart;        // (R, H, Bt, nc) scratch
  int R, Bt, S, H, P, G, N, L, nc;
  int Lp, Np, Pp;  // L, N, P padded to multiples of 16
  long long xs0, xs1, xs2, xs3;
  long long ds0, ds1, ds2, ds3;
  long long as0, as1;
  long long bs0, bs1, bs2, bs3;
  long long cs0, cs1, cs2, cs3;
};

// register q of a fragment from two values (the lower k in the low half)
template <int TT, int NQ>
__device__ __forceinline__ void put_terms(uint32_t (&f)[TT][NQ], int q,
                                          float v0, float v1) {
  __nv_bfloat16 t0[TT], t1[TT];
  split<TT>(v0, t0);
  split<TT>(v1, t1);
#pragma unroll
  for (int t = 0; t < TT; ++t) f[t][q] = pack2(t0[t], t1[t]);
}

// The m16n8k16 fragments, lane l (gq = l / 4, cq = l % 4):
// A (16 x 16): register q holds row gq + 8 (q & 1), columns 2 cq, 2 cq + 1
//   plus 8 (q >> 1); B (16 x 8): register r holds rows 2 cq, 2 cq + 1 plus
//   8 r of column gq; the accumulator (16 x 8): d0, d1 row gq, d2, d3 row
//   gq + 8, columns 2 cq, 2 cq + 1.
// A fragment at (m0, k0) of a shared-memory matrix whose element (m, k)
// lies at s[m * sm + k * sk], as TT bf16 terms; row m scaled by rs[m]
// first when rs is given
template <int TT>
__device__ __forceinline__ void frag_a(uint32_t (&f)[TT][4], const float* s,
                                       int sm, int sk, int m0, int k0,
                                       int lane,
                                       const float* rs = nullptr) {
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + gq + 8 * (q & 1), k = k0 + 2 * cq + 8 * (q >> 1);
    float v0 = s[m * sm + k * sk], v1 = s[m * sm + (k + 1) * sk];
    if (rs != nullptr) {
      v0 *= rs[m];
      v1 *= rs[m];
    }
    put_terms<TT, 4>(f, q, v0, v1);
  }
}

// B fragment at (k0, n0) of a matrix whose element (k, n) lies at
// s[k * sk + n * sn], as TT bf16 terms; row k scaled by ks[k] first when
// ks is given
template <int TT>
__device__ __forceinline__ void frag_b(uint32_t (&f)[TT][2], const float* s,
                                       int sk, int sn, int k0, int n0,
                                       int lane,
                                       const float* ks = nullptr) {
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = k0 + 2 * cq + 8 * r, n = n0 + gq;
    float v0 = s[k * sk + n * sn], v1 = s[(k + 1) * sk + n * sn];
    if (ks != nullptr) {
      v0 *= ks[k];
      v1 *= ks[k + 1];
    }
    put_terms<TT, 2>(f, r, v0, v1);
  }
}

// A fragment of a 16 x 16 block held as two accumulator tiles (columns
// 0-7 and 8-15): the accumulator layout is the A layout
template <int TT>
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[TT][4],
                                         const float (&v)[2][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    put_terms<TT, 4>(f, q, v[q >> 1][2 * (q & 1)], v[q >> 1][2 * (q & 1) + 1]);
}

// d += A . B over the products of terms of order <= 2, smallest first
template <int TA, int TB>
__device__ __forceinline__ void mma_t(float (&d)[4], const uint32_t (&a)[TA][4],
                                      const uint32_t (&b)[TB][2]) {
#pragma unroll
  for (int order = 2; order >= 0; --order)
#pragma unroll
    for (int ia = 0; ia < TA; ++ia) {
      const int ib = order - ia;
      if (ib < 0 || ib >= TB) continue;
      mma(d, a[ia], b[ib][0], b[ib][1]);
    }
}

// d += A . B through a zeroed accumulator and IEEE adds: the tensor
// cores' f32 accumulation does not round to nearest (it truncates what an
// addend loses in alignment), and a sum carried through many mma calls
// (over tiles and heads: 144 for dB at the training shape) drifts by ~0.5
// ulp a call; this keeps the drift to one call's products
template <int TA, int TB>
__device__ __forceinline__ void mma_add(float (&d)[4],
                                        const uint32_t (&a)[TA][4],
                                        const uint32_t (&b)[TB][2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_t<TA, TB>(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// the sum over the four lanes of a row (cq), the same bits on each
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Stage rows [0, rows_p) x columns [0, cols_p) of a row-major global f32
// tile (row stride ld; rows >= rows or columns >= cols read as 0) into
// shared memory as it is (row stride lds), 16 bytes a thread at a time
__device__ __forceinline__ void stage(const float* g, long long ld, int rows,
                                      int rows_p, int cols, int cols_p,
                                      float* s, int lds, int tid) {
  constexpr int VE = 4;  // floats in 16 bytes
  const int vpr = cols_p / VE;
  for (int v = tid; v < rows_p * vpr; v += THREADS) {
    const int r = v / vpr, col = (v - r * vpr) * VE;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < rows && col < cols)
      u = *reinterpret_cast<const uint4*>(g + r * ld + col);
    *reinterpret_cast<uint4*>(s + r * lds + col) = u;
  }
}

// two consecutive values of one row of a T output
template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1) {
  if constexpr (sizeof(T) == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// ---------------------------------------------------------------------
// b1: U_c = C^T (exp(cum) o dy), one block per (rank, batch, chunk, group)
// ---------------------------------------------------------------------

// shared memory: C, dy and exp(cum), their rows unpadded (as the grads
// kernel's, which must fit)
constexpr size_t U_SMEM =
    sizeof(float) * (MAX_L * MAX_N + MAX_L * MAX_P + MAX_L);

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_u_kernel(
    const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sC = reinterpret_cast<float*>(smem);  // [i][n]
  float* sDy = sC + MAX_L * MAX_N;              // [i][p]
  float* sEc = sDy + MAX_L * MAX_P;  // exp(cum_i), 0 past the chunk

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
  const float* Cm = static_cast<const float*>(a.c) + r * a.cs0 +
                    bt * a.cs1 + g * a.cs3 + s0 * a.cs2;
  stage(Cm, a.cs2, a.L, a.Lp, a.N, a.Np, sC, MAX_N, tid);
  const int n0 = 16 * warp;  // this warp's state rows

  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = (r * a.Bt + bt) * a.H + h;
    __syncthreads();  // the last head is done with sDy, sEc
    stage(a.dy + ((r * a.Bt + bt) * a.S + s0) * a.H * a.P +
              static_cast<long long>(h) * a.P,
          static_cast<long long>(a.H) * a.P, a.L, a.Lp, a.P, a.Pp, sDy, MAX_P,
          tid);
    for (int i = tid; i < a.Lp; i += THREADS)
      sEc[i] = i < a.L ? expf(a.cum[rbh * a.S + s0 + i]) : 0.f;
    __syncthreads();
    if (n0 >= a.Np) continue;
    float u[MAX_P / 8][4];
#pragma unroll
    for (int t = 0; t < MAX_P / 8; ++t) u[t][0] = u[t][1] = u[t][2] = u[t][3] = 0.f;
    for (int k0 = 0; k0 < a.Lp; k0 += 16) {
      uint32_t af[3][4];
      frag_a<3>(af, sC, 1, MAX_N, n0, k0, lane);  // C^T: (n, i) at C[i][n]
#pragma unroll
      for (int pt = 0; pt < MAX_P / 8; ++pt) {
        if (8 * pt >= a.Pp) continue;
        uint32_t bf[3][2];
        frag_b<3>(bf, sDy, MAX_P, 1, k0, 8 * pt, lane, sEc);
        mma_add<3, 3>(u[pt], af, bf);
      }
    }
    float* UC = a.grad + (rbh * a.nc + c) * a.N * a.P;
#pragma unroll
    for (int pt = 0; pt < MAX_P / 8; ++pt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + gq + 8 * e, p = 8 * pt + 2 * cq;
        if (n < a.N && p < a.P)
          *reinterpret_cast<float2*>(UC + n * a.P + p) =
              make_float2(u[pt][2 * e], u[pt][2 * e + 1]);
      }
  }
}

// ---------------------------------------------------------------------
// b2: the reverse hand-off, one thread per (rank, batch, head, 4 elements)
// ---------------------------------------------------------------------

constexpr int HANDOFF_BATCH = 16;  // chunks whose values a thread loads at once

__global__ void __launch_bounds__(THREADS) ssd_bwd_handoff_kernel(
    const BwdArgs a) {
  const long long np4 = static_cast<long long>(a.N) * a.P / 4;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= static_cast<long long>(a.R) * a.Bt * a.H * np4) return;
  const long long rbh = e / np4, k = e - rbh * np4;
  float4* gr = reinterpret_cast<float4*>(a.grad) + rbh * a.nc * np4 + k;
  const float* cum = a.cum + rbh * a.S + a.L - 1;
  float4 g = a.dh != nullptr ? reinterpret_cast<const float4*>(a.dh)[e]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  // every chunk value of a batch is loaded before any g is stored over it:
  // the loads are in flight together
  for (int c1 = a.nc; c1 > 0; c1 -= HANDOFF_BATCH) {
    float4 u[HANDOFF_BATCH];
    float dk[HANDOFF_BATCH];
#pragma unroll
    for (int t = 0; t < HANDOFF_BATCH; ++t) {
      const int c = c1 - 1 - t;
      if (c >= 0) {
        u[t] = gr[c * np4];
        dk[t] = expf(cum[static_cast<long long>(c) * a.L]);
      }
    }
#pragma unroll
    for (int t = 0; t < HANDOFF_BATCH; ++t) {
      const int c = c1 - 1 - t;
      if (c < 0) continue;
      gr[c * np4] = g;  // the gradient of the state leaving chunk c
      g.x = __fadd_rn(__fmul_rn(g.x, dk[t]), u[t].x);
      g.y = __fadd_rn(__fmul_rn(g.y, dk[t]), u[t].y);
      g.z = __fadd_rn(__fmul_rn(g.z, dk[t]), u[t].z);
      g.w = __fadd_rn(__fmul_rn(g.w, dk[t]), u[t].w);
    }
  }
}

// ---------------------------------------------------------------------
// b3: the gradients, one block per (rank, batch, chunk, group)
// ---------------------------------------------------------------------

// shared memory: C, B, x, dy, the state, cum, dt, the row scales and the
// per-warp sums (226 KB)
constexpr size_t G_SMEM =
    sizeof(float) *
    (2 * MAX_L * MAX_N + 2 * MAX_L * MAX_P + MAX_N * MAX_P + 3 * MAX_L + 16);

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_grads_kernel(
    const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sC = reinterpret_cast<float*>(smem);  // [i][n]
  float* sB = sC + MAX_L * MAX_N;               // [j][n]
  float* sX = sB + MAX_L * MAX_N;               // [j][p]
  float* sDy = sX + MAX_L * MAX_P;              // [i][p]
  float* sHG = sDy + MAX_L * MAX_P;  // [n][p]: h_{c-1}, then g_c
  float* sCum = sHG + MAX_N * MAX_P;
  float* sDt = sCum + MAX_L;
  float* sS = sDt + MAX_L;  // row scales: exp(cum_i), then exp(cL - cum_j) dt_j
  float* sRed = sS + MAX_L;  // per-warp sums

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
  const int r0 = 16 * warp;  // this warp's rows, in both passes
  const bool rows = r0 < a.Lp;
  const int ra = r0 + gq, rb = ra + 8;  // this thread's two rows
  const long long rbt = r * a.Bt + bt;
  const float* Bm = static_cast<const float*>(a.b) + r * a.bs0 +
                    bt * a.bs1 + g * a.bs3 + s0 * a.bs2;
  const float* Cm = static_cast<const float*>(a.c) + r * a.cs0 +
                    bt * a.cs1 + g * a.cs3 + s0 * a.cs2;
  stage(Cm, a.cs2, a.L, a.Lp, a.N, a.Np, sC, MAX_N, tid);
  stage(Bm, a.bs2, a.L, a.Lp, a.N, a.Np, sB, MAX_N, tid);

  // one head's x, dy, cum, dt and state (h_{c-1} or g_c) into shared memory
  auto load_head = [&](int h, const float* state) {
    const long long rbh = rbt * a.H + h;
    stage(static_cast<const float*>(a.x) + r * a.xs0 + bt * a.xs1 +
              h * a.xs3 + s0 * a.xs2,
          a.xs2, a.L, a.Lp, a.P, a.Pp, sX, MAX_P, tid);
    stage(a.dy + (rbt * a.S + s0) * a.H * a.P +
              static_cast<long long>(h) * a.P,
          static_cast<long long>(a.H) * a.P, a.L, a.Lp, a.P, a.Pp, sDy, MAX_P,
          tid);
    stage(state + (rbh * a.nc + c) * a.N * a.P, a.P, a.N, a.Np, a.P, a.Pp,
          sHG, MAX_P, tid);
    for (int i = tid; i < a.Lp; i += THREADS) {
      sCum[i] = i < a.L ? a.cum[rbh * a.S + s0 + i] : 0.f;
      sDt[i] = i < a.L ? a.dt[r * a.ds0 + bt * a.ds1 + h * a.ds3 +
                              (s0 + i) * a.ds2]
                       : 0.f;
    }
  };

  // ---- rows-i pass: dC, and each row's dcum less the column terms ----
  float dC[MAX_N / 8][4];
#pragma unroll
  for (int t = 0; t < MAX_N / 8; ++t) dC[t][0] = dC[t][1] = dC[t][2] = dC[t][3] = 0.f;
  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = rbt * a.H + h;
    __syncthreads();  // the last head is done with the head's tiles
    load_head(h, a.states);
    __syncthreads();
    for (int i = tid; i < a.Lp; i += THREADS)
      sS[i] = i < a.L ? expf(sCum[i]) : 0.f;
    __syncthreads();
    if (!rows) continue;
    const float cum_a = ra < a.L ? sCum[ra] : 0.f;
    const float cum_b = rb < a.L ? sCum[rb] : 0.f;
    float part_a = 0.f, part_b = 0.f;  // sum_{j<i} W_ij of rows ra, rb
    for (int kt = 0; kt <= warp; ++kt) {  // column tiles with 16 kt <= i
      bool live = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? rb : ra;
        const float cr = (q & 1) ? cum_b : cum_a;
        const int j = 16 * kt + 8 * (q >> 1) + 2 * cq;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          live |= j + e <= row && row < a.L &&
                  !(cr - sCum[j + e] < EXP_ZERO);
      }
      if (!__any_sync(FULL, live)) continue;
      float cb[2][4], m[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[t][e] = m[t][e] = 0.f;
      for (int k0 = 0; k0 < a.Np; k0 += 16) {  // C_i . B_j over n
        uint32_t af[3][4];
        frag_a<3>(af, sC, MAX_N, 1, r0, k0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bf[3][2];
          frag_b<3>(bf, sB, 1, MAX_N, k0, 16 * kt + 8 * nt, lane);
          mma_t<3, 3>(cb[nt], af, bf);
        }
      }
      for (int k0 = 0; k0 < a.Pp; k0 += 16) {  // dy_i . x_j over p
        uint32_t af[3][4];
        frag_a<3>(af, sDy, MAX_P, 1, r0, k0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bf[3][2];
          frag_b<3>(bf, sX, 1, MAX_P, k0, 16 * kt + 8 * nt, lane);
          mma_t<3, 3>(m[nt], af, bf);
        }
      }
      float z[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (e >> 1) ? rb : ra;
          const int j = 16 * kt + 8 * nt + 2 * cq + (e & 1);
          float zz = 0.f;
          if (j <= row && row < a.L) {
            const float cr = (e >> 1) ? cum_b : cum_a;
            zz = expf(cr - sCum[j]) * sDt[j] * m[nt][e];
            if (j < row) {
              if (e >> 1)
                part_b += cb[nt][e] * zz;
              else
                part_a += cb[nt][e] * zz;
            }
          }
          z[nt][e] = zz;
        }
      uint32_t zf[3][4];
      acc_to_a<3>(zf, z);
#pragma unroll
      for (int nt = 0; nt < MAX_N / 8; ++nt) {  // dC_i += Z_ij B_j
        if (8 * nt >= a.Np) continue;
        uint32_t bf[3][2];
        frag_b<3>(bf, sB, MAX_N, 1, 16 * kt, 8 * nt, lane);
        mma_add<3, 3>(dC[nt], zf, bf);
      }
    }
    part_a = row_sum(part_a);
    part_b = row_sum(part_b);
    // the inter-chunk term: exp(cum_i) C_i h_{c-1}; a warp whose rows'
    // exp(cum_i) are all 0 takes no product (it adds exactly 0)
    float yi_a = 0.f, yi_b = 0.f;
    const bool inter =
        __any_sync(FULL, (ra < a.L && !(cum_a < EXP_ZERO)) ||
                             (rb < a.L && !(cum_b < EXP_ZERO)));
    if (inter) {
      float yv[MAX_P / 8][4];
#pragma unroll
      for (int t = 0; t < MAX_P / 8; ++t) yv[t][0] = yv[t][1] = yv[t][2] = yv[t][3] = 0.f;
      for (int k0 = 0; k0 < a.Np; k0 += 16) {  // C_i h_{c-1} over n
        uint32_t af[3][4];
        frag_a<3>(af, sC, MAX_N, 1, r0, k0, lane);
#pragma unroll
        for (int pt = 0; pt < MAX_P / 8; ++pt) {
          if (8 * pt >= a.Pp) continue;
          uint32_t bf[3][2];
          frag_b<3>(bf, sHG, MAX_P, 1, k0, 8 * pt, lane);
          mma_add<3, 3>(yv[pt], af, bf);
        }
      }
#pragma unroll
      for (int pt = 0; pt < MAX_P / 8; ++pt) {
        if (8 * pt >= a.Pp) continue;  // columns past Pp are not staged
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * pt + 2 * cq + e;
          yi_a += yv[pt][e] * sDy[ra * MAX_P + p];
          yi_b += yv[pt][2 + e] * sDy[rb * MAX_P + p];
        }
      }
      yi_a = row_sum(yi_a);
      yi_b = row_sum(yi_b);
      for (int k0 = 0; k0 < a.Pp; k0 += 16) {  // dC_i += exp(cum_i) dy_i h^T
        uint32_t af[3][4];
        frag_a<3>(af, sDy, MAX_P, 1, r0, k0, lane, sS);
#pragma unroll
        for (int nt = 0; nt < MAX_N / 8; ++nt) {
          if (8 * nt >= a.Np) continue;
          uint32_t bf[3][2];
          frag_b<3>(bf, sHG, 1, MAX_P, k0, 8 * nt, lane);
          mma_add<3, 3>(dC[nt], af, bf);
        }
      }
    }
    if (cq == 0) {
      float* DC = a.dcum + rbh * a.S + s0;
      if (ra < a.L) DC[ra] = part_a + sS[ra] * yi_a;
      if (rb < a.L) DC[rb] = part_b + sS[rb] * yi_b;
    }
  }
  const long long orow = static_cast<long long>(a.G) * a.N;  // dB, dC rows
  if (rows) {
    float* DCo = static_cast<float*>(a.dc) + (rbt * a.S + s0) * orow +
                 static_cast<long long>(g) * a.N;
#pragma unroll
    for (int nt = 0; nt < MAX_N / 8; ++nt) {
      const int n = 8 * nt + 2 * cq;
      if (n >= a.N) continue;
      if (ra < a.L) store2<float>(DCo + ra * orow + n, dC[nt][0], dC[nt][1]);
      if (rb < a.L) store2<float>(DCo + rb * orow + n, dC[nt][2], dC[nt][3]);
    }
  }

  // ---- rows-j pass: dx, dB, the column terms of dcum, the direct ddt ----
  float dB[MAX_N / 8][4];
#pragma unroll
  for (int t = 0; t < MAX_N / 8; ++t) dB[t][0] = dB[t][1] = dB[t][2] = dB[t][3] = 0.f;
  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = rbt * a.H + h;
    __syncthreads();  // the last head is done with the head's tiles, sRed
    load_head(h, a.grad);
    __syncthreads();
    const float cl = sCum[a.L - 1];
    for (int j = tid; j < a.Lp; j += THREADS)
      sS[j] = j < a.L ? expf(cl - sCum[j]) * sDt[j] : 0.f;
    // the hand-off's term <h_{c-1}, g_c>: a fixed share per thread, then a
    // fixed butterfly in each warp
    {
      const float* HP = a.states + (rbh * a.nc + c) * a.N * a.P;
      float hd = 0.f;
      for (int e = tid; e < a.N * a.P; e += THREADS) {
        const int n = e / a.P;
        hd += HP[e] * sHG[n * MAX_P + (e - n * a.P)];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) hd += __shfl_xor_sync(FULL, hd, o);
      if (lane == 0) sRed[warp] = hd;
    }
    __syncthreads();
    float ssum = 0.f;  // sum of s_j over this warp's rows
    if (rows) {
      const float cum_a = ra < a.L ? sCum[ra] : 0.f;
      const float cum_b = rb < a.L ? sCum[rb] : 0.f;
      float dxa[MAX_P / 8][4];
#pragma unroll
      for (int t = 0; t < MAX_P / 8; ++t) dxa[t][0] = dxa[t][1] = dxa[t][2] = dxa[t][3] = 0.f;
      float col_a = 0.f, col_b = 0.f;  // sum_{i>j} W_ij of rows ra, rb
      float dd_a = 0.f, dd_b = 0.f;    // sum_{i>=j} (C_i . B_j) D_ij M_ij
      for (int it = warp; 16 * it < a.Lp; ++it) {  // tiles with i >= j
        bool live = false;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = (q & 1) ? rb : ra;
          const float cr = (q & 1) ? cum_b : cum_a;
          const int i = 16 * it + 8 * (q >> 1) + 2 * cq;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            live |= row <= i + e && i + e < a.L &&
                    !(sCum[i + e] - cr < EXP_ZERO);
        }
        if (!__any_sync(FULL, live)) continue;
        float bc[2][4], mt[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) bc[t][e] = mt[t][e] = 0.f;
        for (int k0 = 0; k0 < a.Np; k0 += 16) {  // B_j . C_i over n
          uint32_t af[3][4];
          frag_a<3>(af, sB, MAX_N, 1, r0, k0, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t bf[3][2];
            frag_b<3>(bf, sC, 1, MAX_N, k0, 16 * it + 8 * nt, lane);
            mma_t<3, 3>(bc[nt], af, bf);
          }
        }
        for (int k0 = 0; k0 < a.Pp; k0 += 16) {  // x_j . dy_i over p
          uint32_t af[3][4];
          frag_a<3>(af, sX, MAX_P, 1, r0, k0, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t bf[3][2];
            frag_b<3>(bf, sDy, 1, MAX_P, k0, 16 * it + 8 * nt, lane);
            mma_t<3, 3>(mt[nt], af, bf);
          }
        }
        float u[2][4], z[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e >> 1) ? rb : ra;
            const int i = 16 * it + 8 * nt + 2 * cq + (e & 1);
            float uu = 0.f, zz = 0.f;
            if (row <= i && i < a.L) {
              const float cr = (e >> 1) ? cum_b : cum_a;
              const float d = expf(sCum[i] - cr);
              uu = bc[nt][e] * d;
              zz = d * sDt[row] * mt[nt][e];
              const float dd = uu * mt[nt][e];
              const float w = row < i ? bc[nt][e] * zz : 0.f;
              if (e >> 1) {
                dd_b += dd;
                col_b += w;
              } else {
                dd_a += dd;
                col_a += w;
              }
            }
            u[nt][e] = uu;
            z[nt][e] = zz;
          }
        uint32_t uf[3][4], zf[3][4];
        acc_to_a<3>(uf, u);
        acc_to_a<3>(zf, z);
#pragma unroll
        for (int pt = 0; pt < MAX_P / 8; ++pt) {  // dx_j += u_ji dy_i
          if (8 * pt >= a.Pp) continue;
          uint32_t bf[3][2];
          frag_b<3>(bf, sDy, MAX_P, 1, 16 * it, 8 * pt, lane);
          mma_add<3, 3>(dxa[pt], uf, bf);
        }
#pragma unroll
        for (int nt = 0; nt < MAX_N / 8; ++nt) {  // dB_j += Z_ij C_i
          if (8 * nt >= a.Np) continue;
          uint32_t bf[3][2];
          frag_b<3>(bf, sC, MAX_N, 1, 16 * it, 8 * nt, lane);
          mma_add<3, 3>(dB[nt], zf, bf);
        }
      }
      col_a = row_sum(col_a);
      col_b = row_sum(col_b);
      dd_a = row_sum(dd_a);
      dd_b = row_sum(dd_b);
      // the state term: V_j = B_j g_c, q_j = V_j . x_j, and dB_j +=
      // exp(cL - cum_j) dt_j x_j g_c^T; rows whose decay to the chunk's end
      // is 0 add exactly 0
      float v[MAX_P / 8][4];
#pragma unroll
      for (int t = 0; t < MAX_P / 8; ++t) v[t][0] = v[t][1] = v[t][2] = v[t][3] = 0.f;
      float q_a = 0.f, q_b = 0.f;
      const bool reach =
          __any_sync(FULL, (ra < a.L && !(cl - cum_a < EXP_ZERO)) ||
                               (rb < a.L && !(cl - cum_b < EXP_ZERO)));
      if (reach) {
        for (int k0 = 0; k0 < a.Np; k0 += 16) {
          uint32_t af[3][4];
          frag_a<3>(af, sB, MAX_N, 1, r0, k0, lane);
#pragma unroll
          for (int pt = 0; pt < MAX_P / 8; ++pt) {
            if (8 * pt >= a.Pp) continue;
            uint32_t bf[3][2];
            frag_b<3>(bf, sHG, MAX_P, 1, k0, 8 * pt, lane);
            mma_add<3, 3>(v[pt], af, bf);
          }
        }
#pragma unroll
        for (int pt = 0; pt < MAX_P / 8; ++pt) {
          if (8 * pt >= a.Pp) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = 8 * pt + 2 * cq + e;
            q_a += v[pt][e] * sX[ra * MAX_P + p];
            q_b += v[pt][2 + e] * sX[rb * MAX_P + p];
          }
        }
        q_a = row_sum(q_a);
        q_b = row_sum(q_b);
        for (int k0 = 0; k0 < a.Pp; k0 += 16) {
          uint32_t af[3][4];
          frag_a<3>(af, sX, MAX_P, 1, r0, k0, lane, sS);
#pragma unroll
          for (int nt = 0; nt < MAX_N / 8; ++nt) {
            if (8 * nt >= a.Np) continue;
            uint32_t bf[3][2];
            frag_b<3>(bf, sHG, 1, MAX_P, k0, 8 * nt, lane);
            mma_add<3, 3>(dB[nt], af, bf);
          }
        }
      }
      const float dt_a = sDt[ra], dt_b = sDt[rb];  // 0 past the chunk
      const float de_a = ra < a.L ? expf(cl - cum_a) : 0.f;
      const float de_b = rb < a.L ? expf(cl - cum_b) : 0.f;
      float* DX = static_cast<float*>(a.dx) +
                  (rbt * a.S + s0) * a.H * a.P +
                  static_cast<long long>(h) * a.P;
      const long long xrow = static_cast<long long>(a.H) * a.P;
#pragma unroll
      for (int pt = 0; pt < MAX_P / 8; ++pt) {
        const int p = 8 * pt + 2 * cq;
        if (p >= a.P) continue;
        if (ra < a.L)
          store2<float>(DX + ra * xrow + p,
                        dt_a * (dxa[pt][0] + de_a * v[pt][0]),
                        dt_a * (dxa[pt][1] + de_a * v[pt][1]));
        if (rb < a.L)
          store2<float>(DX + rb * xrow + p,
                        dt_b * (dxa[pt][2] + de_b * v[pt][2]),
                        dt_b * (dxa[pt][3] + de_b * v[pt][3]));
      }
      const float s_a = de_a * dt_a * q_a, s_b = de_b * dt_b * q_b;
      if (cq == 0) {
        float* DC = a.dcum + rbh * a.S + s0;
        float* DD = a.ddtd + rbh * a.S + s0;
        if (ra < a.L) {
          DC[ra] = DC[ra] - col_a - s_a;
          DD[ra] = dd_a + de_a * q_a;
        }
        if (rb < a.L) {
          DC[rb] = DC[rb] - col_b - s_b;
          DD[rb] = dd_b + de_b * q_b;
        }
      }
      // over the warp's rows: the four lanes of a row hold the same s
      ssum = s_a + s_b;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) ssum += __shfl_xor_sync(FULL, ssum, o);
    }
    if (lane == 0) sRed[8 + warp] = ssum;
    __syncthreads();
    if (tid == 0) {
      float hsum = 0.f, s = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) {
        hsum += sRed[w];
        s += sRed[8 + w];
      }
      a.tail[rbh * a.nc + c] = s + expf(cl) * hsum;
    }
  }
  if (rows) {
    float* DBo = static_cast<float*>(a.db) + (rbt * a.S + s0) * orow +
                 static_cast<long long>(g) * a.N;
#pragma unroll
    for (int nt = 0; nt < MAX_N / 8; ++nt) {
      const int n = 8 * nt + 2 * cq;
      if (n >= a.N) continue;
      if (ra < a.L) store2<float>(DBo + ra * orow + n, dB[nt][0], dB[nt][1]);
      if (rb < a.L) store2<float>(DBo + rb * orow + n, dB[nt][2], dB[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------
// b4: ddt and the dA partials, one thread per (rank, batch, chunk, head)
// ---------------------------------------------------------------------

// The f32 route's: the rows of a chunk in order, one thread.  The bf16
// route's ssd_bwd_dt_bf16 (a warp a chunk) adds the same terms in another
// order, so its ddt and dA differ from this one's in the last bits; f32
// calls keep this order, and so the results they gave before the bf16
// route had kernels of its own.

__global__ void __launch_bounds__(THREADS) ssd_bwd_dt_kernel(const BwdArgs a) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= static_cast<long long>(a.R) * a.Bt * a.nc * a.H) return;
  const int h = static_cast<int>(e % a.H);
  long long rest = e / a.H;
  const int c = static_cast<int>(rest % a.nc);
  rest /= a.nc;
  const int bt = static_cast<int>(rest % a.Bt);
  const long long r = rest / a.Bt;
  const long long rbh = (r * a.Bt + bt) * a.H + h;
  const long long s0 = static_cast<long long>(c) * a.L;
  const float A = a.a[r * a.as0 + h * a.as1];
  const float* DC = a.dcum + rbh * a.S + s0;
  const float* DD = a.ddtd + rbh * a.S + s0;
  float* DT = a.ddt + ((r * a.Bt + bt) * a.S + s0) * a.H + h;
  const float* dt = a.dt + r * a.ds0 + bt * a.ds1 + h * a.ds3 + s0 * a.ds2;
  float rc = a.tail[rbh * a.nc + c], da = 0.f;
  for (int j = a.L - 1; j >= 0; --j) {
    rc += DC[j];  // the sum of dcum over rows >= j
    DT[static_cast<long long>(j) * a.H] = DD[j] + rc * A;
    da += rc * dt[j * a.ds2];
  }
  a.dapart[((r * a.H + h) * a.Bt + bt) * a.nc + c] = da;
}

// b5: dA, one thread per (rank, head)
__global__ void __launch_bounds__(THREADS) ssd_bwd_da_kernel(const BwdArgs a) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= static_cast<long long>(a.R) * a.H) return;
  const float* part = a.dapart + e * a.Bt * a.nc;
  float da = 0.f;
  for (long long k = 0; k < static_cast<long long>(a.Bt) * a.nc; ++k)
    da += part[k];
  a.da[e] = da;
}

unsigned blocks_of(long long threads) {
  return static_cast<unsigned>((threads + THREADS - 1) / THREADS);
}

// ---------------------------------------------------------------------
// The bf16 route (x, B, C in bf16; dy and the states f32): term planes,
// ldmatrix fragments, wgmma for the chunk-state products
// ---------------------------------------------------------------------

namespace bfr {

using bf16 = __nv_bfloat16;

constexpr uint32_t ROW = 128;            // bytes of a tile row: 64 bf16
constexpr uint32_t TILE = MAX_L * ROW;   // 128 rows x 64 columns, 16 KB


// Byte offset of element (row, col) of a tile of 128-byte rows, 128-byte
// swizzled as wgmma reads it (16-byte chunk c of row r lies at chunk
// c ^ (r % 8) of its row; the tile starts 1024-byte aligned); columns 64
// on lie in a second tile TILE bytes on
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return static_cast<uint32_t>(col >> 6) * TILE + row * ROW +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// Where the grads kernel stores row `row` of the chunk's tiles (C, B, x
// and dy's planes): 16-row blocks 4 .. 7 in reverse.  Warp w + 4 (w < 4)
// owns the wgmma rows of stored block 4 + w, which so hold logical block 7
// - w; with warp w on logical block w, the warps that share an SM
// sub-partition (w and w + 4) take 9 of the triangle's 36 tiles a pass
// between them, where blocks in order would give one 12 and another 6.
__device__ __forceinline__ int prow(int row) {
  return row < 64 ? row : ((11 - (row >> 4)) << 4) | (row & 15);
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The m16n8k16 fragments (layouts above frag_a) by ldmatrix.x4, lane l
// addressing row l % 8 of matrix l / 8.  A at (m0, k0) of a tile stored
// [m][k]:
__device__ __forceinline__ void lda(uint32_t (&f)[4], uint32_t tile, int m0,
                                    int k0, int lane) {
  const int q = lane >> 3;
  ldsm(f, tile + swz(m0 + (lane & 7) + 8 * (q & 1), k0 + 8 * (q >> 1)));
}

// A at (m0, k0) of a tile stored [k][m]
__device__ __forceinline__ void lda_t(uint32_t (&f)[4], uint32_t tile,
                                      int m0, int k0, int lane) {
  const int q = lane >> 3;
  ldsm_t(f, tile + swz(k0 + (lane & 7) + 8 * (q >> 1), m0 + 8 * (q & 1)));
}

// B at k0 of columns n0 .. n0 + 7 (f0, f1) and n0 + 8 .. n0 + 15 (f2, f3)
// of a tile stored [n][k]
__device__ __forceinline__ void ldb(uint32_t (&f)[4], uint32_t tile, int k0,
                                    int n0, int lane) {
  const int q = lane >> 3;
  ldsm(f, tile + swz(n0 + (lane & 7) + 8 * (q >> 1), k0 + 8 * (q & 1)));
}

// the same of a tile stored [k][n]
__device__ __forceinline__ void ldb_t(uint32_t (&f)[4], uint32_t tile,
                                      int k0, int n0, int lane) {
  const int q = lane >> 3;
  ldsm_t(f, tile + swz(k0 + (lane & 7) + 8 * (q & 1), n0 + 8 * (q >> 1)));
}

// the B fragments of four column tiles, n0 .. n0 + 31, at k0 of TT term
// planes (TILE bytes apart) stored [k][n]
template <int TT>
__device__ __forceinline__ void ldb_t4(uint32_t (&b)[TT][4][2], uint32_t tile,
                                       int k0, int n0, int lane) {
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t f[4];
      ldb_t(f, tile + t * TILE, k0, n0 + 16 * q, lane);
      b[t][2 * q][0] = f[0];
      b[t][2 * q][1] = f[1];
      b[t][2 * q + 1][0] = f[2];
      b[t][2 * q + 1][1] = f[3];
    }
}

// split<3> of two values at once, as bf16 pairs (v0 in the low half): one
// conversion a term for both
__device__ __forceinline__ void split2(float v0, float v1, uint32_t (&w)[3]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    w[t] = *reinterpret_cast<const uint32_t*>(&p);
    v0 = __fsub_rn(v0, __low2float(p));
    v1 = __fsub_rn(v1, __high2float(p));
  }
}

// acc_to_a<3> by split2
__device__ __forceinline__ void acc_to_a3(uint32_t (&f)[3][4],
                                          const float (&v)[2][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t w[3];
    split2(v[q >> 1][2 * (q & 1)], v[q >> 1][2 * (q & 1) + 1], w);
#pragma unroll
    for (int t = 0; t < 3; ++t) f[t][q] = w[t];
  }
}

// eight f32 values as three bf16 term vectors (hi, mid, lo; split<3>)
__device__ __forceinline__ void split8(const float (&v)[8], uint4 (&o)[3]) {
  uint32_t w[3][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t p[3];
    split2(v[2 * q], v[2 * q + 1], p);
#pragma unroll
    for (int t = 0; t < 3; ++t) w[t][q] = p[t];
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) o[t] = make_uint4(w[t][0], w[t][1], w[t][2], w[t][3]);
}

// the two bf16 values of a fragment register as f32 (the lower k first)
__device__ __forceinline__ float2 bf2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// sum += the row's values of `v` (a 64-column wgmma accumulator, rows ra
// and rb of this thread) times the tile's values at the same places,
// read as the A fragments of the tile's TT term planes (A's register q of
// k-step kq holds column tile 2 kq + q / 2 of row ra (q even) or rb), a
// value rebuilt from its terms as (hi + mid) + lo, exactly split8's input
template <int TT>
__device__ __forceinline__ void row_dots(float& s_a, float& s_b,
                                         const float (&v)[32], uint32_t tile,
                                         int p0, int Pp, int lane) {
#pragma unroll
  for (int kq = 0; kq < MAX_P / 16; ++kq) {
    if (16 * kq >= Pp) continue;
    uint32_t f[TT][4];
#pragma unroll
    for (int t = 0; t < TT; ++t) lda(f[t], tile + t * TILE, p0, 16 * kq, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // column tile 2 kq + h
      float2 xa = bf2(f[0][2 * h]), xb = bf2(f[0][2 * h + 1]);
#pragma unroll
      for (int t = 1; t < TT; ++t) {
        const float2 ya = bf2(f[t][2 * h]), yb = bf2(f[t][2 * h + 1]);
        xa.x += ya.x;
        xa.y += ya.y;
        xb.x += yb.x;
        xb.y += yb.y;
      }
      const int pt = 2 * kq + h;
      s_a += v[4 * pt] * xa.x;
      s_b += v[4 * pt + 2] * xb.x;
      s_a += v[4 * pt + 1] * xa.y;
      s_b += v[4 * pt + 3] * xb.y;
    }
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes of global memory (16-byte aligned) into shared memory at `dst`,
// asynchronously (cp.async, through L2); cp_async_wait waits for the
// calling thread's copies
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// `bytes` (a multiple of 16) of global memory at `src` (16-byte aligned)
// into L2, by one thread
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [0, rows) of `bytes` (a multiple of 16) each, row i at src + i *
// ld_bytes, into shared memory at dst + i * pitch, by the block's threads
__device__ __forceinline__ void cp_async_rows(uint32_t dst, uint32_t pitch,
                                              const void* src,
                                              long long ld_bytes, int rows,
                                              int bytes, int tid) {
  const int cpr = bytes / 16;
  for (int v = tid; v < rows * cpr; v += THREADS) {
    const int i = v / cpr, ch = v - i * cpr;
    cp_async16(dst + i * pitch + 16 * ch,
               static_cast<const unsigned char*>(src) + i * ld_bytes +
                   16 * ch);
  }
}

// whether p holds on any thread of warpgroup wg (its 128 threads all call)
__device__ __forceinline__ bool wg_any(bool p, int wg) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred a, b;\n"
      "setp.ne.u32 a, %1, 0;\n"
      "bar.red.or.pred b, %2, 128, a;\n"
      "selp.u32 %0, 1, 0, b;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(p)), "r"(wg + 1)
      : "memory");
  return r != 0;
}

// d (64 x 64) {+}= A (64 x 16, K-major) . B (16 x 64, MN-major), both in
// shared memory; acc 0 overwrites d
__device__ __forceinline__ void wgmma_n64_t(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128) {+}= A (64 x 16) . B (16 x 128), both K-major in shared
// memory; acc 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// K-major operand rows of a 128-byte-swizzled tile at k-step kk (16 deep):
// 32 bytes a k-step, the next 64 columns a tile on
__device__ __forceinline__ uint64_t desc_k(uint32_t rows, int kk) {
  return hopper::desc_sw128(rows + (kk >> 2) * TILE + (kk & 3) * 32, 16,
                            1024);
}

// out (this warpgroup's 64 rows x 64 head columns) = A . S over the 128
// state rows: A (C or B) K-major at `arow`, S (h_{c-1} or g_c) the three
// term planes at `planes`, read MN-major.  One chain over the whole depth,
// its terms smallest first, inside the tensor cores from a zeroed
// accumulator (the header says why one chain is enough).  The wgmmas are
// issued four at a time, their descriptors computed ahead of each four.
__device__ __forceinline__ void rows_state(float (&out)[32], uint32_t arow,
                                           uint32_t planes) {
  constexpr int BATCH = 4;
#pragma unroll
  for (int term = 2; term >= 0; --term)
#pragma unroll
    for (int b0 = 0; b0 < MAX_N / 16; b0 += BATCH) {
      uint64_t da[BATCH], db[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        da[i] = desc_k(arow, b0 + i);
        db[i] = hopper::desc_sw128(
            planes + term * TILE + (b0 + i) * 16 * ROW, 64 * ROW, 1024);
      }
      hopper::fence_regs(da);
      hopper::fence_regs(db);
      hopper::fence_regs(out);
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        wgmma_n64_t(out, da[i], db[i], term != 2 || b0 + i > 0);
      hopper::wgmma_commit();
    }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(out);
}

// acc (this warpgroup's 64 rows x 128 state columns, in mma.sync tiles)
// += s_row (A . S^T) over the 64 head columns: A's TA term planes K-major
// at `arow` (dy: three; x: one, exact in bf16), S's three planes K-major;
// the products of order <= 2, smallest first, in one chain over the whole
// depth from a zeroed accumulator, its sum scaled by its row's s and added
// to acc by IEEE adds
template <int TA>
__device__ __forceinline__ void rows_head(float (&acc)[MAX_N / 8][4],
                                          float s_a, float s_b, uint32_t arow,
                                          uint32_t planes) {
  constexpr int K = MAX_P / 16;  // k-steps
  float t[64];
#pragma unroll
  for (int order = 2; order >= 0; --order)
#pragma unroll
    for (int ia = 0; ia < TA; ++ia) {
      const int ib = order - ia;
      if (ib < 0 || ib >= 3) continue;
      const bool first = order == 2 && ia == 0;
      uint64_t da[K], db[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        da[i] = desc_k(arow + ia * TILE, i);
        db[i] = desc_k(planes + ib * TILE, i);
      }
      hopper::fence_regs(da);
      hopper::fence_regs(db);
      hopper::fence_regs(t);
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < K; ++i) wgmma_n128(t, da[i], db[i], !first || i > 0);
      hopper::wgmma_commit();
    }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(t);
#pragma unroll
  for (int nt = 0; nt < MAX_N / 8; ++nt) {
    acc[nt][0] += s_a * t[4 * nt];
    acc[nt][1] += s_a * t[4 * nt + 1];
    acc[nt][2] += s_b * t[4 * nt + 2];
    acc[nt][3] += s_b * t[4 * nt + 3];
  }
}

// Rows [0, 128) x columns [0, 128) of a row-major bf16 global tile (row
// stride ld; rows >= rows or columns >= cols read as 0) into a swizzled
// tile at `s` (two tiles of 64 columns), its rows where prow puts them
// when `permuted`
__device__ __forceinline__ void stage_bf16(const bf16* g, long long ld,
                                           int rows, int cols,
                                           unsigned char* s, int tid,
                                           bool permuted) {
  constexpr int CHUNKS = MAX_N / 8;  // of 8 bf16 a row
  for (int v = tid; v < MAX_L * CHUNKS; v += THREADS) {
    const int row = v / CHUNKS, ch = v - row * CHUNKS;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row < rows && 8 * ch < cols)
      u = *reinterpret_cast<const uint4*>(g + row * ld + 8 * ch);
    *reinterpret_cast<uint4*>(s + swz(permuted ? prow(row) : row, 8 * ch)) =
        u;
  }
}

// A (rows x cols) f32 tile (row stride ld, cols a multiple of 8) into the
// three term planes at `s`, 128 rows x 64 columns, zero past the tile;
// the global loads of a thread's four chunks are issued first.  With
// `other` (a tile of the same shape and stride), returns this thread's
// share of <tile, other>: its chunks in order, each left to right.
__device__ __forceinline__ float stage_planes(const float* g, long long ld,
                                              int rows, int cols,
                                              unsigned char* s, int tid,
                                              const float* other = nullptr) {
  constexpr int IT = MAX_L * 8 / THREADS;
  float v[IT][8], dot = 0.f;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int w = tid + it * THREADS, row = w >> 3, ch = w & 7;
    float4 f0 = make_float4(0.f, 0.f, 0.f, 0.f), f1 = f0;
    if (row < rows && 8 * ch < cols) {
      const float4* p =
          reinterpret_cast<const float4*>(g + row * ld + 8 * ch);
      f0 = p[0];
      f1 = p[1];
    }
    v[it][0] = f0.x; v[it][1] = f0.y; v[it][2] = f0.z; v[it][3] = f0.w;
    v[it][4] = f1.x; v[it][5] = f1.y; v[it][6] = f1.z; v[it][7] = f1.w;
  }
  if (other != nullptr) {
    float o[IT][8];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int w = tid + it * THREADS, row = w >> 3, ch = w & 7;
      float4 f0 = make_float4(0.f, 0.f, 0.f, 0.f), f1 = f0;
      if (row < rows && 8 * ch < cols) {
        const float4* p =
            reinterpret_cast<const float4*>(other + row * ld + 8 * ch);
        f0 = p[0];
        f1 = p[1];
      }
      o[it][0] = f0.x; o[it][1] = f0.y; o[it][2] = f0.z; o[it][3] = f0.w;
      o[it][4] = f1.x; o[it][5] = f1.y; o[it][6] = f1.z; o[it][7] = f1.w;
    }
#pragma unroll
    for (int it = 0; it < IT; ++it)
#pragma unroll
      for (int q = 0; q < 8; ++q) dot += v[it][q] * o[it][q];
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int w = tid + it * THREADS, row = w >> 3, ch = w & 7;
    uint4 o[3];
    split8(v[it], o);
#pragma unroll
    for (int t = 0; t < 3; ++t)
      *reinterpret_cast<uint4*>(s + t * TILE + swz(row, 8 * ch)) = o[t];
  }
  return dot;
}

// The triangle's two products of a 16 x 16 tile, its rows at r0 of tile
// RA (K-major over the state) and its columns at c0 of tile RB: cb = RA .
// RB^T over n, and m = XA . XB^T over p, where the dy operand (XA when not
// J, else XB) is three term planes and the other is x; each a chain of
// mma.sync from a zeroed accumulator, the terms smallest first (mma_t),
// cb's and m's k-steps interleaved so that their four chains overlap
template <bool J>
__device__ __forceinline__ void tile_products(float (&cb)[2][4],
                                              float (&m)[2][4], uint32_t ra_,
                                              uint32_t rb_, uint32_t xa,
                                              uint32_t xb, int r0, int c0,
                                              int Np, int Pp, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[n][e] = m[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MAX_N / 16; ++kk) {
    if (16 * kk < Np) {
      uint32_t af[4], f[4];
      lda(af, ra_, r0, 16 * kk, lane);
      ldb(f, rb_, 16 * kk, c0, lane);
      mma(cb[0], af, f[0], f[1]);
      mma(cb[1], af, f[2], f[3]);
    }
    if (kk < MAX_P / 16 && 16 * kk < Pp) {
      if (J) {  // x_j . dy_i: x one term, dy's three as B
        uint32_t af[4];
        lda(af, xa, r0, 16 * kk, lane);
#pragma unroll
        for (int t = 2; t >= 0; --t) {
          uint32_t f[4];
          ldb(f, xb + t * TILE, 16 * kk, c0, lane);
          mma(m[0], af, f[0], f[1]);
          mma(m[1], af, f[2], f[3]);
        }
      } else {  // dy_i . x_j: dy's three terms as A
        uint32_t f[4];
        ldb(f, xb, 16 * kk, c0, lane);
#pragma unroll
        for (int t = 2; t >= 0; --t) {
          uint32_t af[4];
          lda(af, xa + t * TILE, r0, 16 * kk, lane);
          mma(m[0], af, f[0], f[1]);
          mma(m[1], af, f[2], f[3]);
        }
      }
    }
  }
}

// acc (16 rows x the state's 128 columns) += Z . S, Z a 16 x 16 A operand
// in three terms, S rows k0 .. k0 + 15 of a tile stored [k][n] (B or C):
// mma_add's arithmetic (a zeroed temporary per 8 columns takes the
// products smallest first, then an IEEE add), four column tiles' chains
// interleaved at a time
__device__ __forceinline__ void add_zt(float (&acc)[MAX_N / 8][4],
                                       const uint32_t (&zf)[3][4],
                                       uint32_t tile, int k0, int Np,
                                       int lane) {
#pragma unroll
  for (int qt = 0; qt < MAX_N / 32; ++qt) {
    if (32 * qt >= Np) continue;
    uint32_t b[1][4][2];
    ldb_t4<1>(b, tile, k0, 32 * qt, lane);
    float t[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
#pragma unroll
    for (int o = 2; o >= 0; --o)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(t[n], zf[o], b[0][n][0], b[0][n][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * qt + n][e] += t[n][e];
  }
}

// ---- b1: U_c = C^T (exp(cum) o dy) ------------------------------------

// tiles: C (two), dy's three planes, the landing area (dy's raw rows, two
// tiles), then exp(cum) of the chunk's rows.  No wgmma reads them, so the
// swizzle (against ldmatrix's bank conflicts) needs no 1024-byte
// alignment, and two blocks fit an SM.
constexpr uint32_t U_OFF_LDY = 5 * TILE, U_OFF_EC = 7 * TILE;
constexpr size_t U_BYTES = U_OFF_EC + 4 * MAX_L;

__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_u_bf16(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw;
  const uint32_t sa = hopper::smem_u32(smem_raw);
  const uint32_t aC = sa, aDY = sa + 2 * TILE;
  float* sEc = reinterpret_cast<float*>(sm + U_OFF_EC);

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
  const long long rbt = r * a.Bt + bt;
  // head hh's dy rows into the landing area (cp.async) and, into a
  // register of thread i < L, cum_i: both land while the last head computes
  auto issue = [&](int hh, float& cn) {
    const int h = g * hpg + hh;
    cp_async_rows(sa + U_OFF_LDY, 2 * ROW,
                  a.dy + (rbt * a.S + s0) * a.H * a.P +
                      static_cast<long long>(h) * a.P,
                  static_cast<long long>(a.H) * a.P * 4, a.L, a.P * 4, tid);
    cp_async_commit();
    cn = tid < a.L ? a.cum[(rbt * a.H + h) * a.S + s0 + tid] : 0.f;
  };
  float cn;
  issue(0, cn);
  stage_bf16(static_cast<const bf16*>(a.c) + r * a.cs0 + bt * a.cs1 +
                 g * a.cs3 + s0 * a.cs2,
             a.cs2, a.L, a.N, sm, tid, false);
  const int n0 = 16 * warp;  // this warp's state rows

#pragma unroll 1
  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = rbt * a.H + h;
    if (tid < MAX_L) sEc[tid] = tid < a.L ? expf(cn) : 0.f;
    cp_async_wait();
    __syncthreads();  // the landing area and exp(cum); the last head is
                      // done with dy's planes
    // exp(cum_i) dy_i into the planes
#pragma unroll
    for (int it = 0; it < MAX_L * 8 / THREADS; ++it) {
      const int v = tid + it * THREADS, row = v >> 3, ch = v & 7;
      float f[8];
      if (row < a.L && 8 * ch < a.P) {
        const float4* q = reinterpret_cast<const float4*>(
            sm + U_OFF_LDY + row * 2 * ROW + 32 * ch);
        const float4 f0 = q[0], f1 = q[1];
        const float e = sEc[row];
        f[0] = f0.x * e; f[1] = f0.y * e; f[2] = f0.z * e; f[3] = f0.w * e;
        f[4] = f1.x * e; f[5] = f1.y * e; f[6] = f1.z * e; f[7] = f1.w * e;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) f[q] = 0.f;
      }
      uint4 o[3];
      split8(f, o);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint4*>(sm + 2 * TILE + t * TILE +
                                  swz(row, 8 * ch)) = o[t];
    }
    __syncthreads();
    if (hh + 1 < hpg) issue(hh + 1, cn);
    if (n0 >= a.Np) continue;
    float u[MAX_P / 8][4];
#pragma unroll
    for (int t = 0; t < MAX_P / 8; ++t) u[t][0] = u[t][1] = u[t][2] = u[t][3] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < a.Lp; k0 += 16) {
      uint32_t af[4];
      lda_t(af, aC, n0, k0, lane);  // C^T: (n, i) at C[i][n]
      // mma_add's arithmetic, four head-dim tiles' chains interleaved
#pragma unroll
      for (int hf = 0; hf < MAX_P / 32; ++hf) {
        if (32 * hf >= a.Pp) continue;
        uint32_t b[3][4][2];
        ldb_t4<3>(b, aDY, k0, 32 * hf, lane);
        float t[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
#pragma unroll
        for (int o = 2; o >= 0; --o)
#pragma unroll
          for (int n = 0; n < 4; ++n) mma(t[n], af, b[o][n][0], b[o][n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[4 * hf + n][e] += t[n][e];
      }
    }
    float* UC = a.grad + (rbh * a.nc + c) * a.N * a.P;
#pragma unroll
    for (int pt = 0; pt < MAX_P / 8; ++pt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + gq + 8 * e, p = 8 * pt + 2 * cq;
        if (n < a.N && p < a.P)
          *reinterpret_cast<float2*>(UC + n * a.P + p) =
              make_float2(u[pt][2 * e], u[pt][2 * e + 1]);
      }
  }
}

// ---- b3: the gradients -------------------------------------------------

// tiles: C, B (two each), x, dy's three planes, the state's three planes,
// the landing area (x's raw rows, one tile; dy's, two); then cum, dt, the
// row scales, the per-warp sums and each 16-row block's cum range
constexpr uint32_t OFF_C = 0, OFF_B = 2 * TILE, OFF_X = 4 * TILE,
                   OFF_DY = 5 * TILE, OFF_HG = 8 * TILE, OFF_LX = 11 * TILE,
                   OFF_LDY = 12 * TILE, OFF_F = 14 * TILE;
constexpr size_t G_BYTES = OFF_F + 4 * (3 * MAX_L + 16 + MAX_L / 8) + 1024;
static_assert(G_BYTES <= 232448, "over the 227 KB a block may use");

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_grads_bf16(
    const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (sa - raw);
  const uint32_t aC = sa + OFF_C, aB = sa + OFF_B, aX = sa + OFF_X,
                 aDY = sa + OFF_DY, aHG = sa + OFF_HG;
  float* sCum = reinterpret_cast<float*>(sm + OFF_F);
  float* sDt = sCum + MAX_L;
  float* sS = sDt + MAX_L;  // row scales: exp(cum_i), then exp(cL - cum_j) dt_j
  float* sRed = sS + MAX_L;  // per-warp sums
  float* sMax = sRed + 16;   // per 16-row block: largest cum, smallest cum
  float* sMin = sMax + MAX_L / 16;

  long long blk = blockIdx.x;
  const int g = static_cast<int>(blk % a.G);
  blk /= a.G;
  const int c = static_cast<int>(blk % a.nc);
  blk /= a.nc;
  const int bt = static_cast<int>(blk % a.Bt);
  const long long r = blk / a.Bt;
  const long long s0 = static_cast<long long>(c) * a.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3, wg = warp >> 2;
  const int hpg = a.H / a.G, nk = 2 * hpg;
  // this warp's rows, in both passes: logical block rbk, stored at p0
  const int rbk = warp < 4 ? warp : 11 - warp, r0 = 16 * rbk, p0 = 16 * warp;
  const bool rows = r0 < a.Lp;
  const int ra = r0 + gq, rb = ra + 8;  // this thread's two rows
  const long long rbt = r * a.Bt + bt;
  const uint32_t wrows = static_cast<uint32_t>(wg) * 64 * ROW;

  // head load k (the rows-i pass's heads, then the rows-j pass's): x's and
  // dy's rows of the chunk into the landing area, by cp.async
  auto issue = [&](int k) {
    const int h = g * hpg + k % hpg;
    // the state tiles this head stages (h_{c-1}; in the rows-j pass g_c
    // and h_{c-1}, for <h_{c-1}, g_c>) and its cum and dt, into L2
    const long long rbh = rbt * a.H + h;
    if (tid == 0) {
      const long long so = (rbh * a.nc + c) * a.N * a.P;
      const uint32_t bytes = static_cast<uint32_t>(a.N * a.P * 4);
      prefetch_l2(a.states + so, bytes);
      if (k >= hpg) prefetch_l2(a.grad + so, bytes);
    }
    if (tid < a.L) {
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                       a.cum + rbh * a.S + s0 + tid) : "memory");
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                       a.dt + r * a.ds0 + bt * a.ds1 + h * a.ds3 +
                       (s0 + tid) * a.ds2) : "memory");
    }
    cp_async_rows(sa + OFF_LX, ROW,
                  static_cast<const bf16*>(a.x) + r * a.xs0 + bt * a.xs1 +
                      h * a.xs3 + s0 * a.xs2,
                  a.xs2 * 2, a.L, a.P * 2, tid);
    cp_async_rows(sa + OFF_LDY, 2 * ROW,
                  a.dy + (rbt * a.S + s0) * a.H * a.P +
                      static_cast<long long>(h) * a.P,
                  static_cast<long long>(a.H) * a.P * 4, a.L, a.P * 4, tid);
    cp_async_commit();
  };

  issue(0);
  stage_bf16(static_cast<const bf16*>(a.c) + r * a.cs0 + bt * a.cs1 +
                 g * a.cs3 + s0 * a.cs2,
             a.cs2, a.L, a.N, sm + OFF_C, tid, true);
  stage_bf16(static_cast<const bf16*>(a.b) + r * a.bs0 + bt * a.bs1 +
                 g * a.bs3 + s0 * a.bs2,
             a.bs2, a.L, a.N, sm + OFF_B, tid, true);

  // head load k into the tiles: x as it is, dy and the state (h_{c-1} or
  // g_c) as term planes, cum, dt and the row scales; then the next load
  int k = 0;
  auto begin_head = [&](const float* state, bool rows_i) {
    const int h = g * hpg + k % hpg;
    const long long rbh = rbt * a.H + h;
    cp_async_wait();  // this head's landing area, visible after the barrier
    __syncthreads();  // the last head is done with the tiles and sRed
    // the state's planes; in the rows-j pass also the hand-off's term
    // <h_{c-1}, g_c>: a fixed share per thread, then a fixed butterfly in
    // each warp
    const long long so = (rbh * a.nc + c) * a.N * a.P;
    float hd = stage_planes(state + so, a.P, a.N, a.P, sm + OFF_HG, tid,
                            rows_i ? nullptr : a.states + so);
    if (!rows_i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) hd += __shfl_xor_sync(FULL, hd, o);
      if (lane == 0) sRed[warp] = hd;
    }
    const float* cum = a.cum + rbh * a.S + s0;
    const float cl = cum[a.L - 1];
    if (tid < MAX_L) {  // warps 0-3, a 16-row block per half warp
      const int i = tid;
      const float cu = i < a.L ? cum[i] : 0.f;
      const float d = i < a.L ? a.dt[r * a.ds0 + bt * a.ds1 + h * a.ds3 +
                                     (s0 + i) * a.ds2]
                              : 0.f;
      sCum[i] = cu;
      sDt[i] = d;
      sS[i] = i < a.L ? (rows_i ? expf(cu) : expf(cl - cu) * d) : 0.f;
      // the block's largest and smallest cum over rows < L (a NaN counts
      // as largest: its tiles are never skipped): the decay between two
      // blocks is at most sMax[later] - sMin[earlier]
      float hi = i < a.L ? (cu == cu ? cu : INFINITY) : -INFINITY;
      float lo = i < a.L ? cu : INFINITY;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
        lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
      }
      if ((i & 15) == 0) {
        sMax[i >> 4] = hi;
        sMin[i >> 4] = lo;
      }
    }
    for (int v = tid; v < MAX_L * 8; v += THREADS) {
      const int row = v >> 3, ch = v & 7;
      const bool ok = row < a.L && 8 * ch < a.P;
      uint4 u = make_uint4(0, 0, 0, 0);
      float f[8];
      if (ok) {
        u = *reinterpret_cast<const uint4*>(sm + OFF_LX + row * ROW + 16 * ch);
        const float4* p = reinterpret_cast<const float4*>(
            sm + OFF_LDY + row * 2 * ROW + 32 * ch);
        const float4 f0 = p[0], f1 = p[1];
        f[0] = f0.x; f[1] = f0.y; f[2] = f0.z; f[3] = f0.w;
        f[4] = f1.x; f[5] = f1.y; f[6] = f1.z; f[7] = f1.w;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) f[q] = 0.f;
      }
      *reinterpret_cast<uint4*>(sm + OFF_X + swz(prow(row), 8 * ch)) = u;
      uint4 o[3];
      split8(f, o);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint4*>(sm + OFF_DY + t * TILE +
                                  swz(prow(row), 8 * ch)) = o[t];
    }
    fence_proxy_async();  // the tiles' generic writes before wgmma reads
    __syncthreads();
    ++k;
    if (k < nk) issue(k);  // lands while this head computes
  };

  // ---- rows-i pass: dC, and each row's dcum less the column terms ----
  float dC[MAX_N / 8][4];
#pragma unroll
  for (int t = 0; t < MAX_N / 8; ++t) dC[t][0] = dC[t][1] = dC[t][2] = dC[t][3] = 0.f;
#pragma unroll 1
  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = rbt * a.H + h;
    begin_head(a.states, true);
    const float cum_a = sCum[ra], cum_b = sCum[rb];  // 0 past the chunk
    float part_a = 0.f, part_b = 0.f;  // sum_{j<i} W_ij of rows ra, rb
    if (rows) {
#pragma unroll 1
      for (int kt = 0; kt <= rbk; ++kt) {  // column tiles with 16 kt <= i
        // off the diagonal, a tile whose largest decay lies below EXP_ZERO
        // adds exactly 0
        if (kt < rbk && sMax[rbk] - sMin[kt] < EXP_ZERO) continue;
        // C_i . B_j over n and dy_i . x_j over p (dy's terms apart)
        float cb[2][4], m[2][4];
        tile_products<false>(cb, m, aC, aB, aDY, aX, p0, prow(16 * kt),
                             a.Np, a.Pp, lane);
        float z[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e >> 1) ? rb : ra;
            const int j = 16 * kt + 8 * nt + 2 * cq + (e & 1);
            float zz = 0.f;
            if (j <= row && row < a.L) {
              const float cr = (e >> 1) ? cum_b : cum_a;
              zz = expf(cr - sCum[j]) * sDt[j] * m[nt][e];
              if (j < row) {
                if (e >> 1)
                  part_b += cb[nt][e] * zz;
                else
                  part_a += cb[nt][e] * zz;
              }
            }
            z[nt][e] = zz;
          }
        uint32_t zf[3][4];
        acc_to_a3(zf, z);
        add_zt(dC, zf, aB, prow(16 * kt), a.Np, lane);  // dC_i += Z_ij B_j
      }
      part_a = row_sum(part_a);
      part_b = row_sum(part_b);
    }
    // the inter-chunk terms on wgmma, this warpgroup's 64 rows: y_i = C_i
    // h_{c-1}, dcum's exp(cum_i) dy_i . y_i, and dC_i += exp(cum_i) dy_i
    // h^T (the row scale applied to each chain's sum); a warpgroup whose
    // rows' exp(cum_i) are all 0 takes no product (it adds exactly 0)
    float yi_a = 0.f, yi_b = 0.f;
    if (wg_any((ra < a.L && !(cum_a < EXP_ZERO)) ||
                   (rb < a.L && !(cum_b < EXP_ZERO)),
               wg)) {
      float yv[32];
      rows_state(yv, aC + wrows, aHG);
      row_dots<3>(yi_a, yi_b, yv, aDY, p0, a.Pp, lane);
      yi_a = row_sum(yi_a);
      yi_b = row_sum(yi_b);
      rows_head<3>(dC, sS[ra], sS[rb], aDY + wrows, aHG);
    }
    if (rows && cq == 0) {
      float* DC = a.dcum + rbh * a.S + s0;
      if (ra < a.L) DC[ra] = part_a + sS[ra] * yi_a;
      if (rb < a.L) DC[rb] = part_b + sS[rb] * yi_b;
    }
  }
  const long long orow = static_cast<long long>(a.G) * a.N;  // dB, dC rows
  if (rows) {
    bf16* DCo = static_cast<bf16*>(a.dc) + (rbt * a.S + s0) * orow +
                static_cast<long long>(g) * a.N;
#pragma unroll
    for (int nt = 0; nt < MAX_N / 8; ++nt) {
      const int n = 8 * nt + 2 * cq;
      if (n >= a.N) continue;
      if (ra < a.L) store2<bf16>(DCo + ra * orow + n, dC[nt][0], dC[nt][1]);
      if (rb < a.L) store2<bf16>(DCo + rb * orow + n, dC[nt][2], dC[nt][3]);
    }
  }

  // ---- rows-j pass: dx, dB, the column terms of dcum, the direct ddt ----
  float dB[MAX_N / 8][4];
#pragma unroll
  for (int t = 0; t < MAX_N / 8; ++t) dB[t][0] = dB[t][1] = dB[t][2] = dB[t][3] = 0.f;
#pragma unroll 1
  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = rbt * a.H + h;
    begin_head(a.grad, false);
    const float cl = sCum[a.L - 1];
    const float cum_a = sCum[ra], cum_b = sCum[rb];
    float dxa[MAX_P / 8][4];
#pragma unroll
    for (int t = 0; t < MAX_P / 8; ++t) dxa[t][0] = dxa[t][1] = dxa[t][2] = dxa[t][3] = 0.f;
    float col_a = 0.f, col_b = 0.f;  // sum_{i>j} W_ij of rows ra, rb
    float dd_a = 0.f, dd_b = 0.f;    // sum_{i>=j} (C_i . B_j) D_ij M_ij
    if (rows) {
#pragma unroll 1
      for (int it = rbk; 16 * it < a.Lp; ++it) {  // tiles with i >= j
        if (it > rbk && sMax[it] - sMin[rbk] < EXP_ZERO) continue;
        // B_j . C_i over n and x_j . dy_i over p (dy's terms apart)
        float bc[2][4], mt[2][4];
        tile_products<true>(bc, mt, aB, aC, aX, aDY, p0, prow(16 * it),
                            a.Np, a.Pp, lane);
        float u[2][4], z[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e >> 1) ? rb : ra;
            const int i = 16 * it + 8 * nt + 2 * cq + (e & 1);
            float uu = 0.f, zz = 0.f;
            if (row <= i && i < a.L) {
              const float cr = (e >> 1) ? cum_b : cum_a;
              const float d = expf(sCum[i] - cr);
              uu = bc[nt][e] * d;
              zz = d * sDt[row] * mt[nt][e];
              const float dd = uu * mt[nt][e];
              const float w = row < i ? bc[nt][e] * zz : 0.f;
              if (e >> 1) {
                dd_b += dd;
                col_b += w;
              } else {
                dd_a += dd;
                col_a += w;
              }
            }
            u[nt][e] = uu;
            z[nt][e] = zz;
          }
        uint32_t uf[3][4], zf[3][4];
        acc_to_a3(uf, u);
        acc_to_a3(zf, z);
        add_zt(dB, zf, aC, prow(16 * it), a.Np, lane);  // dB_j += Z_ij C_i
        // dx_j += u_ji dy_i: mma_add's arithmetic, two head-dim tiles'
        // chains interleaved
#pragma unroll
        for (int pp = 0; pp < MAX_P / 16; ++pp) {
          if (16 * pp >= a.Pp) continue;
          uint32_t b[3][4];
#pragma unroll
          for (int t = 0; t < 3; ++t)
            ldb_t(b[t], aDY + t * TILE, prow(16 * it), 16 * pp, lane);
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int order = 2; order >= 0; --order)
#pragma unroll
            for (int ia = 0; ia < 3; ++ia) {
              const int ib = order - ia;
              if (ib < 0 || ib >= 3) continue;
              mma(t0, uf[ia], b[ib][0], b[ib][1]);
              mma(t1, uf[ia], b[ib][2], b[ib][3]);
            }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dxa[2 * pp][e] += t0[e];
            dxa[2 * pp + 1][e] += t1[e];
          }
        }
      }
      col_a = row_sum(col_a);
      col_b = row_sum(col_b);
      dd_a = row_sum(dd_a);
      dd_b = row_sum(dd_b);
    }
    // the state terms on wgmma, this warpgroup's 64 rows: V_j = B_j g_c,
    // q_j = V_j . x_j, and dB_j += exp(cL - cum_j) dt_j x_j g_c^T (three
    // products, x exact in bf16, the row scale on each chain's sum); a
    // warpgroup whose rows' decay to the chunk's end is 0 adds exactly 0
    const bool reach =
        wg_any((ra < a.L && !(cl - cum_a < EXP_ZERO)) ||
                   (rb < a.L && !(cl - cum_b < EXP_ZERO)),
               wg);
    float v[32];
    if (reach) {
      rows_state(v, aB + wrows, aHG);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) v[e] = 0.f;
    }
    float ssum = 0.f;  // sum of s_j over this warp's rows
    if (rows) {
      float q_a = 0.f, q_b = 0.f;
      if (reach) {
        row_dots<1>(q_a, q_b, v, aX, p0, a.Pp, lane);
        q_a = row_sum(q_a);
        q_b = row_sum(q_b);
      }
      const float dt_a = sDt[ra], dt_b = sDt[rb];  // 0 past the chunk
      const float de_a = ra < a.L ? expf(cl - cum_a) : 0.f;
      const float de_b = rb < a.L ? expf(cl - cum_b) : 0.f;
      bf16* DX = static_cast<bf16*>(a.dx) + (rbt * a.S + s0) * a.H * a.P +
                 static_cast<long long>(h) * a.P;
      const long long xrow = static_cast<long long>(a.H) * a.P;
#pragma unroll
      for (int pt = 0; pt < MAX_P / 8; ++pt) {
        const int p = 8 * pt + 2 * cq;
        if (p >= a.P) continue;
        if (ra < a.L)
          store2<bf16>(DX + ra * xrow + p,
                       dt_a * (dxa[pt][0] + de_a * v[4 * pt]),
                       dt_a * (dxa[pt][1] + de_a * v[4 * pt + 1]));
        if (rb < a.L)
          store2<bf16>(DX + rb * xrow + p,
                       dt_b * (dxa[pt][2] + de_b * v[4 * pt + 2]),
                       dt_b * (dxa[pt][3] + de_b * v[4 * pt + 3]));
      }
      const float s_a = de_a * dt_a * q_a, s_b = de_b * dt_b * q_b;
      if (cq == 0) {
        float* DC = a.dcum + rbh * a.S + s0;
        float* DD = a.ddtd + rbh * a.S + s0;
        if (ra < a.L) {
          DC[ra] = DC[ra] - col_a - s_a;
          DD[ra] = dd_a + de_a * q_a;
        }
        if (rb < a.L) {
          DC[rb] = DC[rb] - col_b - s_b;
          DD[rb] = dd_b + de_b * q_b;
        }
      }
      // over the warp's rows: the four lanes of a row hold the same s
      ssum = s_a + s_b;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) ssum += __shfl_xor_sync(FULL, ssum, o);
    }
    if (reach) rows_head<1>(dB, sS[ra], sS[rb], aX + wrows, aHG);
    if (lane == 0) sRed[8 + warp] = ssum;
    __syncthreads();
    if (tid == 0) {
      float hsum = 0.f, s = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) {
        hsum += sRed[w];
        s += sRed[8 + w];
      }
      a.tail[rbh * a.nc + c] = s + expf(cl) * hsum;
    }
  }
  if (rows) {
    bf16* DBo = static_cast<bf16*>(a.db) + (rbt * a.S + s0) * orow +
                static_cast<long long>(g) * a.N;
#pragma unroll
    for (int nt = 0; nt < MAX_N / 8; ++nt) {
      const int n = 8 * nt + 2 * cq;
      if (n >= a.N) continue;
      if (ra < a.L) store2<bf16>(DBo + ra * orow + n, dB[nt][0], dB[nt][1]);
      if (rb < a.L) store2<bf16>(DBo + rb * orow + n, dB[nt][2], dB[nt][3]);
    }
  }
}

// ---- b4: ddt and the dA partials ----------------------------------------

// One warp per (rank, batch, chunk, head), lane l on rows 4 l .. 4 l + 3:
// rc_j = tail + sum_{k>=j} dcum_k by a suffix sum in each lane, then over
// the lanes by a fixed shuffle ladder; ddt_j = ddt_direct_j + A rc_j, and
// the chunk's dA partial sum_j rc_j dt_j by a fixed butterfly.  (The f32
// route's ssd_bwd_dt_kernel walks the rows one thread a chunk.)
__global__ void __launch_bounds__(THREADS) ssd_bwd_dt_bf16(const BwdArgs a) {
  const long long e = (static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= static_cast<long long>(a.R) * a.Bt * a.nc * a.H) return;
  const int h = static_cast<int>(e % a.H);
  long long rest = e / a.H;
  const int c = static_cast<int>(rest % a.nc);
  rest /= a.nc;
  const int bt = static_cast<int>(rest % a.Bt);
  const long long r = rest / a.Bt;
  const long long rbh = (r * a.Bt + bt) * a.H + h;
  const long long s0 = static_cast<long long>(c) * a.L;
  const float A = a.a[r * a.as0 + h * a.as1];
  const float* DC = a.dcum + rbh * a.S + s0;
  const float* DD = a.ddtd + rbh * a.S + s0;
  float* DT = a.ddt + ((r * a.Bt + bt) * a.S + s0) * a.H + h;
  const float* dt = a.dt + r * a.ds0 + bt * a.ds1 + h * a.ds3 + s0 * a.ds2;
  float dc[4], dd[4], d[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 4 * lane + q;
    const bool in = j < a.L;
    dc[q] = in ? DC[j] : 0.f;
    dd[q] = in ? DD[j] : 0.f;
    d[q] = in ? dt[j * a.ds2] : 0.f;
  }
  float s[4];  // suffix sums inside the lane
  s[3] = dc[3];
#pragma unroll
  for (int q = 2; q >= 0; --q) s[q] = dc[q] + s[q + 1];
  float v = s[0];  // the suffix sum over lanes >= l
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v += u;
  }
  float after = __shfl_down_sync(FULL, v, 1);  // lanes > l
  if (lane == 31) after = 0.f;
  const float base = a.tail[rbh * a.nc + c] + after;
  float da = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 4 * lane + q;
    const float rc = base + s[q];
    if (j < a.L) DT[static_cast<long long>(j) * a.H] = dd[q] + rc * A;
    da += rc * d[q];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(FULL, da, o);
  if (lane == 0) a.dapart[((r * a.H + h) * a.Bt + bt) * a.nc + c] = da;
}

cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_u_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(U_BYTES));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_grads_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(G_BYTES));
  if (err != cudaSuccess) return err;
  const long long rb = static_cast<long long>(a.R) * a.Bt;
  const unsigned groups = static_cast<unsigned>(rb * a.nc * a.G);
  ssd_bwd_u_bf16<<<groups, THREADS, U_BYTES, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_handoff_kernel<<<blocks_of(rb * a.H * a.N * a.P / 4), THREADS, 0,
                           stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_grads_bf16<<<groups, THREADS, G_BYTES, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dt_bf16<<<blocks_of(rb * a.nc * a.H * 32), THREADS, 0, stream>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<blocks_of(static_cast<long long>(a.R) * a.H), THREADS,
                      0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace bfr

// the f32 route
cudaError_t launch_f32(const BwdArgs& a, cudaStream_t stream) {
  const size_t su = U_SMEM, sg = G_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_u_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(su));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_grads_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sg));
  if (err != cudaSuccess) return err;
  const long long rb = static_cast<long long>(a.R) * a.Bt;
  const unsigned groups = static_cast<unsigned>(rb * a.nc * a.G);
  ssd_bwd_u_kernel<<<groups, THREADS, su, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_handoff_kernel<<<blocks_of(rb * a.H * a.N * a.P / 4), THREADS, 0,
                           stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_grads_kernel<<<groups, THREADS, sg, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dt_kernel<<<blocks_of(rb * a.nc * a.H), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<blocks_of(static_cast<long long>(a.R) * a.H), THREADS,
                      0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and of dx, dB, dC): 0 = float32, 1 = bfloat16; dt, A,
// dy, dh and every other array are float32.  Strides in elements, four each
// for x, dt, B, C (ranks, batch, sequence, head or group) and two for A;
// every inner stride is 1.  dy, dh (null for a zero cotangent), states,
// cum and the outputs are contiguous; grad (R, Bt, H, S / L, N, P), dcum
// and ddtd (R, Bt, H, S), tail (R, Bt, H, S / L) and dapart (R, H, Bt,
// S / L) are f32 scratch.  The limits are the forward's.  Launches the five
// kernels in order; returns the CUDA error of the launches (0 on success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* dy, const void* dh, const void* states,
    const void* cum, void* dx, void* ddt, void* da, void* db, void* dc,
    void* grad, void* dcum, void* ddtd, void* tail, void* dapart, int dtype,
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
  BwdArgs args{x,
               static_cast<const float*>(dt),
               static_cast<const float*>(a),
               b,
               c,
               static_cast<const float*>(dy),
               static_cast<const float*>(dh),
               static_cast<const float*>(states),
               static_cast<const float*>(cum),
               dx,
               static_cast<float*>(ddt),
               static_cast<float*>(da),
               db,
               dc,
               static_cast<float*>(grad),
               static_cast<float*>(dcum),
               static_cast<float*>(ddtd),
               static_cast<float*>(tail),
               static_cast<float*>(dapart),
               R, Bt, S, H, P, G, N, L, nc,
               pad16(L), pad16(N), pad16(P),
               xs0, xs1, xs2, xs3, ds0, ds1, ds2, ds3, as0, as1,
               bs0, bs1, bs2, bs3, cs0, cs1, cs2, cs3};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(args, st);
  if (dtype == 1) return bfr::launch(args, st);
  return cudaErrorInvalidValue;
}
