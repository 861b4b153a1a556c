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
// S 2048, H 6, P 64, N 128, chunk 128, bf16) it must move ~278 MB (dy in
// f32 101 MB, x and dx 50 MB each, B, C, dB, dC 17 MB each): ~83 us at
// 3.35 TB/s, against ~46 GFLOP of products, ~47 us on the tensor cores.
//
// What the design does about it: the forward's mirror, every product on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulation), with
// the forward's exactness rule: an f32 operand (dy, the states, a decay-
// weighted matrix, and every operand of an f32 call) is split into three
// bf16 terms whose products of order <= 2 accumulate in f32, a bf16 operand
// is taken as it is.  Five kernels per call (one ssd_scan_bwd_launch):
// b0. (the forward) keeps cum and the incoming states for the backward:
//     100.7 MB f32 at the training shape, which under remat per block lives
//     only for the recomputed block, during its backward; rerunning passes
//     1-2 here would cost their time again for no memory that matters.
// b1. ssd_bwd_u_kernel, one block per (rank, batch, chunk, group): per
//     head, U_c = C^T (exp(cum) o dy), N x P over the chunk's rows, warp w
//     owning state rows [16 w, 16 w + 16), into a scratch (R, Bt, H, nc, N,
//     P) f32;
// b2. ssd_bwd_handoff_kernel, one thread per (rank, batch, head, 4 state
//     elements): the chunks last to first, g_{c-1} = exp(cL) g_c + U_c in
//     the forward's rounded product-then-sum order, overwriting U_c with g_c;
// b3. ssd_bwd_grads_kernel, one block per (rank, batch, chunk, group), warp
//     w owning rows [16 w, 16 w + 16) of the chunk.  C and B are staged once
//     for the group.  Rows-i pass, per head in order: C.B^T and M one 16 x 16
//     tile at a time over the j <= i triangle, Z built in registers as the A
//     operand of Z.B (dC), the row sums of W, then C.h_{c-1} and dy.h^T;
//     dC accumulates over the group's heads in registers.  Rows-j pass, per
//     head: B.C^T and x.dy^T tiles over i >= j, the A operands of
//     (C.B^T o D).dy (dx) and Z^T.C (dB), the column sums of W and the
//     direct ddt, then B.g_c and x.g_c^T; dB accumulates over the heads.  The
//     two passes restage x and dy per head (from L2): holding both dC and dB
//     in one pass would not fit the registers.  Each row's dcum goes to a
//     scratch (R, Bt, H, S), the per-(chunk, head) terms of row L-1 to
//     another (R, Bt, H, nc);
// b4. ssd_bwd_dt_kernel, one thread per (rank, batch, chunk, head): the
//     reverse cumsum of dcum in row order, ddt, and one dA partial;
// b5. ssd_bwd_da_kernel, one thread per (rank, head): dA, the partials
//     summed over (batch, chunk) in order.
// Determinism: no atomics; every output element has one writer and every
// sum runs in a fixed order (warp shuffles in a fixed butterfly), so two
// runs are bitwise equal.  Sums over tiles and heads (U, dC, dB, dx and
// the state terms) add each k-step's products into their accumulator with
// IEEE adds: carried through the tensor cores' accumulation instead, dB's
// 144 calls at the training shape drifted to 6x the f32 plain version's
// error against float64 (f32 inputs, shallow decay).  Tiles whose decays all lie below EXP_ZERO add
// exactly 0 and are skipped, as in the forward; how much that saves
// depends on the data (steep decays skip most of a chunk's triangle).
// Operands are read from shared memory in their own type and split into
// terms as their fragments are loaded (no term planes: the f32 call's five
// tiles, C, B, x, dy and h or g, fill 226 KB as they are).  L, N and P are
// zero-padded to multiples of 16 in shared memory (the wrapper pads N and P
// to multiples of 8 and aligns every row, as for the forward).  b1 and b3
// launch 8 warps a block; they launch on the caller's stream and allocate
// nothing: the wrapper allocates the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_common.cuh"

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

template <typename U>
__device__ __forceinline__ float ldf(const U* p) {
  if constexpr (sizeof(U) == 2)
    return __bfloat162float(*p);
  else
    return *p;
}

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
template <int TT, typename U>
__device__ __forceinline__ void frag_a(uint32_t (&f)[TT][4], const U* s,
                                       int sm, int sk, int m0, int k0,
                                       int lane,
                                       const float* rs = nullptr) {
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + gq + 8 * (q & 1), k = k0 + 2 * cq + 8 * (q >> 1);
    float v0 = ldf(s + m * sm + k * sk), v1 = ldf(s + m * sm + (k + 1) * sk);
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
template <int TT, typename U>
__device__ __forceinline__ void frag_b(uint32_t (&f)[TT][2], const U* s,
                                       int sk, int sn, int k0, int n0,
                                       int lane,
                                       const float* ks = nullptr) {
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = k0 + 2 * cq + 8 * r, n = n0 + gq;
    float v0 = ldf(s + k * sk + n * sn), v1 = ldf(s + (k + 1) * sk + n * sn);
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

// Stage rows [0, rows_p) x columns [0, cols_p) of a row-major global tile
// of U (row stride ld; rows >= rows or columns >= cols read as 0) into
// shared memory as it is (row stride lds), 16 bytes a thread at a time
template <typename U>
__device__ __forceinline__ void stage(const U* g, long long ld, int rows,
                                      int rows_p, int cols, int cols_p, U* s,
                                      int lds, int tid) {
  constexpr int VE = 16 / sizeof(U);
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

// shared-memory row strides: rows of bf16 padded by 16 bytes and of f32 by
// 32 (fewer bank conflicts); the f32 call's tiles are not padded, to fit
template <typename T>
struct Ld {
  static constexpr bool BF = sizeof(T) == 2;
  static constexpr int N = MAX_N + (BF ? 8 : 0);  // T per row of B or C
  static constexpr int P = MAX_P + (BF ? 8 : 0);  // per row of x, dy, h, g
};

// ---------------------------------------------------------------------
// b1: U_c = C^T (exp(cum) o dy), one block per (rank, batch, chunk, group)
// ---------------------------------------------------------------------

template <typename T>
struct USmem {
  static constexpr size_t BYTES = sizeof(T) * MAX_L * Ld<T>::N +
                                  sizeof(float) * (MAX_L * Ld<T>::P + MAX_L);
};

template <typename T, int TI>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_u_kernel(
    const BwdArgs a) {
  using LD = Ld<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sC = reinterpret_cast<T*>(smem);                                // [i][n]
  float* sDy = reinterpret_cast<float*>(sC + MAX_L * LD::N);         // [i][p]
  float* sEc = sDy + MAX_L * LD::P;  // exp(cum_i), 0 past the chunk

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
  const T* Cm = static_cast<const T*>(a.c) + r * a.cs0 + bt * a.cs1 +
                g * a.cs3 + s0 * a.cs2;
  stage<T>(Cm, a.cs2, a.L, a.Lp, a.N, a.Np, sC, LD::N, tid);
  const int n0 = 16 * warp;  // this warp's state rows

  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const long long rbh = (r * a.Bt + bt) * a.H + h;
    __syncthreads();  // the last head is done with sDy, sEc
    stage<float>(a.dy + ((r * a.Bt + bt) * a.S + s0) * a.H * a.P +
                     static_cast<long long>(h) * a.P,
                 static_cast<long long>(a.H) * a.P, a.L, a.Lp, a.P, a.Pp, sDy,
                 LD::P, tid);
    for (int i = tid; i < a.Lp; i += THREADS)
      sEc[i] = i < a.L ? expf(a.cum[rbh * a.S + s0 + i]) : 0.f;
    __syncthreads();
    if (n0 >= a.Np) continue;
    float u[MAX_P / 8][4];
#pragma unroll
    for (int t = 0; t < MAX_P / 8; ++t) u[t][0] = u[t][1] = u[t][2] = u[t][3] = 0.f;
    for (int k0 = 0; k0 < a.Lp; k0 += 16) {
      uint32_t af[TI][4];
      frag_a<TI>(af, sC, 1, LD::N, n0, k0, lane);  // C^T: (n, i) at C[i][n]
#pragma unroll
      for (int pt = 0; pt < MAX_P / 8; ++pt) {
        if (8 * pt >= a.Pp) continue;
        uint32_t bf[3][2];
        frag_b<3>(bf, sDy, LD::P, 1, k0, 8 * pt, lane, sEc);
        mma_add<TI, 3>(u[pt], af, bf);
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

__global__ void __launch_bounds__(THREADS) ssd_bwd_handoff_kernel(
    const BwdArgs a) {
  const long long np4 = static_cast<long long>(a.N) * a.P / 4;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= static_cast<long long>(a.R) * a.Bt * a.H * np4) return;
  const long long rbh = e / np4, k = e - rbh * np4;
  float4* __restrict__ gr =
      reinterpret_cast<float4*>(a.grad) + rbh * a.nc * np4 + k;
  const float* __restrict__ cum = a.cum + rbh * a.S + a.L - 1;
  float4 g = a.dh != nullptr ? reinterpret_cast<const float4*>(a.dh)[e]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = a.nc - 1; c >= 0; --c) {
    const float4 u = gr[c * np4];
    const float dk = expf(cum[static_cast<long long>(c) * a.L]);
    gr[c * np4] = g;  // the gradient of the state leaving chunk c
    g.x = __fadd_rn(__fmul_rn(g.x, dk), u.x);
    g.y = __fadd_rn(__fmul_rn(g.y, dk), u.y);
    g.z = __fadd_rn(__fmul_rn(g.z, dk), u.z);
    g.w = __fadd_rn(__fmul_rn(g.w, dk), u.w);
  }
}

// ---------------------------------------------------------------------
// b3: the gradients, one block per (rank, batch, chunk, group)
// ---------------------------------------------------------------------

template <typename T>
struct GradSmem {
  static constexpr size_t BYTES =
      sizeof(T) * (2 * MAX_L * Ld<T>::N + MAX_L * Ld<T>::P) +
      sizeof(float) * (MAX_L * Ld<T>::P + MAX_N * Ld<T>::P + 3 * MAX_L + 16);
};

template <typename T, int TI>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_grads_kernel(
    const BwdArgs a) {
  using LD = Ld<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sC = reinterpret_cast<T*>(smem);                           // [i][n]
  T* sB = sC + MAX_L * LD::N;                                   // [j][n]
  T* sX = sB + MAX_L * LD::N;                                   // [j][p]
  float* sDy = reinterpret_cast<float*>(sX + MAX_L * LD::P);    // [i][p]
  float* sHG = sDy + MAX_L * LD::P;  // [n][p]: h_{c-1}, then g_c
  float* sCum = sHG + MAX_N * LD::P;
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
  const T* Bm = static_cast<const T*>(a.b) + r * a.bs0 + bt * a.bs1 +
                g * a.bs3 + s0 * a.bs2;
  const T* Cm = static_cast<const T*>(a.c) + r * a.cs0 + bt * a.cs1 +
                g * a.cs3 + s0 * a.cs2;
  stage<T>(Cm, a.cs2, a.L, a.Lp, a.N, a.Np, sC, LD::N, tid);
  stage<T>(Bm, a.bs2, a.L, a.Lp, a.N, a.Np, sB, LD::N, tid);

  // one head's x, dy, cum, dt and state (h_{c-1} or g_c) into shared memory
  auto load_head = [&](int h, const float* state) {
    const long long rbh = rbt * a.H + h;
    stage<T>(static_cast<const T*>(a.x) + r * a.xs0 + bt * a.xs1 +
                 h * a.xs3 + s0 * a.xs2,
             a.xs2, a.L, a.Lp, a.P, a.Pp, sX, LD::P, tid);
    stage<float>(a.dy + (rbt * a.S + s0) * a.H * a.P +
                     static_cast<long long>(h) * a.P,
                 static_cast<long long>(a.H) * a.P, a.L, a.Lp, a.P, a.Pp, sDy,
                 LD::P, tid);
    stage<float>(state + (rbh * a.nc + c) * a.N * a.P, a.P, a.N, a.Np, a.P,
                 a.Pp, sHG, LD::P, tid);
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
        uint32_t af[TI][4];
        frag_a<TI>(af, sC, LD::N, 1, r0, k0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bf[TI][2];
          frag_b<TI>(bf, sB, 1, LD::N, k0, 16 * kt + 8 * nt, lane);
          mma_t<TI, TI>(cb[nt], af, bf);
        }
      }
      for (int k0 = 0; k0 < a.Pp; k0 += 16) {  // dy_i . x_j over p
        uint32_t af[3][4];
        frag_a<3>(af, sDy, LD::P, 1, r0, k0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bf[TI][2];
          frag_b<TI>(bf, sX, 1, LD::P, k0, 16 * kt + 8 * nt, lane);
          mma_t<3, TI>(m[nt], af, bf);
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
        uint32_t bf[TI][2];
        frag_b<TI>(bf, sB, LD::N, 1, 16 * kt, 8 * nt, lane);
        mma_add<3, TI>(dC[nt], zf, bf);
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
        uint32_t af[TI][4];
        frag_a<TI>(af, sC, LD::N, 1, r0, k0, lane);
#pragma unroll
        for (int pt = 0; pt < MAX_P / 8; ++pt) {
          if (8 * pt >= a.Pp) continue;
          uint32_t bf[3][2];
          frag_b<3>(bf, sHG, LD::P, 1, k0, 8 * pt, lane);
          mma_add<TI, 3>(yv[pt], af, bf);
        }
      }
#pragma unroll
      for (int pt = 0; pt < MAX_P / 8; ++pt) {
        if (8 * pt >= a.Pp) continue;  // columns past Pp are not staged
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * pt + 2 * cq + e;
          yi_a += yv[pt][e] * sDy[ra * LD::P + p];
          yi_b += yv[pt][2 + e] * sDy[rb * LD::P + p];
        }
      }
      yi_a = row_sum(yi_a);
      yi_b = row_sum(yi_b);
      for (int k0 = 0; k0 < a.Pp; k0 += 16) {  // dC_i += exp(cum_i) dy_i h^T
        uint32_t af[3][4];
        frag_a<3>(af, sDy, LD::P, 1, r0, k0, lane, sS);
#pragma unroll
        for (int nt = 0; nt < MAX_N / 8; ++nt) {
          if (8 * nt >= a.Np) continue;
          uint32_t bf[3][2];
          frag_b<3>(bf, sHG, 1, LD::P, k0, 8 * nt, lane);
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
    T* DCo = static_cast<T*>(a.dc) + (rbt * a.S + s0) * orow +
             static_cast<long long>(g) * a.N;
#pragma unroll
    for (int nt = 0; nt < MAX_N / 8; ++nt) {
      const int n = 8 * nt + 2 * cq;
      if (n >= a.N) continue;
      if (ra < a.L) store2<T>(DCo + ra * orow + n, dC[nt][0], dC[nt][1]);
      if (rb < a.L) store2<T>(DCo + rb * orow + n, dC[nt][2], dC[nt][3]);
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
        hd += HP[e] * sHG[n * LD::P + (e - n * a.P)];
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
          uint32_t af[TI][4];
          frag_a<TI>(af, sB, LD::N, 1, r0, k0, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t bf[TI][2];
            frag_b<TI>(bf, sC, 1, LD::N, k0, 16 * it + 8 * nt, lane);
            mma_t<TI, TI>(bc[nt], af, bf);
          }
        }
        for (int k0 = 0; k0 < a.Pp; k0 += 16) {  // x_j . dy_i over p
          uint32_t af[TI][4];
          frag_a<TI>(af, sX, LD::P, 1, r0, k0, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t bf[3][2];
            frag_b<3>(bf, sDy, 1, LD::P, k0, 16 * it + 8 * nt, lane);
            mma_t<TI, 3>(mt[nt], af, bf);
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
          frag_b<3>(bf, sDy, LD::P, 1, 16 * it, 8 * pt, lane);
          mma_add<3, 3>(dxa[pt], uf, bf);
        }
#pragma unroll
        for (int nt = 0; nt < MAX_N / 8; ++nt) {  // dB_j += Z_ij C_i
          if (8 * nt >= a.Np) continue;
          uint32_t bf[TI][2];
          frag_b<TI>(bf, sC, LD::N, 1, 16 * it, 8 * nt, lane);
          mma_add<3, TI>(dB[nt], zf, bf);
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
          uint32_t af[TI][4];
          frag_a<TI>(af, sB, LD::N, 1, r0, k0, lane);
#pragma unroll
          for (int pt = 0; pt < MAX_P / 8; ++pt) {
            if (8 * pt >= a.Pp) continue;
            uint32_t bf[3][2];
            frag_b<3>(bf, sHG, LD::P, 1, k0, 8 * pt, lane);
            mma_add<TI, 3>(v[pt], af, bf);
          }
        }
#pragma unroll
        for (int pt = 0; pt < MAX_P / 8; ++pt) {
          if (8 * pt >= a.Pp) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = 8 * pt + 2 * cq + e;
            q_a += v[pt][e] * ldf(sX + ra * LD::P + p);
            q_b += v[pt][2 + e] * ldf(sX + rb * LD::P + p);
          }
        }
        q_a = row_sum(q_a);
        q_b = row_sum(q_b);
        for (int k0 = 0; k0 < a.Pp; k0 += 16) {
          uint32_t af[3][4];
          frag_a<3>(af, sX, LD::P, 1, r0, k0, lane, sS);
#pragma unroll
          for (int nt = 0; nt < MAX_N / 8; ++nt) {
            if (8 * nt >= a.Np) continue;
            uint32_t bf[3][2];
            frag_b<3>(bf, sHG, 1, LD::P, k0, 8 * nt, lane);
            mma_add<3, 3>(dB[nt], af, bf);
          }
        }
      }
      const float dt_a = sDt[ra], dt_b = sDt[rb];  // 0 past the chunk
      const float de_a = ra < a.L ? expf(cl - cum_a) : 0.f;
      const float de_b = rb < a.L ? expf(cl - cum_b) : 0.f;
      T* DX = static_cast<T*>(a.dx) + (rbt * a.S + s0) * a.H * a.P +
              static_cast<long long>(h) * a.P;
      const long long xrow = static_cast<long long>(a.H) * a.P;
#pragma unroll
      for (int pt = 0; pt < MAX_P / 8; ++pt) {
        const int p = 8 * pt + 2 * cq;
        if (p >= a.P) continue;
        if (ra < a.L)
          store2<T>(DX + ra * xrow + p, dt_a * (dxa[pt][0] + de_a * v[pt][0]),
                    dt_a * (dxa[pt][1] + de_a * v[pt][1]));
        if (rb < a.L)
          store2<T>(DX + rb * xrow + p, dt_b * (dxa[pt][2] + de_b * v[pt][2]),
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
    T* DBo = static_cast<T*>(a.db) + (rbt * a.S + s0) * orow +
             static_cast<long long>(g) * a.N;
#pragma unroll
    for (int nt = 0; nt < MAX_N / 8; ++nt) {
      const int n = 8 * nt + 2 * cq;
      if (n >= a.N) continue;
      if (ra < a.L) store2<T>(DBo + ra * orow + n, dB[nt][0], dB[nt][1]);
      if (rb < a.L) store2<T>(DBo + rb * orow + n, dB[nt][2], dB[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------
// b4: ddt and the dA partials, one thread per (rank, batch, chunk, head)
// ---------------------------------------------------------------------

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

template <typename T, int TI>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t su = USmem<T>::BYTES, sg = GradSmem<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_u_kernel<T, TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(su));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_grads_kernel<T, TI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sg));
  if (err != cudaSuccess) return err;
  const long long rb = static_cast<long long>(a.R) * a.Bt;
  const unsigned groups = static_cast<unsigned>(rb * a.nc * a.G);
  ssd_bwd_u_kernel<T, TI><<<groups, THREADS, su, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_handoff_kernel<<<blocks_of(rb * a.H * a.N * a.P / 4), THREADS, 0,
                           stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_grads_kernel<T, TI><<<groups, THREADS, sg, stream>>>(a);
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
  if (dtype == 0) return launch<float, 3>(args, st);
  if (dtype == 1) return launch<__nv_bfloat16, 1>(args, st);
  return cudaErrorInvalidValue;
}
