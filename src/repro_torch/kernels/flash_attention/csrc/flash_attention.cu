// Tiled online-softmax attention (flash attention, forward), written by
// hand for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (body _kernel), the JAX package's Pallas TPU
// kernel, with its GQA wrapper repro/kernels/flash_attention/ops.py.
//
// Layout, the model's: q (N, S, H, d), k and v (N, T, KV, d), read through
// three strides each with a unit inner stride; out (N, S, H, d) in q's
// dtype.  N is stacked ranks x batch.  Grouped-query attention reads kv
// head h / (H / KV) for q head h: the repeated K and V of the JAX wrapper
// are never materialised.  f32 or bf16 inputs; every product, the running
// max m, the running sum l and the accumulator are fp32.  d is one of 16,
// 32, 64, 128, 256 (the wrapper zero-pads any other d up to one of them).
//
// Semantics, those of the Pallas kernel:
// - s = (q . k) * scale, then the tanh softcap c * tanh(s / c) when c != 0;
// - a masked score is the finite NEG_INF = -1e30, and its probability is
//   set to exactly 0: k_pos >= T (the padded kv tail); with causal,
//   k_pos > q_pos (positions unshifted, both from 0, also when S != T);
//   with a window w, k_pos <= q_pos - w;
// - the output is acc / max(l, 1e-30) (IEEE division: no --use_fast_math),
//   so a row with no visible key comes out 0;
// - padded q rows (q_pos >= S) are computed and never written.
// A kv tile in which every score is masked leaves (m, l, acc) exactly as
// they were (m_new = m, p = 0, corr = exp(0) = 1), so such tiles are
// skipped: with causal, tiles past the q tile's last row; with a window,
// tiles wholly before its first row's window.
//
// What bounds it on this card: operations.  At the serving shape (N 16,
// S = T = 1024, 8 q heads over 2 kv heads, d 128, causal, bf16) it must
// move 84 MB and do 34 GFLOP of products, ~410 operations per byte: above
// the card's ~295 (989 TFLOP/s over 3.35 TB/s).
//
// What the design does about it (a simple design), in two paths:
// - bf16 with d <= 128 (the serving path) runs on the tensor cores:
//   mma.sync m16n8k16 with fp32 accumulation, below;
// - f32 inputs, which must hold 3e-5 against the plain version (no TF32 or
//   bf16 tensor cores), and d = 256 run on fp32 FMA:
// - one block of 256 threads per (q tile of 64 rows, q head, n); a loop
//   over 64-row kv tiles takes the place of Pallas' sequential grid axis,
//   with (m, l, acc) in registers;
// - Q, K and V tiles are staged in shared memory as fp32, rows padded by
//   one word so that column reads are free of bank conflicts; the
//   probability tile P reuses the K tile's buffer;
// - each thread owns a 4 x 4 block of the 64 x 64 score tile (rows 4ty..,
//   columns tx + 16j) and the same 4 rows x d/16 columns of the output;
//   the row max and sum are warp shuffles within the 16 threads of a row.
// The tensor-core path rounds the probabilities to bf16 for P . V (the
// Pallas kernel multiplies them in fp32) and takes them as exp2 of scores
// in log2 units: one more bf16 rounding and a few f32 ulps, inside the
// 2e-2 that bf16 outputs are held to.
// Both launch on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads: ty = row group, tx = column
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs0, qs1, qs2;
  long long ks0, ks1, ks2;
  long long vs0, vs1, vs2;
  long long os0, os1, os2;
  int S, T, rep;
  float scale;
  int causal, has_window, window;
  float softcap;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// max that propagates NaN, as jnp.max / jnp.maximum do (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

template <int D>
struct Smem {
  static constexpr int LD = D + 1;    // padded Q / K row
  static constexpr int LDP = BK + 1;  // padded P row
  static constexpr int K_ELEMS = BK * LD > BQ * LDP ? BK * LD : BQ * LDP;
  static constexpr size_t BYTES =
      sizeof(float) * (BQ * LD + K_ELEMS + BK * D);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Args a) {
  constexpr int LD = Smem<D>::LD;
  constexpr int LDP = Smem<D>::LDP;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                       // BQ x LD
  float* sK = sQ + BQ * LD;               // BK x LD, then P: BQ x LDP
  float* sV = sK + Smem<D>::K_ELEMS;      // BK x D

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kvh = h / a.rep;
  const T* Q = static_cast<const T*>(a.q) + n * a.qs0 + h * a.qs2;
  const T* K = static_cast<const T*>(a.k) + n * a.ks0 + kvh * a.ks2;
  const T* V = static_cast<const T*>(a.v) + n * a.vs0 + kvh * a.vs2;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    sQ[r * LD + c] = qr < a.S ? to_f32(Q[qr * a.qs1 + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that can hold a visible key for some row of this q tile
  int hi = a.T;
  if (a.causal) hi = min(hi, q0 + BQ);
  int lo = 0;
  if (a.has_window) lo = max(0, q0 - a.window + 1) / BK * BK;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the last tile's P and V are consumed (and Q is in)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool in = kr < a.T;
      sK[r * LD + c] = in ? to_f32(K[kr * a.ks1 + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(V[kr * a.vs1 + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, softcap, mask; online-softmax update of (m, l, acc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      unsigned ok = 0;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool vis = kp < a.T;
        if (a.causal) vis = vis && kp <= qp;
        if (a.has_window) vis = vis && kp > qp - a.window;
        s[i][j] = vis ? x : NEG_INF;
        ok |= (vis ? 1u : 0u) << j;
        rmax = max_nan(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = max_nan(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = max_nan(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every score is read out of the K tile
    float* sP = sK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = sV[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= a.S) continue;
    const float denom = max_nan(l[i], 1e-30f);
    T* O = static_cast<T*>(a.o) + n * a.os0 + qr * a.os1 + h * a.os2;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(O + tx + 16 * c, acc[i][c] / denom);
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16 with fp32 accumulation
// ---------------------------------------------------------------------
//
// One block of 4 warps per (q tile of 64 rows, q head, n); warp w owns q
// rows 16w .. 16w + 15.  Q, K and V tiles are staged in shared memory as
// bf16 rows padded by 16 bytes (ldmatrix reads 8 rows of 16 bytes from
// distinct banks), copied with cp.async: every 16-byte copy of a tile is
// in flight at once, and K/V are double-buffered, so tile i + 1 lands
// while tile i is computed.  A warp skips a kv tile that masks all of its
// own rows.  Per kv tile of 64 keys a warp computes its 16 x 64
// scores with 4 x (d/16) mma.sync from Q fragments held in registers and K
// fragments read by ldmatrix; the online softmax runs on the score
// fragments (a row's 64 scores live in the 4 lanes of a quad: two
// shuffles); the probabilities are rounded to bf16 and fed straight back as
// the A operand of P . V, with V fragments read by ldmatrix.trans.  The
// output accumulator (16 x d per warp) stays in registers.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;

template <int D>
struct MmaSmem {
  static constexpr int LDS = D + 8;  // bf16 per padded row (16 B of pad)
  // Q, then K and V in two stages each
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * 5 * BQ * LDS;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Issue the cp.async copies of rows [r0, r0 + 64) of a (rows, D) bf16
// matrix with row stride `ld` (elements, a multiple of 8) into padded
// shared rows; rows >= n are zero-filled (a 0-byte source).  The caller
// commits the group.
template <int D>
__device__ __forceinline__ void copy_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long ld, int r0, int n) {
  constexpr int LDS = MmaSmem<D>::LDS;
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  static_assert(BQ * VEC % MMA_THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < BQ * VEC / MMA_THREADS; ++it) {
    const int i = it * MMA_THREADS + threadIdx.x;
    const int r = i / VEC, c = (i % VEC) * 8;
    const bool in = r0 + r < n;
    const __nv_bfloat16* from = in ? src + (r0 + r) * ld + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst + r * LDS + c)), "l"(from),
                    "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(const Args a) {
  constexpr int LDS = MmaSmem<D>::LDS;
  constexpr int KD = D / 16;   // k16 steps over the head dim
  constexpr int NS = BK / 8;   // score n-tiles per kv tile
  constexpr int ND = D / 8;    // output n-tiles
  extern __shared__ uint4 smem_v4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_v4);
  __nv_bfloat16* sK0 = sQ + BQ * LDS;     // K stage 0, then stage 1
  __nv_bfloat16* sV0 = sK0 + 2 * BK * LDS;  // V stage 0, then stage 1

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int kvh = h / a.rep;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(a.q) + n * a.qs0 + h * a.qs2;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(a.k) + n * a.ks0 + kvh * a.ks2;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(a.v) + n * a.vs0 + kvh * a.vs2;

  int hi = a.T;
  if (a.causal) hi = min(hi, q0 + BQ);
  int lo = 0;
  if (a.has_window) lo = max(0, q0 - a.window + 1) / BK * BK;

  copy_tile_async<D>(sQ, Q, a.qs1, q0, a.S);
  cp_async_commit();
  if (lo < hi) {  // the first kv tile, stage 0
    copy_tile_async<D>(sK0, K, a.ks1, lo, a.T);
    copy_tile_async<D>(sV0, V, a.vs1, lo, a.T);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q is in
  __syncthreads();
  unsigned qf[KD][4];  // this warp's 16 q rows as A fragments
  {
    const int mi = lane >> 3;
    const int row = warp * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], sQ + row * LDS + kk * 16 + (mi >> 1) * 8);
  }

  const int qp0 = q0 + warp * 16 + g;  // this lane's two rows: qp0, qp0 + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // the rows this warp owns: [wq0, wq0 + 16)
  const int wq0 = q0 + warp * 16;
  // scores go to log2 units here, or after the softcap's tanh
  const float scale2 = a.softcap != 0.f ? a.scale : a.scale * LOG2E;
  for (int k0 = lo, stage = 0; k0 < hi; k0 += BK, stage ^= 1) {
    const __nv_bfloat16* sK = sK0 + stage * BK * LDS;
    const __nv_bfloat16* sV = sV0 + stage * BK * LDS;
    if (k0 + BK < hi) {  // prefetch the next tile into the other stage
      copy_tile_async<D>(sK0 + (stage ^ 1) * BK * LDS, K, a.ks1, k0 + BK,
                         a.T);
      copy_tile_async<D>(sV0 + (stage ^ 1) * BK * LDS, V, a.vs1, k0 + BK,
                         a.T);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile is in
    __syncthreads();

    // a tile that masks every row of this warp changes nothing
    const bool skip = (a.causal && k0 > wq0 + 15) ||
                      (a.has_window && k0 + BK - 1 <= wq0 - a.window);
    if (!skip) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      {
        const int mi = lane >> 3;
        const int key = (mi >> 1) * 8 + (lane & 7);
        const int col = (mi & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
#pragma unroll
          for (int j = 0; j < NS; j += 2) {
            unsigned b[4];
            ldmatrix_x4(b, sK + (j * 8 + key) * LDS + kk * 16 + col);
            mma_bf16(s[j], qf[kk], b[0], b[1]);
            mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
          }
      }

      // scale, softcap, mask; online-softmax update of (m, l, o).  Scores,
      // m and the exponents are in log2 units (x * log2(e)), so that
      // p = exp2(x - m) is one MUFU.EX2; the masks are only evaluated on
      // a tile that is not visible in full to all of this warp's rows.
      const bool full = k0 + BK <= a.T &&
                        (!a.causal || k0 + BK - 1 <= wq0) &&
                        (!a.has_window || k0 > wq0 + 15 - a.window);
      float rmax[2] = {NEG_INF, NEG_INF};
      unsigned ok = 0;  // bit 4j + e: score (j, e) is visible
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (a.softcap != 0.f)
            x = a.softcap * tanhf(x / a.softcap) * LOG2E;
          bool vis = true;
          if (!full) {
            const int qp = qp0 + (e >> 1) * 8;
            const int kp = k0 + j * 8 + 2 * c + (e & 1);
            vis = kp < a.T;
            if (a.causal) vis = vis && kp <= qp;
            if (a.has_window) vis = vis && kp > qp - a.window;
          }
          s[j][e] = vis ? x : NEG_INF;
          ok |= (vis ? 1u : 0u) << (4 * j + e);
          rmax[e >> 1] = max_nan(rmax[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rmax[r] = max_nan(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
        rmax[r] = max_nan(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
        const float m_new = max_nan(m[r], rmax[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (ok >> (4 * j + e)) & 1u ? exp2f(s[j][e] - m[e >> 1])
                                              : 0.f;
          rsum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
        l[r] = l[r] * corr[r] + rsum[r];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }

      // o += P . V: the score fragments of n-tiles 2t, 2t+1 are the A
      // fragment of keys 16t .. 16t + 15
      {
        const int mi = lane >> 3;
        const int key = (mi & 1) * 8 + (lane & 7);
        const int col = (mi >> 1) * 8;
#pragma unroll
        for (int t = 0; t < BK / 16; ++t) {
          const unsigned pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                                  pack_bf16(s[2 * t][2], s[2 * t][3]),
                                  pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                                  pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
          for (int j = 0; j < ND; j += 2) {
            unsigned b[4];
            ldmatrix_x4_trans(b, sV + (t * 16 + key) * LDS + j * 8 + col);
            mma_bf16(o[j], pa, b[0], b[1]);
            mma_bf16(o[j + 1], pa, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = qp0 + r * 8;
    if (qr >= a.S) continue;
    const float denom = max_nan(l[r], 1e-30f);
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + n * a.os0 +
                       qr * a.os1 + h * a.os2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(O + j * 8 + 2 * c) =
          __floats2bfloat162_rn(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int N, int H, cudaStream_t stream) {
  const size_t smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, H, N);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a, int N, int H, cudaStream_t stream) {
  const size_t smem = MmaSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, H, N);
  flash_attention_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int d, int N, int H,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, N, H, stream);
    case 32: return launch<T, 32>(a, N, H, stream);
    case 64: return launch<T, 64>(a, N, H, stream);
    case 128: return launch<T, 128>(a, N, H, stream);
    case 256: return launch<T, 256>(a, N, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements; the inner stride
// of every tensor is 1.  window < 0 means no window, softcap 0 no softcap.
// Every row of q, k, v and out starts 16-byte aligned (pointers and
// strides), as the tensor-core path's 16-byte loads need: bf16 with
// d <= 128 takes that path, f32 and d = 256 the fp32 FMA path.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int d,
    int N, int S, int T, int H, int KV, long long qs0, long long qs1,
    long long qs2, long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2, long long os0,
    long long os1, long long os2, float scale, int causal, int window,
    float softcap, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T < 0)
    return cudaErrorInvalidValue;
  Args a{q,   k,   v,   o,   qs0, qs1, qs2, ks0, ks1, ks2,   vs0,
         vs1, vs2, os0, os1, os2, S,   T,   H / KV, scale, causal,
         window >= 0 ? 1 : 0, window, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, d, N, H, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_mma<16>(a, N, H, st);
    case 32: return launch_mma<32>(a, N, H, st);
    case 64: return launch_mma<64>(a, N, H, st);
    case 128: return launch_mma<128>(a, N, H, st);
    default: return launch_d<__nv_bfloat16>(a, d, N, H, st);
  }
}
