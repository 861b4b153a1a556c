// Tiled online-softmax attention (flash attention, forward), written by
// hand for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (body _kernel), the JAX package's Pallas TPU
// kernel, with its GQA wrapper repro/kernels/flash_attention/ops.py.
//
// Layout, the model's: q (N, S, H, d), k (N, T, KV, d) and v (N, T, KV,
// d_v), read through three strides each with a unit inner stride; out (N,
// S, H, d_v) in q's dtype.  N is stacked ranks x batch.  Grouped-query
// attention reads kv head h / (H / KV) for q head h: the repeated K and V
// of the JAX wrapper are never materialised.  f32 or bf16 inputs; every
// product, the running max m, the running sum l and the accumulator are
// fp32.  d = d_v is one of 16, 32, 64, 128, 256 for f32 and one of 64,
// 128, 256 for bf16, or bf16 d 192 with d_v 128 (MLA's); the wrapper
// zero-pads any other pair up to one of them (ops.py::route).
//
// Semantics, those of the Pallas kernel:
// - s = (q . k) * scale, then the tanh softcap c * tanh(s / c) when c != 0;
// - a masked score is the finite NEG_INF = -1e30, and its probability is
//   set to exactly 0: k_pos >= T (the padded kv tail); with causal,
//   k_pos > q_pos (positions unshifted, both from 0, also when S != T);
//   with a window w, k_pos <= q_pos - w;
// - the output is acc / max(l, 1e-30) (IEEE division: no --use_fast_math;
//   the wgmma path multiplies by the IEEE reciprocal, within an f32 ulp,
//   before the bf16 rounding), so a row with no visible key comes out 0;
// - padded q rows (q_pos >= S) are computed and never written.
// A kv tile in which every score is masked leaves (m, l, acc) exactly as
// they were (m_new = m, p = 0, corr = exp(0) = 1), so such tiles are
// skipped: with causal, tiles past the q tile's last row; with a window,
// tiles wholly before its first row's window.
//
// What bounds it on this card: operations.  At the serving shape (N 16,
// S = T = 1024, 8 q heads over 2 kv heads, d 128, causal, bf16) it must
// move 84 MB and do 34 GFLOP of products, ~410 operations per byte: above
// the card's ~295 (989 TFLOP/s over 3.35 TB/s).  Only wgmma reaches the
// tensor cores' rate; mma.sync, which the first version ran, cannot.
//
// At d 256 (gemma3-1b: N 16, S = T = 1024, 4 q heads over 1 kv head,
// causal, window 512) it must move 84 MB and do 25.8 GFLOP, ~307
// operations per byte: operations again, just.  Its bf16 tiles press on
// the block's limits: O alone is 64 x 256 f32 over a warpgroup, 128
// registers a thread, and Q for 128 rows is 64 KB of shared memory.
//
// What the design does about it, three kernels chosen by dtype and d in
// flash_attention_launch:
// - bf16 with d = 64 or 128 (the serving path; bf16 head dims below 64 are
//   padded to 64: a 128-byte swizzled row holds 64 bf16),
//   flash_attention_wgmma_kernel,
//   persistent: one block per SM walks the (q tile of 128 rows, head, n)
//   work items, longest causal q tiles first.  Warp 8 is the producer: one
//   thread issues TMA loads (4-D tensor maps over (d, heads, seq, n),
//   128-byte swizzle, out-of-range rows zero-filled) of each item's Q
//   (two buffers) and of its K and V tiles of 64 rows into a 2-stage
//   ring, each stage's K and V guarded by a full/empty mbarrier pair; it
//   runs ahead across items, so the next item's loads overlap this one's
//   tail and epilogue.  Warpgroups 0 and 1 each own 64 q rows: S = Q . K^T
//   is wgmma m64n64k16 with both operands in shared memory; the online
//   softmax runs on the accumulator fragment (a row's max and sum are
//   shuffles in its quad; the exponent is one FMA of the raw score into
//   log2 units and one ex2.approx.ftz; max.NaN propagates NaN; masks only
//   on tiles not wholly visible); P is rounded to bf16 in registers and is
//   the register A operand of O += P . V (wgmma m64n{d}k16, V read MN-major
//   through the descriptor's transpose bit).  O stays in registers and is
//   written once per item.  Kv tiles are 64 rows, not 128: with nine warps
//   a block gets at most 168 registers a thread, and at 128 ptxas
//   serialised every wgmma (C7512, insufficient registers; setmaxnreg with
//   a producer warpgroup did not lift it);
// - bf16 with d = 256 (gemma3-1b; bf16 head dims over 128 are padded to
//   256), flash_attention_wgmma256_kernel, the same design with these
//   changes.  Registers: O (128), S (32), P (16) and the row stats are
//   ~190 a thread, over the 168 of a nine-warp block, so the producer is a
//   whole warpgroup that drops to 40 registers (setmaxnreg) while the two
//   consumer warpgroups rise to 232, as the backward's kernels do.  Shared
//   memory: one Q buffer (64 KB) and a 2-stage ring of 64-row K and V tiles
//   (128 KB), 192 KB; two Q buffers with 32-row kv tiles (also 192 KB)
//   were slower (examples/flash_tiling_torch.py times both: on an H100
//   80GB HBM3 at gemma3's local shape, 91.5 against 112.5 us).
//   A warpgroup frees the Q buffer after the item's last S, so the next
//   item's Q lands during the last tile's softmax, P . V and epilogue.
//   S = Q . K^T is issued a 64-column half at a time (four descriptors of
//   each operand live at once, not sixteen), and O += P . V is one
//   m64n256k16 a k-step.  Items are walked in the backward's snake order
//   (every other round of blocks reversed), which evens out the causal
//   items' lengths across blocks;
// - bf16 with q/k head dim 192 and v head dim 128 (deepseek-v3's MLA:
//   128 nope + 64 rope; bf16 pairs with 128 < d <= 192 and d_v <= 128
//   are padded to it), flash_attention_wgmma192_kernel.  At its prefill
//   shape (N 16, S = T = 1024, 32 q heads over 32 kv heads, causal) it
//   must move 671 MB and do 172 GFLOP, ~256 operations per byte: bytes,
//   just, and no K/V tile is shared by two heads.  The d 256 form on
//   inputs zero-padded to 256 did 1.6x the work and spent ~46 % of its
//   call on the padding copies.  This form maps q and k at 192 columns
//   (three 64-column slices) and v at 128 (two), so it reads MLA's
//   tensors in place and does no product over a padded column.  Shared
//   memory: two Q buffers (48 KB each) and a 3-stage ring of 64-row K
//   (24 KB) and V (16 KB) tiles, 216 KB.  Registers a consumer thread: O
//   64 (at n 128), S 32, P 16, against the d 256 form's O of 128; that
//   room buys FA3's intra-warpgroup overlap: a warpgroup issues tile i's
//   S = Q . K^T, rescales O by tile i - 1's softmax while S runs, issues
//   tile i - 1's O += P . V (wgmma m64n128k16), waits for S alone, and
//   runs tile i's softmax while P . V runs.  Items are (n, head) slowest
//   and their q tiles longest first, so that the blocks at work read the
//   K and V of few (n, kv head)s, which stay in L2 (with 32 kv heads a
//   rank each q head has its own), and the snake order still evens out
//   the blocks' shares (q tile lengths 2, 4, ..., 16 kv tiles pair up to
//   18 a round at 132 SMs; examples/flash_tiling_torch.py times this
//   order against the other forms').  The softmax is theirs
//   (wg::softmax_probs).  Tried and dropped as slower: 128-row kv tiles with
//   one Q buffer (they spill at 232 registers), FA3's ping-pong of the
//   two warpgroups, a second S buffer to issue tile i + 1's S before tile
//   i's softmax (ptxas serialises the wgmmas, C7513 or C7515), three
//   consumer warpgroups (they spill at 160 registers); Q held as register
//   fragments gained next to nothing;
// - f32 inputs, which must hold 3e-5 against the plain version (no TF32 or
//   bf16 tensor cores), run on fp32 FMA, flash_attention_kernel:
//   - one block of 256 threads per (q tile of 64 rows, q head, n); a loop
//     over 64-row kv tiles takes the place of Pallas' sequential grid axis,
//     with (m, l, acc) in registers;
//   - Q, K and V tiles are staged in shared memory as fp32, rows padded by
//     one word so that column reads are free of bank conflicts; the
//     probability tile P reuses the K tile's buffer;
//   - each thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//     4ty.., columns tx + 16j) and the same 4 rows x d/16 columns of the
//     output; the row max and sum are warp shuffles within the 16 threads
//     of a row.
// The wgmma kernels round the probabilities to bf16 for P . V (the
// Pallas kernel multiplies them in fp32) and take them as exp2 of scores
// in log2 units: one more bf16 rounding and a few f32 ulps, inside the
// 2e-2 that bf16 outputs are held to.
// All launch on the caller's stream and allocate nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "hopper.cuh"
#include "tma_map.cuh"

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
  float* lse;  // (N, H, S) row log-sum-exp, or null (serving)
};

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

template <int D>
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
  const float* Q = static_cast<const float*>(a.q) + n * a.qs0 + h * a.qs2;
  const float* K = static_cast<const float*>(a.k) + n * a.ks0 + kvh * a.ks2;
  const float* V = static_cast<const float*>(a.v) + n * a.vs0 + kvh * a.vs2;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    sQ[r * LD + c] = qr < a.S ? Q[qr * a.qs1 + c] : 0.f;
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
      sK[r * LD + c] = in ? K[kr * a.ks1 + c] : 0.f;
      sV[r * D + c] = in ? V[kr * a.vs1 + c] : 0.f;
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
    if (a.lse != nullptr && tx == 0)
      a.lse[(n * gridDim.y + h) * a.S + qr] = m[i] + logf(denom);
    float* O = static_cast<float*>(a.o) + n * a.os0 + qr * a.os1 + h * a.os2;
#pragma unroll
    for (int c = 0; c < CPT; ++c) O[tx + 16 * c] = acc[i][c] / denom;
  }
}

// bf16 pair -> one 32-bit register (lo in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------------
// bf16, d = 64 or 128: wgmma fed by TMA, warp-specialised, persistent
// ---------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;         // q rows per work item: two warpgroups
constexpr int BN = 64;          // kv rows per tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int CONSUMERS = 2;    // warpgroups 0, 1; then one producer warp
constexpr int THREADS = 128 * CONSUMERS + 32;
constexpr int ROW = 128;        // bytes of one swizzled row: 64 bf16

// Two Q buffers, then K stages, then V stages, then the mbarriers.  A tile
// of d columns is d / 64 column halves, each rows x 128 B and 1024-byte
// aligned, as TMA's 128-byte swizzle writes it.
template <int D>
struct Smem {
  static constexpr int HALVES = D / 64;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;   // one K or V tile
  static constexpr uint32_t K_OFF = 2 * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BARS = 4 + 4 * STAGES;
  // + 1024 to align the dynamic buffer's start
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

// mbarrier slots: Q full and Q empty per buffer, then per stage K full,
// V full, K empty, V empty
__device__ __forceinline__ int bar_q_full(int b) { return b; }
__device__ __forceinline__ int bar_q_empty(int b) { return 2 + b; }
__device__ __forceinline__ int bar_k_full(int s) { return 4 + s; }
__device__ __forceinline__ int bar_v_full(int s) { return 4 + STAGES + s; }
__device__ __forceinline__ int bar_k_empty(int s) {
  return 4 + 2 * STAGES + s;
}
__device__ __forceinline__ int bar_v_empty(int s) {
  return 4 + 3 * STAGES + s;
}

// max that propagates NaN (max.NaN), as jnp.max does
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 2^x in one MUFU.EX2; a result below 2^-126 flushes to 0 (a probability
// that small changes no bf16 output)
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// A work item: q tile (longest first), head, n; its kv tiles of KB rows
struct Item {
  int q0, h, n, lo, nt;
};

template <int KB = BN>
__device__ __forceinline__ Item item(int w, int nq, int H, int N,
                                     const Args& a) {
  Item it;
  const int hn = H * N;
  it.q0 = (nq - 1 - w / hn) * BM;
  it.h = (w % hn) % H;
  it.n = (w % hn) / H;
  // kv tiles that can hold a visible key for some row of this item
  int hi = a.T;
  if (a.causal) hi = min(hi, it.q0 + BM);
  it.lo = 0;
  if (a.has_window) it.lo = max(0, it.q0 - a.window + 1) / KB * KB;
  it.nt = hi > it.lo ? (hi - it.lo + KB - 1) / KB : 0;
  return it;
}

// Scale, softcap and (MASK) mask one 64 x 2R score tile held as the
// accumulator fragment: register r is row qp0 + 8 ((r >> 1) & 1), key k0 +
// 8 (r >> 2) + 2c + (r & 1).  Without a softcap the scores stay raw (the
// exponent scales them: one FMA); with one they leave in log2 units.
// Hidden scores become NEG_INF with their bit in ok cleared; rmax takes
// the row maxima.
template <bool MASK, bool CAP, int R>
__device__ __forceinline__ void score_tile(float (&sc)[R], uint32_t& ok,
                                           float (&rmax)[2], const Args& a,
                                           float scale2, int qp0, int k0,
                                           int c) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = sc[r];
    if (CAP) x = a.softcap * tanhf(x * scale2 / a.softcap) * LOG2E;
    if (MASK) {
      const int qp = qp0 + ((r >> 1) & 1) * 8;
      const int kp = k0 + (r >> 2) * 8 + 2 * c + (r & 1);
      bool vis = kp < a.T;
      if (a.causal) vis = vis && kp <= qp;
      if (a.has_window) vis = vis && kp > qp - a.window;
      x = vis ? x : NEG_INF;
      ok |= (vis ? 1u : 0u) << r;
    }
    sc[r] = x;
    rmax[(r >> 1) & 1] = fmax_nan(rmax[(r >> 1) & 1], x);
  }
}

// The online-softmax update by one 64-row score tile of R registers a
// thread (the accumulator fragment), but for the output: scale, softcap
// and mask it (the mask only where `full` is false, a tile some score of
// which is hidden) and move (m, l); the scores become p = 2^(score - m), 0
// where hidden, and corr the factor by which the output's rows rescale
template <int R>
__device__ __forceinline__ void softmax_probs(float (&sc)[R],
                                              float (&corr)[2],
                                              float (&m)[2], float (&l)[2],
                                              const Args& a, bool full,
                                              bool cap, float scale2,
                                              float f, int qp0, int k0,
                                              int c) {
  float rmax[2] = {NEG_INF, NEG_INF};
  uint32_t ok = 0;
  if (full) {
    if (cap)
      score_tile<false, true>(sc, ok, rmax, a, scale2, qp0, k0, c);
    else
      score_tile<false, false>(sc, ok, rmax, a, scale2, qp0, k0, c);
  } else {
    if (cap)
      score_tile<true, true>(sc, ok, rmax, a, scale2, qp0, k0, c);
    else
      score_tile<true, false>(sc, ok, rmax, a, scale2, qp0, k0, c);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rmax[e] = fmax_nan(rmax[e], __shfl_xor_sync(0xffffffffu, rmax[e], 1));
    rmax[e] = fmax_nan(rmax[e], __shfl_xor_sync(0xffffffffu, rmax[e], 2));
    const float m_new = fmax_nan(m[e], rmax[e] * f);
    corr[e] = exp2_ftz(m[e] - m_new);
    m[e] = m_new;
  }
  // p = 2^(score - m); on a tile that hides some score, 0 where hidden
  float rsum[2] = {0.f, 0.f};
  if (full) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sc[r] = exp2_ftz(fmaf(sc[r], f, -m[(r >> 1) & 1]));
      rsum[(r >> 1) & 1] += sc[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float e2 = exp2_ftz(fmaf(sc[r], f, -m[(r >> 1) & 1]));
      sc[r] = (ok >> r) & 1u ? e2 : 0.f;
      rsum[(r >> 1) & 1] += sc[r];
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 1);
    rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 2);
    l[e] = l[e] * corr[e] + rsum[e];
  }
}

// o's rows times corr (the accumulator fragment's rows qp0, qp0 + 8)
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < NO; ++r) o[r] *= corr[(r >> 1) & 1];
}

// softmax_probs, then o rescaled: the update of a tile whose P . V follows
template <int R, int NO>
__device__ __forceinline__ void softmax_tile(float (&sc)[R], float (&o)[NO],
                                             float (&m)[2], float (&l)[2],
                                             const Args& a, bool full,
                                             bool cap, float scale2, float f,
                                             int qp0, int k0, int c) {
  float corr[2];
  softmax_probs(sc, corr, m, l, a, full, cap, scale2, f, qp0, k0, c);
  rescale(o, corr);
}

// the probability fragments of keys 16kt .. 16kt + 15 are the A fragment of
// k-step kt of P . V
template <int R>
__device__ __forceinline__ void pack_p(const float (&sc)[R],
                                       uint32_t (&p)[R / 8][4]) {
#pragma unroll
  for (int kt = 0; kt < R / 8; ++kt) {
    p[kt][0] = pack_bf16(sc[8 * kt + 0], sc[8 * kt + 1]);
    p[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
    p[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
    p[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
  }
}

// An item's rows qp0 and qp0 + 8 of the output (o / l in bf16) and, where
// asked, their log-sum-exp
template <int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO],
                                           const float (&m)[2],
                                           const float (&l)[2],
                                           const Args& a, const Item& it,
                                           int H, int qp0, int c) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qr = qp0 + 8 * e;
    if (qr >= a.S) continue;
    // one IEEE reciprocal per row: o * (1 / l) is within an f32 ulp of
    // o / l, far under the bf16 rounding that follows
    const float inv = 1.f / max_nan(l[e], 1e-30f);
    // m and the exponents are in log2 units: L = (m + log2 l) ln 2; a
    // row that sees no key (l = 0) gets NEG_INF + ln(1e-30) = NEG_INF in
    // f32, as the plain version and the FMA kernel give it
    if (a.lse != nullptr && c == 0)
      a.lse[(static_cast<long long>(it.n) * H + it.h) * a.S + qr] =
          l[e] == 0.f
              ? NEG_INF
              : (m[e] + log2f(max_nan(l[e], 1e-30f))) * 0.6931471805599453f;
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + it.n * a.os0 +
                       qr * a.os1 + it.h * a.os2;
#pragma unroll
    for (int jj = 0; jj < NO / 4; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(O + 8 * jj + 2 * c) =
          __floats2bfloat162_rn(o[4 * jj + 2 * e] * inv,
                                o[4 * jj + 2 * e + 1] * inv);
  }
}

}  // namespace wg

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&p)[4],
                                             uint64_t db) {
  hopper::wgmma_rs_n64(o, p, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&p)[4],
                                              uint64_t db) {
  hopper::wgmma_rs_n128(o, p, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&p)[4],
                                              uint64_t db) {
  hopper::wgmma_rs_n256(o, p, db);
}

// S (64 x BN) {+}= Q (64 x 16) . K^T (16 x BN), both from shared memory
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&sc)[BN / 2], uint64_t dq,
                                         uint64_t dk, int accumulate) {
  if constexpr (BN == 64)
    hopper::wgmma_ss_n64(sc, dq, dk, accumulate);
  else
    hopper::wgmma_ss_n32(sc, dq, dk, accumulate);
}

// Persistent: block b takes work items b, b + gridDim.x, ... of the nq * H
// * N (q tile, head, n) items, q tiles longest first.  The producer runs
// ahead across items: the next item's Q (two buffers) and K/V tiles land
// while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const Args a, const int nq, const int H,
                             const int N) {
  using namespace hopper;
  using L = wg::Smem<D>;
  constexpr int BM = wg::BM, BN = wg::BN, STAGES = wg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * i; };
  const int items = nq * H * N;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar(wg::bar_q_full(b)), 1);
      mbar_init(bar(wg::bar_q_empty(b)), 4 * wg::CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(wg::bar_k_full(s)), 1);
      mbar_init(bar(wg::bar_v_full(s)), 1);
      // one arrival per consumer warp
      mbar_init(bar(wg::bar_k_empty(s)), 4 * wg::CONSUMERS);
      mbar_init(bar(wg::bar_v_empty(s)), 4 * wg::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform (a shuffle from lane 0): the descriptors below stay in
  // uniform registers
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == wg::CONSUMERS) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x != 128 * wg::CONSUMERS) return;
    int tile = 0;  // tiles issued so far, across items
    for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
      const wg::Item it = wg::item(w, nq, H, N, a);
      const int kvh = it.h / a.rep;
      const int qb = j & 1;
      mbar_wait(bar(wg::bar_q_empty(qb)), ((j >> 1) & 1) ^ 1);
      mbar_expect_tx(bar(wg::bar_q_full(qb)), L::Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < L::HALVES; ++hf)
        tma_load_4d(base + qb * L::Q_BYTES + hf * BM * wg::ROW, &tmq,
                    bar(wg::bar_q_full(qb)), 64 * hf, it.h, it.q0, it.n);
      for (int i = 0; i < it.nt; ++i, ++tile) {
        const int s = tile % STAGES;
        const uint32_t free_parity = ((tile / STAGES) & 1) ^ 1;
        const int k0 = it.lo + i * BN;
        mbar_wait(bar(wg::bar_k_empty(s)), free_parity);
        mbar_expect_tx(bar(wg::bar_k_full(s)), L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < L::HALVES; ++hf)
          tma_load_4d(sK + s * L::KV_BYTES + hf * BN * wg::ROW, &tmk,
                      bar(wg::bar_k_full(s)), 64 * hf, kvh, k0, it.n);
        mbar_wait(bar(wg::bar_v_empty(s)), free_parity);
        mbar_expect_tx(bar(wg::bar_v_full(s)), L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < L::HALVES; ++hf)
          tma_load_4d(sV + s * L::KV_BYTES + hf * BN * wg::ROW, &tmv,
                      bar(wg::bar_v_full(s)), 64 * hf, kvh, k0, it.n);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns q rows [q0 + 64 wgi, + 64) ----
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int c = lane % 4;
  const bool cap = a.softcap != 0.f;
  // without a softcap the exponent is raw * scale2 - m, in log2 units;
  // with one, the softcap's output is taken to log2 units
  const float scale2 = cap ? a.scale : a.scale * LOG2E;
  const float f = cap ? 1.f : scale2;
  int tile = 0;
  for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
    const wg::Item it = wg::item(w, nq, H, N, a);
    const int wq0 = it.q0 + 64 * wgi;
    const int qp0 = wq0 + 16 * warp + lane / 4;  // rows qp0, qp0 + 8
    const int qb = j & 1;
    const uint32_t q_wg = base + qb * L::Q_BYTES + 64 * wgi * wg::ROW;

    float o[D / 2], sc[BN / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) sc[r] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t p[BN / 16][4];

    mbar_wait(bar(wg::bar_q_full(qb)), (j >> 1) & 1);
    for (int i = 0; i < it.nt; ++i, ++tile) {
      const int s = tile % STAGES;
      const uint32_t parity = (tile / STAGES) & 1;
      const int k0 = it.lo + i * BN;
      // a tile that masks every row of this warpgroup changes nothing; it
      // still takes part in the ring's hand-shakes
      const bool skip = (a.causal && k0 > wq0 + 63) ||
                        (a.has_window && k0 + BN - 1 <= wq0 - a.window);
      mbar_wait(bar(wg::bar_k_full(s)), parity);
      if (!skip) {
        // S = Q . K^T: d / 16 k-steps; a k-step is 32 bytes into a
        // 128-byte swizzled row, 64 columns per half
        const uint32_t k_s = sK + s * L::KV_BYTES;
        uint64_t dq[D / 16], dk[D / 16];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          dq[kk] = desc_sw128(q_wg + (kk / 4) * BM * wg::ROW + off, 16, 1024);
          dk[kk] = desc_sw128(k_s + (kk / 4) * BN * wg::ROW + off, 16, 1024);
        }
        fence_regs(dq);
        fence_regs(dk);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, dq[kk], dk[kk], kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(wg::bar_k_empty(s)));

      if (!skip) {
        // scale, softcap, mask (only on a tile some score of which is
        // hidden); online-softmax update of (m, l, o)
        const bool full = k0 + BN <= a.T &&
                          (!a.causal || k0 + BN - 1 <= wq0) &&
                          (!a.has_window || k0 > wq0 + 63 - a.window);
        wg::softmax_tile(sc, o, m, l, a, full, cap, scale2, f, qp0, k0, c);
        wg::pack_p(sc, p);
      }

      mbar_wait(bar(wg::bar_v_full(s)), parity);
      if (!skip) {
        // O += P . V: V is (kv rows = K, d = N), d contiguous: MN-major;
        // a k-step is 16 rows (2048 bytes), the next 64 columns the other
        // half (BN * 128 bytes on)
        const uint32_t v_s = sV + s * L::KV_BYTES;
        uint64_t dv[BN / 16];
#pragma unroll
        for (int kt = 0; kt < BN / 16; ++kt)
          dv[kt] = desc_sw128(v_s + kt * 16 * wg::ROW, BN * wg::ROW, 1024);
        fence_regs(dv);
#pragma unroll
        for (int kt = 0; kt < BN / 16; ++kt) fence_regs(p[kt]);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < BN / 16; ++kt) wgmma_pv<D>(o, p[kt], dv[kt]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(wg::bar_v_empty(s)));
    }
    // this item's Q buffer is free for the item after next
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(wg::bar_q_empty(qb)));

    wg::store_rows(o, m, l, a, it, H, qp0, c);
  }
}

// ---------------------------------------------------------------------
// bf16, d = 256: the same design, with a producer warpgroup that hands its
// registers to the consumers
// ---------------------------------------------------------------------

namespace wg256 {

constexpr int D = 256;
constexpr int HALVES = D / 64;
constexpr int CONSUMERS = 2;                    // warpgroups 0 and 1
constexpr int THREADS = 128 * (CONSUMERS + 1);  // warpgroup 2 loads
// 40 + 2 x 232 a thread of each SM sub-partition's three warps: the 3 x
// 168 that a block of 384 threads is launched with
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// QBUF Q buffers of BM rows, then the K stages, then the V stages (tiles
// of BN rows), then the mbarriers: Q full and Q empty per buffer, then per
// stage K full, V full, K empty, V empty
template <int BN, int QBUF>
struct Smem {
  static constexpr uint32_t Q_BYTES = wg::BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr uint32_t K_OFF = QBUF * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + wg::STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + wg::STAGES * KV_BYTES;
  static constexpr int BARS = 2 * QBUF + 4 * wg::STAGES;
  // + 1024 to align the dynamic buffer's start
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

}  // namespace wg256

// flash_attention_wgmma_kernel at d 256 (see the header): a producer
// warpgroup at 40 registers and two consumer warpgroups at 232, QBUF Q
// buffers and kv tiles of BN rows (the launcher takes 64 and 1;
// examples/flash_tiling_torch.py times 32 and 2); S = Q . K^T is issued a
// 64-column half at a time (four descriptors of each operand live at
// once), and a warpgroup frees the item's Q buffer after its last S, so
// that the next item's Q lands during the last tile's softmax, P . V and
// the epilogue.
template <int BN, int QBUF>
__global__ void __launch_bounds__(wg256::THREADS, 1)
flash_attention_wgmma256_kernel(const __grid_constant__ CUtensorMap tmq,
                                const __grid_constant__ CUtensorMap tmk,
                                const __grid_constant__ CUtensorMap tmv,
                                const Args a, const int nq, const int H,
                                const int N) {
  using namespace hopper;
  using L = wg256::Smem<BN, QBUF>;
  constexpr int D = wg256::D, BM = wg::BM, STAGES = wg::STAGES;
  constexpr int ROW = wg::ROW, CONSUMERS = wg256::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto q_full = [bars](int b) { return bars + 8u * b; };
  auto q_empty = [bars](int b) { return bars + 8u * (QBUF + b); };
  auto k_full = [bars](int s) { return bars + 8u * (2 * QBUF + s); };
  auto v_full = [bars](int s) {
    return bars + 8u * (2 * QBUF + STAGES + s);
  };
  auto k_empty = [bars](int s) {
    return bars + 8u * (2 * QBUF + 2 * STAGES + s);
  };
  auto v_empty = [bars](int s) {
    return bars + 8u * (2 * QBUF + 3 * STAGES + s);
  };
  const int items = nq * H * N;

  if (threadIdx.x == 0) {
    for (int b = 0; b < QBUF; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), 4 * CONSUMERS);  // one arrival a consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * CONSUMERS);
      mbar_init(v_empty(s), 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform (a shuffle from lane 0): the paths split here once
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dec<wg256::PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const wg::Item it = wg::item<BN>(w, nq, H, N, a);
        const int kvh = it.h / a.rep;
        const int qb = j % QBUF;
        mbar_wait(q_empty(qb), ((j / QBUF) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), L::Q_BYTES);
#pragma unroll
        for (int hf = 0; hf < wg256::HALVES; ++hf)
          tma_load_4d(base + qb * L::Q_BYTES + hf * BM * ROW, &tmq,
                      q_full(qb), 64 * hf, it.h, it.q0, it.n);
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const uint32_t free_parity = ((tile / STAGES) & 1) ^ 1;
          const int k0 = it.lo + i * BN;
          mbar_wait(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
          for (int hf = 0; hf < wg256::HALVES; ++hf)
            tma_load_4d(sK + s * L::KV_BYTES + hf * BN * ROW, &tmk,
                        k_full(s), 64 * hf, kvh, k0, it.n);
          mbar_wait(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
          for (int hf = 0; hf < wg256::HALVES; ++hf)
            tma_load_4d(sV + s * L::KV_BYTES + hf * BN * ROW, &tmv,
                        v_full(s), 64 * hf, kvh, k0, it.n);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns q rows [q0 + 64 wgi, + 64) ----
    regs_inc<wg256::CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const bool cap = a.softcap != 0.f;
    const float scale2 = cap ? a.scale : a.scale * LOG2E;
    const float f = cap ? 1.f : scale2;
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const wg::Item it = wg::item<BN>(w, nq, H, N, a);
      const int wq0 = it.q0 + 64 * wgi;
      const int qp0 = wq0 + 16 * warp + lane / 4;  // rows qp0, qp0 + 8
      const int qb = j % QBUF;
      const uint32_t q_wg = base + qb * L::Q_BYTES + 64 * wgi * ROW;

      float o[D / 2], sc[BN / 2];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) sc[r] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      uint32_t p[BN / 16][4];

      mbar_wait(q_full(qb), (j / QBUF) & 1);
      for (int i = 0; i < it.nt; ++i, ++tile) {
        const int s = tile % STAGES;
        const uint32_t parity = (tile / STAGES) & 1;
        const int k0 = it.lo + i * BN;
        const bool skip = (a.causal && k0 > wq0 + 63) ||
                          (a.has_window && k0 + BN - 1 <= wq0 - a.window);
        mbar_wait(k_full(s), parity);
        if (!skip) {
          // S = Q . K^T, 16 k-steps issued a 64-column half at a time
          const uint32_t k_s = sK + s * L::KV_BYTES;
          fence_regs(sc);
#pragma unroll
          for (int hf = 0; hf < wg256::HALVES; ++hf) {
            uint64_t dq[4], dk[4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              dq[kk] = desc_sw128(q_wg + hf * BM * ROW + kk * 32, 16, 1024);
              dk[kk] = desc_sw128(k_s + hf * BN * ROW + kk * 32, 16, 1024);
            }
            fence_regs(dq);
            fence_regs(dk);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_qk<BN>(sc, dq[kk], dk[kk], hf > 0 || kk > 0);
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(sc);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(k_empty(s));
          // the item's last S has read this warpgroup's Q rows
          if (i == it.nt - 1) mbar_arrive(q_empty(qb));
        }

        if (!skip) {
          const bool full = k0 + BN <= a.T &&
                            (!a.causal || k0 + BN - 1 <= wq0) &&
                            (!a.has_window || k0 > wq0 + 63 - a.window);
          wg::softmax_tile(sc, o, m, l, a, full, cap, scale2, f, qp0, k0, c);
          wg::pack_p(sc, p);
        }

        mbar_wait(v_full(s), parity);
        if (!skip) {
          // O += P . V: one m64n256k16 a k-step of 16 kv rows, V read
          // MN-major over its four 64-column halves (BN * 128 bytes apart)
          const uint32_t v_s = sV + s * L::KV_BYTES;
          uint64_t dv[BN / 16];
#pragma unroll
          for (int kt = 0; kt < BN / 16; ++kt)
            dv[kt] = desc_sw128(v_s + kt * 16 * ROW, BN * ROW, 1024);
          fence_regs(dv);
#pragma unroll
          for (int kt = 0; kt < BN / 16; ++kt) fence_regs(p[kt]);
          fence_regs(o);
          wgmma_fence();
#pragma unroll
          for (int kt = 0; kt < BN / 16; ++kt) wgmma_pv<D>(o, p[kt], dv[kt]);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty(s));
      }
      if (it.nt == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty(qb));
      }
      wg::store_rows(o, m, l, a, it, H, qp0, c);
    }
  }
}

// ---------------------------------------------------------------------
// bf16, q/k head dim 192 and v head dim 128 (MLA): read in place; inside a
// consumer warpgroup the softmax of one tile runs while P . V of the tile
// before it does
// ---------------------------------------------------------------------

namespace wg192 {

constexpr int DQK = 192, DV = 128;
constexpr int QS = DQK / 64, VS = DV / 64;  // 64-column slices
constexpr int BM = wg::BM, BN = wg::BN;     // q rows an item, kv rows a tile

// QBUF Q buffers of BM rows (QS slices), then the K stages (QS slices of BN
// rows), then the V stages (VS slices), then the mbarriers: Q full and Q
// empty per buffer, then per stage K full, V full, K empty, V empty
template <int QBUF, int STAGES>
struct Smem {
  static constexpr uint32_t Q_BYTES = BM * DQK * 2;  // 48 KB
  static constexpr uint32_t K_BYTES = BN * DQK * 2;  // 24 KB
  static constexpr uint32_t V_BYTES = BN * DV * 2;   // 16 KB
  static constexpr uint32_t K_OFF = QBUF * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int BARS = 2 * QBUF + 4 * STAGES;
  // + 1024 to align the dynamic buffer's start
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

// Work item w of the nq * H * N: (n, q head) slowest, then its q tiles
// longest first, so that the blocks at work at one time read the K and V
// of few (n, kv head)s, which stay in L2 between them
__device__ __forceinline__ wg::Item item(int w, int nq, int H,
                                         const Args& a) {
  wg::Item it;
  const int nh = w / nq;
  it.q0 = (nq - 1 - w % nq) * BM;
  it.h = nh % H;
  it.n = nh / H;
  // kv tiles that can hold a visible key for some row of this item
  int hi = a.T;
  if (a.causal) hi = min(hi, it.q0 + BM);
  it.lo = 0;
  if (a.has_window) it.lo = max(0, it.q0 - a.window + 1) / BN * BN;
  it.nt = hi > it.lo ? (hi - it.lo + BN - 1) / BN : 0;
  return it;
}

// S (64 x BN) = Q (64 rows of the warpgroup) . K^T over the QS 64-column
// slices, one commit group a slice (four descriptors of each operand live
// at once)
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t q_wg,
                                         uint32_t k_s) {
  using namespace hopper;
  fence_regs(sc);
#pragma unroll
  for (int hf = 0; hf < QS; ++hf) {
    uint64_t dq[4], dk[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dq[kk] = desc_sw128(q_wg + hf * BM * wg::ROW + kk * 32, 16, 1024);
      dk[kk] = desc_sw128(k_s + hf * BN * wg::ROW + kk * 32, 16, 1024);
    }
    fence_regs(dq);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sc, dq[kk], dk[kk], hf > 0 || kk > 0);
    wgmma_commit();
  }
}

// O (64 x DV) += P (64 x BN, bf16 registers) . V: V read MN-major over its
// VS slices (BN * 128 bytes apart), a k-step 16 kv rows; one commit group
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         uint32_t (&p)[BN / 16][4],
                                         uint32_t v_s) {
  using namespace hopper;
  uint64_t dv[BN / 16];
#pragma unroll
  for (int kt = 0; kt < BN / 16; ++kt)
    dv[kt] = desc_sw128(v_s + kt * 16 * wg::ROW, BN * wg::ROW, 1024);
  fence_regs(dv);
#pragma unroll
  for (int kt = 0; kt < BN / 16; ++kt) fence_regs(p[kt]);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < BN / 16; ++kt) wgmma_rs_n128(o, p[kt], dv[kt]);
  wgmma_commit();
}

}  // namespace wg192

// The forward at q/k head dim 192 and v head dim 128 (see the header): q
// and k mapped at 192 columns, v and the output at 128, nothing padded; a
// producer warpgroup at 40 registers and two consumer warpgroups at 232,
// QBUF Q buffers and a STAGES-deep ring of 64-row kv tiles (the launcher
// takes 2 and 3; examples/flash_tiling_torch.py times 1 and 4).  A
// consumer warpgroup walks the kv tiles [ia, ib) that show some of its
// rows a key: it issues tile i's S, rescales O by tile i - 1's softmax
// while S runs, issues tile i - 1's P . V, waits for S alone and runs tile
// i's softmax while P . V runs (FA3's intra-warpgroup overlap).  The tiles
// before ia and from ib on only take part in the ring's hand-shakes.
template <int QBUF, int STAGES>
__global__ void __launch_bounds__(wg256::THREADS, 1)
flash_attention_wgmma192_kernel(const __grid_constant__ CUtensorMap tmq,
                                const __grid_constant__ CUtensorMap tmk,
                                const __grid_constant__ CUtensorMap tmv,
                                const Args a, const int nq, const int H,
                                const int N) {
  using namespace hopper;
  using L = wg192::Smem<QBUF, STAGES>;
  constexpr int BM = wg192::BM, BN = wg192::BN, ROW = wg::ROW;
  constexpr int CONSUMERS = wg256::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto q_full = [bars](int b) { return bars + 8u * b; };
  auto q_empty = [bars](int b) { return bars + 8u * (QBUF + b); };
  auto k_full = [bars](int s) { return bars + 8u * (2 * QBUF + s); };
  auto v_full = [bars](int s) {
    return bars + 8u * (2 * QBUF + STAGES + s);
  };
  auto k_empty = [bars](int s) {
    return bars + 8u * (2 * QBUF + 2 * STAGES + s);
  };
  auto v_empty = [bars](int s) {
    return bars + 8u * (2 * QBUF + 3 * STAGES + s);
  };
  const int items = nq * H * N;

  if (threadIdx.x == 0) {
    for (int b = 0; b < QBUF; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), 4 * CONSUMERS);  // one arrival a consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * CONSUMERS);
      mbar_init(v_empty(s), 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform (a shuffle from lane 0): the paths split here once
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dec<wg256::PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const wg::Item it = wg192::item(w, nq, H, a);
        const int kvh = it.h / a.rep;
        const int qb = j % QBUF;
        mbar_wait(q_empty(qb), ((j / QBUF) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), L::Q_BYTES);
#pragma unroll
        for (int hf = 0; hf < wg192::QS; ++hf)
          tma_load_4d(base + qb * L::Q_BYTES + hf * BM * ROW, &tmq,
                      q_full(qb), 64 * hf, it.h, it.q0, it.n);
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const uint32_t free_parity = ((tile / STAGES) & 1) ^ 1;
          const int k0 = it.lo + i * BN;
          mbar_wait(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), L::K_BYTES);
#pragma unroll
          for (int hf = 0; hf < wg192::QS; ++hf)
            tma_load_4d(sK + s * L::K_BYTES + hf * BN * ROW, &tmk, k_full(s),
                        64 * hf, kvh, k0, it.n);
          mbar_wait(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), L::V_BYTES);
#pragma unroll
          for (int hf = 0; hf < wg192::VS; ++hf)
            tma_load_4d(sV + s * L::V_BYTES + hf * BN * ROW, &tmv, v_full(s),
                        64 * hf, kvh, k0, it.n);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns q rows [q0 + 64 wgi, + 64) ----
    regs_inc<wg256::CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const bool cap = a.softcap != 0.f;
    const float scale2 = cap ? a.scale : a.scale * LOG2E;
    const float f = cap ? 1.f : scale2;
    // tile tl's hand-shakes alone (a tile that hides every row of this
    // warpgroup): it must have landed before its stage is handed back
    auto pass = [&](int tl) {
      const int s = tl % STAGES;
      const uint32_t parity = (tl / STAGES) & 1;
      mbar_wait(k_full(s), parity);
      mbar_wait(v_full(s), parity);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(k_empty(s));
        mbar_arrive(v_empty(s));
      }
    };
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const wg::Item it = wg192::item(w, nq, H, a);
      const int wq0 = it.q0 + 64 * wgi;
      const int qp0 = wq0 + 16 * warp + lane / 4;  // rows qp0, qp0 + 8
      const int qb = j % QBUF;
      const uint32_t q_wg = base + qb * L::Q_BYTES + 64 * wgi * ROW;
      // the tiles [ia, ib) show a key to some row of this warpgroup: a
      // window hides a prefix of the item's tiles, causality a suffix
      int ia = 0, ib = it.nt;
      if (a.has_window)
        while (ia < ib && it.lo + ia * BN + BN - 1 <= wq0 - a.window) ++ia;
      if (a.causal)
        while (ib > ia && it.lo + (ib - 1) * BN > wq0 + 63) --ib;
      // whether tile k0 shows every row of this warpgroup its every key
      auto full = [&](int k0) {
        return k0 + BN <= a.T && (!a.causal || k0 + BN - 1 <= wq0) &&
               (!a.has_window || k0 > wq0 + 63 - a.window);
      };

      float o[wg192::DV / 2], sc[BN / 2], corr[2];
#pragma unroll
      for (int r = 0; r < wg192::DV / 2; ++r) o[r] = 0.f;
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) sc[r] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      uint32_t p[BN / 16][4];

      mbar_wait(q_full(qb), (j / QBUF) & 1);
      for (int i = 0; i < ia; ++i) pass(tile + i);
      if (ia < ib) {
        // tile ia: S, then its softmax (O is still 0: nothing to rescale)
        int tl = tile + ia, s = tl % STAGES;
        mbar_wait(k_full(s), (tl / STAGES) & 1);
        wg192::issue_qk(sc, q_wg, sK + s * L::K_BYTES);
        wgmma_wait<0>();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty(s));
        int k0 = it.lo + ia * BN;
        wg::softmax_probs(sc, corr, m, l, a, full(k0), cap, scale2, f, qp0,
                          k0, c);
        wg::pack_p(sc, p);
        for (int i = ia + 1; i < ib; ++i) {
          // tile i's S; O rescaled by tile i - 1's softmax while S runs;
          // tile i - 1's P . V; S is waited for alone
          tl = tile + i;
          s = tl % STAGES;
          const int sp = (tl - 1) % STAGES;
          mbar_wait(k_full(s), (tl / STAGES) & 1);
          wg192::issue_qk(sc, q_wg, sK + s * L::K_BYTES);
          wg::rescale(o, corr);
          mbar_wait(v_full(sp), ((tl - 1) / STAGES) & 1);
          wg192::issue_pv(o, p, sV + sp * L::V_BYTES);
          wgmma_wait<1>();
          fence_regs(sc);
          __syncwarp();
          if (lane == 0) mbar_arrive(k_empty(s));
          k0 = it.lo + i * BN;
          wg::softmax_probs(sc, corr, m, l, a, full(k0), cap, scale2, f,
                            qp0, k0, c);
          wgmma_wait<0>();
          fence_regs(o);
          __syncwarp();
          if (lane == 0) mbar_arrive(v_empty(sp));
          wg::pack_p(sc, p);
        }
        // every S has read this warpgroup's Q rows: the buffer is free for
        // the item QBUF on; then the last tile's P . V
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty(qb));
        tl = tile + ib - 1;
        s = tl % STAGES;
        wg::rescale(o, corr);
        mbar_wait(v_full(s), (tl / STAGES) & 1);
        wg192::issue_pv(o, p, sV + s * L::V_BYTES);
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty(s));
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty(qb));
      }
      for (int i = ib; i < it.nt; ++i) pass(tile + i);
      tile += it.nt;
      wg::store_rows(o, m, l, a, it, H, qp0, c);
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int N, int H, cudaStream_t stream) {
  const size_t smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, H, N);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a, int N, int H, int KV,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      make_map(&tq, a.q, D, H, a.S, N, a.qs2, a.qs1, a.qs0, wg::BM);
  if (err == cudaSuccess)
    err = make_map(&tk, a.k, D, KV, a.T, N, a.ks2, a.ks1, a.ks0, wg::BN);
  if (err == cudaSuccess)
    err = make_map(&tv, a.v, D, KV, a.T, N, a.vs2, a.vs1, a.vs0, wg::BN);
  if (err != cudaSuccess) return err;
  const size_t smem = wg::Smem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nq = (a.S + wg::BM - 1) / wg::BM;
  const long long items = static_cast<long long>(nq) * H * N;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  // one resident block per SM walks the items
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  flash_attention_wgmma_kernel<D><<<blocks, wg::THREADS, smem, stream>>>(
      tq, tk, tv, a, nq, H, N);
  return cudaGetLastError();
}

// a forward kernel with a producer warpgroup (the d 256 and MLA forms)
using HandoverKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, Args,
                                int, int, int);

// Launches `kernel`, of 384 threads and `smem` bytes of dynamic shared
// memory, one block per SM over the (q tile, head, n) items, q and k mapped
// at d_qk columns and v at d_v, k and v in boxes of kv_rows rows.
// setmaxnreg.inc waits for the registers the producer gave back: the block
// must be launched with enough of them, or the consumers would wait forever
// (ptxas sets the count from __launch_bounds__: 168 a thread)
cudaError_t launch_handover(HandoverKernel kernel, size_t smem, int d_qk,
                            int d_v, int kv_rows, const Args& a, int N,
                            int H, int KV, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      make_map(&tq, a.q, d_qk, H, a.S, N, a.qs2, a.qs1, a.qs0, wg::BM);
  if (err == cudaSuccess)
    err = make_map(&tk, a.k, d_qk, KV, a.T, N, a.ks2, a.ks1, a.ks0, kv_rows);
  if (err == cudaSuccess)
    err = make_map(&tv, a.v, d_v, KV, a.T, N, a.vs2, a.vs1, a.vs0, kv_rows);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * wg256::THREADS <
      128 * (wg256::PRODUCER_REGS +
             wg256::CONSUMERS * wg256::CONSUMER_REGS))
    return cudaErrorInvalidConfiguration;
  const int nq = (a.S + wg::BM - 1) / wg::BM;
  const long long items = static_cast<long long>(nq) * H * N;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  kernel<<<blocks, wg256::THREADS, smem, stream>>>(tq, tk, tv, a, nq, H, N);
  return cudaGetLastError();
}

template <int BN, int QBUF>
cudaError_t launch_wgmma256(const Args& a, int N, int H, int KV,
                            cudaStream_t stream) {
  return launch_handover(flash_attention_wgmma256_kernel<BN, QBUF>,
                         wg256::Smem<BN, QBUF>::BYTES, wg256::D, wg256::D,
                         BN, a, N, H, KV, stream);
}

template <int QBUF, int STAGES>
cudaError_t launch_wgmma192(const Args& a, int N, int H, int KV,
                            cudaStream_t stream) {
  return launch_handover(flash_attention_wgmma192_kernel<QBUF, STAGES>,
                         wg192::Smem<QBUF, STAGES>::BYTES, wg192::DQK,
                         wg192::DV, wg::BN, a, N, H, KV, stream);
}

cudaError_t launch_d(const Args& a, int d, int N, int H,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(a, N, H, stream);
    case 32: return launch<32>(a, N, H, stream);
    case 64: return launch<64>(a, N, H, stream);
    case 128: return launch<128>(a, N, H, stream);
    case 256: return launch<256>(a, N, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d (q's and k's head dim) and dv (v's and
// the output's) are a route's instantiated head dims (the wrapper zero-pads
// any other, ops.py::route).  bf16 at d = dv = 64 or 128 runs the wgmma +
// TMA kernel, bf16 at d = dv = 256 its d 256 form, bf16 at d 192 with dv
// 128 its MLA form; f32 at any d = dv the fp32-FMA kernel; anything else is
// refused.  Strides in
// elements; the inner stride of every tensor is 1.  window < 0 means no
// window, softcap 0 no softcap.  A non-null lse receives every row's
// log-sum-exp of its scores, (N, H, S) f32 contiguous (training; the
// backward reads it).  The wgmma kernels need every row of q, k, v and out
// to start 16-byte aligned and, for TMA, every stride of an extent over 1
// to be a positive multiple of 16 bytes (ops.py::_rows_aligned copies a
// view that is not).  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int d,
    int dv, int N, int S, int T, int H, int KV, long long qs0, long long qs1,
    long long qs2, long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2, long long os0,
    long long os1, long long os2, float scale, int causal, int window,
    float softcap, float* lse, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T < 0)
    return cudaErrorInvalidValue;
  Args a{q,   k,   v,   o,   qs0, qs1, qs2, ks0, ks1, ks2,   vs0,
         vs1, vs2, os0, os1, os2, S,   T,   H / KV, scale, causal,
         window >= 0 ? 1 : 0, window, softcap, lse};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == wg192::DQK && dv == wg192::DV)
    return launch_wgmma192<2, 3>(a, N, H, KV, st);
  if (dv != d) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_d(a, d, N, H, st);
  if (dtype == 1 && d == 64) return launch_wgmma<64>(a, N, H, KV, st);
  if (dtype == 1 && d == 128) return launch_wgmma<128>(a, N, H, KV, st);
  if (dtype == 1 && d == 256)
    return launch_wgmma256<64, 1>(a, N, H, KV, st);
  return cudaErrorInvalidValue;
}
