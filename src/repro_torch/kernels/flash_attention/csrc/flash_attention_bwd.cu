// Flash-attention backward, written by hand for Hopper (sm_90a).
//
// Replaces: the gradient of repro/kernels/flash_attention/
// flash_attention.py::flash_attention_pallas.  The JAX package has no
// backward kernel (it trains through its jnp reference, use_pallas
// defaults to False); this is the backward of the port's forward kernel,
// flash_attention.cu, which writes the row log-sum-exp L it needs.
//
// Layout, the forward's: q, dq (N, S, H, D) and o, do (N, S, H, D_v); k,
// dk (N, T, KV, D) and v, dv (N, T, KV, D_v); L (N, H, S) f32.  f32 or bf16
// inputs and outputs, fp32 inside.  D_v = D but on the MLA route below.
//
// Semantics, the forward's masks and softcap:
// - x = (q . k) * scale, s = c tanh(x / c) with a softcap c, else s = x;
// - a key is visible to a query when k_pos < T, q_pos < S and, with
//   causal, k_pos <= q_pos, with a window w, k_pos > q_pos - w;
// - P = exp(s - L) on visible pairs, else 0 (the forward's probabilities);
// - delta = rowsum(dO o O); dP = dO . V^T; dS = P (dP - delta), times
//   1 - tanh^2 = 1 - (s / c)^2 under a softcap, times scale;
// - dQ = dS . K, dK = dS^T . Q and dV = P^T . dO, dK and dV summed over the
//   q heads of each kv group.
// A row that sees no key gets zero gradients.
//
// What bounds it on this card: operations.  At the training shape (N 32,
// S = T = 1024, 8 q heads over 2 kv heads, d 128, causal, bf16) the five
// products of the gradient are 172 GFLOP against 337 MB to move, ~510
// operations per byte, above the card's ~295 (989 TFLOP/s over 3.35
// TB/s); only wgmma reaches the tensor cores' rate.  The design below does
// seven products (S and dP twice, once for dQ and once for dK/dV: the
// price of writing every gradient element once, with no atomics), so its
// own ceiling is 5/7 of the bound.
//
// Two routes, both deterministic with no atomics (every output element has
// one writer, every sum a fixed order), picked by ops.py::bwd_route:
//
// bf16 with D = 64 or 128 (the training path; smaller bf16 head dims are
// zero-padded to 64): wg::launch, three kernels.
// - flash_bwd_stats: delta = rowsum(dO o O) and L log2(e) per row into a
//   (2, N, H, S_pad) f32 scratch, S_pad the rows rounded up to 128 and
//   zero past S; 16-byte loads, D / 8 threads a row.
// - flash_bwd_dq_wgmma: persistent, one block per SM walks the (q tile of
//   128 rows, q head, n) items, longest causal tiles first, every other
//   round of blocks in reverse (a snake, which evens out the blocks'
//   shares).  Warpgroup 2 is the producer: one thread issues TMA loads (the
//   forward's 4-D tensor maps, 128-byte swizzle, rows past the end
//   zero-filled) of each item's Q and dO (two buffers, so the next item's
//   land during this one's tail) and of its K and V tiles of 64 rows into a
//   2-stage full/empty mbarrier ring.  Warpgroups 0 and 1 each own 64 q
//   rows: S = Q . K^T and dP = dO . V^T are wgmma m64n64k16 with both
//   operands K-major in shared memory; P = 2^(S scale log2(e) - L log2(e))
//   and dS run on the accumulator fragments, dS is rounded to bf16 in
//   registers and is the A operand of dQ += dS . K (K read MN-major
//   through the descriptor's transpose bit, as the forward reads V), issued
//   in two halves of the keys so that the second half's dS is formed while
//   the first half's product runs.  dQ stays in registers and is written
//   once per item.
// - flash_bwd_dkdv_wgmma: persistent over (kv tile of 128 rows, kv head,
//   n), the first kv tiles (which the most queries see) first, in the same
//   snake.  K and V are staged once per item (two buffers); Q and dO tiles
//   of 64 rows, with their rows' L log2(e) and delta (bulk copies of the
//   scratch), stream through the ring, the group's q heads in order.  Each
//   consumer warpgroup owns 64 kv rows: S^T = K . Q^T and dP^T = V . dO^T
//   (both K-major), P^T and dS^T in registers, then dV += P^T . dO and
//   dK += dS^T . Q with dO and Q read MN-major, in two halves of the
//   queries as above.
// In both, the masks run only on a tile that hides some pair (the tile's
// elementwise pass is instantiated with and without them): testing every
// pair of every tile, as a select, was the largest cost found on the card;
// a tile hidden from every row of a warpgroup is skipped.
// The dK/dV consumer holds dK and dV (64 + 64 registers at d 128) beside
// S^T and dP^T (32 + 32): 192 of accumulators alone, over the 168 a
// thread that a block of three warpgroups gets (three warps share an SM
// sub-partition's 16,384 registers), and at that cap ptxas serialises every
// wgmma (C7512).  So both wgmma kernels hand registers over as FA3 does:
// launched at 168 a thread (__launch_bounds__(384, 1)), the producer
// warpgroup drops to 40 (setmaxnreg.dec) and the two consumer warpgroups
// rise to 232 (setmaxnreg.inc), 40 + 2 x 232 = 3 x 168.  setmaxnreg acts
// on a whole warpgroup, and ptxas honours it only where the paths split
// once and never join, so the producer is a full warpgroup (one of its
// threads works) and the split is one if/else with nothing after it.
// Found on the card: so built, both kernels compile at 168 registers with
// no spill and no serialised wgmma; at 24 + 2 x 240 the producer spilled
// 32 bytes.  Whether the forward's attempt failed for its lone producer
// warp (a warpgroup of one warp) was not tested.  Two other overlaps
// were tried on the card (before the masks were split out) and dropped:
// keeping the two warpgroups' wgmma batches in turns (named barriers), and
// forming P while dP's product runs; both raised register pressure until
// ptxas spilled or serialised wgmmas (C7512, C7517), and both were
// slower.
//
// bf16 with D = 256 (gemma3-1b; bf16 head dims over 128 are padded to 256):
// the same three steps, with flash_bwd_dq_wgmma256 and
// flash_bwd_dkdv_wgmma256 in place of the d 128 kernels.  At gemma3's
// training shape (N 32, S = T = 1024, 4 q heads over 1 kv head, causal,
// window 512) the five products are 129 GFLOP against 336 MB, ~384
// operations per byte: operations.  The d 128 layouts do not fit there:
// - dQ: two (Q, dO) buffers of 128 rows are 256 KB alone.  So one buffer
//   (128 KB), freed after the item's last S and dP so that the next item's
//   lands during the last tile's dQ and epilogue, and a 2-stage ring of
//   K/V tiles of 32 rows (64 KB): 192 KB.  S and dP are m64n32k16 (16 + 16
//   registers beside dQ's 128), issued a 64-column half of d at a time;
//   dQ += dS . K is one m64n256k16 a k-step of 16 keys, the second
//   k-step's dS formed while the first runs.
// - dK/dV: a warpgroup that owned 64 kv rows would hold dK and dV in 256
//   registers a thread, over the 255 a thread may have.  So both consumer
//   warpgroups share one item of 64 kv rows: warpgroup w forms S^T = K .
//   Q^T and dP^T = V . dO^T for queries 32 w .. 32 w + 31 of each q tile
//   (m64n32k16, a 64-column half of d at a time), P^T and dS^T of them in
//   fp32 as the d 128 kernel does, and stores both as bf16 into shared
//   memory, 128-byte swizzled (fence.proxy.async, then a named barrier
//   over the two warpgroups); then each runs dV += P^T . dO and dK += dS^T
//   . Q for head-dim columns 128 w .. 128 w + 127 (m64n128k16 with both
//   operands in shared memory, dO and Q MN-major): 64 + 64 registers of
//   dK and dV a thread.  Each S^T and dP^T element is computed once, seven
//   products in the whole backward as at d 128.  The other way, each
//   warpgroup forming the whole S^T and dP^T for its own columns, needs no
//   barrier and no staging but does nine products and twice the
//   exponentials of every tile; it was not built.  The (P^T, dS^T) tiles
//   alternate between two buffers (32 KB), so a warpgroup that runs ahead
//   writes the next tile's while the other still reads this one's; with
//   the (K, V) item buffer (64 KB), the 2-stage Q/dO ring (128 KB) and the
//   ring's stats the block takes 225 KB of the 227 it may have.
// Both launch through the same host path (wg::launch) with the same
// register hand-over and launch check; the stats pass runs one warp a row.
//
// bf16 with q/k head dim 192 and v head dim 128 (deepseek-v3's MLA; bf16
// pairs with 128 < d <= 192 and d_v <= 128 are padded to it): the stats
// pass at d_v 128 (it reads O and dO, 128 columns), then
// flash_bwd_dq_wgmma192 and flash_bwd_dkdv_wgmma192, which map q, k, dq
// and dk at 192 columns (three 64-column slices) and v, o, dO and dv at
// 128 (two), so MLA's tensors are read in place and no product runs over a
// padded column (the d 256 route on operands padded to 256 did 1.6x the
// work, and the padding copies took ~0.7 ms of a 2.4 ms call).  At
// deepseek-v3's training shape (N 8, S = T = 1024, 32 q heads over 32 kv
// heads, causal) the five products are 224 GFLOP against 672 MB, ~333
// operations per byte: operations, just.
// - dQ: the d 256 kernel's single (Q, dO) buffer (48 + 32 KB), freed after
//   the item's last S and dP, with a 2-stage ring of 64-row (K, V) tiles
//   (24 + 16 KB): 160 KB.  S (k 192) and dP (k 128) are m64n64k16 (32 +
//   32 registers), issued a 64-column slice at a time; dQ += dS . K is one
//   m64n192k16 a k-step of 16 keys: 96 registers of dQ against 128 at d
//   256, two halves of the keys as at d 128.
// - dK/dV: dK (96 registers) and dV (64) fit one warpgroup, so each
//   consumer warpgroup owns its own 64 kv rows, as at d 128, and the d 256
//   kernel's shared item, staged P^T/dS^T tiles and named barrier are not
//   needed.  The streamed q tiles are 32 rows: S^T = K . Q^T and dP^T = V
//   . dO^T are m64n32k16 (16 + 16 registers), P^T and dS^T stay in
//   registers as the A operands of dV += P^T . dO (m64n128k16) and dK +=
//   dS^T . Q (m64n192k16), one k-step of 16 queries formed while the
//   other's products run.  Two (K, V) item buffers (80 KB each) and a
//   2-stage (Q, dO) ring (12 + 8 KB a stage) with its stats: 201 KB.
// - Both walk their items (n, head) slowest, then q tiles (dQ) or kv tiles
//   (dK/dV) longest first: with 32 kv heads a rank no K/V (dQ) or Q/dO
//   (dK/dV) is shared across heads, so the blocks at work keep the tensors
//   of few (n, head)s in L2 between them, while the snake order still
//   evens out the causal lengths.
//
// f32 inputs (held to 1e-4 against the plain version: no tensor-core type
// keeps that): fp32 FMA, every tensor contiguous (the wrapper copies), D
// one of 16, 32, 64, 128, 256 (the wrapper zero-pads); three kernels (bf16
// inputs take them too when asked, chip_smoke.py times them beside the
// wgmma route):
// - flash_bwd_delta: one warp per (n, s, h) row;
// - flash_bwd_dq: one block per (q tile, q head, n) walks the kv tiles the
//   tile can see and recomputes the scores, P, dP and dS for each;
// - flash_bwd_dkdv: one block per (kv tile, kv head, n) walks the group's
//   q heads in order and, for each, the q tiles that can see the tile.
// Tiles are staged in shared memory as fp32 rows padded by one word (no
// bank conflicts on column reads); 256 threads as 16 x 16, a thread owning
// R = B / 16 rows and every 16th column of a score tile and of its output
// rows.
// All launch on the caller's stream and allocate nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "tma_map.cuh"

namespace {

constexpr int THREADS = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int N, S, T, H, KV, rep;
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

// tile rows: 64 up to d 128, 32 at d 256 (shared memory)
template <int D>
struct Tile {
  static constexpr int B = D > 128 ? 32 : 64;
  static constexpr int R = B / 16;  // rows per thread
  static constexpr int C = B / 16;  // score columns per thread
  static constexpr int LD = D + 1;
  static constexpr int LDP = B + 1;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const Args a, int D) {
  const long long rows = static_cast<long long>(a.N) * a.S * a.H;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* O = static_cast<const T*>(a.o) + row * D;
  const T* dO = static_cast<const T*>(a.dout) + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(dO[c]) * to_f32(O[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (n * S + s) * H + h -> delta[(n * H + h) * S + s]
    const long long h = row % a.H, ns = row / a.H;
    const long long n = ns / a.S, s = ns % a.S;
    a.delta[(n * a.H + h) * a.S + s] = acc;
  }
}

// load `rows` x D of a (.., len, heads, D) tensor at row r0, head `head`
// of batch n into a padded fp32 tile (zeros past len)
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          long long n, int r0, int rows,
                                          int len, int heads, int head) {
  const T* base = static_cast<const T*>(src) +
                  (n * len * heads + head) * static_cast<long long>(D);
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int gr = r0 + r;
    dst[r * LD + c] =
        gr < len ? to_f32(base[static_cast<long long>(gr) * heads * D + c])
                 : 0.f;
  }
}

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  bool vis = kp < a.T && qp < a.S;
  if (a.causal) vis = vis && kp <= qp;
  if (a.has_window) vis = vis && kp > qp - a.window;
  return vis;
}

// P and dS of one score (raw = q . k, dp = dO . v) of a visible pair
__device__ __forceinline__ void prob_grad(const Args& a, float raw, float dp,
                                          float L, float dl, float& p,
                                          float& ds) {
  const float x = raw * a.scale;
  float s = x, dcap = 1.f;
  if (a.softcap != 0.f) {
    const float t = tanhf(x / a.softcap);
    s = a.softcap * t;
    dcap = 1.f - t * t;
  }
  p = expf(s - L);
  ds = p * (dp - dl) * dcap * a.scale;
}

// dQ: one block per (q tile, q head, n)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const Args a) {
  using TL = Tile<D>;
  constexpr int B = TL::B, R = TL::R, C = TL::C, LD = TL::LD, LDP = TL::LDP;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // B x LD
  float* sdO = sQ + B * LD;     // B x LD
  float* sK = sdO + B * LD;     // B x LD
  float* sV = sK + B * LD;      // B x LD
  float* sdS = sV + B * LD;     // B x LDP

  const int q0 = blockIdx.x * B, h = blockIdx.y;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kvh = h / a.rep;
  load_tile<T, D, LD>(sQ, a.q, n, q0, B, a.S, a.H, h);
  load_tile<T, D, LD>(sdO, a.dout, n, q0, B, a.S, a.H, h);
  float L[R], dl[R], acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    const long long li = (n * a.H + h) * a.S + qp;
    L[i] = qp < a.S ? a.lse[li] : 0.f;
    dl[i] = qp < a.S ? a.delta[li] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int hi = a.T;
  if (a.causal) hi = min(hi, q0 + B);
  int lo = 0;
  if (a.has_window) lo = max(0, q0 - a.window + 1) / B * B;

  for (int k0 = lo; k0 < hi; k0 += B) {
    __syncthreads();  // the last tile's K and dS are consumed
    load_tile<T, D, LD>(sK, a.k, n, k0, B, a.T, a.KV, kvh);
    load_tile<T, D, LD>(sV, a.v, n, k0, B, a.T, a.KV, kvh);
    __syncthreads();
    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], gv[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = sQ[(ty * R + i) * LD + d];
        gv[i] = sdO[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kp = k0 + tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (visible(a, qp, kp)) prob_grad(a, s[i][j], dp[i][j], L[i], dl[i],
                                          p, ds);
        sdS[(ty * R + i) * LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float g[R];
#pragma unroll
      for (int i = 0; i < R; ++i) g[i] = sdS[(ty * R + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = sK[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(g[i], kv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= a.S) continue;
    T* out = static_cast<T*>(a.dq) +
             ((n * a.S + qp) * a.H + h) * static_cast<long long>(D);
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(out + tx + 16 * c, acc[i][c]);
  }
}

// dK and dV: one block per (kv tile, kv head, n); the group's q heads in
// order, each over the q tiles that can see the kv tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const Args a) {
  using TL = Tile<D>;
  constexpr int B = TL::B, R = TL::R, C = TL::C, LD = TL::LD, LDP = TL::LDP;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // B x LD
  float* sV = sK + B * LD;      // B x LD
  float* sQ = sV + B * LD;      // B x LD
  float* sdO = sQ + B * LD;     // B x LD
  float* sP = sdO + B * LD;     // B (kv) x LDP (q)
  float* sdS = sP + B * LDP;    // B (kv) x LDP (q)
  float* sL = sdS + B * LDP;    // B
  float* sD = sL + B;           // B

  const int k0 = blockIdx.x * B, kvh = blockIdx.y;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_tile<T, D, LD>(sK, a.k, n, k0, B, a.T, a.KV, kvh);
  load_tile<T, D, LD>(sV, a.v, n, k0, B, a.T, a.KV, kvh);
  float dk[R][CPT], dv[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // q tiles that can see a key of this tile
  int lo = 0, hi = a.S;
  if (a.causal) lo = k0 / B * B;
  if (a.has_window) hi = min(hi, k0 + B - 1 + a.window);

  for (int hh = 0; hh < a.rep; ++hh) {
    const int h = kvh * a.rep + hh;
    for (int q0 = lo; q0 < hi; q0 += B) {
      __syncthreads();  // the last tile's Q, dO, P and dS are consumed
      load_tile<T, D, LD>(sQ, a.q, n, q0, B, a.S, a.H, h);
      load_tile<T, D, LD>(sdO, a.dout, n, q0, B, a.S, a.H, h);
      for (int i = tid; i < B; i += THREADS) {
        const int qp = q0 + i;
        const long long li = (n * a.H + h) * a.S + qp;
        sL[i] = qp < a.S ? a.lse[li] : 0.f;
        sD[i] = qp < a.S ? a.delta[li] : 0.f;
      }
      __syncthreads();
      // scores transposed: rows are keys (ty), columns queries (tx)
      float s[R][C], dp[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[R], vv[R], qv[C], gv[C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = sK[(ty * R + i) * LD + d];
          vv[i] = sV[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          qv[j] = sQ[(tx + 16 * j) * LD + d];
          gv[j] = sdO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int qi = tx + 16 * j, qp = q0 + qi;
          float p = 0.f, ds = 0.f;
          if (visible(a, qp, kp))
            prob_grad(a, s[i][j], dp[i][j], sL[qi], sD[qi], p, ds);
          sP[(ty * R + i) * LDP + qi] = p;
          sdS[(ty * R + i) * LDP + qi] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < B; ++qq) {
        float p[R], g[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = sP[(ty * R + i) * LDP + qq];
          g[i] = sdS[(ty * R + i) * LDP + qq];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float ov = sdO[qq * LD + tx + 16 * c];
          const float qv = sQ[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dv[i][c] = fmaf(p[i], ov, dv[i][c]);
            dk[i][c] = fmaf(g[i], qv, dk[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty * R + i;
    if (kp >= a.T) continue;
    const long long off =
        ((n * a.T + kp) * a.KV + kvh) * static_cast<long long>(D);
    T* gk = static_cast<T*>(a.dk) + off;
    T* gv = static_cast<T*>(a.dv) + off;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(gk + tx + 16 * c, dk[i][c]);
      store(gv + tx + 16 * c, dv[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using TL = Tile<D>;
  constexpr int B = TL::B, LD = TL::LD, LDP = TL::LDP;
  const size_t smem_dq = sizeof(float) * (4 * B * LD + B * LDP);
  const size_t smem_kv = sizeof(float) * (4 * B * LD + 2 * B * LDP + 2 * B);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.N) * a.S * a.H;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_bwd_delta<T><<<delta_blocks, THREADS, 0, stream>>>(a, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, D><<<dim3((a.S + B - 1) / B, a.H, a.N), THREADS, smem_dq,
                       stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.T > 0)
    flash_bwd_dkdv<T, D><<<dim3((a.T + B - 1) / B, a.KV, a.N), THREADS,
                           smem_kv, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// bf16, d = 64 or 128: wgmma fed by TMA, warp-specialised, persistent
// ---------------------------------------------------------------------

namespace wg {

constexpr int ROW = 128;                 // bytes of a swizzled row: 64 bf16
constexpr int CONSUMERS = 2;             // warpgroups 0 and 1 compute
constexpr int THREADS = 128 * (CONSUMERS + 1);  // warpgroup 2 loads
constexpr int BLOCK = 64 * CONSUMERS;    // rows a work item owns
constexpr int TILE = 64;                 // rows of a streamed tile
constexpr int STAGES = 2;                // streamed-tile ring depth
// register budgets after the hand-over: 40 + 2 x 232 a thread of each SM
// sub-partition's three warps, 504 x 32 = the 168 x 3 x 32 the block is
// launched with (at 24 + 2 x 240 the producer spilled)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* o;
  const void* dout;
  long long os0, os1, os2;
  long long ds0, ds1, ds2;
  const float* lse;  // (N, H, S)
  float* stats;      // (2, N, H, S_pad): L log2(e), then delta
  __nv_bfloat16* dq;  // (N, S, H, D) contiguous
  __nv_bfloat16* dk;  // (N, T, KV, D) contiguous
  __nv_bfloat16* dv;
  int N, S, T, H, KV, rep, S_pad;
  float scale;
  int causal, has_window, window;
  float softcap;
};

// 2^x in one MUFU.EX2; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// bf16 pair -> one 32-bit register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  bool vis = kp < a.T && qp < a.S;
  if (a.causal) vis = vis && kp <= qp;
  if (a.has_window) vis = vis && kp > qp - a.window;
  return vis;
}

// P and dS of one raw score q . k (dp = dO . v) of a visible pair, with l2
// = L log2(e) and dl = delta of its query row: P = 2^(s log2(e) - l2), dS
// = P (dp - dl) (1 - t^2 under a softcap) scale
template <bool CAP>
__device__ __forceinline__ void prob_grad(const Args& a, float raw, float dp,
                                          float l2, float dl, float& p,
                                          float& ds) {
  if (CAP) {
    const float t = tanhf(raw * a.scale / a.softcap);
    p = exp2_ftz(a.softcap * LOG2E * t - l2);
    ds = p * (dp - dl) * (1.f - t * t) * a.scale;
  } else {
    p = exp2_ftz(fmaf(raw, a.scale * LOG2E, -l2));
    ds = p * (dp - dl) * a.scale;
  }
}

// The accumulator fragment of a 64 x 64 tile: register r of thread (warp,
// lane) is row 16 warp + lane / 4 + 8 ((r >> 1) & 1), column 8 (r >> 2) +
// 2 (lane % 4) + (r & 1).  Columns 16 kt .. 16 kt + 15 of it are the
// register A fragment of k-step kt of a product that contracts them: its
// register x packs registers 8 kt + 2 x and 8 kt + 2 x + 1 as a bf16 pair.

// dS of score registers 8 KS H .. 8 KS (H + 1) - 1 (keys 16 KS H .. 16 KS
// (H + 1) - 1 of the tile) in place, rows qp0 and qp0 + 8, and their bf16 A
// fragments, k-steps KS H .. KS (H + 1) - 1 of dQ += dS . K; with MASK,
// hidden pairs give 0
template <int H, int KS, bool MASK, bool CAP, int R>
__device__ __forceinline__ void dq_grads(float (&sc)[R], const float (&dp)[R],
                                         const float (&l2)[2],
                                         const float (&dl)[2],
                                         uint32_t (&g)[R / 8][4],
                                         const Args& a, int qp0, int k0,
                                         int c) {
#pragma unroll
  for (int i = 0; i < 8 * KS; ++i) {
    const int r = 8 * KS * H + i, e = (r >> 1) & 1;
    float p, ds;
    prob_grad<CAP>(a, sc[r], dp[r], l2[e], dl[e], p, ds);
    if (MASK && !visible(a, qp0 + 8 * e, k0 + 8 * (r >> 2) + 2 * c + (r & 1)))
      ds = 0.f;
    sc[r] = ds;
  }
#pragma unroll
  for (int kt = KS * H; kt < KS * H + KS; ++kt)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      g[kt][x] = pack_bf16(sc[8 * kt + 2 * x], sc[8 * kt + 2 * x + 1]);
}

template <int H, int KS, int R>
__device__ __forceinline__ void dq_grads(bool mask, bool cap, float (&sc)[R],
                                         const float (&dp)[R],
                                         const float (&l2)[2],
                                         const float (&dl)[2],
                                         uint32_t (&g)[R / 8][4],
                                         const Args& a, int qp0, int k0,
                                         int c) {
  if (mask) {
    if (cap) dq_grads<H, KS, true, true>(sc, dp, l2, dl, g, a, qp0, k0, c);
    else dq_grads<H, KS, true, false>(sc, dp, l2, dl, g, a, qp0, k0, c);
  } else {
    if (cap) dq_grads<H, KS, false, true>(sc, dp, l2, dl, g, a, qp0, k0, c);
    else dq_grads<H, KS, false, false>(sc, dp, l2, dl, g, a, qp0, k0, c);
  }
}

// P^T and dS^T of score registers R/2 H .. R/2 (H + 1) - 1 of a tile of R
// registers a thread, 2 R queries (queries R H .. R (H + 1) - 1 of the
// tile, whose l2 and delta are sl[] and sl[2 R + ]) in place, kv rows kp0
// and kp0 + 8, and their bf16 A fragments, k-steps R/16 H .. R/16 (H + 1) -
// 1 of dV += P^T . dO and dK += dS^T . Q; with MASK, hidden pairs give 0
template <int H, bool MASK, bool CAP, int R>
__device__ __forceinline__ void dkv_grads(float (&st)[R], float (&dpt)[R],
                                          const float* sl,
                                          uint32_t (&pa)[R / 8][4],
                                          uint32_t (&ga)[R / 8][4],
                                          const Args& a, int q0, int kp0,
                                          int c) {
#pragma unroll
  for (int jj = R / 8 * H; jj < R / 8 * (H + 1); ++jj) {
    const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * jj + 2 * c);
    const float2 dl =
        *reinterpret_cast<const float2*>(sl + 2 * R + 8 * jj + 2 * c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 4 * jj + u;
      float p, ds;
      prob_grad<CAP>(a, st[r], dpt[r], (u & 1) ? l2.y : l2.x,
                     (u & 1) ? dl.y : dl.x, p, ds);
      if (MASK && !visible(a, q0 + 8 * jj + 2 * c + (u & 1),
                           kp0 + 8 * ((u >> 1) & 1))) {
        p = 0.f;
        ds = 0.f;
      }
      st[r] = p;
      dpt[r] = ds;
    }
  }
#pragma unroll
  for (int kt = R / 16 * H; kt < R / 16 * (H + 1); ++kt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pa[kt][x] = pack_bf16(st[8 * kt + 2 * x], st[8 * kt + 2 * x + 1]);
      ga[kt][x] = pack_bf16(dpt[8 * kt + 2 * x], dpt[8 * kt + 2 * x + 1]);
    }
}

template <int H, int R>
__device__ __forceinline__ void dkv_grads(bool mask, bool cap,
                                          float (&st)[R], float (&dpt)[R],
                                          const float* sl,
                                          uint32_t (&pa)[R / 8][4],
                                          uint32_t (&ga)[R / 8][4],
                                          const Args& a, int q0, int kp0,
                                          int c) {
  if (mask) {
    if (cap) dkv_grads<H, true, true>(st, dpt, sl, pa, ga, a, q0, kp0, c);
    else dkv_grads<H, true, false>(st, dpt, sl, pa, ga, a, q0, kp0, c);
  } else {
    if (cap) dkv_grads<H, false, true>(st, dpt, sl, pa, ga, a, q0, kp0, c);
    else dkv_grads<H, false, false>(st, dpt, sl, pa, ga, a, q0, kp0, c);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  hopper::wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  hopper::wgmma_rs_n128(d, a, db);
}

// acc (64 x 64) = A . B^T over d: A's 64 rows and B's 64 rows K-major in
// 128-byte swizzled halves of 64 columns, a_half / b_half bytes apart
template <int D>
__device__ __forceinline__ void descs_kmajor(uint64_t (&da)[D / 16],
                                             uint64_t (&db)[D / 16],
                                             uint32_t a, uint32_t a_half,
                                             uint32_t b, uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // a k-step is 32 bytes of a row
    da[kk] = hopper::desc_sw128(a + (kk / 4) * a_half + off, 16, 1024);
    db[kk] = hopper::desc_sw128(b + (kk / 4) * b_half + off, 16, 1024);
  }
}

// B of acc (64 x D) += A (64 x 64 keys or queries, registers) . B: a tile
// of 64 rows (the contracted dimension) by D, MN-major; a k-step is 16
// rows, the next 64 columns the other half (TILE rows on)
__device__ __forceinline__ void descs_mnmajor(uint64_t (&db)[4], uint32_t b) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
    db[kt] = hopper::desc_sw128(b + kt * 16 * ROW, TILE * ROW, 1024);
}

// ---- delta = rowsum(dO o O) and L log2(e), padded to S_pad rows -------

// D / 8 threads a row, 16 bytes (8 bf16) of O and of dO each; rows in the
// order (n, s, h), h fastest, as the tensors lie; a row of s >= S is 0
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_stats(const Args a) {
  constexpr int LANES = D / 8;  // divides 32: a row's threads share a warp
  const long long rows = static_cast<long long>(a.N) * a.S_pad * a.H;
  const long long t = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long row = t / LANES;
  const int part = static_cast<int>(t % LANES);
  const int h = static_cast<int>(row % a.H);
  const long long ns = row / a.H;
  const int s = static_cast<int>(ns % a.S_pad);
  const long long n = ns / a.S_pad;
  const bool live = row < rows && s < a.S;
  float acc = 0.f;
  if (live) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(a.o) + n * a.os0 + s * a.os1 +
        h * a.os2 + part * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(a.dout) + n * a.ds0 + s * a.ds1 +
        h * a.ds2 + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fo = __bfloat1622float2(o2[i]);
      const float2 fg = __bfloat1622float2(g2[i]);
      acc = fmaf(fo.x, fg.x, acc);
      acc = fmaf(fo.y, fg.y, acc);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) {
    const long long li = (n * a.H + h) * a.S_pad + s;
    a.stats[li] =
        live ? a.lse[(n * a.H + h) * a.S + s] * LOG2E : 0.f;
    a.stats[static_cast<long long>(a.N) * a.H * a.S_pad + li] =
        live ? acc : 0.f;
  }
}

// ---- dQ: items (q tile of BLOCK rows, q head, n) ----------------------

template <int D>
struct DqSmem {
  static constexpr uint32_t Q_BYTES = BLOCK * D * 2;   // one Q or dO tile
  static constexpr uint32_t KV_BYTES = TILE * D * 2;   // one K or V tile
  static constexpr uint32_t KV_OFF = 4 * Q_BYTES;      // two (Q, dO) buffers
  static constexpr uint32_t BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int BARS = 4 + 2 * STAGES;
  // + 1024 to align the dynamic buffer's start
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

// mbarrier slots of both kernels: the item buffers' full and empty (per
// buffer), then the streamed ring's full and empty (per stage)
__device__ __forceinline__ int bar_item_full(int b) { return b; }
__device__ __forceinline__ int bar_item_empty(int b) { return 2 + b; }
__device__ __forceinline__ int bar_full(int s) { return 4 + s; }
__device__ __forceinline__ int bar_empty(int s) { return 4 + STAGES + s; }

__device__ __forceinline__ void init_bars(uint32_t bars) {
  using namespace hopper;
  for (int i = 0; i < 2 + STAGES; ++i) {
    const int full = i < 2 ? bar_item_full(i) : bar_full(i - 2);
    const int empty = i < 2 ? bar_item_empty(i) : bar_empty(i - 2);
    mbar_init(bars + 8u * full, 1);
    mbar_init(bars + 8u * empty, 4 * CONSUMERS);  // one arrival a warp
  }
  mbar_fence_init();
}

struct DqItem {
  int q0, h, n, lo, nt;
};

// q tiles longest first (causal), then heads, then n; key tiles of KB rows
template <int KB = TILE>
__device__ __forceinline__ DqItem dq_item(int w, int nq, const Args& a) {
  DqItem it;
  const int hn = a.H * a.N;
  it.q0 = (nq - 1 - w / hn) * BLOCK;
  it.h = (w % hn) % a.H;
  it.n = (w % hn) / a.H;
  // key tiles that can hold a visible key for some row of the item
  int hi = a.T;
  if (a.causal) hi = min(hi, it.q0 + BLOCK);
  it.lo = 0;
  if (a.has_window) it.lo = max(0, it.q0 - a.window + 1) / KB * KB;
  it.nt = hi > it.lo ? (hi - it.lo + KB - 1) / KB : 0;
  return it;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmdo,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, const Args a,
                   const int nq) {
  using namespace hopper;
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * i; };
  const int items = nq * a.H * a.N;
  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  // warp-uniform (a shuffle from lane 0): the paths split here once
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // key tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const DqItem it = dq_item(w, nq, a);
        const int kvh = it.h / a.rep;
        const int b = j & 1;
        const uint32_t qs = base + b * 2 * L::Q_BYTES;
        mbar_wait(bar(bar_item_empty(b)), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(bar(bar_item_full(b)), 2 * L::Q_BYTES);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(qs + hf * BLOCK * ROW, &tmq, bar(bar_item_full(b)),
                      64 * hf, it.h, it.q0, it.n);
          tma_load_4d(qs + L::Q_BYTES + hf * BLOCK * ROW, &tmdo,
                      bar(bar_item_full(b)), 64 * hf, it.h, it.q0, it.n);
        }
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const int k0 = it.lo + i * TILE;
          const uint32_t ks = base + L::KV_OFF + s * 2 * L::KV_BYTES;
          mbar_wait(bar(bar_empty(s)), ((tile / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar(bar_full(s)), 2 * L::KV_BYTES);
#pragma unroll
          for (int hf = 0; hf < D / 64; ++hf) {
            tma_load_4d(ks + hf * TILE * ROW, &tmk, bar(bar_full(s)),
                        64 * hf, kvh, k0, it.n);
            tma_load_4d(ks + L::KV_BYTES + hf * TILE * ROW, &tmv,
                        bar(bar_full(s)), 64 * hf, kvh, k0, it.n);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns q rows [q0 + 64 wgi, + 64) ----
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const bool cap = a.softcap != 0.f;
    const long long nhs = static_cast<long long>(a.N) * a.H * a.S_pad;
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const DqItem it = dq_item(w, nq, a);
      const int wq0 = it.q0 + 64 * wgi;
      const int qp0 = wq0 + 16 * warp + lane / 4;  // rows qp0, qp0 + 8
      const int b = j & 1;
      const uint32_t q_wg = base + b * 2 * L::Q_BYTES + 64 * wgi * ROW;
      const uint32_t do_wg = q_wg + L::Q_BYTES;
      float l2[2], dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long li =
            (static_cast<long long>(it.n) * a.H + it.h) * a.S_pad + qp0 +
            8 * e;
        l2[e] = a.stats[li];
        dl[e] = a.stats[nhs + li];
      }
      float dq[D / 2], sc[32], dp[32];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) dq[r] = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = dp[r] = 0.f;

      mbar_wait(bar(bar_item_full(b)), (j >> 1) & 1);
      for (int i = 0; i < it.nt; ++i, ++tile) {
        const int s = tile % STAGES;
        const int k0 = it.lo + i * TILE;
        // a key tile hidden from every row of this warpgroup changes
        // nothing; it still takes part in the ring's hand-shakes
        const bool skip = wq0 >= a.S || (a.causal && k0 > wq0 + 63) ||
                          (a.has_window && k0 + TILE - 1 <= wq0 - a.window);
        mbar_wait(bar(bar_full(s)), (tile / STAGES) & 1);
        if (!skip) {
          const uint32_t ks = base + L::KV_OFF + s * 2 * L::KV_BYTES;
          const uint32_t vs = ks + L::KV_BYTES;
          // S = Q . K^T and dP = dO . V^T
          uint64_t dqa[D / 16], dkb[D / 16], doa[D / 16], dvb[D / 16];
          descs_kmajor<D>(dqa, dkb, q_wg, BLOCK * ROW, ks, TILE * ROW);
          descs_kmajor<D>(doa, dvb, do_wg, BLOCK * ROW, vs, TILE * ROW);
          fence_regs(dqa);
          fence_regs(dkb);
          fence_regs(doa);
          fence_regs(dvb);
          fence_regs(sc);
          fence_regs(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(sc, dqa[kk], dkb[kk], kk > 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(dp, doa[kk], dvb[kk], kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);

          // dS in place of the scores, the masks only on a tile that hides
          // some pair; dQ += dS . K (K read MN-major) in two halves of
          // the keys, so that the second half's dS is formed while the
          // first half's product runs
          const bool full = k0 + TILE <= a.T && wq0 + 64 <= a.S &&
                            (!a.causal || k0 + TILE - 1 <= wq0) &&
                            (!a.has_window || k0 > wq0 + 63 - a.window);
          uint64_t kb[4];
          descs_mnmajor(kb, ks);
          fence_regs(kb);
          uint32_t g[4][4];
          dq_grads<0, 2>(!full, cap, sc, dp, l2, dl, g, a, qp0, k0, c);
          fence_regs(g[0]);
          fence_regs(g[1]);
          fence_regs(dq);
          wgmma_fence();
          wgmma_rs<D>(dq, g[0], kb[0]);
          wgmma_rs<D>(dq, g[1], kb[1]);
          wgmma_commit();
          dq_grads<1, 2>(!full, cap, sc, dp, l2, dl, g, a, qp0, k0, c);
          fence_regs(g[2]);
          fence_regs(g[3]);
          wgmma_fence();
          wgmma_rs<D>(dq, g[2], kb[2]);
          wgmma_rs<D>(dq, g[3], kb[3]);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(bar_empty(s)));
      }
      // this item's Q and dO buffer is free for the item after next
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(bar_item_empty(b)));

#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qr = qp0 + 8 * e;
        if (qr >= a.S) continue;
        __nv_bfloat16* out =
            a.dq + ((static_cast<long long>(it.n) * a.S + qr) * a.H + it.h) *
                       static_cast<long long>(D);
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dq[4 * jj + 2 * e], dq[4 * jj + 2 * e + 1]);
      }
    }
  }
}

// ---- dK and dV: items (kv tile of BLOCK rows, kv head, n) -------------

template <int D>
struct KvSmem {
  static constexpr uint32_t KV_BYTES = BLOCK * D * 2;  // one K or V tile
  static constexpr uint32_t Q_BYTES = TILE * D * 2;    // one Q or dO tile
  static constexpr uint32_t Q_OFF = 4 * KV_BYTES;      // two (K, V) buffers
  static constexpr uint32_t STAT_OFF = Q_OFF + STAGES * 2 * Q_BYTES;
  static constexpr uint32_t STAT_BYTES = TILE * 4;     // one l2 or delta row
  static constexpr uint32_t BAR_OFF = STAT_OFF + STAGES * 2 * STAT_BYTES;
  static constexpr int BARS = 4 + 2 * STAGES;
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

struct KvItem {
  int k0, kvh, n, lo, nt;  // nt q tiles per q head of the group
};

// kv tiles of KB rows longest first (causal: the first sees the most
// queries), then kv heads, then n
template <int KB = BLOCK>
__device__ __forceinline__ KvItem kv_item(int w, const Args& a) {
  KvItem it;
  const int hn = a.KV * a.N;
  it.k0 = (w / hn) * KB;
  it.kvh = (w % hn) % a.KV;
  it.n = (w % hn) / a.KV;
  // q tiles that can see a key of the item
  it.lo = a.causal ? it.k0 : 0;
  int hi = a.S;
  if (a.has_window) hi = min(hi, it.k0 + KB - 1 + a.window);
  it.nt = hi > it.lo ? (hi - it.lo + TILE - 1) / TILE : 0;
  return it;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmdo,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv, const Args a,
                     const int nkv) {
  using namespace hopper;
  using L = KvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * i; };
  const int items = nkv * a.KV * a.N;
  const long long nhs = static_cast<long long>(a.N) * a.H * a.S_pad;
  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // q tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const KvItem it = kv_item(w, a);
        const int b = j & 1;
        const uint32_t kvs = base + b * 2 * L::KV_BYTES;
        mbar_wait(bar(bar_item_empty(b)), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(bar(bar_item_full(b)), 2 * L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(kvs + hf * BLOCK * ROW, &tmk, bar(bar_item_full(b)),
                      64 * hf, it.kvh, it.k0, it.n);
          tma_load_4d(kvs + L::KV_BYTES + hf * BLOCK * ROW, &tmv,
                      bar(bar_item_full(b)), 64 * hf, it.kvh, it.k0, it.n);
        }
        // the group's q heads in order, each over its q tiles
        for (int hh = 0; hh < a.rep; ++hh) {
          const int h = it.kvh * a.rep + hh;
          const long long row0 =
              (static_cast<long long>(it.n) * a.H + h) * a.S_pad;
          for (int i = 0; i < it.nt; ++i, ++tile) {
            const int s = tile % STAGES;
            const int q0 = it.lo + i * TILE;
            const uint32_t qs = base + L::Q_OFF + s * 2 * L::Q_BYTES;
            const uint32_t st = base + L::STAT_OFF + s * 2 * L::STAT_BYTES;
            mbar_wait(bar(bar_empty(s)), ((tile / STAGES) & 1) ^ 1);
            mbar_expect_tx(bar(bar_full(s)),
                           2 * L::Q_BYTES + 2 * L::STAT_BYTES);
#pragma unroll
            for (int hf = 0; hf < D / 64; ++hf) {
              tma_load_4d(qs + hf * TILE * ROW, &tmq, bar(bar_full(s)),
                          64 * hf, h, q0, it.n);
              tma_load_4d(qs + L::Q_BYTES + hf * TILE * ROW, &tmdo,
                          bar(bar_full(s)), 64 * hf, h, q0, it.n);
            }
            bulk_load(st, a.stats + row0 + q0, L::STAT_BYTES,
                      bar(bar_full(s)));
            bulk_load(st + L::STAT_BYTES, a.stats + nhs + row0 + q0,
                      L::STAT_BYTES, bar(bar_full(s)));
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns kv rows [k0 + 64 wgi, + 64) ----
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const bool cap = a.softcap != 0.f;
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const KvItem it = kv_item(w, a);
      const int wk0 = it.k0 + 64 * wgi;
      const int kp0 = wk0 + 16 * warp + lane / 4;  // rows kp0, kp0 + 8
      const int b = j & 1;
      const uint32_t k_wg = base + b * 2 * L::KV_BYTES + 64 * wgi * ROW;
      const uint32_t v_wg = k_wg + L::KV_BYTES;
      float dk[D / 2], dv[D / 2], st[32], dpt[32];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) dk[r] = dv[r] = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) st[r] = dpt[r] = 0.f;

      mbar_wait(bar(bar_item_full(b)), (j >> 1) & 1);
      for (int hh = 0; hh < a.rep; ++hh) {
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const int q0 = it.lo + i * TILE;
          const bool skip =
              wk0 >= a.T || (a.causal && q0 + TILE - 1 < wk0) ||
              (a.has_window && q0 >= wk0 + 63 + a.window);
          mbar_wait(bar(bar_full(s)), (tile / STAGES) & 1);
          if (!skip) {
            const uint32_t qs = base + L::Q_OFF + s * 2 * L::Q_BYTES;
            const uint32_t dos = qs + L::Q_BYTES;
            // S^T = K . Q^T and dP^T = V . dO^T
            uint64_t ka[D / 16], qb[D / 16], va[D / 16], dob[D / 16];
            descs_kmajor<D>(ka, qb, k_wg, BLOCK * ROW, qs, TILE * ROW);
            descs_kmajor<D>(va, dob, v_wg, BLOCK * ROW, dos, TILE * ROW);
            fence_regs(ka);
            fence_regs(qb);
            fence_regs(va);
            fence_regs(dob);
            fence_regs(st);
            fence_regs(dpt);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_ss_n64(st, ka[kk], qb[kk], kk > 0);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_ss_n64(dpt, va[kk], dob[kk], kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);

            // P^T and dS^T in place, the masks only on a tile that hides
            // some pair (a column is a query, whose l2 and delta the
            // producer staged beside Q); dV += P^T . dO and dK += dS^T . Q
            // (dO and Q read MN-major) in two halves of the queries, so
            // that the second half is formed while the first half's
            // products run
            const float* sl = reinterpret_cast<const float*>(
                smem_raw + (base - smem_u32(smem_raw)) + L::STAT_OFF +
                s * 2 * L::STAT_BYTES);
            const bool full = wk0 + 64 <= a.T && q0 + TILE <= a.S &&
                              (!a.causal || wk0 + 63 <= q0) &&
                              (!a.has_window ||
                               wk0 > q0 + TILE - 1 - a.window);
            uint64_t dob2[4], qb2[4];
            descs_mnmajor(dob2, dos);
            descs_mnmajor(qb2, qs);
            fence_regs(dob2);
            fence_regs(qb2);
            uint32_t pa[4][4], ga[4][4];
            dkv_grads<0>(!full, cap, st, dpt, sl, pa, ga, a, q0, kp0, c);
#pragma unroll
            for (int kt = 0; kt < 2; ++kt) {
              fence_regs(pa[kt]);
              fence_regs(ga[kt]);
            }
            fence_regs(dv);
            fence_regs(dk);
            wgmma_fence();
#pragma unroll
            for (int kt = 0; kt < 2; ++kt) wgmma_rs<D>(dv, pa[kt], dob2[kt]);
#pragma unroll
            for (int kt = 0; kt < 2; ++kt) wgmma_rs<D>(dk, ga[kt], qb2[kt]);
            wgmma_commit();
            dkv_grads<1>(!full, cap, st, dpt, sl, pa, ga, a, q0, kp0, c);
#pragma unroll
            for (int kt = 2; kt < 4; ++kt) {
              fence_regs(pa[kt]);
              fence_regs(ga[kt]);
            }
            wgmma_fence();
#pragma unroll
            for (int kt = 2; kt < 4; ++kt) wgmma_rs<D>(dv, pa[kt], dob2[kt]);
#pragma unroll
            for (int kt = 2; kt < 4; ++kt) wgmma_rs<D>(dk, ga[kt], qb2[kt]);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv);
            fence_regs(dk);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(bar_empty(s)));
        }
      }
      // this item's K and V buffer is free for the item after next
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(bar_item_empty(b)));

#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kr = kp0 + 8 * e;
        if (kr >= a.T) continue;
        const long long off =
            ((static_cast<long long>(it.n) * a.T + kr) * a.KV + it.kvh) *
            static_cast<long long>(D);
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dk[4 * jj + 2 * e], dk[4 * jj + 2 * e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dv[4 * jj + 2 * e], dv[4 * jj + 2 * e + 1]);
        }
      }
    }
  }
}

// ---- d 256 ---------------------------------------------------------------

// dQ at d 256: one (Q, dO) buffer of BLOCK rows, then a ring of K/V tiles
// of TILE256 rows
constexpr int TILE256 = 32;
struct Dq256Smem {
  static constexpr uint32_t Q_BYTES = BLOCK * 256 * 2;     // one Q or dO tile
  static constexpr uint32_t KV_BYTES = TILE256 * 256 * 2;  // one K or V tile
  static constexpr uint32_t KV_OFF = 2 * Q_BYTES;
  static constexpr uint32_t BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int BARS = 4 + 2 * STAGES;
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

// As flash_bwd_dq_wgmma at d 128, with four changes (see the header):
// one (Q, dO) buffer, freed after the item's last S and dP so that the next
// item's lands during the last tile's dQ and the epilogue; key tiles of 32
// rows; S and dP issued a 64-column half at a time; dQ += dS . K one
// m64n256k16 a k-step, the second k-step's dS formed while the first runs.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma256(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmdo,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, const Args a,
                      const int nq) {
  using namespace hopper;
  using L = Dq256Smem;
  constexpr int D = 256, KB = TILE256;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * i; };
  const int items = nq * a.H * a.N;
  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // key tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const DqItem it = dq_item<KB>(w, nq, a);
        const int kvh = it.h / a.rep;
        mbar_wait(bar(bar_item_empty(0)), (j & 1) ^ 1);
        mbar_expect_tx(bar(bar_item_full(0)), 2 * L::Q_BYTES);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(base + hf * BLOCK * ROW, &tmq, bar(bar_item_full(0)),
                      64 * hf, it.h, it.q0, it.n);
          tma_load_4d(base + L::Q_BYTES + hf * BLOCK * ROW, &tmdo,
                      bar(bar_item_full(0)), 64 * hf, it.h, it.q0, it.n);
        }
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const int k0 = it.lo + i * KB;
          const uint32_t ks = base + L::KV_OFF + s * 2 * L::KV_BYTES;
          mbar_wait(bar(bar_empty(s)), ((tile / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar(bar_full(s)), 2 * L::KV_BYTES);
#pragma unroll
          for (int hf = 0; hf < D / 64; ++hf) {
            tma_load_4d(ks + hf * KB * ROW, &tmk, bar(bar_full(s)), 64 * hf,
                        kvh, k0, it.n);
            tma_load_4d(ks + L::KV_BYTES + hf * KB * ROW, &tmv,
                        bar(bar_full(s)), 64 * hf, kvh, k0, it.n);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns q rows [q0 + 64 wgi, + 64) ----
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const bool cap = a.softcap != 0.f;
    const long long nhs = static_cast<long long>(a.N) * a.H * a.S_pad;
    const uint32_t q_wg = base + 64 * wgi * ROW, do_wg = q_wg + L::Q_BYTES;
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const DqItem it = dq_item<KB>(w, nq, a);
      const int wq0 = it.q0 + 64 * wgi;
      const int qp0 = wq0 + 16 * warp + lane / 4;  // rows qp0, qp0 + 8
      float l2[2], dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long li =
            (static_cast<long long>(it.n) * a.H + it.h) * a.S_pad + qp0 +
            8 * e;
        l2[e] = a.stats[li];
        dl[e] = a.stats[nhs + li];
      }
      float dq[D / 2], sc[KB / 2], dp[KB / 2];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) dq[r] = 0.f;
#pragma unroll
      for (int r = 0; r < KB / 2; ++r) sc[r] = dp[r] = 0.f;

      mbar_wait(bar(bar_item_full(0)), j & 1);
      for (int i = 0; i < it.nt; ++i, ++tile) {
        const int s = tile % STAGES;
        const int k0 = it.lo + i * KB;
        const bool skip = wq0 >= a.S || (a.causal && k0 > wq0 + 63) ||
                          (a.has_window && k0 + KB - 1 <= wq0 - a.window);
        const uint32_t ks = base + L::KV_OFF + s * 2 * L::KV_BYTES;
        const uint32_t vs = ks + L::KV_BYTES;
        mbar_wait(bar(bar_full(s)), (tile / STAGES) & 1);
        if (!skip) {
          // S = Q . K^T and dP = dO . V^T, a 64-column half at a time
          fence_regs(sc);
          fence_regs(dp);
#pragma unroll
          for (int hf = 0; hf < D / 64; ++hf) {
            uint64_t qa[4], kb[4], oa[4], vb[4];
            descs_kmajor<64>(qa, kb, q_wg + hf * BLOCK * ROW, 0,
                             ks + hf * KB * ROW, 0);
            descs_kmajor<64>(oa, vb, do_wg + hf * BLOCK * ROW, 0,
                             vs + hf * KB * ROW, 0);
            fence_regs(qa);
            fence_regs(kb);
            fence_regs(oa);
            fence_regs(vb);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n32(sc, qa[kk], kb[kk], hf > 0 || kk > 0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n32(dp, oa[kk], vb[kk], hf > 0 || kk > 0);
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
        }
        // the item's last S and dP have read this warpgroup's Q and dO
        __syncwarp();
        if (lane == 0 && i == it.nt - 1) mbar_arrive(bar(bar_item_empty(0)));
        if (!skip) {
          const bool full = k0 + KB <= a.T && wq0 + 64 <= a.S &&
                            (!a.causal || k0 + KB - 1 <= wq0) &&
                            (!a.has_window || k0 > wq0 + 63 - a.window);
          // K read MN-major: a k-step is 16 key rows, the next 64 columns
          // KB rows on
          uint64_t kb[KB / 16];
#pragma unroll
          for (int kt = 0; kt < KB / 16; ++kt)
            kb[kt] = desc_sw128(ks + kt * 16 * ROW, KB * ROW, 1024);
          fence_regs(kb);
          uint32_t g[KB / 16][4];
          dq_grads<0, 1>(!full, cap, sc, dp, l2, dl, g, a, qp0, k0, c);
          fence_regs(g[0]);
          fence_regs(dq);
          wgmma_fence();
          wgmma_rs_n256(dq, g[0], kb[0]);
          wgmma_commit();
          dq_grads<1, 1>(!full, cap, sc, dp, l2, dl, g, a, qp0, k0, c);
          fence_regs(g[1]);
          wgmma_fence();
          wgmma_rs_n256(dq, g[1], kb[1]);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(bar_empty(s)));
      }
      if (it.nt == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(bar_item_empty(0)));
      }

#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qr = qp0 + 8 * e;
        if (qr >= a.S) continue;
        __nv_bfloat16* out =
            a.dq + ((static_cast<long long>(it.n) * a.S + qr) * a.H + it.h) *
                       static_cast<long long>(D);
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dq[4 * jj + 2 * e], dq[4 * jj + 2 * e + 1]);
      }
    }
  }
}

// dK/dV at d 256: one (K, V) buffer of BLOCK256 rows, the Q/dO ring of
// TILE rows, two (P^T, dS^T) buffers of BLOCK256 x TILE bf16, then the
// ring's stats (l2 and delta of each streamed tile's rows)
constexpr int BLOCK256 = 64;
struct Kv256Smem {
  static constexpr uint32_t KV_BYTES = BLOCK256 * 256 * 2;  // one K or V
  static constexpr uint32_t Q_BYTES = TILE * 256 * 2;       // one Q or dO
  static constexpr uint32_t Q_OFF = 2 * KV_BYTES;
  static constexpr uint32_t PS_OFF = Q_OFF + STAGES * 2 * Q_BYTES;
  static constexpr uint32_t PS_BYTES = BLOCK256 * TILE * 2;  // P^T or dS^T
  static constexpr uint32_t STAT_OFF = PS_OFF + 2 * 2 * PS_BYTES;
  static constexpr uint32_t STAT_BYTES = TILE * 4;
  static constexpr uint32_t BAR_OFF = STAT_OFF + STAGES * 2 * STAT_BYTES;
  static constexpr int BARS = 4 + 2 * STAGES;
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

// P^T and dS^T of a 64 x 32 block of the tile (accumulator fragments st,
// dpt: kv rows kp0 and kp0 + 8 of the thread, tile row `row` and row + 8;
// queries q0 .. q0 + 31, whose l2 and delta are sl[] and sl[TILE + ]) as
// bf16 into the tiles at sp and sds, 16-byte chunks chunk0 .. chunk0 + 3 of
// each 128-byte row, 128-byte swizzled: the K-major A operand of dV +=
// P^T . dO and dK += dS^T . Q.  With MASK, hidden pairs give 0.
template <bool MASK, bool CAP>
__device__ __forceinline__ void dkv_grads_store(const float (&st)[16],
                                                const float (&dpt)[16],
                                                const float* sl, uint32_t sp,
                                                uint32_t sds, const Args& a,
                                                int q0, int kp0, int row,
                                                int chunk0, int c) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * jj + 2 * c);
    const float2 dl =
        *reinterpret_cast<const float2*>(sl + TILE + 8 * jj + 2 * c);
    float p[4], ds[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      prob_grad<CAP>(a, st[4 * jj + u], dpt[4 * jj + u], (u & 1) ? l2.y : l2.x,
                     (u & 1) ? dl.y : dl.x, p[u], ds[u]);
      if (MASK && !visible(a, q0 + 8 * jj + 2 * c + (u & 1),
                           kp0 + 8 * ((u >> 1) & 1))) {
        p[u] = 0.f;
        ds[u] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      const uint32_t off = r * ROW + (((chunk0 + jj) ^ (r & 7)) << 4) + 4 * c;
      hopper::st_shared_b32(sp + off, pack_bf16(p[2 * e], p[2 * e + 1]));
      hopper::st_shared_b32(sds + off, pack_bf16(ds[2 * e], ds[2 * e + 1]));
    }
  }
}

__device__ __forceinline__ void dkv_grads_store(bool mask, bool cap,
                                                const float (&st)[16],
                                                const float (&dpt)[16],
                                                const float* sl, uint32_t sp,
                                                uint32_t sds, const Args& a,
                                                int q0, int kp0, int row,
                                                int chunk0, int c) {
  if (mask) {
    if (cap)
      dkv_grads_store<true, true>(st, dpt, sl, sp, sds, a, q0, kp0, row,
                                  chunk0, c);
    else
      dkv_grads_store<true, false>(st, dpt, sl, sp, sds, a, q0, kp0, row,
                                   chunk0, c);
  } else {
    if (cap)
      dkv_grads_store<false, true>(st, dpt, sl, sp, sds, a, q0, kp0, row,
                                   chunk0, c);
    else
      dkv_grads_store<false, false>(st, dpt, sl, sp, sds, a, q0, kp0, row,
                                    chunk0, c);
  }
}

// dK/dV at d 256 (see the header): the two consumer warpgroups share one
// item of 64 kv rows.  Warpgroup w forms S^T and dP^T of the tile's
// queries 32 w .. 32 w + 31 (m64n32k16, a 64-column half of d at a time),
// and P^T and dS^T of them in fp32, which it stores as bf16 into shared
// memory; after a named barrier over both warpgroups each runs dV += P^T .
// dO and dK += dS^T . Q for head-dim columns 128 w .. 128 w + 127
// (m64n128k16, both operands from shared memory).  The (P^T, dS^T) tiles
// alternate between two buffers, so that a warpgroup that runs ahead
// writes the next tile's while the other still reads this one's.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma256(const __grid_constant__ CUtensorMap tmq,
                        const __grid_constant__ CUtensorMap tmdo,
                        const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv, const Args a,
                        const int nkv) {
  using namespace hopper;
  using L = Kv256Smem;
  constexpr int D = 256, KB = BLOCK256;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * i; };
  const int items = nkv * a.KV * a.N;
  const long long nhs = static_cast<long long>(a.N) * a.H * a.S_pad;
  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // q tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const KvItem it = kv_item<KB>(w, a);
        mbar_wait(bar(bar_item_empty(0)), (j & 1) ^ 1);
        mbar_expect_tx(bar(bar_item_full(0)), 2 * L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(base + hf * KB * ROW, &tmk, bar(bar_item_full(0)),
                      64 * hf, it.kvh, it.k0, it.n);
          tma_load_4d(base + L::KV_BYTES + hf * KB * ROW, &tmv,
                      bar(bar_item_full(0)), 64 * hf, it.kvh, it.k0, it.n);
        }
        // the group's q heads in order, each over its q tiles
        for (int hh = 0; hh < a.rep; ++hh) {
          const int h = it.kvh * a.rep + hh;
          const long long row0 =
              (static_cast<long long>(it.n) * a.H + h) * a.S_pad;
          for (int i = 0; i < it.nt; ++i, ++tile) {
            const int s = tile % STAGES;
            const int q0 = it.lo + i * TILE;
            const uint32_t qs = base + L::Q_OFF + s * 2 * L::Q_BYTES;
            const uint32_t st = base + L::STAT_OFF + s * 2 * L::STAT_BYTES;
            mbar_wait(bar(bar_empty(s)), ((tile / STAGES) & 1) ^ 1);
            mbar_expect_tx(bar(bar_full(s)),
                           2 * L::Q_BYTES + 2 * L::STAT_BYTES);
#pragma unroll
            for (int hf = 0; hf < D / 64; ++hf) {
              tma_load_4d(qs + hf * TILE * ROW, &tmq, bar(bar_full(s)),
                          64 * hf, h, q0, it.n);
              tma_load_4d(qs + L::Q_BYTES + hf * TILE * ROW, &tmdo,
                          bar(bar_full(s)), 64 * hf, h, q0, it.n);
            }
            bulk_load(st, a.stats + row0 + q0, L::STAT_BYTES,
                      bar(bar_full(s)));
            bulk_load(st + L::STAT_BYTES, a.stats + nhs + row0 + q0,
                      L::STAT_BYTES, bar(bar_full(s)));
          }
        }
      }
    }
  } else {
    // ---- consumers: both own the item's 64 kv rows; warpgroup wgi its
    // queries 32 wgi .. of each tile and head-dim columns 128 wgi .. ----
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const int row = 16 * warp + lane / 4;  // tile rows row, row + 8
    const bool cap = a.softcap != 0.f;
    const uint32_t k_s = base, v_s = base + L::KV_BYTES;
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const KvItem it = kv_item<KB>(w, a);
      const int kp0 = it.k0 + row;  // kv rows kp0, kp0 + 8
      float dk[D / 4], dv[D / 4], st[16], dpt[16];
#pragma unroll
      for (int r = 0; r < D / 4; ++r) dk[r] = dv[r] = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) st[r] = dpt[r] = 0.f;

      mbar_wait(bar(bar_item_full(0)), j & 1);
      for (int hh = 0; hh < a.rep; ++hh) {
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const int q0 = it.lo + i * TILE;
          const int wq0 = q0 + 32 * wgi;  // this warpgroup's first query
          // a tile hidden from every pair is skipped by both warpgroups
          const bool skip =
              it.k0 >= a.T || (a.causal && q0 + TILE - 1 < it.k0) ||
              (a.has_window && q0 >= it.k0 + KB - 1 + a.window);
          const uint32_t qs = base + L::Q_OFF + s * 2 * L::Q_BYTES;
          const uint32_t dos = qs + L::Q_BYTES;
          const uint32_t sp = base + L::PS_OFF + (tile & 1) * 2 * L::PS_BYTES;
          const uint32_t sds = sp + L::PS_BYTES;
          mbar_wait(bar(bar_full(s)), (tile / STAGES) & 1);
          if (!skip) {
            // S^T = K . Q^T and dP^T = V . dO^T over this warpgroup's 32
            // queries, a 64-column half of d at a time
            fence_regs(st);
            fence_regs(dpt);
#pragma unroll
            for (int hf = 0; hf < D / 64; ++hf) {
              uint64_t ka[4], qb[4], va[4], dob[4];
              descs_kmajor<64>(ka, qb, k_s + hf * KB * ROW, 0,
                               qs + hf * TILE * ROW + 32 * wgi * ROW, 0);
              descs_kmajor<64>(va, dob, v_s + hf * KB * ROW, 0,
                               dos + hf * TILE * ROW + 32 * wgi * ROW, 0);
              fence_regs(ka);
              fence_regs(qb);
              fence_regs(va);
              fence_regs(dob);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss_n32(st, ka[kk], qb[kk], hf > 0 || kk > 0);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss_n32(dpt, va[kk], dob[kk], hf > 0 || kk > 0);
              wgmma_commit();
            }
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);

            // P^T and dS^T into shared memory, the masks only on a block
            // that hides some pair
            const float* sl = reinterpret_cast<const float*>(
                smem_raw + (base - smem_u32(smem_raw)) + L::STAT_OFF +
                s * 2 * L::STAT_BYTES) + 32 * wgi;
            const bool full = it.k0 + KB <= a.T && wq0 + 32 <= a.S &&
                              (!a.causal || it.k0 + KB - 1 <= wq0) &&
                              (!a.has_window || it.k0 > wq0 + 31 - a.window);
            dkv_grads_store(!full, cap, st, dpt, sl, sp, sds, a, wq0, kp0,
                            row, 4 * wgi, c);
            fence_proxy_async();
          }
          // both warpgroups' halves of P^T and dS^T are in
          bar_sync(1, 128 * CONSUMERS);
          if (!skip) {
            // dV += P^T . dO and dK += dS^T . Q: A K-major from the staged
            // tiles (a k-step is 16 queries, 32 bytes of a row), dO and Q
            // MN-major over this warpgroup's two 64-column halves
            uint64_t pa[4], ga[4], ob[4], qb[4];
#pragma unroll
            for (int kt = 0; kt < 4; ++kt) {
              pa[kt] = desc_sw128(sp + kt * 32, 16, 1024);
              ga[kt] = desc_sw128(sds + kt * 32, 16, 1024);
            }
            descs_mnmajor(ob, dos + 2 * wgi * TILE * ROW);
            descs_mnmajor(qb, qs + 2 * wgi * TILE * ROW);
            fence_regs(pa);
            fence_regs(ga);
            fence_regs(ob);
            fence_regs(qb);
            fence_regs(dv);
            fence_regs(dk);
            wgmma_fence();
#pragma unroll
            for (int kt = 0; kt < 4; ++kt) wgmma_ss_n128_mn(dv, pa[kt], ob[kt]);
#pragma unroll
            for (int kt = 0; kt < 4; ++kt) wgmma_ss_n128_mn(dk, ga[kt], qb[kt]);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv);
            fence_regs(dk);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(bar_empty(s)));
        }
      }
      // this item's K and V buffer is free for the next item
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(bar_item_empty(0)));

#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kr = kp0 + 8 * e;
        if (kr >= a.T) continue;
        const long long off =
            ((static_cast<long long>(it.n) * a.T + kr) * a.KV + it.kvh) *
                static_cast<long long>(D) +
            128 * wgi;
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dk[4 * jj + 2 * e], dk[4 * jj + 2 * e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dv[4 * jj + 2 * e], dv[4 * jj + 2 * e + 1]);
        }
      }
    }
  }
}

// ---- q/k head dim 192, v head dim 128 (MLA) -----------------------------

constexpr int DQK192 = 192, DV128 = 128;
constexpr int QS192 = DQK192 / 64, VS128 = DV128 / 64;  // 64-column slices

// dQ at (192, 128): one (Q, dO) buffer of BLOCK rows (Q in QS192 slices, dO
// in VS128), then a 2-stage ring of (K, V) tiles of TILE rows
struct Dq192Smem {
  static constexpr uint32_t Q_BYTES = BLOCK * DQK192 * 2;  // 48 KB
  static constexpr uint32_t DO_BYTES = BLOCK * DV128 * 2;  // 32 KB
  static constexpr uint32_t K_BYTES = TILE * DQK192 * 2;   // 24 KB
  static constexpr uint32_t V_BYTES = TILE * DV128 * 2;    // 16 KB
  static constexpr uint32_t KV_OFF = Q_BYTES + DO_BYTES;
  static constexpr uint32_t BAR_OFF = KV_OFF + STAGES * (K_BYTES + V_BYTES);
  static constexpr int BARS = 4 + 2 * STAGES;
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

// (n, q head) slowest, then its q tiles longest first (causal): the blocks
// at work at one time read the K and V of few (n, kv head)s, which stay in
// L2 between them
__device__ __forceinline__ DqItem dq_item192(int w, int nq, const Args& a) {
  DqItem it;
  const int nh = w / nq;
  it.q0 = (nq - 1 - w % nq) * BLOCK;
  it.h = nh % a.H;
  it.n = nh / a.H;
  int hi = a.T;
  if (a.causal) hi = min(hi, it.q0 + BLOCK);
  it.lo = 0;
  if (a.has_window) it.lo = max(0, it.q0 - a.window + 1) / TILE * TILE;
  it.nt = hi > it.lo ? (hi - it.lo + TILE - 1) / TILE : 0;
  return it;
}

// dQ at (192, 128) (see the header): flash_bwd_dq_wgmma's design with one
// (Q, dO) buffer, freed after the item's last S and dP so that the next
// item's lands during the last tile's dQ and the epilogue; S = Q . K^T over
// three 64-column slices and dP = dO . V^T over two, a commit group a
// slice; dQ += dS . K one m64n192k16 a k-step (96 registers of dQ), in two
// halves of the keys as at d 128.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma192(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmdo,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, const Args a,
                      const int nq) {
  using namespace hopper;
  using L = Dq192Smem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * i; };
  const int items = nq * a.H * a.N;
  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // key tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const DqItem it = dq_item192(w, nq, a);
        const int kvh = it.h / a.rep;
        mbar_wait(bar(bar_item_empty(0)), (j & 1) ^ 1);
        mbar_expect_tx(bar(bar_item_full(0)), L::Q_BYTES + L::DO_BYTES);
#pragma unroll
        for (int hf = 0; hf < QS192; ++hf)
          tma_load_4d(base + hf * BLOCK * ROW, &tmq, bar(bar_item_full(0)),
                      64 * hf, it.h, it.q0, it.n);
#pragma unroll
        for (int hf = 0; hf < VS128; ++hf)
          tma_load_4d(base + L::Q_BYTES + hf * BLOCK * ROW, &tmdo,
                      bar(bar_item_full(0)), 64 * hf, it.h, it.q0, it.n);
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const int k0 = it.lo + i * TILE;
          const uint32_t ks = base + L::KV_OFF + s * (L::K_BYTES + L::V_BYTES);
          mbar_wait(bar(bar_empty(s)), ((tile / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar(bar_full(s)), L::K_BYTES + L::V_BYTES);
#pragma unroll
          for (int hf = 0; hf < QS192; ++hf)
            tma_load_4d(ks + hf * TILE * ROW, &tmk, bar(bar_full(s)),
                        64 * hf, kvh, k0, it.n);
#pragma unroll
          for (int hf = 0; hf < VS128; ++hf)
            tma_load_4d(ks + L::K_BYTES + hf * TILE * ROW, &tmv,
                        bar(bar_full(s)), 64 * hf, kvh, k0, it.n);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns q rows [q0 + 64 wgi, + 64) ----
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const bool cap = a.softcap != 0.f;
    const long long nhs = static_cast<long long>(a.N) * a.H * a.S_pad;
    const uint32_t q_wg = base + 64 * wgi * ROW, do_wg = q_wg + L::Q_BYTES;
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const DqItem it = dq_item192(w, nq, a);
      const int wq0 = it.q0 + 64 * wgi;
      const int qp0 = wq0 + 16 * warp + lane / 4;  // rows qp0, qp0 + 8
      float l2[2], dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long li =
            (static_cast<long long>(it.n) * a.H + it.h) * a.S_pad + qp0 +
            8 * e;
        l2[e] = a.stats[li];
        dl[e] = a.stats[nhs + li];
      }
      float dq[DQK192 / 2], sc[TILE / 2], dp[TILE / 2];
#pragma unroll
      for (int r = 0; r < DQK192 / 2; ++r) dq[r] = 0.f;
#pragma unroll
      for (int r = 0; r < TILE / 2; ++r) sc[r] = dp[r] = 0.f;

      mbar_wait(bar(bar_item_full(0)), j & 1);
      for (int i = 0; i < it.nt; ++i, ++tile) {
        const int s = tile % STAGES;
        const int k0 = it.lo + i * TILE;
        const bool skip = wq0 >= a.S || (a.causal && k0 > wq0 + 63) ||
                          (a.has_window && k0 + TILE - 1 <= wq0 - a.window);
        const uint32_t ks = base + L::KV_OFF + s * (L::K_BYTES + L::V_BYTES);
        const uint32_t vs = ks + L::K_BYTES;
        mbar_wait(bar(bar_full(s)), (tile / STAGES) & 1);
        if (!skip) {
          // S = Q . K^T over three 64-column slices, dP = dO . V^T over two
          fence_regs(sc);
          fence_regs(dp);
#pragma unroll
          for (int hf = 0; hf < QS192; ++hf) {
            uint64_t qa[4], kb[4];
            descs_kmajor<64>(qa, kb, q_wg + hf * BLOCK * ROW, 0,
                             ks + hf * TILE * ROW, 0);
            fence_regs(qa);
            fence_regs(kb);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n64(sc, qa[kk], kb[kk], hf > 0 || kk > 0);
            wgmma_commit();
          }
#pragma unroll
          for (int hf = 0; hf < VS128; ++hf) {
            uint64_t oa[4], vb[4];
            descs_kmajor<64>(oa, vb, do_wg + hf * BLOCK * ROW, 0,
                             vs + hf * TILE * ROW, 0);
            fence_regs(oa);
            fence_regs(vb);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n64(dp, oa[kk], vb[kk], hf > 0 || kk > 0);
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
        }
        // the item's last S and dP have read this warpgroup's Q and dO
        __syncwarp();
        if (lane == 0 && i == it.nt - 1) mbar_arrive(bar(bar_item_empty(0)));
        if (!skip) {
          // dS in place of the scores, the masks only on a tile that hides
          // some pair; dQ += dS . K (K read MN-major over its three slices)
          // in two halves of the keys
          const bool full = k0 + TILE <= a.T && wq0 + 64 <= a.S &&
                            (!a.causal || k0 + TILE - 1 <= wq0) &&
                            (!a.has_window || k0 > wq0 + 63 - a.window);
          uint64_t kb[4];
          descs_mnmajor(kb, ks);
          fence_regs(kb);
          uint32_t g[4][4];
          dq_grads<0, 2>(!full, cap, sc, dp, l2, dl, g, a, qp0, k0, c);
          fence_regs(g[0]);
          fence_regs(g[1]);
          fence_regs(dq);
          wgmma_fence();
          wgmma_rs_n192(dq, g[0], kb[0]);
          wgmma_rs_n192(dq, g[1], kb[1]);
          wgmma_commit();
          dq_grads<1, 2>(!full, cap, sc, dp, l2, dl, g, a, qp0, k0, c);
          fence_regs(g[2]);
          fence_regs(g[3]);
          wgmma_fence();
          wgmma_rs_n192(dq, g[2], kb[2]);
          wgmma_rs_n192(dq, g[3], kb[3]);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(bar_empty(s)));
      }
      if (it.nt == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(bar_item_empty(0)));
      }

#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qr = qp0 + 8 * e;
        if (qr >= a.S) continue;
        __nv_bfloat16* out =
            a.dq + ((static_cast<long long>(it.n) * a.S + qr) * a.H + it.h) *
                       static_cast<long long>(DQK192);
#pragma unroll
        for (int jj = 0; jj < DQK192 / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dq[4 * jj + 2 * e], dq[4 * jj + 2 * e + 1]);
      }
    }
  }
}

// dK/dV at (192, 128): two (K, V) buffers of BLOCK rows (K in QS192
// slices, V in VS128), then a 2-stage ring of (Q, dO) tiles of QT192 rows,
// then the ring's stats (l2 and delta of each streamed tile's rows)
constexpr int QT192 = 32;
struct Kv192Smem {
  static constexpr uint32_t K_BYTES = BLOCK * DQK192 * 2;   // 48 KB
  static constexpr uint32_t V_BYTES = BLOCK * DV128 * 2;    // 32 KB
  static constexpr uint32_t ITEM_BYTES = K_BYTES + V_BYTES;
  static constexpr uint32_t Q_BYTES = QT192 * DQK192 * 2;   // 12 KB
  static constexpr uint32_t DO_BYTES = QT192 * DV128 * 2;   // 8 KB
  static constexpr uint32_t STAGE_BYTES = Q_BYTES + DO_BYTES;
  static constexpr uint32_t Q_OFF = 2 * ITEM_BYTES;
  static constexpr uint32_t STAT_OFF = Q_OFF + STAGES * STAGE_BYTES;
  static constexpr uint32_t STAT_BYTES = QT192 * 4;         // l2 or delta
  static constexpr uint32_t BAR_OFF = STAT_OFF + STAGES * 2 * STAT_BYTES;
  static constexpr int BARS = 4 + 2 * STAGES;
  static constexpr size_t BYTES = BAR_OFF + 8 * BARS + 1024;
};

// (n, kv head) slowest, then its kv tiles first (causal: the most queries)
// first: the blocks at work at one time read the Q and dO of few (n, kv
// head)s, which stay in L2 between them
__device__ __forceinline__ KvItem kv_item192(int w, int nkv, const Args& a) {
  KvItem it;
  const int nk = w / nkv;
  it.k0 = (w % nkv) * BLOCK;
  it.kvh = nk % a.KV;
  it.n = nk / a.KV;
  // q tiles that can see a key of the item
  it.lo = a.causal ? it.k0 : 0;
  int hi = a.S;
  if (a.has_window) hi = min(hi, it.k0 + BLOCK - 1 + a.window);
  it.nt = hi > it.lo ? (hi - it.lo + QT192 - 1) / QT192 : 0;
  return it;
}

// dK/dV at (192, 128) (see the header): flash_bwd_dkdv_wgmma's design,
// each consumer warpgroup owning 64 kv rows (dK 96 and dV 64 registers a
// thread), over streamed q tiles of 32 rows: S^T = K . Q^T over three
// 64-column slices and dP^T = V . dO^T over two (m64n32k16, 16 + 16
// registers), P^T and dS^T in registers, then dV += P^T . dO (m64n128k16)
// and dK += dS^T . Q (m64n192k16), dO and Q read MN-major, a k-step of 16
// queries at a time, the second half formed while the first half's
// products run.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma192(const __grid_constant__ CUtensorMap tmq,
                        const __grid_constant__ CUtensorMap tmdo,
                        const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv, const Args a,
                        const int nkv) {
  using namespace hopper;
  using L = Kv192Smem;
  constexpr int QT = QT192;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * i; };
  const int items = nkv * a.KV * a.N;
  const long long nhs = static_cast<long long>(a.N) * a.H * a.S_pad;
  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                              0);
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int tile = 0;  // q tiles issued so far, across items
      for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
        const KvItem it = kv_item192(w, nkv, a);
        const int b = j & 1;
        const uint32_t kvs = base + b * L::ITEM_BYTES;
        mbar_wait(bar(bar_item_empty(b)), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(bar(bar_item_full(b)), L::ITEM_BYTES);
#pragma unroll
        for (int hf = 0; hf < QS192; ++hf)
          tma_load_4d(kvs + hf * BLOCK * ROW, &tmk, bar(bar_item_full(b)),
                      64 * hf, it.kvh, it.k0, it.n);
#pragma unroll
        for (int hf = 0; hf < VS128; ++hf)
          tma_load_4d(kvs + L::K_BYTES + hf * BLOCK * ROW, &tmv,
                      bar(bar_item_full(b)), 64 * hf, it.kvh, it.k0, it.n);
        // the group's q heads in order, each over its q tiles
        for (int hh = 0; hh < a.rep; ++hh) {
          const int h = it.kvh * a.rep + hh;
          const long long row0 =
              (static_cast<long long>(it.n) * a.H + h) * a.S_pad;
          for (int i = 0; i < it.nt; ++i, ++tile) {
            const int s = tile % STAGES;
            const int q0 = it.lo + i * QT;
            const uint32_t qs = base + L::Q_OFF + s * L::STAGE_BYTES;
            const uint32_t st = base + L::STAT_OFF + s * 2 * L::STAT_BYTES;
            mbar_wait(bar(bar_empty(s)), ((tile / STAGES) & 1) ^ 1);
            mbar_expect_tx(bar(bar_full(s)),
                           L::STAGE_BYTES + 2 * L::STAT_BYTES);
#pragma unroll
            for (int hf = 0; hf < QS192; ++hf)
              tma_load_4d(qs + hf * QT * ROW, &tmq, bar(bar_full(s)),
                          64 * hf, h, q0, it.n);
#pragma unroll
            for (int hf = 0; hf < VS128; ++hf)
              tma_load_4d(qs + L::Q_BYTES + hf * QT * ROW, &tmdo,
                          bar(bar_full(s)), 64 * hf, h, q0, it.n);
            bulk_load(st, a.stats + row0 + q0, L::STAT_BYTES,
                      bar(bar_full(s)));
            bulk_load(st + L::STAT_BYTES, a.stats + nhs + row0 + q0,
                      L::STAT_BYTES, bar(bar_full(s)));
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns kv rows [k0 + 64 wgi, + 64) ----
    regs_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const bool cap = a.softcap != 0.f;
    int tile = 0;
    for (int j = 0, w = nth_item(0); w < items; w = nth_item(++j)) {
      const KvItem it = kv_item192(w, nkv, a);
      const int wk0 = it.k0 + 64 * wgi;
      const int kp0 = wk0 + 16 * warp + lane / 4;  // rows kp0, kp0 + 8
      const int b = j & 1;
      const uint32_t k_wg = base + b * L::ITEM_BYTES + 64 * wgi * ROW;
      const uint32_t v_wg = k_wg + L::K_BYTES;
      float dk[DQK192 / 2], dv[DV128 / 2], st[QT / 2], dpt[QT / 2];
#pragma unroll
      for (int r = 0; r < DQK192 / 2; ++r) dk[r] = 0.f;
#pragma unroll
      for (int r = 0; r < DV128 / 2; ++r) dv[r] = 0.f;
#pragma unroll
      for (int r = 0; r < QT / 2; ++r) st[r] = dpt[r] = 0.f;

      mbar_wait(bar(bar_item_full(b)), (j >> 1) & 1);
      for (int hh = 0; hh < a.rep; ++hh) {
        for (int i = 0; i < it.nt; ++i, ++tile) {
          const int s = tile % STAGES;
          const int q0 = it.lo + i * QT;
          const bool skip =
              wk0 >= a.T || (a.causal && q0 + QT - 1 < wk0) ||
              (a.has_window && q0 >= wk0 + 63 + a.window);
          mbar_wait(bar(bar_full(s)), (tile / STAGES) & 1);
          if (!skip) {
            const uint32_t qs = base + L::Q_OFF + s * L::STAGE_BYTES;
            const uint32_t dos = qs + L::Q_BYTES;
            // S^T = K . Q^T over three 64-column slices, dP^T = V . dO^T
            // over two
            fence_regs(st);
            fence_regs(dpt);
#pragma unroll
            for (int hf = 0; hf < QS192; ++hf) {
              uint64_t ka[4], qb[4];
              descs_kmajor<64>(ka, qb, k_wg + hf * BLOCK * ROW, 0,
                               qs + hf * QT * ROW, 0);
              fence_regs(ka);
              fence_regs(qb);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss_n32(st, ka[kk], qb[kk], hf > 0 || kk > 0);
              wgmma_commit();
            }
#pragma unroll
            for (int hf = 0; hf < VS128; ++hf) {
              uint64_t va[4], ob[4];
              descs_kmajor<64>(va, ob, v_wg + hf * BLOCK * ROW, 0,
                               dos + hf * QT * ROW, 0);
              fence_regs(va);
              fence_regs(ob);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss_n32(dpt, va[kk], ob[kk], hf > 0 || kk > 0);
              wgmma_commit();
            }
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);

            // P^T and dS^T in place, the masks only on a tile that hides
            // some pair; dV += P^T . dO and dK += dS^T . Q (dO and Q read
            // MN-major: a k-step is 16 queries, the next 64 columns QT rows
            // on), a k-step at a time, the second formed while the first
            // one's products run
            const float* sl = reinterpret_cast<const float*>(
                smem_raw + (base - smem_u32(smem_raw)) + L::STAT_OFF +
                s * 2 * L::STAT_BYTES);
            const bool full = wk0 + 64 <= a.T && q0 + QT <= a.S &&
                              (!a.causal || wk0 + 63 <= q0) &&
                              (!a.has_window ||
                               wk0 > q0 + QT - 1 - a.window);
            uint64_t ob2[QT / 16], qb2[QT / 16];
#pragma unroll
            for (int kt = 0; kt < QT / 16; ++kt) {
              ob2[kt] = desc_sw128(dos + kt * 16 * ROW, QT * ROW, 1024);
              qb2[kt] = desc_sw128(qs + kt * 16 * ROW, QT * ROW, 1024);
            }
            fence_regs(ob2);
            fence_regs(qb2);
            uint32_t pa[QT / 16][4], ga[QT / 16][4];
            dkv_grads<0>(!full, cap, st, dpt, sl, pa, ga, a, q0, kp0, c);
            fence_regs(pa[0]);
            fence_regs(ga[0]);
            fence_regs(dv);
            fence_regs(dk);
            wgmma_fence();
            wgmma_rs_n128(dv, pa[0], ob2[0]);
            wgmma_rs_n192(dk, ga[0], qb2[0]);
            wgmma_commit();
            dkv_grads<1>(!full, cap, st, dpt, sl, pa, ga, a, q0, kp0, c);
            fence_regs(pa[1]);
            fence_regs(ga[1]);
            wgmma_fence();
            wgmma_rs_n128(dv, pa[1], ob2[1]);
            wgmma_rs_n192(dk, ga[1], qb2[1]);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv);
            fence_regs(dk);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(bar_empty(s)));
        }
      }
      // this item's K and V buffer is free for the item after next
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(bar_item_empty(b)));

#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kr = kp0 + 8 * e;
        if (kr >= a.T) continue;
        const long long row =
            (static_cast<long long>(it.n) * a.T + kr) * a.KV + it.kvh;
        __nv_bfloat16* gk = a.dk + row * DQK192;
        __nv_bfloat16* gv = a.dv + row * DV128;
#pragma unroll
        for (int jj = 0; jj < DQK192 / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(gk + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dk[4 * jj + 2 * e], dk[4 * jj + 2 * e + 1]);
#pragma unroll
        for (int jj = 0; jj < DV128 / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(gv + 8 * jj + 2 * c) =
              __floats2bfloat162_rn(dv[4 * jj + 2 * e], dv[4 * jj + 2 * e + 1]);
      }
    }
  }
}

// a dQ or dK/dV kernel of the wgmma route
using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                        Args, int);

// The dynamic shared memory `fn` takes, and the check that ptxas gave its
// block the registers of the hand-over: setmaxnreg.inc waits for the
// registers the producer gave back, so with fewer the consumers would wait
// forever (ptxas sets the count from __launch_bounds__: 168 a thread)
cudaError_t prepare(Kernel fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * THREADS <
      128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// The stats pass, then the dQ and the dK/dV kernels, each persistent: one
// block per SM walks its items.  q and k have head dim DQK, v, o and dO
// DV.  The dQ kernel's items are BLOCK q rows over key tiles of dq_tile
// rows; the dK/dV kernel's kv_block kv rows over q tiles of kv_qtile rows.
template <int DQK, int DV>
cudaError_t launch(const Args& a, const void* q, const void* k,
                   const void* v, const long long (&st)[4][3],
                   cudaStream_t stream, Kernel dq_fn, size_t dq_smem,
                   int dq_tile, Kernel kv_fn, size_t kv_smem, int kv_block,
                   int kv_qtile) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int nq = (a.S + BLOCK - 1) / BLOCK;
  const int nkv = (a.T + kv_block - 1) / kv_block;
  const long long dq_items = static_cast<long long>(nq) * a.H * a.N;
  const long long kv_items = static_cast<long long>(nkv) * a.KV * a.N;
  const long long stat_threads =
      static_cast<long long>(a.N) * a.S_pad * a.H * (DV / 8);
  if (dq_items > INT_MAX || kv_items > INT_MAX ||
      (stat_threads + 255) / 256 > INT_MAX)
    return cudaErrorInvalidValue;
  // (q, dO) with boxes of BLOCK rows and (k, v) of dq_tile rows for dQ;
  // (q, dO) of kv_qtile rows and (k, v) of kv_block rows for dK/dV
  CUtensorMap mq[2], mdo[2], mk[2], mv[2];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    const int qbox = i == 0 ? BLOCK : kv_qtile;
    const int kbox = i == 0 ? dq_tile : kv_block;
    err = make_map(&mq[i], q, DQK, a.H, a.S, a.N, st[0][2], st[0][1],
                   st[0][0], qbox);
    if (err == cudaSuccess)
      err = make_map(&mdo[i], a.dout, DV, a.H, a.S, a.N, st[3][2], st[3][1],
                     st[3][0], qbox);
    if (err == cudaSuccess)
      err = make_map(&mk[i], k, DQK, a.KV, a.T, a.N, st[1][2], st[1][1],
                     st[1][0], kbox);
    if (err == cudaSuccess)
      err = make_map(&mv[i], v, DV, a.KV, a.T, a.N, st[2][2], st[2][1],
                     st[2][0], kbox);
  }
  if (err == cudaSuccess) err = prepare(dq_fn, dq_smem);
  if (err == cudaSuccess) err = prepare(kv_fn, kv_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_stats<DV><<<static_cast<unsigned>((stat_threads + 255) / 256),
                        256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_fn<<<static_cast<int>(dq_items < sms ? dq_items : sms), THREADS, dq_smem,
          stream>>>(mq[0], mdo[0], mk[0], mv[0], a, nq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_fn<<<static_cast<int>(kv_items < sms ? kv_items : sms), THREADS,
          kv_smem, stream>>>(mq[1], mdo[1], mk[1], mv[1], a, nkv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, const void* q, const void* k,
                     const void* v, const long long (&st)[4][3],
                     cudaStream_t stream) {
  return launch<D, D>(a, q, k, v, st, stream, flash_bwd_dq_wgmma<D>,
                      DqSmem<D>::BYTES, TILE, flash_bwd_dkdv_wgmma<D>,
                      KvSmem<D>::BYTES, BLOCK, TILE);
}

template <>
cudaError_t launch_d<256>(const Args& a, const void* q, const void* k,
                          const void* v, const long long (&st)[4][3],
                          cudaStream_t stream) {
  return launch<256, 256>(a, q, k, v, st, stream, flash_bwd_dq_wgmma256,
                          Dq256Smem::BYTES, TILE256, flash_bwd_dkdv_wgmma256,
                          Kv256Smem::BYTES, BLOCK256, TILE);
}

cudaError_t launch_d192(const Args& a, const void* q, const void* k,
                        const void* v, const long long (&st)[4][3],
                        cudaStream_t stream) {
  return launch<DQK192, DV128>(a, q, k, v, st, stream, flash_bwd_dq_wgmma192,
                               Dq192Smem::BYTES, TILE,
                               flash_bwd_dkdv_wgmma192, Kv192Smem::BYTES,
                               BLOCK, QT192);
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d one of 16, 32, 64, 128, 256; every
// tensor contiguous in the layout above; delta is N * H * S floats of
// scratch.  window < 0 means no window, softcap 0 no softcap.  Returns the
// CUDA error of the launches (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int d, int N, int S, int T, int H, int KV,
    float scale, int causal, int window, float softcap, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T < 0 ||
      N > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, T, H, KV, H / KV,
         scale, causal, window >= 0 ? 1 : 0, window, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, d, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, d, st);
  return cudaErrorInvalidValue;
}

// bf16, the wgmma + TMA route: q and k of head dim d, v, o and dout of dv,
// at d = dv = 64, 128 or 256, or d 192 with dv 128 (the wrapper zero-pads
// any other pair up to one of them, ops.py::route).  Strides in elements,
// the inner stride of every input 1, every row 16-byte aligned and every
// stride of an extent over 1 a positive multiple of 16 bytes
// (ops.py::_rows_aligned copies a view that is not); dq, dk (head dim d)
// and dv (dv) contiguous; stats is 2 * N * H * s_pad floats of scratch,
// s_pad a multiple of 128 no smaller than S.  window < 0 means no window,
// softcap 0 no softcap.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* stats, void* dq, void* dk,
    void* dv, int d, int d_v, int N, int S, int T, int H, int KV, int s_pad,
    long long qs0, long long qs1, long long qs2, long long ks0,
    long long ks1, long long ks2, long long vs0, long long vs1,
    long long vs2, long long os0, long long os1, long long os2,
    long long ds0, long long ds1, long long ds2, float scale, int causal,
    int window, float softcap, void* stream) {
  if (N <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      s_pad < S || s_pad % wg::BLOCK != 0)
    return cudaErrorInvalidValue;
  const wg::Args a{o, dout, os0, os1, os2, ds0, ds1, ds2, lse, stats,
                   static_cast<__nv_bfloat16*>(dq),
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), N, S, T, H, KV, H / KV,
                   s_pad, scale, causal, window >= 0 ? 1 : 0, window,
                   softcap};
  const long long st[4][3] = {{qs0, qs1, qs2},
                              {ks0, ks1, ks2},
                              {vs0, vs1, vs2},
                              {ds0, ds1, ds2}};
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (d == wg::DQK192 && d_v == wg::DV128)
    return wg::launch_d192(a, q, k, v, st, sm);
  if (d_v != d) return cudaErrorInvalidValue;
  if (d == 64) return wg::launch_d<64>(a, q, k, v, st, sm);
  if (d == 128) return wg::launch_d<128>(a, q, k, v, st, sm);
  if (d == 256) return wg::launch_d<256>(a, q, k, v, st, sm);
  return cudaErrorInvalidValue;
}
