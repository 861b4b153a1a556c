// Flash-attention backward, written by hand for Hopper (sm_90a).
//
// Replaces: the gradient of repro/kernels/flash_attention/
// flash_attention.py::flash_attention_pallas.  The JAX package has no
// backward kernel (it trains through its jnp reference, use_pallas
// defaults to False); this is the backward of the port's forward kernel,
// flash_attention.cu, which writes the row log-sum-exp L it needs.
//
// Layout, the forward's, every tensor contiguous (the wrapper copies):
// q, o, do, dq (N, S, H, D); k, v, dk, dv (N, T, KV, D); L and the scratch
// delta (N, H, S) f32.  f32 or bf16 inputs and outputs, fp32 everywhere
// inside.  D is one of 16, 32, 64, 128, 256 (the wrapper zero-pads).
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
//
// Deterministic, with no atomics: three kernels, each output element
// written once by one thread, every sum in a fixed order.
// - flash_bwd_delta: one warp per (n, s, h) row;
// - flash_bwd_dq: one block per (q tile, q head, n) walks the kv tiles the
//   tile can see and recomputes the scores, P, dP and dS for each;
// - flash_bwd_dkdv: one block per (kv tile, kv head, n) walks the group's
//   q heads in order and, for each, the q tiles that can see the tile.
// Tiles are staged in shared memory as fp32 rows padded by one word (no
// bank conflicts on column reads); 256 threads as 16 x 16, a thread owning
// R = B / 16 rows and every 16th column of a score tile and of its output
// rows.  The products run on fp32 FMA: a simple kernel that is right, not
// yet a tensor-core one.
// All launch on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
