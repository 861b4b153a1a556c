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
// Per chunk of L rows, with cum the running sum of dt * A over the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . h_prev
//   h_new = exp(cum_{L-1}) h_prev
//         + sum_j B_j^T exp(cum_{L-1} - cum_j) dt_j x_j
// The exponent of the decay is only formed for j <= i, where it is <= 0 (dt
// > 0, A < 0): future entries, whose exp would overflow, are never
// evaluated, and they contribute exactly 0, as the reference's
// exp(where(mask, diff, -inf)) makes them for finite inputs.  Every
// product, sum and exponential is fp32; nothing is rounded to bf16.
//
// What bounds it on this card: bytes.  At the serving shape (R 4, Bt 8, H 6,
// S 2048, P 64, N 128, chunk 128, bf16) it must move ~192 MB (x 50 MB, y in
// f32 101 MB, B and C 17 MB each, h_final 6 MB): ~57 us at 3.35 TB/s,
// against ~17 GFLOP of products (~17 us on the tensor cores).
//
// What the design does about it (a simple design, right first):
// - one block of 256 threads per (rank, batch, head) walks the chunks in
//   order, carrying the (N, P) fp32 state in shared memory (32 KB at N 128,
//   P 64); a loop over chunks takes the place of Pallas' sequential grid
//   axis;
// - each chunk's C, B (rows padded by one word: column reads are free of
//   bank conflicts) and x tiles are staged in dynamic shared memory as fp32
//   (216 KB at the serving shape, opted in past 48 KB);
// - the cumulative decay is a prefix sum in fp32, taken in row order by
//   one thread (128 dependent adds per chunk);
// - the masked decay matrix W = (C . B^T) o exp(cum_i - cum_j) dt_j is
//   built 32 rows at a time (4 x 4 per thread, only columns j that can be
//   <= i), then y's 32 rows = W . x + exp(cum) (C . h_prev) (4 x 2 per
//   thread), then the state update (16 x 2 per thread);
// - all products run on fp32 FMA (no tensor cores), so the kernel is held
//   by the FMA rate and one block per SM, not by the bytes.
// It launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_L = 128;    // chunk rows
constexpr int MAX_N = 128;    // state size
constexpr int MAX_P = 64;     // head dim
constexpr int BI = 32;        // rows of W per block of the chunk

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* hout;
  int Bt, S, H, P, G, N, L;
  long long xs0, xs1, xs2, xs3;
  long long ds0, ds1, ds2, ds3;
  long long as0, as1;
  long long bs0, bs1, bs2, bs3;
  long long cs0, cs1, cs2, cs3;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int L, int N, int P) {
  return sizeof(float) * (2 * static_cast<size_t>(L) * (N + 1) +
                          static_cast<size_t>(L) * P +
                          static_cast<size_t>(N) * P +
                          static_cast<size_t>(BI) * L + 4 * L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const Args a) {
  const int L = a.L, N = a.N, P = a.P;
  const int LDN = N + 1;
  extern __shared__ float smem[];
  float* sC = smem;             // L x LDN
  float* sB = sC + L * LDN;     // L x LDN
  float* sX = sB + L * LDN;     // L x P
  float* sH = sX + L * P;       // N x P, the carried state
  float* sW = sH + N * P;       // BI x L, 32 rows of the decay matrix
  float* sCum = sW + BI * L;    // cum_i
  float* sEc = sCum + L;        // exp(cum_i)
  float* sF = sEc + L;          // exp(cum_{L-1} - cum_j) dt_j
  float* sDt = sF + L;          // dt_j

  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const long long blk = blockIdx.x;  // (r * Bt + bt) * H + h
  const int h = static_cast<int>(blk % a.H);
  const long long rb = blk / a.H;
  const int bt = static_cast<int>(rb % a.Bt);
  const long long r = rb / a.Bt;
  const int g = h / (a.H / a.G);
  const T* X = static_cast<const T*>(a.x) + r * a.xs0 + bt * a.xs1 +
               h * a.xs3;
  const float* DT = a.dt + r * a.ds0 + bt * a.ds1 + h * a.ds3;
  const float A = a.a[r * a.as0 + h * a.as1];
  const T* Bm = static_cast<const T*>(a.b) + r * a.bs0 + bt * a.bs1 +
                g * a.bs3;
  const T* Cm = static_cast<const T*>(a.c) + r * a.cs0 + bt * a.cs1 +
                g * a.cs3;
  const long long y_row = static_cast<long long>(a.H) * P;
  float* Y = a.y + rb * a.S * y_row + static_cast<long long>(h) * P;
  float* HO = a.hout + blk * N * P;

  for (int i = tid; i < N * P; i += THREADS) sH[i] = 0.f;

  const int nc = a.S / L;
  const int col_groups = (L + 31) / 32;
  for (int ch = 0; ch < nc; ++ch) {
    const long long s0 = static_cast<long long>(ch) * L;
    __syncthreads();  // the last chunk's tiles are consumed, h is updated
    for (int i = tid; i < L * N; i += THREADS) {
      const int row = i / N, col = i - row * N;
      sB[row * LDN + col] = to_f32(Bm[(s0 + row) * a.bs2 + col]);
      sC[row * LDN + col] = to_f32(Cm[(s0 + row) * a.cs2 + col]);
    }
    for (int i = tid; i < L * P; i += THREADS) {
      const int row = i / P, col = i - row * P;
      sX[i] = to_f32(X[(s0 + row) * a.xs2 + col]);
    }
    for (int i = tid; i < L; i += THREADS) sDt[i] = DT[(s0 + i) * a.ds2];
    __syncthreads();

    if (tid == 0) {
      // the running sum of dt * A, in order: a rounded product, then a
      // rounded sum (no FMA contraction), as the plain version's
      // elementwise product and cumsum compute it.  A tree-shaped scan
      // rounds nearby rows' partial sums apart, and exp(cum_i - cum_j)
      // reads their differences at |cum| ~ 1e3.
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run = __fadd_rn(run, __fmul_rn(sDt[i], A));
        sCum[i] = run;
      }
    }
    __syncthreads();
    const float c_last = sCum[L - 1];
    for (int i = tid; i < L; i += THREADS) {
      sEc[i] = expf(sCum[i]);
      sF[i] = expf(c_last - sCum[i]) * sDt[i];
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += BI) {
      // W rows i0 + 4 ty + rr, columns j = tx + 32 k with j < i0 + BI
      const int kmax = min(i0 / 32 + 1, col_groups);
      int crow[4], bcol[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) crow[rr] = min(i0 + 4 * ty + rr, L - 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) bcol[k] = min(tx + 32 * k, L - 1);
      float acc[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[rr][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) cv[rr] = sC[crow[rr] * LDN + n];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < kmax) bv[k] = sB[bcol[k] * LDN + n];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < kmax) acc[rr][k] = fmaf(cv[rr], bv[k], acc[rr][k]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int i = i0 + 4 * ty + rr;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = tx + 32 * k;
          if (k < kmax && j < L) {
            float w = 0.f;
            if (i < L && j <= i)
              w = acc[rr][k] * expf(sCum[i] - sCum[j]) * sDt[j];
            sW[(4 * ty + rr) * L + j] = w;
          }
        }
      }
      __syncthreads();

      if (i0 + 4 * ty < L) {
        // y rows i0 + 4 ty + rr, columns p = tx + 32 q
        const int jmax = min(i0 + 4 * ty + 3, L - 1);
        float yi[4][2], ye[4][2];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int q = 0; q < 2; ++q) yi[rr][q] = ye[rr][q] = 0.f;
        const bool p1 = tx + 32 < P;
        const int pc0 = min(tx, P - 1), pc1 = min(tx + 32, P - 1);
        for (int j = 0; j <= jmax; ++j) {
          const float x0 = sX[j * P + pc0], x1 = sX[j * P + pc1];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float w = sW[(4 * ty + rr) * L + j];
            yi[rr][0] = fmaf(w, x0, yi[rr][0]);
            yi[rr][1] = fmaf(w, x1, yi[rr][1]);
          }
        }
        for (int n = 0; n < N; ++n) {
          const float h0 = sH[n * P + pc0], h1 = sH[n * P + pc1];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float cv = sC[crow[rr] * LDN + n];
            ye[rr][0] = fmaf(cv, h0, ye[rr][0]);
            ye[rr][1] = fmaf(cv, h1, ye[rr][1]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = i0 + 4 * ty + rr;
          if (i >= L) continue;
          float* out = Y + (s0 + i) * y_row;
          if (tx < P) out[tx] = yi[rr][0] + ye[rr][0] * sEc[i];
          if (p1) out[tx + 32] = yi[rr][1] + ye[rr][1] * sEc[i];
        }
      }
      __syncthreads();  // sW is rewritten by the next block of rows
    }

    // h = exp(cum_{L-1}) h + sum_j B_j^T (exp(cum_{L-1} - cum_j) dt_j x_j):
    // state rows n = ty + 8 m, columns p = tx + 32 q
    {
      float acc[MAX_N / 8][2];
#pragma unroll
      for (int m = 0; m < MAX_N / 8; ++m) acc[m][0] = acc[m][1] = 0.f;
      const int pc0 = min(tx, P - 1), pc1 = min(tx + 32, P - 1);
      for (int j = 0; j < L; ++j) {
        const float f = sF[j];
        const float x0 = f * sX[j * P + pc0], x1 = f * sX[j * P + pc1];
#pragma unroll
        for (int m = 0; m < MAX_N / 8; ++m) {
          if (ty + 8 * m < N) {
            const float bv = sB[j * LDN + ty + 8 * m];
            acc[m][0] = fmaf(bv, x0, acc[m][0]);
            acc[m][1] = fmaf(bv, x1, acc[m][1]);
          }
        }
      }
      const float decay = expf(c_last);
#pragma unroll
      for (int m = 0; m < MAX_N / 8; ++m) {
        const int n = ty + 8 * m;
        if (n >= N) continue;
        if (tx < P) sH[n * P + tx] = sH[n * P + tx] * decay + acc[m][0];
        if (tx + 32 < P)
          sH[n * P + tx + 32] = sH[n * P + tx + 32] * decay + acc[m][1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += THREADS) HO[i] = sH[i];
}

template <typename T>
cudaError_t launch(const Args& a, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L, a.N, a.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<static_cast<unsigned>(blocks), THREADS, smem,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16; dt and A are float32.
// Strides in elements, four each for x, dt, B, C (ranks, batch, sequence,
// head or group) and two for A; every inner stride is 1.  y and h_final
// are contiguous.  L is the chunk: 1..128 and divides S; N <= 128, P <= 64,
// H % G == 0.  Returns the CUDA error of the launch (0 on success).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* hout, int dtype, int R, int Bt, int S,
    int H, int P, int G, int N, int L, long long xs0, long long xs1,
    long long xs2, long long xs3, long long ds0, long long ds1,
    long long ds2, long long ds3, long long as0, long long as1,
    long long bs0, long long bs1, long long bs2, long long bs3,
    long long cs0, long long cs1, long long cs2, long long cs3,
    void* stream) {
  if (R <= 0 || Bt <= 0 || H <= 0 || S <= 0 || G <= 0 || H % G != 0 ||
      L <= 0 || L > MAX_L || S % L != 0 || N <= 0 || N > MAX_N || P <= 0 ||
      P > MAX_P)  // at most 216,064 bytes of shared memory
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(R) * Bt * H;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  Args args{x,   static_cast<const float*>(dt), static_cast<const float*>(a),
            b,   c,   static_cast<float*>(y),   static_cast<float*>(hout),
            Bt,  S,   H,   P,   G,   N,   L,
            xs0, xs1, xs2, xs3, ds0, ds1, ds2, ds3, as0, as1,
            bs0, bs1, bs2, bs3, cs0, cs1, cs2, cs3};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(args, blocks, st);
  if (dtype == 1) return launch<__nv_bfloat16>(args, blocks, st);
  return cudaErrorInvalidValue;
}
