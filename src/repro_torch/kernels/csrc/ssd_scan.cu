// Mamba-2 SSD scan, forward and backward, for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU kernel,
// forward only, state from zero, no final state).  Per (batch, head), with
// one scalar decay per step and B/C shared by every head (ngroups = 1):
//   a_t = exp(dt_t A)    S_t = a_t S_{t-1} + (x_t dt_t) B_t^T    y_t = S_t C_t
// x and y are (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, Bm and Cm
// (B, S, N), the state (B, H, P, N) fp32 (the model's layout).  P is 32 or
// 64 and N is 16, 32 or 64; x, Bm, Cm and y share one dtype, fp32 or bf16.
// Any S >= 1.  Optional initial state; the final state is returned.
//
// Design.  The TPU kernel runs the chunked matmul form on the MXU.  This
// kernel runs the recurrence itself, one step at a time, so every decay is
// a factor exp(dt A) <= 1 taken once and nothing is formed before it is
// masked.  One CTA per (b, h) with 4 P threads: thread (p, q) holds the
// state row S[p, n] for the N / 4 columns n = 4 j + q in registers, so the
// readout sum over n is in-thread plus two shuffles.  Inputs of SEG steps
// are staged in shared memory and read as broadcasts.
//
// Backward.  G_t = dL/dS_t follows G_t = a_{t+1} G_{t+1} + dy_t C_t^T,
// seeded with the final state's gradient; then
//   dX̄_t = G_t B_t (sum over n)       dB_t = G_t^T X̄_t (sum over p)
//   dC_t = S_t^T dy_t (sum over p)     g_t = a_t sum_{p,n} G_t ⊙ S_{t-1}
//   dx_t = dX̄_t dt_t    d dt_t = dX̄_t . x_t + A g_t    dA = sum_{b,t} dt_t g_t
// and the initial state's gradient is a_0 G_0.  g_t is that exact dot
// product: S_{t-1} is recomputed from checkpoints written every SEG steps
// by a forward pass, one segment at a time into shared memory.  (Writing
// g through S_t - X̄_t B_t^T, or through a reverse cumulative sum, cancels
// when decays are strong.)  Sums over p cross warps: each warp reduces its
// 8 rows by recursive halving over shuffles, the per-warp rows meet in
// shared memory, and the CTA writes one fp32 partial per (b, t, h, n).
// B and C are shared by the heads, so dB and dC are then summed over H by
// a second kernel, in a fixed order; dA is summed over B in fp64 by a
// third.  No atomics: the result is deterministic.
//
// Bound on an H100 at the zamba2-2.7b training shape (B=4, S=4096, H=80,
// P=N=64, bf16): the function moves about 345 MB forward (x and y 168 MB
// each) and 520 MB backward; its chunked tensor-core form needs 64.4 GFLOP
// forward, so both directions are bound by bytes (about 0.10 and 0.16 ms).
// The recurrence does ~6 P N fp32 operations per (b, t, h) forward and
// ~16 P N backward on the non-tensor units, with only B H = 320 CTAs, so
// it sits far above that bound (see PERF.md); a chunked wgmma form is later
// work.
//
// Plain C entry points, bound with ctypes; each returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SEG = 8;  // steps staged per segment; backward checkpoint interval
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// row (b, t) of a (B, S, ...) tensor, as an element offset before the
// trailing dims
__device__ __forceinline__ size_t bt(int b, int t, int S) {
  return static_cast<size_t>(b) * S + t;
}

// Stage steps [t0, t0 + n) of x (and dy), dt, Bm (and Cm) for head h.
template <typename T, int P, int N>
__device__ __forceinline__ void stage(const T* __restrict__ x, const T* __restrict__ dy,
                                      const float* __restrict__ dt, const T* __restrict__ Bm,
                                      const T* __restrict__ Cm, float (*sx)[P],
                                      float (*sdy)[P], float* sdt, float (*sB)[N],
                                      float (*sC)[N], int b, int h, int t0, int n, int S,
                                      int H) {
  constexpr int NT = 4 * P;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * P; i += NT) {
    const int tt = i / P, c = i % P;
    const size_t off = (bt(b, t0 + tt, S) * H + h) * P + c;
    sx[tt][c] = to_f(x[off]);
    if (dy) sdy[tt][c] = to_f(dy[off]);
  }
  for (int i = tid; i < n * N; i += NT) {
    const int tt = i / N, c = i % N;
    const size_t off = bt(b, t0 + tt, S) * N + c;
    sB[tt][c] = to_f(Bm[off]);
    if (Cm) sC[tt][c] = to_f(Cm[off]);
  }
  if (tid < n) sdt[tid] = dt[bt(b, t0 + tid, S) * H + h];
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(4 * P)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s0, T* __restrict__ y,
               float* __restrict__ sT, int S, int H) {
  constexpr int NT = 4 * P, NQ = N / 4;
  __shared__ float sx[SEG][P];
  __shared__ float sy[SEG][P];
  __shared__ float sB[SEG][N];
  __shared__ float sC[SEG][N];
  __shared__ float sdt[SEG];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, p = tid >> 2, q = tid & 3;
  const float a_h = A[h];
  const size_t row = (static_cast<size_t>(bh) * P + p) * N + q;  // + 4 j
  float s[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) s[j] = s0 ? s0[row + 4 * j] : 0.f;

  for (int t0 = 0; t0 < S; t0 += SEG) {
    const int n = min(SEG, S - t0);
    __syncthreads();  // the previous segment's staged inputs are consumed
    stage<T, P, N>(x, nullptr, dt, Bm, Cm, sx, nullptr, sdt, sB, sC, b, h, t0, n, S, H);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float d = sdt[tt];
      const float a = expf(d * a_h), xb = sx[tt][p] * d;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        s[j] = a * s[j] + xb * sB[tt][4 * j + q];
        acc += s[j] * sC[tt][4 * j + q];
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      acc += __shfl_xor_sync(FULL, acc, 2);
      if (q == 0) sy[tt][p] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n * P; i += NT) {
      const int tt = i / P, c = i % P;
      y[(bt(b, t0 + tt, S) * H + h) * P + c] = from_f<T>(sy[tt][c]);
    }
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) sT[row + 4 * j] = s[j];
}

// in[M] -> out[M / 2]: this lane keeps one half (the upper one when `hi`),
// adds its partner's copy of that half and sends the other.
template <int M, int OFF>
__device__ __forceinline__ void halve(const float* in, float* out, bool hi) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float send = hi ? in[i] : in[i + M / 2];
    const float keep = hi ? in[i + M / 2] : in[i];
    out[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// v[j] is this lane's value for column n = 4 j + q.  Sums each column over
// the warp's 8 rows p (lane bits 2-4) by recursive halving and writes every
// column's sum exactly once to out[n].
template <int NQ>
__device__ __forceinline__ void warp_sum_rows(const float (&v)[NQ], float* out, int lane) {
  const int q = lane & 3;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a[NQ / 2], c[NQ / 4];
  halve<NQ, 16>(v, a, b4);
  halve<NQ / 2, 8>(a, c, b3);
  int jb = (b4 ? NQ / 2 : 0) + (b3 ? NQ / 4 : 0);
  if constexpr (NQ >= 8) {
    float e[NQ / 8];
    halve<NQ / 4, 4>(c, e, b2);
    jb += b2 ? NQ / 8 : 0;
#pragma unroll
    for (int i = 0; i < NQ / 8; ++i) out[4 * (jb + i) + q] = e[i];
  } else {
    const float e = c[0] + __shfl_xor_sync(FULL, c[0], 4);
    if (!b2) out[4 * jb + q] = e;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(4 * P)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s0,
               const T* __restrict__ dy, const float* __restrict__ dsT, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dB_part,
               float* __restrict__ dC_part, double* __restrict__ dA_part,
               float* __restrict__ ds0, float* __restrict__ ckpt, int S, int H) {
  constexpr int NT = 4 * P, NW = NT / 32, NQ = N / 4;
  constexpr int PITCH = N + 4;  // padded rows: a warp's 8 rows x 4 columns hit 32 banks
  extern __shared__ float hist[];  // [SEG][P][PITCH]: S_{t-1} of the segment's steps
  __shared__ float sx[SEG][P];
  __shared__ float sdy[SEG][P];
  __shared__ float sB[SEG][N];
  __shared__ float sC[SEG][N];
  __shared__ float sdt[SEG];
  __shared__ float pB[SEG][NW][N];  // per-warp sums over p
  __shared__ float pC[SEG][NW][N];
  __shared__ float pg[SEG][NW];
  __shared__ float pd[SEG][NW];
  __shared__ float sgd[SEG];  // dt_t g_t
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, p = tid >> 2, q = tid & 3;
  const int lane = tid & 31, warp = tid >> 5;
  const float a_h = A[h];
  const int nseg = (S + SEG - 1) / SEG;
  const size_t row = (static_cast<size_t>(bh) * P + p) * N + q;  // + 4 j
  float* ck = ckpt + static_cast<size_t>(bh) * nseg * P * N + static_cast<size_t>(p) * N + q;

  // pass 1: forward in time; checkpoint S at the start of every segment
  float s[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) s[j] = s0 ? s0[row + 4 * j] : 0.f;
  for (int seg = 0; seg < nseg; ++seg) {
    const int t0 = seg * SEG, n = min(SEG, S - t0);
#pragma unroll
    for (int j = 0; j < NQ; ++j) ck[static_cast<size_t>(seg) * P * N + 4 * j] = s[j];
    __syncthreads();
    stage<T, P, N>(x, nullptr, dt, Bm, nullptr, sx, nullptr, sdt, sB, nullptr, b, h, t0, n,
                   S, H);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float d = sdt[tt];
      const float a = expf(d * a_h), xb = sx[tt][p] * d;
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[j] = a * s[j] + xb * sB[tt][4 * j + q];
    }
  }

  // pass 2: backward in time, G[p, 4 j + q] in registers
  float g[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) g[j] = dsT ? dsT[row + 4 * j] : 0.f;
  float* my_hist = hist + p * PITCH + q;
  double dA_acc = 0.0;
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * SEG, n = min(SEG, S - t0);
    __syncthreads();  // the previous segment's shared buffers are consumed
    stage<T, P, N>(x, dy, dt, Bm, Cm, sx, sdy, sdt, sB, sC, b, h, t0, n, S, H);
    __syncthreads();
    // S_{t-1} of each step of the segment, from its checkpoint (each thread
    // reads back only what it wrote: no barrier needed)
#pragma unroll
    for (int j = 0; j < NQ; ++j) s[j] = ck[static_cast<size_t>(seg) * P * N + 4 * j];
    for (int tt = 0; tt < n; ++tt) {
      const float d = sdt[tt];
      const float a = expf(d * a_h), xb = sx[tt][p] * d;
      float* hrow = my_hist + tt * P * PITCH;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        hrow[4 * j] = s[j];
        s[j] = a * s[j] + xb * sB[tt][4 * j + q];
      }
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      const float d = sdt[tt];
      const float a = expf(d * a_h), xt = sx[tt][p], xb = xt * d, dyp = sdy[tt][p];
      const float* hrow = my_hist + tt * P * PITCH;
      float gs = 0.f, dxb = 0.f, vb[NQ], vc[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float bn = sB[tt][4 * j + q], cn = sC[tt][4 * j + q], sp = hrow[4 * j];
        g[j] += dyp * cn;  // G_t
        gs += g[j] * sp;
        dxb += g[j] * bn;
        vb[j] = g[j] * xb;
        vc[j] = dyp * (a * sp + xb * bn);  // dy_t[p] S_t[p, n]
        g[j] *= a;  // a_t G_t: G_{t-1} before dy_{t-1} C_{t-1}
      }
      dxb += __shfl_xor_sync(FULL, dxb, 1);
      dxb += __shfl_xor_sync(FULL, dxb, 2);
      if (q == 0) dx[(bt(b, t0 + tt, S) * H + h) * P + p] = from_f<T>(dxb * d);
      const float dd = warp_sum(q == 0 ? dxb * xt : 0.f);
      gs = warp_sum(gs);
      if (lane == 0) {
        pg[tt][warp] = gs;
        pd[tt][warp] = dd;
      }
      warp_sum_rows<NQ>(vb, pB[tt][warp], lane);
      warp_sum_rows<NQ>(vc, pC[tt][warp], lane);
    }
    __syncthreads();
    for (int i = tid; i < n * N; i += NT) {
      const int tt = i / N, c = i % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        sb += pB[tt][w][c];
        sc += pC[tt][w][c];
      }
      const size_t off = (bt(b, t0 + tt, S) * H + h) * N + c;
      dB_part[off] = sb;
      dC_part[off] = sc;
    }
    if (tid < n) {
      const int tt = tid;
      float gsum = 0.f, dsum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        gsum += pg[tt][w];
        dsum += pd[tt][w];
      }
      const float d = sdt[tt];
      const float gt = expf(d * a_h) * gsum;
      ddt[bt(b, t0 + tt, S) * H + h] = dsum + a_h * gt;
      sgd[tt] = d * gt;
    }
    __syncthreads();
    if (tid == 0)
      for (int tt = 0; tt < n; ++tt) dA_acc += static_cast<double>(sgd[tt]);
  }
  if (tid == 0) dA_part[bh] = dA_acc;
  if (ds0) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) ds0[row + 4 * j] = g[j];
  }
}

// dB[b, t, n] = sum_h dB_part[b, t, h, n] (and dC), h in order
template <typename T>
__global__ void ssd_bc_reduce_kernel(const float* __restrict__ dB_part,
                                     const float* __restrict__ dC_part, T* __restrict__ dB,
                                     T* __restrict__ dC, int H, int N) {
  const size_t r = blockIdx.x;
  const int n = threadIdx.x;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dB_part[(r * H + h) * N + n];
    sc += dC_part[(r * H + h) * N + n];
  }
  dB[r * N + n] = from_f<T>(sb);
  dC[r * N + n] = from_f<T>(sc);
}

// dA[h] = sum_b dA_part[b, h], b in order, in fp64
__global__ void ssd_dA_reduce_kernel(const double* __restrict__ dA_part, float* __restrict__ dA,
                                     int B, int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    double acc = 0.0;
    for (int b = 0; b < B; ++b) acc += dA_part[b * H + h];
    dA[h] = static_cast<float>(acc);
  }
}

template <typename T, int P, int N>
int launch_fwd(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
               const float* s0, void* y, float* sT, int B, int S, int H, cudaStream_t st) {
  ssd_fwd_kernel<T, P, N><<<B * H, 4 * P, 0, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      s0, static_cast<T*>(y), sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, int N>
int launch_bwd(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
               const float* s0, const void* dy, const float* dsT, void* dx, float* ddt,
               float* dA, void* dB, void* dC, float* ds0, float* dB_part, float* dC_part,
               double* dA_part, float* ckpt, int B, int S, int H, cudaStream_t st) {
  const int smem = SEG * P * (N + 4) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_kernel<T, P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_kernel<T, P, N><<<B * H, 4 * P, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      s0, static_cast<const T*>(dy), dsT, static_cast<T*>(dx), ddt, dB_part, dC_part, dA_part,
      ds0, ckpt, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bc_reduce_kernel<T><<<B * S, N, 0, st>>>(dB_part, dC_part, static_cast<T*>(dB),
                                               static_cast<T*>(dC), H, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_dA_reduce_kernel<<<1, 128, 0, st>>>(dA_part, dA, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SSD_DISPATCH(CALL)                                       \
  do {                                                           \
    if (dtype == 0) {                                            \
      if (P == 32 && N == 16) return CALL(float, 32, 16);        \
      if (P == 32 && N == 32) return CALL(float, 32, 32);        \
      if (P == 32 && N == 64) return CALL(float, 32, 64);        \
      if (P == 64 && N == 16) return CALL(float, 64, 16);        \
      if (P == 64 && N == 32) return CALL(float, 64, 32);        \
      if (P == 64 && N == 64) return CALL(float, 64, 64);        \
    } else if (dtype == 1) {                                     \
      if (P == 32 && N == 16) return CALL(__nv_bfloat16, 32, 16); \
      if (P == 32 && N == 32) return CALL(__nv_bfloat16, 32, 32); \
      if (P == 32 && N == 64) return CALL(__nv_bfloat16, 32, 64); \
      if (P == 64 && N == 16) return CALL(__nv_bfloat16, 64, 16); \
      if (P == 64 && N == 32) return CALL(__nv_bfloat16, 64, 32); \
      if (P == 64 && N == 64) return CALL(__nv_bfloat16, 64, 64); \
    }                                                            \
  } while (0)

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, y).  P in {32, 64}, N in
// {16, 32, 64}.  s0 may be NULL (zero initial state).
extern "C" int ssd_fwd(const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* s0, void* y, float* sT, int dtype, int B,
                       int S, int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_FWD(T, PP, NN) launch_fwd<T, PP, NN>(x, dt, A, Bm, Cm, s0, y, sT, B, S, H, st)
  SSD_DISPATCH(SSD_FWD);
#undef SSD_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// dsT and s0 may be NULL (zero); ds0 may be NULL (not wanted).  Scratch:
// dB_part and dC_part (B, S, H, N) fp32, dA_part (B, H) fp64, ckpt
// (B * H, ceil(S / 8), P, N) fp32.  dB, dC in x's dtype; ddt, dA fp32.
extern "C" int ssd_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* s0, const void* dy, const float* dsT,
                       void* dx, float* ddt, float* dA, void* dB, void* dC, float* ds0,
                       float* dB_part, float* dC_part, double* dA_part, float* ckpt,
                       int dtype, int B, int S, int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_BWD(T, PP, NN)                                                                    \
  launch_bwd<T, PP, NN>(x, dt, A, Bm, Cm, s0, dy, dsT, dx, ddt, dA, dB, dC, ds0, dB_part,    \
                        dC_part, dA_part, ckpt, B, S, H, st)
  SSD_DISPATCH(SSD_BWD);
#undef SSD_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
