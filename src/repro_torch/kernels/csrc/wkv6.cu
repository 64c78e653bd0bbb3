// RWKV-6 WKV recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces repro/kernels/wkv6.py::_wkv6_kernel (the Pallas TPU kernel).
// Per (batch, head), with decays w in (0, 1) clipped to [1e-6, 1]:
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)      S_t = diag(w_t) S_{t-1} + k_t v_t^T
// r, k, w are (B, S, H, N), v and o (B, S, H, N), u (H, N) fp32, the state
// (B, H, N, N) fp32 (key index first).  N = K = V is 32 or 64.
//
// Design.  The TPU kernel runs the chunked matmul form, which multiplies
// k by exp(-cumsum(log w)) and overflows fp32 once the decays are strong.
// This kernel runs the recurrence itself, one step at a time, so every
// decay factor is a product of values in [1e-6, 1] and nothing can
// overflow at any decay.  One CTA per (b, h); the grid is B*H CTAs.
//
// * Forward: one thread per value column j holds S[:, j] (N fp32
//   registers).  r, k, w, v of SEG steps are staged in shared memory; each
//   step reads them as broadcasts.
// * Backward, rows kernel: one thread per key row k.  Pass 1 runs forward
//   in time holding S[k, :] and gives dr_t[k] = do_t . S_{t-1}[k, :] +
//   u_k k_t[k] (do_t . v_t) and this CTA's du partial, and writes S at the
//   start of every SEG-step segment to a checkpoint buffer.  Pass 2 runs
//   backward in time holding G_t[k, :] = dL/dS_t[k, :], with
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T.  For each segment it recomputes
//   S_{t-1}[k, :] from the segment's checkpoint into shared memory, so
//   dw_t[k] = G_t[k, :] . S_{t-1}[k, :] is an exact dot product.  (The
//   cheaper reverse-cumsum identity for d log w subtracts two sums that
//   nearly cancel when w is small; its error over w grows without bound.)
//   dk_t[k] = G_t[k, :] . v_t + u_k r_t[k] (do_t . v_t).
// * Backward, columns kernel: one thread per value column j holds
//   G_t[:, j] and gives dv_t[j] = G_t[:, j] . k_t + do_t[j] (r_t u k_t).
// * du is reduced over B by a third, tiny kernel from per-CTA partials:
//   deterministic, no atomics.
//
// Bound on an H100: the recurrence does ~5 N^2 fp32 operations per
// (b, t, h) forward (readout 2, decay and outer product 3) and ~14 N^2
// backward (state recompute 3, dr 2, G update 3, dk 2, dv 2, dw 2) on the
// non-tensor fp32 units (67 TFLOP/s), against 2 bytes per bf16 element
// moved (3.35 TB/s).  At the rwkv6-1.6b training shape (B=4, S=4096,
// H=32, N=64) both directions are bound by operations; the sequential
// form keeps only B*H = 128 CTAs of N threads in flight, so it sits well
// above the bound (see PERF.md).  A chunked tensor-core form is a later PR.
//
// Plain C entry points, bound with ctypes; each returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SEG = 8;  // steps staged per segment; backward checkpoint interval
constexpr float W_MIN = 1e-6f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float clip_w(float w) { return fminf(fmaxf(w, W_MIN), 1.0f); }

// d clip(w) / dw: 1 inside [W_MIN, 1] (bounds included, as torch.clamp), else 0
__device__ __forceinline__ bool w_in_range(float w) { return w >= W_MIN && w <= 1.0f; }

__device__ __forceinline__ size_t at(int b, int t, int h, int S, int H, int N) {
  return ((static_cast<size_t>(b) * S + t) * H + h) * N;
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT,
                int S, int H) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  __shared__ __align__(16) float sr[SEG][N];
  __shared__ __align__(16) float sk[SEG][N];
  __shared__ __align__(16) float sw[SEG][N];
  __shared__ float sv[SEG][N];
  __shared__ float su[N];
  __shared__ float bonus[SEG];
  su[j] = u[h * N + j];
  float s[N];
  const float* s0p = s0 ? s0 + static_cast<size_t>(bh) * N * N : nullptr;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s0p ? s0p[i * N + j] : 0.f;

  for (int t0 = 0; t0 < S; t0 += SEG) {
    const int n = min(SEG, S - t0);
    __syncthreads();  // the previous segment's reads are done
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = at(b, t0 + tt, h, S, H, N) + j;
      sr[tt][j] = to_f(r[off]);
      sk[tt][j] = to_f(k[off]);
      sw[tt][j] = clip_w(to_f(w[off]));
      sv[tt][j] = to_f(v[off]);
    }
    __syncthreads();
    if (j < n) {  // bonus_t = sum_i r_t[i] u[i] k_t[i], one step per thread
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) acc += sr[j][i] * su[i] * sk[j][i];
      bonus[j] = acc;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc = bonus[tt] * vj;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&sw[tt][i]);
        acc += rr.x * s[i] + rr.y * s[i + 1] + rr.z * s[i + 2] + rr.w * s[i + 3];
        s[i] = ww.x * s[i] + kk.x * vj;
        s[i + 1] = ww.y * s[i + 1] + kk.y * vj;
        s[i + 2] = ww.z * s[i + 2] + kk.z * vj;
        s[i + 3] = ww.w * s[i + 3] + kk.w * vj;
      }
      o[at(b, t0 + tt, h, S, H, N) + j] = from_f<T>(acc);
    }
  }
  float* sTp = sT + static_cast<size_t>(bh) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) sTp[i * N + j] = s[i];
}

// Stage v and do of steps [t0, t0 + n) (thread c loads column c) and the
// per-step dot products do_t . v_t.
template <typename T, int N>
__device__ __forceinline__ void stage_v_do(const T* __restrict__ v, const T* __restrict__ dout,
                                           float (*sv)[N], float (*sdo)[N], float* sdot,
                                           int b, int h, int t0, int n, int S, int H) {
  const int c = threadIdx.x;
  __syncthreads();
  for (int tt = 0; tt < n; ++tt) {
    const size_t off = at(b, t0 + tt, h, S, H, N) + c;
    sv[tt][c] = to_f(v[off]);
    sdo[tt][c] = to_f(dout[off]);
  }
  __syncthreads();
  if (c < n) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc += sdo[c][i] * sv[c][i];
    sdot[c] = acc;
  }
  __syncthreads();
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_rows_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ w, const float* __restrict__ u,
                     const float* __restrict__ s0, const T* __restrict__ dout,
                     const float* __restrict__ dsT, T* __restrict__ dr, T* __restrict__ dk,
                     T* __restrict__ dw, float* __restrict__ du_part, float* __restrict__ ds0,
                     float* __restrict__ ckpt, int S, int H) {
  constexpr int PITCH = N + 1;  // padded rows: thread kk's row in its own banks
  extern __shared__ float hist[];  // [SEG][N][PITCH]: S_{t-1}[kk, :] of a segment
  __shared__ float sv[SEG][N];
  __shared__ float sdo[SEG][N];
  __shared__ float sdot[SEG];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kk = threadIdx.x;
  const int nseg = (S + SEG - 1) / SEG;
  const float uk = u[h * N + kk];
  float* ck = ckpt + static_cast<size_t>(bh) * nseg * N * N;

  // pass 1: forward in time, S[kk, :] in registers
  float srow[N];
  const float* s0p = s0 ? s0 + (static_cast<size_t>(bh) * N + kk) * N : nullptr;
#pragma unroll
  for (int j = 0; j < N; ++j) srow[j] = s0p ? s0p[j] : 0.f;
  // du sums B*S terms that largely cancel; fp64 keeps the sum's rounding
  // error far below the terms' scale (one add per step).
  double du_acc = 0.0;
  for (int seg = 0; seg < nseg; ++seg) {
    const int t0 = seg * SEG, n = min(SEG, S - t0);
    float4* cp = reinterpret_cast<float4*>(ck + (static_cast<size_t>(seg) * N + kk) * N);
#pragma unroll
    for (int j = 0; j < N; j += 4)
      cp[j / 4] = make_float4(srow[j], srow[j + 1], srow[j + 2], srow[j + 3]);
    stage_v_do<T, N>(v, dout, sv, sdo, sdot, b, h, t0, n, S, H);
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = at(b, t0 + tt, h, S, H, N) + kk;
      const float rt = to_f(r[off]), kt = to_f(k[off]), wc = clip_w(to_f(w[off]));
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) a += sdo[tt][j] * srow[j];
      dr[off] = from_f<T>(a + uk * kt * sdot[tt]);
      du_acc += static_cast<double>(rt * kt * sdot[tt]);
#pragma unroll
      for (int j = 0; j < N; ++j) srow[j] = wc * srow[j] + kt * sv[tt][j];
    }
  }
  du_part[static_cast<size_t>(bh) * N + kk] = static_cast<float>(du_acc);

  // pass 2: backward in time, G[kk, :] in registers
  float grow[N];
  const float* dsTp = dsT ? dsT + (static_cast<size_t>(bh) * N + kk) * N : nullptr;
#pragma unroll
  for (int j = 0; j < N; ++j) grow[j] = dsTp ? dsTp[j] : 0.f;
  float* my_hist = hist + kk * PITCH;
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * SEG, n = min(SEG, S - t0);
    stage_v_do<T, N>(v, dout, sv, sdo, sdot, b, h, t0, n, S, H);
    // recompute S_{t-1}[kk, :] for the segment's steps from its checkpoint
    const float4* cp = reinterpret_cast<const float4*>(ck + (static_cast<size_t>(seg) * N + kk) * N);
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 c4 = cp[j / 4];
      srow[j] = c4.x; srow[j + 1] = c4.y; srow[j + 2] = c4.z; srow[j + 3] = c4.w;
    }
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = at(b, t0 + tt, h, S, H, N) + kk;
      const float kt = to_f(k[off]), wc = clip_w(to_f(w[off]));
      float* row = my_hist + tt * N * PITCH;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        row[j] = srow[j];
        srow[j] = wc * srow[j] + kt * sv[tt][j];
      }
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      const size_t off = at(b, t0 + tt, h, S, H, N) + kk;
      const float rt = to_f(r[off]), wt = to_f(w[off]);
      const float wc = clip_w(wt);
      const float* row = my_hist + tt * N * PITCH;
      float gv = 0.f, gs = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        gv += grow[j] * sv[tt][j];
        gs += grow[j] * row[j];
      }
      dk[off] = from_f<T>(gv + uk * rt * sdot[tt]);
      dw[off] = from_f<T>(w_in_range(wt) ? gs : 0.f);
#pragma unroll
      for (int j = 0; j < N; ++j) grow[j] = wc * grow[j] + rt * sdo[tt][j];
    }
  }
  if (ds0) {
    float* dp = ds0 + (static_cast<size_t>(bh) * N + kk) * N;
#pragma unroll
    for (int j = 0; j < N; ++j) dp[j] = grow[j];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_cols_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ w,
                     const float* __restrict__ u, const T* __restrict__ dout,
                     const float* __restrict__ dsT, T* __restrict__ dv, int S, int H) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  __shared__ __align__(16) float sr[SEG][N];
  __shared__ __align__(16) float sk[SEG][N];
  __shared__ __align__(16) float sw[SEG][N];
  __shared__ float su[N];
  __shared__ float bonus[SEG];
  su[j] = u[h * N + j];
  float g[N];  // G_t[:, j]
  const float* dsTp = dsT ? dsT + static_cast<size_t>(bh) * N * N : nullptr;
#pragma unroll
  for (int i = 0; i < N; ++i) g[i] = dsTp ? dsTp[i * N + j] : 0.f;
  const int nseg = (S + SEG - 1) / SEG;
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * SEG, n = min(SEG, S - t0);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = at(b, t0 + tt, h, S, H, N) + j;
      sr[tt][j] = to_f(r[off]);
      sk[tt][j] = to_f(k[off]);
      sw[tt][j] = clip_w(to_f(w[off]));
    }
    __syncthreads();
    if (j < n) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) acc += sr[j][i] * su[i] * sk[j][i];
      bonus[j] = acc;
    }
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt) {
      const size_t off = at(b, t0 + tt, h, S, H, N) + j;
      const float doj = to_f(dout[off]);
      float acc = doj * bonus[tt];
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&sw[tt][i]);
        acc += g[i] * kk.x + g[i + 1] * kk.y + g[i + 2] * kk.z + g[i + 3] * kk.w;
        g[i] = ww.x * g[i] + rr.x * doj;
        g[i + 1] = ww.y * g[i + 1] + rr.y * doj;
        g[i + 2] = ww.z * g[i + 2] + rr.z * doj;
        g[i + 3] = ww.w * g[i + 3] + rr.w * doj;
      }
      dv[off] = from_f<T>(acc);
    }
  }
}

// du[h, k] = sum_b du_part[b, h, k], in a fixed order
__global__ void wkv6_du_reduce_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                      int B, int H, int N) {
  const int h = blockIdx.x, kk = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(static_cast<size_t>(b) * H + h) * N + kk];
  du[h * N + kk] = acc;
}

template <typename T, int N>
int launch_fwd(const void* r, const void* k, const void* v, const void* w, const float* u,
               const float* s0, void* o, float* sT, int B, int S, int H, cudaStream_t st) {
  wkv6_fwd_kernel<T, N><<<B * H, N, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s0, static_cast<T*>(o), sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_bwd(const void* r, const void* k, const void* v, const void* w, const float* u,
               const float* s0, const void* dout, const float* dsT, void* dr, void* dk,
               void* dv, void* dw, float* du, float* ds0, float* du_part, float* ckpt,
               int B, int S, int H, cudaStream_t st) {
  const int smem = SEG * N * (N + 1) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_rows_kernel<T, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_rows_kernel<T, N><<<B * H, N, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s0, static_cast<const T*>(dout), dsT,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dw), du_part, ds0, ckpt, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_cols_kernel<T, N><<<B * H, N, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(w), u,
      static_cast<const T*>(dout), dsT, static_cast<T*>(dv), S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_du_reduce_kernel<<<H, N, 0, st>>>(du_part, du, B, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  N (= K = V) in {32, 64}.  s0 may be
// NULL (zero initial state).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* s0, void* o, float* sT, int dtype,
                        int B, int S, int H, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && N == 32) return launch_fwd<float, 32>(r, k, v, w, u, s0, o, sT, B, S, H, st);
  if (dtype == 0 && N == 64) return launch_fwd<float, 64>(r, k, v, w, u, s0, o, sT, B, S, H, st);
  if (dtype == 1 && N == 32)
    return launch_fwd<__nv_bfloat16, 32>(r, k, v, w, u, s0, o, sT, B, S, H, st);
  if (dtype == 1 && N == 64)
    return launch_fwd<__nv_bfloat16, 64>(r, k, v, w, u, s0, o, sT, B, S, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dsT and s0 may be NULL (zero); ds0 may be NULL (not wanted).  du_part is
// (B, H, N) fp32 scratch, ckpt (B*H, ceil(S/8), N, N) fp32 scratch.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* s0, const void* dout, const float* dsT,
                        void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
                        float* du_part, float* ckpt, int dtype, int B, int S, int H, int N,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define WKV6_BWD(T, NN)                                                                      \
  return launch_bwd<T, NN>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, \
                           ckpt, B, S, H, st)
  if (dtype == 0 && N == 32) WKV6_BWD(float, 32);
  if (dtype == 0 && N == 64) WKV6_BWD(float, 64);
  if (dtype == 1 && N == 32) WKV6_BWD(__nv_bfloat16, 32);
  if (dtype == 1 && N == 64) WKV6_BWD(__nv_bfloat16, 64);
#undef WKV6_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
