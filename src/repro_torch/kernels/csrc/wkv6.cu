// RWKV-6 WKV, forward and backward, for Hopper (sm_90a).
//
// Replaces repro/kernels/wkv6.py::_wkv6_kernel (the Pallas TPU kernel,
// forward only, state from zero, no final state).  Per (batch, head), with
// decays w clipped to [1e-6, 1] and one decay per key channel:
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)      S_t = diag(w_t) S_{t-1} + k_t v_t^T
// r, k, w are (B, S, H, N), v and o (B, S, H, N), u (H, N) fp32, the state
// (B, H, N, N) fp32 (key index first).  N = K = V is 32 or 64.  Any S >= 1.
// Optional initial state; the final state is returned.
//
// Bound on an H100 at the rwkv6-1.6b training shape (B=4, S=4096, H=32,
// N=64, bf16): the function moves 337.6 MB forward (r, k, v, w in, o out,
// the final state) and 604.0 MB backward (r, k, v, w, do in; dr, dk, dv,
// dw out); the chunked form below needs about 13 GFLOP forward and 26
// backward, well under the bytes' time at 989 TFLOP/s, so both directions
// are bound by bytes: 0.1008 and 0.1803 ms at 3.35 TB/s.  (The
// recurrence's fp32 operations, 10.87 and 30.06 GFLOP at 67 TFLOP/s, bound
// the fp32 route: 0.1623 and 0.4487 ms.)
//
// bf16: the chunked form (entries wkv6_chunk_fwd and wkv6_chunk_bwd).  The
// sequence is cut into chunks of L = 64 steps and sub-chunks of SUB = 16;
// the ragged last chunk is padded with the neutral step w = 1 (log w = 0),
// r = k = v = 0.  Per chunk and head, with lw = log clip(w):
//   forward  wkv6_chunk_state_kernel: each chunk's own state
//              sum_j (k_j ⊙ exp(sum_{m>j} lw_m)) v_j^T and its decay tot
//            wkv6_state_pass_kernel: S_c = diag(exp(tot_c)) S_{c-1} + own_c,
//              in place: the state entering each chunk (Sp, kept for the
//              backward) and the final state; the only sequential part,
//              S / 64 steps per state element
//            wkv6_chunk_out_kernel: o = (r ⊙ exp(sum_{m<t} lw_m)) Sp + A v,
//              A the in-chunk matrix with the bonus on its diagonal
//   backward wkv6_chunk_state_kernel (reverse form):
//              D_c = sum_i (r_i ⊙ exp(sum_{m<i} lw_m))^T do_i
//            wkv6_state_pass_kernel, reverse: G_{c-1} = diag(exp(tot_c)) G_c + D_c
//              from dsT, in place: the gradient of the state leaving each
//              chunk (G_out), and the initial state's gradient
//            wkv6_chunk_dv_kernel: dv = A^T do + (k ⊙ exp(sum_{m>j} lw_m)) G_out,
//              and the chunk's du partial sum_t r_t ⊙ k_t (do_t . v_t)
//            wkv6_chunk_walk_kernel: dr, dk, dw by the chunk's own walk
//            wkv6_chunk_du_kernel: du over (b, chunk) in a fixed order, fp64.
// wkv6_chunked_grads_plain in kernels/wkv6.py is these formulas in plain
// PyTorch, held against autograd by the tests.
//
// What the design does about the bound:
//   * Work is spread over (chunk, head, b) CTAs: 8192 at the training
//     shape, where the recurrence had B H = 128 CTAs walking 4096 dependent
//     steps.  Each chunk's r, k, v, w (and do) are staged by cp.async.
//   * The decay differs per key channel, so unlike SSD's scalar decay the
//     in-chunk matrix A[t][j] = sum_k r_t k_j exp(sum_{j<m<t} lw_m) is no
//     single product of two factors whose exponents are <= 0 (the TPU
//     kernel's k ⊙ exp(-cumsum(lw)) overflows from w about 0.19).  A is
//     formed from sub-chunks (see the A section): across sub-chunks the
//     span is cut at the sub-chunks' edges (a product on the tensor cores),
//     inside one each pair keeps its own span (fp32 on the CUDA cores).
//     Every exponent is a sum of exactly the
//     steps it spans, or a product of such exponentials: never a difference
//     of cumulative sums.
//   * The products (own state, D, r Sp, A v, A^T do, k G_out and A's blocks
//     across sub-chunks) run on the tensor cores as mma.sync m16n8k16 with
//     fp32 accumulators (the function's ~40 GFLOP need ~0.04 ms at 989
//     TFLOP/s, so wgmma's rate would not show).  Operands that are inputs
//     (v, do) are exact in bf16; every other operand (the states, G_out, A,
//     the exp-scaled r and k) is
//     split into hi + lo bf16 halves and multiplied two or three times:
//     about 16 significant bits, fp32-grade.  Rounded to bf16 once, such
//     operands missed the per-element bf16 tolerance of the SSD kernels
//     (2e-2 absolute and relative) several times over.
//   * dw_t = rowsum(G_t ⊙ S_{t-1}) stays an exact dot product: the
//     reverse-cumsum identity for d log w, divided by w, cancels and then
//     grows the error by up to 1e6 at the clip.  Given S_in and G_out, each
//     (chunk, head, b) re-walks its own 64 steps: a chain 64 steps deep
//     instead of 4096, exact at every decay.  The walk also gives dr and dk
//     as exact fp32 dot products.  It takes most of the backward's time
//     (see PERF.md): it is bound by issue of the ~9 fp32 operations per
//     state element and step, not by bytes.  dr and dk could leave it for
//     tensor-core products like dv's, but dw keeps both walks (PERF.md §7).
//   * The chunk states move in fp32 (B nc H N N, 134 MB at the training
//     shape): the recurrence's 8-step checkpoints (1.07 GB) are gone.
//   * Deterministic: no atomics; every sum has a fixed order.
//
// fp32 (entries wkv6_fwd and wkv6_bwd): the recurrence itself, one step at
// a time (the tensor cores' TF32 would miss the fp32 tolerance).  One CTA
// per (b, h); every decay factor is a product of values in [1e-6, 1].
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
//   dw_t[k] = G_t[k, :] . S_{t-1}[k, :] is an exact dot product.
//   dk_t[k] = G_t[k, :] . v_t + u_k r_t[k] (do_t . v_t).
// * Backward, columns kernel: one thread per value column j holds
//   G_t[:, j] and gives dv_t[j] = G_t[:, j] . k_t + do_t[j] (r_t u k_t).
// * du is reduced over B by a third, tiny kernel from per-CTA partials.
//
// Plain C entry points, bound with ctypes; each returns the first CUDA error
// of the call (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int SEG = 8;  // steps staged per segment; backward checkpoint interval
constexpr float W_MIN = 1e-6f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16: the chunked form (mma.sync m16n8k16 with fp32 accumulators, and
// exact fp32 work on the CUDA cores where a decay differs per key channel)
// ---------------------------------------------------------------------------

namespace chunked {

using namespace tc;

constexpr int L = 64;            // chunk length
constexpr int SUB = 16;          // sub-chunk length
constexpr int NSUB = L / SUB;    // sub-chunks per chunk
constexpr int NPAIR = NSUB * (NSUB - 1) / 2;  // sub-chunk pairs I > J
constexpr int AP = L + 1;        // pitch (floats) of the L x L fp32 tile A
constexpr int CHECK = 8;         // the walk's checkpoint interval
constexpr int CHUNK_THREADS = 256;  // output and dv kernels: 8 warps; warp w has rows
                                    // 16 (w % 4) .. and half w / 4 of the columns

// pitch (floats) of an (L, N) fp32 tile: odd, so column walks and reads of
// one column from many rows are free of bank conflicts
__host__ __device__ constexpr int fpitch(int cols) { return cols + 1; }

// acc += A[m0 .. m0 + 16, 0 .. 16 kk) * B for two hi + lo operand pairs:
// hi hi + hi lo + lo hi (the lo lo term is below fp32 rounding).  B is
// stored [k][n]; A [m][k] or, with AT, [k][m].
template <int NT, bool AT>
__device__ __forceinline__ void warp_mma3(float (&acc)[NT][4], const bf16* a_hi,
                                          const bf16* a_lo, int pa, int m0, const bf16* b_hi,
                                          const bf16* b_lo, int pb, int n0, int kk) {
  warp_mma<NT, AT, true>(acc, a_hi, pa, m0, b_hi, pb, n0, 0, kk);
  warp_mma<NT, AT, true>(acc, a_hi, pa, m0, b_lo, pb, n0, 0, kk);
  warp_mma<NT, AT, true>(acc, a_lo, pa, m0, b_hi, pb, n0, 0, kk);
}

// Rows [0, L) of a (rows, N) bf16 tile whose row t starts at base + t * stride,
// into shared memory with pitch `pt` by cp.async; rows >= nv are zero-filled.
template <int N>
__device__ __forceinline__ void stage_rows(bf16* dst, int pt, const bf16* base, size_t stride,
                                           int nv) {
  constexpr int V = N / 8;
  for (int i = threadIdx.x; i < L * V; i += blockDim.x) {
    const int r = i / V, v = i % V;
    const bool ok = r < nv;
    cp_async16(dst + r * pt + v * 8, ok ? base + r * stride + v * 8 : base, ok);
  }
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// log clip(w) of step t, 0 past the sequence's end (the neutral pad w = 1)
__device__ __forceinline__ float log_decay(const bf16* sw, int pt, int t, int k, int nv) {
  return t < nv ? __logf(clip_w(bf(sw + t * pt + k))) : 0.f;
}

// ---- one (K, V) product per chunk: the forward's own state and the
// backward's D ----
//
// !REV: out = sum_j (k_j ⊙ exp(sum_{m>j} lw_m)) v_j^T, the chunk's own
//       state, and tot = sum_m lw_m (the chunk's decay);
//  REV: out = sum_i (r_i ⊙ exp(sum_{m<i} lw_m)) do_i^T.
// x = k or r, y = v or do.  Each (channel, sub-chunk) is walked by one
// thread (a chain of SUB adds); an exponent is its in-sub-chunk sum plus
// the whole sub-chunks beyond, so a sum of exactly its steps.  The scaled
// x is split into hi + lo, y is an exact input.

template <int N>
struct StateSmem {
  size_t x = 0, y = 0, w = 0, x_hi = 0, x_lo = 0, lw = 0, sub = 0, total = 0;
  __host__ __device__ constexpr StateSmem() {
    Carve c;
    x = c.take<bf16>(L * pitch(N));
    y = c.take<bf16>(L * pitch(N));
    w = c.take<bf16>(L * pitch(N));
    x_hi = c.take<bf16>(L * pitch(N));
    x_lo = c.take<bf16>(L * pitch(N));
    lw = c.take<float>(L * fpitch(N));  // the in-sub-chunk exponents
    sub = c.take<float>(NSUB * N);
    total = c.off;
  }
};

// threads of the state kernel: 8 warps tile a (64, 64) output, 4 a (32, 32)
__host__ __device__ constexpr int state_threads(int N) { return N == 64 ? 256 : 128; }

template <int N, bool REV>
__global__ void __launch_bounds__(state_threads(N))
wkv6_chunk_state_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                        const bf16* __restrict__ w, float* __restrict__ out,
                        float* __restrict__ tot, int S, int H) {
  constexpr int WM = N / 16, WN = state_threads(N) / 32 / WM, NW = N / WN, NT = NW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr StateSmem<N> o{};
  bf16* sx = reinterpret_cast<bf16*>(smem + o.x);
  bf16* sy = reinterpret_cast<bf16*>(smem + o.y);
  bf16* sw = reinterpret_cast<bf16*>(smem + o.w);
  bf16* sx_hi = reinterpret_cast<bf16*>(smem + o.x_hi);
  bf16* sx_lo = reinterpret_cast<bf16*>(smem + o.x_lo);
  float* slw = reinterpret_cast<float*>(smem + o.lw);
  float* ssub = reinterpret_cast<float*>(smem + o.sub);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t rs = static_cast<size_t>(H) * N;
  const size_t head = (static_cast<size_t>(b) * S + t0) * rs + static_cast<size_t>(h) * N;
  stage_rows<N>(sx, pitch(N), x + head, rs, nv);
  stage_rows<N>(sy, pitch(N), y + head, rs, nv);
  stage_rows<N>(sw, pitch(N), w + head, rs, nv);
  cp_async_wait_all();
  __syncthreads();
  // each (channel, sub-chunk) walks its SUB steps: the exponent from the
  // step to its sub-chunk's end (!REV) or start (REV), and the sub-chunk's sum
  for (int task = tid; task < N * NSUB; task += blockDim.x) {
    const int k = task % N, sub = task / N;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = SUB * sub + (REV ? i : SUB - 1 - i);
      slw[t * fpitch(N) + k] = acc;
      acc += log_decay(sw, pitch(N), t, k, nv);
    }
    ssub[sub * N + k] = acc;
  }
  __syncthreads();
  // x ⊙ exp(the exponent plus the whole sub-chunks after (before) it), hi + lo
  for (int i = tid; i < L * N; i += blockDim.x) {
    const int t = i / N, k = i % N, sub = t / SUB;
    float e = slw[t * fpitch(N) + k];
#pragma unroll
    for (int m = 0; m < NSUB; ++m)
      if (REV ? m < sub : m > sub) e += ssub[m * N + k];
    split(bf(sx + t * pitch(N) + k) * __expf(e), sx_hi + t * pitch(N) + k,
          sx_lo + t * pitch(N) + k);
  }
  if (!REV && tid < N) {
    float e = 0.f;
#pragma unroll
    for (int m = 0; m < NSUB; ++m) e += ssub[m * N + tid];
    tot[((static_cast<size_t>(b) * nc + c) * H + h) * N + tid] = e;
  }
  __syncthreads();
  const int m0 = 16 * (warp % WM), n0 = NW * (warp / WM);
  float acc[NT][4];
  zero(acc);
  // out[k][v] = sum_t xd[t][k] y[t][v]: A = xd^T (stored [t][k]), B = y (stored [t][v])
  warp_mma2<NT, true, true, true>(acc, sx_hi, sx_lo, pitch(N), m0, sy, nullptr, pitch(N), n0, 0,
                                  L / 16);
  float* dst = out + ((static_cast<size_t>(b) * nc + c) * H + h) * N * N;
  const int lane = tid & 31;
  const int p0 = m0 + (lane >> 2), q0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = q0 + 8 * nt;
    *reinterpret_cast<float2*>(dst + p0 * N + n) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(dst + (p0 + 8) * N + n) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- the pass over chunks, forward or reverse ----
//
// forward: buf holds each chunk's own state; on return buf[c] is the state
//   entering chunk c, and out the final state (from seed = s0, or zero).
// reverse: buf holds each chunk's D_c; on return buf[c] is the gradient of
//   the state leaving chunk c (from seed = dsT, or zero), and out (if not
//   NULL) the initial state's gradient.
// One thread per 4 elements of a (b, h) state (one key row k); exp(tot[k])
// is the row's decay over the chunk.  Loads go out DEPTH chunks at a time.
template <bool REVERSE>
__global__ void __launch_bounds__(128)
wkv6_state_pass_kernel(float* __restrict__ buf, const float* __restrict__ tot,
                       const float* __restrict__ seed, float* __restrict__ out, int nc, int H,
                       int N) {
  constexpr int DEPTH = 8;
  const int e4 = blockIdx.x * blockDim.x + threadIdx.x;
  const int NN = N * N;
  if (4 * e4 >= NN) return;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k = (4 * e4) / N;
  const size_t step = static_cast<size_t>(H) * NN / 4;  // float4s from chunk c to c + 1
  float4* base = reinterpret_cast<float4*>(buf + (static_cast<size_t>(b) * nc * H + h) * NN) + e4;
  const float* td = tot + (static_cast<size_t>(b) * nc * H + h) * N + k;
  float4 s = seed ? reinterpret_cast<const float4*>(seed + static_cast<size_t>(bh) * NN)[e4]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += DEPTH) {
    float4 v[DEPTH];
    float d[DEPTH];
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int c = REVERSE ? nc - 1 - (k0 + i) : k0 + i;
      if (k0 + i < nc) {
        v[i] = base[c * step];
        d[i] = td[static_cast<size_t>(c) * H * N];
      }
    }
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int c = REVERSE ? nc - 1 - (k0 + i) : k0 + i;
      if (k0 + i < nc) {
        base[c * step] = s;
        const float e = __expf(d[i]);
        s = make_float4(e * s.x + v[i].x, e * s.y + v[i].y, e * s.z + v[i].z, e * s.w + v[i].w);
      }
    }
  }
  if (out) reinterpret_cast<float4*>(out + static_cast<size_t>(bh) * NN)[e4] = s;
}

// ---- the in-chunk matrix A, shared by the output and dv kernels ----
//
// A[t][j] = sum_k r_t k_j exp(sum_{j<m<t} lw_m) for j < t, the bonus
// r_t . (u ⊙ k_t) on the diagonal, 0 above it, kept in fp32.  The decay
// differs per key channel, so A is no single product of two factors with
// non-positive exponents.  Sub-chunks of SUB steps fix that:
//   * across sub-chunks I > J the span is cut at the sub-chunks' edges:
//     A[t][j] = sum_k rq_t gap_JI kb_j, with rq_t = r_t exp(pe_t) (pe_t the
//     sum from t's sub-chunk start to t - 1), kb_j = k_j exp(ke_j) (ke_j the
//     sum from j + 1 to the end of j's sub-chunk) and gap_JI = exp(the
//     sub-chunks strictly between): every factor is exp of a sum <= 0.
//     Each of the 6 pairs is one warp's 16 x 16 product on the tensor
//     cores, (rq ⊙ gap) and kb split into hi + lo in registers.
//   * inside a sub-chunk each pair keeps its own span: j walks down from
//     t - 1 with a running product of exp(lw_j) per channel; 8 threads
//     split the channels of a pair of rows (t, SUB - 1 - t) and sum by
//     shuffles.

template <int N, bool DV>
struct ChunkSmem {
  size_t r = 0, k = 0, v = 0, y = 0, A = 0, lw = 0, kb = 0, rq = 0;
  size_t u = 0, sub = 0, gap = 0, side = 0, dvv = 0, total = 0;
  __host__ __device__ constexpr ChunkSmem() {
    Carve c;
    r = c.take<bf16>(L * pitch(N));  // r then k: later two bf16 hi + lo tiles
    k = c.take<bf16>(L * pitch(N));
    v = c.take<bf16>(L * pitch(N));
    y = DV ? c.take<bf16>(L * pitch(N)) : 0;  // do
    A = c.take<float>(L * AP);  // first the staged w
    lw = c.take<float>(L * fpitch(N));  // lw then kb: later the state's hi + lo tiles
    kb = c.take<float>(L * fpitch(N));
    rq = c.take<float>(L * fpitch(N));
    u = c.take<float>(N);
    sub = c.take<float>(NSUB * N);
    gap = c.take<float>(NPAIR * N);
    side = c.take<float>(NSUB * N);  // exp(pre_I), or exp(post_J) for DV
    dvv = DV ? c.take<float>(L) : 0;  // do_t . v_t
    total = c.off;
  }
};

template <int N, bool DV>
struct ChunkTiles {
  bf16 *r, *k, *v, *y;
  float *A, *lw, *kb, *rq, *u, *sub, *gap, *side, *dvv;
  __device__ explicit ChunkTiles(unsigned char* smem) {
    constexpr ChunkSmem<N, DV> o{};
    r = reinterpret_cast<bf16*>(smem + o.r);
    k = reinterpret_cast<bf16*>(smem + o.k);
    v = reinterpret_cast<bf16*>(smem + o.v);
    y = reinterpret_cast<bf16*>(smem + o.y);
    A = reinterpret_cast<float*>(smem + o.A);
    lw = reinterpret_cast<float*>(smem + o.lw);
    kb = reinterpret_cast<float*>(smem + o.kb);
    rq = reinterpret_cast<float*>(smem + o.rq);
    u = reinterpret_cast<float*>(smem + o.u);
    sub = reinterpret_cast<float*>(smem + o.sub);
    gap = reinterpret_cast<float*>(smem + o.gap);
    side = reinterpret_cast<float*>(smem + o.side);
    dvv = reinterpret_cast<float*>(smem + o.dvv);
  }
  // the two bf16 tiles that take r's and k's place once A is formed
  __device__ bf16* hi_a() const { return r; }
  __device__ bf16* lo_a() const { return k; }
  // the two bf16 tiles that take lw's and kb's place
  __device__ bf16* hi_s() const { return reinterpret_cast<bf16*>(lw); }
  __device__ bf16* lo_s() const { return reinterpret_cast<bf16*>(lw) + N * pitch(N); }
};

// Stages r, k, v (and do), w and u of the chunk, then forms A and the
// per-channel factors.  On return (after a barrier): A, rq, kb, sub (the
// sub-chunks' sums of lw) and side (exp of the sums of the sub-chunks
// before, or for DV after, each sub-chunk); lw holds exp(lw).
template <int N, bool DV>
__device__ void chunk_prologue(const ChunkTiles<N, DV>& s, const bf16* __restrict__ r,
                               const bf16* __restrict__ k, const bf16* __restrict__ v,
                               const bf16* __restrict__ w, const bf16* __restrict__ dout,
                               const float* __restrict__ u, size_t head, size_t rs, int h,
                               int nv) {
  const int tid = threadIdx.x;
  bf16* sw = reinterpret_cast<bf16*>(s.A);
  stage_rows<N>(s.r, pitch(N), r + head, rs, nv);
  stage_rows<N>(s.k, pitch(N), k + head, rs, nv);
  stage_rows<N>(s.v, pitch(N), v + head, rs, nv);
  if (DV) stage_rows<N>(s.y, pitch(N), dout + head, rs, nv);
  stage_rows<N>(sw, pitch(N), w + head, rs, nv);
  if (tid < N) s.u[tid] = u[h * N + tid];
  cp_async_wait_all();
  __syncthreads();
  // each (channel, sub-chunk) walks its SUB steps: forward for rq and the
  // sub-chunk's sum, backward for kb; lw becomes exp(lw) for the diagonal
  for (int task = tid; task < N * NSUB; task += blockDim.x) {
    const int kk = task % N, t0 = SUB * (task / N);
    float lw[SUB];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = t0 + i;
      lw[i] = log_decay(sw, pitch(N), t, kk, nv);
      s.rq[t * fpitch(N) + kk] = bf(s.r + t * pitch(N) + kk) * __expf(acc);
      s.lw[t * fpitch(N) + kk] = __expf(lw[i]);
      acc += lw[i];
    }
    s.sub[(task / N) * N + kk] = acc;
    acc = 0.f;
#pragma unroll
    for (int i = SUB - 1; i >= 0; --i) {
      const int t = t0 + i;
      s.kb[t * fpitch(N) + kk] = bf(s.k + t * pitch(N) + kk) * __expf(acc);
      acc += lw[i];
    }
  }
  __syncthreads();  // the staged w is consumed: A may be written
  if (tid < N) {
    const int kk = tid;
    for (int I = 1; I < NSUB; ++I)
      for (int J = 0; J < I; ++J) {
        float e = 0.f;
        for (int m = J + 1; m < I; ++m) e += s.sub[m * N + kk];
        s.gap[(I * (I - 1) / 2 + J) * N + kk] = __expf(e);
      }
    for (int I = 0; I < NSUB; ++I) {
      float e = 0.f;
      for (int m = 0; m < NSUB; ++m)
        if (DV ? m > I : m < I) e += s.sub[m * N + kk];
      s.side[I * N + kk] = __expf(e);
    }
  }
  __syncthreads();
  if (tid < NPAIR * 32) {  // across sub-chunks: warp pr forms pair pr's 16 x 16 block
    const int pr = tid / 32, lane = tid & 31, g = lane >> 2, c4 = lane & 3;
    int I = 1;
    while ((I + 1) * I / 2 <= pr) ++I;
    const int J = pr - I * (I - 1) / 2;
    const float* gap = s.gap + pr * N;
    const float* rq = s.rq + SUB * I * fpitch(N);
    const float* kb = s.kb + SUB * J * fpitch(N);
    float acc[2][4];
    zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t ah[4], al[4];  // (rq ⊙ gap) rows g and g + 8, hi + lo
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = k0 + 8 * half + 2 * c4;
        const float g0 = gap[col], g1 = gap[col + 1];
        const float* a0 = rq + g * fpitch(N) + col;
        const float* a1 = a0 + 8 * fpitch(N);
        split2(a0[0] * g0, a0[1] * g1, &ah[2 * half], &al[2 * half]);
        split2(a1[0] * g0, a1[1] * g1, &ah[2 * half + 1], &al[2 * half + 1]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // kb^T: column j = 8 nt + g, rows (channels) 2 c4 ..
        const float* b = kb + (8 * nt + g) * fpitch(N) + k0 + 2 * c4;
        uint32_t bh[2], bl[2];
        split2(b[0], b[1], &bh[0], &bl[0]);
        split2(b[8], b[9], &bh[1], &bl[1]);
        mma(acc[nt], ah, bh[0], bh[1]);
        mma(acc[nt], ah, bl[0], bl[1]);
        mma(acc[nt], al, bh[0], bh[1]);
      }
    }
    float* dst = s.A + (SUB * I + g) * AP + SUB * J + 2 * c4;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      dst[8 * nt] = acc[nt][0];
      dst[8 * nt + 1] = acc[nt][1];
      dst[8 * AP + 8 * nt] = acc[nt][2];
      dst[8 * AP + 8 * nt + 1] = acc[nt][3];
    }
  }
  {  // inside a sub-chunk, and the bonus.  Thread (sub-chunk, p, q) takes rows
     // p and SUB - 1 - p of the sub-chunk (SUB - 1 pairs (t, j < t) between
     // them, so every thread walks the same count) and channels q, q + 8, ..;
     // the 8 threads of a row pair sum over the channels by shuffles.
    constexpr int QN = 8, KQ = N / QN;
    const int q = tid % QN, p = (tid / QN) % (SUB / 2), j0 = SUB * (tid / (QN * SUB / 2));
#pragma unroll
    for (int row = 0; row < 2; ++row) {  // the bonus on the diagonal, 0 right of it
      const int t = row ? j0 + SUB - 1 - p : j0 + p;
      float bonus = 0.f;
#pragma unroll
      for (int i = 0; i < KQ; ++i) {
        const int kk = q + QN * i;
        bonus += bf(s.r + t * pitch(N) + kk) * s.u[kk] * bf(s.k + t * pitch(N) + kk);
      }
#pragma unroll
      for (int off = QN / 2; off > 0; off >>= 1) bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
      if (q == 0) s.A[t * AP + t] = bonus;
      for (int jj = t + 1 + q; jj < j0 + SUB; jj += QN) s.A[t * AP + jj] = 0.f;
    }
    float rt[KQ], d[KQ];  // r_t of this thread's channels; exp(sum_{j<m<t} lw_m)
    int t = j0 + p;
#pragma unroll
    for (int i = 0; i < KQ; ++i) {
      rt[i] = bf(s.r + t * pitch(N) + q + QN * i);
      d[i] = 1.f;
    }
    for (int it = 0; it < SUB - 1; ++it) {  // row p's p pairs, then row SUB - 1 - p's
      if (it == p) {
        t = j0 + SUB - 1 - p;
#pragma unroll
        for (int i = 0; i < KQ; ++i) {
          rt[i] = bf(s.r + t * pitch(N) + q + QN * i);
          d[i] = 1.f;
        }
      }
      const int j = t - 1 - (it < p ? it : it - p);  // walking down from t - 1
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KQ; ++i) {
        const int kk = q + QN * i;
        acc += rt[i] * bf(s.k + j * pitch(N) + kk) * d[i];
        d[i] *= s.lw[j * fpitch(N) + kk];
      }
#pragma unroll
      for (int off = QN / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (q == 0) s.A[t * AP + j] = acc;
    }
  }
  __syncthreads();
}

// An (L, N) fp32 tile times exp-factors per (row's sub-chunk, column) as a
// hi + lo pair of bf16 tiles [t][pitch(N)].
template <int N>
__device__ __forceinline__ void split_tile(bf16* hi, bf16* lo, const float* src,
                                           const float* factors) {
  for (int i = threadIdx.x; i < L * N; i += blockDim.x) {
    const int t = i / N, kk = i % N;
    split(src[t * fpitch(N) + kk] * factors[(t / SUB) * N + kk], hi + t * pitch(N) + kk,
          lo + t * pitch(N) + kk);
  }
}

// An (N, N) fp32 state in registers, float4 per slot, loaded when the
// kernel starts (the loads stay in flight through the prologue) and split
// into hi + lo bf16 tiles [k][pitch(N)] once those are free.
template <int N>
struct StateRegs {
  static constexpr int SLOTS = N * N / 4 / CHUNK_THREADS;
  float4 v[SLOTS];
  __device__ explicit StateRegs(const float* src) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
      v[j] = reinterpret_cast<const float4*>(src)[threadIdx.x + j * CHUNK_THREADS];
  }
  __device__ void split_into(bf16* hi, bf16* lo) const {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int e = 4 * (threadIdx.x + j * CHUNK_THREADS), k = e / N, n = e % N;
      const float f[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(f[i], hi + k * pitch(N) + n + i, lo + k * pitch(N) + n + i);
    }
  }
};

// A register A-fragment (hi + lo) of the fp32 tile A for rows m0 + g and
// m0 + g + 8 and the k16 block at k0: A itself, or with AT its transpose.
template <bool AT>
__device__ __forceinline__ void a_frag(const float* sA, int m0, int k0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  auto at = [&](int row, int col) { return AT ? sA[col * AP + row] : sA[row * AP + col]; };
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = k0 + 8 * half + 2 * c;
    split2(at(m0 + g, col), at(m0 + g, col + 1), &hi[2 * half], &lo[2 * half]);
    split2(at(m0 + g + 8, col), at(m0 + g + 8, col + 1), &hi[2 * half + 1], &lo[2 * half + 1]);
  }
}

// Writes a warp's 16 x 8 NT fp32 accumulator as bf16 rows of the output
// (rows past the sequence's end are skipped).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, size_t rs, const float (&acc)[NT][4],
                                           int m0, int n0, int nv) {
  const int lane = threadIdx.x & 31;
  const int r0 = m0 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + 8 * nt + 2 * (lane & 3);
    if (r0 < nv)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * rs + n) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r1 < nv)
      *reinterpret_cast<__nv_bfloat162*>(dst + r1 * rs + n) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}


// ---- forward: o = rdec S_in + A v ----
template <int N>
__global__ void __launch_bounds__(CHUNK_THREADS)
wkv6_chunk_out_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ Sp,
                      bf16* __restrict__ o, int S, int H) {
  constexpr int NT = N / 16;  // 8-column tiles in a warp's half of the columns
  extern __shared__ __align__(128) unsigned char smem[];
  const ChunkTiles<N, false> s(smem);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const size_t rs = static_cast<size_t>(H) * N;
  const size_t head = (static_cast<size_t>(b) * S + t0) * rs + static_cast<size_t>(h) * N;
  const StateRegs<N> s_in(Sp + ((static_cast<size_t>(b) * nc + c) * H + h) * N * N);
  chunk_prologue<N, false>(s, r, k, v, w, nullptr, u, head, rs, h, nv);
  // rdec = rq ⊙ exp(pre) and S_in, each as hi + lo
  split_tile<N>(s.hi_a(), s.lo_a(), s.rq, s.side);
  s_in.split_into(s.hi_s(), s.lo_s());
  __syncthreads();
  const int warp = threadIdx.x >> 5, I = warp & 3, n0 = (warp >> 2) * (N / 2);
  float acc[NT][4];
  zero(acc);
  warp_mma3<NT, false>(acc, s.hi_a(), s.lo_a(), pitch(N), SUB * I, s.hi_s(), s.lo_s(),
                       pitch(N), n0, N / 16);
  for (int kk = 0; kk <= I; ++kk) {  // A v over the blocks at or left of the diagonal
    uint32_t hi[4], lo[4];
    a_frag<false>(s.A, SUB * I, 16 * kk, hi, lo);
    mma_k16<NT, true>(acc, hi, s.v, pitch(N), n0, 16 * kk);
    mma_k16<NT, true>(acc, lo, s.v, pitch(N), n0, 16 * kk);
  }
  store_rows<NT>(o + head, rs, acc, SUB * I, n0, nv);
}

// ---- backward: dv = A^T do + kdec G_out, and the chunk's du partial ----
template <int N>
__global__ void __launch_bounds__(CHUNK_THREADS)
wkv6_chunk_dv_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ w,
                     const float* __restrict__ u, const bf16* __restrict__ dout,
                     const float* __restrict__ G, bf16* __restrict__ dv,
                     double* __restrict__ du_part, int S, int H) {
  constexpr int NT = N / 16;  // 8-column tiles in a warp's half of the columns
  extern __shared__ __align__(128) unsigned char smem[];
  const ChunkTiles<N, true> s(smem);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const int tid = threadIdx.x;
  const size_t rs = static_cast<size_t>(H) * N;
  const size_t head = (static_cast<size_t>(b) * S + t0) * rs + static_cast<size_t>(h) * N;
  const size_t chunk = (static_cast<size_t>(b) * nc + c) * H + h;
  const StateRegs<N> g_out(G + chunk * N * N);
  chunk_prologue<N, true>(s, r, k, v, w, dout, u, head, rs, h, nv);
  // du partial: sum_t r_t ⊙ k_t (do_t . v_t), t in order, in fp64
  if (tid < L) {
    float d = 0.f;
    for (int kk = 0; kk < N; ++kk) d += bf(s.y + tid * pitch(N) + kk) * bf(s.v + tid * pitch(N) + kk);
    s.dvv[tid] = d;
  }
  __syncthreads();
  if (tid < N) {
    double acc = 0.0;
    for (int t = 0; t < L; ++t)
      acc += static_cast<double>(bf(s.r + t * pitch(N) + tid) * bf(s.k + t * pitch(N) + tid) *
                                 s.dvv[t]);
    du_part[chunk * N + tid] = acc;
  }
  __syncthreads();  // r and k are consumed
  // kdec = kb ⊙ exp(post) as hi + lo; then G_out as hi + lo over lw and kb
  split_tile<N>(s.hi_a(), s.lo_a(), s.kb, s.side);
  __syncthreads();
  g_out.split_into(s.hi_s(), s.lo_s());
  __syncthreads();
  const int warp = tid >> 5, J = warp & 3, n0 = (warp >> 2) * (N / 2);
  float acc[NT][4];
  zero(acc);
  warp_mma3<NT, false>(acc, s.hi_a(), s.lo_a(), pitch(N), SUB * J, s.hi_s(), s.lo_s(),
                       pitch(N), n0, N / 16);
  for (int kk = J; kk < NSUB; ++kk) {  // A^T do over the blocks at or below the diagonal
    uint32_t hi[4], lo[4];
    a_frag<true>(s.A, SUB * J, 16 * kk, hi, lo);
    mma_k16<NT, true>(acc, hi, s.y, pitch(N), n0, 16 * kk);
    mma_k16<NT, true>(acc, lo, s.y, pitch(N), n0, 16 * kk);
  }
  store_rows<NT>(dv + head, rs, acc, SUB * J, n0, nv);
}

// ---- backward: dr, dk and dw by each chunk's own walk ----
//
// dw_t = rowsum(G_t ⊙ S_{t-1}) must stay an exact dot product (the
// reverse-cumsum identity for d log w, divided by w, cancels and then
// grows the error by up to 1e6 at the clip).  Each (chunk, head, b) CTA
// knows S_in and G_out, so it re-walks its own L steps exactly: a chain of
// L steps instead of S.  Thread (k, slice) holds VPT columns of key row k.
// Pass 1 walks S forward and keeps it every CHECK steps in shared memory;
// pass 2 takes the segments in reverse: S of the segment's steps from its
// checkpoint into registers, then G backward through them:
//   dr_t = S_{t-1} do_t + u ⊙ k_t (do_t . v_t)
//   dk_t = G_t v_t + u ⊙ r_t (do_t . v_t)       dw_t = rowsum(G_t ⊙ S_{t-1})
// with the sums over a row's columns by shuffles among its threads, a
// segment's 8 steps at once.

constexpr int WALK_THREADS = 512;

template <int N>
struct WalkSmem {
  size_t ck = 0, r = 0, k = 0, w = 0, v = 0, y = 0, rf = 0, kf = 0, wf = 0, u = 0, dvv = 0;
  size_t total = 0;
  __host__ __device__ constexpr WalkSmem() {
    Carve c;
    ck = c.take<float>((L / CHECK) * N * N);
    r = c.take<bf16>(L * N);  // r, k, w as loaded; later dr, dk, dw
    k = c.take<bf16>(L * N);
    w = c.take<bf16>(L * N);
    v = c.take<bf16>(L * N);
    y = c.take<bf16>(L * N);
    rf = c.take<float>(L * N);  // r, k and clip(w) in fp32; clip(w) negated where
    kf = c.take<float>(L * N);  // w is outside the clip (dw = 0 there)
    wf = c.take<float>(L * N);
    u = c.take<float>(N);
    dvv = c.take<float>(L);
    total = c.off;
  }
};

// this thread's VPT columns of row t of a bf16 tile [L][N], as fp32, read
// 16 bytes at a time
template <int VPT>
__device__ __forceinline__ void row_slice(const bf16* tile, int N, int t, int v0,
                                          float (&out)[VPT]) {
  static_assert(VPT % 2 == 0, "pairs");
#pragma unroll
  for (int i = 0; i < VPT; i += 8) {
    if (VPT - i >= 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(tile + t * N + v0 + i);
      const uint32_t parts[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&parts[j]));
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int j = i; j < VPT; j += 2) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(tile + t * N + v0 + j));
        out[j] = f.x;
        out[j + 1] = f.y;
      }
    }
  }
}

// Sums v[tt] (one partial per step of a segment) over the TPR threads of a
// row by recursive halving: 7 shuffles for the segment's 8 sums instead of
// 8 log2(TPR).  Returns the step this thread then holds the sum of in v[0],
// or -1 where another thread holds the same one.
template <int TPR>
__device__ __forceinline__ int segment_sum(float (&v)[CHECK]) {
  static_assert(CHECK == 8 && TPR >= 8, "three halvings");
  constexpr int O1 = TPR / 2, O2 = TPR / 4, O3 = TPR / 8;
  const int l = threadIdx.x % TPR;
  const bool u1 = l & O1, u2 = l & O2, u3 = l & O3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (u1 ? v[j + 4] : v[j]) + __shfl_xor_sync(0xffffffffu, u1 ? v[j] : v[j + 4], O1);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    v[j] = (u2 ? v[j + 2] : v[j]) + __shfl_xor_sync(0xffffffffu, u2 ? v[j] : v[j + 2], O2);
  v[0] = (u3 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, u3 ? v[0] : v[1], O3);
#pragma unroll
  for (int off = O3 / 2; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return (l & (O3 - 1)) ? -1 : 4 * u1 + 2 * u2 + u3;
}

template <int N>
__global__ void __launch_bounds__(WALK_THREADS, 1)
wkv6_chunk_walk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ w,
                       const float* __restrict__ u, const bf16* __restrict__ dout,
                       const float* __restrict__ Sp, const float* __restrict__ G,
                       bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dw,
                       int S, int H) {
  constexpr int TPR = WALK_THREADS / N, VPT = N / TPR, NCK = L / CHECK;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr WalkSmem<N> o{};
  float* ck = reinterpret_cast<float*>(smem + o.ck);
  bf16* sr = reinterpret_cast<bf16*>(smem + o.r);
  bf16* sk = reinterpret_cast<bf16*>(smem + o.k);
  bf16* sw = reinterpret_cast<bf16*>(smem + o.w);
  bf16* sv = reinterpret_cast<bf16*>(smem + o.v);
  bf16* sdo = reinterpret_cast<bf16*>(smem + o.y);
  bf16* odr = sr;  // the outputs take the staged r, k, w's place
  bf16* odk = sk;
  bf16* odw = sw;
  float* rf = reinterpret_cast<float*>(smem + o.rf);
  float* kf = reinterpret_cast<float*>(smem + o.kf);
  float* wf = reinterpret_cast<float*>(smem + o.wf);
  float* su = reinterpret_cast<float*>(smem + o.u);
  float* sdvv = reinterpret_cast<float*>(smem + o.dvv);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const int tid = threadIdx.x;
  const size_t rs = static_cast<size_t>(H) * N;
  const size_t head = (static_cast<size_t>(b) * S + t0) * rs + static_cast<size_t>(h) * N;
  const size_t chunk = (static_cast<size_t>(b) * nc + c) * H + h;
  stage_rows<N>(sr, N, r + head, rs, nv);
  stage_rows<N>(sk, N, k + head, rs, nv);
  stage_rows<N>(sw, N, w + head, rs, nv);
  stage_rows<N>(sv, N, v + head, rs, nv);
  stage_rows<N>(sdo, N, dout + head, rs, nv);
  if (tid < N) su[tid] = u[h * N + tid];
  const int kr = tid / TPR, v0 = (tid % TPR) * VPT;
  float st[VPT], g[VPT];  // S_in and G_out of this thread's columns, loaded while staging
  const float* sp = Sp + (chunk * N + kr) * N + v0;
  const float* gp = G + (chunk * N + kr) * N + v0;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    st[i] = sp[i];
    g[i] = gp[i];
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < L * N; i += WALK_THREADS) {
    rf[i] = bf(sr + i);
    kf[i] = bf(sk + i);
    const float wt = bf(sw + i);
    // past the sequence's end the neutral step w = 1 (and r = k = v = do = 0)
    wf[i] = i / N < nv ? (w_in_range(wt) ? clip_w(wt) : -clip_w(wt)) : 1.f;
  }
  if (tid < L) {
    float d = 0.f;
    for (int j = 0; j < N; ++j) d += bf(sdo + tid * N + j) * bf(sv + tid * N + j);
    sdvv[tid] = d;
  }
  __syncthreads();  // the staged r, k, w are consumed
  const float uk = su[kr];

  // pass 1: S forward from S_in, kept at the start of every segment
  for (int seg = 0; seg < NCK; ++seg) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) ck[(seg * N + kr) * N + v0 + i] = st[i];
    if (seg == NCK - 1) break;
#pragma unroll
    for (int tt = 0; tt < CHECK; ++tt) {
      const int t = seg * CHECK + tt;
      const float wc = fabsf(wf[t * N + kr]), kt = kf[t * N + kr];
      float vt[VPT];
      row_slice<VPT>(sv, N, t, v0, vt);
#pragma unroll
      for (int i = 0; i < VPT; ++i) st[i] = wc * st[i] + kt * vt[i];
    }
  }

  // pass 2: the segments in reverse; G backward from G_out
  for (int seg = NCK - 1; seg >= 0; --seg) {
    float hist[CHECK][VPT];  // S_{t-1} of the segment's steps
#pragma unroll
    for (int i = 0; i < VPT; ++i) st[i] = ck[(seg * N + kr) * N + v0 + i];
#pragma unroll
    for (int tt = 0; tt < CHECK; ++tt) {
      const int t = seg * CHECK + tt;
      const float wc = fabsf(wf[t * N + kr]), kt = kf[t * N + kr];
      float vt[VPT];
      row_slice<VPT>(sv, N, t, v0, vt);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        hist[tt][i] = st[i];
        st[i] = wc * st[i] + kt * vt[i];
      }
    }
    float part[CHECK];  // dr: do_t . S_{t-1}[k, :], this thread's columns
#pragma unroll
    for (int tt = 0; tt < CHECK; ++tt) {
      float dt[VPT];
      row_slice<VPT>(sdo, N, seg * CHECK + tt, v0, dt);
      part[tt] = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) part[tt] += dt[i] * hist[tt][i];
    }
    int tt = segment_sum<TPR>(part);
    if (tt >= 0) {
      const int t = seg * CHECK + tt;
      odr[t * N + kr] = __float2bfloat16(part[0] + uk * kf[t * N + kr] * sdvv[t]);
    }
    float pv[CHECK], ps[CHECK];  // dk: G_t[k, :] . v_t; dw: G_t[k, :] . S_{t-1}[k, :]
#pragma unroll
    for (int tt = CHECK - 1; tt >= 0; --tt) {
      const int t = seg * CHECK + tt;
      const float wc = fabsf(wf[t * N + kr]), rt = rf[t * N + kr];
      float vt[VPT], dt[VPT];
      row_slice<VPT>(sv, N, t, v0, vt);
      row_slice<VPT>(sdo, N, t, v0, dt);
      pv[tt] = 0.f;
      ps[tt] = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        pv[tt] += g[i] * vt[i];
        ps[tt] += g[i] * hist[tt][i];
        g[i] = wc * g[i] + rt * dt[i];
      }
    }
    tt = segment_sum<TPR>(pv);
    segment_sum<TPR>(ps);
    if (tt >= 0) {
      const int t = seg * CHECK + tt;
      const float ws = wf[t * N + kr];
      odk[t * N + kr] = __float2bfloat16(pv[0] + uk * rf[t * N + kr] * sdvv[t]);
      odw[t * N + kr] = __float2bfloat16(ws > 0.f ? ps[0] : 0.f);
    }
  }
  __syncthreads();
  constexpr int V8 = N / 8;  // 16-byte pieces of a row
  for (int i = tid; i < nv * V8; i += WALK_THREADS) {
    const int t = i / V8, p = (i % V8) * 8;
    const size_t off = head + t * rs + p;
    *reinterpret_cast<uint4*>(dr + off) = *reinterpret_cast<const uint4*>(odr + t * N + p);
    *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(odk + t * N + p);
    *reinterpret_cast<uint4*>(dw + off) = *reinterpret_cast<const uint4*>(odw + t * N + p);
  }
}

// du[h, k] = sum_b sum_c du_part[b, c, h, k], b then c in order, in fp64
__global__ void wkv6_chunk_du_kernel(const double* __restrict__ du_part, float* __restrict__ du,
                                     int B, int nc, int H, int N) {
  const int h = blockIdx.x, kk = threadIdx.x;
  double acc = 0.0;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) acc += du_part[((static_cast<size_t>(b) * nc + c) * H + h) * N + kk];
  du[h * N + kk] = static_cast<float>(acc);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define WKV_TRY(expr)                                \
  do {                                               \
    const cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <int N>
int launch_chunk_fwd(const bf16* r, const bf16* k, const bf16* v, const bf16* w,
                     const float* u, const float* s0, bf16* o, float* sT, float* Sp, float* tot,
                     int B, int S, int H, cudaStream_t st) {
  const int nc = (S + L - 1) / L;
  const dim3 grid(nc, H, B);
  constexpr size_t state_smem = StateSmem<N>().total, out_smem = ChunkSmem<N, false>().total;
  WKV_TRY(allow_smem(wkv6_chunk_state_kernel<N, false>, state_smem));
  WKV_TRY(allow_smem(wkv6_chunk_out_kernel<N>, out_smem));
  wkv6_chunk_state_kernel<N, false><<<grid, state_threads(N), state_smem, st>>>(k, v, w, Sp, tot, S, H);
  WKV_TRY(cudaGetLastError());
  wkv6_state_pass_kernel<false><<<dim3((N * N / 4 + 127) / 128, B * H), 128, 0, st>>>(
      Sp, tot, s0, sT, nc, H, N);
  WKV_TRY(cudaGetLastError());
  wkv6_chunk_out_kernel<N><<<grid, CHUNK_THREADS, out_smem, st>>>(r, k, v, w, u, Sp, o, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_chunk_bwd(const bf16* r, const bf16* k, const bf16* v, const bf16* w,
                     const float* u, const bf16* dout, const float* dsT, const float* Sp,
                     const float* tot, bf16* dr, bf16* dk, bf16* dv, bf16* dw, float* du,
                     float* ds0, float* G, double* du_part, int B, int S, int H,
                     cudaStream_t st) {
  const int nc = (S + L - 1) / L;
  const dim3 grid(nc, H, B);
  constexpr size_t state_smem = StateSmem<N>().total, dv_smem = ChunkSmem<N, true>().total;
  constexpr size_t walk_smem = WalkSmem<N>().total;
  WKV_TRY(allow_smem(wkv6_chunk_state_kernel<N, true>, state_smem));
  WKV_TRY(allow_smem(wkv6_chunk_dv_kernel<N>, dv_smem));
  WKV_TRY(allow_smem(wkv6_chunk_walk_kernel<N>, walk_smem));
  wkv6_chunk_state_kernel<N, true><<<grid, state_threads(N), state_smem, st>>>(r, dout, w, G, nullptr, S, H);
  WKV_TRY(cudaGetLastError());
  wkv6_state_pass_kernel<true><<<dim3((N * N / 4 + 127) / 128, B * H), 128, 0, st>>>(
      G, tot, dsT, ds0, nc, H, N);
  WKV_TRY(cudaGetLastError());
  wkv6_chunk_dv_kernel<N><<<grid, CHUNK_THREADS, dv_smem, st>>>(r, k, v, w, u, dout, G, dv,
                                                                 du_part, S, H);
  WKV_TRY(cudaGetLastError());
  wkv6_chunk_walk_kernel<N><<<grid, WALK_THREADS, walk_smem, st>>>(r, k, v, w, u, dout, Sp, G,
                                                                    dr, dk, dw, S, H);
  WKV_TRY(cudaGetLastError());
  wkv6_chunk_du_kernel<<<H, N, 0, st>>>(du_part, du, B, nc, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

}  // namespace

// dtype: 0 = float32 (bf16 goes through wkv6_chunk_fwd).  N (= K = V) in
// {32, 64}.  s0 may be NULL (zero initial state).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* s0, void* o, float* sT, int dtype,
                        int B, int S, int H, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && N == 32) return launch_fwd<float, 32>(r, k, v, w, u, s0, o, sT, B, S, H, st);
  if (dtype == 0 && N == 64) return launch_fwd<float, 64>(r, k, v, w, u, s0, o, sT, B, S, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32 (bf16 goes through wkv6_chunk_bwd).  dsT and s0 may
// be NULL (zero); ds0 may be NULL (not wanted).  du_part is (B, H, N) fp32
// scratch, ckpt (B*H, ceil(S/8), N, N) fp32 scratch.
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
#undef WKV6_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 only; N (= K = V) in {32, 64}; r, k, v, w 16-byte aligned.  s0 may be
// NULL (zero initial state).  Sp (B, nc, H, N, N) fp32 receives the state
// entering each chunk and tot (B, nc, H, N) fp32 each chunk's sum of
// log w, both kept for wkv6_chunk_bwd (nc = ceil(S / 64)).
extern "C" int wkv6_chunk_fwd(const void* r, const void* k, const void* v, const void* w,
                              const float* u, const float* s0, void* o, float* sT, float* Sp,
                              float* tot, int B, int S, int H, int N, void* stream) {
  using chunked::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
#define WKV6_CHUNK_FWD(NN)                                                                   \
  return chunked::launch_chunk_fwd<NN>(                                                      \
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v), \
      static_cast<const bf16*>(w), u, s0, static_cast<bf16*>(o), sT, Sp, tot, B, S, H, st)
  if (N == 32) WKV6_CHUNK_FWD(32);
  if (N == 64) WKV6_CHUNK_FWD(64);
#undef WKV6_CHUNK_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// dsT may be NULL (zero); ds0 may be NULL (not wanted).  Sp and tot are
// wkv6_chunk_fwd's; G (B, nc, H, N, N) fp32 and du_part (B, nc, H, N) fp64
// are scratch.
extern "C" int wkv6_chunk_bwd(const void* r, const void* k, const void* v, const void* w,
                              const float* u, const void* dout, const float* dsT,
                              const float* Sp, const float* tot, void* dr, void* dk, void* dv,
                              void* dw, float* du, float* ds0, float* G, double* du_part, int B,
                              int S, int H, int N, void* stream) {
  using chunked::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
#define WKV6_CHUNK_BWD(NN)                                                                    \
  return chunked::launch_chunk_bwd<NN>(                                                       \
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),  \
      static_cast<const bf16*>(w), u, static_cast<const bf16*>(dout), dsT, Sp, tot,           \
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv),                 \
      static_cast<bf16*>(dw), du, ds0, G, du_part, B, S, H, st)
  if (N == 32) WKV6_CHUNK_BWD(32);
  if (N == 64) WKV6_CHUNK_BWD(64);
#undef WKV6_CHUNK_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
