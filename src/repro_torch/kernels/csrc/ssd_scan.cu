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
// Bound on an H100 at the zamba2-2.7b training shape (B=4, S=4096, H=80,
// P=N=64, bf16): the function moves about 350 MB forward (x and y 168 MB
// each) and 520 MB backward; its chunked tensor-core form needs 64 GFLOP
// forward, so both directions are bound by bytes (about 0.10 and 0.16 ms).
//
// bf16: the chunked form on tensor cores (entries ssd_chunk_fwd and
// ssd_chunk_bwd).  The sequence is cut into chunks of L = 64 steps (the
// ragged last chunk is zero-filled: dt = 0 steps leave the state alone).
// Per chunk and head, with span sums seg_ij = sum_{j<m<=i} dA_m, cum_i =
// sum_{m<=i}, rev_l = sum_{m>l}, tot = the chunk's sum, and E = exp(seg)
// masked to 0 above the diagonal:
//   forward  ssd_chunk_state_kernel: each chunk's own state
//              sum_l exp(rev_l) dt_l x_l B_l^T
//            ssd_state_pass_kernel: S_c = exp(tot_c) S_{c-1} + own_c, in
//              place: the state entering each chunk (Sp, kept for the
//              backward) and the final state; the only sequential part,
//              S / 64 steps per state element
//            ssd_chunk_out_kernel: y = exp(cum) ⊙ (C Sp^T) + (C B^T ⊙ E ⊙ dt_j) x
//   backward ssd_chunk_dstate_kernel: D_c = sum_i dy_i^T exp(cum_i) C_i
//            ssd_state_pass_kernel, reverse: G_{c-1} = exp(tot_c) G_c + D_c
//              from dsT, in place: the gradient of the state leaving each
//              chunk, and the initial state's gradient
//            ssd_chunk_bwd_kernel: dCB = (dy x^T) ⊙ dt_j ⊙ E; with W = C B^T ⊙ E,
//              dX̄ = W^T dy + exp(rev) (B G^T); dC = dCB B + exp(cum) (dy Sp);
//              dB = dCB^T C + exp(rev) dt (x G); the decay gradient
//              g_m = sum_{i>=m>j} dCB_ij CB_ij + sum_{i>=m} r_i + sum_{l<m} u_l + e
//              (r_i = C_i . exp(cum_i) (dy Sp)_i, u_l = dt_l x_l . exp(rev_l) (G B_l),
//              e = exp(tot) <G, Sp>); ddt = dX̄ . x + A g; dx = dX̄ dt
//            ssd_chunk_bc_sum_kernel, ssd_chunk_dA_sum_kernel: dB and dC over
//              the head groups, dA over (b, chunk), in a fixed order.
// ssd_chunked_grads_plain in kernels/ssd_scan.py is the backward's formulas
// in plain PyTorch, held against autograd by the tests.
//
// What the design does about the bound:
//   * Work is spread over (chunk, group of HG = 16 heads, b) CTAs of 4 warps:
//     1280 at the training shape, where the recurrence had B H = 320 CTAs
//     walking 4096 dependent steps.  B and C are loaded once per CTA for
//     its 16 heads; each head's x, dy and dt (and, forward, its Sp) are
//     loaded by cp.async while the previous head computes.
//   * Every product runs on the tensor cores with fp32 accumulators, as
//     mma.sync m16n8k16 with ldmatrix(.trans), not wgmma: each product's
//     result is reshaped elementwise (masks, span-sum exponents, dt) before
//     it becomes an operand of the next product in the other orientation,
//     and ldmatrix reads either orientation of one padded tile; the
//     function needs ~0.07 ms of tensor time at 989 TFLOP/s against ~0.5 ms
//     of bytes, so wgmma's higher rate would not show.  Warp w owns rows
//     16 w .. 16 w + 15 of every L-row tile; blocks wholly above the
//     diagonal are skipped.
//   * Operands that are inputs (x, dy, Bm, Cm) are exact in bf16.  Every
//     other operand (Sp, G, C B^T ⊙ E ⊙ dt, dCB, W, exp-scaled B and C) is
//     split into hi + lo bf16 halves and multiplied twice: about 16
//     significant bits, fp32-grade.  Rounded to bf16 once instead, they
//     missed the per-element bf16 tolerance (2e-2 absolute and relative)
//     several times over in y, dx, ddt, dB and dC (an emulation of the
//     roundings on the CPU).
//   * Exponents are span sums and are masked before exp: cum, rev and tot
//     by warp-shuffle scans (tree sums of exactly the steps spanned), E by
//     per-thread running sums that walk each row leftwards from the end of
//     the chunk and add a step only at or below the row.  Never a
//     difference of cumulative sums.  The decay gradient stays fp32 from
//     fp32 operands: dy x^T and C B^T come from exact inputs, the
//     sum_{i>=m>j} is a row prefix then column sum over an fp32 L x L tile
//     in shared memory, and dA is summed in fp64.
//   * The chunk states move in fp32 (B nc H P N, 335 MB at the training
//     shape, four passes each way).  The recurrence's 8-step checkpoints
//     (2.7 GB) and per-head dB/dC partials (671 MB) are gone: dB and dC are
//     summed over a CTA's heads in registers, one partial per head group.
//   * Deterministic: no atomics; every sum has a fixed order.
//
// fp32 (entries ssd_fwd and ssd_bwd): the recurrence itself, one step at a
// time (the tensor cores' TF32 would miss the fp32 tolerance).  One CTA per
// (b, h) with 4 P threads: thread (p, q) holds the state row S[p, n] for the
// N / 4 columns n = 4 j + q in registers, so the readout sum over n is
// in-thread plus two shuffles.  Inputs of SEG steps are staged in shared
// memory and read as broadcasts.  Backward: G_t = dL/dS_t follows
// G_t = a_{t+1} G_{t+1} + dy_t C_t^T, seeded with the final state's gradient;
// then
//   dX̄_t = G_t B_t (sum over n)       dB_t = G_t^T X̄_t (sum over p)
//   dC_t = S_t^T dy_t (sum over p)     g_t = a_t sum_{p,n} G_t ⊙ S_{t-1}
//   dx_t = dX̄_t dt_t    d dt_t = dX̄_t . x_t + A g_t    dA = sum_{b,t} dt_t g_t
// and the initial state's gradient is a_0 G_0.  g_t is that exact dot
// product: S_{t-1} is recomputed from checkpoints written every SEG steps
// by a forward pass, one segment at a time into shared memory.  The
// backward carries a_t, the state, G and g_t in fp64 registers (the stored
// history and checkpoints stay fp32): dA sums terms that cancel, and with
// a_t and the state rounded to fp32 it strayed from an fp64 oracle by most
// of the fp32 tolerance at some lengths.  Sums over p cross warps (recursive
// halving over shuffles, then shared memory); dB and dC are then summed
// over H by a second kernel, dA over B in fp64 by a third.  No atomics.
//
// Plain C entry points, bound with ctypes; each returns the first CUDA error
// of the call (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int SEG = 8;  // steps staged per segment; backward checkpoint interval
constexpr unsigned FULL = 0xffffffffu;


// row (b, t) of a (B, S, ...) tensor, as an element offset before the
// trailing dims
__device__ __forceinline__ size_t bt(int b, int t, int S) {
  return static_cast<size_t>(b) * S + t;
}

// Stage steps [t0, t0 + n) of x (and dy), dt, Bm (and Cm) for head h.
template <int P, int N>
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      const float* __restrict__ dy,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ Bm,
                                      const float* __restrict__ Cm, float (*sx)[P],
                                      float (*sdy)[P], float* sdt, float (*sB)[N],
                                      float (*sC)[N], int b, int h, int t0, int n, int S,
                                      int H) {
  constexpr int NT = 4 * P;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * P; i += NT) {
    const int tt = i / P, c = i % P;
    const size_t off = (bt(b, t0 + tt, S) * H + h) * P + c;
    sx[tt][c] = x[off];
    if (dy) sdy[tt][c] = dy[off];
  }
  for (int i = tid; i < n * N; i += NT) {
    const int tt = i / N, c = i % N;
    const size_t off = bt(b, t0 + tt, S) * N + c;
    sB[tt][c] = Bm[off];
    if (Cm) sC[tt][c] = Cm[off];
  }
  if (tid < n) sdt[tid] = dt[bt(b, t0 + tid, S) * H + h];
}

template <int P, int N>
__global__ void __launch_bounds__(4 * P)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ s0, float* __restrict__ y,
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
    stage<P, N>(x, nullptr, dt, Bm, Cm, sx, nullptr, sdt, sB, sC, b, h, t0, n, S, H);
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
      y[(bt(b, t0 + tt, S) * H + h) * P + c] = sy[tt][c];
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

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <int P, int N>
__global__ void __launch_bounds__(4 * P)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ s0,
               const float* __restrict__ dy, const float* __restrict__ dsT, float* __restrict__ dx,
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
  __shared__ double pg[SEG][NW];
  __shared__ float pd[SEG][NW];
  __shared__ double sgd[SEG];  // dt_t g_t
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, p = tid >> 2, q = tid & 3;
  const int lane = tid & 31, warp = tid >> 5;
  const double a_h = A[h];
  const int nseg = (S + SEG - 1) / SEG;
  const size_t row = (static_cast<size_t>(bh) * P + p) * N + q;  // + 4 j
  float* ck = ckpt + static_cast<size_t>(bh) * nseg * P * N + static_cast<size_t>(p) * N + q;

  // pass 1: forward in time; checkpoint S at the start of every segment
  double s[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) s[j] = s0 ? s0[row + 4 * j] : 0.0;
  for (int seg = 0; seg < nseg; ++seg) {
    const int t0 = seg * SEG, n = min(SEG, S - t0);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      ck[static_cast<size_t>(seg) * P * N + 4 * j] = static_cast<float>(s[j]);
    __syncthreads();
    stage<P, N>(x, nullptr, dt, Bm, nullptr, sx, nullptr, sdt, sB, nullptr, b, h, t0, n,
                   S, H);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const double d = sdt[tt];
      const double a = exp(d * a_h), xb = sx[tt][p] * d;
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[j] = a * s[j] + xb * sB[tt][4 * j + q];
    }
  }

  // pass 2: backward in time, G[p, 4 j + q] in registers
  double g[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) g[j] = dsT ? dsT[row + 4 * j] : 0.0;
  float* my_hist = hist + p * PITCH + q;
  double dA_acc = 0.0;
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * SEG, n = min(SEG, S - t0);
    __syncthreads();  // the previous segment's shared buffers are consumed
    stage<P, N>(x, dy, dt, Bm, Cm, sx, sdy, sdt, sB, sC, b, h, t0, n, S, H);
    __syncthreads();
    // S_{t-1} of each step of the segment, from its checkpoint (each thread
    // reads back only what it wrote: no barrier needed)
#pragma unroll
    for (int j = 0; j < NQ; ++j) s[j] = ck[static_cast<size_t>(seg) * P * N + 4 * j];
    for (int tt = 0; tt < n; ++tt) {
      const double d = sdt[tt];
      const double a = exp(d * a_h), xb = sx[tt][p] * d;
      float* hrow = my_hist + tt * P * PITCH;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        hrow[4 * j] = static_cast<float>(s[j]);
        s[j] = a * s[j] + xb * sB[tt][4 * j + q];
      }
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      const double d = sdt[tt];
      const double a = exp(d * a_h), xt = sx[tt][p], xb = xt * d, dyp = sdy[tt][p];
      const float* hrow = my_hist + tt * P * PITCH;
      double gs = 0.0, dxb = 0.0;
      float vb[NQ], vc[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const double bn = sB[tt][4 * j + q], cn = sC[tt][4 * j + q], sp = hrow[4 * j];
        g[j] += dyp * cn;  // G_t
        gs += g[j] * sp;
        dxb += g[j] * bn;
        vb[j] = static_cast<float>(g[j] * xb);
        vc[j] = static_cast<float>(dyp * (a * sp + xb * bn));  // dy_t[p] S_t[p, n]
        g[j] *= a;  // a_t G_t: G_{t-1} before dy_{t-1} C_{t-1}
      }
      dxb += __shfl_xor_sync(FULL, dxb, 1);
      dxb += __shfl_xor_sync(FULL, dxb, 2);
      if (q == 0) dx[(bt(b, t0 + tt, S) * H + h) * P + p] = static_cast<float>(dxb * d);
      const float dd = warp_sum(q == 0 ? static_cast<float>(dxb * xt) : 0.f);
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
      double gsum = 0.0;
      float dsum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        gsum += pg[tt][w];
        dsum += pd[tt][w];
      }
      const double d = sdt[tt];
      const double gt = exp(d * a_h) * gsum;
      ddt[bt(b, t0 + tt, S) * H + h] = dsum + static_cast<float>(a_h * gt);
      sgd[tt] = d * gt;
    }
    __syncthreads();
    if (tid == 0)
      for (int tt = 0; tt < n; ++tt) dA_acc += sgd[tt];
  }
  if (tid == 0) dA_part[bh] = dA_acc;
  if (ds0) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) ds0[row + 4 * j] = static_cast<float>(g[j]);
  }
}

// dB[b, t, n] = sum_h dB_part[b, t, h, n] (and dC), h in order
__global__ void ssd_bc_reduce_kernel(const float* __restrict__ dB_part,
                                     const float* __restrict__ dC_part, float* __restrict__ dB,
                                     float* __restrict__ dC, int H, int N) {
  const size_t r = blockIdx.x;
  const int n = threadIdx.x;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dB_part[(r * H + h) * N + n];
    sc += dC_part[(r * H + h) * N + n];
  }
  dB[r * N + n] = sb;
  dC[r * N + n] = sc;
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

template <int P, int N>
int launch_fwd(const float* x, const float* dt, const float* A, const float* Bm,
               const float* Cm, const float* s0, float* y, float* sT, int B, int S, int H,
               cudaStream_t st) {
  ssd_fwd_kernel<P, N><<<B * H, 4 * P, 0, st>>>(x, dt, A, Bm, Cm, s0, y, sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_bwd(const float* x, const float* dt, const float* A, const float* Bm,
               const float* Cm, const float* s0, const float* dy, const float* dsT, float* dx,
               float* ddt, float* dA, float* dB, float* dC, float* ds0, float* dB_part,
               float* dC_part, double* dA_part, float* ckpt, int B, int S, int H,
               cudaStream_t st) {
  const int smem = SEG * P * (N + 4) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_kernel<P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_kernel<P, N><<<B * H, 4 * P, smem, st>>>(x, dt, A, Bm, Cm, s0, dy, dsT, dx, ddt,
                                                   dB_part, dC_part, dA_part, ds0, ckpt, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bc_reduce_kernel<<<B * S, N, 0, st>>>(dB_part, dC_part, dB, dC, H, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_dA_reduce_kernel<<<1, 128, 0, st>>>(dA_part, dA, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// bf16: the chunked form on tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------

namespace chunked {

using namespace tc;

constexpr int L = 64;         // chunk length
constexpr int THREADS = 128;  // 4 warps; warp w owns rows 16 w .. 16 w + 15 of an L-row tile
constexpr int HG = 16;        // heads per CTA: they share its B and C tiles
constexpr int EP = L + 1;     // pitch (floats) of the L x L fp32 tile: row and column walks
                              // are free of bank conflicts

// Rows [0, L) of a (rows, COLS) bf16 tile whose row r starts at
// base + r * stride, into shared memory (pitch pitch(COLS)) by cp.async;
// rows >= nv are zero-filled.
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base, size_t stride, int nv) {
  constexpr int V = COLS / 8;
  for (int i = threadIdx.x; i < L * V; i += THREADS) {
    const int r = i / V, v = i % V;
    const bool ok = r < nv;
    cp_async16(dst + r * pitch(COLS) + v * 8, ok ? base + r * stride + v * 8 : base, ok);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dt of one head over the chunk into sdt by cp.async, 0 past the sequence's end
__device__ __forceinline__ void stage_dt(float* sdt, const float* __restrict__ dt, int b, int t0,
                                         int nv, int S, int H, int h) {
  const int l = threadIdx.x;
  if (l < L) {
    const bool ok = l < nv;
    cp_async4(sdt + l, ok ? dt + (static_cast<size_t>(b) * S + t0 + l) * H + h : dt, ok);
  }
}

// Span sums over the chunk, by one warp (lane k holds steps 2k and 2k + 1):
// cum_l = sum_{m <= l} dA_m, rev_l = sum_{m > l} dA_m and the chunk's total.
// Scans by shuffles, so every value is a sum of exactly the steps it spans
// (never a difference of cumulative sums).  Either output may be NULL.
__device__ __forceinline__ float warp_span_sums(float a, float b, float* scum, float* srev) {
  const int lane = threadIdx.x & 31;
  float pre = a + b, suf = a + b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, pre, off);
    const float d = __shfl_down_sync(0xffffffffu, suf, off);
    if (lane >= off) pre += u;
    if (lane + off < 32) suf += d;
  }
  float before = __shfl_up_sync(0xffffffffu, pre, 1);  // pairs 0 .. lane - 1
  float after = __shfl_down_sync(0xffffffffu, suf, 1);  // pairs lane + 1 .. 31
  if (lane == 0) before = 0.f;
  if (lane == 31) after = 0.f;
  if (scum) {
    scum[2 * lane] = before + a;
    scum[2 * lane + 1] = before + (a + b);
  }
  if (srev) {
    srev[2 * lane] = b + after;
    srev[2 * lane + 1] = after;
  }
  return __shfl_sync(0xffffffffu, suf, 0);  // the whole chunk
}

// The exponents of E[i][j] = exp(sum_{j < m <= i} dA_m) for this thread's
// rows r0, r1 at its two columns 8 nt + 2 q + {0, 1} of fragment tile nt:
// running sums s0, s1 walk m downwards from the end of the chunk, adding
// dA_m only for m <= row, and are read as they pass each column, so every
// exponent is a sum of the steps it spans.  Call (unrolled) for nt = L/8 - 1
// down to a lowest tile, s0 = s1 = 0 at the start (tiles wholly right of
// both rows may be skipped); t0[e], t1[e] get the exponents
// (0 above the diagonal, where E is masked to 0 before exp).
__device__ __forceinline__ void exponents(const float* sdA, int nt, int r0, int r1, int q,
                                          float& s0, float& s1, float (&t0)[2], float (&t1)[2]) {
#pragma unroll
  for (int mm = 7; mm >= 0; --mm) {
    const int m = 8 * nt + mm;
    if ((mm >> 1) == q) {
      t0[mm & 1] = s0;
      t1[mm & 1] = s1;
    }
    const float d = sdA[m];
    if (m <= r0) s0 += d;
    if (m <= r1) s1 += d;
  }
}

// Warp tiling of a (P, N) output over the 4 warps: WM x WN warps of
// 16 x NW.
template <int P, int N>
struct StateTiling {
  static constexpr int WM = P / 16, WN = 4 / WM, NW = N / WN, NT = NW / 8;
};

template <int P, int N>
__device__ __forceinline__ void store_state(float* __restrict__ dst,
                                            const float (&acc)[StateTiling<P, N>::NT][4]) {
  using T = StateTiling<P, N>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = 16 * (warp % T::WM) + (lane >> 2), n0 = T::NW * (warp / T::WM) + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int n = n0 + 8 * nt;
    *reinterpret_cast<float2*>(dst + p0 * N + n) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(dst + (p0 + 8) * N + n) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Each row's sum over the thread's columns of acc ⊙ (a shared bf16 tile),
// reduced over the quad: the value of rows r0 and r1 in every lane.
template <int NT>
__device__ __forceinline__ void row_dots(const float (&acc)[NT][4], const bf16* t, int pt,
                                         int r0, float* d0, float* d1) {
  const int q = threadIdx.x & 3;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = 8 * nt + 2 * q;
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(t + r0 * pt + col);
    const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(t + (r0 + 8) * pt + col);
    s0 += acc[nt][0] * __bfloat162float(a.x) + acc[nt][1] * __bfloat162float(a.y);
    s1 += acc[nt][2] * __bfloat162float(c.x) + acc[nt][3] * __bfloat162float(c.y);
  }
  *d0 = quad_sum(s0);
  *d1 = quad_sum(s1);
}

template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[NT][4], float s0, float s1) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] *= s0;
    acc[nt][1] *= s0;
    acc[nt][2] *= s1;
    acc[nt][3] *= s1;
  }
}

template <int NT>
__device__ __forceinline__ void add_into(float (&sum)[NT][4], const float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[nt][e] += acc[nt][e];
}

// ---- forward 1: each chunk's own state, sum_l exp(rev_l) dt_l x_l B_l^T ----
//
// Per CTA the x and dt of the heads two ahead are loaded (cp.async, three
// buffers) while this head's product runs.

template <int P, int N>
struct StateSmem {
  size_t B = 0, x = 0, w_hi = 0, w_lo = 0, dt = 0, w = 0, total = 0;
  __host__ __device__ constexpr StateSmem() {
    Carve c;
    B = c.take<bf16>(L * pitch(N));
    x = c.take<bf16>(3 * L * pitch(P));
    w_hi = c.take<bf16>(L * pitch(N));
    w_lo = c.take<bf16>(L * pitch(N));
    dt = c.take<float>(3 * L);
    w = c.take<float>(L);
    total = c.off;
  }
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ tot, int S, int H) {
  using T = StateTiling<P, N>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr StateSmem<P, N> o{};
  bf16* sB = reinterpret_cast<bf16*>(smem + o.B);
  bf16* sx0 = reinterpret_cast<bf16*>(smem + o.x);
  bf16* sw_hi = reinterpret_cast<bf16*>(smem + o.w_hi);
  bf16* sw_lo = reinterpret_cast<bf16*>(smem + o.w_lo);
  float* sdt0 = reinterpret_cast<float*>(smem + o.dt);
  float* sw = reinterpret_cast<float*>(smem + o.w);
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const int h_lo = blockIdx.y * HG, h_hi = min(H, h_lo + HG);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = 16 * (warp % T::WM), n0 = T::NW * (warp / T::WM);
  const size_t rs = static_cast<size_t>(H) * P;
  const bf16* xrow = x + (static_cast<size_t>(b) * S + t0) * rs;

  // x and dt of head h go to slot (h - h_lo) % 3, two heads ahead
  auto stage = [&](int hh) {
    if (hh < h_hi) {
      const int slot = (hh - h_lo) % 3;
      stage_rows<P>(sx0 + slot * L * pitch(P), xrow + static_cast<size_t>(hh) * P, rs, nv);
      stage_dt(sdt0 + slot * L, dt, b, t0, nv, S, H, hh);
    }
    cp_async_commit();
  };
  stage_rows<N>(sB, Bm + (static_cast<size_t>(b) * S + t0) * N, N, nv);
  stage(h_lo);
  stage(h_lo + 1);
  for (int h = h_lo; h < h_hi; ++h) {
    const int slot = (h - h_lo) % 3;
    bf16* sx = sx0 + slot * L * pitch(P);
    const float* sdt = sdt0 + slot * L;
    cp_async_wait_prior();  // head h has landed (head h + 1 may be in flight)
    __syncthreads();        // head h - 1 is done with every buffer
    stage(h + 2);
    const size_t chunk = (static_cast<size_t>(b) * nc + c) * H + h;
    if (warp == 0) {  // w_l = exp(rev_l) dt_l, and the chunk's total
      const int lane = tid & 31;
      const float a = A[h], d0 = sdt[2 * lane], d1 = sdt[2 * lane + 1];
      const float total = warp_span_sums(d0 * a, d1 * a, nullptr, sw);
      sw[2 * lane] = __expf(sw[2 * lane]) * d0;
      sw[2 * lane + 1] = __expf(sw[2 * lane + 1]) * d1;
      if (lane == 0) tot[chunk] = total;
    }
    __syncthreads();
    // w_l B_l as hi + lo
    for (int i = tid; i < L * N / 2; i += THREADS) {
      const int l = (2 * i) / N, n = (2 * i) % N;
      const float w = sw[l];
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(sB + l * pitch(N) + n);
      store_split2(w * __bfloat162float(bv.x), w * __bfloat162float(bv.y),
                   sw_hi + l * pitch(N) + n, sw_lo + l * pitch(N) + n);
    }
    __syncthreads();
    float acc[T::NT][4];
    zero(acc);
    // state[p][n] = sum_l x[l][p] (w B)[l][n]: A = x^T, B = w B, both stored [l][.]
    warp_mma2<T::NT, true, true, false>(acc, sx, nullptr, pitch(P), m0, sw_hi, sw_lo,
                                        pitch(N), n0, 0, L / 16);
    store_state<P, N>(states + chunk * P * N, acc);
  }
}

// ---- the pass over chunks, forward or reverse ----
//
// forward: buf holds each chunk's own state; on return buf[c] is the state
//   entering chunk c, and out the final state (from seed = s0, or zero).
// reverse: buf holds each chunk's D_c; on return buf[c] is the gradient of
//   the state leaving chunk c (from seed = dsT, or zero), and out (if not
//   NULL) the initial state's gradient.
// One thread per 4 elements of a (b, h) state; exp(tot) is the chunk's
// decay.  Loads go out DEPTH chunks at a time, so a thread waits for memory
// once per DEPTH chunks.
template <bool REVERSE>
__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(float* __restrict__ buf, const float* __restrict__ tot,
                      const float* __restrict__ seed, float* __restrict__ out, int nc, int H,
                      int PN) {
  constexpr int DEPTH = 8;
  const int e4 = blockIdx.x * THREADS + threadIdx.x;
  if (4 * e4 >= PN) return;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t step = static_cast<size_t>(H) * PN / 4;  // float4s from chunk c to c + 1
  float4* base = reinterpret_cast<float4*>(buf + (static_cast<size_t>(b) * nc * H + h) * PN) + e4;
  const float* td = tot + static_cast<size_t>(b) * nc * H + h;
  float4 s = seed ? reinterpret_cast<const float4*>(seed + static_cast<size_t>(bh) * PN)[e4]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += DEPTH) {
    float4 v[DEPTH];
    float d[DEPTH];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int c = REVERSE ? nc - 1 - (k0 + k) : k0 + k;
      if (k0 + k < nc) {
        v[k] = base[c * step];
        d[k] = td[static_cast<size_t>(c) * H];
      }
    }
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int c = REVERSE ? nc - 1 - (k0 + k) : k0 + k;
      if (k0 + k < nc) {
        base[c * step] = s;
        const float e = expf(d[k]);
        s = make_float4(e * s.x + v[k].x, e * s.y + v[k].y, e * s.z + v[k].z, e * s.w + v[k].w);
      }
    }
  }
  if (out) reinterpret_cast<float4*>(out + static_cast<size_t>(bh) * PN)[e4] = s;
}

// ---- forward 2: y = exp(cum) ⊙ (C Sp^T) + (C B^T ⊙ E ⊙ dt) x ----
//
// The next head's x, dt and Sp (fp32) are loaded while this head runs.  Sp
// is split into hi + lo once per head; E is formed in registers, each
// thread for its own fragment elements, as the diagonal product runs.

template <int P, int N>
struct OutSmem {
  size_t C = 0, B = 0, x = 0, Sp = 0, S_hi = 0, S_lo = 0, dt = 0, dA = 0, cum = 0, total = 0;
  __host__ __device__ constexpr OutSmem() {
    Carve c;
    C = c.take<bf16>(L * pitch(N));
    B = c.take<bf16>(L * pitch(N));
    x = c.take<bf16>(2 * L * pitch(P));
    Sp = c.take<float>(P * N);
    S_hi = c.take<bf16>(P * pitch(N));
    S_lo = c.take<bf16>(P * pitch(N));
    dt = c.take<float>(2 * L);
    dA = c.take<float>(L);
    cum = c.take<float>(L);
    total = c.off;
  }
};

// C B^T for the warp's 16 rows i and all L columns j (only j <= i is used)
template <int N>
__device__ __forceinline__ void compute_cb(float (&cb)[L / 8][4], const bf16* sC, const bf16* sB) {
  const int warp = threadIdx.x >> 5;
  zero(cb);
  warp_mma<L / 8, false, false>(cb, sC, pitch(N), 16 * warp, sB, pitch(N), 0, 0, N / 16);
}

// A (P, N) fp32 tile (dense, in shared memory) as a hi + lo pair of bf16
// tiles [p][pitch(N)]
template <int P, int N>
__device__ __forceinline__ void split_tile(bf16* hi, bf16* lo, const float* src) {
  for (int i = threadIdx.x; i < P * N / 4; i += THREADS) {
    const int p = (4 * i) / N, n = (4 * i) % N;
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    bf16* h = hi + p * pitch(N) + n;
    bf16* l = lo + p * pitch(N) + n;
    store_split2(v.x, v.y, h, l);
    store_split2(v.z, v.w, h + 2, l + 2);
  }
}

// Warp 0: dA_l = dt_l A into sdA and the span sums of the chunk.
__device__ __forceinline__ float warp_decays(const float* sdt, float a, float* sdA, float* scum,
                                             float* srev) {
  const int lane = threadIdx.x & 31;
  const float d0 = sdt[2 * lane] * a, d1 = sdt[2 * lane + 1] * a;
  sdA[2 * lane] = d0;
  sdA[2 * lane + 1] = d1;
  return warp_span_sums(d0, d1, scum, srev);
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const float* __restrict__ Sp,
                     bf16* __restrict__ y, int S, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr OutSmem<P, N> o{};
  bf16* sC = reinterpret_cast<bf16*>(smem + o.C);
  bf16* sB = reinterpret_cast<bf16*>(smem + o.B);
  bf16* sx0 = reinterpret_cast<bf16*>(smem + o.x);
  float* sSp = reinterpret_cast<float*>(smem + o.Sp);
  bf16* sS_hi = reinterpret_cast<bf16*>(smem + o.S_hi);
  bf16* sS_lo = reinterpret_cast<bf16*>(smem + o.S_lo);
  float* sdt0 = reinterpret_cast<float*>(smem + o.dt);
  float* sdA = reinterpret_cast<float*>(smem + o.dA);
  float* scum = reinterpret_cast<float*>(smem + o.cum);
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const int h_lo = blockIdx.y * HG, h_hi = min(H, h_lo + HG);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;
  const size_t rs = static_cast<size_t>(H) * P;
  const bf16* xrow = x + (static_cast<size_t>(b) * S + t0) * rs;
  const float* Sp_c = Sp + (static_cast<size_t>(b) * nc + c) * H * P * N;

  stage_rows<N>(sC, Cm + (static_cast<size_t>(b) * S + t0) * N, N, nv);
  stage_rows<N>(sB, Bm + (static_cast<size_t>(b) * S + t0) * N, N, nv);
  stage_rows<P>(sx0, xrow + static_cast<size_t>(h_lo) * P, rs, nv);
  stage_dt(sdt0, dt, b, t0, nv, S, H, h_lo);
  for (int i = tid; i < P * N / 4; i += THREADS)
    cp_async16(sSp + 4 * i, Sp_c + static_cast<size_t>(h_lo) * P * N + 4 * i, true);
  cp_async_commit();
  float cb[L / 8][4];
  for (int h = h_lo; h < h_hi; ++h) {
    const int buf = (h - h_lo) & 1;
    const bf16* sx = sx0 + buf * L * pitch(P);
    const float* sdt = sdt0 + buf * L;
    cp_async_wait_all();
    __syncthreads();  // head h has landed; head h - 1 is done with every buffer
    split_tile<P, N>(sS_hi, sS_lo, sSp);
    if (warp == 0) warp_decays(sdt, A[h], sdA, scum, nullptr);
    __syncthreads();  // sSp is consumed
    if (h + 1 < h_hi) {
      stage_rows<P>(sx0 + (buf ^ 1) * L * pitch(P), xrow + static_cast<size_t>(h + 1) * P, rs,
                    nv);
      stage_dt(sdt0 + (buf ^ 1) * L, dt, b, t0, nv, S, H, h + 1);
      for (int i = tid; i < P * N / 4; i += THREADS)
        cp_async16(sSp + 4 * i, Sp_c + static_cast<size_t>(h + 1) * P * N + 4 * i, true);
    }
    cp_async_commit();
    if (h == h_lo) compute_cb<N>(cb, sC, sB);

    float acc[P / 8][4];
    zero(acc);
    // exp(cum_i) (C Sp^T)_i: B operand (k = n, cols p) stored Sp[p][n]
    warp_mma2<P / 8, false, false, false>(acc, sC, nullptr, pitch(N), 16 * warp, sS_hi, sS_lo,
                                          pitch(N), 0, 0, N / 16);
    scale_rows(acc, __expf(scum[r0]), __expf(scum[r1]));
    // (C B^T ⊙ E ⊙ dt) x over the k16 blocks at or left of the diagonal,
    // right to left as the exponents' running sums walk
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int kk = L / 16 - 1; kk >= 0; --kk) {
      if (kk > warp) continue;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int half = 1; half >= 0; --half) {
        const int nt = 2 * kk + half, j = 8 * nt + 2 * q;
        float t0[2], t1[2];
        exponents(sdA, nt, r0, r1, q, s0, s1, t0, t1);
        const float w0 = sdt[j], w1 = sdt[j + 1];
        split2(j <= r0 ? cb[nt][0] * __expf(t0[0]) * w0 : 0.f,
               j + 1 <= r0 ? cb[nt][1] * __expf(t0[1]) * w1 : 0.f, &hi[2 * half], &lo[2 * half]);
        split2(j <= r1 ? cb[nt][2] * __expf(t1[0]) * w0 : 0.f,
               j + 1 <= r1 ? cb[nt][3] * __expf(t1[1]) * w1 : 0.f, &hi[2 * half + 1],
               &lo[2 * half + 1]);
      }
      mma_k16<P / 8, true>(acc, hi, sx, pitch(P), 0, 16 * kk);
      mma_k16<P / 8, true>(acc, lo, sx, pitch(P), 0, 16 * kk);
    }
    bf16* yb = y + (static_cast<size_t>(b) * S + t0) * rs + static_cast<size_t>(h) * P;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const int p = 8 * nt + 2 * q;
      if (r0 < nv)
        *reinterpret_cast<__nv_bfloat162*>(yb + r0 * rs + p) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      if (r1 < nv)
        *reinterpret_cast<__nv_bfloat162*>(yb + r1 * rs + p) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---- backward 1: D_c = sum_i dy_i^T exp(cum_i) C_i ----

template <int P, int N>
struct DstateSmem {
  size_t C = 0, dy = 0, c_hi = 0, c_lo = 0, dt = 0, cum = 0, total = 0;
  __host__ __device__ constexpr DstateSmem() {
    Carve c;
    C = c.take<bf16>(L * pitch(N));
    dy = c.take<bf16>(2 * L * pitch(P));
    c_hi = c.take<bf16>(L * pitch(N));
    c_lo = c.take<bf16>(L * pitch(N));
    dt = c.take<float>(2 * L);
    cum = c.take<float>(L);
    total = c.off;
  }
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_dstate_kernel(const bf16* __restrict__ dy, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ Cm,
                        float* __restrict__ D, int S, int H) {
  using T = StateTiling<P, N>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr DstateSmem<P, N> o{};
  bf16* sC = reinterpret_cast<bf16*>(smem + o.C);
  bf16* sdy0 = reinterpret_cast<bf16*>(smem + o.dy);
  bf16* sc_hi = reinterpret_cast<bf16*>(smem + o.c_hi);
  bf16* sc_lo = reinterpret_cast<bf16*>(smem + o.c_lo);
  float* sdt0 = reinterpret_cast<float*>(smem + o.dt);
  float* scum = reinterpret_cast<float*>(smem + o.cum);
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const int h_lo = blockIdx.y * HG, h_hi = min(H, h_lo + HG);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = 16 * (warp % T::WM), n0 = T::NW * (warp / T::WM);
  const size_t rs = static_cast<size_t>(H) * P;
  const bf16* dyrow = dy + (static_cast<size_t>(b) * S + t0) * rs;

  stage_rows<N>(sC, Cm + (static_cast<size_t>(b) * S + t0) * N, N, nv);
  stage_rows<P>(sdy0, dyrow + static_cast<size_t>(h_lo) * P, rs, nv);
  stage_dt(sdt0, dt, b, t0, nv, S, H, h_lo);
  cp_async_commit();
  for (int h = h_lo; h < h_hi; ++h) {
    const int buf = (h - h_lo) & 1;
    const bf16* sdy = sdy0 + buf * L * pitch(P);
    const float* sdt = sdt0 + buf * L;
    cp_async_wait_all();
    __syncthreads();  // head h has landed; head h - 1 is done with every buffer
    if (h + 1 < h_hi) {
      stage_rows<P>(sdy0 + (buf ^ 1) * L * pitch(P), dyrow + static_cast<size_t>(h + 1) * P,
                    rs, nv);
      stage_dt(sdt0 + (buf ^ 1) * L, dt, b, t0, nv, S, H, h + 1);
    }
    cp_async_commit();
    if (warp == 0) {  // exp(cum_l)
      const int lane = tid & 31;
      const float a = A[h];
      warp_span_sums(sdt[2 * lane] * a, sdt[2 * lane + 1] * a, scum, nullptr);
      scum[2 * lane] = __expf(scum[2 * lane]);
      scum[2 * lane + 1] = __expf(scum[2 * lane + 1]);
    }
    __syncthreads();
    // exp(cum_i) C_i as hi + lo
    for (int i = tid; i < L * N / 2; i += THREADS) {
      const int l = (2 * i) / N, n = (2 * i) % N;
      const float e = scum[l];
      const __nv_bfloat162 cv = *reinterpret_cast<const __nv_bfloat162*>(sC + l * pitch(N) + n);
      store_split2(e * __bfloat162float(cv.x), e * __bfloat162float(cv.y),
                   sc_hi + l * pitch(N) + n, sc_lo + l * pitch(N) + n);
    }
    __syncthreads();
    float acc[T::NT][4];
    zero(acc);
    // D[p][n] = sum_i dy[i][p] (exp(cum) C)[i][n]: A = dy^T, B = exp(cum) C, both stored [i][.]
    warp_mma2<T::NT, true, true, false>(acc, sdy, nullptr, pitch(P), m0, sc_hi, sc_lo,
                                        pitch(N), n0, 0, L / 16);
    store_state<P, N>(D + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N, acc);
  }
}

// ---- backward 2: the in-chunk gradients ----

template <int P, int N>
struct BwdSmem {
  size_t C = 0, B = 0, x = 0, dy = 0, uni = 0, Q = 0, dt = 0, dA = 0, cum = 0, rev = 0;
  size_t u = 0, r = 0, ddx = 0, T = 0, gd = 0, red = 0, total = 0;
  // uni holds Sp hi/lo and G hi/lo [P][pitch(N)] while the state terms run,
  // then W hi/lo and dCB hi/lo [L][pitch(L)]
  static constexpr int UNI = (4 * P * pitch(N) > 4 * L * pitch(L) ? 4 * P * pitch(N)
                                                                  : 4 * L * pitch(L));
  __host__ __device__ constexpr BwdSmem() {
    Carve c;
    C = c.take<bf16>(L * pitch(N));
    B = c.take<bf16>(L * pitch(N));
    x = c.take<bf16>(2 * L * pitch(P));
    dy = c.take<bf16>(2 * L * pitch(P));
    uni = c.take<bf16>(UNI);
    Q = c.take<float>(L * EP);
    dt = c.take<float>(2 * L);
    dA = c.take<float>(L);
    cum = c.take<float>(L);
    rev = c.take<float>(L);
    u = c.take<float>(L);
    r = c.take<float>(L);
    ddx = c.take<float>(L);
    T = c.take<float>(L);
    gd = c.take<float>(L);
    red = c.take<float>(THREADS / 32);
    total = c.off;
  }
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                 const float* __restrict__ Sp, const float* __restrict__ G,
                 const float* __restrict__ tot, bf16* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ dBC_part, double* __restrict__ dA_part, int S, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr BwdSmem<P, N> o{};
  bf16* sC = reinterpret_cast<bf16*>(smem + o.C);
  bf16* sB = reinterpret_cast<bf16*>(smem + o.B);
  bf16* sx0 = reinterpret_cast<bf16*>(smem + o.x);
  bf16* sdy0 = reinterpret_cast<bf16*>(smem + o.dy);
  bf16* uni = reinterpret_cast<bf16*>(smem + o.uni);
  bf16* sS_hi = uni;
  bf16* sS_lo = uni + P * pitch(N);
  bf16* sG_hi = uni + 2 * P * pitch(N);
  bf16* sG_lo = uni + 3 * P * pitch(N);
  bf16* sW_hi = uni;
  bf16* sW_lo = uni + L * pitch(L);
  bf16* sD_hi = uni + 2 * L * pitch(L);
  bf16* sD_lo = uni + 3 * L * pitch(L);
  float* sQ = reinterpret_cast<float*>(smem + o.Q);  // dCB ⊙ C B^T, fp32
  float* sdt0 = reinterpret_cast<float*>(smem + o.dt);
  float* sdA = reinterpret_cast<float*>(smem + o.dA);
  float* scum = reinterpret_cast<float*>(smem + o.cum);
  float* srev = reinterpret_cast<float*>(smem + o.rev);
  float* su = reinterpret_cast<float*>(smem + o.u);
  float* sr = reinterpret_cast<float*>(smem + o.r);
  float* sddx = reinterpret_cast<float*>(smem + o.ddx);
  float* sT = reinterpret_cast<float*>(smem + o.T);
  float* sgd = reinterpret_cast<float*>(smem + o.gd);
  float* sred = reinterpret_cast<float*>(smem + o.red);
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, nv = min(L, S - t0);
  const int h_lo = blockIdx.y * HG, h_hi = min(H, h_lo + HG);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows of every L-row tile

  const size_t rs = static_cast<size_t>(H) * P;
  const size_t row_c = (static_cast<size_t>(b) * S + t0) * H;  // row (b, t0), head 0
  stage_rows<N>(sC, Cm + (static_cast<size_t>(b) * S + t0) * N, N, nv);
  stage_rows<N>(sB, Bm + (static_cast<size_t>(b) * S + t0) * N, N, nv);
  stage_rows<P>(sx0, x + (row_c + h_lo) * P, rs, nv);
  stage_rows<P>(sdy0, dy + (row_c + h_lo) * P, rs, nv);
  stage_dt(sdt0, dt, b, t0, nv, S, H, h_lo);
  cp_async_commit();
  float dcs[N / 8][4], dbs[N / 8][4];  // dC (rows i) and dB (rows j), summed over the heads
  zero(dcs);
  zero(dbs);

  for (int h = h_lo; h < h_hi; ++h) {
    const int buf = (h - h_lo) & 1;
    const bf16* sx = sx0 + buf * L * pitch(P);
    const bf16* sdy = sdy0 + buf * L * pitch(P);
    const float* sdt = sdt0 + buf * L;
    __syncthreads();  // head h - 1 is done with every buffer
    if (h + 1 < h_hi) {  // the next head's x, dy and dt, while this one runs
      stage_rows<P>(sx0 + (buf ^ 1) * L * pitch(P), x + (row_c + h + 1) * P, rs, nv);
      stage_rows<P>(sdy0 + (buf ^ 1) * L * pitch(P), dy + (row_c + h + 1) * P, rs, nv);
      stage_dt(sdt0 + (buf ^ 1) * L, dt, b, t0, nv, S, H, h + 1);
    }
    cp_async_commit();
    const size_t chunk = (static_cast<size_t>(b) * nc + c) * H + h;
    const float a = A[h];
    // Sp and G as hi + lo, and <G, Sp> from the fp32 values (fixed order)
    {
      const float4* s4 = reinterpret_cast<const float4*>(Sp + chunk * P * N);
      const float4* g4 = reinterpret_cast<const float4*>(G + chunk * P * N);
      float part = 0.f;
      for (int i = tid; i < P * N / 4; i += THREADS) {
        const int p = (4 * i) / N, n = (4 * i) % N;
        const float4 sv = s4[i], gv = g4[i];
        part += sv.x * gv.x + sv.y * gv.y + sv.z * gv.z + sv.w * gv.w;
        const int at = p * pitch(N) + n;
        store_split2(sv.x, sv.y, sS_hi + at, sS_lo + at);
        store_split2(sv.z, sv.w, sS_hi + at + 2, sS_lo + at + 2);
        store_split2(gv.x, gv.y, sG_hi + at, sG_lo + at);
        store_split2(gv.z, gv.w, sG_hi + at + 2, sG_lo + at + 2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) sred[warp] = part;
    }
    cp_async_wait_prior();  // head h's x, dy, dt
    __syncthreads();
    if (warp == 0) warp_decays(sdt, a, sdA, scum, srev);
    __syncthreads();
    const float e_c = __expf(scum[L - 1]) * (((sred[0] + sred[1]) + sred[2]) + sred[3]);

    // -- the state terms --
    // dX̄ state part: exp(rev_j) (B G^T)_j; u_j = dt_j x_j . that
    float xa[P / 8][4];
    zero(xa);
    warp_mma2<P / 8, false, false, false>(xa, sB, nullptr, pitch(N), 16 * warp, sG_hi, sG_lo,
                                          pitch(N), 0, 0, N / 16);
    scale_rows(xa, __expf(srev[r0]), __expf(srev[r1]));
    {
      float d0, d1;
      row_dots(xa, sx, pitch(P), r0, &d0, &d1);
      if (q == 0) {
        su[r0] = sdt[r0] * d0;
        su[r1] = sdt[r1] * d1;
      }
    }
    // dC off-diagonal part: exp(cum_i) (dy Sp)_i; r_i = C_i . that
    {
      float t[N / 8][4];
      zero(t);
      warp_mma2<N / 8, false, true, false>(t, sdy, nullptr, pitch(P), 16 * warp, sS_hi, sS_lo,
                                           pitch(N), 0, 0, P / 16);
      scale_rows(t, __expf(scum[r0]), __expf(scum[r1]));
      float d0, d1;
      row_dots(t, sC, pitch(N), r0, &d0, &d1);
      if (q == 0) {
        sr[r0] = d0;
        sr[r1] = d1;
      }
      add_into(dcs, t);
      // dB state part: exp(rev_j) dt_j (x G)_j
      zero(t);
      warp_mma2<N / 8, false, true, false>(t, sx, nullptr, pitch(P), 16 * warp, sG_hi, sG_lo,
                                           pitch(N), 0, 0, P / 16);
      scale_rows(t, __expf(srev[r0]) * sdt[r0], __expf(srev[r1]) * sdt[r1]);
      add_into(dbs, t);
    }
    __syncthreads();  // Sp and G are consumed: uni now takes W and dCB

    // -- the in-chunk terms --
    // dy x^T and C B^T in two halves of 32 columns, right half first (fewer
    // live registers); a half wholly above the warp's rows is all zeros
    {
      float s0 = 0.f, s1 = 0.f;  // the exponents' running sums, right to left
#pragma unroll
      for (int ch = 1; ch >= 0; --ch) {
        float s[L / 16][4], cb[L / 16][4];  // dy x^T and C B^T, rows i, columns 32 ch + 8 nt'
        zero(s);
        zero(cb);
        if (32 * ch <= 16 * warp + 15) {
          warp_mma<L / 16, false, false>(s, sdy, pitch(P), 16 * warp, sx, pitch(P), 32 * ch, 0,
                                         P / 16);
          warp_mma<L / 16, false, false>(cb, sC, pitch(N), 16 * warp, sB, pitch(N), 32 * ch, 0,
                                         N / 16);
        }
#pragma unroll
        for (int nl = L / 16 - 1; nl >= 0; --nl) {
          const int nt = (L / 16) * ch + nl, j = 8 * nt + 2 * q;
          float t[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
          if (nt <= 2 * warp + 1) exponents(sdA, nt, r0, r1, q, s0, s1, t[0], t[1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = half ? r1 : r0;
            const float e0 = j <= i ? __expf(t[half][0]) : 0.f;
            const float e1 = j + 1 <= i ? __expf(t[half][1]) : 0.f;
            const float d0 = s[nl][2 * half] * sdt[j] * e0;
            const float d1 = s[nl][2 * half + 1] * sdt[j + 1] * e1;
            const float c0 = cb[nl][2 * half], c1 = cb[nl][2 * half + 1];
            sQ[i * EP + j] = d0 * c0;
            sQ[i * EP + j + 1] = d1 * c1;
            store_split2(c0 * e0, c1 * e1, sW_hi + i * pitch(L) + j, sW_lo + i * pitch(L) + j);
            store_split2(d0, d1, sD_hi + i * pitch(L) + j, sD_lo + i * pitch(L) + j);
          }
        }
      }
    }
    __syncthreads();
    if (tid < L) {
      // T_m = sum_{i >= m > j} Q_ij: row prefix sums (Z_im = sum_{j<m} Q_ij),
      // then column sums over i >= m; fixed order, no cancellation
      const int i = tid;
      float acc = 0.f;
      float* row = sQ + i * EP;
      for (int m = 0; m < L; ++m) {
        const float v = row[m];
        row[m] = acc;
        acc += v;
      }
      asm volatile("bar.sync 1, 64;\n" ::: "memory");
      const int m = tid;
      float t = 0.f;
      for (int k = L - 1; k >= 0; --k)
        if (k >= m) t += sQ[k * EP + m];
      sT[m] = t;
    }
    // dX̄ += W^T dy (rows j; i >= j: k16 blocks kk >= warp)
    warp_mma2<P / 8, true, true, true>(xa, sW_hi, sW_lo, pitch(L), 16 * warp, sdy, nullptr,
                                       pitch(P), 0, warp, L / 16);
    {
      float d0, d1;
      row_dots(xa, sx, pitch(P), r0, &d0, &d1);
      if (q == 0) {
        sddx[r0] = d0;
        sddx[r1] = d1;
      }
      bf16* dxb = dx + (row_c + h) * P;
      const float t0v = sdt[r0], t1v = sdt[r1];
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int p = 8 * nt + 2 * q;
        if (r0 < nv)
          *reinterpret_cast<__nv_bfloat162*>(dxb + r0 * rs + p) =
              __floats2bfloat162_rn(xa[nt][0] * t0v, xa[nt][1] * t0v);
        if (r1 < nv)
          *reinterpret_cast<__nv_bfloat162*>(dxb + r1 * rs + p) =
              __floats2bfloat162_rn(xa[nt][2] * t1v, xa[nt][3] * t1v);
      }
    }
    // dC += dCB B (rows i; j <= i: kk <= warp); dB += dCB^T C (rows j; kk >= warp)
    warp_mma2<N / 8, false, true, true>(dcs, sD_hi, sD_lo, pitch(L), 16 * warp, sB, nullptr,
                                        pitch(N), 0, 0, warp + 1);
    warp_mma2<N / 8, true, true, true>(dbs, sD_hi, sD_lo, pitch(L), 16 * warp, sC, nullptr,
                                       pitch(N), 0, warp, L / 16);
    __syncthreads();
    // g_m = T_m + sum_{i>=m} r_i + sum_{l<m} u_l + e; ddt = dX̄.x + A g
    if (tid < L) {
      const int m = tid;
      float rs = 0.f, us = 0.f;
      for (int k = L - 1; k >= 0; --k)
        if (k >= m) rs += sr[k];
      for (int k = 0; k < L; ++k)
        if (k < m) us += su[k];
      const float gm = ((sT[m] + rs) + us) + e_c;
      if (m < nv) ddt[(static_cast<size_t>(b) * S + t0 + m) * H + h] = sddx[m] + a * gm;
      sgd[m] = sdt[m] * gm;
      asm volatile("bar.sync 1, 64;\n" ::: "memory");
      if (m == 0) {
        double s = 0.0;
        for (int k = 0; k < L; ++k) s += static_cast<double>(sgd[k]);
        dA_part[chunk] = s;
      }
    }
  }
  // this CTA's dB and dC, summed over its heads: part[0 or 1][group][b][t][n]
  const size_t plane = static_cast<size_t>(gridDim.y) * gridDim.z * S * N;
  float* pc = dBC_part + plane + ((static_cast<size_t>(blockIdx.y) * gridDim.z + b) * S + t0) * N;
  float* pb = dBC_part + ((static_cast<size_t>(blockIdx.y) * gridDim.z + b) * S + t0) * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int n = 8 * nt + 2 * q;
    if (r0 < nv) {
      *reinterpret_cast<float2*>(pc + r0 * N + n) = make_float2(dcs[nt][0], dcs[nt][1]);
      *reinterpret_cast<float2*>(pb + r0 * N + n) = make_float2(dbs[nt][0], dbs[nt][1]);
    }
    if (r1 < nv) {
      *reinterpret_cast<float2*>(pc + r1 * N + n) = make_float2(dcs[nt][2], dcs[nt][3]);
      *reinterpret_cast<float2*>(pb + r1 * N + n) = make_float2(dbs[nt][2], dbs[nt][3]);
    }
  }
}

// dB[b, t, n] = sum over head groups of the partials (and dC), in order
__global__ void ssd_chunk_bc_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dB,
                                        bf16* __restrict__ dC, int groups, size_t rows_n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows_n) return;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < groups; ++k) {
    sb += part[k * rows_n + i];
    sc += part[(groups + k) * rows_n + i];
  }
  dB[i] = __float2bfloat16(sb);
  dC[i] = __float2bfloat16(sc);
}

// dA[h] = sum over (b, chunk) of the per-chunk partials, in order, in fp64
__global__ void ssd_chunk_dA_sum_kernel(const double* __restrict__ part,
                                        float* __restrict__ dA, int BC, int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    double s = 0.0;
    for (int k = 0; k < BC; ++k) s += part[static_cast<size_t>(k) * H + h];
    dA[h] = static_cast<float>(s);
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int P, int N>
int launch_fwd(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
               const float* s0, bf16* y, float* sT, float* Sp, float* tot, int B, int S, int H,
               cudaStream_t st) {
  const int nc = (S + L - 1) / L;
  const dim3 grid(nc, (H + HG - 1) / HG, B);
  const size_t sm1 = StateSmem<P, N>().total, sm3 = OutSmem<P, N>().total;
  cudaError_t e = prepare(ssd_chunk_state_kernel<P, N>, sm1);
  if (e == cudaSuccess) e = prepare(ssd_chunk_out_kernel<P, N>, sm3);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_state_kernel<P, N><<<grid, THREADS, sm1, st>>>(x, dt, A, Bm, Sp, tot, S, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 pass_grid((P * N / 4 + THREADS - 1) / THREADS, B * H);
  ssd_state_pass_kernel<false><<<pass_grid, THREADS, 0, st>>>(Sp, tot, s0, sT, nc, H, P * N);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_out_kernel<P, N><<<grid, THREADS, sm3, st>>>(x, dt, A, Bm, Cm, Sp, y, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_bwd(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
               const bf16* dy, const float* dsT, const float* Sp, const float* tot, bf16* dx,
               float* ddt, float* dA, bf16* dBm, bf16* dCm, float* ds0, float* Gbuf,
               float* dBC_part, double* dA_part, int B, int S, int H, cudaStream_t st) {
  const int nc = (S + L - 1) / L, groups = (H + HG - 1) / HG;
  const dim3 grid(nc, groups, B);
  const size_t sm1 = DstateSmem<P, N>().total, sm3 = BwdSmem<P, N>().total;
  cudaError_t e = prepare(ssd_chunk_dstate_kernel<P, N>, sm1);
  if (e == cudaSuccess) e = prepare(ssd_chunk_bwd_kernel<P, N>, sm3);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_dstate_kernel<P, N><<<grid, THREADS, sm1, st>>>(dy, dt, A, Cm, Gbuf, S, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 pass_grid((P * N / 4 + THREADS - 1) / THREADS, B * H);
  ssd_state_pass_kernel<true><<<pass_grid, THREADS, 0, st>>>(Gbuf, tot, dsT, ds0, nc, H, P * N);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_bwd_kernel<P, N><<<grid, THREADS, sm3, st>>>(x, dt, A, Bm, Cm, dy, Sp, Gbuf, tot, dx,
                                                     ddt, dBC_part, dA_part, S, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const size_t rows_n = static_cast<size_t>(B) * S * N;
  const unsigned sum_blocks = static_cast<unsigned>((rows_n + 255) / 256);
  ssd_chunk_bc_sum_kernel<<<sum_blocks, 256, 0, st>>>(dBC_part, dBm, dCm, groups, rows_n);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_dA_sum_kernel<<<1, 128, 0, st>>>(dA_part, dA, B * nc, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

}  // namespace

#define SSD_DISPATCH_PN(CALL)                 \
  do {                                        \
    if (P == 32 && N == 16) return CALL(32, 16); \
    if (P == 32 && N == 32) return CALL(32, 32); \
    if (P == 32 && N == 64) return CALL(32, 64); \
    if (P == 64 && N == 16) return CALL(64, 16); \
    if (P == 64 && N == 32) return CALL(64, 32); \
    if (P == 64 && N == 64) return CALL(64, 64); \
  } while (0)

// fp32 x, Bm, Cm, y: the recurrence.  P in {32, 64}, N in {16, 32, 64}.
// s0 may be NULL (zero initial state).
extern "C" int ssd_fwd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* s0, float* y, float* sT, int B, int S,
                       int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_FWD(PP, NN) launch_fwd<PP, NN>(x, dt, A, Bm, Cm, s0, y, sT, B, S, H, st)
  SSD_DISPATCH_PN(SSD_FWD);
#undef SSD_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// dsT and s0 may be NULL (zero); ds0 may be NULL (not wanted).  Scratch:
// dB_part and dC_part (B, S, H, N) fp32, dA_part (B, H) fp64, ckpt
// (B * H, ceil(S / 8), P, N) fp32.
extern "C" int ssd_bwd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* s0, const float* dy, const float* dsT,
                       float* dx, float* ddt, float* dA, float* dB, float* dC, float* ds0,
                       float* dB_part, float* dC_part, double* dA_part, float* ckpt, int B,
                       int S, int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_BWD(PP, NN)                                                                       \
  launch_bwd<PP, NN>(x, dt, A, Bm, Cm, s0, dy, dsT, dx, ddt, dA, dB, dC, ds0, dB_part,       \
                     dC_part, dA_part, ckpt, B, S, H, st)
  SSD_DISPATCH_PN(SSD_BWD);
#undef SSD_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

using chunked::bf16;

// bf16 x, Bm, Cm, y: the chunked kernels.  s0 may be NULL.  Scratch kept for
// the backward: Sp (B, ceil(S / 64), H, P, N) fp32, the state entering each
// chunk, and tot (B, ceil(S / 64), H) fp32, each chunk's sum of dt A.
extern "C" int ssd_chunk_fwd(const void* x, const float* dt, const float* A, const void* Bm,
                             const void* Cm, const float* s0, void* y, float* sT, float* Sp,
                             float* tot, int B, int S, int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_CFWD(PP, NN)                                                                     \
  chunked::launch_fwd<PP, NN>(static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm), \
                              static_cast<const bf16*>(Cm), s0, static_cast<bf16*>(y), sT, Sp, \
                              tot, B, S, H, st)
  SSD_DISPATCH_PN(SSD_CFWD);
#undef SSD_CFWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Sp and tot as the forward left them.  dsT may be NULL (zero); ds0 may be
// NULL (not wanted).  Scratch: G (the shape of Sp) fp32, dBC_part
// (2, ceil(H / 16), B, S, N) fp32, dA_part (B, ceil(S / 64), H) fp64.
extern "C" int ssd_chunk_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                             const void* Cm, const void* dy, const float* dsT, const float* Sp,
                             const float* tot, void* dx, float* ddt, float* dA, void* dB,
                             void* dC, float* ds0, float* G, float* dBC_part, double* dA_part,
                             int B, int S, int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_CBWD(PP, NN)                                                                      \
  chunked::launch_bwd<PP, NN>(                                                                \
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),                       \
      static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy), dsT, Sp, tot,               \
      static_cast<bf16*>(dx), ddt, dA, static_cast<bf16*>(dB), static_cast<bf16*>(dC), ds0, G, \
      dBC_part, dA_part, B, S, H, st)
  SSD_DISPATCH_PN(SSD_CBWD);
#undef SSD_CBWD
  return static_cast<int>(cudaErrorInvalidValue);
}
