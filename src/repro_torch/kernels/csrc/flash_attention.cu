// Flash attention for Hopper (sm_90a), forward and backward: blocked
// online-softmax attention, causal or not, optional sliding window, GQA by
// indexing.  d in {32, 64, 80, 128}.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (wrapper flash_attention, pallas_call at :132).  Same function: fp32 m/l
// statistics and output accumulator, the finite NEG_INF = -1e30 mask value,
// and the l == 0 -> 1 guard.  Unlike the Pallas kernel it takes any
// Sq, Skv >= 1: rows and keys past the ends are zero-filled and masked.
//
// What bounds it on an H100: at prefill shapes attention does
// 4*Sq*Skv*d*H/2 (causal) multiply-adds over O(S*H*d) bytes, far above the
// card's ~295 operations per byte, so the bound is the tensor cores'
// 989 TFLOP/s in bf16.  The design follows from that:
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulate).
//     One CTA of 4 warps owns a 64-row query tile; each warp owns 16 rows
//     and keeps its Q fragments, the S tile, m/l and the O accumulator in
//     registers.  The S accumulator's register layout is exactly the A
//     operand layout of the P.V product, so P never touches shared memory.
//   * K and V tiles of 64 keys are staged in shared memory, row-major with
//     rows padded by 8 elements so the fragment loads are conflict free.
//     Two stages: cp.async fetches tile t + 1 while tile t is multiplied.
//     V's B fragments come from ldmatrix.trans, so V needs no transposed
//     copy.
//   * The Pallas kernel's sequential kv grid axis is the loop inside the
//     CTA; tiles above the causal diagonal, or entirely left of the
//     window, are never loaded.  Causal query tiles start heaviest first,
//     so the short ones fill the tail of the grid.
//   * q/k/v/o are read in their (B, S, heads, d) layout through strides;
//     query head h reads kv head h / (H / KV).  Nothing is repeated or
//     transposed in device memory.
// fp32 inputs take a plain FMA kernel (16-row tiles, 32-key tiles): the
// tensor cores' TF32 would miss the fp32 tolerance.  Neither kernel uses
// wgmma, TMA or warp specialisation yet.  When asked (a non-NULL `lse`),
// the forward also writes each row's log-sum-exp of the scaled scores,
// fp32 (B, H, Sq), for the backward; a row that saw no key gets +inf.
//
// Backward (the TPU kernel has none): with P = exp(s - LSE) recomputed
// from the forward's LSE, D = rowsum(dO ⊙ O) from a pre-pass, and
// dS = P ⊙ (dO V^T - D):
//   * flash_bwd_dkdv: one CTA per (b, kv head, 64-key tile) keeps K, V and
//     the dK, dV accumulators (fp32) and loops over the group's query heads
//     and the 64-row query tiles that can see the tile, so the GQA sum over
//     the group is taken in a fixed order: no atomics.
//   * flash_bwd_dq: one CTA per (b, head, 64-row query tile) loops over the
//     key tiles it can see and accumulates dQ.
// Both run on plain fp32 FMAs from tiles converted to fp32 in shared
// memory (rows padded to an odd pitch, 4 x 4 register blocks per thread),
// for bf16 and fp32 alike; tiles outside the causal window are skipped as
// in the forward.  The backward is bound by operations (2.5x the forward's
// products); the FMA form runs far below the tensor cores' rate, and
// mma.sync/wgmma for it is later work.  The finite NEG_INF is kept: in a
// live row a masked entry gives exp(-1e30 - LSE) = 0.
//
// C interface (loaded with ctypes): flash_attention_fwd and
// flash_attention_bwd return cudaGetLastError() after the launches; they
// launch on the given stream and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Geom {
  int Sq, Skv, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
};

// First key tile (multiple of `bn`) and one past the last key this query
// tile [q0, q0 + bm) can see.
__device__ __forceinline__ void kv_range(const Geom& g, int q0, int bm, int bn,
                                         int* begin, int* end) {
  int lo = 0;
  if (g.window > 0) lo = max(0, q0 - g.window + 1);
  int hi = g.Skv;
  if (g.causal) hi = min(g.Skv, q0 + bm);
  *begin = (lo / bn) * bn;
  *end = hi;
}

__device__ __forceinline__ bool live(const Geom& g, int row, int col) {
  bool ok = col < g.Skv;
  if (g.causal) ok = ok && col <= row;
  if (g.window > 0) ok = ok && col > row - g.window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64;        // query rows per CTA (4 warps x 16)
constexpr int BN = 64;        // keys per tile
constexpr int PAD = 8;        // bf16 elements of row padding in shared memory
constexpr int STAGES = 2;     // K/V tiles in flight

template <int D>
constexpr int bf16_smem_bytes() {
  return STAGES * 2 * BN * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 tiles, transposed on the way into registers: lane l gives
// the address of row l % 8 of tile l / 8; each thread receives rows 2t and
// 2t + 1 of column g of every tile, the B-operand layout of m16n8k16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !valid (the source address must still be a legal one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, Geom g,
               float scale_log2) {
  // [STAGES] K tiles then [STAGES] V tiles, each BN x (D + PAD), row-major
  extern __shared__ __align__(16) unsigned char smem[];
  using Tile = __nv_bfloat16[BN][D + PAD];
  Tile* Ks = reinterpret_cast<Tile*>(smem);
  Tile* Vs = Ks + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;  // fragment row group, thread in group
  // causal tiles near the end of the sequence carry the most keys: start
  // them first so the short ones fill the tail of the grid
  const int qt = g.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BM;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int kvh = h / (g.H / g.KV);

  const __nv_bfloat16* qb = q + b * g.q_sb + h * g.q_sh;
  const __nv_bfloat16* kb = k + b * g.k_sb + kvh * g.k_sh;
  const __nv_bfloat16* vb = v + b * g.v_sb + kvh * g.v_sh;

  int begin, end;
  kv_range(g, q0, BM, BN, &begin, &end);
  const int n_tiles = end > begin ? (end - begin + BN - 1) / BN : 0;

  auto load_tile = [&](int stage, int n0) {
    for (int i = tid; i < BN * D / 8; i += 128) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const int key = n0 + row;
      const bool in = key < g.Skv;
      const long long src = (in ? key : 0);
      cp_async16(&Ks[stage][row][col], kb + src * g.k_ss + col, in);
      cp_async16(&Vs[stage][row][col], vb + src * g.v_ss + col, in);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, begin);

  // rows this thread owns in the accumulators: r0 and r0 + 8
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;

  // Q fragments (A operand of Q.K^T), straight from global memory
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tg;
    qa[kk][0] = r0 < g.Sq ? ld32(qb + r0 * g.q_ss + c) : 0u;
    qa[kk][1] = r1 < g.Sq ? ld32(qb + r1 * g.q_ss + c) : 0u;
    qa[kk][2] = r0 < g.Sq ? ld32(qb + r0 * g.q_ss + c + 8) : 0u;
    qa[kk][3] = r1 < g.Sq ? ld32(qb + r1 * g.q_ss + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = begin + t * BN;
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile(st ^ 1, n0 + BN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t visible to every warp

    // S = Q K^T for this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = &Ks[st][nt * 8 + gr][kk * 16 + 2 * tg];
        mma_bf16(s[nt], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // scale into the log2 domain, mask, and take the tile's row maxima
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = n0 + nt * 8 + 2 * tg + (e & 1);
        const float x = s[nt][e] * scale_log2;
        s[nt][e] = live(g, row, col) ? x : NEG_INF;
        mc[e >> 1] = fmaxf(mc[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float mn = fmaxf(m[r], mc[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }

    // P = exp2(S - m), packed straight into A fragments of P.V
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m[0]), p1 = exp2f(s[nt][1] - m[0]);
      const float p2 = exp2f(s[nt][2] - m[1]), p3 = exp2f(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O = alpha * O + P V; V's B fragments come from ldmatrix.trans, two
    // 8-column slices of d per instruction
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: tile, row within it
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &Vs[st][kc * 16 + (mi & 1) * 8 + mr][(dt + (mi >> 1)) * 8]);
        mma_bf16(acc[dt], pa[kc], bv[0], bv[1]);
        mma_bf16(acc[dt + 1], pa[kc], bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage st is free for the prefetch of tile t + 2
  }

  // finalize: full row sums across the 4 threads of a row group
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r ? r1 : r0;
    if (lse && tg == 0 && row < g.Sq)  // m is in the log2 domain
      lse[static_cast<long long>(bh) * g.Sq + row] =
          l[r] == 0.f ? __int_as_float(0x7f800000) : (m[r] + log2f(l[r])) * LN2;
    if (l[r] == 0.f) l[r] = 1.f;
    l[r] = 1.f / l[r];
  }
  __nv_bfloat16* ob = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * tg;
    if (r0 < g.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * g.o_ss + c) =
          pack_bf16(acc[dt][0] * l[0], acc[dt][1] * l[0]);
    if (r1 < g.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * g.o_ss + c) =
          pack_bf16(acc[dt][2] * l[1], acc[dt][3] * l[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int FBM = 16;  // query rows per CTA (4 warps x 4 rows)
constexpr int FBN = 32;  // keys per tile (one per lane)
constexpr int FROWS = FBM / 4;

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Geom g, float scale) {
  __shared__ float Qs[FBM][D];
  __shared__ float Ks[FBN][D + 1];
  __shared__ float Vs[FBN][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FBM;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int kvh = h / (g.H / g.KV);

  const float* qb = q + b * g.q_sb + h * g.q_sh;
  const float* kb = k + b * g.k_sb + kvh * g.k_sh;
  const float* vb = v + b * g.v_sb + kvh * g.v_sh;

  for (int i = tid; i < FBM * D; i += 128) {
    const int row = i / D, col = i % D;
    Qs[row][col] = q0 + row < g.Sq ? qb[(q0 + row) * g.q_ss + col] : 0.f;
  }

  constexpr int LC = (D + 31) / 32;  // output columns per lane
  float acc[FROWS][LC];
  float m[FROWS], l[FROWS];
#pragma unroll
  for (int i = 0; i < FROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < LC; ++j) acc[i][j] = 0.f;
  }

  int begin, end;
  kv_range(g, q0, FBM, FBN, &begin, &end);

  for (int n0 = begin; n0 < end; n0 += FBN) {
    __syncthreads();
    for (int i = tid; i < FBN * D; i += 128) {
      const int row = i / D, col = i % D;
      const int key = n0 + row;
      const bool in = key < g.Skv;
      Ks[row][col] = in ? kb[key * g.k_ss + col] : 0.f;
      Vs[row][col] = in ? vb[key * g.v_ss + col] : 0.f;
    }
    __syncthreads();

    const int col = n0 + lane;  // this lane's key
#pragma unroll
    for (int i = 0; i < FROWS; ++i) {
      const int lr = warp * FROWS + i;
      const int row = q0 + lr;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(Qs[lr][c], Ks[lane][c], s);
      s = live(g, row, col) ? s * scale : NEG_INF;

      float mc = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      const float p = expf(s - mn);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < LC; ++j) acc[i][j] *= alpha;
      for (int c = 0; c < FBN; ++c) {
        const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
        for (int j = 0; j < LC; ++j)
          if (lane + 32 * j < D) acc[i][j] = fmaf(pc, Vs[c][lane + 32 * j], acc[i][j]);
      }
    }
  }

  float* ob = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int i = 0; i < FROWS; ++i) {
    const int row = q0 + warp * FROWS + i;
    if (row >= g.Sq) continue;
    if (lse && lane == 0)
      lse[static_cast<long long>(bh) * g.Sq + row] =
          l[i] == 0.f ? __int_as_float(0x7f800000) : m[i] + logf(l[i]);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < LC; ++j)
      if (lane + 32 * j < D) ob[row * g.o_ss + lane + 32 * j] = acc[i][j] * inv;
  }
}

template <int D>
void launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
            int B, const Geom& g, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (dtype == 1) {
    constexpr int smem = bf16_smem_bytes<D>();
    static bool configured = false;  // once per head dim (one device)
    if (!configured) {
      cudaFuncSetAttribute(flash_fwd_bf16<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      configured = true;
    }
    dim3 grid((g.Sq + BM - 1) / BM, B * g.H);
    flash_fwd_bf16<D><<<grid, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, g,
        scale * LOG2E);
  } else {
    dim3 grid((g.Sq + FBM - 1) / FBM, B * g.H);
    flash_fwd_f32<D><<<grid, 128, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, g, scale);
  }
}

// ---------------------------------------------------------------------------
// backward: FMA kernels over fp32 tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int BT = 64;        // query rows and keys per tile
constexpr int BTHREADS = 256;  // 16 x 16 threads, each a 4 x 4 block of a 64 x 64 tile

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// D[b, h, i] = sum_c dO[b, i, h, c] O[b, i, h, c]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ Dd,
              long long rows, int Sq, int H, int D) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += ld_f(o + r * D + c) * ld_f(dO + r * D + c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = r % H, bi = r / H;  // r = (b Sq + i) H + h
    const long long b = bi / Sq, i = bi % Sq;
    Dd[(b * H + h) * Sq + i] = acc;
  }
}

// rows [r0, r0 + BT) of a (rows, ld)-strided tensor, as fp32, zero past `limit`
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const T* __restrict__ base,
                                          long long ld, int r0, int limit) {
  for (int i = threadIdx.x; i < BT * D; i += BTHREADS) {
    const int r = i / D, c = i % D;
    dst[r][c] = r0 + r < limit ? ld_f(base + (r0 + r) * ld + c) : 0.f;
  }
}

template <int D>
constexpr int bwd_smem_bytes() {  // four (BT, D + 1) tiles, two (BT, BT + 1), two rows
  return (4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT) * static_cast<int>(sizeof(float));
}

// S = Q K^T and dP = dO V^T for rows ty + 16 ii and keys tx + 16 jj, then
// P = exp2(S scale_log2 - lse2) on live entries (0 elsewhere) and
// dS = P (dP - D); P (when wanted) and dS go to shared memory.
template <int D>
__device__ __forceinline__ void p_and_ds(float (*Qs)[D + 1], float (*dOs)[D + 1],
                                         float (*Ks)[D + 1], float (*Vs)[D + 1],
                                         const float* lse2, const float* Dr,
                                         float (*Ps)[BT + 1], float (*dSs)[BT + 1],
                                         const Geom& g, int q0, int k0, float scale_log2) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      qv[x] = Qs[ty + 16 * x][c];
      ov[x] = dOs[ty + 16 * x][c];
      kv[x] = Ks[tx + 16 * x][c];
      vv[x] = Vs[tx + 16 * x][c];
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
        dp[ii][jj] = fmaf(ov[ii], vv[jj], dp[ii][jj]);
      }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = ty + 16 * ii;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = tx + 16 * jj;
      const float p = live(g, q0 + i, k0 + j) ? exp2f(s[ii][jj] * scale_log2 - lse2[i]) : 0.f;
      if (Ps) Ps[i][j] = p;
      dSs[i][j] = p * (dp[ii][jj] - Dr[i]);
    }
  }
}

// the query rows' LSE (log2 domain; +inf past Sq, so P = 0 there) and D
__device__ __forceinline__ void load_rows_stats(float* lse2, float* Dr, const float* lse,
                                               const float* Dd, long long bh, int q0, int Sq) {
  for (int i = threadIdx.x; i < BT; i += BTHREADS) {
    const bool in = q0 + i < Sq;
    lse2[i] = in ? lse[bh * Sq + q0 + i] * LOG2E : __int_as_float(0x7f800000);
    Dr[i] = in ? Dd[bh * Sq + q0 + i] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BTHREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dO, const float* __restrict__ lse,
               const float* __restrict__ Dd, T* __restrict__ dk, T* __restrict__ dv, Geom g,
               float scale) {
  extern __shared__ __align__(16) float bsm[];
  using Tile = float[D + 1];
  using Sq_t = float[BT + 1];
  Tile* Qs = reinterpret_cast<Tile*>(bsm);
  Tile* dOs = Qs + BT;
  Tile* Ks = dOs + BT;
  Tile* Vs = Ks + BT;
  Sq_t* Ps = reinterpret_cast<Sq_t*>(Vs + BT);
  Sq_t* dSs = Ps + BT;
  float* lse2 = reinterpret_cast<float*>(dSs + BT);
  float* Dr = lse2 + BT;

  constexpr int CD = D / 16;  // dK, dV columns per thread
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BT;
  const int b = blockIdx.y / g.KV, kvh = blockIdx.y % g.KV;
  const int G = g.H / g.KV;
  load_tile<T, D>(Ks, k + b * g.k_sb + kvh * g.k_sh, g.k_ss, k0, g.Skv);
  load_tile<T, D>(Vs, v + b * g.k_sb + kvh * g.k_sh, g.k_ss, k0, g.Skv);

  float dK[4][CD] = {}, dV[4][CD] = {};
  // query rows that can see a key of [k0, k0 + BT)
  const int q_begin = g.causal ? k0 : 0;
  const int q_end = g.window > 0 ? min(g.Sq, k0 + BT - 1 + g.window) : g.Sq;
  const float scale_log2 = scale * LOG2E;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const long long bh = static_cast<long long>(b) * g.H + h;
    for (int q0 = q_begin; q0 < q_end; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(Qs, q + b * g.q_sb + h * g.q_sh, g.q_ss, q0, g.Sq);
      load_tile<T, D>(dOs, dO + b * g.q_sb + h * g.q_sh, g.q_ss, q0, g.Sq);
      load_rows_stats(lse2, Dr, lse, Dd, bh, q0, g.Sq);
      __syncthreads();
      p_and_ds<D>(Qs, dOs, Ks, Vs, lse2, Dr, Ps, dSs, g, q0, k0, scale_log2);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys tx + 16 jj, columns ty + 16 cc
      for (int i = 0; i < BT; ++i) {
        float pj[4], sj[4], oc[CD], qc[CD];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pj[x] = Ps[i][tx + 16 * x];
          sj[x] = dSs[i][tx + 16 * x];
        }
#pragma unroll
        for (int cc = 0; cc < CD; ++cc) {
          oc[cc] = dOs[i][ty + 16 * cc];
          qc[cc] = Qs[i][ty + 16 * cc];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int cc = 0; cc < CD; ++cc) {
            dV[jj][cc] = fmaf(pj[jj], oc[cc], dV[jj][cc]);
            dK[jj][cc] = fmaf(sj[jj], qc[cc], dK[jj][cc]);
          }
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int key = k0 + tx + 16 * jj;
    if (key >= g.Skv) continue;
    const long long off = b * g.k_sb + key * g.k_ss + kvh * g.k_sh;
#pragma unroll
    for (int cc = 0; cc < CD; ++cc) {
      st_f(dk + off + ty + 16 * cc, dK[jj][cc] * scale);
      st_f(dv + off + ty + 16 * cc, dV[jj][cc]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BTHREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dO, const float* __restrict__ lse,
             const float* __restrict__ Dd, T* __restrict__ dq, Geom g, float scale) {
  extern __shared__ __align__(16) float bsm[];
  using Tile = float[D + 1];
  using Sq_t = float[BT + 1];
  Tile* Qs = reinterpret_cast<Tile*>(bsm);
  Tile* dOs = Qs + BT;
  Tile* Ks = dOs + BT;
  Tile* Vs = Ks + BT;
  Sq_t* dSs = reinterpret_cast<Sq_t*>(Vs + BT) + BT;  // the dkdv layout's dS slot
  float* lse2 = reinterpret_cast<float*>(dSs + BT);
  float* Dr = lse2 + BT;

  constexpr int CD = D / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / g.H, h = blockIdx.y % g.H;
  const int kvh = h / (g.H / g.KV);
  const long long bh = blockIdx.y;
  load_tile<T, D>(Qs, q + b * g.q_sb + h * g.q_sh, g.q_ss, q0, g.Sq);
  load_tile<T, D>(dOs, dO + b * g.q_sb + h * g.q_sh, g.q_ss, q0, g.Sq);
  load_rows_stats(lse2, Dr, lse, Dd, bh, q0, g.Sq);

  float dQ[4][CD] = {};
  int begin, end;
  kv_range(g, q0, BT, BT, &begin, &end);
  const float scale_log2 = scale * LOG2E;
  for (int k0 = begin; k0 < end; k0 += BT) {
    __syncthreads();
    load_tile<T, D>(Ks, k + b * g.k_sb + kvh * g.k_sh, g.k_ss, k0, g.Skv);
    load_tile<T, D>(Vs, v + b * g.k_sb + kvh * g.k_sh, g.k_ss, k0, g.Skv);
    __syncthreads();
    p_and_ds<D>(Qs, dOs, Ks, Vs, lse2, Dr, nullptr, dSs, g, q0, k0, scale_log2);
    __syncthreads();
    // dQ += dS K: rows tx + 16 ii, columns ty + 16 cc
    for (int j = 0; j < BT; ++j) {
      float si[4], kc[CD];
#pragma unroll
      for (int x = 0; x < 4; ++x) si[x] = dSs[tx + 16 * x][j];
#pragma unroll
      for (int cc = 0; cc < CD; ++cc) kc[cc] = Ks[j][ty + 16 * cc];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int cc = 0; cc < CD; ++cc) dQ[ii][cc] = fmaf(si[ii], kc[cc], dQ[ii][cc]);
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = q0 + tx + 16 * ii;
    if (row >= g.Sq) continue;
    const long long off = b * g.q_sb + row * g.q_ss + h * g.q_sh;
#pragma unroll
    for (int cc = 0; cc < CD; ++cc) st_f(dq + off + ty + 16 * cc, dQ[ii][cc] * scale);
  }
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dO,
               const float* lse, void* dq, void* dk, void* dv, float* Dd, int B,
               const Geom& g, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const long long rows = static_cast<long long>(B) * g.Sq * g.H;
  flash_bwd_dot<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), Dd, rows, g.Sq, g.H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dOt = static_cast<const T*>(dO);
  flash_bwd_dkdv<T, D><<<dim3((g.Skv + BT - 1) / BT, B * g.KV), BTHREADS, smem, stream>>>(
      qt, kt, vt, dOt, lse, Dd, static_cast<T*>(dk), static_cast<T*>(dv), g, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq<T, D><<<dim3((g.Sq + BT - 1) / BT, B * g.H), BTHREADS, smem, stream>>>(
      qt, kt, vt, dOt, lse, Dd, static_cast<T*>(dq), g, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse may be NULL (not wanted): fp32 (B, H, Sq) when given.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
    int Sq, int Skv, int H, int KV, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, void* stream) {
  Geom g{Sq,   Skv,  H,    KV,   q_sb, q_ss, q_sh,   k_sb,  k_ss,
         k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: launch<32>(dtype, q, k, v, o, lse, B, g, s); break;
    case 64: launch<64>(dtype, q, k, v, o, lse, B, g, s); break;
    case 80: launch<80>(dtype, q, k, v, o, lse, B, g, s); break;
    case 128: launch<128>(dtype, q, k, v, o, lse, B, g, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Every tensor contiguous: q, o, dO, dq (B, Sq, H, D); k, v, dk, dv
// (B, Skv, KV, D); lse from the forward and the scratch Dd fp32 (B, H, Sq).
// dq, dk, dv are written (not accumulated) in the inputs' dtype.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dO,
    const float* lse, void* dq, void* dk, void* dv, float* Dd, int dtype, int B, int Sq,
    int Skv, int H, int KV, int D, int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long qs = static_cast<long long>(H) * D, ks = static_cast<long long>(KV) * D;
  Geom g{Sq, Skv, H, KV, Sq * qs, qs, D, Skv * ks, ks, D,
         Skv * ks, ks, D, Sq * qs, qs, D, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD(T, DD) launch_bwd<T, DD>(q, k, v, o, dO, lse, dq, dk, dv, Dd, B, g, s)
  if (dtype == 0) {
    switch (D) {
      case 32: return FLASH_BWD(float, 32);
      case 64: return FLASH_BWD(float, 64);
      case 80: return FLASH_BWD(float, 80);
      case 128: return FLASH_BWD(float, 128);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return FLASH_BWD(__nv_bfloat16, 32);
      case 64: return FLASH_BWD(__nv_bfloat16, 64);
      case 80: return FLASH_BWD(__nv_bfloat16, 80);
      case 128: return FLASH_BWD(__nv_bfloat16, 128);
    }
  }
#undef FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
