// Flash-attention forward for Hopper (sm_90a): blocked online-softmax
// attention, causal or not, optional sliding window, GQA by indexing.
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
// wgmma, TMA or warp specialisation yet.
//
// C interface (loaded with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch; it launches on the given stream and
// does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

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
               __nv_bfloat16* __restrict__ o, Geom g, float scale_log2) {
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
              const float* __restrict__ v, float* __restrict__ o, Geom g,
              float scale) {
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

  float acc[FROWS][D / 32];
  float m[FROWS], l[FROWS];
#pragma unroll
  for (int i = 0; i < FROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) acc[i][j] = 0.f;
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
      for (int j = 0; j < D / 32; ++j) acc[i][j] *= alpha;
      for (int c = 0; c < FBN; ++c) {
        const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
        for (int j = 0; j < D / 32; ++j)
          acc[i][j] = fmaf(pc, Vs[c][lane + 32 * j], acc[i][j]);
      }
    }
  }

  float* ob = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int i = 0; i < FROWS; ++i) {
    const int row = q0 + warp * FROWS + i;
    if (row >= g.Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      ob[row * g.o_ss + lane + 32 * j] = acc[i][j] * inv;
  }
}

template <int D>
void launch(int dtype, const void* q, const void* k, const void* v, void* o,
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
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), g,
        scale * LOG2E);
  } else {
    dim3 grid((g.Sq + FBM - 1) / FBM, B * g.H);
    flash_fwd_f32<D><<<grid, 128, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), g, scale);
  }
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int KV, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, void* stream) {
  Geom g{Sq,   Skv,  H,    KV,   q_sb, q_ss, q_sh,   k_sb,  k_ss,
         k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: launch<32>(dtype, q, k, v, o, B, g, s); break;
    case 64: launch<64>(dtype, q, k, v, o, B, g, s); break;
    case 128: launch<128>(dtype, q, k, v, o, B, g, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
