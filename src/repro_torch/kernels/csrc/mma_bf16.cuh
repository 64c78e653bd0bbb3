// bf16 tensor-core helpers shared by the chunked kernels (ssd_scan.cu,
// wkv6.cu): cp.async staging, ldmatrix, mma.sync m16n8k16 with fp32
// accumulators, hi + lo operand splits, and shared-memory carving.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

// pitch (bf16 elements) of a tile with `cols` columns: rows 16 bytes apart
// modulo 128, so the 8 row addresses of an ldmatrix hit distinct banks
__host__ __device__ constexpr int pitch(int cols) { return cols + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for all but the most recently committed group
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a b for one 16 x 8 x 16 step (bf16 operands, fp32 accumulator)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout (lane = 4 g + c): acc[nt][0..1] is row g, columns
// 8 nt + 2 c + {0, 1}; acc[nt][2..3] is row g + 8, the same columns.
//
// One k16 step of acc[16 x 8 NT] += a (register A fragment) * B[k0 .. k0 + 16,
// n0 .. n0 + 8 NT), B read from a shared tile stored [k][n] (BT) or [n][k].
template <int NT, bool BT>
__device__ __forceinline__ void mma_k16(float (&acc)[NT][4], const uint32_t (&a)[4],
                                        const bf16* b, int pb, int n0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt + 1 < NT; nt += 2) {
    uint32_t f[4];
    const int nb = n0 + nt * 8;
    if (BT)
      ldsm_x4_t(f, b + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pb + nb + (lane >> 4) * 8);
    else
      ldsm_x4(f, b + (nb + (lane & 7) + ((lane >> 4) << 3)) * pb + k0 + ((lane >> 3) & 1) * 8);
    mma(acc[nt], a, f[0], f[1]);
    mma(acc[nt + 1], a, f[2], f[3]);
  }
  if (NT & 1) {
    uint32_t f[2];
    const int nb = n0 + (NT - 1) * 8;
    if (BT)
      ldsm_x2_t(f, b + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pb + nb);
    else
      ldsm_x2(f, b + (nb + (lane & 7)) * pb + k0 + ((lane >> 3) & 1) * 8);
    mma(acc[NT - 1], a, f[0], f[1]);
  }
}

// acc[16 x 8 NT] += A[m0 .. m0 + 16, 16 kk_lo .. 16 kk_hi) * B: A read from a
// shared tile stored [m][k] or, with AT, [k][m]; B as in mma_k16.
template <int NT, bool AT, bool BT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* a, int pa, int m0,
                                         const bf16* b, int pb, int n0, int kk_lo, int kk_hi) {
  const int lane = threadIdx.x & 31;
  for (int kk = kk_lo; kk < kk_hi; ++kk) {
    const int k0 = kk * 16;
    uint32_t f[4];
    if (AT)
      ldsm_x4_t(f, a + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pa + m0 + ((lane >> 3) & 1) * 8);
    else
      ldsm_x4(f, a + (m0 + (lane & 15)) * pa + k0 + (lane >> 4) * 8);
    mma_k16<NT, BT>(acc, f, b, pb, n0, k0);
  }
}

// The same product for an operand held as a hi + lo pair of bf16 tiles
// (A when SPLIT_A, else B): two passes into one accumulator.
template <int NT, bool AT, bool BT, bool SPLIT_A>
__device__ __forceinline__ void warp_mma2(float (&acc)[NT][4], const bf16* a, const bf16* a_lo,
                                          int pa, int m0, const bf16* b, const bf16* b_lo,
                                          int pb, int n0, int kk_lo, int kk_hi) {
  warp_mma<NT, AT, BT>(acc, a, pa, m0, b, pb, n0, kk_lo, kk_hi);
  if (SPLIT_A)
    warp_mma<NT, AT, BT>(acc, a_lo, pa, m0, b, pb, n0, kk_lo, kk_hi);
  else
    warp_mma<NT, AT, BT>(acc, a, pa, m0, b_lo, pb, n0, kk_lo, kk_hi);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// v = hi + lo, both bf16: the fp32 value to about 16 significant bits
__device__ __forceinline__ void split(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16(v);
  *hi = h;
  *lo = __float2bfloat16(v - __bfloat162float(h));
}

__device__ __forceinline__ uint32_t pack(bf16 lo_col, bf16 hi_col) {
  __nv_bfloat162 v;
  v.x = lo_col;
  v.y = hi_col;
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi and lo A-fragment registers of two fp32 values of adjacent columns
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi, uint32_t* lo) {
  bf16 h0, l0, h1, l1;
  split(v0, &h0, &l0);
  split(v1, &h1, &l1);
  *hi = pack(h0, h1);
  *lo = pack(l0, l1);
}

__device__ __forceinline__ void store_split2(float v0, float v1, bf16* hi, bf16* lo) {
  uint32_t h, l;
  split2(v0, v1, &h, &l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

// Offsets (bytes) of a kernel's shared buffers, each 128-byte aligned.
struct Carve {
  size_t off = 0;
  template <typename T>
  __host__ __device__ constexpr size_t take(size_t count) {
    const size_t at = off;
    off = (off + count * sizeof(T) + 127) & ~size_t(127);
    return at;
  }
};

}  // namespace tc
}  // namespace
