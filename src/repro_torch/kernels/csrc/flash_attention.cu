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
// What bounds it on an H100: at prefill and training shapes attention does
// 4*Sq*Skv*d*H/2 (causal) multiply-adds forward and 2.5 times that backward
// over O(S*H*d) bytes, far above the card's ~295 operations per byte, so the
// bound is the tensor cores' 989 TFLOP/s in bf16.  The bf16 kernels are
// built for that:
//   * Every product runs on wgmma (fp32 accumulators).  Q, K, V and dO
//     tiles come into 128-byte-swizzled shared memory by TMA, issued by one
//     thread (or warp) of a producer warpgroup into an mbarrier ring
//     (full/empty barriers per stage); two consumer warpgroups of 64 rows
//     each run the products.  setmaxnreg moves registers from the producer
//     (40) to the consumers (232).  The consumers take turns at issuing
//     their products (ping-pong on two named barriers), so one
//     warpgroup's softmax runs while the other's products occupy the
//     tensor cores.
//   * A tile is loaded once in its natural (S, d) layout, as 64-column
//     blocks (TMA box 64 x rows).  Read K-major it is the operand of Q K^T
//     (and dO V^T); read MN-major (wgmma's transpose of 16-bit operands) it
//     is the B operand of P V, dS^T Q, P^T dO and dS K.  Nothing is
//     transposed in device memory.
//   * d = 80 is no multiple of the 64-column swizzle block: the tensor map's
//     innermost extent is d itself, tiles take two 64-column blocks and TMA
//     zero-fills columns 80..127 without reading them.  Q K^T runs exactly
//     five k16 steps, and the products with N = d use N = 80, so no padded
//     column is multiplied: only shared memory is padded (d = 32 likewise
//     takes one 64-column block half-filled).
//   * S and dP stay in registers.  P (and dS) go from the accumulator to
//     bf16 A fragments of the next wgmma without touching shared memory.
//   * Forward: 128 query rows per CTA (64 per consumer warpgroup), 128-key
//     K/V tiles in a 3-stage ring, tiles above the causal diagonal or left
//     of the window never loaded, a warpgroup skips a loaded tile that is
//     dead for all its rows, and only tiles on a mask edge evaluate the
//     mask.  S of tile t is issued with P V of tile t - 1, so the softmax
//     of tile t runs under that product.  Causal CTAs start heaviest first.
//   * Backward, with P = exp(S - LSE) recomputed from the forward's row LSE
//     and dS = P ⊙ (dO V^T - D), D = rowsum(dO ⊙ O):
//     flash_bwd_dq_sm90 runs first, one CTA per (b, head, 128-row query
//     tile): it computes and writes D for its rows, walks the key tiles it
//     sees (128 keys, 64 at d = 128) and accumulates dQ += dS K.
//     flash_bwd_dkdv_sm90, one CTA per (b, kv head, 128-key tile), keeps K
//     and V in shared memory and dK, dV in registers, and walks the group's
//     query heads and the 64-row query tiles that see the tile (Q, dO and
//     their rows' LSE and D in a 3-stage ring), computing S^T = K Q^T and
//     dP^T = V dO^T so that P^T and dS^T are A fragments of dV += P^T dO and
//     dK += dS^T Q; each iteration's dV, dK products run on while the next
//     iteration's S^T, dP^T are issued.  The GQA sum is taken in a fixed
//     order: no atomics.  dQ in its own kernel recomputes S and dP, so the
//     backward does 7 tile products where the function needs 5, and stays
//     deterministic: dq, dk, dv are bit-identical run to run.
//   * Register A fragments that an in-flight wgmma still reads are kept
//     allocated until the wait that retires it (fence_frags).
//   * A wait on an mbarrier gives up after 4 s (a lost arrival gives wrong
//     results, never a hang).
// fp32 inputs take plain FMA kernels, forward and backward (16-row and
// 64 x 64 tiles): the tensor cores' TF32 would miss the fp32 tolerance.
// When asked (a non-NULL `lse`), the forward also writes each row's
// log-sum-exp of the scaled scores, fp32 (B, H, Sq), for the backward; a row
// that saw no key gets +inf.  The finite NEG_INF is kept: in a live row a
// masked entry gives exp(-1e30 - LSE) = 0, and a tile fully masked for a
// row that has seen no key yet (a window) adds exp(0) terms that the first
// live tile wipes (alpha = 0).
//
// TMA needs 16-byte-aligned bases and strides; the tensor maps are encoded
// on every call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda) and passed as
// __grid_constant__ kernel parameters.  cuTensorMapEncodeTiled needs a
// context current on the calling thread, which a thread that has made no CUDA
// runtime call yet lacks (autograd runs a backward on a worker thread of
// its own, and the flash backward can be its first CUDA work): each C
// entry first makes current the device that holds q, and so its primary
// context.
//
// C interface (loaded with ctypes): flash_attention_fwd and
// flash_attention_bwd return the first error of the call (the CUDA error of
// a shared-memory attribute or a launch, the driver's CUresult of a refused
// tensor map), 0 if none, and flash_attention_error_site() names the step;
// they launch on the given stream and do not synchronise.

#include <cuda.h>  // CUtensorMap and its enums (types only)
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

// Keys [k0, k0 + nk) against rows [r0, r0 + nr): is every pair live, and is
// none?  (Whole-tile tests that let interior tiles skip the mask and dead
// tiles skip the work.)
__device__ __forceinline__ bool all_live(const Geom& g, int r0, int nr, int k0, int nk) {
  return k0 + nk <= g.Skv && (!g.causal || k0 + nk - 1 <= r0) &&
         (g.window <= 0 || k0 > r0 + nr - 1 - g.window);
}

__device__ __forceinline__ bool none_live(const Geom& g, int r0, int nr, int k0, int nk) {
  return (g.causal && k0 > r0 + nr - 1) || (g.window > 0 && k0 + nk - 1 <= r0 - g.window);
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma, setmaxnreg
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// phase that does not complete within 4 s is a lost arrival, a fault of the
// kernel: the wait gives up rather than hang the card, and the results are
// then wrong, which every comparison with the plain version catches.  (No
// trap: a trap in the consumers' path stops ptxas from giving them the
// registers setmaxnreg grants.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(a, parity))
    if (global_ns() - t0 > 4000000000ull) return;
}

// One box of a 4-d tensor map into shared memory; completion counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (barrier 0 is __syncthreads): a warpgroup waits at its own barrier, which
// completes when the other warpgroup has arrived there (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (issue ... wait).
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments in registers: an in-flight wgmma still reads
// them, so they must stay allocated until the wait that retires it.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

// Shared-memory matrix descriptors for tiles that TMA wrote with the
// 128-byte swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes
// apart (SBO), the tile's base 1024-byte aligned.  K-major: the contraction
// runs along the row (a k16 step adds 32 bytes to the start).  MN-major:
// the contraction runs down the rows (a k16 step adds 16 rows, 2048 bytes)
// and N crosses 64-column blocks `block_bytes` apart (LBO).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t block_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(block_bytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// D[64 x N] (+)= A B with A and B read K-major from shared memory.  Per
// thread of the warpgroup (warp w, lane l), d[i] holds row
// 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 (l % 4) + (i & 1).
// scale_d = 0 overwrites D.  The operand lists are written out: inline asm
// takes literal strings only.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d);

// D[64 x N] (+)= A B with A from registers (the m16n8k16 A fragment of
// each warp's 16 rows, the layout of D's own registers packed to bf16
// pairs) and B read MN-major from shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The S-shaped accumulator (64 x N, fp32) as bf16 A fragments of the next
// product, k16 slice by k16 slice.
template <int N>
__device__ __forceinline__ void to_a_frags(const float* s, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// Consumer warpgroups 0 and 1, producer warpgroup 2 (one thread or warp of
// it issues).  One CTA of 384 threads per SM starts at 168 registers a
// thread; setmaxnreg gives the consumers 232 and the producer 40
// (2 x 128 x 232 + 128 x 40 = 384 x 168).
constexpr int THREADS = 384;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int CONSUMER_WARPS = 8;  // arrivals that free a stage
constexpr int PRODUCER = 256;      // the thread (or warp) that issues the TMA loads

// 2^x on the special-function unit (inputs are <= 0 or -inf-like here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory columns of a tile: 64-column swizzle blocks.
template <int D>
constexpr int padded_cols() {
  return D <= 64 ? 64 : 128;
}

// ---------------------------------------------------------------------------
// bf16 forward: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int DP = padded_cols<D>(), NB = DP / 64;
  static constexpr int BM = 128, BN = 128, STAGES = 3;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int T_BYTES = BN * DP * 2;  // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * T_BYTES + 64;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, const Geom g, float scale_log2) {
  using C = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);
  unsigned char* Ks = Qs + C::Q_BYTES;  // [STAGES] tiles, then V's
  unsigned char* Vs = Ks + C::STAGES * C::T_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + C::STAGES * C::T_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  // causal tiles near the end of the sequence carry the most keys: start
  // them first so the short ones fill the tail of the grid (a head's tiles
  // stay together, so its K and V stay in L2)
  const int qt = g.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * C::BM;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int kvh = h / (g.H / g.KV);
  int begin, end;
  kv_range(g, q0, C::BM, C::BN, &begin, &end);
  const int n_tiles = end > begin ? (end - begin + C::BN - 1) / C::BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 2) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NB; ++c) tma_load(Qs + c * C::BM * 128, &tq, q_full, 64 * c, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % C::STAGES, n0 = begin + t * C::BN;
        if (t >= C::STAGES) mbar_wait(&empty[st], ((t / C::STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * C::T_BYTES);
        for (int c = 0; c < C::NB; ++c) {
          tma_load(Ks + st * C::T_BYTES + c * C::BN * 128, &tk, &full[st], 64 * c, kvh, n0, b);
          tma_load(Vs + st * C::T_BYTES + c * C::BN * 128, &tv, &full[st], 64 * c, kvh, n0, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows [q0 + 64 wg, + 64)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    const int rw = q0 + 64 * wg;
    const int r0 = rw + 16 * warp + lane / 4, r1 = r0 + 8;  // this thread's rows
    const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's partial row sums

    // Tiles dead for all of this warpgroup's rows form a prefix (left of
    // the window) and a suffix (above the diagonal): waited for and freed.
    int t_lo = 0, t_hi = n_tiles;
    while (t_lo < t_hi && none_live(g, rw, 64, begin + t_lo * C::BN, C::BN)) ++t_lo;
    while (t_hi > t_lo && none_live(g, rw, 64, begin + (t_hi - 1) * C::BN, C::BN)) --t_hi;
    // Ping-pong: tile t is one turn of each warpgroup, warpgroup 0 first.
    // A warpgroup issues its products for the turn between turn() and
    // done(), so one warpgroup's softmax runs under the other's products.
    auto turn = [&] { named_sync(1 + wg); };
    auto done = [&](int t) {
      if (wg == 0 || t < n_tiles - 1) named_arrive(2 - wg);  // the last arrival has no taker
    };
    if (wg == 1 && n_tiles > 0) named_arrive(1);
    auto skip = [&](int t) {
      turn();
      done(t);
      mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);
      if (lane == 0) mbar_arrive(&empty[t % C::STAGES]);
    };
    auto stage_addr = [&](unsigned char* base, int t) {
      return smem_u32(base + (t % C::STAGES) * C::T_BYTES);
    };
    // S = Q K_t^T for this warpgroup's 64 rows x BN keys, issued (one group)
    auto issue_s = [&](float* s, int t) {
      const uint32_t k_addr = stage_addr(Ks, t);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BN>(s, desc_k(q_addr + (kk / 4) * C::BM * 128 + (kk % 4) * 32),
                        desc_k(k_addr + (kk / 4) * C::BN * 128 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
    };
    // O += P V_t (V read MN-major: keys down the rows), issued (one group)
    auto issue_pv = [&](const uint32_t (*pa)[4], int t) {
      const uint32_t v_addr = stage_addr(Vs, t);
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], desc_mn(v_addr + kk * 2048, C::BN * 128), 1);
      wgmma_commit();
    };
    // Online softmax of tile t in place (m in the scores' own scale, c =
    // scale log2 e): S becomes P = exp2((S - m) c) in fp32, masked with
    // NEG_INF on an edge tile; m and l move on; alpha rescales O.
    auto softmax = [&](float* s, int t, float* alpha) {
      const int n0 = begin + t * C::BN;
      const bool edge = !all_live(g, rw, 64, n0, C::BN);
      if (edge) {
#pragma unroll
        for (int i = 0; i < C::BN / 2; ++i)
          if (!live(g, (i >> 1) & 1 ? r1 : r0, n0 + 8 * (i / 4) + 2 * t4 + (i & 1))) s[i] = NEG_INF;
      }
      // row maxima in four independent chains per row (two warps a
      // scheduler leave little to hide a serial chain's latency)
      float mx[2][4];  // s[4q], s[4q + 1] are row r0's, s[4q + 2], s[4q + 3] row r1's
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mx[0][q] = fmaxf(s[4 * q], s[4 * q + 1]);
        mx[1][q] = fmaxf(s[4 * q + 2], s[4 * q + 3]);
      }
#pragma unroll
      for (int q = 4; q < C::BN / 8; ++q) {
        mx[0][q % 4] = fmaxf(mx[0][q % 4], fmaxf(s[4 * q], s[4 * q + 1]));
        mx[1][q % 4] = fmaxf(mx[1][q % 4], fmaxf(s[4 * q + 2], s[4 * q + 3]));
      }
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mc[r] = fmaxf(fmaxf(m[r], fmaxf(mx[r][0], mx[r][1])), fmaxf(mx[r][2], mx[r][3]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
        alpha[r] = ex2((m[r] - mc[r]) * scale_log2);
        m[r] = mc[r];
        l[r] *= alpha[r];
      }
      // (s - m) c, not s c - m c: where a row has seen only masked
      // entries, s = m = NEG_INF must give exp2(0) exactly, as the plain
      // version's exp(NEG_INF - NEG_INF)
      float ls[2][4] = {};
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2((s[i] - m[r]) * scale_log2);
        ls[r][(i / 4) % 4] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] += (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]);
    };

    mbar_wait(q_full, 0);
    for (int t = 0; t < t_lo; ++t) skip(t);
    if (t_lo < t_hi) {
      // The loop keeps two products in flight: S of tile t runs while the
      // tensor cores finish P V of tile t - 1, and the softmax of tile t
      // overlaps that P V.
      float s[C::BN / 2];
      uint32_t pa[C::BN / 16][4];
      float alpha[2];
      mbar_wait(&full[t_lo % C::STAGES], (t_lo / C::STAGES) & 1);
      fence_regs<C::BN / 2>(s);
      turn();
      wgmma_fence();
      issue_s(s, t_lo);
      done(t_lo);
      wgmma_wait<0>();
      fence_regs<C::BN / 2>(s);
      softmax(s, t_lo, alpha);
      to_a_frags<C::BN>(s, pa);
      for (int t = t_lo + 1; t < t_hi; ++t) {
        mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);
        fence_regs<D / 2>(acc);
        fence_regs<C::BN / 2>(s);
        turn();
        wgmma_fence();
        issue_s(s, t);
        issue_pv(pa, t - 1);
        done(t);
        wgmma_wait<1>();  // S of tile t is in; P V of tile t - 1 may still run
        fence_regs<C::BN / 2>(s);
        softmax(s, t, alpha);
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
        fence_frags<C::BN / 16>(pa);
        if (lane == 0) mbar_arrive(&empty[(t - 1) % C::STAGES]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        to_a_frags<C::BN>(s, pa);
      }
      fence_regs<D / 2>(acc);
      wgmma_fence();
      issue_pv(pa, t_hi - 1);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      fence_frags<C::BN / 16>(pa);
      if (lane == 0) mbar_arrive(&empty[(t_hi - 1) % C::STAGES]);
    }
    for (int t = t_hi; t < n_tiles; ++t) skip(t);

    // finalize: full row sums across the 4 threads of a row group
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r ? r1 : r0;
      if (lse && t4 == 0 && row < g.Sq)  // m is unscaled, l in the log2 domain
        lse[static_cast<long long>(bh) * g.Sq + row] =
            l[r] == 0.f ? __int_as_float(0x7f800000) : (m[r] * scale_log2 + log2f(l[r])) * LN2;
      if (l[r] == 0.f) l[r] = 1.f;
      l[r] = 1.f / l[r];
    }
    __nv_bfloat16* ob = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (r0 < g.Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * g.o_ss + c) =
            pack_bf16(acc[4 * j] * l[0], acc[4 * j + 1] * l[0]);
      if (r1 < g.Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * g.o_ss + c) =
            pack_bf16(acc[4 * j + 2] * l[1], acc[4 * j + 3] * l[1]);
    }
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


// ---------------------------------------------------------------------------
// fp32 backward: the rowsum(dO ⊙ O) pre-pass, then FMA kernels over fp32
// tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int BT = 64;        // query rows and keys per tile
constexpr int BTHREADS = 256;  // 16 x 16 threads, each a 4 x 4 block of a 64 x 64 tile

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ void st_f(float* p, float x) { *p = x; }

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


// ---------------------------------------------------------------------------
// bf16 backward: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

template <int D>
struct Bwd {
  static constexpr int DP = padded_cols<D>(), NB = DP / 64, STAGES = 3;  // dK/dV kernel
  // dK/dV kernel: 128 keys per CTA (64 per consumer warpgroup), 64-row query tiles
  static constexpr int BK = 128, BQ = 64;
  static constexpr int KV_BYTES = BK * DP * 2;  // the K or the V tile
  static constexpr int QT_BYTES = BQ * DP * 2;  // one Q or dO tile
  static constexpr int SMEM_DKDV =
      1024 + 2 * KV_BYTES + STAGES * (2 * QT_BYTES + 2 * BQ * 4) + 64;
  // dQ kernel: 128 query rows per CTA (64 per consumer warpgroup), 64-key tiles
  static constexpr int BQ2 = 128, BK2 = D <= 80 ? 128 : 64;  // d = 128 keeps to 232 registers
  static constexpr int Q2_BYTES = BQ2 * DP * 2;  // the Q or the dO tile
  static constexpr int K2_BYTES = BK2 * DP * 2;  // one K or V tile
  static constexpr int STAGES_DQ = 1024 + 2 * Q2_BYTES + 3 * 2 * K2_BYTES + 64 <= 232448 ? 3 : 2;
  static constexpr int SMEM_DQ = 1024 + 2 * Q2_BYTES + STAGES_DQ * 2 * K2_BYTES + 64;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ Dd,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, const Geom g,
                    float scale) {
  using C = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align_1024(smem_raw);
  unsigned char* Vs = Ks + C::KV_BYTES;
  unsigned char* Qs = Vs + C::KV_BYTES;  // [STAGES] tiles, then dO's
  unsigned char* dOs = Qs + C::STAGES * C::QT_BYTES;
  float* lse2s = reinterpret_cast<float*>(dOs + C::STAGES * C::QT_BYTES);  // [STAGES][BQ]
  float* Ds = lse2s + C::STAGES * C::BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + C::STAGES * C::BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int k0 = blockIdx.x * C::BK;
  const int b = blockIdx.y / g.KV, kvh = blockIdx.y % g.KV;
  const int G = g.H / g.KV;
  // query rows that can see a key of [k0, k0 + BK)
  const int q_begin = g.causal ? k0 : 0;
  const int q_end = g.window > 0 ? min(g.Sq, k0 + C::BK - 1 + g.window) : g.Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + C::BQ - 1) / C::BQ : 0;
  const int n_it = G * n_q;  // (head of the group, query tile), head-major

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp: its stats stores, and TMA
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 2) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == PRODUCER / 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
        for (int c = 0; c < C::NB; ++c) {
          tma_load(Ks + c * C::BK * 128, &tk, kv_full, 64 * c, kvh, k0, b);
          tma_load(Vs + c * C::BK * 128, &tv, kv_full, 64 * c, kvh, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % C::STAGES;
        const int h = kvh * G + it / n_q, qq0 = q_begin + (it % n_q) * C::BQ;
        if (it >= C::STAGES) mbar_wait(&empty[st], ((it / C::STAGES) - 1) & 1);
        // the rows' LSE (log2 domain; +inf past Sq, so P = 0 there) and D
        const long long bh = static_cast<long long>(b) * g.H + h;
        for (int i = lane; i < C::BQ; i += 32) {
          const bool in = qq0 + i < g.Sq;
          lse2s[st * C::BQ + i] = in ? lse[bh * g.Sq + qq0 + i] * LOG2E : __int_as_float(0x7f800000);
          Ds[st * C::BQ + i] = in ? Dd[bh * g.Sq + qq0 + i] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * C::QT_BYTES);
          for (int c = 0; c < C::NB; ++c) {
            tma_load(Qs + st * C::QT_BYTES + c * C::BQ * 128, &tq, &full[st], 64 * c, h, qq0, b);
            tma_load(dOs + st * C::QT_BYTES + c * C::BQ * 128, &tdo, &full[st], 64 * c, h, qq0, b);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns keys [k0 + 64 wg, + 64)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    const int kw = k0 + 64 * wg;
    const int kr0 = kw + 16 * warp + lane / 4, kr1 = kr0 + 8;  // this thread's keys
    const uint32_t k_addr = smem_u32(Ks) + wg * 64 * 128;
    const uint32_t v_addr = smem_u32(Vs) + wg * 64 * 128;
    const float scale_log2 = scale * LOG2E;

    float dK[D / 2], dV[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.f;

    // A live iteration leaves dV += P^T dO and dK += dS^T Q in flight; the
    // next live iteration waits for them after issuing its own S^T and dP^T,
    // and only then frees their stage (`held`).
    int held = -1;
    uint32_t pa[C::BQ / 16][4], sa[C::BQ / 16][4];  // P^T, dS^T as A fragments
    // ping-pong of the two warpgroups' S^T and dP^T products, one turn per
    // iteration (as in the forward)
    auto turn = [&] { named_sync(1 + wg); };
    auto done = [&](int it) {
      if (wg == 0 || it < n_it - 1) named_arrive(2 - wg);
    };
    if (wg == 1 && n_it > 0) named_arrive(1);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % C::STAGES, qq0 = q_begin + (it % n_q) * C::BQ;
      mbar_wait(&full[st], (it / C::STAGES) & 1);
      if (none_live(g, qq0, C::BQ, kw, 64)) {
        turn();
        done(it);
        if (held >= 0) {
          wgmma_wait<0>();
          fence_frags<C::BQ / 16>(pa);
          fence_frags<C::BQ / 16>(sa);
          if (lane == 0) mbar_arrive(&empty[held]);
          held = -1;
        }
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const uint32_t q_addr = smem_u32(Qs + st * C::QT_BYTES);
      const uint32_t do_addr = smem_u32(dOs + st * C::QT_BYTES);
      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x BQ rows
      float s[C::BQ / 2], dp[C::BQ / 2];
#pragma unroll
      for (int i = 0; i < C::BQ / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs<C::BQ / 2>(s);
      fence_regs<C::BQ / 2>(dp);
      turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BQ>(s, desc_k(k_addr + (kk / 4) * C::BK * 128 + (kk % 4) * 32),
                        desc_k(q_addr + (kk / 4) * C::BQ * 128 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BQ>(dp, desc_k(v_addr + (kk / 4) * C::BK * 128 + (kk % 4) * 32),
                        desc_k(do_addr + (kk / 4) * C::BQ * 128 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      done(it);
      if (held >= 0) {
        wgmma_wait<2>();  // the previous iteration's dV and dK are done
        fence_frags<C::BQ / 16>(pa);
        fence_frags<C::BQ / 16>(sa);
        if (lane == 0) mbar_arrive(&empty[held]);
      }
      wgmma_wait<1>();  // S^T is in; dP^T may still run
      fence_regs<C::BQ / 2>(s);

      // P^T = exp2(S^T scale_log2 - lse2) on live pairs
      const float* ls = lse2s + st * C::BQ;
      const float* Dr = Ds + st * C::BQ;
      const bool edge = !all_live(g, qq0, C::BQ, kw, 64);
#pragma unroll
      for (int i = 0; i < C::BQ / 2; ++i) {
        const int qc = 8 * (i / 4) + 2 * t4 + (i & 1);
        s[i] = ex2(s[i] * scale_log2 - ls[qc]);
        if (edge && !live(g, qq0 + qc, (i >> 1) & 1 ? kr1 : kr0)) s[i] = 0.f;
      }
      to_a_frags<C::BQ>(s, pa);
      // dV += P^T dO (dO read MN-major: rows down the tile), while dS^T is formed
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BQ / 16; ++kk)
        wgmma_rs<D>(dV, pa[kk], desc_mn(do_addr + kk * 2048, C::BQ * 128), 1);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is in
      fence_regs<C::BQ / 2>(dp);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int i = 0; i < C::BQ / 2; ++i) dp[i] = s[i] * (dp[i] - Dr[8 * (i / 4) + 2 * t4 + (i & 1)]);
      to_a_frags<C::BQ>(dp, sa);
      // dK += dS^T Q (Q read MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BQ / 16; ++kk)
        wgmma_rs<D>(dK, sa[kk], desc_mn(q_addr + kk * 2048, C::BQ * 128), 1);
      wgmma_commit();
      held = st;
    }
    wgmma_wait<0>();
    fence_regs<D / 2>(dV);
    fence_regs<D / 2>(dK);
    fence_frags<C::BQ / 16>(pa);
    fence_frags<C::BQ / 16>(sa);
    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (kr0 < g.Skv) {
        const long long off = b * g.k_sb + kr0 * g.k_ss + kvh * g.k_sh + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dK[4 * j] * scale, dK[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dV[4 * j], dV[4 * j + 1]);
      }
      if (kr1 < g.Skv) {
        const long long off = b * g.k_sb + kr1 * g.k_ss + kvh * g.k_sh + c;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(dK[4 * j + 2] * scale, dK[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dV[4 * j + 2], dV[4 * j + 3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
                  const float* __restrict__ lse, float* __restrict__ Dd,
                  __nv_bfloat16* __restrict__ dq, const Geom g, float scale) {
  using C = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);
  unsigned char* dOs = Qs + C::Q2_BYTES;
  unsigned char* Ks = dOs + C::Q2_BYTES;  // [STAGES] tiles, then V's
  unsigned char* Vs = Ks + C::STAGES_DQ * C::K2_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + C::STAGES_DQ * C::K2_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES_DQ;

  const int qt = g.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int q0 = qt * C::BQ2;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int kvh = h / (g.H / g.KV);
  int begin, end;
  kv_range(g, q0, C::BQ2, C::BK2, &begin, &end);
  const int n_tiles = end > begin ? (end - begin + C::BK2 - 1) / C::BK2 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES_DQ; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 2) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      mbar_expect_tx(q_full, 2 * C::Q2_BYTES);
      for (int c = 0; c < C::NB; ++c) {
        tma_load(Qs + c * C::BQ2 * 128, &tq, q_full, 64 * c, h, q0, b);
        tma_load(dOs + c * C::BQ2 * 128, &tdo, q_full, 64 * c, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % C::STAGES_DQ, n0 = begin + t * C::BK2;
        if (t >= C::STAGES_DQ) mbar_wait(&empty[st], ((t / C::STAGES_DQ) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * C::K2_BYTES);
        for (int c = 0; c < C::NB; ++c) {
          tma_load(Ks + st * C::K2_BYTES + c * C::BK2 * 128, &tk, &full[st], 64 * c, kvh, n0, b);
          tma_load(Vs + st * C::K2_BYTES + c * C::BK2 * 128, &tv, &full[st], 64 * c, kvh, n0, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows [q0 + 64 wg, + 64)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    const int rw = q0 + 64 * wg;
    const int r0 = rw + 16 * warp + lane / 4, r1 = r0 + 8;
    const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
    const uint32_t do_addr = smem_u32(dOs) + wg * 64 * 128;
    const float scale_log2 = scale * LOG2E;
    // The rows' LSE (log2 domain; +inf past Sq, so P = 0) and D =
    // rowsum(dO ⊙ O), which this kernel computes and writes for the dK/dV
    // kernel that runs after it: the 4 threads of a row group take every
    // fourth 16-byte chunk of the row, then sum across the group in a fixed
    // order.
    float lse2[2], Dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      const bool in = row < g.Sq;
      const long long at = static_cast<long long>(bh) * g.Sq + row;
      lse2[r] = in ? lse[at] * LOG2E : __int_as_float(0x7f800000);
      float acc = 0.f;
      if (in) {
        const long long off = b * g.q_sb + row * g.q_ss + h * g.q_sh;
        const uint4* x = reinterpret_cast<const uint4*>(o + off);
        const uint4* y = reinterpret_cast<const uint4*>(dO + off);
        for (int j = t4; j < D / 8; j += 4) {
          const uint4 xv = x[j], yv = y[j];
          const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
          const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fx = __bfloat1622float2(xp[e]), fy = __bfloat1622float2(yp[e]);
            acc = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, acc));
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      Dr[r] = acc;
      if (in && t4 == 0) Dd[at] = acc;
    }
    float dQ[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dQ[i] = 0.f;

    // A live tile leaves dQ += dS K in flight; the next live tile waits for
    // it after issuing its own S and dP, and only then frees its stage.
    int held = -1;
    uint32_t sa[C::BK2 / 16][4];  // dS as A fragments
    // ping-pong of the two warpgroups' S and dP products, one turn per tile
    auto turn = [&] { named_sync(1 + wg); };
    auto done = [&](int t) {
      if (wg == 0 || t < n_tiles - 1) named_arrive(2 - wg);
    };
    if (wg == 1 && n_tiles > 0) named_arrive(1);
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % C::STAGES_DQ, n0 = begin + t * C::BK2;
      mbar_wait(&full[st], (t / C::STAGES_DQ) & 1);
      if (none_live(g, rw, 64, n0, C::BK2)) {
        turn();
        done(t);
        if (held >= 0) {
          wgmma_wait<0>();
          fence_frags<C::BK2 / 16>(sa);
          if (lane == 0) mbar_arrive(&empty[held]);
          held = -1;
        }
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const uint32_t k_addr = smem_u32(Ks + st * C::K2_BYTES);
      const uint32_t v_addr = smem_u32(Vs + st * C::K2_BYTES);
      // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows x BK2 keys
      float s[C::BK2 / 2], dp[C::BK2 / 2];
#pragma unroll
      for (int i = 0; i < C::BK2 / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs<C::BK2 / 2>(s);
      fence_regs<C::BK2 / 2>(dp);
      turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BK2>(s, desc_k(q_addr + (kk / 4) * C::BQ2 * 128 + (kk % 4) * 32),
                         desc_k(k_addr + (kk / 4) * C::BK2 * 128 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BK2>(dp, desc_k(do_addr + (kk / 4) * C::BQ2 * 128 + (kk % 4) * 32),
                         desc_k(v_addr + (kk / 4) * C::BK2 * 128 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      done(t);
      if (held >= 0) {
        wgmma_wait<2>();  // the previous tile's dQ product is done
        fence_frags<C::BK2 / 16>(sa);
        if (lane == 0) mbar_arrive(&empty[held]);
      }
      wgmma_wait<1>();  // S is in; dP may still run
      fence_regs<C::BK2 / 2>(s);
      const bool edge = !all_live(g, rw, 64, n0, C::BK2);
#pragma unroll
      for (int i = 0; i < C::BK2 / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(s[i] * scale_log2 - lse2[r]);
        if (edge && !live(g, r ? r1 : r0, n0 + 8 * (i / 4) + 2 * t4 + (i & 1))) s[i] = 0.f;
      }
      wgmma_wait<0>();  // dP is in
      fence_regs<C::BK2 / 2>(dp);
#pragma unroll
      for (int i = 0; i < C::BK2 / 2; ++i) dp[i] = s[i] * (dp[i] - Dr[(i >> 1) & 1]);
      to_a_frags<C::BK2>(dp, sa);

      // dQ += dS K (K read MN-major: keys down the rows)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK2 / 16; ++kk)
        wgmma_rs<D>(dQ, sa[kk], desc_mn(k_addr + kk * 2048, C::BK2 * 128), 1);
      wgmma_commit();
      held = st;
    }
    wgmma_wait<0>();
    fence_regs<D / 2>(dQ);
    fence_frags<C::BK2 / 16>(sa);
    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

    __nv_bfloat16* qb = dq + b * g.q_sb + h * g.q_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (r0 < g.Sq)
        *reinterpret_cast<uint32_t*>(qb + r0 * g.q_ss + c) =
            pack_bf16(dQ[4 * j] * scale, dQ[4 * j + 1] * scale);
      if (r1 < g.Sq)
        *reinterpret_cast<uint32_t*>(qb + r1 * g.q_ss + c) =
            pack_bf16(dQ[4 * j + 2] * scale, dQ[4 * j + 3] * scale);
    }
  }
}


// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------

// The step of the last call that failed ("" if none), for the wrapper's
// error message.
const char* g_error_site = "";

int fail_at(const char* site, int e) {
  if (e) g_error_site = site;
  return e;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, heads, d) tensor with element strides (sb, ss, sh) and unit
// stride over d, read in boxes of 64 columns x `rows` rows of one (b, head)
// with the 128-byte swizzle; out-of-range rows and columns read as zero.
// Returns cudaErrorInvalidValue for a misaligned base or stride.
int make_map(CUtensorMap* map, const void* base, int d, int heads, int S, int B, long long sb,
             long long ss, long long sh, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 || (sh * 2) % 16 || (ss * 2) % 16 || (sb * 2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2), static_cast<cuuint64_t>(ss * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);  // the driver's CUresult when it refuses the map
}

// Makes the device that holds `p` current on the calling thread, and with
// it that device's primary context, which cuTensorMapEncodeTiled needs;
// every launch below then goes to that device.  Once per call.
int bind_device(const void* p) {
  cudaPointerAttributes a;
  cudaError_t e = cudaPointerGetAttributes(&a, p);
  if (e == cudaSuccess && a.type != cudaMemoryTypeDevice) e = cudaErrorInvalidDevicePointer;
  if (e == cudaSuccess) e = cudaSetDevice(a.device);
  return static_cast<int>(e);
}

// The dynamic shared-memory attribute belongs to a kernel on one device:
// it is set the first time the kernel launches on each device, and a
// refusal is returned, never ignored (nor remembered as done).
template <auto Kernel>
int allow_smem(int bytes) {
  static bool done[64] = {};  // one set per kernel
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return static_cast<int>(e);
}

template <int D>
int launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
               int B, const Geom& g, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (dtype == 1) {
    using C = Fwd<D>;
    CUtensorMap tq, tk, tv;
    int e = fail_at("tensor map q", make_map(&tq, q, D, g.H, g.Sq, B, g.q_sb, g.q_ss, g.q_sh, C::BM));
    if (!e) e = fail_at("tensor map k", make_map(&tk, k, D, g.KV, g.Skv, B, g.k_sb, g.k_ss, g.k_sh, C::BN));
    if (!e) e = fail_at("tensor map v", make_map(&tv, v, D, g.KV, g.Skv, B, g.v_sb, g.v_ss, g.v_sh, C::BN));
    if (!e) e = fail_at("shared-memory attribute", allow_smem<flash_fwd_sm90<D>>(C::SMEM));
    if (e) return e;
    dim3 grid((g.Sq + C::BM - 1) / C::BM, B * g.H);
    flash_fwd_sm90<D><<<grid, THREADS, C::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, g, scale * LOG2E);
  } else {
    dim3 grid((g.Sq + FBM - 1) / FBM, B * g.H);
    flash_fwd_f32<D><<<grid, 128, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, g, scale);
  }
  return fail_at("forward launch", static_cast<int>(cudaGetLastError()));
}

template <typename T>
int launch_bwd_dot(const void* o, const void* dO, float* Dd, int B, const Geom& g, int D,
                   cudaStream_t stream) {  // the fp32 pre-pass
  const long long rows = static_cast<long long>(B) * g.Sq * g.H;
  flash_bwd_dot<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), Dd, rows, g.Sq, g.H, D);
  return fail_at("rowsum(dO O) launch", static_cast<int>(cudaGetLastError()));
}

template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o, const void* dO,
                   const float* lse, void* dq, void* dk, void* dv, float* Dd, int B,
                   const Geom& g, cudaStream_t stream) {
  using T = float;
  constexpr int smem = bwd_smem_bytes<D>();
  int e = fail_at("shared-memory attribute", allow_smem<flash_bwd_dkdv<T, D>>(smem));
  if (!e) e = fail_at("shared-memory attribute", allow_smem<flash_bwd_dq<T, D>>(smem));
  if (!e) e = launch_bwd_dot<T>(o, dO, Dd, B, g, D, stream);
  if (e) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dOt = static_cast<const T*>(dO);
  flash_bwd_dkdv<T, D><<<dim3((g.Skv + BT - 1) / BT, B * g.KV), BTHREADS, smem, stream>>>(
      qt, kt, vt, dOt, lse, Dd, static_cast<T*>(dk), static_cast<T*>(dv), g, scale);
  e = fail_at("dk/dv launch", static_cast<int>(cudaGetLastError()));
  if (e) return e;
  flash_bwd_dq<T, D><<<dim3((g.Sq + BT - 1) / BT, B * g.H), BTHREADS, smem, stream>>>(
      qt, kt, vt, dOt, lse, Dd, static_cast<T*>(dq), g, scale);
  return fail_at("dq launch", static_cast<int>(cudaGetLastError()));
}

template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dO,
                    const float* lse, void* dq, void* dk, void* dv, float* Dd, int B,
                    const Geom& g, cudaStream_t stream) {
  using C = Bwd<D>;
  // q and dO in 64-row boxes for the dK/dV kernel and 128-row boxes for the
  // dQ kernel; k and v the other way round
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  int e = fail_at("tensor map q", make_map(&q64, q, D, g.H, g.Sq, B, g.q_sb, g.q_ss, g.q_sh, C::BQ));
  if (!e) e = fail_at("tensor map dO", make_map(&do64, dO, D, g.H, g.Sq, B, g.q_sb, g.q_ss, g.q_sh, C::BQ));
  if (!e) e = fail_at("tensor map k", make_map(&k128, k, D, g.KV, g.Skv, B, g.k_sb, g.k_ss, g.k_sh, C::BK));
  if (!e) e = fail_at("tensor map v", make_map(&v128, v, D, g.KV, g.Skv, B, g.v_sb, g.v_ss, g.v_sh, C::BK));
  if (!e) e = fail_at("tensor map q", make_map(&q128, q, D, g.H, g.Sq, B, g.q_sb, g.q_ss, g.q_sh, C::BQ2));
  if (!e) e = fail_at("tensor map dO", make_map(&do128, dO, D, g.H, g.Sq, B, g.q_sb, g.q_ss, g.q_sh, C::BQ2));
  if (!e) e = fail_at("tensor map k", make_map(&k64, k, D, g.KV, g.Skv, B, g.k_sb, g.k_ss, g.k_sh, C::BK2));
  if (!e) e = fail_at("tensor map v", make_map(&v64, v, D, g.KV, g.Skv, B, g.v_sb, g.v_ss, g.v_sh, C::BK2));
  if (!e) e = fail_at("shared-memory attribute", allow_smem<flash_bwd_dkdv_sm90<D>>(C::SMEM_DKDV));
  if (!e) e = fail_at("shared-memory attribute", allow_smem<flash_bwd_dq_sm90<D>>(C::SMEM_DQ));
  if (e) return e;
  // the dQ kernel first: it also writes D = rowsum(dO ⊙ O), which the dK/dV
  // kernel reads
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_bwd_dq_sm90<D><<<dim3((g.Sq + C::BQ2 - 1) / C::BQ2, B * g.H), THREADS, C::SMEM_DQ,
                         stream>>>(q128, k64, v64, do128, static_cast<const __nv_bfloat16*>(o),
                                   static_cast<const __nv_bfloat16*>(dO), lse, Dd,
                                   static_cast<__nv_bfloat16*>(dq), g, scale);
  e = fail_at("dq launch", static_cast<int>(cudaGetLastError()));
  if (e) return e;
  flash_bwd_dkdv_sm90<D><<<dim3((g.Skv + C::BK - 1) / C::BK, B * g.KV), THREADS,
                           C::SMEM_DKDV, stream>>>(
      q64, k128, v128, do64, lse, Dd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g, scale);
  return fail_at("dk/dv launch", static_cast<int>(cudaGetLastError()));
}

}  // namespace

// The step at which the last failing call stopped ("" if none failed).
extern "C" const char* flash_attention_error_site() { return g_error_site; }

// lse may be NULL (not wanted): fp32 (B, H, Sq) when given.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
    int Sq, int Skv, int H, int KV, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return fail_at("arguments", static_cast<int>(cudaErrorInvalidValue));
  cudaGetLastError();  // report this call's errors only, not an earlier caller's
  if (int e = fail_at("device of q", bind_device(q))) return e;
  Geom g{Sq,   Skv,  H,    KV,   q_sb, q_ss, q_sh,   k_sb,  k_ss,
         k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_fwd<32>(dtype, q, k, v, o, lse, B, g, s);
    case 64: return launch_fwd<64>(dtype, q, k, v, o, lse, B, g, s);
    case 80: return launch_fwd<80>(dtype, q, k, v, o, lse, B, g, s);
    case 128: return launch_fwd<128>(dtype, q, k, v, o, lse, B, g, s);
  }
  return fail_at("arguments", static_cast<int>(cudaErrorInvalidValue));
}

// Every tensor contiguous: q, o, dO, dq (B, Sq, H, D); k, v, dk, dv
// (B, Skv, KV, D); lse from the forward and the scratch Dd fp32 (B, H, Sq).
// dq, dk, dv are written (not accumulated) in the inputs' dtype.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dO,
    const float* lse, void* dq, void* dk, void* dv, float* Dd, int dtype, int B, int Sq,
    int Skv, int H, int KV, int D, int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0)
    return fail_at("arguments", static_cast<int>(cudaErrorInvalidValue));
  cudaGetLastError();  // report this call's errors only, not an earlier caller's
  if (int e = fail_at("device of q", bind_device(q))) return e;
  const long long qs = static_cast<long long>(H) * D, ks = static_cast<long long>(KV) * D;
  Geom g{Sq, Skv, H, KV, Sq * qs, qs, D, Skv * ks, ks, D,
         Skv * ks, ks, D, Sq * qs, qs, D, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD(F, DD) F<DD>(q, k, v, o, dO, lse, dq, dk, dv, Dd, B, g, s)
  if (dtype == 0) {
    switch (D) {
      case 32: return FLASH_BWD(launch_bwd_f32, 32);
      case 64: return FLASH_BWD(launch_bwd_f32, 64);
      case 80: return FLASH_BWD(launch_bwd_f32, 80);
      case 128: return FLASH_BWD(launch_bwd_f32, 128);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return FLASH_BWD(launch_bwd_bf16, 32);
      case 64: return FLASH_BWD(launch_bwd_bf16, 64);
      case 80: return FLASH_BWD(launch_bwd_bf16, 80);
      case 128: return FLASH_BWD(launch_bwd_bf16, 128);
    }
  }
#undef FLASH_BWD
  return fail_at("arguments", static_cast<int>(cudaErrorInvalidValue));
}
