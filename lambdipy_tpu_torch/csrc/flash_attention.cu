// Flash attention for prefill on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lambdipy_tpu/ops/attention.py
// ::_flash_kernel, reached through flash_attention. It computes what that
// kernel body computes: scores q . k^T * scale in f32, the causal mask
// (q_idx >= k_idx, fill -1e30), an online softmax with a running max m and
// sum l, p = exp(s - m) rounded to v's dtype before the PV product, f32
// accumulation, and out = acc / max(l, 1e-30) cast to the input dtype.
//
// Layouts are the JAX package's: q [b, sq, h, d], k/v [b, sk, kvh, d]
// (contiguous, heads grouped), out [b, sq, h, d]. Query head h reads kv
// head h / (h_total / kvh) in place: K/V is never repeated into memory
// (the JAX wrapper materialises the repeat). The caller checks sq == sk
// for causal calls, d % 16 == 0, d <= 256 and 16-byte alignment.
//
// What bounds it on the H100: operations. At b=1, s=4096, h=32, kvh=8,
// d=128, causal, the work is 4 * b * h * d * s (s + 1) / 2 = 1.37e11 flop,
// 0.139 ms at 989 TFLOP/s, while its bytes (q, k, v read once, out
// written once: 67 MB) take 0.020 ms. So the design feeds the tensor
// cores' asynchronous path and keeps every operand out of the threads'
// way:
//
// * bf16: one block per (query head, batch row, 128-query tile), three
//   warpgroups. Warpgroup 0 produces: `setmaxnreg` down to 40 registers,
//   and its one thread issues every load through the tensor-memory
//   accelerator (TMA): the Q tile once, then a ring of two stages of K
//   and V tiles (BKV positions each: 128 at d <= 128, 64 at d = 256, where
//   the output accumulator takes the registers), each K and each V tile
//   guarded by a full and an empty mbarrier (a K tile goes back as soon as
//   its S product is done). The tensor maps are 4-D over [b, s, heads, d]
//   with the JAX layout's strides, encoded per call; every tile is one
//   64-column, 128-byte-swizzled atom per 64 head dims, and d is padded
//   to 64, 128 or 256 by TMA's zero fill (a zero column leaves every dot
//   product unchanged). Warpgroups 1 and 2 consume, 64 query rows each,
//   `setmaxnreg` up to 232: S = Q K^T by wgmma.mma_async m64nBKVk16 (A:
//   the Q slab, B: the K tile, both K-major in shared memory) into f32
//   registers; the masks on the accumulator fragment (the causal mask
//   only on tiles that cross the slab's diagonal, the ragged tail past sk
//   only on the last tile, whose zero-filled keys would otherwise score
//   0); the running max on the raw scores and the sum by quad shuffles;
//   p = 2^(s * scale log2 e - m * scale log2 e), one FFMA (the scale in
//   f32) and one ex2; p rounded to bf16 in registers and handed to wgmma
//   as its register A operand (the S accumulator of k16 step j is the A
//   fragment of that step, pair by pair) for O += P V, B the V tile,
//   d-contiguous, so MN-major with the transpose flag. A consumer issues
//   S_j and the PV product of tile j - 1 together, so the softmax of S_j
//   runs while the tensor cores do that PV product, and O is rescaled
//   once it is done; the producer keeps K and V loads a tile or more
//   ahead; the two consumers share the SM's tensor cores (no explicit
//   ping-pong between them). The pipeline is static -- tile 0's S alone,
//   then a loop whose every pass issues both products and waits for the
//   older one, then the last PV product -- because with a number of
//   groups in flight that varies from pass to pass ptxas cannot tell
//   which product a wait completes and serialises every wgmma (its
//   warning C7514). K/V tiles entirely above the diagonal are never
//   loaded (they would add exactly 0). The grid puts
//   the query tile on its slowest axis, longest tiles first, so a causal
//   call does not end on a tail of full-length blocks. Epilogue: acc /
//   max(l, 1e-30) in bf16 written into the slab's own Q rows in the
//   swizzled layout, then a TMA store, which clips the query tail past
//   sq and the head dims past d.
// * f32: a loop on the CUDA cores (16-query tiles, 32-position K/V tiles,
//   scores through shared memory), for the small f32 models.
//
// Batch invariance (the serving engine's grouped prefills rest on it: a
// row prefilled inside a group must be bitwise the row prefilled alone):
// everything that fixes an element's summation order -- BKV, the tile
// plan, the k16 order of both products, where p is rounded, the shuffle
// order -- depends on sq, sk and d alone, never on b. The batch row is
// only a grid coordinate.
//
// Launches on the caller's stream, allocates nothing.

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask fill
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------ bf16, wgmma
constexpr int BQ = 128;          // query rows per block: two 64-row slabs
constexpr int FA_THREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int STAGES = 2;        // the K/V ring
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory

// Shared memory of the d <= DP kernel: the Q tile [DP / 64 atoms][BQ
// rows][128 B], then STAGES stages of [K | V], each [DP / 64][BKV][128 B],
// then the mbarriers. Every region is a multiple of 1024 bytes (the
// swizzle atom).
template <int DP>
struct Flash {
  static constexpr int BKV = DP <= 128 ? 128 : 64;
  static constexpr int Q = BQ * DP * 2;
  static constexpr int KV = BKV * DP * 2;  // one K or V tile
  static constexpr int STAGE = 2 * KV;
  static constexpr int SMEM = Q + STAGES * STAGE + 1024 + 256;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// A box of a 4-D map over [b, s, heads, d] at coordinates (d0, head, s0,
// row), innermost first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int head,
                                         int s0, int row) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(head), "r"(s0), "r"(row) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int d0, int head,
                                          int s0, int row) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(
          map)), "r"(smem_u32(src)), "r"(d0), "r"(head), "r"(s0), "r"(row)
      : "memory");
}

// generic-proxy writes to shared memory made visible to TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Byte offsets:
// lbo between 64-element atoms along MN (MN-major only), sbo between
// groups of 8 rows (K-major) or of 8 k (MN-major).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// d[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, f32 accumulate; A and B
// K-major in shared memory (S = Q K^T); scale_d == 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);

// d[64 x N] += A[64 x 16] * B[16 x N]: A from registers (P), B MN-major
// in shared memory (V).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

// The online-softmax step of one S tile, on the accumulator fragment of
// rows r_lo and r_lo + 8 (keys k0 + 8 n8 + 2 t + {0, 1}): the masks (only
// on a tile that crosses the slab's diagonal or holds the ragged tail past
// sk), the running max on the raw scores by quad shuffles, p = 2^(s *
// scale log2 e - m * scale log2 e) in place, the running sum. Returns the
// rescale factors of the previous accumulator in alpha.
template <int BKV>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BKV / 2], int k0, int sk, int t, int r_lo, bool diag,
    float scale_log2, float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  if (diag || k0 + BKV > sk) {
#pragma unroll
    for (int n8 = 0; n8 < BKV / 8; ++n8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + n8 * 8 + 2 * t + (e & 1);
        if ((diag && kc > r_lo + (e < 2 ? 0 : 8)) || kc >= sk) {
          sc[4 * n8 + e] = NEG_INF;
        }
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n8 = 0; n8 < BKV / 8; ++n8) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n8], sc[4 * n8 + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n8 + 2], sc[4 * n8 + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
    }
  }
  const float mc[2] = {mx[0] * scale_log2, mx[1] * scale_log2};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n8 = 0; n8 < BKV / 8; ++n8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * n8 + e] = ex2(fmaf(sc[4 * n8 + e], scale_log2, -mc[e / 2]));
      sum[e / 2] += sc[4 * n8 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    alpha[h] = ex2((m[h] - mx[h]) * scale_log2);
    l[h] = l[h] * alpha[h] + sum[h];
    m[h] = mx[h];
  }
}

// P in bf16: the accumulator of positions 16 kk .. 16 kk + 15 is the
// register A fragment of k16 step kk (rows g and g + 8, two columns each,
// the lower index in the low half).
template <int BKV>
__device__ __forceinline__ void pack_p(const float (&sc)[BKV / 2],
                                       uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap o_map, int sq, int sk, int group,
    float scale_log2, int causal) {
  using C = Flash<DP>;
  constexpr int BKV = C::BKV;
  constexpr int ATOMS = DP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* stages = smem + C::Q;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + STAGES * C::STAGE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int kv_head = head / group;
  // causal: the tile's last query row sees keys up to q0 + BQ - 1
  const int kend = causal ? min(sk, q0 + BQ) : sk;
  const int tiles = (kend + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2);  // one arrival per consumer warpgroup
      mbar_init(&v_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        tma_load(qs + a * BQ * 128, &q_map, q_full, a * 64, head, q0, row);
        tma_load(qs + a * BQ * 128 + 8192, &q_map, q_full, a * 64, head,
                 q0 + 64, row);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        uint8_t* ks = stages + s * C::STAGE;
        uint8_t* vs = ks + C::KV;
        mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], C::KV);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load(ks + a * BKV * 128, &k_map, &k_full[s], a * 64, kv_head,
                   j * BKV, row);
        }
        mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], C::KV);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load(vs + a * BKV * 128, &v_map, &v_full[s], a * 64, kv_head,
                   j * BKV, row);
        }
      }
    }
  } else {  // consumers: warpgroup c owns query rows q0 + 64 c ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int ct = threadIdx.x % 128;
    const int lane = ct % 32;
    const int t = lane % 4;
    const int slab0 = q0 + 64 * c;
    const int r_in = (ct / 32) * 16 + lane / 4;  // row in the slab; +8
    const int r_lo = slab0 + r_in;
    const uint32_t q_addr = smem_u32(qs) + c * 8192;
    const uint32_t stage_addr = smem_u32(stages);

    float o[DP / 2], sc[BKV / 2];
    uint32_t pa[BKV / 16][4];  // P of the previous tile, bf16 pairs
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    // running max (raw scores) and sum of rows r_lo and r_lo + 8
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

    // S_j = Q K_j^T, DP / 16 k16 steps in order; O += P V_j, BKV / 16
    // k16 steps in order. Each is one commit group.
    auto issue_s = [&](int j) {
      const int s = j % STAGES;
      mbar_wait(&k_full[s], (j / STAGES) & 1);
      const uint32_t k_addr = stage_addr + s * C::STAGE;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // k16 step inside its atom
        wgmma_ss<BKV>(
            sc, smem_desc(q_addr + (kk / 4) * BQ * 128 + off, 16, 1024),
            smem_desc(k_addr + (kk / 4) * BKV * 128 + off, 16, 1024),
            kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    auto issue_pv = [&](int j) {
      const int s = j % STAGES;
      mbar_wait(&v_full[s], (j / STAGES) & 1);
      const uint32_t v_addr = stage_addr + s * C::STAGE + C::KV;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wgmma_rs<DP>(o, pa[kk],
                     smem_desc(v_addr + kk * 2048, BKV * 128, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };

    mbar_wait(q_full, 0);
    // tile 0: S alone
    wgmma_fence();
    issue_s(0);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(sc);
    if (ct == 0) mbar_arrive(&k_empty[0]);
    softmax_tile<BKV>(sc, 0, sk, t, r_lo, causal && BKV - 1 > slab0,
                      scale_log2, m, l, alpha);
    pack_p<BKV>(sc, pa);
    // tile j: S_j and O += P_{j-1} V_{j-1} issued together; the softmax
    // of S_j runs while the tensor cores do the PV product; O is rescaled
    // once that is done
    for (int j = 1; j < tiles; ++j) {
      fence_acc(sc);
      fence_acc(o);
      fence_regs(pa);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(sc);
      if (ct == 0) mbar_arrive(&k_empty[j % STAGES]);
      const int k0 = j * BKV;
      softmax_tile<BKV>(sc, k0, sk, t, r_lo, causal && k0 + BKV - 1 > slab0,
                        scale_log2, m, l, alpha);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(o);
      fence_regs(pa);
      if (ct == 0) mbar_arrive(&v_empty[(j - 1) % STAGES]);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      pack_p<BKV>(sc, pa);
    }
    // the last PV product
    fence_acc(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(tiles - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(o);
    if (ct == 0) mbar_arrive(&v_empty[(tiles - 1) % STAGES]);

    // epilogue: acc / max(l, 1e-30) in bf16 into the slab's Q rows (no
    // longer read), swizzled as TMA wrote them, then a TMA store
    const float den_lo = fmaxf(l[0], 1e-30f);
    const float den_hi = fmaxf(l[1], 1e-30f);
    uint8_t* slab = qs + c * 8192;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      uint8_t* atom = slab + (i / 8) * BQ * 128;
      const int chunk = ((i % 8) ^ (r_in & 7)) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(atom + r_in * 128 + chunk) =
          pack_bf16(o[4 * i] / den_lo, o[4 * i + 1] / den_lo);
      *reinterpret_cast<uint32_t*>(atom + (r_in + 8) * 128 + chunk) =
          pack_bf16(o[4 * i + 2] / den_hi, o[4 * i + 3] / den_hi);
    }
    fence_async_shared();
    bar_sync(1 + c, 128);
    if (ct == 0 && slab0 < sq) {
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        tma_store(&o_map, slab + a * BQ * 128, a * 64, head, slab0, row);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that libcuda is not
// linked
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D bf16 map over a contiguous [b, s, heads, d] tensor, boxes of 64
// head dims (one 128-byte swizzle atom) x 1 head x box_s positions x 1
// row; elements outside the tensor read as zero and are not written.
bool encode(CUtensorMap* map, const void* base, int b, int s, int heads,
            int d, int box_s) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t row = (cuuint64_t)heads * d * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, row, row * s};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_s, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int b, int sq, int sk, int h, int kvh, int d, float scale,
                int causal, cudaStream_t stream) {
  using C = Flash<DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap qm, km, vm, om;
  const bool ok = encode(&qm, q, b, sq, h, d, 64) &&
                  encode(&km, k, b, sk, kvh, d, C::BKV) &&
                  encode(&vm, v, b, sk, kvh, d, C::BKV) &&
                  encode(&om, out, b, sq, h, d, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(h, b, (sq + BQ - 1) / BQ);
  flash_wgmma_kernel<DP><<<grid, FA_THREADS, C::SMEM, stream>>>(
      qm, km, vm, om, sq, sk, h / kvh, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- f32, CUDA cores
constexpr int THREADS = 128;
constexpr int FQ = 16;     // query rows per block
constexpr int FK = 32;     // K/V positions per tile
constexpr int FDMAX = 256;
constexpr int F_ACC = FQ * FDMAX / THREADS;  // output values per thread

__global__ void __launch_bounds__(THREADS) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int sq, int sk,
    int h, int kvh, int d, float scale, int causal) {
  extern __shared__ __align__(16) float fsmem[];
  const int ld = d + 1;  // odd row stride: rows fall in different banks
  float* qs = fsmem;                 // [FQ][ld]
  float* ks = qs + FQ * ld;          // [FK][ld]
  float* vs = ks + FK * ld;          // [FK][ld]
  float* ps = vs + FK * ld;          // [FQ][FK + 1]
  float* m_s = ps + FQ * (FK + 1);   // [FQ]
  float* l_s = m_s + FQ;             // [FQ]
  float* alpha_s = l_s + FQ;         // [FQ]

  const int q0 = blockIdx.x * FQ;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int tid = threadIdx.x;
  const size_t q_stride = (size_t)h * d;
  const size_t kv_stride = (size_t)kvh * d;

  for (int i = tid; i < FQ * d; i += THREADS) {
    const int r = i / d;
    const int c = i % d;
    qs[r * ld + c] = q0 + r < sq
        ? q[((size_t)row * sq + q0 + r) * q_stride + (size_t)head * d + c]
        : 0.f;
  }
  if (tid < FQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // thread owns query row tid % FQ and head dims tid / FQ + 8 i
  const int my_row = tid % FQ;
  const int my_col = tid / FQ;
  float acc[F_ACC];
#pragma unroll
  for (int i = 0; i < F_ACC; ++i) acc[i] = 0.f;

  const int kend = causal ? min(sk, q0 + FQ) : sk;
  const float* kbase = k + (size_t)row * sk * kv_stride + (size_t)kv_head * d;
  const float* vbase = v + (size_t)row * sk * kv_stride + (size_t)kv_head * d;
  for (int k0 = 0; k0 < kend; k0 += FK) {
    const int n = min(FK, sk - k0);
    __syncthreads();
    for (int i = tid; i < FK * d; i += THREADS) {
      const int r = i / d;
      const int c = i % d;
      const bool in = r < n;
      ks[r * ld + c] = in ? kbase[(size_t)(k0 + r) * kv_stride + c] : 0.f;
      vs[r * ld + c] = in ? vbase[(size_t)(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FQ * FK; i += THREADS) {
      const int r = i % FQ;
      const int j = i / FQ;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot += qs[r * ld + c] * ks[j * ld + c];
      float val = dot * scale;
      if (causal && k0 + j > q0 + r) val = NEG_INF;
      if (j >= n) val = -INFINITY;  // ragged tile: not a position
      ps[r * (FK + 1) + j] = val;
    }
    __syncthreads();
    if (tid < FQ) {
      float* pr = ps + tid * (FK + 1);
      float mx = NEG_INF;
      for (int j = 0; j < FK; ++j) mx = fmaxf(mx, pr[j]);
      const float m_new = fmaxf(m_s[tid], mx);
      float sum = 0.f;
      for (int j = 0; j < FK; ++j) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      const float a = expf(m_s[tid] - m_new);
      alpha_s[tid] = a;
      l_s[tid] = l_s[tid] * a + sum;
      m_s[tid] = m_new;
    }
    __syncthreads();
    const float a = alpha_s[my_row];
    const float* pr = ps + my_row * (FK + 1);
#pragma unroll
    for (int i = 0; i < F_ACC; ++i) {
      const int c = my_col + 8 * i;
      if (c < d) {
        float sacc = acc[i] * a;
        for (int j = 0; j < n; ++j) sacc += pr[j] * vs[j * ld + c];
        acc[i] = sacc;
      }
    }
  }
  __syncthreads();
  if (q0 + my_row < sq) {
    const float den = fmaxf(l_s[my_row], 1e-30f);
    float* orow = out + ((size_t)row * sq + q0 + my_row) * q_stride +
                  (size_t)head * d;
#pragma unroll
    for (int i = 0; i < F_ACC; ++i) {
      const int c = my_col + 8 * i;
      if (c < d) orow[c] = acc[i] / den;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int sk, int h, int kvh, int d, float scale,
               int causal, cudaStream_t stream) {
  const int ld = d + 1;
  const int smem = (int)sizeof(float) *
                   ((FQ + 2 * FK) * ld + FQ * (FK + 1) + 3 * FQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + FQ - 1) / FQ, h, b);
  flash_f32_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, h, kvh,
      d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the first CUDA error of the
// attribute call or the launch, or cudaErrorInvalidValue when a tensor
// map cannot be encoded. The caller checks the shapes (h % kvh,
// d % 16, d <= 256, sq == sk when causal), contiguity and alignment.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, int b, int sq, int sk,
                                      int h, int kvh, int d, float scale,
                                      int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_f32(q, k, v, out, b, sq, sk, h, kvh, d, scale, causal, s);
  }
  if (dtype == 1) {
    if (d <= 64) {
      return launch_bf16<64>(q, k, v, out, b, sq, sk, h, kvh, d, scale,
                             causal, s);
    }
    if (d <= 128) {
      return launch_bf16<128>(q, k, v, out, b, sq, sk, h, kvh, d, scale,
                              causal, s);
    }
    return launch_bf16<256>(q, k, v, out, b, sq, sk, h, kvh, d, scale,
                            causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
