// Int8 weight-only matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lambdipy_tpu/ops/quant.py::_kernel,
// reached through int8_matmul. It computes what that kernel body
// computes: out[m, n] = (bf16(x) @ bf16(w_int8)) accumulated in f32, times
// the per-output-channel f32 scale once at the end, cast to x's dtype.
// x is [m, k] float32 or bfloat16, w is [k, n] int8 row-major (the
// layout QDense keeps), scale is [1, n] float32, out is [m, n] in x's
// dtype. The caller picks the route (ops/quant.py::int8_route): the GEMV
// for rows that each stand alone (a decode step, the lm_head at the logit
// positions) at any m, else the tiled route. What each route takes (the
// wrapper checks it):
// * gemv: n % 8 == 0, w 16-byte aligned; any k, any m, x rows at any
//   alignment;
// * tiled: n % 16 == 0, k % 8 == 0 (bf16 x) or k % 4 == 0 (f32 x), and
//   x, w, scale 16-byte aligned: the tensor-memory accelerator (TMA)
//   wants 16-byte row strides and bases.
//
// What bounds it on the H100: at decode (m = 1 to 64) bytes — the k * n
// int8 weights are read once per call and each weight byte feeds only 2m
// flops, far below the ~295 flop/byte ridge; at prefill operations from
// m ~ 300 up, bytes below (m = 128 moves 2 * 128 flops per weight byte).
// Two routes therefore:
//
// * gemv (decode, m = the batch's rows, one position each): a split-k
//   tensor-core kernel that reads the weights once for up to 64 rows.
//   The plan (ops/quant.py::gemv_plan, a function of k and n alone,
//   passed in) cuts k into at most 8 splits so that the column tiles
//   times the splits make about one wave of two blocks on each of the 132
//   SMs: a block owns 128 columns (64 for n < 2048, n % 16 != 0 or more
//   than 16 rows) and one split, and its 8 warps take every 8th 16-deep
//   k step of it. Each lane loads its weights straight into registers,
//   16 (or 8) columns from each of 4 k rows a step, with the next step
//   already in flight, so no shared memory sits between HBM and the
//   tensor cores. The product runs transposed, out^T = W^T x^T, as
//   mma.sync m16n8k16 bf16 with f32 accumulators: the int8 weights,
//   converted to bf16 in registers (exact), are the A operand (16
//   columns x 16 k), x^T the B operand (16 k x 8 rows, loaded a step
//   ahead, f32 x rounded to bf16 there), so rows cost only tensor-core
//   time up to 64 (8 row groups a block; past 64 the grid's z axis takes
//   groups of 64). The block sums its warps in warp order through shared
//   memory; with one split it applies scale[col] and writes the output,
//   else it writes an f32 partial to a workspace [splits, m, n] and the
//   last block of its column tile to arrive (a counter per tile, which
//   that block resets) sums the partials in split order, applies the
//   scale and writes the output. No atomics on the output. On the H100
//   the large projections stream at ~0.7 of the bytes bound up to 16
//   rows; small ones pay launch and ramp; at 64 rows the registers of 8
//   row groups leave one block an SM (PERF.md has the numbers).
// * tiled (prefill, m = rows x positions >= 16): a warp-specialised
//   wgmma GEMM. A block computes a BM x BN output tile, one of three
//   shapes (256 x 128, 128 x 128, 128 x 64: two consumer warpgroups of
//   one or two 64-row slabs each), picked by m and n from the H100's
//   measured step times so that short prompts get many blocks and long
//   ones big tiles. One producer
//   thread keeps a ring of 3-8 stages in dynamic shared memory full
//   through TMA (the x tile [BM, 64] with the 128-byte swizzle; the int8
//   tile [64, BN] n-contiguous as QDense keeps it, half the bytes of
//   bf16), each stage guarded by a full and an empty mbarrier. The consumers convert the stage's int8 tile into a bf16
//   tile laid out as wgmma's MN-major (transposed) B operand with the
//   128-byte swizzle (the mixed-input step: one pass over 64 x BN values
//   per k step against BM x BN x 64 multiply-adds), then each issues four
//   wgmma.mma_async m64nBNk16 bf16 per slab with f32 accumulators in
//   registers (A: its slabs of the x tile), keeping one k step in flight
//   while the next is converted. f32 x (the lm_head outside the served
//   path) arrives as an f32 TMA tile and is rounded to bf16 into the A
//   layout by the same pass. Epilogue: accumulator x scale[col] (the
//   scale tile itself a TMA load), cast to x's dtype, staged in shared
//   memory and written by a TMA store. Ragged m, n and k come from TMA's
//   zero fill on loads and its clipping on the store: nothing is masked
//   by element. At m >= ~1024 shared-memory bandwidth bounds it (the
//   wgmma operand reads plus the conversion's pass); at m <= ~128 the
//   ~0.37 µs a 128 x 64 block takes per k step, whose four k16 wgmmas
//   run one after another into one accumulator.
//
// Row invariance in m (the serving engine's bitwise checks rest on it: a
// row decoded or prefilled inside a group of rows must equal the row
// alone). The GEMV sums a row's element in an order fixed by k and n
// alone: the 16-deep steps of a warp in k order, each one mma into the
// same accumulator; the 8 warps in order; the splits in order. m picks
// only how many row groups a block computes; the rows of an mma are
// independent, so a row's bits are the same at m = 1 and anywhere in
// m = 64. The tiled route sums every element over k in one order fixed
// by k alone — 64-deep stages in order, four k16 wgmmas in order, each
// into the same f32 accumulator, with no split of k. The tile shape and
// the grid, which do depend on m, change which block computes an
// element, never its order.
//
// Launches on the caller's stream, allocates nothing: the GEMV's
// workspace and counters come from the wrapper.

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// --------------------------------------------------------------- tiled
constexpr int TM_BK = 64;            // k per stage: one 128-byte bf16 row
constexpr int TM_SMEM_MAX = 232448;  // a block's dynamic shared memory
constexpr int TM_THREADS = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int TM_CONSUMERS = 256;

// One tile shape of the tiled route: two consumer warpgroups, each
// owning SLABS slabs of 64 rows (1 or 2), times BN columns (64 or 128).
// Shared memory: STAGES stages of [x | a | b | w], then the scale tile,
// then the mbarriers. x: the TMA x tile [BM, 64] (bf16 with the 128-byte
// swizzle, or f32 unswizzled); a: f32 x rounded to bf16 in the swizzled
// layout wgmma reads as A (f32 x only); b: the bf16 B operand [64, BN],
// MN-major, 128-byte swizzle; w: the TMA int8 tile [64, BN]. Every region
// is a multiple of 1024 bytes (the swizzle atom).
template <typename T, int SLABS, int BN>
struct Tiled {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BM = 128 * SLABS;
  static constexpr int X = BM * TM_BK * (int)sizeof(T);
  static constexpr int A = F32 ? BM * TM_BK * 2 : 0;
  static constexpr int B = TM_BK * BN * 2;
  static constexpr int W = TM_BK * BN;
  static constexpr int STAGE = X + A + B + W;
  static constexpr int EXTRA = 1024 + BN * 4 + 256;  // alignment, scale, bars
  static constexpr int STAGES = (TM_SMEM_MAX - EXTRA) / STAGE;
  static constexpr int SMEM = STAGES * STAGE + EXTRA;
  static constexpr int TX = X + W;  // bytes a stage's TMA loads bring
  static_assert(STAGES >= 3, "too few stages");
  // the epilogue stages the BM x BN output tile in the stages' space
  static_assert(BM * BN * (int)sizeof(T) <= STAGES * STAGE, "epilogue");
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

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
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

// d[64 x BN] += A[64 x 16] (K-major) * B[16 x BN] (MN-major), bf16 in, f32
// accumulate.
template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight int8 to eight bf16, exactly: byte b ^ 0x80 is b + 128 as an
// unsigned byte; as the low mantissa byte of 2^23 it reads 2^23 + b + 128,
// and subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ uint4 int8x8_to_bf16(uint2 raw) {
  const uint32_t u[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
  uint32_t o[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float lo = __uint_as_float(__byte_perm(u[h], 0x4B000000u,
                                                   0x7650 + 2 * p));
      const float hi = __uint_as_float(__byte_perm(u[h], 0x4B000000u,
                                                   0x7651 + 2 * p));
      o[2 * h + p] = pack_bf16(lo - 8388736.f, hi - 8388736.f);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The stage's int8 tile w [64][BN] into the MN-major B operand: for each
// 64-column atom, k row kr is a 128-byte line at atom * 8192 + kr * 128
// whose 16-byte chunk c sits at chunk c ^ (kr % 8). ct: the consumer
// thread.
template <int BN>
__device__ __forceinline__ void convert_w(const uint8_t* w, uint8_t* b,
                                          int ct) {
#pragma unroll
  for (int j = 0; j < TM_BK * BN / 8 / TM_CONSUMERS; ++j) {
    const int q = ct + j * TM_CONSUMERS;
    const int kr = q / (BN / 8), nc = q % (BN / 8);
    const uint2 raw = *reinterpret_cast<const uint2*>(w + kr * BN + nc * 8);
    *reinterpret_cast<uint4*>(b + (nc / 8) * (TM_BK * 128) + kr * 128 +
                              (((nc % 8) ^ (kr & 7)) * 16)) =
        int8x8_to_bf16(raw);
  }
}

// f32 x tile [BM][64] rounded to bf16 into the K-major A layout the TMA
// swizzle gives a bf16 tile: row r at r * 128, chunk c at c ^ (r % 8).
template <int BM>
__device__ __forceinline__ void convert_x(const float* x, uint8_t* a,
                                          int ct) {
#pragma unroll
  for (int j = 0; j < BM * TM_BK / 8 / TM_CONSUMERS; ++j) {
    const int q = ct + j * TM_CONSUMERS;
    const int r = q / 8, c = q % 8;
    const float4 u = *reinterpret_cast<const float4*>(x + r * TM_BK + c * 8);
    const float4 v =
        *reinterpret_cast<const float4*>(x + r * TM_BK + c * 8 + 4);
    *reinterpret_cast<uint4*>(a + r * 128 + ((c ^ (r & 7)) * 16)) =
        make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w),
                   pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int SLABS, int BN>
__global__ void __launch_bounds__(TM_THREADS, 1)
    tiled_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap s_map,
                 const __grid_constant__ CUtensorMap o_map, int m, int k) {
  using C = Tiled<T, SLABS, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sc = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + BN);
  uint64_t* empty = full + C::STAGES;
  uint64_t* scale_bar = empty + C::STAGES;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * C::BM;
  const int steps = (k + TM_BK - 1) / TM_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(scale_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(scale_bar, BN * 4);
      tma_load(sc, &s_map, scale_bar, n0, 0);
      for (int i = 0; i < steps; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::TX);
        tma_load(st, &x_map, &full[s], i * TM_BK, m0);
        tma_load(st + C::X + C::A + C::B, &w_map, &full[s], n0, i * TM_BK);
      }
    }
  } else {  // consumers: warpgroup c owns SLABS slabs of 64 rows from
            // row (c * SLABS) * 64
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int ct = threadIdx.x - 128;
    float acc[SLABS][BN / 2];
#pragma unroll
    for (int j = 0; j < SLABS; ++j) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[j][i] = 0.f;
    }
    for (int i = 0; i < steps; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      uint8_t* st = smem + s * C::STAGE;
      uint8_t* b = st + C::X + C::A;
      convert_w<BN>(b + C::B, b, ct);
      if constexpr (C::F32) {
        convert_x<C::BM>(reinterpret_cast<const float*>(st), st + C::X, ct);
      }
      fence_async_shared();
      bar_sync(1, TM_CONSUMERS);  // the stage's B (and A) tiles are whole
      const uint32_t a_addr = smem_u32(st + (C::F32 ? C::X : 0)) +
                              c * SLABS * 64 * 128;
      const uint32_t b_addr = smem_u32(b);
#pragma unroll
      for (int j = 0; j < SLABS; ++j) fence_acc(acc[j]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TM_BK / 16; ++kk) {
        const uint64_t bd = smem_desc(b_addr + kk * 2048, TM_BK * 128, 1024);
#pragma unroll
        for (int j = 0; j < SLABS; ++j) {
          wgmma<BN>(acc[j], smem_desc(a_addr + j * 8192 + kk * 32, 16, 1024),
                    bd);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < SLABS; ++j) fence_acc(acc[j]);
      // keep this step in flight; the step before has finished reading
      // its stage, which goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < SLABS; ++j) fence_acc(acc[j]);
      if (i > 0 && ct % 128 == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < SLABS; ++j) fence_acc(acc[j]);
    mbar_wait(scale_bar, 0);
    bar_sync(1, TM_CONSUMERS);  // both warpgroups are done with the stages

    // epilogue: row-major [SLABS * 64][BN] per warpgroup in the stages'
    // space
    const int rows0 = c * SLABS * 64;
    T* o = reinterpret_cast<T*>(smem) + rows0 * BN;
    const int lane = ct % 32;
    const int r = (ct % 128) / 32 * 16 + lane / 4;
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + 2 * (lane % 4);
        const float s0 = sc[col], s1 = sc[col + 1];
        T* row = o + (sl * 64 + r) * BN + col;
        store2<T>(row, acc[sl][4 * j] * s0, acc[sl][4 * j + 1] * s1);
        store2<T>(row + 8 * BN, acc[sl][4 * j + 2] * s0,
                  acc[sl][4 * j + 3] * s1);
      }
    }
    fence_async_shared();
    bar_sync(2 + c, 128);
    if (ct % 128 == 0 && m0 + rows0 < m) tma_store(&o_map, o, n0, m0 + rows0);
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

// A 2-D map over a row-major [rows, cols] tensor, boxes [box_rows,
// box_cols]; elements outside the tensor read as zero and are not written.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int esize,
            const void* base, int rows, int cols, int box_rows, int box_cols,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int SLABS, int BN>
int launch_tiled(const void* x, const void* w, const void* scale, void* out,
                 int m, int k, int n, cudaStream_t s) {
  using C = Tiled<T, SLABS, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tiled_kernel<T, SLABS, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const CUtensorMapDataType xt = C::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap xm, wm, sm, om;
  const bool ok =
      encode(&xm, xt, sizeof(T), x, m, k, C::BM, TM_BK,
             C::F32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, k, n, TM_BK, BN,
             CU_TENSOR_MAP_SWIZZLE_NONE) &&
      encode(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale, 1, n, 1, BN,
             CU_TENSOR_MAP_SWIZZLE_NONE) &&
      encode(&om, xt, sizeof(T), out, m, n, 64 * SLABS, BN,
             CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + C::BM - 1) / C::BM);
  tiled_kernel<T, SLABS, BN><<<grid, TM_THREADS, C::SMEM, s>>>(
      xm, wm, sm, om, m, k);
  return (int)cudaGetLastError();
}

// The tile shapes (SLABS, BN): 256 x 128 (bf16 x only, whose stages fit
// it), 128 x 128, 128 x 64.
constexpr int TM_N_SHAPES = 3;
constexpr int TM_SHAPES[TM_N_SHAPES][2] = {{2, 128}, {1, 128}, {1, 64}};
// Device time of one 64-deep k step of a block of each shape, in 10 ns:
// a block's time over its waves and its k steps, measured on an H100 by
// `python -m lambdipy_tpu_torch.tile_probe` (the same at m=16 as on a
// full card for 128 x 64: a step computes every row of the tile, filled
// or not).
constexpr int TM_STEP[TM_N_SHAPES] = {90, 58, 39};
constexpr int TM_SMS = 132;  // the H100's streaming multiprocessors

// The tile shape for an m x n output: the fewest step times, counted as
// waves of blocks over the card times a block's step time; ties go to
// the earlier shape. Only which block computes an element depends on
// it, not the order in which the element is summed.
int tiled_shape(int m, int n, bool f32) {
  int best = -1;
  long best_cost = 0;
  for (int i = 0; i < TM_N_SHAPES; ++i) {
    if (f32 && i == 0) continue;
    const int bm = 128 * TM_SHAPES[i][0];
    const int bn = TM_SHAPES[i][1];
    const long blocks = (long)((m + bm - 1) / bm) * ((n + bn - 1) / bn);
    const long cost = (blocks + TM_SMS - 1) / TM_SMS * TM_STEP[i];
    if (best < 0 || cost < best_cost) best = i, best_cost = cost;
  }
  return best;
}

template <typename T>
int launch_tiled_shape(int shape, const void* x, const void* w,
                       const void* sc, void* out, int m, int k, int n,
                       cudaStream_t s) {
  switch (shape) {
    case 1: return launch_tiled<T, 1, 128>(x, w, sc, out, m, k, n, s);
    case 2: return launch_tiled<T, 1, 64>(x, w, sc, out, m, k, n, s);
  }
  if constexpr (sizeof(T) == 2) {
    if (shape == 0) return launch_tiled<T, 2, 128>(x, w, sc, out, m, k, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- gemv
constexpr int GV_WARPS = 8;   // warps of a block; warp w takes the split's
                              // k steps w, w + 8, w + 16, ...
constexpr int GV_STEP = 16;   // k per step: one mma m16n8k16
constexpr int GV_ROWS = 64;   // rows of a block; more on the grid's z axis
constexpr int GV_MAX_SPLITS = 8;  // a column tile's partials to merge
constexpr int GV_WIDE_MIN_N = 2048;  // the least n for 16 columns a lane
constexpr int GV_THREADS = 32 * GV_WARPS;

// 16 columns a lane (16-byte loads, 128 columns a block) where every
// lane's 16 are whole (n % 16 == 0 keeps the loads aligned), n is wide
// enough to fill the card with at most GV_MAX_SPLITS splits, and the
// accumulators fit (m <= 16); else 8 columns (64 a block). Only which
// block, lane and mma row an element takes changes, not its order.
inline int gemv_lane_cols(int n, int m) {
  return n % 16 == 0 && n >= GV_WIDE_MIN_N && m <= 16 ? 16 : 8;
}

// x as loaded for one lane and step: 4 consecutive k of one row
template <typename T>
using XRaw = typename std::conditional<sizeof(T) == 2, uint2, float4>::type;

// MG: groups of 8 rows a block computes (1, 2, 4 or 8: m up to 8, 16, 32,
// 64). CW: columns a lane loads from each of its k rows (8 or 16); a
// block owns 8 * CW columns. DEPTH: k steps a warp keeps in flight, in
// registers (more did not pay on an H100, nor did a cp.async ring in
// shared memory). MIN_BLOCKS: blocks an SM holds, two where a lane's
// 2 * MG * CW accumulators are at most 32 (more spill there). Shared
// memory holds the reduction buffer, LANE floats a lane (4 past its
// 2 * CW * MG against bank conflicts).
template <int MG, int CW>
struct Gemv {
  static constexpr int COLS = 8 * CW;
  static constexpr int MMAS = CW / 2;
  static constexpr int DEPTH = CW == 16 || MG > 2 ? 2 : 4;
  static constexpr int MIN_BLOCKS = MG * CW <= 16 ? 2 : 1;
  static constexpr int LANE = 2 * CW * MG + 4;
  static constexpr int SMEM = GV_THREADS * LANE * 4;
  static constexpr int CHUNKS = 8 * MG * CW;  // 8 columns of a row each
  using W = typename std::conditional<CW == 8, uint2, uint4>::type;
};

__device__ __forceinline__ void ld_stream(const int8_t* p, uint2& v) {
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
}
__device__ __forceinline__ void ld_stream(const int8_t* p, uint4& v) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
}
__device__ __forceinline__ uint32_t word(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// x[row][kr .. kr + 3] (zero past k or past the block's rows); vec: the
// row stride and base allow one aligned vector load
template <typename T>
__device__ __forceinline__ XRaw<T> load_x(const T* x, int row, int rows,
                                          int kr, int k, bool vec) {
  XRaw<T> v{};
  if (row < rows && kr < k) {
    const T* p = x + (size_t)row * k + kr;
    if (vec) {
      v = __ldg(reinterpret_cast<const XRaw<T>*>(p));
    } else {
      T e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = kr + i < k ? p[i] : from_f<T>(0.f);
      memcpy(&v, e, sizeof v);
    }
  }
  return v;
}

// the B fragment {x[kr], x[kr + 1]}, {x[kr + 2], x[kr + 3]} in bf16
__device__ __forceinline__ void x_frag(uint2 v, uint32_t& b0, uint32_t& b1) {
  b0 = v.x;
  b1 = v.y;
}
__device__ __forceinline__ void x_frag(float4 v, uint32_t& b0, uint32_t& b1) {
  b0 = pack_bf16(v.x, v.y);
  b1 = pack_bf16(v.z, v.w);
}

// {bf16(byte b of u), bf16(byte b of v)} for words already XORed with
// 0x80808080, exactly, as int8x8_to_bf16: the f32 2^23 + byte - (2^23 +
// 128) is the int8 value, whose low 16 bits are zero, so its top half is
// its bf16
__device__ __forceinline__ uint32_t pair_bf16(uint32_t u, uint32_t v, int b) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b));
  const float hi = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 + b));
  return __byte_perm(__float_as_uint(lo - 8388736.f),
                     __float_as_uint(hi - 8388736.f), 0x7632);
}

// The A fragments of a lane's CW / 2 mmas from its CW columns of 4 k
// rows. mma j: A row g is column CW g + 2j, row g + 8 column CW g + 2j +
// 1; the lane's logical k 2t, 2t + 1, 2t + 8, 2t + 9 are the physical
// rows 4t .. 4t + 3 (the same permutation for x, whatever m).
template <int CW, typename W>
__device__ __forceinline__ void a_frags(const W (&q)[4],
                                        uint32_t (&a)[CW / 2][4]) {
  uint32_t u[4][CW / 4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < CW / 4; ++i) u[r][i] = word(q[r], i) ^ 0x80808080u;
  }
#pragma unroll
  for (int j = 0; j < CW / 2; ++j) {
    const int wd = j / 2, b = 2 * (j % 2);
    a[j][0] = pair_bf16(u[0][wd], u[1][wd], b);
    a[j][1] = pair_bf16(u[0][wd], u[1][wd], b + 1);
    a[j][2] = pair_bf16(u[2][wd], u[3][wd], b);
    a[j][3] = pair_bf16(u[2][wd], u[3][wd], b + 1);
  }
}

// d[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load8_l2(const float* p, float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// One block: 8 * CW columns (blockIdx.x), one split of k (blockIdx.y:
// rows [split * depth, min(k, (split + 1) * depth)), depth a multiple of
// 16 * GV_WARPS), rows [64 z, 64 z + 64) of x (blockIdx.z), of which it
// computes the first 8 * MG. Lane (g, t) of a warp loads columns CW g ..
// CW g + CW - 1 of k rows 4t .. 4t + 3 of each of its steps. ws: the
// workspace [splits, m, n]; counters: one per (z, 64 columns), zero on
// entry and on exit; both unused with one split.
template <int MG, int CW, typename T>
__global__ void __launch_bounds__(GV_THREADS, Gemv<MG, CW>::MIN_BLOCKS)
    gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, T* __restrict__ out,
                float* __restrict__ ws, unsigned* __restrict__ counters,
                int m, int k, int n, int depth, int xvec) {
  using C = Gemv<MG, CW>;
  using W = typename C::W;
  extern __shared__ __align__(16) float red[];  // [GV_THREADS][C::LANE]
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int col = blockIdx.x * C::COLS + CW * g;
  const int split = blockIdx.y, splits = gridDim.y;
  const int row0 = blockIdx.z * GV_ROWS;
  const int rows = min(GV_ROWS, m - row0);
  const int kb = split * depth;
  const int steps = (min(k, kb + depth) - kb + GV_STEP - 1) / GV_STEP;
  const int mine =
      warp < steps ? (steps - warp + GV_WARPS - 1) / GV_WARPS : 0;
  x += (size_t)row0 * k;
  const int kr0 = kb + GV_STEP * warp + 4 * t;  // the lane's first k row
  const int8_t* wp = w + (size_t)kr0 * n + col;
  const size_t wstep = (size_t)GV_STEP * GV_WARPS * n;
  const bool colok = col < n;

  float acc[MG][C::MMAS][4];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
    for (int j = 0; j < C::MMAS; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mg][j][i] = 0.f;
    }
  }
  W wq[C::DEPTH][4];
  XRaw<T> xq[C::DEPTH][MG];
  // the weights and x of the warp's step i into ring slot d
  auto fetch = [&](int i, int d) {
    const int kr = kr0 + GV_STEP * GV_WARPS * i;
    const int8_t* p = wp + i * wstep;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (colok && kr + r < k) {
        ld_stream(p + (size_t)r * n, wq[d][r]);
      } else {
        wq[d][r] = W{};
      }
    }
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      xq[d][mg] = load_x<T>(x, 8 * mg + g, rows, kr, k, xvec);
    }
  };
#pragma unroll
  for (int d = 0; d < C::DEPTH; ++d) {
    if (d < mine) fetch(d, d);
  }
  for (int i0 = 0; i0 < mine; i0 += C::DEPTH) {
#pragma unroll
    for (int d = 0; d < C::DEPTH; ++d) {
      const int i = i0 + d;
      if (i < mine) {
        uint32_t a[C::MMAS][4], b[MG][2];
        a_frags<CW>(wq[d], a);
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) x_frag(xq[d][mg], b[mg][0], b[mg][1]);
        if (i + C::DEPTH < mine) fetch(i + C::DEPTH, d);
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
          for (int j = 0; j < C::MMAS; ++j) {
            mma_bf16(acc[mg][j], a[j], b[mg][0], b[mg][1]);
          }
        }
      }
    }
  }

  // The warps' sums in warp order. Accumulator i of mma j, group mg holds
  // row 8 mg + 2t + (i & 1), column CW g + 2j + (i >> 1): a lane leaves,
  // per (mg, h = row parity), its CW columns in order, in chunks of 8.
  float* mine_red = red + threadIdx.x * C::LANE;
#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4* q = reinterpret_cast<float4*>(mine_red + (2 * mg + h) * CW);
#pragma unroll
      for (int j = 0; j < C::MMAS; j += 2) {
        q[j / 2] = make_float4(acc[mg][j][h], acc[mg][j][h + 2],
                               acc[mg][j + 1][h], acc[mg][j + 1][h + 2]);
      }
    }
  }
  __syncthreads();
  // chunk c: 8 columns of one row, the (c / 32)-th chunk of lane c % 32
  auto chunk = [&](int c, int& row, int& cc) {
    const int cl = c % 32, ch = c / 32, mgh = ch / (CW / 8);
    row = 8 * (mgh / 2) + 2 * (cl % 4) + mgh % 2;
    cc = blockIdx.x * C::COLS + CW * (cl / 4) + 8 * (ch % (CW / 8));
  };
  auto finish = [&](int c, float (&v)[8]) {
    int row, cc;
    chunk(c, row, cc);
    if (row >= rows || cc >= n) return;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= __ldg(scale + cc + e);
    store8<T>(out + (size_t)(row0 + row) * n + cc, v);
  };
  for (int c = threadIdx.x; c < C::CHUNKS; c += GV_THREADS) {
    const float* src = red + (c % 32) * C::LANE + (c / 32) * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[e];
#pragma unroll
    for (int wi = 1; wi < GV_WARPS; ++wi) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += src[wi * 32 * C::LANE + e];
    }
    if (splits == 1) {
      finish(c, v);
    } else {
      int row, cc;
      chunk(c, row, cc);
      if (row < rows && cc < n) {
        store8<float>(ws + ((size_t)split * m + row0 + row) * n + cc, v);
      }
    }
  }
  if (splits == 1) return;

  // the last block of the column tile to arrive merges the splits, in
  // split order, and zeroes the tile's counter for the next call
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.z * ((n + 63) / 64) +
                      blockIdx.x * (C::COLS / 64);
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = threadIdx.x; c < C::CHUNKS; c += GV_THREADS) {
    int row, cc;
    chunk(c, row, cc);
    if (row >= rows || cc >= n) continue;
    const float* src = ws + (size_t)(row0 + row) * n + cc;
    const size_t stride = (size_t)m * n;
    float v[8];
    load8_l2(src, v);
#pragma unroll 4
    for (int sp = 1; sp < splits; ++sp) {
      float u[8];
      load8_l2(src + sp * stride, u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += u[e];
    }
    finish(c, v);
  }
  if (threadIdx.x == 0) *counter = 0u;
}

template <int MG, int CW, typename T>
int launch_gemv(const T* x, const int8_t* w, const float* sc, T* out,
                float* ws, unsigned* counters, int m, int k, int n,
                int splits, int depth, cudaStream_t s) {
  using C = Gemv<MG, CW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_kernel<MG, CW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int xvec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const dim3 grid((n + C::COLS - 1) / C::COLS, splits,
                  (m + GV_ROWS - 1) / GV_ROWS);
  gemv_kernel<MG, CW, T><<<grid, GV_THREADS, C::SMEM, s>>>(
      x, w, sc, out, ws, counters, m, k, n, depth, xvec);
  return (int)cudaGetLastError();
}

// The row groups a block computes and the lane width follow m and n
// (neither changes an element's order); the split plan is the caller's
template <typename T>
int launch_gemv_rows(const void* xv, const void* wv, const void* sv, void* ov,
                     float* ws, unsigned* cnt, int m, int k, int n,
                     int splits, int depth, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* sc = static_cast<const float*>(sv);
  T* out = static_cast<T*>(ov);
#define GV_LAUNCH(MG, CW) \
  launch_gemv<MG, CW, T>(x, w, sc, out, ws, cnt, m, k, n, splits, depth, s)
  if (gemv_lane_cols(n, m) == 16) {
    return m <= 8 ? GV_LAUNCH(1, 16) : GV_LAUNCH(2, 16);
  }
  if (m <= 8) return GV_LAUNCH(1, 8);
  if (m <= 16) return GV_LAUNCH(2, 8);
  if (m <= 32) return GV_LAUNCH(4, 8);
  return GV_LAUNCH(8, 8);
#undef GV_LAUNCH
}

template <typename T>
int launch(const void* x, const void* w, const void* sc, void* out, int m,
           int k, int n, int route, cudaStream_t s) {
  if (route < 0) route = tiled_shape(m, n, sizeof(T) == 4);
  return launch_tiled_shape<T>(route, x, w, sc, out, m, k, n, s);
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16. route: -1 the tiled
// route with the tile shape the kernel picks, 0.. the tiled route with that
// tile shape (an index into TM_SHAPES; 0 only for bfloat16). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue when a
// tensor map cannot be encoded. The caller checks shapes, alignment and
// contiguity.
extern "C" int int8_matmul_launch(int dtype, const void* x, const void* w,
                                  const void* scale, void* out, int m, int k,
                                  int n, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scale, out, m, k, n, route, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, out, m, k, n, route, s);
  return (int)cudaErrorInvalidValue;
}

// The GEMV. splits, depth: k in splits ranges of depth rows
// (ops/quant.py::gemv_plan), depth a multiple of GV_STEP * GV_WARPS that
// leaves no split empty, at most GV_MAX_SPLITS splits. ws: f32 [splits,
// m, n]; counters: ceil(m / 64) * ceil(n / 64) unsigned, zero, left zero;
// one set per stream; both may be null with one split. Returns
// cudaErrorInvalidValue for a plan that does not cover k.
extern "C" int int8_matmul_gemv_launch(int dtype, const void* x,
                                       const void* w, const void* scale,
                                       void* out, void* ws, void* counters,
                                       int m, int k, int n, int splits,
                                       int depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || k < 1 || n < 1 || splits < 1 || splits > GV_MAX_SPLITS ||
      depth % (GV_STEP * GV_WARPS) != 0 || (long)splits * depth < k ||
      (long)(splits - 1) * depth >= k ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  unsigned* cnt = static_cast<unsigned*>(counters);
  if (dtype == 0)
    return launch_gemv_rows<float>(x, w, scale, out, wsf, cnt, m, k, n,
                                   splits, depth, s);
  if (dtype == 1)
    return launch_gemv_rows<__nv_bfloat16>(x, w, scale, out, wsf, cnt, m, k,
                                           n, splits, depth, s);
  return (int)cudaErrorInvalidValue;
}

// The GEMV's geometry, checked by the wrapper when the library loads: 0
// warps of a block, 1 k per step, 2 rows of a block, 3 the most splits, 4
// the least n for 16 columns a lane.
extern "C" int int8_matmul_gemv_geometry(int i) {
  const int g[5] = {GV_WARPS, GV_STEP, GV_ROWS, GV_MAX_SPLITS, GV_WIDE_MIN_N};
  return i >= 0 && i < 5 ? g[i] : -1;
}
