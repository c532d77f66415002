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
// * gemv: n % 8 == 0, w 16-byte aligned;
// * tiled: n % 16 == 0, k % 8 == 0 (bf16 x) or k % 4 == 0 (f32 x), and
//   x, w, scale 16-byte aligned: the tensor-memory accelerator (TMA)
//   wants 16-byte row strides and bases.
//
// What bounds it on the H100: at decode (m = 1 to 8) bytes — the k * n
// int8 weights are read once per call and each weight byte feeds only 2m
// flops, far below the ~295 flop/byte ridge; at prefill operations from
// m ~ 300 up, bytes below (m = 128 moves 2 * 128 flops per weight byte).
// Two routes therefore:
//
// * gemv (decode, m = the batch's rows): threads side by side along n
//   read contiguous int8 (8 bytes a thread, 64 bytes per row segment),
//   the block splits k over 32 slices so every SM has loads in flight,
//   accumulates up to 8 rows x 8 outputs per thread in f32 registers, and
//   reduces the slices by warp shuffles and shared memory. The x rows are
//   read through the cache (every thread of a slice reads the same
//   value). Above 8 rows the grid's y axis takes groups of 8 rows, each
//   reading the weights again (m = 16 reads them twice).
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
// alone). The GEMV sums each row in its own registers in an order fixed
// by k, whatever the row count or the row's group of 8. The tiled route
// sums every element over k in one order fixed by k alone —
// 64-deep stages in order, four k16 wgmmas in order, each into the same
// f32 accumulator, with no split of k. The tile shape and the grid, which
// do depend on m, change which block computes an element, never its
// order.
//
// Launches on the caller's stream, allocates nothing.

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------- gemv
constexpr int GV_THREADS = 256;
constexpr int GV_TN = 8;                     // threads along n
constexpr int GV_TK = GV_THREADS / GV_TN;    // k slices
constexpr int GV_BN = GV_TN * 8;             // columns per block
constexpr int GV_WARPS = GV_THREADS / 32;

// One block: GV_BN columns of M rows. GROUPS (m > 8): the rows from
// blockIdx.y * M, read through 32-bit offsets from the group's first row
// (rows past m read row m - 1 and are not written); else rows 0 .. M - 1
// of an m = M call. Each row sums in its own registers in an order fixed
// by k alone, whatever M, m or the row group.
template <int M, typename T, bool GROUPS>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int m, int k,
    int n) {
  const int cn = threadIdx.x % GV_TN;
  const int ks = threadIdx.x / GV_TN;
  const int col0 = blockIdx.x * GV_BN + cn * 8;
  const int row0 = GROUPS ? blockIdx.y * M : 0;
  int xoff[M];
  if constexpr (GROUPS) {
    x += (size_t)row0 * k;
#pragma unroll
    for (int mi = 0; mi < M; ++mi) xoff[mi] = min(mi, m - 1 - row0) * k;
  }
  float acc[M][8];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mi][i] = 0.f;
  }
  if (col0 < n) {
    const int8_t* wp = w + col0;
#pragma unroll 4
    for (int kk = ks; kk < k; kk += GV_TK) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(wp + (size_t)kk * n));
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
      float wf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) wf[i] = (float)q[i];
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        const float xv = bf16_round(GROUPS ? x[xoff[mi] + kk]
                                           : x[(size_t)mi * k + kk]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[mi][i] += xv * wf[i];
      }
    }
  }
  // threadIdx = ks * 8 + cn: lanes 8 and 16 apart hold the same columns
  // for the warp's four k slices
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float s = acc[mi][i];
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      acc[mi][i] = s;
    }
  }
  __shared__ float red[GV_WARPS][M][GV_BN];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) < GV_TN) {
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
#pragma unroll
      for (int i = 0; i < 8; ++i) red[warp][mi][cn * 8 + i] = acc[mi][i];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < M * GV_BN; o += GV_THREADS) {
    const int mi = o / GV_BN;
    const int c = o % GV_BN;
    const int col = blockIdx.x * GV_BN + c;
    if (col < n && (!GROUPS || row0 + mi < m)) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < GV_WARPS; ++wi) s += red[wi][mi][c];
      out[(size_t)(row0 + mi) * n + col] = from_f<T>(s * scale[col]);
    }
  }
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

constexpr int ROUTE_GEMV = -2;  // the launch's route: the GEMV

template <typename T>
int launch(const void* xv, const void* wv, const void* sv, void* ov, int m,
           int k, int n, int route, cudaStream_t s) {
  if (route != ROUTE_GEMV) {
    if (route < 0) route = tiled_shape(m, n, sizeof(T) == 4);
    return launch_tiled_shape<T>(route, xv, wv, sv, ov, m, k, n, s);
  }
  const T* x = static_cast<const T*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* sc = static_cast<const float*>(sv);
  T* out = static_cast<T*>(ov);
  // up to 8 rows in one block; above, groups of 8 on the grid's y axis
  const dim3 gv((n + GV_BN - 1) / GV_BN, (m + 7) / 8);
  switch (m) {
    case 1: gemv_kernel<1, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    case 2: gemv_kernel<2, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    case 3: gemv_kernel<3, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    case 4: gemv_kernel<4, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    case 5: gemv_kernel<5, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    case 6: gemv_kernel<6, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    case 7: gemv_kernel<7, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    case 8: gemv_kernel<8, T, false><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
    default: gemv_kernel<8, T, true><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, m, k, n); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16. route: -2 the GEMV
// (any m; rows in groups of 8), -1 the tiled route with the tile shape the
// kernel picks, 0.. the tiled route with that tile shape (an index into
// TM_SHAPES; 0 only for bfloat16). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue when a tensor map cannot be encoded.
// The caller checks shapes, alignment and contiguity.
extern "C" int int8_matmul_launch(int dtype, const void* x, const void* w,
                                  const void* scale, void* out, int m, int k,
                                  int n, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scale, out, m, k, n, route, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, out, m, k, n, route, s);
  return (int)cudaErrorInvalidValue;
}
