// Int8 weight-only matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lambdipy_tpu/ops/quant.py::_kernel,
// reached through int8_matmul. It computes what that kernel body
// computes: out[m, n] = (bf16(x) @ bf16(w_int8)) accumulated in f32, times
// the per-output-channel f32 scale once at the end, cast to x's dtype.
// x is [m, k] float32 or bfloat16, w is [k, n] int8 row-major (the
// layout QDense keeps), scale is [1, n] float32, out is [m, n] in x's
// dtype. n must be a multiple of 8 and w 16-byte aligned.
//
// What bounds it on the H100: at decode (m = 1 to 8) bytes — the k * n
// int8 weights are read once per call and each weight byte feeds only 2m
// flops, far below the ~295 flop/byte ridge; at prefill (m in the
// thousands) operations. Two paths therefore:
//
// * gemv (m <= 8): threads side by side along n read contiguous int8 (8
//   bytes a thread, 64 bytes per row segment), the block splits k over 32
//   slices so every SM has loads in flight, accumulates m x 8 outputs per
//   thread in f32 registers, and reduces the slices by warp shuffles and
//   shared memory. The x rows are read through the cache (every thread
//   of a slice reads the same value).
// * tiled (m > 8): 64 x 64 output tiles, 32-deep k steps staged in shared
//   memory as bf16 (int8 -> bf16 is exact), and the tensor cores through
//   mma.sync m16n8k16 bf16 with f32 accumulators; four warps each own a
//   32 x 32 sub-tile. No cp.async pipelining yet: loads and math do not
//   overlap, which is the next step for speed.
//
// Launches on the caller's stream, allocates nothing.

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
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
  return x;
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

template <int M, typename T>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int k, int n) {
  const int cn = threadIdx.x % GV_TN;
  const int ks = threadIdx.x / GV_TN;
  const int col0 = blockIdx.x * GV_BN + cn * 8;
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
        const float xv = bf16_round(x[(size_t)mi * k + kk]);
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
    if (col < n) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < GV_WARPS; ++wi) s += red[wi][mi][c];
      out[(size_t)mi * n + col] = from_f<T>(s * scale[col]);
    }
  }
}

// --------------------------------------------------------------- tiled
constexpr int TB_M = 64;
constexpr int TB_N = 64;
constexpr int TB_K = 32;
constexpr int TB_THREADS = 128;
constexpr int TB_PAD = TB_K + 8;  // row stride in bf16: conflict-free frags

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(TB_THREADS) tiled_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int m, int k,
    int n) {
  __shared__ __align__(16) __nv_bfloat16 as[TB_M][TB_PAD];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 bs[TB_N][TB_PAD];  // [col][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // warp's sub-tile origin
  const int wn = (warp & 1) * 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = blockIdx.y * TB_M;
  const int col0 = blockIdx.x * TB_N;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < k; k0 += TB_K) {
    for (int i = tid; i < TB_M * TB_K; i += TB_THREADS) {
      const int r = i / TB_K;
      const int c = i % TB_K;
      const int gr = row0 + r;
      const int gc = k0 + c;
      as[r][c] = (gr < m && gc < k) ? to_bf16(x[(size_t)gr * k + gc])
                                    : __float2bfloat16(0.f);
    }
    for (int i = tid; i < TB_K * (TB_N / 4); i += TB_THREADS) {
      const int r = i / (TB_N / 4);
      const int c = (i % (TB_N / 4)) * 4;
      const int gr = k0 + r;
      const int gc = col0 + c;
      char4 q = make_char4(0, 0, 0, 0);
      if (gr < k && gc < n) {
        q = *reinterpret_cast<const char4*>(w + (size_t)gr * n + gc);
      }
      bs[c + 0][r] = __float2bfloat16((float)q.x);
      bs[c + 1][r] = __float2bfloat16((float)q.y);
      bs[c + 2][r] = __float2bfloat16((float)q.z);
      bs[c + 3][r] = __float2bfloat16((float)q.w);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 2 * tq]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 2 * tq]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 2 * tq + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn + nt * 8 + g;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 2 * tq]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 2 * tq + 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                   b0, b1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int c = col0 + wn + nt * 8 + 2 * tq + (e & 1);
        if (r < m && c < n) {
          out[(size_t)r * n + c] = from_f<T>(acc[mt][nt][e] * scale[c]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* xv, const void* wv, const void* sv, void* ov, int m,
           int k, int n, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* sc = static_cast<const float*>(sv);
  T* out = static_cast<T*>(ov);
  const dim3 gv((n + GV_BN - 1) / GV_BN);
  switch (m) {
    case 1: gemv_kernel<1, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    case 2: gemv_kernel<2, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    case 3: gemv_kernel<3, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    case 4: gemv_kernel<4, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    case 5: gemv_kernel<5, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    case 6: gemv_kernel<6, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    case 7: gemv_kernel<7, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    case 8: gemv_kernel<8, T><<<gv, GV_THREADS, 0, s>>>(x, w, sc, out, k, n); break;
    default: {
      const dim3 grid((n + TB_N - 1) / TB_N, (m + TB_M - 1) / TB_M);
      tiled_kernel<T><<<grid, TB_THREADS, 0, s>>>(x, w, sc, out, m, k, n);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch. The caller checks shapes, n % 8,
// alignment and contiguity.
extern "C" int int8_matmul_launch(int dtype, const void* x, const void* w,
                                  const void* scale, void* out, int m, int k,
                                  int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scale, out, m, k, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, scale, out, m, k, n, s);
  return (int)cudaErrorInvalidValue;
}
