// Length-aware GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lambdipy_tpu/ops/decode_attention.py
// ::_decode_kernel (float-KV branch), reached through
// blocked_decode_attention / decode_attention. The int8-KV branch is not
// ported here.
//
// What it computes: out[b, 0, h, :] = softmax(q[b, 0, h, :] . k[b, :t_b, h/group, :]
// * scale) @ v[b, :t_b, h/group, :], with t_b = active_len[b] clamped to t.
// At active_len <= 0 every logit is the reference's -1e9 fill, so the
// result is the uniform mean of V over all t positions — the kernel
// reproduces the plain PyTorch version there (the TPU kernel returns
// zeros instead).
//
// What bounds it on the H100: bytes. One decode step reads each row's
// active K and V once (2 * t_b * kvh * d * 2 bytes in bf16) and does 4
// flops per byte-pair, far below the ~295 flop/byte ridge. The design
// therefore (a) reads only positions below active_len — nothing past a
// row's length is loaded or computed, like the TPU kernel's clamped
// index map; (b) gives one block to each (row, kv head), so a kv head's
// K/V is read once for all its `group` query heads (GQA); (c) replaces
// the TPU's sequential kv grid axis by a loop inside the block carrying
// an f32 online softmax (running max, sum and weighted-V accumulator).
// With b * kvh blocks (32 at batch 4) the grid underfills 132 SMs; a
// split-KV second pass (flash-decoding) is the next step for speed.
//
// Layouts are the JAX package's: q [b, 1, h, d], k/v [b, t, kvh, d]
// (contiguous, heads grouped, not pre-broadcast), active_len [b] int32,
// out [b, 1, h, d]. Launches on the caller's stream, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;       // K/V positions per loop iteration
constexpr int GMAX = 8;        // largest query group (heads / kv_heads)
constexpr int DMAX = 256;      // largest head dim
constexpr int DPT = DMAX / THREADS;  // head dims owned per thread in PV
constexpr float NEG_INF = -1e9f;     // the reference's mask fill

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
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

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ active_len,
    T* __restrict__ out, int t, int kvh, int group, int d, float scale) {
  const int row = blockIdx.x / kvh;
  const int head = blockIdx.x % kvh;
  const int h = kvh * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float qs[GMAX][DMAX];
  __shared__ float ps[GMAX][TILE];
  __shared__ float m_s[GMAX];
  __shared__ float l_s[GMAX];
  __shared__ float alpha_s[GMAX];

  int alen = active_len[row];
  const bool uniform = alen <= 0;
  if (uniform || alen > t) alen = t;

  const T* qrow = q + ((size_t)row * h + (size_t)head * group) * d;
  for (int i = tid; i < group * d; i += THREADS) {
    qs[i / d][i % d] = to_f(qrow[i]);
  }
  if (tid < GMAX) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[GMAX][DPT];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[g][j] = 0.f;
  }
  __syncthreads();

  const size_t pos_stride = (size_t)kvh * d;
  const size_t base = (size_t)row * t * pos_stride + (size_t)head * d;
  const T* kbase = k + base;
  const T* vbase = v + base;

  for (int t0 = 0; t0 < alen; t0 += TILE) {
    const int n = min(TILE, alen - t0);
    // scores: each warp takes positions warp, warp + WARPS, ...; lanes
    // split the head dim and reduce by shuffles
    for (int j = warp; j < n; j += WARPS) {
      const T* kp = kbase + (size_t)(t0 + j) * pos_stride;
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.f;
      for (int dd = lane; dd < d; dd += 32) {
        const float kv = to_f(kp[dd]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < group) part[g] += qs[g][dd] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < group) {
          float s = part[g];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
          }
          if (lane == 0) ps[g][j] = uniform ? NEG_INF : s * scale;
        }
      }
    }
    __syncthreads();
    // online softmax over this tile, one warp per query head
    for (int g = warp; g < group; g += WARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(ps[g][j] - m_new);
        ps[g][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // weighted V: each thread owns head dims tid, tid + THREADS
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int dd = tid + jj * THREADS;
      if (dd < d) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < group) acc[g][jj] *= alpha_s[g];
        }
        const T* vp = vbase + (size_t)t0 * pos_stride + dd;
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const float vv = to_f(vp[(size_t)j * pos_stride]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < group) acc[g][jj] += ps[g][j] * vv;
          }
        }
      }
    }
    __syncthreads();  // ps and alpha_s are rewritten by the next tile
  }

  T* orow = out + ((size_t)row * h + (size_t)head * group) * d;
#pragma unroll
  for (int jj = 0; jj < DPT; ++jj) {
    const int dd = tid + jj * THREADS;
    if (dd < d) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < group) {
          orow[(size_t)g * d + dd] =
              from_f<T>(acc[g][jj] / fmaxf(l_s[g], 1e-30f));
        }
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const void* active_len, void* out, int b, int t, int kvh,
           int group, int d, float scale, cudaStream_t stream) {
  decode_attention_kernel<T><<<b * kvh, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(active_len),
      static_cast<T*>(out), t, kvh, group, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch. The caller checks group <= 8, d <= 256 and contiguity.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* active_len, void* out,
                                       int b, int t, int kvh, int group,
                                       int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, active_len, out, b, t, kvh, group, d,
                         scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, active_len, out, b, t, kvh, group,
                                 d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
