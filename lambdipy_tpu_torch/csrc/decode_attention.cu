// Length-aware GQA decode attention for Hopper (sm_90a), over a
// contiguous or a paged KV cache.
//
// Replaces two Pallas TPU kernels of lambdipy_tpu/ops/decode_attention.py:
// ::_decode_kernel, both of its branches, reached through
// blocked_decode_attention / decode_attention (the contiguous addressing
// below), and ::_paged_kernel, both of its branches, reached through
// paged_blocked_decode_attention / paged_decode_attention (the paged
// addressing below). Both branches of each:
//
// * float KV: k/v in q's dtype;
// * int8 KV (kv_quant="int8"): k/v int8 with per-(position, kv head) f32
//   scales k_scale/v_scale [b, t, kvh, 1]. Each element is dequantized as
//   the TPU kernel body does (decode_attention.py:134-137): int8 times
//   its f32 scale in f32, rounded to q's dtype, then used exactly as the
//   float branch uses a K/V element.
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
// The int8 branch moves 1 byte per K/V element plus 4 bytes of scale per
// (position, kv head): at d = 128 about 0.52 of the bf16 branch's bytes.
// It reads the scale of a position once per warp (a broadcast load) and
// dequantizes in registers; no int8 element is ever widened in memory.
//
// Layouts are the JAX package's: q [b, 1, h, d], k/v [b, t, kvh, d]
// (contiguous, heads grouped, not pre-broadcast), scales [b, t, kvh, 1],
// active_len [b] int32, out [b, 1, h, d]. Launches on the caller's
// stream, allocates nothing.
//
// Paged addressing (kernel 3): K/V live in a page arena [P, page, kvh, d]
// (scales [P, page, kvh, 1]) and row r's position p sits in page
// tables[r, p / page] at offset p % page (tables [b, nb] int32, page a
// power of two). The kernel is the same template: only the map from a
// position to its storage slot differs, so on equal K/V values the paged
// output is bitwise the contiguous one. Each 64-position tile first
// copies the page ids it spans into shared memory (the table is read
// once per page, never per element); a tile may span several pages, so
// every position resolves its own page and any power-of-two page works.
// Nothing past a row's active_len is read. At active_len <= 0 the
// uniform mean runs over all nb * page table positions, null pages
// included, as the gather reference gives. The TPU kernel's grid walks
// one page per step in series with the table in scalar prefetch; here
// the page lookup rides inside the tile loop and costs one shared-memory
// read per position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// One K/V element as the float branch sees it. Float KV: the element
// itself. Int8 KV: int8 * f32 scale in f32, rounded to T.
template <typename T>
__device__ __forceinline__ float kv_elem(const T* p, size_t i, float) {
  return to_f(p[i]);
}
template <typename T>
__device__ __forceinline__ float kv_elem(const int8_t* p, size_t i,
                                         float sc) {
  return to_f(from_f<T>((float)p[i] * sc));
}

// Where position p of one (row, kv head) lives: `kv`, the offset in
// elements of its d-vector in the K/V storage, and `sc`, the index of
// its scale. Contiguous ([b, t, kvh, d]): affine in p from the
// (row, head) origins kv0 and sc0, which keeps kernel 1's pointer
// arithmetic (a slot index multiplied out per position made kernel 1 up
// to 24% slower on an H100).
// Paged ([P, page, kvh, d]): p's page from the tile's page ids pid_s
// (entry page0 of the row's table first) plus p's offset in the page;
// kv0 and sc0 are then the head's offsets within a slot.
struct Slot {
  size_t kv, sc;
};

template <bool PAGED>
__device__ __forceinline__ Slot slot_of(int p, size_t kv0, size_t sc0,
                                        size_t pos_stride, int kvh,
                                        const int* pid_s, int page0,
                                        int page_shift) {
  if constexpr (PAGED) {
    const size_t s = ((size_t)pid_s[(p >> page_shift) - page0]
                      << page_shift) + (size_t)(p & ((1 << page_shift) - 1));
    return {kv0 + s * pos_stride, sc0 + s * kvh};
  } else {
    return {kv0 + (size_t)p * pos_stride, sc0 + (size_t)p * kvh};
  }
}

// KV is T (float branch, k_scale/v_scale unused) or int8_t (int8
// branch). PAGED false: k/v are [b, t, kvh, d], tables unused. PAGED
// true: k/v are the arena [P, 1 << page_shift, kvh, d], row r's block
// table is tables[r * nb .. r * nb + nb), and t = nb << page_shift.
template <typename T, typename KV, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ active_len, T* __restrict__ out, int t, int nb,
    int page_shift, int kvh, int group, int d, float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
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
  __shared__ int pid_s[TILE];  // paged: the page ids of the current tile

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
  // contiguous: the (row, head) origins; paged: the head within a slot
  const size_t kv0 = (PAGED ? 0 : (size_t)row * t * pos_stride) +
                     (size_t)head * d;
  const size_t sc0 = (PAGED ? 0 : (size_t)row * t * kvh) + head;

  for (int t0 = 0; t0 < alen; t0 += TILE) {
    const int n = min(TILE, alen - t0);
    const int page0 = t0 >> page_shift;
    if constexpr (PAGED) {
      // the tile's page ids, one table read per page; the previous
      // tile's closing __syncthreads guards the rewrite
      const int pages = ((t0 + n - 1) >> page_shift) - page0 + 1;
      for (int i = tid; i < pages; i += THREADS) {
        pid_s[i] = tables[(size_t)row * nb + page0 + i];
      }
      __syncthreads();
    }
    // scores: each warp takes positions warp, warp + WARPS, ...; lanes
    // split the head dim and reduce by shuffles
    for (int j = warp; j < n; j += WARPS) {
      const Slot sl = slot_of<PAGED>(t0 + j, kv0, sc0, pos_stride, kvh,
                                     pid_s, page0, page_shift);
      const KV* kp = k + sl.kv;
      const float ksc = QUANT ? k_scale[sl.sc] : 0.f;
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.f;
      for (int dd = lane; dd < d; dd += 32) {
        const float kv = kv_elem<T>(kp, dd, ksc);
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
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const Slot sl = slot_of<PAGED>(t0 + j, kv0, sc0, pos_stride, kvh,
                                         pid_s, page0, page_shift);
          const float vsc = QUANT ? v_scale[sl.sc] : 0.f;
          const float vv = kv_elem<T>(v, sl.kv + dd, vsc);
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

template <typename T, typename KV, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tables, const void* active_len,
           void* out, int b, int t, int nb, int page_shift, int kvh,
           int group, int d, float scale, cudaStream_t stream) {
  decode_attention_kernel<T, KV, PAGED><<<b * kvh, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(active_len), static_cast<T*>(out), t, nb,
      page_shift, kvh, group, d, scale);
  return (int)cudaGetLastError();
}

// Picks the instantiation: dtype (of q and out) 0 = float32, 1 = bfloat16;
// scales null = float K/V in q's dtype, else int8 K/V with f32 scales.
template <bool PAGED>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* active_len, void* out, int b, int t, int nb,
             int page_shift, int kvh, int group, int d, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return quant ? launch<float, int8_t, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       b, t, nb, page_shift, kvh, group, d, scale, s)
                 : launch<float, float, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       b, t, nb, page_shift, kvh, group, d, scale, s);
  }
  if (dtype == 1) {
    return quant ? launch<__nv_bfloat16, int8_t, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       b, t, nb, page_shift, kvh, group, d, scale, s)
                 : launch<__nv_bfloat16, __nv_bfloat16, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       b, t, nb, page_shift, kvh, group, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. k_scale/v_scale null:
// k/v in q's dtype; else k/v int8 with f32 scales [b, t, kvh, 1]. Returns
// cudaGetLastError() after the launch. The caller checks group <= 8,
// d <= 256 and contiguity.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* active_len, void* out,
                                       int b, int t, int kvh, int group,
                                       int d, float scale, void* stream) {
  return dispatch<false>(dtype, q, k, v, k_scale, v_scale, nullptr,
                         active_len, out, b, t, 0, 0, kvh, group, d, scale,
                         stream);
}

// The paged form: k/v (and scales) are arenas [P, 1 << page_shift, kvh,
// d (or 1)], tables [b, nb] int32 page ids. The caller checks the shapes
// above, page a power of two and every table entry in [0, P).
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale_pages, const void* v_scale_pages, const void* tables,
    const void* active_len, void* out, int b, int nb, int page_shift,
    int kvh, int group, int d, float scale, void* stream) {
  return dispatch<true>(dtype, q, k_pages, v_pages, k_scale_pages,
                        v_scale_pages, tables, active_len, out, b,
                        nb << page_shift, nb, page_shift, kvh, group, d,
                        scale, stream);
}
