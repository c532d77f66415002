// Length-aware GQA decode attention for Hopper (sm_90a), over a
// contiguous or a paged KV cache, as split-KV flash-decoding.
//
// Replaces two Pallas TPU kernels of lambdipy_tpu/ops/decode_attention.py:
// ::_decode_kernel (:110), both of its branches, reached through
// blocked_decode_attention (the contiguous addressing below), and
// ::_paged_kernel (:282), both of its branches, reached through
// paged_blocked_decode_attention (the paged addressing below). Both
// branches of each:
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
// flops per byte-pair, far below the ~295 flop/byte ridge. To reach the
// memory rate the card needs many blocks in flight, each with many bytes
// in flight. The design:
//
// * Split-KV (flash-decoding). A row's positions are cut into fixed
//   chunks of KV_CHUNK positions; the first pass gives one block to each
//   (row x kv head, chunk) and writes the chunk's softmax partial (running
//   max m, sum l and an unnormalized f32 accumulator per query head of
//   the group) to scratch; blocks whose chunk starts at or past the row's
//   length return at once. The grid thus scales with the active
//   positions (264 working blocks at one 4,128-position row of llama3-8b,
//   against 8 with one block per (row, kv head)). A second pass, one
//   block per (row x kv head, query head), merges the row's partials in
//   chunk order: M = max m_s, out = sum exp(m_s - M) acc_s /
//   max(sum exp(m_s - M) l_s, 1e-30). No float atomics.
// * Batch invariance. The chunk bounds, the order of every reduction
//   inside a chunk and the merge order are functions of the row's
//   active_len alone (and of the head dim and dtype), never of b, t, the
//   addressing, the SM count or the other rows, and a row with a single
//   chunk takes the same merge. So a row's output is bitwise the same
//   alone at batch 1 with one capacity t, inside a batch of 8 with
//   another, paged or contiguous, and from launch to launch: the serving
//   engine's rows stay bitwise the rows of solo generation. (At
//   active_len <= 0 the row covers its t positions, as the plain version
//   does; both addressings see the same t there.)
// * Staging for bandwidth. A chunk is walked in tiles of TILE positions
//   (64; 32 for f32 K/V, so two f32 stages fit) copied into shared memory
//   by 16-byte cp.async into two stages. Both stages are requested when
//   the chunk starts (a chunk of bf16 or int8 K/V is exactly two tiles),
//   so the second tile's copy is in flight while the first is computed;
//   f32's later tiles refill a stage after a second barrier. Neighbouring
//   threads copy neighbouring 16-byte pieces of one position's d-vector.
//   An int8 tile's scales ride along as 4-byte copies, once per position
//   per tile; a paged chunk's page ids are read from the block table once
//   per page into shared memory before its first tile, and each d-vector
//   is copied whole from its page slot.
// * No cross-warp softmax. Each group of L lanes (L = the head dim's
//   8-element vectors, rounded up to a power of two, at most 32) owns
//   every (WARPS * 32 / L)-th position of each tile and keeps its own
//   online softmax in registers. Per tile it computes its positions'
//   logits (a dot product over its L lanes, reduced by shuffles) into a
//   small shared tile, rescales its accumulator once to the new running
//   max, exponentiates its logits spread over its L lanes, and
//   accumulates p * V for its slice of the head dim. At the chunk's end
//   the lane groups' partials merge in shared memory in lane-group order.
//   The query group is a template width (1, 2, 4 or 8), so llama3-8b's
//   group of 4 holds 4 heads in registers, not 8. K/V are dequantized in
//   registers; CUDA cores do the arithmetic (4 flops per byte-pair do not
//   need tensor cores).
//
// Layouts are the JAX package's: q [b, 1, h, d], k/v [b, t, kvh, d]
// (contiguous, heads grouped, not pre-broadcast), scales [b, t, kvh, 1],
// active_len [b] int32, out [b, 1, h, d]. The caller allocates the
// partials (acc [b * kvh, nsplit, group, d] f32, m/l [b * kvh, nsplit,
// group, 2] f32, nsplit = ceil(t / KV_CHUNK)); the kernels allocate
// nothing and launch on the caller's stream.
//
// Paged addressing (kernel 3): K/V live in a page arena [P, page, kvh, d]
// (scales [P, page, kvh, 1]) and row r's position p sits in page
// tables[r, p / page] at offset p % page (tables [b, nb] int32, page a
// power of two, t = nb * page). Only the map from a position to its
// storage slot differs from the contiguous addressing, so on equal K/V
// values the paged output is bitwise the contiguous one. At
// active_len <= 0 the uniform mean runs over all nb * page table
// positions, null pages included, as the gather reference gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KV_CHUNK = 128;  // positions per split; see the header note
constexpr int GMAX = 8;        // largest query group (heads / kv_heads)
constexpr int R = 8;           // head-dim elements a lane holds per head
constexpr float NEG_INF = -1e9f;  // the reference's mask fill

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

// Tile geometry per K/V element type: EV elements per shared-memory
// vector read (16 bytes of bf16 or f32, 8 of int8), TILE positions per
// stage.
template <typename KV> struct Geo {
  static constexpr int ES = sizeof(KV);
  static constexpr int EV = ES == 4 ? 4 : 8;
  static constexpr int TILE = ES == 4 ? 32 : 64;
  static constexpr int NV = R / EV;  // vectors a lane holds per head
};

// Lanes per position: the head dim's EV-element vectors rounded up to a
// power of two, at most 32 (so a lane holds at most R elements: d <= 256).
__host__ __device__ inline int lanes_per_pos(int nev) {
  int lanes = 1;
  while (lanes < nev && lanes < 32) lanes <<= 1;
  return lanes;
}

// Shared memory of the split kernel, in bytes: two stages of K and V
// tiles (reused by the lane-group merge at the chunk's end), then the
// int8 tiles' scales, then the paged chunk's page ids.
struct Layout {
  size_t scales, pages, total;
};

template <typename KV>
__host__ __device__ inline Layout smem_layout(int d, int group, bool quant,
                                              bool paged) {
  using G = Geo<KV>;
  const size_t stages = (size_t)4 * G::TILE * d * G::ES;
  const int lgs = WARPS * (32 / lanes_per_pos(d / G::EV));
  const size_t merge = (size_t)lgs * group * (d + 2) * 4;
  Layout lay;
  lay.scales = ((stages > merge ? stages : merge) + 15) / 16 * 16;
  lay.pages = lay.scales + (quant ? (size_t)4 * G::TILE * 4 : 0);
  lay.total = lay.pages + (paged ? (size_t)KV_CHUNK * 4 : 0);
  return lay;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One EV-element vector of a staged K/V row as the float branch sees it:
// float KV the elements themselves; int8 KV int8 * f32 scale in f32,
// rounded to T.
template <typename T>
__device__ __forceinline__ void load_vec(const float* p, float, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
template <typename T>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float,
                                         float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __low2float(h[i]);
    o[2 * i + 1] = __high2float(h[i]);
  }
}
template <typename T>
__device__ __forceinline__ void load_vec(const int8_t* p, float sc,
                                         float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = to_f(from_f<T>((float)c[i] * sc));
}

// First pass: one block per (chunk, row x kv head). KV is T (float
// branch, scales unused) or int8_t (int8 branch). PAGED false: k/v are
// [b, t, kvh, d], tables unused. PAGED true: k/v are the arena
// [P, 1 << page_shift, kvh, d], row r's block table is
// tables[r * nb .. r * nb + nb), and t = nb << page_shift. GT >= group
// is the register width of the query group (1, 2, 4 or 8).
template <typename T, typename KV, bool PAGED, int GT>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ active_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int t, int nb, int page_shift, int kvh,
    int group, int d, float scale, int nsplit) {
  using G = Geo<KV>;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int EV = G::EV, TILE = G::TILE, NV = G::NV;
  const int split = blockIdx.x;
  const int rh = blockIdx.y;  // row * kvh + head
  const int row = rh / kvh;
  const int head = rh % kvh;

  int alen = active_len[row];
  const bool uniform = alen <= 0;
  if (uniform || alen > t) alen = t;
  const int c0 = split * KV_CHUNK;
  if (c0 >= alen) return;  // past the row's length: no partial
  const int c1 = min(c0 + KV_CHUNK, alen);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nev = d / EV;                // vectors per d-vector
  const int lanes = lanes_per_pos(nev);  // lanes per position
  const int per_warp = 32 / lanes;       // positions per warp step
  const int lgs = WARPS * per_warp;      // lane groups in the block
  const int lg = warp * per_warp + lane / lanes;
  const int li = lane % lanes;
  const int nvl = (nev + lanes - 1) / lanes;  // vectors per lane, <= NV

  extern __shared__ __align__(16) unsigned char smem[];
  // a tile's logits, then probabilities, per (position, query head)
  __shared__ float p_s[TILE][GT];
  const Layout lay = smem_layout<KV>(d, group, QUANT, PAGED);
  const size_t row_bytes = (size_t)d * sizeof(KV);
  const size_t stage_bytes = (size_t)TILE * row_bytes;
  float* sc_s = reinterpret_cast<float*>(smem + lay.scales);  // [2][2][TILE]
  int* pid_s = reinterpret_cast<int*>(smem + lay.pages);

  const size_t pos_stride = (size_t)kvh * d;
  // contiguous: the (row, head) origins; paged: the head within a slot
  const size_t kv0 = (PAGED ? 0 : (size_t)row * t * pos_stride) +
                     (size_t)head * d;
  const size_t sc0 = (PAGED ? 0 : (size_t)row * t * kvh) + head;
  const int page0 = c0 >> page_shift;
  if constexpr (PAGED) {
    // the chunk's page ids, one table read per page
    const int pages = ((c1 - 1) >> page_shift) - page0 + 1;
    for (int i = tid; i < pages; i += THREADS) {
      pid_s[i] = tables[(size_t)row * nb + page0 + i];
    }
    __syncthreads();
  }
  // the storage slot of position p (contiguous: p itself)
  auto slot = [&](int p) -> size_t {
    if constexpr (PAGED) {
      return ((size_t)pid_s[(p >> page_shift) - page0] << page_shift) +
             (size_t)(p & ((1 << page_shift) - 1));
    } else {
      return (size_t)p;
    }
  };

  const int ntiles = (c1 - c0 + TILE - 1) / TILE;
  auto fetch = [&](int it) {
    const int t0 = c0 + it * TILE;
    const int n = min(TILE, c1 - t0);
    unsigned char* kd = smem + (size_t)(it & 1) * stage_bytes;
    unsigned char* vd = kd + 2 * stage_bytes;
    const int pieces = (int)(row_bytes / 16);
    for (int i = tid; i < n * pieces; i += THREADS) {
      const int j = i / pieces;
      const int c = i - j * pieces;
      const size_t off = kv0 + slot(t0 + j) * pos_stride;
      cp_async16(kd + j * row_bytes + c * 16,
                 reinterpret_cast<const unsigned char*>(k + off) + c * 16);
      cp_async16(vd + j * row_bytes + c * 16,
                 reinterpret_cast<const unsigned char*>(v + off) + c * 16);
    }
    if constexpr (QUANT) {
      float* sk = sc_s + (it & 1) * 2 * TILE;
      for (int j = tid; j < n; j += THREADS) {
        const size_t s = sc0 + slot(t0 + j) * kvh;
        cp_async4(sk + j, k_scale + s);
        cp_async4(sk + TILE + j, v_scale + s);
      }
    }
    cp_async_commit();
  };
  fetch(0);
  if (ntiles > 1) fetch(1);

  // q of this lane's head-dim vectors, in f32
  const int h = kvh * group;
  const T* qrow = q + ((size_t)row * h + (size_t)head * group) * d;
  float qr[GT][R];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = li + i * lanes;
      const bool ok = g < group && i < nvl && vi < nev;
#pragma unroll
      for (int x = 0; x < EV; ++x) {
        qr[g][i * EV + x] = ok ? to_f(qrow[(size_t)g * d + vi * EV + x])
                               : 0.f;
      }
    }
  }
  float m[GT], l[GT], acc[GT][R];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < R; ++e) acc[g][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    // tile `it` landed (tile it + 1, if any, may still be in flight), and
    // the barrier publishes it to every thread
    if (it + 1 < ntiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(TILE, c1 - (c0 + it * TILE));
    const KV* kt = reinterpret_cast<const KV*>(
        smem + (size_t)(it & 1) * stage_bytes);
    const KV* vt = reinterpret_cast<const KV*>(
        smem + (size_t)(2 + (it & 1)) * stage_bytes);
    const float* ksc = sc_s + (it & 1) * 2 * TILE;
    // (1) logits: lane group lg takes positions lg, lg + lgs, ...; a warp
    // steps together, two positions a lane group at a time (shuffles need
    // every lane), clamping a position past the tile to its last row and
    // discarding it
    float mt[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) mt[g] = -INFINITY;
    for (int j0 = warp * per_warp; j0 < n; j0 += 2 * lgs) {
      int j[2];
      float s[2][GT];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        j[u] = j0 + u * lgs + lane / lanes;
        const int jj = j[u] < n ? j[u] : n - 1;
        float kf[R];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int vi = li + i * lanes;
          if (i < nvl && vi < nev) {
            load_vec<T>(kt + (size_t)jj * d + vi * EV,
                        QUANT ? ksc[jj] : 0.f, kf + i * EV);
          } else {
#pragma unroll
            for (int x = 0; x < EV; ++x) kf[i * EV + x] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          s[u][g] = 0.f;
#pragma unroll
          for (int e = 0; e < R; ++e) s[u][g] += qr[g][e] * kf[e];
        }
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (j[u] < n) {
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            s[u][g] = uniform ? NEG_INF : s[u][g] * scale;
            mt[g] = fmaxf(mt[g], s[u][g]);
          }
          if (li == 0) {
#pragma unroll
            for (int g = 0; g < GT; ++g) p_s[j[u]][g] = s[u][g];
          }
        }
      }
    }
    // (2) one rescale per tile to the lane group's new running max
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m_new = fmaxf(m[g], mt[g]);
      const float a = expf(m[g] - m_new);
      l[g] *= a;
#pragma unroll
      for (int e = 0; e < R; ++e) acc[g][e] *= a;
      m[g] = m_new;
    }
    __syncwarp();
    // (3) the lane group's probabilities, its positions spread over its
    // lanes
    for (int j = lg + li * lgs; j < n; j += lanes * lgs) {
#pragma unroll
      for (int g = 0; g < GT; ++g) p_s[j][g] = expf(p_s[j][g] - m[g]);
    }
    __syncwarp();
    // (4) p @ V over the lane group's positions, two loads at a time,
    // accumulated in position order
    for (int j0 = lg; j0 < n; j0 += 2 * lgs) {
      float vf[2][R];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * lgs < n ? j0 + u * lgs : j0;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int vi = li + i * lanes;
          if (i < nvl && vi < nev) {
            load_vec<T>(vt + (size_t)j * d + vi * EV,
                        QUANT ? ksc[TILE + j] : 0.f, vf[u] + i * EV);
          } else {
#pragma unroll
            for (int x = 0; x < EV; ++x) vf[u][i * EV + x] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (j0 + u * lgs < n) {
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float p = p_s[j0 + u * lgs][g];
            l[g] += p;
#pragma unroll
            for (int e = 0; e < R; ++e) acc[g][e] += p * vf[u][e];
          }
        }
      }
    }
    if (it + 2 < ntiles) {
      __syncthreads();  // every thread is done with this tile's stage
      fetch(it + 2);
    }
  }

  // merge the lane groups' partials in lane-group order; the merge
  // region reuses the stages
  __syncthreads();
  float* r_acc = reinterpret_cast<float*>(smem);  // [lgs][group][d]
  float* r_ml = r_acc + (size_t)lgs * group * d;  // [lgs][group][2]
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < group) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = li + i * lanes;
        if (i < nvl && vi < nev) {
#pragma unroll
          for (int x = 0; x < EV; ++x) {
            r_acc[((size_t)lg * group + g) * d + vi * EV + x] =
                acc[g][i * EV + x];
          }
        }
      }
      if (li == 0) {
        r_ml[(lg * group + g) * 2] = m[g];
        r_ml[(lg * group + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  const size_t base = ((size_t)rh * nsplit + split) * group;
  for (int idx = tid; idx < group * d; idx += THREADS) {
    const int g = idx / d;
    const int dd = idx - g * d;
    float mx = r_ml[g * 2];
    for (int s = 1; s < lgs; ++s) mx = fmaxf(mx, r_ml[(s * group + g) * 2]);
    float a = 0.f, ls = 0.f;
    for (int s = 0; s < lgs; ++s) {
      const float w = expf(r_ml[(s * group + g) * 2] - mx);
      ls += w * r_ml[(s * group + g) * 2 + 1];
      a += w * r_acc[((size_t)s * group + g) * d + dd];
    }
    part_acc[base * d + idx] = a;
    if (dd == 0) {
      part_ml[(base + g) * 2] = mx;
      part_ml[(base + g) * 2 + 1] = ls;
    }
  }
}

// Second pass: one block per (row x kv head, query head) merges the
// row's chunk partials in chunk order and writes the output in T. The
// chunks' maxima and weights are staged in shared memory (3 * nsplit
// floats).
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ active_len, T* __restrict__ out, int t, int kvh,
    int group, int d, int nsplit) {
  extern __shared__ float w_s[];  // m [nsplit], weight [nsplit], l [nsplit]
  const int rh = blockIdx.x / group;
  const int g = blockIdx.x % group;
  const int row = rh / kvh;
  const int head = rh % kvh;
  int alen = active_len[row];
  if (alen <= 0 || alen > t) alen = t;
  const int ns = (alen + KV_CHUNK - 1) / KV_CHUNK;
  const float* ml = part_ml + (size_t)rh * nsplit * group * 2;
  for (int s = threadIdx.x; s < ns; s += THREADS) {
    w_s[s] = ml[(s * group + g) * 2];
    w_s[2 * nsplit + s] = ml[(s * group + g) * 2 + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, w_s[s]);
  for (int s = threadIdx.x; s < ns; s += THREADS) {
    w_s[nsplit + s] = expf(w_s[s] - mx);
  }
  __syncthreads();
  float ls = 0.f;
  for (int s = 0; s < ns; ++s) ls += w_s[nsplit + s] * w_s[2 * nsplit + s];
  const float* pa = part_acc + ((size_t)rh * nsplit * group + g) * d;
  T* orow = out + ((size_t)row * kvh * group + (size_t)head * group + g) * d;
  for (int dd = threadIdx.x; dd < d; dd += THREADS) {
    float a = 0.f;
#pragma unroll 16
    for (int s = 0; s < ns; ++s) {
      a += w_s[nsplit + s] * pa[(size_t)s * group * d + dd];
    }
    orow[dd] = from_f<T>(a / fmaxf(ls, 1e-30f));
  }
}

// Sets a kernel's dynamic shared memory past the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, typename KV, bool PAGED, int GT>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tables, const void* active_len,
           void* out, void* part_acc, void* part_ml, int b, int t, int nb,
           int page_shift, int kvh, int group, int d, float scale,
           cudaStream_t stream) {
  constexpr bool QUANT = sizeof(KV) == 1;
  const int nsplit = t > 0 ? (t + KV_CHUNK - 1) / KV_CHUNK : 1;
  const size_t bytes = smem_layout<KV>(d, group, QUANT, PAGED).total;
  auto split = decode_split_kernel<T, KV, PAGED, GT>;
  auto combine = decode_combine_kernel<T>;
  const size_t combine_bytes = (size_t)3 * nsplit * 4;
  {
    cudaError_t e = allow_smem(split, bytes);
    if (e == cudaSuccess) e = allow_smem(combine, combine_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  split<<<dim3(nsplit, b * kvh), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(active_len), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), t, nb, page_shift, kvh, group, d, scale,
      nsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine<<<b * kvh * group, THREADS, combine_bytes, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(active_len), static_cast<T*>(out), t, kvh,
      group, d, nsplit);
  return (int)cudaGetLastError();
}

// Picks the register width of the query group: the least of 1, 2, 4, 8
// that holds it.
template <typename T, typename KV, bool PAGED>
int launch_group(const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale,
                 const void* tables, const void* active_len, void* out,
                 void* part_acc, void* part_ml, int b, int t, int nb,
                 int page_shift, int kvh, int group, int d, float scale,
                 cudaStream_t s) {
#define LAUNCH(GT)                                                          \
  launch<T, KV, PAGED, GT>(q, k, v, k_scale, v_scale, tables, active_len,  \
                           out, part_acc, part_ml, b, t, nb, page_shift,   \
                           kvh, group, d, scale, s)
  if (group <= 1) return LAUNCH(1);
  if (group <= 2) return LAUNCH(2);
  if (group <= 4) return LAUNCH(4);
  if (group <= GMAX) return LAUNCH(8);
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Picks the instantiation: dtype (of q and out) 0 = float32, 1 = bfloat16;
// scales null = float K/V in q's dtype, else int8 K/V with f32 scales.
template <bool PAGED>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* active_len, void* out, void* part_acc,
             void* part_ml, int b, int t, int nb, int page_shift, int kvh,
             int group, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return quant ? launch_group<float, int8_t, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       part_acc, part_ml, b, t, nb, page_shift, kvh, group,
                       d, scale, s)
                 : launch_group<float, float, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       part_acc, part_ml, b, t, nb, page_shift, kvh, group,
                       d, scale, s);
  }
  if (dtype == 1) {
    return quant ? launch_group<__nv_bfloat16, int8_t, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       part_acc, part_ml, b, t, nb, page_shift, kvh, group,
                       d, scale, s)
                 : launch_group<__nv_bfloat16, __nv_bfloat16, PAGED>(
                       q, k, v, k_scale, v_scale, tables, active_len, out,
                       part_acc, part_ml, b, t, nb, page_shift, kvh, group,
                       d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The chunk width of the split plan; the wrapper checks it against its
// own copy, which sizes the partials.
extern "C" int decode_attention_kv_chunk() { return KV_CHUNK; }

// dtype (of q and out): 0 = float32, 1 = bfloat16. k_scale/v_scale null:
// k/v in q's dtype; else k/v int8 with f32 scales [b, t, kvh, 1].
// part_acc/part_ml: scratch as the header note says. Returns the first
// non-zero cudaGetLastError() of the two launches. The caller checks
// group <= 8, d <= 256, d * element size a multiple of 16 bytes,
// 16-byte-aligned K/V and contiguity.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* active_len, void* out,
                                       void* part_acc, void* part_ml, int b,
                                       int t, int kvh, int group, int d,
                                       float scale, void* stream) {
  return dispatch<false>(dtype, q, k, v, k_scale, v_scale, nullptr,
                         active_len, out, part_acc, part_ml, b, t, 0, 0, kvh,
                         group, d, scale, stream);
}

// The paged form: k/v (and scales) are arenas [P, 1 << page_shift, kvh,
// d (or 1)], tables [b, nb] int32 page ids. The caller checks the shapes
// above, page a power of two and every table entry in [0, P).
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale_pages, const void* v_scale_pages, const void* tables,
    const void* active_len, void* out, void* part_acc, void* part_ml, int b,
    int nb, int page_shift, int kvh, int group, int d, float scale,
    void* stream) {
  return dispatch<true>(dtype, q, k_pages, v_pages, k_scale_pages,
                        v_scale_pages, tables, active_len, out, part_acc,
                        part_ml, b, nb << page_shift, nb, page_shift, kvh,
                        group, d, scale, stream);
}
