// SAM global-layer grid attention with the decomposed relative-position
// bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel mars_tpu/ops/sam_attention.py:82
// grid_attention_pallas (its pallas_call at :110, Pallas body _kernel).
// Contract, as there:
//   q, k, v:  (H, L, d) row-major, float32 or bfloat16, q unscaled, d <= 128
//   bias_h:   (H, L, Hg) per-query bias over key rows, same type
//   bias_w:   (H, L, Wg) per-query bias over key columns, same type
//   out:      (H, L, d) in the input type, with Hg * Wg = L and
//     logits[q, k] = (q . k) * d^-0.5 + bias_h[q, k / Wg] + bias_w[q, k % Wg]
//     out = softmax(logits) v
//   Logits and the softmax are float32; with bfloat16 inputs P is rounded to
//   bfloat16 before the P.V product, as the TPU kernel's probs.astype(v.dtype)
//   does (here the unnormalised exp(s - running max) is rounded, then divided
//   by the float32 row sum of the rounded values at the end).
//
// What bounds it: at ViT-H @1024 (H = 16, L = 64 * 64 = 4096, d = 80) the two
// products are 4 * H * L^2 * d = 85.9 GFLOP against ~38 MB of inputs and
// output, so arithmetic bounds it, never the memory: 0.087 ms at the tensor
// cores' bf16 rate, 1.28 ms at the CUDA cores' float32 rate.
//
// Design, both types: one CTA per (64-row query tile, head), 64 x 16 = 1024
// CTAs at ViT-H, sweeps the keys once in tiles of 64 with a float32 online
// softmax (running max and sum per row, output rescaled).  The logits are
// __fadd_rn(__fadd_rn(__fmul_rn(s, scale), bh), bw), the plain version's
// expression in its order.
//
// bfloat16 (grid_bf16): notap_bf16's loop (csrc/attention_notap.cu) on the
// tensor cores, one warpgroup a CTA (csrc/attention_sm90.cuh).  Q stays in
// shared memory; K and V tiles arrive through cp.async, double buffered; Q K^T
// is wgmma from shared memory; the row's 4 threads share the running max (two
// shuffles); P = exp(s - max), rounded to bf16 in the accumulator registers,
// is P.V's A fragment and the row sum adds the rounded values; V is read as an
// MN-major operand.  Head dim 80 is an SW128 panel and a 16-wide interleaved
// one.  The bias, by the grid's width W:
//   W % 64 == 0 (every SAM global layer: a 64 x 64 grid at 1024 px for
//   ViT-B, -L and -H).  L is a multiple of 64, so nothing is masked, and key
//   tile t is part of one key row y = 64t / W, columns x0 = 64t mod W to
//   x0 + 63.  The CTA's 64 rows of bias_h sit in shared memory as bf16: two
//   loads a thread a tile, one per row half.  The 32 bias_w values a thread
//   adds (rows r0 and r0 + 8, columns x0 + 8j + c2 + e, the accumulator
//   layout of s) are the same on every tile at W = 64 and stay in registers
//   as floats from before the key loop (W64); at W = 128, 192, ... the CTA's
//   bias_w rows sit in shared memory as bf16, 16 paired loads a tile (WIDE).
//   y and x0 step with the tile: no division and no table in the loop.
//   No one-hot expander products either (the TPU kernel's _expanders fed its
//   matrix unit): at this width they would add 4 + 4 K steps to Q K^T's 5,
//   where the decomposition costs two shared loads a tile.
//   Any other W (GENERAL): the bias rows in shared memory as above and each
//   key's row and column in per-tile tables, one lookup each per logit; keys
//   past L are masked and query rows past L are computed on zeros and not
//   stored.  Its own instantiation, so the aligned kernels carry none of it.
//
// float32 (grid_attention_kernel<float>): 256 threads on the CUDA cores (TF32
// would break the 2e-5 float32 limits), a 4-row x 4-key register block a
// thread, the bias rows in shared memory indexed per key through per-tile
// tables, P through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int DMAX = 128;     // head-dim capacity
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Rows [row0, row0 + 64) of a (L, d) matrix into a (64, ld) float tile;
// rows >= L and columns in [d, dp) are zero.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int L, int d, int dp) {
  for (int idx = threadIdx.x; idx < BQ * dp; idx += THREADS) {
    const int r = idx / dp, c = idx % dp, row = row0 + r;
    dst[r * ld + c] = (row < L && c < d) ? to_f32(src[(size_t)row * d + c]) : 0.f;
  }
}

// Shared-memory layout (floats unless noted) for head dim padded to dp and
// bias widths hg, wg.
struct Layout {
  int ld, dp, hg, wg;
  size_t q, k, v, p, bh, bw, ky, kx, bytes;
  __host__ __device__ Layout(int d, int hg_, int wg_) : hg(hg_), wg(wg_) {
    dp = (d + 15) / 16 * 16;
    ld = dp + 1;
    q = 0;
    k = q + (size_t)BQ * ld;
    v = k + (size_t)BK * ld;
    p = v + (size_t)BK * ld;
    bh = p + (size_t)BQ * (BK + 1);
    bw = bh + (size_t)BQ * hg;
    ky = bw + (size_t)BQ * wg;  // int
    kx = ky + BK;               // int
    bytes = (kx + BK) * sizeof(float);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
grid_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ bias_h, const T* __restrict__ bias_w,
                      T* __restrict__ out, int L, int d, int hg, int wg, float scale) {
  extern __shared__ float smem[];
  const Layout lay(d, hg, wg);
  const int ld = lay.ld, dp = lay.dp;
  float* Qs = smem + lay.q;
  float* Ks = smem + lay.k;
  float* Vs = smem + lay.v;
  float* Ps = smem + lay.p;
  float* Bh = smem + lay.bh;
  float* Bw = smem + lay.bw;
  int* Ky = reinterpret_cast<int*>(smem + lay.ky);
  int* Kx = reinterpret_cast<int*>(smem + lay.kx);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t hoff = (size_t)head * L * d;
  const int ntiles = (L + BK - 1) / BK;
  const int ncol = dp / 16;  // output columns per thread: tx + 16 * jj

  load_tile(Qs, ld, q + hoff, q0, L, d, dp);
  for (int idx = threadIdx.x; idx < BQ * hg; idx += THREADS) {
    const int r = idx / hg, row = q0 + r;
    Bh[idx] = row < L ? to_f32(bias_h[((size_t)head * L + row) * hg + idx % hg]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < BQ * wg; idx += THREADS) {
    const int r = idx / wg, row = q0 + r;
    Bw[idx] = row < L ? to_f32(bias_w[((size_t)head * L + row) * wg + idx % wg]) : 0.f;
  }

  float m[4], l[4], acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DMAX / 16; ++jj) acc[i][jj] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is done with Ks, Vs, Ps, Ky, Kx
    load_tile(Ks, ld, k + hoff, k0, L, d, dp);
    load_tile(Vs, ld, v + hoff, k0, L, d, dp);
    if (threadIdx.x < BK) {
      const int key = k0 + threadIdx.x;
      Ky[threadIdx.x] = key < L ? key / wg : 0;
      Kx[threadIdx.x] = key < L ? key % wg : 0;
    }
    __syncthreads();

    // s[i][j]: row 4ty + i, key k0 + tx + 16j
    float s[4][4] = {};
    for (int dd = 0; dd < dp; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * ld + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (k0 + c < L) {
          s[i][j] = __fadd_rn(__fadd_rn(__fmul_rn(s[i][j], scale), Bh[r * hg + Ky[c]]),
                              Bw[r * wg + Kx[c]]);
        } else {
          s[i][j] = -INFINITY;  // masked key
        }
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 threads (a half-warp) that share row r
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);  // finite: tile 0 has a live key
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = to_f32(from_f32<T>(expf(s[i][j] - m_new)));
        Ps[r * (BK + 1) + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DMAX / 16; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * (BK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DMAX / 16; ++jj) {
        if (jj < ncol) {
          const float vv = Vs[c * ld + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < DMAX / 16; ++jj) {
      const int dim = tx + 16 * jj;
      if (jj < ncol && dim < d) out[hoff + (size_t)row * d + dim] = from_f32<T>(acc[i][jj] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bh, const void* bw,
           void* out, int H, int L, int d, int hg, int wg, float scale, void* stream) {
  if (H < 1 || L < 1 || d < 1 || d > DMAX || hg < 1 || wg < 1 || hg * wg != L)
    return (int)cudaErrorInvalidValue;
  const Layout lay(d, hg, wg);
  if (lay.bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(grid_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, H);
  grid_attention_kernel<T><<<grid, THREADS, lay.bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bh, (const T*)bw, (T*)out, L, d, hg, wg,
      scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bfloat16
// How a bfloat16 kernel takes the bias, by the grid's width W
constexpr int GENERAL = 0;  // any W: bias rows in shared memory, per-tile key tables
constexpr int W64 = 1;      // W = 64: bias_w in registers
constexpr int WIDE = 2;     // W = 128, 192, ...: bias rows in shared memory
constexpr int MAX_GRID_Y = 65535;

// Row strides (elements) of the bf16 bias rows in shared memory.  bias_h:
// 2 mod 4, so the 8 rows a warp reads at once (one element each) fall in 8
// banks.  bias_w: 8 mod 16 for W % 64 == 0, so a warp's 8 rows x 4 column
// pairs fall in 32 banks.
__host__ __device__ constexpr int bh_stride(int hg) { return (hg + 3) / 4 * 4 + 2; }
__host__ __device__ constexpr int bw_stride(int wg) { return wg + 8; }

// Rows [row0, row0 + 64) of an (L, n) bf16 matrix into shared memory at dst
// (row stride ld), rows >= L zero.  8 loads a thread in flight before their
// stores (one at a time would wait out the memory latency per element).
__device__ void stage_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int row0, int L,
                           int n) {
  const int total = BQ * n, live = min(BQ, L - row0) * n;
  src += (size_t)row0 * n;
  for (int b = 0; b < total; b += 8 * attn::THREADS) {
    __nv_bfloat16 x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = b + j * attn::THREADS + threadIdx.x;
      x[j] = idx < live ? src[idx] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = b + j * attn::THREADS + threadIdx.x;
      if (idx < total) dst[(idx / n) * ld + idx % n] = x[j];
    }
  }
}

// Dynamic shared memory: alignment slack, Q, 2 x K, 2 x V, the bias rows
// (bias_w's but at W64) and, GENERAL, the tile's key tables.
template <int R, int MODE> size_t bf16_smem(int hg, int wg) {
  return 1024 + 5 * (size_t)attn::Tile<R>::BYTES +
         2 * (size_t)BQ * (bh_stride(hg) + (MODE == W64 ? 0 : bw_stride(wg))) +
         (MODE == GENERAL ? 2 * sizeof(int) * BK : 0);
}

template <int R, int MODE>
__global__ void __launch_bounds__(attn::THREADS)
grid_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bias_h,
          const __nv_bfloat16* __restrict__ bias_w, __nv_bfloat16* __restrict__ out, int L,
          int d, int hg, int wg, float scale, int vec) {
  using Tile = attn::Tile<R>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  // Q, then K buffers 0 and 1, then V buffers 0 and 1, then the bias rows
  const uint32_t qs = base;
  auto ks = [&](int i) { return base + Tile::BYTES * (1 + (i & 1)); };
  auto vs = [&](int i) { return base + Tile::BYTES * (3 + (i & 1)); };
  uint8_t* rows = smem_raw + (base - sm90::smem_addr(smem_raw)) + 5 * Tile::BYTES;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * L * d;
  const size_t brow = (size_t)blockIdx.y * L;  // the head's first bias row
  const int ntiles = (L + BK - 1) / BK;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane % 4);                      // keys 8j + c2 and + 1 of a tile

  attn::load_tile<R>(qs, q + head, q0, L, d, vec);
  attn::load_tile<R>(ks(0), k + head, 0, L, d, vec);
  attn::load_tile<R>(vs(0), v + head, 0, L, d, vec);
  sm90::cp_async_commit();

  // the bias rows, staged while the first tiles are in flight (W64: bias_w
  // in registers instead); the first barrier of the key loop publishes them
  const int ldh = bh_stride(hg), ldw = bw_stride(wg);
  __nv_bfloat16* bh_rows = reinterpret_cast<__nv_bfloat16*>(rows);
  __nv_bfloat16* bw_rows = bh_rows + BQ * ldh;
  int* ky = reinterpret_cast<int*>(bw_rows + BQ * ldw);  // GENERAL: the tile's key rows
  int* kx = ky + BK;                                     // and columns
  stage_rows(bh_rows, ldh, bias_h + brow * hg, q0, L, hg);
  float bwr[MODE == W64 ? 32 : 1];  // W64: bias_w at register i of s
  if constexpr (MODE == W64) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      bwr[i] = __bfloat162float(
          bias_w[(brow + q0 + r0 + 8 * ((i / 2) & 1)) * 64 + 8 * (i / 4) + c2 + (i & 1)]);
  } else {
    stage_rows(bw_rows, ldw, bias_w + brow * wg, q0, L, wg);
  }

  // running max (shared by the row's 4 threads) and this thread's share of
  // the row sum of the rounded P, per row half
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32], o0[32], o1[Tile::O1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Tile::O1; ++i) o1[i] = 0.f;
  int y = 0, x0 = 0;  // aligned: tile t's key row and first column

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      attn::load_tile<R>(ks(t + 1), k + head, (t + 1) * BK, L, d, vec);
      attn::load_tile<R>(vs(t + 1), v + head, (t + 1) * BK, L, d, vec);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    if constexpr (MODE == GENERAL) {
      // the previous tile's barrier has retired its tables
      const int key = t * BK + threadIdx.x;
      if (threadIdx.x < BK) {
        ky[threadIdx.x] = key < L ? key / wg : 0;
        kx[threadIdx.x] = key < L ? key % wg : 0;
      }
    }
    sm90::fence_async_smem();
    __syncthreads();
    attn::qk<R>(qs, ks(t), s);

    // logits: register i of s is (row r0 + 8 ((i / 2) % 2), key 8 (i / 4) + c2 + i % 2)
    if constexpr (MODE == GENERAL) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + c2 + (i & 1), r = r0 + 8 * ((i / 2) & 1);
        s[i] = t * BK + c < L
                   ? __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale),
                                         __bfloat162float(bh_rows[r * ldh + ky[c]])),
                               __bfloat162float(bw_rows[r * ldw + kx[c]]))
                   : -INFINITY;
      }
    } else {
      const float bh[2] = {__bfloat162float(bh_rows[r0 * ldh + y]),
                           __bfloat162float(bh_rows[(r0 + 8) * ldh + y])};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          float w0, w1;
          if constexpr (MODE == W64) {
            w0 = bwr[i];
            w1 = bwr[i + 1];
          } else {
            const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(
                bw_rows + (r0 + 8 * half) * ldw + x0 + 8 * j + c2);
            w0 = __low2float(w);
            w1 = __high2float(w);
          }
          s[i] = __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), bh[half]), w0);
          s[i + 1] = __fadd_rn(__fadd_rn(__fmul_rn(s[i + 1], scale), bh[half]), w1);
        }
      x0 += BK;
      if (x0 == wg) {
        x0 = 0;
        ++y;
      }
    }

    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, s[4 * j + 2 * half + e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);  // finite: every tile has a live key
      corr[half] = __expf(m[half] - m_new);       // 0 on the first tile
      m[half] = m_new;
    }
    // P = exp(s - m) rounded to bf16 (masked keys give 0), packed in pairs:
    // the A fragment of P.V; the row sum adds the rounded values
    uint32_t p[16];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int half = n & 1;
      p[n] = sm90::pack_bf16(__expf(s[2 * n] - m[half]), __expf(s[2 * n + 1] - m[half]));
      psum[half] += attn::bf16_lo(p[n]) + attn::bf16_hi(p[n]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + psum[half];
    // o's register i is row r0 + 8 ((i / 2) % 2) as in s; the previous P.V has completed
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[i] *= corr[(i / 2) & 1];
    if constexpr (R > 0) {
#pragma unroll
      for (int i = 0; i < Tile::O1; ++i) o1[i] *= corr[(i / 2) & 1];
    }
    attn::pv<R>(o0, o1, p, vs(t));
    __syncthreads();  // every warp is done with K and V buffers t (and the tables)
  }

  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float li = l[half];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    inv[half] = 1.f / li;
  }
  __nv_bfloat16* dst = out + head;
  attn::store_rows(dst, o0, 0, q0 + r0, c2, L, d, inv, d % 2 == 0);
  if constexpr (R > 0) attn::store_rows(dst, o1, 64, q0 + r0, c2, L, d, inv, d % 2 == 0);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int R, int MODE>
int launch_bf16(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                void* out, int H, int L, int d, int hg, int wg, float scale, cudaStream_t st) {
  const size_t smem = bf16_smem<R, MODE>(hg, wg);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(grid_bf16<R, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  grid_bf16<R, MODE><<<dim3((L + BQ - 1) / BQ, H), attn::THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)bh, (const __nv_bfloat16*)bw, (__nv_bfloat16*)out, L, d, hg, wg,
      scale, vec);
  return (int)cudaGetLastError();
}

template <int R>
int launch_bf16_panel(const void* q, const void* k, const void* v, const void* bh,
                      const void* bw, void* out, int H, int L, int d, int hg, int wg,
                      float scale, cudaStream_t st) {
  if (wg == 64) return launch_bf16<R, W64>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
  if (wg % 64 == 0)
    return launch_bf16<R, WIDE>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
  return launch_bf16<R, GENERAL>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
}

}  // namespace

extern "C" int mars_grid_attention_f32(const void* q, const void* k, const void* v,
                                       const void* bh, const void* bw, void* out, int H, int L,
                                       int d, int hg, int wg, float scale, void* stream) {
  return launch<float>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, stream);
}

extern "C" int mars_grid_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* bh, const void* bw, void* out, int H, int L,
                                        int d, int hg, int wg, float scale, void* stream) {
  if (H < 1 || H > MAX_GRID_Y || L < 1 || d < 1 || d > DMAX || hg < 1 || wg < 1 || hg * wg != L)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (attn::panel1(d)) {
    case 0: return launch_bf16_panel<0>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
    case 16: return launch_bf16_panel<16>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
    default: return launch_bf16_panel<64>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
  }
}
