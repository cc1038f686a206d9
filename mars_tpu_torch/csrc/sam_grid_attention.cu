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
//   by the float32 row sum of the rounded values at the end); with float32
//   inputs P is not rounded.
//
// What bounds it: at ViT-H @1024 (H = 16, L = 64 * 64 = 4096, d = 80) the two
// products are 4 * H * L^2 * d = 85.9 GFLOP against ~38 MB of inputs and
// output, so arithmetic bounds it, never the memory: 0.087 ms at the tensor
// cores' bf16 rate; in float32 0.521 ms for the three TF32 passes below at
// the TF32 rate (1.28 ms on the CUDA cores).
//
// Design, both types: a grid of (query tiles, heads); each CTA sweeps the
// keys once in tiles with a float32 online softmax (running max and sum per
// row, output rescaled) on the tensor cores (wgmma, csrc/sm90.cuh), one
// warpgroup for each 64 query rows.  Q stays in shared memory; K and V
// tiles arrive through cp.async; Q K^T is wgmma from shared memory; the
// row's 4 threads share the running max (two shuffles); P is P.V's A
// fragment straight from the accumulator registers.  The logits are
// __fadd_rn(__fadd_rn(__fmul_rn(s, scale), bh), bw), the plain version's
// expression in its order.  The bias, by the grid's width W:
//   W a multiple of the key tile (every SAM global layer: a 64 x 64 grid at
//   1024 px for ViT-B, -L and -H).  Nothing is masked, and key tile t is
//   part of one key row y, columns x0 to x0 + tile - 1: a thread adds
//   bias_h at (its rows r0 and r0 + 8, y) and bias_w at (those rows,
//   columns x0 + 8j + c2 + e, the accumulator layout of s).  y and x0 step
//   with the tile: no division and no table in the loop.  No one-hot
//   expander products either (the TPU kernel's _expanders fed its matrix
//   unit): at this width they would add K steps to Q K^T's.
//   Any other W (GENERAL): each key's row and column in per-tile tables, one
//   lookup each per logit; keys past L are masked and query rows past L are
//   computed on zeros and not stored.  Its own instantiation, so the aligned
//   kernels carry none of it.
//
// float32 (grid_f32): split TF32 (sm90.cuh): each operand is hi + lo, two
// TF32 values, and each product is three TF32 wgmma passes, a_lo b_hi, a_hi
// b_lo, a_hi b_hi (the small terms first): products to ~2^-20, where one
// TF32 pass (~2^-11) would break the 2e-5 float32 limit.  The sweep is
// tf32::biased_sweep (csrc/attention_tf32.cuh), which
// csrc/sam_windowed_attention.cu's windowed_f32 runs too, on the tiles that
// csrc/attention_notap.cu's notap_f32 shares.  What bounds it on the card is
// not the tensor cores but the CUDA cores' share beside them: the splits,
// the softmax and P's split take about as many instructions a tile as the
// passes take cycles.  So a CTA is two warpgroups over 128 query rows,
// sharing each split tile (half the splitting a row, and two warps a
// scheduler), and the splits run while the tensor cores work.  One raw K
// and one raw V tile and one split tile of each are all the shared memory
// takes besides Q (~201 KB at d = 80, one CTA an SM); the bias is read from
// device memory (bias_w's rows at W = 64 are the same every tile, cached).
// Head dims pad to 32, 64, 80 or 128; K tiles are 64 keys, 32 at 128
// (shared memory).
//
// bfloat16 (grid_bf16): notap_bf16's loop (csrc/attention_notap.cu), 64
// query rows a CTA (1024 CTAs at ViT-H), K and V double buffered, V read as
// an MN-major operand, P rounded to bf16 in the accumulator registers and
// the row sum adds the rounded values; head dim 80 is an SW128 panel and a
// 16-wide interleaved one (attention_sm90.cuh).  The bias at an aligned W:
// the CTA's 64 rows of bias_h in shared memory as bf16, two loads a thread
// a tile; bias_w in registers as floats from before the key loop at W = 64
// (W64), its rows in shared memory as bf16 at W = 128, 192, ... (WIDE), 16
// paired loads a tile.  GENERAL: both bias rows in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "attention_tf32.cuh"

namespace {

constexpr int BQ = 64;     // query rows per CTA
constexpr int DMAX = 128;  // head-dim capacity
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_GRID_Y = 65535;

// How a kernel takes the bias, by the grid's width W
constexpr int GENERAL = 0;  // any W: per-tile key tables
constexpr int W64 = 1;      // bf16, W = 64: bias_w in registers
constexpr int WIDE = 2;     // W a multiple of the key tile

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ------------------------------------------------------------ float32
// tf32::biased_sweep (attention_tf32.cuh): two warpgroups a CTA over 128
// query rows, sharing each split K and V^T tile.
using tf32::F32;
using tf32::f32_dp;

template <int DP, int MODE>
__global__ void __launch_bounds__(tf32::THREADS)
grid_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ bias_h, const float* __restrict__ bias_w,
         float* __restrict__ out, int L, int d, int hg, int wg, float scale, int vec) {
  static_assert(MODE == GENERAL || MODE == WIDE, "float32 reads the bias from memory");
  constexpr int BIAS = MODE == WIDE ? tf32::BY_ROW : tf32::BY_TABLES;
  static_assert(tf32::sweep_smem<DP, BIAS>() <= MAX_SMEM, "the tiles fit in shared memory");
  extern __shared__ uint8_t smem_raw[];
  tf32::biased_sweep<DP, BIAS>(q, k, v, bias_h, bias_w, out, L, d, hg, wg, scale, vec,
                               blockIdx.x * tf32::ROWS, blockIdx.y, smem_raw);
}

template <int DP, int MODE>
int launch_f32(const void* q, const void* k, const void* v, const void* bh, const void* bw,
               void* out, int H, int L, int d, int hg, int wg, float scale, cudaStream_t st) {
  constexpr size_t smem = tf32::sweep_smem<DP, MODE == WIDE ? tf32::BY_ROW : tf32::BY_TABLES>();
  cudaError_t err = cudaFuncSetAttribute(grid_f32<DP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  grid_f32<DP, MODE><<<dim3((L + tf32::ROWS - 1) / tf32::ROWS, H), tf32::THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bh, (const float*)bw,
      (float*)out, L, d, hg, wg, scale, vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32_dp(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                  void* out, int H, int L, int d, int hg, int wg, float scale, cudaStream_t st) {
  if (wg % F32<DP>::KEYS == 0)
    return launch_f32<DP, WIDE>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
  return launch_f32<DP, GENERAL>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
}

// ------------------------------------------------------------ bfloat16
constexpr int BK = 64;  // keys per tile

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
  if (H < 1 || H > MAX_GRID_Y || L < 1 || d < 1 || d > DMAX || hg < 1 || wg < 1 || hg * wg != L)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (f32_dp(d)) {
    case 32: return launch_f32_dp<32>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
    case 64: return launch_f32_dp<64>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
    case 80: return launch_f32_dp<80>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
    default: return launch_f32_dp<128>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, st);
  }
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
