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
// float32 (grid_f32): split TF32 (sm90.cuh) on the tiles of attention_tf32.cuh,
// which csrc/attention_notap.cu's notap_f32 shares: each operand is hi + lo, two
// TF32 values, and each product is three TF32 wgmma passes, a_lo b_hi, a_hi
// b_lo, a_hi b_hi (the small terms first): products to ~2^-20, where one
// TF32 pass (~2^-11) would break the 2e-5 float32 limit.  TF32 wgmma reads
// both operands K-major, so P.V takes V^T: each V tile lands raw (cp.async)
// and is split into hi and lo V^T tiles, keys permuted inside each group of
// 8 (0, 2, 4, 6, 1, 3, 5, 7) so that the registers of s are P's A fragment
// as they stand; K tiles are split likewise into hi and lo tiles, P in
// registers.  What bounds it on the card is not the tensor cores but the
// CUDA cores' share beside them: the splits, the softmax and P's split take
// about as many instructions a tile as the passes take cycles.  So a CTA is
// two warpgroups over 128 query rows, sharing each split tile (half the
// splitting a row, and two warps a scheduler), and the splits run while the
// tensor cores work: V's while Q K^T runs, the next K tile's while P.V does.
// One raw K and one raw V tile and one split tile of each are all the
// shared memory takes besides Q (~201 KB at d = 80, one CTA an SM); the bias
// is read from device memory (bias_w's rows at W = 64 are the same every
// tile, cached), each tile's issued before Q K^T.  The tensor cores' float32
// adds truncate, so a tile's P.V is summed from zero in its own accumulator
// and added to the output sum with an IEEE fma: one accumulator over the
// 4096-key sweep reads 3.7e-5 off the plain version at ViT-H, past the
// limit (tools/grid_f32_probe.py, one_acc).  Head dims pad to 32, 64, 80 or 128; K tiles are 64 keys, 32 at 128
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
// Two warpgroups a CTA, 64 query rows each, over one sweep of shared K and
// V tiles: the tiles are split once for 128 query rows (attention_tf32.cuh).
constexpr int F32_THREADS = tf32::THREADS;
constexpr int F32_ROWS = tf32::ROWS;
using tf32::F32;
using tf32::f32_dp;
using tf32::load_raw;
using tf32::pv_pass;
using tf32::qk_pass;
using tf32::split_rows;
using tf32::split_vt;

// Dynamic shared memory: the tiles (attention_tf32.cuh) and, GENERAL, the
// tile's key tables.  The bias is read from device memory (each tile's,
// before Q K^T).
template <int DP, int MODE> __host__ __device__ constexpr size_t f32_smem() {
  return tf32::tile_smem<DP>() + (MODE == GENERAL ? 2 * sizeof(int) * F32<DP>::KEYS : 0);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(F32_THREADS)
grid_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ bias_h, const float* __restrict__ bias_w,
         float* __restrict__ out, int L, int d, int hg, int wg, float scale, int vec) {
  using F = F32<DP>;
  constexpr int KEYS = F::KEYS, NS = KEYS / 2;  // NS: registers of s
  static_assert(MODE == GENERAL || MODE == WIDE, "float32 reads the bias from memory");
  static_assert(f32_smem<DP, MODE>() <= MAX_SMEM, "the tiles fit in shared memory");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - sm90::smem_addr(smem_raw));  // base, generic
  // Q hi and lo of warpgroup 0, then of warpgroup 1; K hi, K lo, V^T hi,
  // V^T lo, raw K, raw V; the key tables
  const int group = threadIdx.x / 128;
  const uint32_t qh = base + 2 * F::Q_BYTES * group, ql = qh + F::Q_BYTES;
  const uint32_t kh = base + 4 * F::Q_BYTES, kl = kh + F::T_BYTES;
  const uint32_t vh = kl + F::T_BYTES, vl = vh + F::T_BYTES;
  float* raw_k = reinterpret_cast<float*>(gbase + 4 * F::Q_BYTES + 4 * F::T_BYTES);
  float* raw_v = raw_k + KEYS * DP;
  int* ky = reinterpret_cast<int*>(raw_v + KEYS * DP);  // GENERAL: the tile's key rows
  int* kx = ky + KEYS;                                  // and columns
  const int q0 = blockIdx.x * F32_ROWS;
  const size_t head = (size_t)blockIdx.y * L * d;
  const size_t brow = (size_t)blockIdx.y * L;  // the head's first bias row
  const float *qg = q + head, *kg = k + head, *vg = v + head;
  const int ntiles = (L + KEYS - 1) / KEYS;
  const int lane = threadIdx.x % 32;
  // rows r0 and r0 + 8 of the warpgroup's 64 (the CTA's rows g0 + r0, + 8)
  const int g0 = 64 * group, r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);  // keys 8j + c2 and + 1 of a tile
  bool live[2];                   // rows below L
#pragma unroll
  for (int half = 0; half < 2; ++half) live[half] = q0 + g0 + r0 + 8 * half < L;

  // Q lands raw where the K, V^T and raw tiles go (6 T_BYTES >= 128 rows),
  // then is split
  float* raw_q = reinterpret_cast<float*>(gbase + 4 * F::Q_BYTES);
  load_raw<DP>(raw_q, qg, q0, F32_ROWS, L, d, vec);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int g = 0; g < 2; ++g)
    split_rows<DP>(base + 2 * F::Q_BYTES * g, base + 2 * F::Q_BYTES * g + F::Q_BYTES,
                   raw_q + BQ * DP * g, BQ);
  sm90::fence_async_smem();
  __syncthreads();  // the raw tiles are free
  load_raw<DP>(raw_k, kg, 0, KEYS, L, d, vec);
  sm90::cp_async_commit();
  load_raw<DP>(raw_v, vg, 0, KEYS, L, d, vec);
  sm90::cp_async_commit();
  sm90::cp_async_wait<1>();
  __syncthreads();
  split_rows<DP>(kh, kl, raw_k, KEYS);
  sm90::fence_async_smem();

  // running max (shared by the row's 4 threads) and this thread's share of
  // the row sum, per row half
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // o: the output sum; pv: a tile's P.V, which the tensor cores sum from
  // zero, then added to o (their truncating adds over a whole sweep's chain
  // of wgmma steps in one accumulator would break the limit)
  float s[NS], o[DP / 2], pv[DP / 2];
  uint32_t ph[NS], pl[NS];  // P hi and lo
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  int y = 0, x0 = 0;  // WIDE: tile t's key row and first column
  const float* bhr[2];  // the thread's bias rows (r0 and r0 + 8)
  const float* bwr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t row = brow + q0 + g0 + r0 + 8 * half;
    bhr[half] = bias_h + row * hg;
    bwr[half] = bias_w + row * wg;
  }

  for (int t = 0; t < ntiles; ++t) {
    const bool next = t + 1 < ntiles;
    if constexpr (MODE == GENERAL) {
      // the previous tile's middle barrier has retired its tables
      const int key = t * KEYS + threadIdx.x;
      if (threadIdx.x < KEYS) {
        ky[threadIdx.x] = key < L ? key / wg : 0;
        kx[threadIdx.x] = key < L ? key % wg : 0;
      }
    }
    // WIDE: the tile's bias, in flight while Q K^T runs (rows past L take none)
    float bh[2] = {0.f, 0.f}, bw[NS];
    if constexpr (MODE == WIDE) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2 w[KEYS / 8] = {};
        if (live[half]) {
          bh[half] = __ldg(bhr[half] + y);
#pragma unroll
          for (int j = 0; j < KEYS / 8; ++j)
            w[j] = __ldg(reinterpret_cast<const float2*>(bwr[half] + x0 + 8 * j + c2));
        }
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          bw[4 * j + 2 * half] = w[j].x;
          bw[4 * j + 2 * half + 1] = w[j].y;
        }
      }
    }
    sm90::cp_async_wait<0>();  // raw V tile t
    // V tile t and the split K tile t in view; raw K and V^T free
    __syncthreads();
    if (next) load_raw<DP>(raw_k, kg, (t + 1) * KEYS, KEYS, L, d, vec);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    qk_pass<DP>(s, ql, kh, true);  // the small terms first
    qk_pass<DP>(s, qh, kl, false);
    qk_pass<DP>(s, qh, kh, false);
    sm90::wgmma_commit();
    split_vt<DP>(vh, vl, raw_v);  // while Q K^T runs
    sm90::fence_async_smem();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);

    // logits: register i of s is (row r0 + 8 ((i / 2) % 2), key 8 (i / 4) + c2 + i % 2)
    if constexpr (MODE == GENERAL) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i / 4) + c2 + (i & 1), half = (i / 2) & 1;
        s[i] = t * KEYS + c < L
                   ? __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale),
                                         live[half] ? __ldg(bhr[half] + ky[c]) : 0.f),
                               live[half] ? __ldg(bwr[half] + kx[c]) : 0.f)
                   : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), bh[(i / 2) & 1]), bw[i]);
      x0 += KEYS;
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
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, s[4 * j + 2 * half + e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);  // finite: every tile has a live key
      corr[half] = __expf(m[half] - m_new);       // 0 on the first tile
      m[half] = m_new;
    }
    // P = exp(s - m) (masked keys give 0), split into hi and lo; the row sum
    // adds P
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int half = (i / 2) & 1;
      const float p = __expf(s[i] - m[half]);
      psum[half] += p;
      sm90::split_tf32(p, ph[i], pl[i]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + psum[half];

    sm90::cp_async_wait<0>();  // raw K tile t + 1
    // V^T in view; raw V free; every warp is done with the K tiles
    __syncthreads();
    if (next) load_raw<DP>(raw_v, vg, (t + 1) * KEYS, KEYS, L, d, vec);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    pv_pass<DP>(pv, pl, vh, true);
    pv_pass<DP>(pv, ph, vl, false);
    pv_pass<DP>(pv, ph, vh, false);
    sm90::wgmma_commit();
    if (next) {  // while P.V runs
      split_rows<DP>(kh, kl, raw_k, KEYS);
      sm90::fence_async_smem();
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(pv);
    sm90::fence_regs(ph);
    sm90::fence_regs(pl);
    // o's register i is row r0 + 8 ((i / 2) % 2) as in s
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = fmaf(o[i], corr[(i / 2) & 1], pv[i]);
  }

  tf32::store_rows<DP>(out + head + (size_t)(q0 + g0 + r0) * d, o, l, live, c2, d);
}

template <int DP, int MODE>
int launch_f32(const void* q, const void* k, const void* v, const void* bh, const void* bw,
               void* out, int H, int L, int d, int hg, int wg, float scale, cudaStream_t st) {
  constexpr size_t smem = f32_smem<DP, MODE>();
  cudaError_t err = cudaFuncSetAttribute(grid_f32<DP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  grid_f32<DP, MODE><<<dim3((L + F32_ROWS - 1) / F32_ROWS, H), F32_THREADS, smem, st>>>(
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
