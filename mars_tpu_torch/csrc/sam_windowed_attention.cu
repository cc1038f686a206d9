// SAM windowed-layer attention with the decomposed relative-position bias,
// every window-head in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// mars_tpu/ops/sam_attention.py:windowed_attention_pallas (Pallas body
// _kernel_win).  Contract, as there:
//   q, k, v:  (BH, L, d) row-major, BH = windows x heads, L = Hw * Ww tokens of
//             one window, float32 or bfloat16, q unscaled, d <= 128
//   bias_h:   (BH, L, Hw) per-query bias over key rows, same type
//   bias_w:   (BH, L, Ww) per-query bias over key columns, same type
//   out:      (BH, L, d) in the input type, with
//     logits[q, k] = (q . k) * d^-0.5 + bias_h[q, k / Ww] + bias_w[q, k % Ww]
//     out = softmax(logits) v
//   Logits and the softmax are float32; with bfloat16 inputs P is
//   normalised, then rounded to bfloat16 before the P.V product, as the TPU
//   kernel's probs.astype(v.dtype) does; with float32 inputs P is not
//   rounded.  Every key of the window is attended: the
//   zero-padded border tokens of a partitioned grid are keys in the contract
//   (the TPU kernel masks only its own 196 -> 256 lane padding).
//
// What bounds it: at SAM ViT-H @1024 a windowed layer has 25 windows of 14 x
// 14 = 196 tokens and 16 heads: 400 window-heads, d = 80.  The two products
// are 4 * 400 * 196^2 * 80 = 4.9 GFLOP against ~55 MB of inputs and output in
// bfloat16 and ~109 MB in float32, so the bytes bound it in both types:
// 0.016 ms in bfloat16, 0.033 ms in float32 (at 3.35 TB/s), where split
// TF32's three passes a product take 0.030 ms at the tensor cores' TF32 rate
// (0.073 ms on the CUDA cores).
//
// Design, bfloat16: one CTA of one warpgroup per (64-query tile,
// window-head), 4 x 400 = 1600 CTAs at ViT-H, on the tensor cores
// (csrc/attention_sm90.cuh); Q stays in shared memory, beside it the query
// tile's bias rows (float) and each key's row and column in the window (the
// TPU's 0/1 expander matmuls, _expanders, were a device for its matrix
// unit).  The logits (s * scale + bh) + bw are formed in the accumulator
// layout; P, normalised, is rounded to bf16 in registers as the A fragment of
// P.V, and V is read as an MN-major operand.  Head dim 80 is one SW128 panel
// and a 16-wide interleaved one: 5 K steps for Q K^T, n64 + n16 for P.V.
//   Resident (windows of up to 256 keys, head dims up to 80: every SAM
//   encoder's): the window's K tiles arrive at once and one commit group of
//   wgmma forms all its logits, which stay in registers (4 x 32 a thread);
//   V's tiles then replace K's in shared memory while an exact row softmax
//   runs in registers, and one commit group of wgmma does the whole P.V.
//   One pass over K and the bias, two waits on memory and two on wgmma.
//   Streamed (any other window): two sweeps over K tiles streamed through two
//   buffers, so the window's size is not bounded by shared memory.  Sweep 1
//   keeps a running max and sum per row, giving its log-sum-exp; sweep 2
//   recomputes the same logits with the same instructions and forms P =
//   exp(logit - lse), already normalised, for P.V.
//
// Design, float32 (windowed_f32): a window-head's contract is grid
// attention's with the window as the grid, so the kernel runs grid_f32's
// sweep (csrc/sam_grid_attention.cu), tf32::biased_sweep of
// csrc/attention_tf32.cuh, one CTA per (128 query rows, window-head): split
// TF32 on wgmma, each product three TF32 passes (a_lo b_hi, a_hi b_lo, a_hi
// b_hi: products to ~2^-20, where one pass, ~2^-11, would break the 2e-5
// limit), two warpgroups sharing each split K and V^T tile, the splits
// under the passes; P is not rounded.  Two CTAs a window-head at ViT-H (800,
// one an SM: ~201 KB of shared memory), the second with 68 live rows of its
// 128.  Beside the passes, what a window's sweep spends most on is the
// bias: through per-tile key tables (a lookup of each key's row and column
// and a gather of its two bias values after Q K^T, per logit) the sweep
// runs 1.4x as long as without the bias (tools/grid_f32_probe.py,
// notables).  So SAM's 14-wide window sweeps tiles of 4 key rows
// (tf32::BY_WINDOW, 56 keys: m64n56 passes): a thread's keys sit at the same
// columns in every tile, so its bias_w values are loaded once, into
// registers, and a tile's bias_h is 4 values a row, loaded before Q K^T.
// 196 keys are 3 such tiles and 28 keys in a tile of 32: 200 keys swept
// where 64-key tiles sweep 256.  Q and the first K and V tiles load
// together: their loads and splits come once every 4 tiles here, not every
// 64 as in a global layer.  Any other window sweeps 64-key tiles (32 at
// head dim 128) through the tables, keys past L masked; keys stream
// through the tiles, so any window is taken (the bf16 streamed kernel's
// reach).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "attention_tf32.cuh"

namespace {

constexpr int BK = 64;     // bfloat16: keys per tile
constexpr int DMAX = 128;  // head-dim capacity
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_GRID_Y = 65535;

// ------------------------------------------------------------ float32
// SAM's window (14 x 14) at head dims up to 80 sweeps tiles of 4 key rows
// (tf32::BY_WINDOW), the last 28 keys in a tile of 32; any other window
// sweeps 64-key tiles (32 at head dim 128) through per-tile key tables.

template <int DP, int MODE>
__global__ void __launch_bounds__(tf32::THREADS)
windowed_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias_h,
             const float* __restrict__ bias_w, float* __restrict__ out, int L, int d, int hg,
             int wg, float scale, int vec) {
  static_assert(tf32::sweep_smem<DP, MODE>() <= MAX_SMEM, "the tiles fit in shared memory");
  extern __shared__ uint8_t smem_raw[];
  tf32::biased_sweep<DP, MODE>(q, k, v, bias_h, bias_w, out, L, d, hg, wg, scale, vec,
                               blockIdx.x * tf32::ROWS, blockIdx.y, smem_raw);
}

// ------------------------------------------------------------ bfloat16
constexpr int BQ = 64;             // query rows per CTA
constexpr int RESIDENT_TILES = 4;  // key tiles whose logits stay in registers (L <= 256)

// The query tile's bias rows (float) and each key's row and column in the
// window, in shared memory after the tiles.
struct BiasRows {
  float* bh;  // (BQ, hg)
  float* bw;  // (BQ, wg)
  int* ky;    // (L)
  int* kx;    // (L)

  __device__ BiasRows(void* p, int L, int hg, int wg) {
    bh = reinterpret_cast<float*>(p);
    bw = bh + BQ * hg;
    ky = reinterpret_cast<int*>(bw + BQ * wg);
    kx = ky + L;
  }
  static size_t bytes(int L, int hg, int wg) {
    return sizeof(float) * ((size_t)BQ * (hg + wg) + 2 * (size_t)L);
  }

  // Plain loads and stores by every thread; a barrier publishes them.
  __device__ void load(const __nv_bfloat16* bias_h, const __nv_bfloat16* bias_w, size_t brow,
                       int q0, int L, int hg, int wg) {
    load_rows(bh, bias_h + brow * hg, min(BQ, L - q0) * hg, BQ * hg);
    load_rows(bw, bias_w + brow * wg, min(BQ, L - q0) * wg, BQ * wg);
    for (int key = threadIdx.x; key < L; key += attn::THREADS) {
      ky[key] = key / wg;
      kx[key] = key % wg;
    }
  }

  // dst[i] = src[i] as float for i < live, 0 up to n: 8 loads a thread in
  // flight before their stores (one load at a time would wait out the
  // memory latency per element).
  static __device__ void load_rows(float* dst, const __nv_bfloat16* src, int live, int n) {
    for (int b = 0; b < n; b += 8 * attn::THREADS) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = b + j * attn::THREADS + threadIdx.x;
        x[j] = idx < live ? __bfloat162float(src[idx]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = b + j * attn::THREADS + threadIdx.x;
        if (idx < n) dst[idx] = x[j];
      }
    }
  }

  // s = Q K^T of key tile t -> float32 logits (s * scale + bh) + bw, keys
  // past L -inf.  Register i of s is (row r0 + 8 ((i / 2) % 2), key 8 (i / 4)
  // + c2 + i % 2).  The same products give the same logits bit for bit.
  __device__ __forceinline__ void logits(float (&s)[32], int t, int r0, int c2, int L, int hg,
                                         int wg, float scale) const {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = t * BK + 8 * (i / 4) + c2 + (i & 1), r = r0 + 8 * ((i / 2) & 1);
      s[i] = key < L ? __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), bh[r * hg + ky[key]]),
                                 bw[r * wg + kx[key]])
                     : -INFINITY;
    }
  }
};

// Dynamic shared memory of a bf16 kernel holding ``tiles`` tiles: alignment
// slack, the tiles, then the bias rows and key tables.
template <int R> size_t bf16_smem(int tiles, int L, int hg, int wg) {
  return 1024 + tiles * (size_t)attn::Tile<R>::BYTES + BiasRows::bytes(L, hg, wg);
}

// Windows of up to 256 keys, panel 1 at most 16 wide: one Q K^T chain over
// the whole window into registers (4 x 32 logits a thread), an exact row
// softmax there while V's tiles replace K's in shared memory, P packed to
// bf16 (4 x 16 registers), then one P.V chain over the whole window.
template <int R>
__global__ void __launch_bounds__(attn::THREADS)
windowed_bf16_resident(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ bias_h,
                       const __nv_bfloat16* __restrict__ bias_w, __nv_bfloat16* __restrict__ out,
                       int L, int d, int hg, int wg, float scale, int vec) {
  using Tile = attn::Tile<R>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  // Q, then the window's K tiles, which V's tiles replace once Q K^T is done
  const uint32_t qs = base;
  auto kv = [&](int t) { return base + Tile::BYTES * (1 + t); };
  BiasRows bias(
      smem_raw + (base - sm90::smem_addr(smem_raw)) + (1 + RESIDENT_TILES) * Tile::BYTES, L,
      hg, wg);
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * L * d;
  const int ntiles = (L + BK - 1) / BK;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane % 4);                      // keys 8j + c2 and + 1 of a tile

  attn::load_tile<R>(qs, q + head, q0, L, d, vec);
  for (int t = 0; t < ntiles; ++t) attn::load_tile<R>(kv(t), k + head, t * BK, L, d, vec);
  sm90::cp_async_commit();
  bias.load(bias_h, bias_w, (size_t)blockIdx.y * L + q0, q0, L, hg, wg);
  sm90::cp_async_wait<0>();
  sm90::fence_async_smem();
  __syncthreads();

  // every tile's Q K^T in one commit group; tiles past the window are not
  // issued and come out of ``logits`` as masked keys
  float s[RESIDENT_TILES][32];
  sm90::wgmma_fence();
#pragma unroll
  for (int t = 0; t < RESIDENT_TILES; ++t)
    if (t < ntiles) attn::qk_issue<R>(qs, kv(t), s[t]);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  __syncthreads();  // every warp is done reading K: V's tiles may land there
  for (int t = 0; t < ntiles; ++t) attn::load_tile<R>(kv(t), v + head, t * BK, L, d, vec);
  sm90::cp_async_commit();
#pragma unroll
  for (int t = 0; t < RESIDENT_TILES; ++t) {
    sm90::fence_regs(s[t]);
    bias.logits(s[t], t, r0, c2, L, hg, wg, scale);
  }

  // exact row softmax: the max, then exp(logit - max) in place and the sum,
  // each over the row's 4 threads
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int t = 0; t < RESIDENT_TILES; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) m[(i / 2) & 1] = fmaxf(m[(i / 2) & 1], s[t][i]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 1));
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 2));
  }
#pragma unroll
  for (int t = 0; t < RESIDENT_TILES; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[t][i] = __expf(s[t][i] - m[(i / 2) & 1]);  // masked keys give 0
      l[(i / 2) & 1] += s[t][i];
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    inv[half] = 1.f / l[half];
  }
  // P = exp(logit - max) / sum, rounded to bf16: pairs of s packed, the A
  // fragment of P.V (4 registers a K step)
  uint32_t p[RESIDENT_TILES][16];
#pragma unroll
  for (int t = 0; t < RESIDENT_TILES; ++t)
#pragma unroll
    for (int n = 0; n < 16; ++n)
      p[t][n] = sm90::pack_bf16(s[t][2 * n] * inv[n & 1], s[t][2 * n + 1] * inv[n & 1]);

  float o0[32], o1[Tile::O1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Tile::O1; ++i) o1[i] = 0.f;
  sm90::cp_async_wait<0>();
  sm90::fence_async_smem();
  __syncthreads();
  sm90::wgmma_fence();
#pragma unroll
  for (int t = 0; t < RESIDENT_TILES; ++t)
    if (t < ntiles) attn::pv_issue<R>(o0, o1, p[t], kv(t));
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(o0);
  sm90::fence_regs(o1);
  const float one[2] = {1.f, 1.f};
  __nv_bfloat16* dst = out + head;
  attn::store_rows(dst, o0, 0, q0 + r0, c2, L, d, one, d % 2 == 0);
  if constexpr (R > 0) attn::store_rows(dst, o1, 64, q0 + r0, c2, L, d, one, d % 2 == 0);
}

// Any window: two sweeps over K tiles streamed through two buffers (the
// logits are recomputed in the second), V streamed in the second.
template <int R>
__global__ void __launch_bounds__(attn::THREADS)
windowed_bf16_streamed(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ bias_h,
                       const __nv_bfloat16* __restrict__ bias_w, __nv_bfloat16* __restrict__ out,
                       int L, int d, int hg, int wg, float scale, int vec) {
  using Tile = attn::Tile<R>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  // Q, then K buffers 0 and 1, then V buffers 0 and 1
  const uint32_t qs = base;
  auto ks = [&](int i) { return base + Tile::BYTES * (1 + (i & 1)); };
  auto vs = [&](int i) { return base + Tile::BYTES * (3 + (i & 1)); };
  BiasRows bias(smem_raw + (base - sm90::smem_addr(smem_raw)) + 5 * Tile::BYTES, L, hg, wg);
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * L * d;
  const int ntiles = (L + BK - 1) / BK;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane % 4);                      // keys 8j + c2 and + 1 of a tile
  float s[32];

  attn::load_tile<R>(qs, q + head, q0, L, d, vec);
  attn::load_tile<R>(ks(0), k + head, 0, L, d, vec);
  sm90::cp_async_commit();
  bias.load(bias_h, bias_w, (size_t)blockIdx.y * L + q0, q0, L, hg, wg);

  // sweep 1: running max / sum over this thread's keys of each row
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      attn::load_tile<R>(ks(t + 1), k + head, (t + 1) * BK, L, d, vec);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();  // also publishes the bias rows and key tables on t = 0
    attn::qk<R>(qs, ks(t), s);
    __syncthreads();  // every warp is done with K buffer t before tile t + 2 lands there
    bias.logits(s, t, r0, c2, L, hg, wg, scale);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, s[4 * j + 2 * half + e]);
      if (tmax == -INFINITY) continue;  // every key of this thread masked
      const float mn = fmaxf(m[half], tmax);
      float sum = l[half] * __expf(m[half] - mn);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += __expf(s[4 * j + 2 * half + e] - mn);
      m[half] = mn;
      l[half] = sum;
    }
  }
  // the row's log-sum-exp over the 4 threads that share it
  float ls[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mi = m[half];
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 1));
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 2));
    float li = l[half] > 0.f ? l[half] * __expf(m[half] - mi) : 0.f;
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    ls[half] = mi + logf(li);
  }

  // sweep 2: P = exp(logit - lse), rounded to bf16, -> out += P.V
  float o0[32], o1[Tile::O1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Tile::O1; ++i) o1[i] = 0.f;
  attn::load_tile<R>(ks(0), k + head, 0, L, d, vec);
  attn::load_tile<R>(vs(0), v + head, 0, L, d, vec);
  sm90::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      attn::load_tile<R>(ks(t + 1), k + head, (t + 1) * BK, L, d, vec);
      attn::load_tile<R>(vs(t + 1), v + head, (t + 1) * BK, L, d, vec);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();
    attn::qk<R>(qs, ks(t), s);
    bias.logits(s, t, r0, c2, L, hg, wg, scale);
    uint32_t p[16];  // pairs of s packed: the A fragment of P.V, 4 registers a K step
#pragma unroll
    for (int n = 0; n < 16; ++n)
      p[n] = sm90::pack_bf16(__expf(s[2 * n] - ls[n & 1]), __expf(s[2 * n + 1] - ls[n & 1]));
    attn::pv<R>(o0, o1, p, vs(t));
    __syncthreads();  // every warp is done with K and V buffers t
  }
  const float one[2] = {1.f, 1.f};
  __nv_bfloat16* dst = out + head;
  attn::store_rows(dst, o0, 0, q0 + r0, c2, L, d, one, d % 2 == 0);
  if constexpr (R > 0) attn::store_rows(dst, o1, 64, q0 + r0, c2, L, d, one, d % 2 == 0);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int DP, int MODE>
int launch_f32(const void* q, const void* k, const void* v, const void* bh, const void* bw,
               void* out, int BH, int L, int d, int hg, int wg, float scale, cudaStream_t st) {
  constexpr size_t smem = tf32::sweep_smem<DP, MODE>();
  cudaError_t err = cudaFuncSetAttribute(windowed_f32<DP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  windowed_f32<DP, MODE><<<dim3((L + tf32::ROWS - 1) / tf32::ROWS, BH), tf32::THREADS, smem,
                           st>>>((const float*)q, (const float*)k, (const float*)v,
                                 (const float*)bh, (const float*)bw, (float*)out, L, d, hg, wg,
                                 scale, vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32_dp(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                  void* out, int BH, int L, int d, int hg, int wg, float scale, cudaStream_t st) {
  if constexpr (tf32::WINDOW_STEP <= tf32::F32<DP>::KEYS) {
    if (wg == tf32::WINDOW_W && L % tf32::WINDOW_STEP == tf32::WINDOW_STEP / 2)
      return launch_f32<DP, tf32::BY_WINDOW>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
  }
  return launch_f32<DP, tf32::BY_TABLES>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
}

template <typename Kernel>
int launch_bf16(Kernel kernel, size_t smem, const void* q, const void* k, const void* v,
                const void* bh, const void* bw, void* out, int BH, int L, int d, int hg, int wg,
                float scale, cudaStream_t st) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  kernel<<<dim3((L + BQ - 1) / BQ, BH), attn::THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)bh, (const __nv_bfloat16*)bw, (__nv_bfloat16*)out, L, d, hg, wg,
      scale, vec);
  return (int)cudaGetLastError();
}

// The resident kernel for windows of up to 256 keys at head dims up to 80
// (every SAM encoder's), else the streamed one.
template <int R>
int launch_bf16_panel(const void* q, const void* k, const void* v, const void* bh,
                      const void* bw, void* out, int BH, int L, int d, int hg, int wg,
                      float scale, cudaStream_t st) {
  if constexpr (R <= 16) {
    if (L <= RESIDENT_TILES * BK)
      return launch_bf16(windowed_bf16_resident<R>, bf16_smem<R>(1 + RESIDENT_TILES, L, hg, wg),
                         q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
  }
  return launch_bf16(windowed_bf16_streamed<R>, bf16_smem<R>(5, L, hg, wg), q, k, v, bh, bw,
                     out, BH, L, d, hg, wg, scale, st);
}

bool valid(int BH, int L, int d, int hg, int wg) {
  return BH >= 1 && BH <= MAX_GRID_Y && L >= 1 && d >= 1 && d <= DMAX && hg >= 1 && wg >= 1 &&
         hg * wg == L;
}

}  // namespace

extern "C" int mars_windowed_attention_f32(const void* q, const void* k, const void* v,
                                           const void* bh, const void* bw, void* out, int BH,
                                           int L, int d, int hg, int wg, float scale,
                                           void* stream) {
  if (!valid(BH, L, d, hg, wg)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tf32::f32_dp(d)) {
    case 32: return launch_f32_dp<32>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
    case 64: return launch_f32_dp<64>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
    case 80: return launch_f32_dp<80>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
    default: return launch_f32_dp<128>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
  }
}

extern "C" int mars_windowed_attention_bf16(const void* q, const void* k, const void* v,
                                            const void* bh, const void* bw, void* out, int BH,
                                            int L, int d, int hg, int wg, float scale,
                                            void* stream) {
  if (!valid(BH, L, d, hg, wg)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (attn::panel1(d)) {
    case 0: return launch_bf16_panel<0>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
    case 16: return launch_bf16_panel<16>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
    default: return launch_bf16_panel<64>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, st);
  }
}
