// Softmax attention with the head-mean probability tap, for Hopper (sm_90a).
//
// Replaces the TPU kernel mars_tpu/ops/flash_attention.py:attention_with_tap
// (Pallas body _kernel).  Contract, as there:
//   q, k, v: (H, L, d) row-major, float32 or bfloat16, d <= 64
//   out:     (H, L, d) in the input type, softmax(q k^T * scale) v per head
//   tap:     (L, L) float32, the mean over heads of the softmax probabilities
//   Every logit, the softmax and the tap are float32.  When the inputs are
//   bfloat16 the probabilities are rounded to bfloat16 before the P.V product,
//   as the TPU kernel's probs.astype(v.dtype) does.
//
// What bounds it: at the main path's shapes the two products are 4 H L^2 d
// operations against 19 MB (bf16) to 30 MB (float32) of input and output,
// 7.55 MB of it the tap, so the operations bound it, never the memory
// (0.009 ms of bytes at DINOv2-L in float32).  On an H100 (495 TFLOP/s TF32,
// 67 TFLOP/s float32 on the CUDA cores, 989 TFLOP/s bf16):
//   shape (H x L x d)         GFLOP   3 x TF32   CUDA cores   bf16
//   DINOv2-L @518 16x1374x64    7.7   0.0469 ms  0.1154 ms    0.0078 ms
//   CLIP-B/16 @528 12x1090x64   3.7   0.0221     0.0545       0.0037
// float32 takes the 3 x TF32 column (below); the CUDA-core one is what the
// same work costs at full float32 without the tensor cores.
//
// Design: two launches per call, deterministic, no atomics.  The TPU kernel
// holds a whole (256, L) float32 row block in VMEM, which does not fit the
// 227 KB of shared memory a block may use, and a CTA that owned its tap rows
// over all heads (one CTA per 64 queries) filled 22 of 132 SMs at B = 1.
//   1. tap_out: grid (query tiles, heads) writes out and each row's
//      log-sum-exp to a float32 (H, L) scratch.
//   2. tap_mean: grid (query tiles, key tiles).  Each CTA loops over the
//      heads inside itself, recomputes its logit tile with the same
//      instructions as tap_out on the same tiles (bitwise-equal logits, so
//      the tap rows sum to 1), forms P = exp(s - lse) and adds P / H in
//      registers in head order, then writes each tap element once (7.55 MB
//      at DINOv2-L, where a read-modify-write per head moved ~240 MB).
// float32 (tap_out_f32, tap_mean_f32): split TF32 on wgmma
// (attention_tf32.cuh: each operand hi + lo, each product three TF32 passes,
// the small terms first; one pass would break the 1e-5 limits), two
// warpgroups over 128 query rows, head dims padded to 32 or 64.  tap_out_f32
// is tf32::unbiased_sweep, the loop of csrc/attention_notap.cu's notap_f32,
// with the lse written: one sweep of 64-key tiles with an online softmax
// (in float32 P is not rounded before P.V, so normalising at the end is
// within the contract), a tile's P.V summed from zero and added with an
// IEEE fma, V's split while Q K^T runs and the next K tile's while P.V
// does; 176 CTAs at DINOv2-L (1.33 waves of one CTA an SM), bounded like
// notap_f32 by the CUDA cores' splits and softmax beside the passes.
// tap_mean_f32: a CTA of 128 query rows and 128 keys, two N = 64 tiles (121
// CTAs at DINOv2-L, one wave with 11 SMs idle; 81 at CLIP-B).  Per head it
// splits its raw Q and K tiles (tf32::split_rows), issues the next head's
// raw tiles through cp.async, then multiplies (the same tf32::qk_pass calls
// as tap_out's, in the same order, and the same __fmul_rn scale) and
// exponentiates while they arrive.  Each head's 128 query rows are loaded
// and split again in every key tile's CTA: that repeated work, ~127 MB of
// L2 reads at DINOv2-L and the CUDA cores' splits and exps, bounds it
// rather than the passes (not timed apart: no ncu here).  One key tile of 64 a CTA (242 CTAs, the raw tiles double
// buffered in ~193 KB) took 0.298 ms a DINOv2-L call against 0.260
// (tools/torch_kernel_ab.py --tap, H100 80GB HBM3 at 700 W); double
// buffers at 128 keys would take 257 KB, past the 227 KB a block may use.
// bfloat16: one warpgroup per CTA, 64 query rows; Q, K and V tiles arrive
// through cp.async (double-buffered) in the 128-byte-swizzled layout of
// sm90.cuh; Q K^T is wgmma m64n64k16 from shared memory, P.V takes P from
// registers (the accumulator layout of Q K^T is wgmma's A-fragment layout)
// and V from shared memory as an MN-major operand.  tap_out_bf16 sweeps the
// keys twice: once for the row's max and sum of exponentials, once for P =
// exp(s - lse), already normalised and rounded to bf16 (the contract's
// rounding point), into out += P.V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "attention_tf32.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int DMAX = 64;  // head-dim capacity; a smaller d is zero-padded

// ------------------------------------------------------------ float32
constexpr size_t MAX_SMEM = 227 * 1024;

template <int DP>
__global__ void __launch_bounds__(tf32::THREADS)
tap_out_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ out, float* __restrict__ lse, int L, int d, float scale, int vec) {
  extern __shared__ uint8_t smem_raw[];
  tf32::unbiased_sweep<DP>(q, k, v, out, lse, L, d, scale, vec, blockIdx.x * tf32::ROWS,
                           blockIdx.y, smem_raw);
}

// tap_mean_f32's key tiles of 64 a CTA, each its own N = 64 product (its
// logits bitwise tap_out_f32's)
constexpr int MEAN_TILES = 2;

// Dynamic shared memory of tap_mean_f32: alignment slack, both warpgroups'
// Q hi and lo, K hi and lo of each key tile, raw Q (128 rows) and raw K.
template <int DP> constexpr size_t mean_smem() {
  using F = tf32::F32<DP>;
  return 1024 + 6 * (size_t)F::Q_BYTES + 3 * MEAN_TILES * (size_t)F::T_BYTES;
}

template <int DP>
__global__ void __launch_bounds__(tf32::THREADS)
tap_mean_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ lse, float* __restrict__ tap, int H, int L, int d,
             float scale, int vec) {
  using F = tf32::F32<DP>;
  constexpr int KEYS = F::KEYS, NS = KEYS / 2, NT = MEAN_TILES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - sm90::smem_addr(smem_raw));  // base, generic
  // Q hi and lo of warpgroup 0, then of warpgroup 1; K hi and lo of key tile
  // 0, then of tile 1; raw Q, then raw K
  const int group = threadIdx.x / 128;
  const uint32_t qh = base + 2 * F::Q_BYTES * group, ql = qh + F::Q_BYTES;
  const uint32_t ks = base + 4 * F::Q_BYTES;
  float* raw_q = reinterpret_cast<float*>(gbase + 4 * F::Q_BYTES + 2 * NT * F::T_BYTES);
  float* raw_k = raw_q + tf32::ROWS * DP;
  const int q0 = blockIdx.x * tf32::ROWS, k0 = blockIdx.y * NT * KEYS;
  const size_t hstride = (size_t)L * d;
  const int lane = threadIdx.x % 32;
  // rows r0 and r0 + 8 of the warpgroup's 64 (the CTA's rows g0 + r0, + 8)
  const int g0 = 64 * group, r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);  // keys 8j + c2 and + 1 of a tile
  const float inv_h = 1.0f / (float)H;
  float acc[NT][NS];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < NS; ++i) acc[j][i] = 0.f;

  // head h's raw Q rows and K keys
  auto load = [&](int h) {
    tf32::load_raw<DP>(raw_q, q + hstride * h, q0, tf32::ROWS, L, d, vec);
    tf32::load_raw<DP>(raw_k, k + hstride * h, k0, NT * KEYS, L, d, vec);
    sm90::cp_async_commit();
  };
  load(0);
  for (int h = 0; h < H; ++h) {
    sm90::cp_async_wait<0>();
    float ls[2];  // the head's log-sum-exp at rows r0 and r0 + 8 (0 past L)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + g0 + r0 + 8 * half;
      ls[half] = row < L ? __ldg(lse + (size_t)h * L + row) : 0.f;
    }
    // head h's raw tiles in view; every warp is done with head h - 1's split tiles
    __syncthreads();
    for (int g = 0; g < 2; ++g)
      tf32::split_rows<DP>(base + 2 * F::Q_BYTES * g, base + 2 * F::Q_BYTES * g + F::Q_BYTES,
                           raw_q + tf32::BQ * DP * g, tf32::BQ);
    for (int j = 0; j < NT; ++j)
      tf32::split_rows<DP>(ks + 2 * F::T_BYTES * j, ks + 2 * F::T_BYTES * j + F::T_BYTES,
                           raw_k + KEYS * DP * j, KEYS);
    sm90::fence_async_smem();
    __syncthreads();  // the split tiles in view; the raw tiles are free
    if (h + 1 < H) load(h + 1);  // in flight while head h multiplies
    float s[NT][NS];
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t kh = ks + 2 * F::T_BYTES * j, kl = kh + F::T_BYTES;
      tf32::qk_pass<DP>(s[j], ql, kh, true);  // tap_out_f32's passes, in its order
      tf32::qk_pass<DP>(s[j], qh, kl, false);
      tf32::qk_pass<DP>(s[j], qh, kh, false);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NT; ++j) sm90::fence_regs(s[j]);
    // register i of s[j] is (row r0 + 8 ((i / 2) % 2), key 64 j + 8 (i / 4) + c2 + i % 2)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < NS; ++i)
        acc[j][i] = fmaf(__expf(__fmul_rn(s[j][i], scale) - ls[(i / 2) & 1]), inv_h, acc[j][i]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int row = q0 + g0 + r0 + 8 * ((i / 2) & 1), col = k0 + KEYS * j + 8 * (i / 4) + c2;
      if (row >= L || col >= L) continue;
      float* at = tap + (size_t)row * L + col;
      if (L % 2 == 0) {
        *reinterpret_cast<float2*>(at) = make_float2(acc[j][i], acc[j][i + 1]);
      } else {
        at[0] = acc[j][i];
        if (col + 1 < L) at[1] = acc[j][i + 1];
      }
    }
}

// ------------------------------------------------------------ bfloat16
constexpr int B_THREADS = attn::THREADS;  // one warpgroup
constexpr uint32_t TILE = attn::Tile<0>::BYTES;  // one 64 x 64 bf16 SW128 tile
constexpr size_t B_OUT_SMEM = 5 * TILE + 1024;   // Q, 2 x K, 2 x V, alignment slack
constexpr size_t B_MEAN_SMEM = 4 * TILE + 1024;  // 2 x Q, 2 x K

// s = scale * Q K^T for one 64 x 64 tile (the accumulator layout of
// sm90.cuh), Q and K tiles over the whole DMAX: columns past d are zeros and
// add exact zeros.
__device__ __forceinline__ void tile_logits_bf16(uint32_t qs, uint32_t ks, float scale,
                                                 float (&s)[32]) {
  attn::qk<0>(qs, ks, s);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale;
}

__global__ void __launch_bounds__(B_THREADS)
tap_out_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse, int L, int d, float scale, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  // Q, then K buffers 0 and 1, then V buffers 0 and 1
  const uint32_t qs = base;
  auto ks = [&](int i) { return base + TILE * (1 + (i & 1)); };
  auto vs = [&](int i) { return base + TILE * (3 + (i & 1)); };
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t head = (size_t)h * L * d;
  const int ntiles = (L + BK - 1) / BK;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane % 4);                      // columns 8j + c2 and + 1
  float s[32];

  // pass 1: running max / sum over this thread's columns of each row
  attn::load_tile<0>(qs, q + head, q0, L, d, vec);
  attn::load_tile<0>(ks(0), k + head, 0, L, d, vec);
  sm90::cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      attn::load_tile<0>(ks(t + 1), k + head, (t + 1) * BK, L, d, vec);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();
    tile_logits_bf16(qs, ks(t), scale, s);
    __syncthreads();  // every warp is done with K buffer t before tile t + 2 lands there
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * BK + 8 * j + c2 + e < L) tmax = fmaxf(tmax, s[4 * j + 2 * half + e]);
      if (tmax == -INFINITY) continue;  // every column of this thread masked
      const float mn = fmaxf(m[half], tmax);
      float sum = l[half] * __expf(m[half] - mn);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * BK + 8 * j + c2 + e < L) sum += __expf(s[4 * j + 2 * half + e] - mn);
      m[half] = mn;
      l[half] = sum;
    }
  }
  // combine the 4 threads that share each row
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
    const int row = q0 + r0 + 8 * half;
    if (lane % 4 == 0 && row < L) lse[(size_t)h * L + row] = ls[half];
  }

  // pass 2: P = exp(s - lse), rounded to bf16, -> out += P.V
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  attn::load_tile<0>(ks(0), k + head, 0, L, d, vec);
  attn::load_tile<0>(vs(0), v + head, 0, L, d, vec);
  sm90::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      attn::load_tile<0>(ks(t + 1), k + head, (t + 1) * BK, L, d, vec);
      attn::load_tile<0>(vs(t + 1), v + head, (t + 1) * BK, L, d, vec);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();
    tile_logits_bf16(qs, ks(t), scale, s);
    // register i of s is (row r0 + 8 ((i / 2) % 2), key 8 (i / 4) + c2 + i % 2);
    // pairs (2n, 2n + 1) packed are the A fragment of P.V, 4 registers a K step
    uint32_t p[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int i = 2 * n, key = t * BK + 8 * (i / 4) + c2;
      const float lsi = ls[(i / 2) & 1];
      p[n] = sm90::pack_bf16(key < L ? __expf(s[i] - lsi) : 0.f,
                             key + 1 < L ? __expf(s[i + 1] - lsi) : 0.f);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      sm90::wgmma_m64n64_rs_mn(o, a, sm90::desc_sw128(vs(t) + 2048 * kk), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    __syncthreads();  // every warp is done with K and V buffers t
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = q0 + r0 + 8 * ((i / 2) & 1), dim = 8 * (i / 4) + c2 + (i & 1);
    if (row < L && dim < d) out[head + (size_t)row * d + dim] = __float2bfloat16(o[i]);
  }
}

__global__ void __launch_bounds__(B_THREADS)
tap_mean_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const float* __restrict__ lse, float* __restrict__ tap, int H, int L, int d,
              float scale, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  // Q buffers 0 and 1, then K buffers 0 and 1
  auto qs = [&](int i) { return base + TILE * (i & 1); };
  auto ks = [&](int i) { return base + TILE * (2 + (i & 1)); };
  const int q0 = blockIdx.x * BQ, k0 = blockIdx.y * BK;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, c2 = 2 * (lane % 4);
  const float inv_h = 1.0f / (float)H;
  float s[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  attn::load_tile<0>(qs(0), q, q0, L, d, vec);
  attn::load_tile<0>(ks(0), k, k0, L, d, vec);
  sm90::cp_async_commit();
  for (int h = 0; h < H; ++h) {
    if (h + 1 < H) {
      const size_t next = (size_t)(h + 1) * L * d;
      attn::load_tile<0>(qs(h + 1), q + next, q0, L, d, vec);
      attn::load_tile<0>(ks(h + 1), k + next, k0, L, d, vec);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    float lsr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + 8 * half;
      lsr[half] = row < L ? lse[(size_t)h * L + row] : 0.f;
    }
    sm90::fence_async_smem();
    __syncthreads();
    tile_logits_bf16(qs(h), ks(h), scale, s);
    __syncthreads();  // every warp is done with this head's tiles
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (k0 + 8 * (i / 4) + c2 + (i & 1) < L)
        acc[i] = fmaf(__expf(s[i] - lsr[(i / 2) & 1]), inv_h, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = q0 + r0 + 8 * ((i / 2) & 1), col = k0 + 8 * (i / 4) + c2 + (i & 1);
    if (row < L && col < L) tap[(size_t)row * L + col] = acc[i];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* tap, void* lse,
               int H, int L, int d, float scale, cudaStream_t st) {
  constexpr size_t out_smem = tf32::tile_smem<DP>(), mean = mean_smem<DP>();
  static_assert(out_smem <= MAX_SMEM && mean <= MAX_SMEM, "the tiles fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(tap_out_f32<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)out_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tap_mean_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mean);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const int nt = (L + tf32::ROWS - 1) / tf32::ROWS, keys = MEAN_TILES * tf32::F32<DP>::KEYS;
  tap_out_f32<DP><<<dim3(nt, H), tf32::THREADS, out_smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, L, d, scale,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tap_mean_f32<DP><<<dim3(nt, (L + keys - 1) / keys), tf32::THREADS, mean, st>>>(
      (const float*)q, (const float*)k, (const float*)lse, (float*)tap, H, L, d, scale, vec);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, void* tap, void* lse,
                int H, int L, int d, float scale, cudaStream_t st) {
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const int nt = (L + BQ - 1) / BQ;
  tap_out_bf16<<<dim3(nt, H), B_THREADS, B_OUT_SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, L, d, scale, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tap_mean_bf16<<<dim3(nt, nt), B_THREADS, B_MEAN_SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const float*)lse, (float*)tap, H, L, d,
      scale, vec);
  return (int)cudaGetLastError();
}

bool valid(int H, int L, int d) {
  const int nt = (L + BQ - 1) / BQ;
  return H >= 1 && L >= 1 && d >= 1 && d <= DMAX && nt <= 65535 && H <= 65535;
}

}  // namespace

// lse: float32 (H, L) scratch the caller allocates; tap_out writes it and
// tap_mean reads it.  Returns a cudaError_t, checked after each launch.
extern "C" int mars_attention_tap_f32(const void* q, const void* k, const void* v, void* out,
                                      void* tap, void* lse, int H, int L, int d, float scale,
                                      void* stream) {
  if (!valid(H, L, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tf32::f32_dp(d) == 32) return launch_f32<32>(q, k, v, out, tap, lse, H, L, d, scale, st);
  return launch_f32<64>(q, k, v, out, tap, lse, H, L, d, scale, st);
}

extern "C" int mars_attention_tap_bf16(const void* q, const void* k, const void* v, void* out,
                                       void* tap, void* lse, int H, int L, int d, float scale,
                                       void* stream) {
  if (!valid(H, L, d)) return (int)cudaErrorInvalidValue;
  return launch_bf16(q, k, v, out, tap, lse, H, L, d, scale, (cudaStream_t)stream);
}
