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
// What bounds it: at the main path's shapes (DINOv2-L: H=16, L=1374, d=64;
// CLIP-B/16 @528: H=12, L=1090) the two products are 4*H*L^2*d operations
// (7.7 GFLOP for DINOv2-L) against 19 MB (bf16) to 30 MB (float32) of input
// and output, 7.55 MB of it the tap: the operations bound it, in float32 on the CUDA cores
// (0.115 ms at DINOv2-L) and in bfloat16 on the tensor cores (0.008 ms).
//
// Design: two launches per call, deterministic, no atomics.  The TPU kernel
// holds a whole (256, L) float32 row block in VMEM, which does not fit the
// 227 KB of shared memory a block may use, and a CTA that owned its tap rows
// over all heads (one CTA per 64 queries) filled 22 of 132 SMs at B = 1.
//   1. tap_out: grid (query tiles, heads), 352 CTAs at DINOv2-L.  Pass 1
//      sweeps the keys in tiles of 64 for each row's max and sum of
//      exponentials and writes the row's log-sum-exp to a float32 (H, L)
//      scratch; pass 2 sweeps them again for P = exp(s - lse), already
//      normalised, which (rounded to bf16 in bfloat16, the contract's
//      rounding point) feeds out += P.V.
//   2. tap_mean: grid (query tiles, key tiles), 484 CTAs at DINOv2-L.  Each
//      CTA loops over the heads inside itself, recomputes its 64 x 64 logit
//      tile with the same code as tap_out, forms P = exp(s - lse) and adds
//      P / H in registers in head order, then writes each tap element once
//      (7.55 MB, where a read-modify-write per head moved ~240 MB).
// Both kernels compute a logit tile with the same instructions on the same
// tiles, so they see bitwise-equal logits and the tap rows sum to 1.
// bfloat16: one warpgroup per CTA; Q, K and V tiles arrive through cp.async
// (double-buffered) in the 128-byte-swizzled layout of sm90.cuh; Q K^T is
// wgmma m64n64k16 from shared memory, P.V takes P from registers (the
// accumulator layout of Q K^T is wgmma's A-fragment layout) and V from
// shared memory as an MN-major operand.  float32 stays on the CUDA cores at
// full precision (TF32 would break the 1e-5 tolerances): 256 threads, a
// 4 x 4 register block a thread, gaining from the grid that fills the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int DMAX = 64;  // head-dim capacity; a smaller d is zero-padded

// ------------------------------------------------------------ float32
constexpr int F_THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int LD = DMAX + 1;    // padded row stride of the shared tiles
constexpr size_t F_OUT_SMEM = (size_t)(BQ + 3 * BK) * LD * sizeof(float);
constexpr size_t F_MEAN_SMEM = (size_t)(BQ + BK) * LD * sizeof(float);

// Rows [row0, row0 + 64) of one head's (L, d) matrix into a (64, LD) float
// tile; rows >= L and columns >= d are zero.
__device__ void load_tile_f32(float* dst, const float* src, int row0, int L, int d) {
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += F_THREADS) {
    const int r = idx / DMAX, c = idx % DMAX, row = row0 + r;
    dst[r * LD + c] = (row < L && c < d) ? src[(size_t)row * d + c] : 0.f;
  }
}

// s[i][j] = scale * <Q[4ty + i], K[tx + 16j]> for this thread's 4 x 4 cells.
__device__ __forceinline__ void tile_logits_f32(const float* Qs, const float* Ks, int ty, int tx,
                                                float scale, float s[4][4]) {
  float acc[4][4] = {};
#pragma unroll 8
  for (int dd = 0; dd < DMAX; ++dd) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + dd];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + dd];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = acc[i][j] * scale;
}

__global__ void __launch_bounds__(F_THREADS)
tap_out_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ out, float* __restrict__ lse, int L, int d, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t head = (size_t)h * L * d;
  const int ntiles = (L + BK - 1) / BK;
  load_tile_f32(Qs, q + head, q0, L, d);

  // pass 1: per-thread running max / sum over this thread's columns
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_tile_f32(Ks, k + head, t * BK, L, d);
    __syncthreads();
    float s[4][4];
    tile_logits_f32(Qs, Ks, ty, tx, scale, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t * BK + tx + 16 * j >= L) continue;  // masked key
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s[i][j] > m[i]) {
          l[i] = l[i] * expf(m[i] - s[i][j]) + 1.f;
          m[i] = s[i][j];
        } else {
          l[i] += expf(s[i][j] - m[i]);
        }
      }
    }
  }
  // combine the 16 threads (one half-warp) that share each row
  float ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mi = m[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, off));
    float li = l[i] > 0.f ? l[i] * expf(m[i] - mi) : 0.f;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    ls[i] = mi + logf(li);
    const int row = q0 + 4 * ty + i;
    if (tx == 0 && row < L) lse[(size_t)h * L + row] = ls[i];
  }

  // pass 2: P = exp(s - lse) -> P.V
  float acc[4][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_tile_f32(Ks, k + head, t * BK, L, d);
    load_tile_f32(Vs, v + head, t * BK, L, d);
    __syncthreads();
    float s[4][4];
    tile_logits_f32(Qs, Ks, ty, tx, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * ty + i) * LD + tx + 16 * j] =
            t * BK + tx + 16 * j < L ? expf(s[i][j] - ls[i]) : 0.f;
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dim = tx + 16 * j;
      if (dim < d) out[head + (size_t)row * d + dim] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
tap_mean_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ lse, float* __restrict__ tap, int H, int L, int d,
             float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ, k0 = blockIdx.y * BK;
  const float inv_h = 1.0f / (float)H;
  float acc[4][4] = {};
  for (int h = 0; h < H; ++h) {
    const size_t head = (size_t)h * L * d;
    __syncthreads();
    load_tile_f32(Qs, q + head, q0, L, d);
    load_tile_f32(Ks, k + head, k0, L, d);
    __syncthreads();
    float s[4][4];
    tile_logits_f32(Qs, Ks, ty, tx, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      const float ls = row < L ? lse[(size_t)h * L + row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < L) acc[i][j] = fmaf(expf(s[i][j] - ls), inv_h, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < L) tap[(size_t)row * L + col] = acc[i][j];
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

int launch_f32(const void* q, const void* k, const void* v, void* out, void* tap, void* lse,
               int H, int L, int d, float scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(tap_out_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F_OUT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nt = (L + BQ - 1) / BQ;
  tap_out_f32<<<dim3(nt, H), F_THREADS, F_OUT_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, L, d, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tap_mean_f32<<<dim3(nt, nt), F_THREADS, F_MEAN_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)lse, (float*)tap, H, L, d, scale);
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
  return launch_f32(q, k, v, out, tap, lse, H, L, d, scale, (cudaStream_t)stream);
}

extern "C" int mars_attention_tap_bf16(const void* q, const void* k, const void* v, void* out,
                                       void* tap, void* lse, int H, int L, int d, float scale,
                                       void* stream) {
  if (!valid(H, L, d)) return (int)cudaErrorInvalidValue;
  return launch_bf16(q, k, v, out, tap, lse, H, L, d, scale, (cudaStream_t)stream);
}
