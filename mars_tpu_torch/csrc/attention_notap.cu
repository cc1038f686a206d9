// Softmax attention without a probability tap, for Hopper (sm_90a).
//
// Replaces the TPU kernel mars_tpu/ops/flash_attention.py:attention_notap
// (Pallas body _kernel_notap).  Contract, as there:
//   q, k, v:  (BH, L, d) row-major, the (B, H) batch flattened, float32 or
//             bfloat16, d <= 128
//   out:      (BH, L, d) in the input type, softmax(q k^T * d^-0.5) v per
//             batch-head
//   Logits and the softmax are float32; with bfloat16 inputs P is rounded to
//   bfloat16 before the P.V product, as the TPU kernel's probs.astype(v.dtype)
//   does.  Here the unnormalised exp(s - running max) is rounded and the
//   float32 row sum of the rounded values divides at the end, so a bfloat16
//   output may differ from the contract by one bfloat16 rounding of P
//   (float32 outputs do not).  The TPU kernel's heads_per_step only sized
//   Mosaic's grid steps; nothing here corresponds to it.
//
// What bounds it: at the path's shapes (DINOv2-L: BH = 16, L = 1374, d = 64;
// CLIP-B/16 @528: BH = 12, L = 1090; AlphaCLIP-L/14@336: BH = 16 x 16, L =
// 577) the two products are 4 * BH * L^2 * d operations (7.7, 3.6 and 21.8
// GFLOP) against 14-38 MB of inputs and output: in float32 the CUDA cores'
// arithmetic rate bounds it, in bfloat16 the tensor cores' (DINOv2-L, CLIP-B)
// or the bytes (an AlphaCLIP chunk, 0.023 ms).
//
// Design.  One launch over the (B.H) batch, grid (64-row query tiles, BH):
// 352 CTAs for DINOv2-L at B = 1, 216 for CLIP-B, 2560 for an AlphaCLIP
// chunk.  Each CTA sweeps the keys once in tiles of 64 with a float32 online
// softmax; keys past L are masked, query rows past L are computed on zeros
// and not stored.
//   bfloat16: one warpgroup on the tensor cores (csrc/attention_sm90.cuh).
//   Q stays in shared memory; K and V tiles arrive through cp.async, double
//   buffered.  Q K^T is wgmma from shared memory; the row's tile max is
//   shared by the 4 threads that hold the row (two shuffles) before
//   P = exp(s - running max) is formed and rounded to bf16 in the
//   accumulator registers, which are the A fragment of P.V, so P never
//   touches shared memory; V is read as an MN-major operand (no transpose).
//   The output accumulator is rescaled by exp(m_old - m_new) after the
//   previous P.V has completed.  Head dims past 64 take a second panel
//   (the tile note of attention_sm90.cuh).
//   float32: 256 threads on the CUDA cores (TF32 would break the 2e-5
//   float32 limits), a 4-row x 4-key register block a thread, P through
//   shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int BQ = 64;     // query rows per CTA
constexpr int BK = 64;     // keys per tile
constexpr int DMAX = 128;  // head-dim capacity
constexpr int MAX_GRID_Y = 65535;

// ------------------------------------------------------------ float32
constexpr int F_THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3

// Rows [row0, row0 + 64) of an (L, d) matrix into a (64, ld) tile; rows >= L
// and columns in [d, dp) are zero.
__device__ void load_tile_f32(float* dst, int ld, const float* src, int row0, int L, int d,
                              int dp) {
  for (int idx = threadIdx.x; idx < BQ * dp; idx += F_THREADS) {
    const int r = idx / dp, c = idx % dp, row = row0 + r;
    dst[r * ld + c] = (row < L && c < d) ? src[(size_t)row * d + c] : 0.f;
  }
}

// Shared-memory layout (floats) for the head dim padded to dp.
struct Layout {
  int ld, dp;
  size_t q, k, v, p, bytes;
  __host__ __device__ explicit Layout(int d) {
    dp = (d + 15) / 16 * 16;
    ld = dp + 1;
    q = 0;
    k = q + (size_t)BQ * ld;
    v = k + (size_t)BK * ld;
    p = v + (size_t)BK * ld;
    bytes = (p + (size_t)BQ * (BK + 1)) * sizeof(float);
  }
};

__global__ void __launch_bounds__(F_THREADS)
notap_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ out, int L, int d, float scale) {
  extern __shared__ float smem[];
  const Layout lay(d);
  const int ld = lay.ld, dp = lay.dp;
  float* Qs = smem + lay.q;
  float* Ks = smem + lay.k;
  float* Vs = smem + lay.v;
  float* Ps = smem + lay.p;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t hoff = (size_t)blockIdx.y * L * d;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (L + BK - 1) / BK;
  const int ncol = dp / 16;  // output columns per thread: tx + 16 * jj

  load_tile_f32(Qs, ld, q + hoff, q0, L, d, dp);

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
    __syncthreads();  // the previous tile is done with Ks, Vs, Ps
    load_tile_f32(Ks, ld, k + hoff, k0, L, d, dp);
    load_tile_f32(Vs, ld, v + hoff, k0, L, d, dp);
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
        s[i][j] = (k0 + tx + 16 * j < L) ? __fmul_rn(s[i][j], scale) : -INFINITY;
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
        const float p = expf(s[i][j] - m_new);
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
      if (jj < ncol && dim < d) out[hoff + (size_t)row * d + dim] = acc[i][jj] * inv;
    }
  }
}

// ------------------------------------------------------------ bfloat16
template <int R>
__global__ void __launch_bounds__(attn::THREADS)
notap_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int L, int d,
           float scale, int vec) {
  using Tile = attn::Tile<R>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::aligned_base(smem_raw);
  // Q, then K buffers 0 and 1, then V buffers 0 and 1
  const uint32_t qs = base;
  auto ks = [&](int i) { return base + Tile::BYTES * (1 + (i & 1)); };
  auto vs = [&](int i) { return base + Tile::BYTES * (3 + (i & 1)); };
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * L * d;
  const int ntiles = (L + BK - 1) / BK;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane % 4);                      // keys 8j + c2 and + 1 of a tile

  attn::load_tile<R>(qs, q + head, q0, L, d, vec);
  attn::load_tile<R>(ks(0), k + head, 0, L, d, vec);
  attn::load_tile<R>(vs(0), v + head, 0, L, d, vec);
  sm90::cp_async_commit();

  // running max (shared by the row's 4 threads) and this thread's share of
  // the row sum of the rounded P, per row half
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32], o0[32], o1[Tile::O1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Tile::O1; ++i) o1[i] = 0.f;

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

    // register i of s is (row r0 + 8 ((i / 2) % 2), key 8 (i / 4) + c2 + i % 2)
    const int k0 = t * BK;
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          s[i] = k0 + 8 * j + c2 + e < L ? __fmul_rn(s[i], scale) : -INFINITY;
          tmax = fmaxf(tmax, s[i]);
        }
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
    __syncthreads();  // every warp is done with K and V buffers t
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

int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int L, int d,
               float scale, cudaStream_t st) {
  const Layout lay(d);
  cudaError_t err = cudaFuncSetAttribute(notap_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  notap_f32<<<dim3((L + BQ - 1) / BQ, BH), F_THREADS, lay.bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, L, d, scale);
  return (int)cudaGetLastError();
}

template <int R>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int L, int d,
                float scale, cudaStream_t st) {
  const size_t smem = 5 * attn::Tile<R>::BYTES + 1024;  // Q, 2 x K, 2 x V, alignment slack
  cudaError_t err = cudaFuncSetAttribute(notap_bf16<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  notap_bf16<R><<<dim3((L + BQ - 1) / BQ, BH), attn::THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, L, d, scale, vec);
  return (int)cudaGetLastError();
}

bool valid(int BH, int L, int d) {
  return BH >= 1 && BH <= MAX_GRID_Y && L >= 1 && d >= 1 && d <= DMAX;
}

}  // namespace

extern "C" int mars_attention_notap_f32(const void* q, const void* k, const void* v, void* out,
                                        int BH, int L, int d, float scale, void* stream) {
  if (!valid(BH, L, d)) return (int)cudaErrorInvalidValue;
  return launch_f32(q, k, v, out, BH, L, d, scale, (cudaStream_t)stream);
}

extern "C" int mars_attention_notap_bf16(const void* q, const void* k, const void* v, void* out,
                                         int BH, int L, int d, float scale, void* stream) {
  if (!valid(BH, L, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (attn::panel1(d)) {
    case 0: return launch_bf16<0>(q, k, v, out, BH, L, d, scale, st);
    case 16: return launch_bf16<16>(q, k, v, out, BH, L, d, scale, st);
    default: return launch_bf16<64>(q, k, v, out, BH, L, d, scale, st);
  }
}
