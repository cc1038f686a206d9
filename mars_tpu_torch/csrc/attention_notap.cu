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
//   float32 row sum divides at the end, so a bfloat16 output may differ from
//   the contract by one bfloat16 rounding of P (float32 outputs do not).
//   The TPU kernel's heads_per_step only sized Mosaic's grid steps; nothing
//   here corresponds to it.
//
// What bounds it: at the path's shapes (DINOv2-L: BH = 16, L = 1374, d = 64;
// CLIP-B/16 @528: BH = 12, L = 1090; AlphaCLIP-L/14@336: BH = 16 x 16, L =
// 577) the two products are 4 * BH * L^2 * d operations (7.7, 3.6 and 21.8
// GFLOP) against 14-38 MB of inputs and output, so in float32 the card's
// arithmetic rate bounds it; in bfloat16 at AlphaCLIP's shape the bytes do.
//
// Design.  A flash-style online softmax, as csrc/sam_grid_attention.cu without
// the bias: one CTA per (batch-head, 64-row query tile) -- 22 x 16 = 352 CTAs
// for DINOv2-L at B = 1, 10 x 256 = 2560 for an AlphaCLIP chunk -- sweeps the
// keys once in tiles of 64 through shared memory, keeping a float32 running
// max and sum per row and rescaling its float32 output accumulator.  Keys past
// L are masked; query rows past L are computed on zeros and not stored.
// Products run on the CUDA cores in float32 (fma); wgmma and TMA are work for
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int DMAX = 128;     // head-dim capacity
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of an (L, d) matrix into a (64, ld) float tile;
// rows >= L and columns in [d, dp) are zero.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int L, int d, int dp) {
  for (int idx = threadIdx.x; idx < BQ * dp; idx += THREADS) {
    const int r = idx / dp, c = idx % dp, row = row0 + r;
    dst[r * ld + c] = (row < L && c < d) ? to_f32(src[(size_t)row * d + c]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_notap_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int L, int d,
                       float scale) {
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

  load_tile(Qs, ld, q + hoff, q0, L, d, dp);

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
    load_tile(Ks, ld, k + hoff, k0, L, d, dp);
    load_tile(Vs, ld, v + hoff, k0, L, d, dp);
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
int launch(const void* q, const void* k, const void* v, void* out, int BH, int L, int d,
           float scale, void* stream) {
  if (BH < 1 || BH > MAX_GRID_Y || L < 1 || d < 1 || d > DMAX) return (int)cudaErrorInvalidValue;
  const Layout lay(d);
  cudaError_t err = cudaFuncSetAttribute(attention_notap_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, BH);
  attention_notap_kernel<T><<<grid, THREADS, lay.bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, L, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mars_attention_notap_f32(const void* q, const void* k, const void* v, void* out,
                                        int BH, int L, int d, float scale, void* stream) {
  return launch<float>(q, k, v, out, BH, L, d, scale, stream);
}

extern "C" int mars_attention_notap_bf16(const void* q, const void* k, const void* v, void* out,
                                         int BH, int L, int d, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, BH, L, d, scale, stream);
}
