// SAM global-layer grid attention with the decomposed relative-position
// bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel mars_tpu/ops/sam_attention.py:grid_attention_pallas
// (Pallas body _kernel).  Contract, as there:
//   q, k, v:  (H, L, d) row-major, float32 or bfloat16, q unscaled, d <= 128
//   bias_h:   (H, L, Hg) per-query bias over key rows, same type
//   bias_w:   (H, L, Wg) per-query bias over key columns, same type
//   out:      (H, L, d) in the input type, with Hg * Wg = L and
//     logits[q, k] = (q . k) * d^-0.5 + bias_h[q, k / Wg] + bias_w[q, k % Wg]
//     out = softmax(logits) v
//   Logits and the softmax are float32; with bfloat16 inputs P is rounded to
//   bfloat16 before the P.V product, as the TPU kernel's probs.astype(v.dtype)
//   does (here the unnormalised exp(s - running max) is rounded, then divided
//   by the float32 row sum at the end).
//
// What bounds it: at ViT-H @1024 (H = 16, L = 64 * 64 = 4096, d = 80) the two
// products are 4 * H * L^2 * d = 85.9 GFLOP against ~38 MB of inputs and
// output, so the card's arithmetic rate bounds it, never its memory.
//
// Design.  No probability tap is needed, so this is a flash-style online
// softmax: one CTA per (head, 64-row query tile) -- 16 x 64 = 1024 CTAs at
// ViT-H, enough to fill the 132 SMs -- sweeps the keys once in tiles of 64,
// keeping a per-row running max and sum and rescaling its float32 output
// accumulator.  The CTA's 64 rows of bias_h and bias_w (64 x Hg and 64 x Wg)
// sit in shared memory and are indexed directly per key; the TPU kernel's
// 0/1 expander matmuls (_expanders) were a device for the MXU and are gone.
// Keys past L are masked, query rows past L are computed on zeros and not
// stored.  Products run on the CUDA cores in float32 (fma) from shared
// memory; wgmma and TMA are work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int DMAX = 128;     // head-dim capacity
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

extern "C" int mars_grid_attention_f32(const void* q, const void* k, const void* v,
                                       const void* bh, const void* bw, void* out, int H, int L,
                                       int d, int hg, int wg, float scale, void* stream) {
  return launch<float>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, stream);
}

extern "C" int mars_grid_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* bh, const void* bw, void* out, int H, int L,
                                        int d, int hg, int wg, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bh, bw, out, H, L, d, hg, wg, scale, stream);
}
