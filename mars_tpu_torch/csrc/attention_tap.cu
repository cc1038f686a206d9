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
// (7.7 GFLOP for DINOv2-L) against ~30 MB of input and output, so the card's
// float32 rate bounds it, not its memory.
//
// Design.  The TPU kernel holds a whole (256, L) float32 row block in VMEM;
// 64 rows x 1408 columns is already 360 KB, above the 227 KB of shared memory
// a block may use.  So one CTA owns a 64-row query tile and loops over the
// heads itself; per head it sweeps the keys twice in tiles of 64:
//   pass 1  logits -> per-row running max and sum of exponentials;
//   pass 2  logits again -> normalised P, which feeds out += P.V (through
//           shared memory) and tap[rows, tile] (+)= P / H.
// The CTA owns its tap rows, so it read-modify-writes them in global memory
// (they stay resident in the 50 MB L2) with no atomics: the sum over heads is
// taken in head order by the same thread for every element, and the tap is
// the same from run to run.  Products run on the CUDA cores in float32 (fma);
// tensor cores, TMA and the occupancy left on the table (22 CTAs of 64 rows at
// L=1374 fill 22 of 132 SMs) are work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per tile
constexpr int DMAX = 64;       // head-dim capacity; a smaller d is zero-padded
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int LD = DMAX + 1;   // padded row stride of the shared tiles
constexpr size_t SMEM_BYTES = (size_t)(BQ + 3 * BK) * LD * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of one head's (L, d) matrix into a (64, LD) float
// tile; rows >= L and columns >= d are zero.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int row0, int L, int d) {
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX, row = row0 + r;
    dst[r * LD + c] = (row < L && c < d) ? to_f32(src[(size_t)row * d + c]) : 0.f;
  }
}

// s[i][j] = scale * <Q[4ty + i], K[tx + 16j]> for this thread's 4 x 4 cells.
__device__ __forceinline__ void tile_logits(const float* Qs, const float* Ks, int ty, int tx,
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_tap_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ tap, int H, int L, int d,
                     float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (L + BK - 1) / BK;
  const float inv_h = 1.0f / (float)H;

  for (int h = 0; h < H; ++h) {
    const size_t head = (size_t)h * L * d;
    __syncthreads();  // the previous head is done with every tile
    load_tile(Qs, q + head, q0, L, d);

    // pass 1: per-thread running max / sum over this thread's columns
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
    for (int t = 0; t < ntiles; ++t) {
      __syncthreads();
      load_tile(Ks, k + head, t * BK, L, d);
      __syncthreads();
      float s[4][4];
      tile_logits(Qs, Ks, ty, tx, scale, s);
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mi = m[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, off));
      float li = l[i] > 0.f ? l[i] * expf(m[i] - mi) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
      m[i] = mi;
      l[i] = li;
    }

    // pass 2: normalised P -> tap and P.V
    float acc[4][4] = {};
    for (int t = 0; t < ntiles; ++t) {
      __syncthreads();
      load_tile(Ks, k + head, t * BK, L, d);
      load_tile(Vs, v + head, t * BK, L, d);
      __syncthreads();
      float s[4][4];
      tile_logits(Qs, Ks, ty, tx, scale, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = t * BK + tx + 16 * j;
          const float p = col < L ? expf(s[i][j] - m[i]) / l[i] : 0.f;
          Ps[(4 * ty + i) * LD + tx + 16 * j] = to_f32(from_f32<T>(p));
          if (row < L && col < L) {
            float* cell = tap + (size_t)row * L + col;
            const float add = p * inv_h;
            *cell = h == 0 ? add : *cell + add;
          }
        }
      }
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
        if (dim < d) out[head + (size_t)row * d + dim] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* tap, int H, int L,
           int d, float scale, void* stream) {
  if (H < 1 || L < 1 || d < 1 || d > DMAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_tap_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ);
  attention_tap_kernel<T><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)tap, H, L, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mars_attention_tap_f32(const void* q, const void* k, const void* v, void* out,
                                      void* tap, int H, int L, int d, float scale,
                                      void* stream) {
  return launch<float>(q, k, v, out, tap, H, L, d, scale, stream);
}

extern "C" int mars_attention_tap_bf16(const void* q, const void* k, const void* v, void* out,
                                       void* tap, int H, int L, int d, float scale,
                                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, tap, H, L, d, scale, stream);
}
