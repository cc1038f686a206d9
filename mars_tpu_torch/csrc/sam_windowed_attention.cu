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
//   Logits and the softmax are float32 and P is normalised, then rounded to
//   the input type before the P.V product, as the TPU kernel's
//   probs.astype(v.dtype) does.  Every key of the window is attended: the
//   zero-padded border tokens of a partitioned grid are keys in the contract
//   (the TPU kernel masks only its own 196 -> 256 lane padding).
//
// What bounds it: at SAM ViT-H @1024 a windowed layer has 25 windows of 14 x
// 14 = 196 tokens and 16 heads: 400 window-heads, d = 80.  The two products
// are 4 * 400 * 196^2 * 80 = 4.9 GFLOP against ~50 MB (float32) of inputs and
// output, so in float32 the arithmetic rate bounds it and in bfloat16 the
// bytes do.
//
// Design.  One CTA per window-head (400 CTAs at ViT-H, about three waves on
// 132 SMs).  The window's K and V sit whole in shared memory as float32
// (196 x 81 x 4 B = 62 KB each at d = 80), with each key's row and column in
// the window; the CTA then walks its queries in chunks of BQ rows (64, or 32
// or 16 where 64 would not fit in 227 KB): the chunk's q rows and bias rows
// are loaded, its whole (BQ, L) logit block is computed into shared memory
// with the bias indexed directly (the TPU's 0/1 expander matmuls, _expanders,
// were a device for its matrix unit), an exact whole-row softmax normalises
// it in place, and P.V accumulates in float32 registers.  Products run on the
// CUDA cores in float32 (fma); wgmma and TMA are work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BK = 64;        // keys per logit sweep step
constexpr int DMAX = 128;     // head-dim capacity
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows RPT*ty .. RPT*ty + RPT-1
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout (floats unless noted) for L keys, head dim padded to
// dp, bias widths hg and wg, and BQ query rows per chunk.
struct Layout {
  int ld, dp, ls;
  size_t k, v, q, s, bh, bw, ky, kx, bytes;
  __host__ __device__ Layout(int L, int d, int hg, int wg, int bq) {
    dp = (d + 15) / 16 * 16;
    ld = dp + 1;
    ls = L + 1;
    k = 0;
    v = k + (size_t)L * ld;
    q = v + (size_t)L * ld;
    s = q + (size_t)bq * ld;
    bh = s + (size_t)bq * ls;
    bw = bh + (size_t)bq * hg;
    ky = bw + (size_t)bq * wg;  // int
    kx = ky + L;                // int
    bytes = (kx + L) * sizeof(float);
  }
};

template <typename T, int BQ>
__global__ void __launch_bounds__(THREADS)
windowed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ bias_h,
                          const T* __restrict__ bias_w, T* __restrict__ out, int L, int d,
                          int hg, int wg, float scale) {
  constexpr int RPT = BQ / 16;       // query rows per thread
  constexpr int TPR = THREADS / BQ;  // threads per row in the softmax
  extern __shared__ float smem[];
  const Layout lay(L, d, hg, wg, BQ);
  const int ld = lay.ld, dp = lay.dp, ls = lay.ls;
  float* Ks = smem + lay.k;
  float* Vs = smem + lay.v;
  float* Qs = smem + lay.q;
  float* Ss = smem + lay.s;
  float* Bh = smem + lay.bh;
  float* Bw = smem + lay.bw;
  int* Ky = reinterpret_cast<int*>(smem + lay.ky);
  int* Kx = reinterpret_cast<int*>(smem + lay.kx);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t hoff = (size_t)blockIdx.x * L * d;
  const size_t boff = (size_t)blockIdx.x * L;
  const int ncol = dp / 16;  // output columns per thread: tx + 16 * jj

  for (int idx = threadIdx.x; idx < L * dp; idx += THREADS) {
    const int r = idx / dp, c = idx % dp;
    const bool live = c < d;
    Ks[r * ld + c] = live ? to_f32(k[hoff + (size_t)r * d + c]) : 0.f;
    Vs[r * ld + c] = live ? to_f32(v[hoff + (size_t)r * d + c]) : 0.f;
  }
  for (int key = threadIdx.x; key < L; key += THREADS) {
    Ky[key] = key / wg;
    Kx[key] = key % wg;
  }

  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();  // K, V loaded; the previous chunk is done with Qs, Ss, Bh, Bw
    for (int idx = threadIdx.x; idx < BQ * dp; idx += THREADS) {
      const int r = idx / dp, c = idx % dp, row = q0 + r;
      Qs[r * ld + c] = (row < L && c < d) ? to_f32(q[hoff + (size_t)row * d + c]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BQ * hg; idx += THREADS) {
      const int row = q0 + idx / hg;
      Bh[idx] = row < L ? to_f32(bias_h[(boff + row) * hg + idx % hg]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BQ * wg; idx += THREADS) {
      const int row = q0 + idx / wg;
      Bw[idx] = row < L ? to_f32(bias_w[(boff + row) * wg + idx % wg]) : 0.f;
    }
    __syncthreads();

    // logits of the chunk: s[i][j] is row RPT*ty + i, key k0 + tx + 16j
    for (int k0 = 0; k0 < L; k0 += BK) {
      float s[RPT][4] = {};
      int kr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kr[j] = min(k0 + tx + 16 * j, L - 1) * ld;
      for (int dd = 0; dd < dp; ++dd) {
        float qv[RPT], kv[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = Qs[(RPT * ty + i) * ld + dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[kr[j] + dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = RPT * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key < L)
            Ss[r * ls + key] = __fadd_rn(__fadd_rn(__fmul_rn(s[i][j], scale), Bh[r * hg + Ky[key]]),
                                         Bw[r * wg + Kx[key]]);
        }
      }
    }
    __syncthreads();

    // exact whole-row softmax in place: TPR threads per row
    {
      const int r = threadIdx.x / TPR, lane = threadIdx.x % TPR;
      float* row = Ss + r * ls;
      float mx = -INFINITY;
      for (int c = lane; c < L; c += TPR) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int c = lane; c < L; c += TPR) {
        const float e = expf(row[c] - mx);
        row[c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int c = lane; c < L; c += TPR) row[c] = to_f32(from_f32<T>(__fdiv_rn(row[c], sum)));
    }
    __syncthreads();

    float acc[RPT][DMAX / 16];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < DMAX / 16; ++jj) acc[i][jj] = 0.f;
    for (int c = 0; c < L; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ss[(RPT * ty + i) * ls + c];
#pragma unroll
      for (int jj = 0; jj < DMAX / 16; ++jj) {
        if (jj < ncol) {
          const float vv = Vs[c * ld + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + RPT * ty + i;
      if (row >= L) continue;
#pragma unroll
      for (int jj = 0; jj < DMAX / 16; ++jj) {
        const int dim = tx + 16 * jj;
        if (jj < ncol && dim < d) out[hoff + (size_t)row * d + dim] = from_f32<T>(acc[i][jj]);
      }
    }
  }
}

template <typename T, int BQ>
int launch_bq(const void* q, const void* k, const void* v, const void* bh, const void* bw,
              void* out, int BH, int L, int d, int hg, int wg, float scale, void* stream) {
  const Layout lay(L, d, hg, wg, BQ);
  cudaError_t err = cudaFuncSetAttribute(windowed_attention_kernel<T, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  windowed_attention_kernel<T, BQ><<<BH, THREADS, lay.bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bh, (const T*)bw, (T*)out, L, d, hg, wg,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bh, const void* bw,
           void* out, int BH, int L, int d, int hg, int wg, float scale, void* stream) {
  if (BH < 1 || L < 1 || d < 1 || d > DMAX || hg < 1 || wg < 1 || hg * wg != L)
    return (int)cudaErrorInvalidValue;
  // the largest query chunk whose layout fits in shared memory
  if (Layout(L, d, hg, wg, 64).bytes <= (size_t)MAX_SMEM)
    return launch_bq<T, 64>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, stream);
  if (Layout(L, d, hg, wg, 32).bytes <= (size_t)MAX_SMEM)
    return launch_bq<T, 32>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, stream);
  if (Layout(L, d, hg, wg, 16).bytes <= (size_t)MAX_SMEM)
    return launch_bq<T, 16>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, stream);
  return (int)cudaErrorInvalidValue;  // the window's K and V do not fit
}

}  // namespace

extern "C" int mars_windowed_attention_f32(const void* q, const void* k, const void* v,
                                           const void* bh, const void* bw, void* out, int BH,
                                           int L, int d, int hg, int wg, float scale,
                                           void* stream) {
  return launch<float>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, stream);
}

extern "C" int mars_windowed_attention_bf16(const void* q, const void* k, const void* v,
                                            const void* bh, const void* bw, void* out, int BH,
                                            int L, int d, int hg, int wg, float scale,
                                            void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bh, bw, out, BH, L, d, hg, wg, scale, stream);
}
