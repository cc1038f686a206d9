// Weight-only 4-bit matmuls for Hopper (sm_90a): hybrid-coded int4 and NF4.
//
// Replaces the TPU kernels mars_tpu/ops/int4_matmul.py:matmul_int4 (Pallas
// body _kernel) and :matmul_nf4 (_nf4_kernel).  Contract, as there:
//   x:       (M, IN) row-major, float32 or bfloat16
//   packed:  (IN/2, OUT) bytes, row-major; byte [r, o] holds input rows 2r
//            (low nibble) and 2r+1 (high nibble) of output column o
//   int4:    low nibble = q[2r] + 8, high nibble = signed q[2r+1], so
//            q[2r] = (b & 0xF) - 8 and q[2r+1] = (signed char)b >> 4;
//            y = (x @ q) * scale[o], scale (OUT,) float32, applied after the
//            float32 accumulation
//   nf4:     both nibbles are unsigned indices into the 16-entry NF4 codebook;
//            w = round_to_x_type(code[c] * bscale[row / 64, o]), bscale
//            (IN/64, OUT) float32, folded in before the product
//   out:     (M, OUT) in x's type; products and sums in float32.
// IN must be even (nf4: a multiple of 64); ragged IN, OUT and M are masked
// here, never padded by copying the weights.
//
// What bounds it.  At decode (M = 1-8 rows) the packed bytes dominate: a
// LLaMA-7B MLP kernel 4096 x 11008 is 22.5 MB of codes against 2 * M * IN
// * OUT = 90 MFLOP per row, so memory bounds it (6.7 us at 3.35 TB/s).  At
// prefill (M ~ 2330) the same kernel is 210 GFLOP against ~45 MB of inputs
// and outputs: the operations bound it.
//
// Design.  Two kernels behind one entry point, picked by M.
//   gemv_kernel (M <= 8): a CTA owns 32 output columns; its 8 column threads
//     each read one 32-bit word (4 columns) of a packed row, so a warp reads
//     whole 32-byte sectors, and 32 groups of them split the packed rows.
//     Every thread keeps 8 x 4 float32 sums in registers; the 32 partial
//     sums of each output are added in a fixed order through shared memory,
//     so reruns are bitwise equal.
//   gemm_kernel (M > 8): a 64 x 128 output tile per CTA, K in steps of 32;
//     the x tile and the unpacked weight tile are staged in shared memory as
//     float32 and each of 256 threads accumulates a 4 x 8 block with FMAs.
// Both unpack in registers; the NF4 codebook sits in shared memory.  These
// run on the CUDA cores: wgmma, TMA and split-K are work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FMT_INT4 = 0;
constexpr int FMT_NF4 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The two weights of one packed byte (rows 2r and 2r+1).  ``s`` is the NF4
// block scale of the column (unused for int4).
template <int FMT, typename T>
__device__ __forceinline__ void unpack(uint32_t byte, float s, const float* code, float& w0,
                                       float& w1) {
  if (FMT == FMT_INT4) {
    const int b = (int)(signed char)byte;
    w0 = (float)((b & 0xF) - 8);
    w1 = (float)(b >> 4);  // arithmetic shift: the signed odd row
  } else {
    w0 = to_f32(from_f32<T>(__fmul_rn(code[byte & 0xF], s)));
    w1 = to_f32(from_f32<T>(__fmul_rn(code[(byte >> 4) & 0xF], s)));
  }
}

// ---------------------------------------------------------------- GEMV
constexpr int GV_COLS = 4;                  // columns per thread: one 32-bit word
constexpr int GV_CT = 8;                    // column threads per CTA
constexpr int GV_KG = 32;                   // packed-row groups per CTA
constexpr int GV_THREADS = GV_CT * GV_KG;   // 256
constexpr int GV_BN = GV_COLS * GV_CT;      // 32 columns per CTA
constexpr int GV_MAX_M = 8;

template <int FMT, typename T>
__global__ void __launch_bounds__(GV_THREADS)
gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
            const float* __restrict__ scale, const float* __restrict__ code_g,
            T* __restrict__ out, int M, int IN, int OUT) {
  __shared__ float code[16];
  __shared__ float red[GV_KG][GV_MAX_M][GV_BN];
  if (threadIdx.x < 16) code[threadIdx.x] = FMT == FMT_NF4 ? code_g[threadIdx.x] : 0.f;
  __syncthreads();

  const int ct = threadIdx.x % GV_CT, kg = threadIdx.x / GV_CT;
  const int col0 = blockIdx.x * GV_BN + ct * GV_COLS;
  const int rows = IN / 2;
  const bool vec = col0 + GV_COLS <= OUT && OUT % 4 == 0 &&
                   ((uintptr_t)packed & 3) == 0;
  float acc[GV_MAX_M][GV_COLS];
#pragma unroll
  for (int m = 0; m < GV_MAX_M; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) acc[m][c] = 0.f;

#pragma unroll 4
  for (int r = kg; r < rows; r += GV_KG) {
    uint32_t word = 0;
    const uint8_t* row = packed + (size_t)r * OUT;
    if (vec) {
      word = __ldg(reinterpret_cast<const uint32_t*>(row + col0));
    } else {
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c)
        if (col0 + c < OUT) word |= (uint32_t)__ldg(row + col0 + c) << (8 * c);
    }
    float s[GV_COLS] = {0.f, 0.f, 0.f, 0.f};
    if (FMT == FMT_NF4) {
      const float* srow = scale + (size_t)(r / 32) * OUT;
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c) s[c] = col0 + c < OUT ? __ldg(srow + col0 + c) : 0.f;
    }
    float xe[GV_MAX_M], xo[GV_MAX_M];
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) {
      xe[m] = m < M ? to_f32(x[(size_t)m * IN + 2 * r]) : 0.f;
      xo[m] = m < M ? to_f32(x[(size_t)m * IN + 2 * r + 1]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) {
      float w0, w1;
      unpack<FMT, T>((word >> (8 * c)) & 0xFF, s[c], code, w0, w1);
#pragma unroll
      for (int m = 0; m < GV_MAX_M; ++m) {
        acc[m][c] = fmaf(xe[m], w0, acc[m][c]);
        acc[m][c] = fmaf(xo[m], w1, acc[m][c]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < GV_MAX_M; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) red[kg][m][ct * GV_COLS + c] = acc[m][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * GV_BN; idx += GV_THREADS) {
    const int m = idx / GV_BN, c = idx % GV_BN, col = blockIdx.x * GV_BN + c;
    if (col >= OUT) continue;
    float v = 0.f;
    for (int g = 0; g < GV_KG; ++g) v += red[g][m][c];
    if (FMT == FMT_INT4) v = __fmul_rn(v, scale[col]);
    out[(size_t)m * OUT + col] = from_f32<T>(v);
  }
}

// ---------------------------------------------------------------- GEMM
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int TM = 4, TN = 8;  // per thread: rows 4ty.., columns 4tx.. and 64 + 4tx..
constexpr int GT = 256;
constexpr int AS_LD = BM + 4;  // keeps float4 rows aligned, spreads the transposed stores

template <int FMT, typename T>
__global__ void __launch_bounds__(GT)
gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
            const float* __restrict__ scale, const float* __restrict__ code_g,
            T* __restrict__ out, int M, int IN, int OUT) {
  __shared__ float code[16];
  __shared__ __align__(16) float As[BK][AS_LD];  // x tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];     // unpacked weights
  if (threadIdx.x < 16) code[threadIdx.x] = FMT == FMT_NF4 ? code_g[threadIdx.x] : 0.f;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = IN / 2;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < IN; k0 += BK) {
    __syncthreads();  // the previous step is done with As and Bs (and code is set)
#pragma unroll
    for (int j = 0; j < BM * BK / GT; ++j) {
      const int idx = threadIdx.x + GT * j, r = idx / BK, kk = idx % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < IN) ? to_f32(x[(size_t)m * IN + k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < (BK / 2) * BN / GT; ++j) {
      const int idx = threadIdx.x + GT * j, pr = idx / BN, c = idx % BN;
      const int r = k0 / 2 + pr, col = n0 + c;
      float w0 = 0.f, w1 = 0.f;
      if (r < rows && col < OUT) {
        const float s = FMT == FMT_NF4 ? __ldg(scale + (size_t)(r / 32) * OUT + col) : 0.f;
        unpack<FMT, T>(__ldg(packed + (size_t)r * OUT + col), s, code, w0, w1);
      }
      Bs[2 * pr][c] = w0;
      Bs[2 * pr + 1][c] = w1;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col >= OUT) continue;
      float v = acc[i][j];
      if (FMT == FMT_INT4) v = __fmul_rn(v, scale[col]);
      out[(size_t)m * OUT + col] = from_f32<T>(v);
    }
  }
}

template <int FMT, typename T>
int launch(const void* x, const void* packed, const void* scale, const void* code, void* out,
           int M, int IN, int OUT, void* stream) {
  if (M < 1 || IN < 2 || IN % 2 || OUT < 1 || (FMT == FMT_NF4 && (IN % 64 || !code)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M <= GV_MAX_M) {
    gemv_kernel<FMT, T><<<(OUT + GV_BN - 1) / GV_BN, GV_THREADS, 0, st>>>(
        (const T*)x, (const uint8_t*)packed, (const float*)scale, (const float*)code, (T*)out,
        M, IN, OUT);
  } else {
    const dim3 grid((OUT + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    gemm_kernel<FMT, T><<<grid, GT, 0, st>>>(
        (const T*)x, (const uint8_t*)packed, (const float*)scale, (const float*)code, (T*)out,
        M, IN, OUT);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = int4 (scale (OUT,)), 1 = nf4 (scale = bscale (IN/64, OUT), code = 16 floats);
// bf16: 0 = float32 x and out, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int mars_matmul_4bit(int fmt, int bf16, const void* x, const void* packed,
                                const void* scale, const void* code, void* out, int M, int IN,
                                int OUT, void* stream) {
  if (fmt == FMT_INT4)
    return bf16 ? launch<FMT_INT4, __nv_bfloat16>(x, packed, scale, code, out, M, IN, OUT, stream)
                : launch<FMT_INT4, float>(x, packed, scale, code, out, M, IN, OUT, stream);
  if (fmt == FMT_NF4)
    return bf16 ? launch<FMT_NF4, __nv_bfloat16>(x, packed, scale, code, out, M, IN, OUT, stream)
                : launch<FMT_NF4, float>(x, packed, scale, code, out, M, IN, OUT, stream);
  return (int)cudaErrorInvalidValue;
}
