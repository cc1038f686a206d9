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
// Design.  Three kernels behind one entry point, picked by M and x's type.
//   gemv_kernel (M <= 8): a CTA owns 32 output columns; its 8 column threads
//     each read one 32-bit word (4 columns) of a packed row, so a warp reads
//     whole 32-byte sectors, and 32 groups of them split the packed rows.
//     Every thread keeps 8 x 4 float32 sums in registers; the 32 partial
//     sums of each output are added in a fixed order through shared memory,
//     so reruns are bitwise equal.  Unpacks in registers.
//   gemm_bf16_kernel (M > 8, bfloat16 x): the tensor cores.  A 128 x 128
//     output tile per CTA, K in steps of 64, two warpgroups of 64 rows.  The
//     x tile (bf16) arrives by cp.async, double-buffered; each thread loads
//     four 32-bit words of packed bytes (4 columns x 8 input rows) a step
//     ahead, and the CTA dequantizes the step's 64 x 128 weights ONCE into a
//     bf16 B tile in shared memory (K-major: a column's 8 input rows are one
//     16-byte store, swizzled for wgmma), so both warpgroups' 128 rows use
//     each dequantized tile.  NF4 reads the codebook from shared memory and
//     one block-scale row per step (64 input rows = one NF4 block); int4's
//     -8..7 are exact in bf16.  Each warpgroup issues wgmma m64n128k16 from
//     shared memory with float32 accumulators, and dequantizes the next step
//     while the tensor cores run.  int4's scale multiplies after the sum
//     (__fmul_rn), then one rounding to bf16.  No split-K: reruns are
//     bitwise equal.
//   gemm_kernel (M > 8, float32 x): a 64 x 128 output tile per CTA, K in
//     steps of 32; the x tile and the unpacked weight tile are staged in
//     shared memory as float32 and each of 256 threads accumulates a 4 x 8
//     block with FMAs (no float32 4-bit matmul is on any path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

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

// ------------------------------------------------------- float32 GEMM
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int TM = 4, TN = 8;  // per thread: rows 4ty.., columns 4tx.. and 64 + 4tx..
constexpr int GT = 256;
constexpr int AS_LD = BM + 4;  // keeps float4 rows aligned, spreads the transposed stores

template <int FMT>
__global__ void __launch_bounds__(GT)
gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
            const float* __restrict__ scale, const float* __restrict__ code_g,
            float* __restrict__ out, int M, int IN, int OUT) {
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
      As[kk][r] = (m < M && k < IN) ? x[(size_t)m * IN + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < (BK / 2) * BN / GT; ++j) {
      const int idx = threadIdx.x + GT * j, pr = idx / BN, c = idx % BN;
      const int r = k0 / 2 + pr, col = n0 + c;
      float w0 = 0.f, w1 = 0.f;
      if (r < rows && col < OUT) {
        const float s = FMT == FMT_NF4 ? __ldg(scale + (size_t)(r / 32) * OUT + col) : 0.f;
        unpack<FMT, float>(__ldg(packed + (size_t)r * OUT + col), s, code, w0, w1);
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
      out[(size_t)m * OUT + col] = v;
    }
  }
}

// ------------------------------------------------------- bf16 GEMM (wgmma)
constexpr int WM = 128, WN = 128, WK = 64;  // CTA tile and K step
constexpr int W_THREADS = 256;              // two warpgroups, 64 rows each
constexpr uint32_t W_TILE = 128 * 128;      // bytes of one 128 x 64 bf16 SW128 tile
constexpr size_t W_SMEM = 4 * W_TILE + 1024;  // 2 x (x tile, B tile), alignment slack

template <int FMT>
__global__ void __launch_bounds__(W_THREADS, 2)  // two CTAs an SM: one dequantizes, one multiplies
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, const float* __restrict__ code_g,
                 __nv_bfloat16* __restrict__ out, int M, int IN, int OUT, int xvec, int wvec) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float code[16];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  // x tile buffers 0 and 1, then B tile buffers 0 and 1
  auto at = [&](int i) { return base + W_TILE * (i & 1); };
  auto bt = [&](int i) { return base + W_TILE * (2 + (i & 1)); };
  const int tid = threadIdx.x;
  if (tid < 16) code[tid] = FMT == FMT_NF4 ? code_g[tid] : 0.f;
  const int m0 = blockIdx.y * WM, n0 = blockIdx.x * WN;
  const int rows = IN / 2, steps = (IN + WK - 1) / WK;
  // dequantizing role: packed rows 4rg..4rg+3 of a step (its input rows
  // 8rg..8rg+7, chunk rg of a B-tile row), columns 4cg..4cg+3 of the tile
  const int rg = tid & 7, cg = tid >> 3, col0 = n0 + 4 * cg;
  uint32_t word[4];
  float bs[4];

  // x rows [m0, m0 + 128), inputs [64 step, + 64) -> SW128 tile (zeros past M, IN)
  auto load_x = [&](int step, uint32_t tile) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + W_THREADS * i, r = idx >> 3, c = idx & 7;
      const int m = m0 + r, kx = step * WK + 8 * c;
      const uint32_t dst = tile + sm90::sw128(r, c);
      if (xvec) {
        const bool live = m < M && kx < IN;
        sm90::cp_async16(dst, live ? x + (size_t)m * IN + kx : x, live ? 16 : 0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kx + 2 * e;
          const float a = m < M && k < IN ? __bfloat162float(x[(size_t)m * IN + k]) : 0.f;
          const float b = m < M && k + 1 < IN ? __bfloat162float(x[(size_t)m * IN + k + 1]) : 0.f;
          w[e] = sm90::pack_bf16(a, b);
        }
        sm90::st_shared16(dst, w[0], w[1], w[2], w[3]);
      }
    }
  };
  // this thread's packed words of a step (and its NF4 block-scale row)
  auto load_w = [&](int step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pr = step * (WK / 2) + 4 * rg + i;
      uint32_t w = 0;
      if (pr < rows) {
        const uint8_t* p = packed + (size_t)pr * OUT + col0;
        if (wvec) {
          if (col0 < OUT) w = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col0 + e < OUT) w |= (uint32_t)__ldg(p + e) << (8 * e);
        }
      }
      word[i] = w;
    }
    if (FMT == FMT_NF4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bs[j] = col0 + j < OUT ? __ldg(scale + (size_t)step * OUT + col0 + j) : 0.f;
    }
  };
  // the words -> bf16 weights of 4 B-tile rows (columns), one 16-byte chunk each
  auto dequant = [&](uint32_t tile) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b = (word[i] >> (8 * j)) & 0xFF;
        if (FMT == FMT_INT4) {
          v[i] = sm90::pack_bf16((float)((int)(b & 0xF) - 8), (float)((int)(signed char)b >> 4));
        } else {
          v[i] = sm90::pack_bf16(__fmul_rn(code[b & 0xF], bs[j]), __fmul_rn(code[b >> 4], bs[j]));
        }
      }
      sm90::st_shared16(tile + sm90::sw128(4 * cg + j, rg), v[0], v[1], v[2], v[3]);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t a_off = (tid >> 7) * 64 * 128;  // this warpgroup's 64 rows of the x tile
  load_x(0, at(0));
  sm90::cp_async_commit();
  load_w(0);
  __syncthreads();  // the codebook
  dequant(bt(0));
  if (steps > 1) {
    load_x(1, at(1));
    sm90::cp_async_commit();
    load_w(1);
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) sm90::cp_async_wait<1>();
    else sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();  // x tile s landed, B tile s written
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      sm90::wgmma_m64n128_ss(acc, sm90::desc_sw128(at(buf) + a_off + 32 * kk),
                             sm90::desc_sw128(bt(buf) + 32 * kk), 1);
    sm90::wgmma_commit();
    if (s + 1 < steps) {  // while the tensor cores run: B tile s + 1, words of s + 2
      dequant(bt(buf ^ 1));
      if (s + 2 < steps) load_w(s + 2);
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    __syncthreads();  // both warpgroups are done with x and B buffers buf
    if (s + 2 < steps) {
      load_x(s + 2, at(buf));
      sm90::cp_async_commit();
    }
  }

  const int lane = tid & 31;
  const int row0 = m0 + 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = row0 + 8 * ((i / 2) & 1), col = n0 + 8 * (i / 4) + 2 * (lane & 3);
    if (row >= M) continue;
    float v0 = acc[i], v1 = acc[i + 1];
    if (FMT == FMT_INT4) {
      v0 = col < OUT ? __fmul_rn(v0, scale[col]) : 0.f;
      v1 = col + 1 < OUT ? __fmul_rn(v1, scale[col + 1]) : 0.f;
    }
    __nv_bfloat16* o = out + (size_t)row * OUT + col;
    if (OUT % 2 == 0) {
      if (col < OUT) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (col < OUT) o[0] = __float2bfloat16(v0);
      if (col + 1 < OUT) o[1] = __float2bfloat16(v1);
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
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((OUT + WN - 1) / WN, (M + WM - 1) / WM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int xvec = IN % 8 == 0 && ((uintptr_t)x & 15) == 0;
    const int wvec = OUT % 4 == 0 && ((uintptr_t)packed & 3) == 0;
    gemm_bf16_kernel<FMT><<<grid, W_THREADS, W_SMEM, st>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)packed, (const float*)scale,
        (const float*)code, (__nv_bfloat16*)out, M, IN, OUT, xvec, wvec);
  } else {
    const dim3 grid((OUT + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    gemm_kernel<FMT><<<grid, GT, 0, st>>>((const float*)x, (const uint8_t*)packed,
                                          (const float*)scale, (const float*)code, (float*)out,
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
