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
// What bounds it.  At decode (M = 1-8 rows) the packed bytes: at M = 4 a
// LLaMA-7B projection moves codes + scales + x + out of
//   4096 -> 4096:  8.47 MB int4, 9.51 MB NF4: 2.53 / 2.84 us at 3.35 TB/s
//   4096 -> 11008: 22.7 MB int4, 25.5 MB NF4: 6.78 / 7.62 us
//   11008 -> 4096: 22.7 MB int4, 25.5 MB NF4: 6.78 / 7.62 us
// against 2 M IN OUT = 0.36 GFLOP at most, so memory bounds it; in a decode
// step the codes come cold from device memory (32 layers x ~101 MB).  At
// prefill (M ~ 2330) the same kernel is 210 GFLOP against ~45 MB of inputs
// and outputs: the operations bound it.
//
// A speculative verify forward (M = B x 9 = 9-72 rows at 8 draft tokens)
// sits between: at M = 72 a 11008 -> 4096 projection is 6.5 GFLOP (6.6 us at
// 989 TFLOP/s) against 22.7 MB (6.8 us), at M = 9 bytes bound it 8 to 1.
//
// Design.  Five kernels behind one entry point, picked by M, x's type and
// the row groups G the wrapper passes (G > 0: the skinny GEMM).
//   gemv_bf16 (M <= 8, bfloat16 x): the decode GEMV.
//     Split-K over the whole card: a CTA owns 128 output columns (each
//     packed row it reads is one 128-byte line) and one K slice of whole
//     64-input-row blocks (one NF4 scale row, 32 packed rows); the wrapper
//     picks the slice count S (gemv_split) so that column tiles x S give at
//     least 2 CTAs an SM on 132 SMs.  Without it the 4096-column
//     projections ran 128 CTAs of one K sweep each.
//     Weight stream: a ring of 8 stages, one block each, filled by cp.async
//     (16 bytes a thread: the block's 4 KB of codes, its 1 KB of x rows and,
//     for NF4, its 128 scales), so a CTA keeps up to 28 KB of codes in
//     flight.  A code row's 16-byte chunk c lands at chunk c ^ (row % 8),
//     x row m's chunk c at c ^ 2 (m % 4): the reads below are conflict-free.
//     Math on the tensor cores, A and B swapped: out^T (OUT x M) = W^T x^T
//     with mma.sync m16n8k16 (bf16 in, float32 sums), M padded to the n8 of
//     the instruction; each warp owns 16 columns.  One ldmatrix.x4.trans
//     gives a lane, for each of the block's four k16 steps, packed rows 2t
//     and 2t+1 of columns 2g and 2g+1 (g = lane / 4, t = lane % 4) in one
//     32-bit word.  A row g is taken as column 2g, row g + 8 as column
//     2g + 1; k pair t as the low nibbles of packed rows 2t and 2t+1 (inputs
//     4t, 4t + 2), pair t + 4 as their high nibbles (4t + 1, 4t + 3).  Then
//     each A register is the word shifted by 0, 4, 8 or 12 and masked with
//     0x000F000F, dequantized in place, never through shared memory: int4
//     by one xor under the bf16 exponent and one bf16x2 subtraction
//     (exact); NF4 as __fmul_rn(code[c], scale) rounded to bf16, the plain
//     version's weight.  The B fragment is x inputs 4t..4t+3 of row g, one
//     8-byte shared load, paired (4t, 4t+2), (4t+1, 4t+3) by two byte
//     permutes.
//     Split-K reduction, one launch and deterministic: with S > 1 each CTA
//     writes its float32 partials (M x 128) to the workspace (S, 8, OUT),
//     fences and counts itself in its tile's int32 counter; the last CTA to
//     arrive fences, sums the S partials in slice order 0..S-1, applies
//     int4's scale (__fmul_rn), rounds once to bf16 and resets the counter.
//     With S = 1 the CTA stores directly.  Products of bf16 are exact in
//     float32, so it differs from the plain version in summation order and
//     the one output rounding only; reruns are bitwise equal.
//   gemm_skinny_bf16 (8 < M <= SKINNY_MAX_ROWS of ops/int4_matmul.py,
//     bfloat16 x): the verify rows.  The 128-row GEMM below ran 32 CTAs on
//     132 SMs at OUT = 4096, each sweeping all of K with 56-119 of its 128
//     rows zero, ~25x its bound.  This one is the GEMV widened to N = 16-72
//     x rows on wgmma: A and B swapped, out^T (128 columns x N) = W^T x^T,
//     each warp's 16 columns the A rows of its slice of the warpgroup's
//     m64nNk16 (two warpgroups a CTA), N = the group's rows rounded up to 8.
//     Split-K as the GEMV's: a CTA owns 128 columns and one K slice of whole
//     64-row blocks, S from skinny_split so that tiles x S fill one wave at
//     two CTAs an SM (S = 8 at OUT = 4096, 3 at 11008), the GEMV's workspace
//     and counters, the S partials summed in slice order 0..S-1 by the last
//     CTA of a tile, int4's scale after it, one rounding; reruns are bitwise
//     equal.  That last CTA's sum is a latency chain (S x M x 128 floats
//     from L2 by one SM): it loads SK_FIXUP_BATCH float4 outputs' slices at
//     once (tools/skinny_probe.py: one at a time cost ~9 us of a 22 us call
//     at M = 72; a cluster of the S slices reducing over distributed shared
//     memory was slower, the clusters' co-scheduling costing more than the
//     sum).  The weights never pass through shared memory as bf16: a ring
//     of up to 8 stages (cp.async; the x tile in wgmma's 128-byte swizzle,
//     the codes as the GEMV's) and one ldmatrix.x4.trans a block whose
//     lanes address the packed rows in the order 0, 4, 1, 5, 2, 6, 3, 7 of
//     each k16 step, so a lane's word holds rows t and t + 4 of columns 2g
//     and 2g + 1: each byte's two nibbles are one register of wgmma's A
//     fragment (the per-warp layout of mma.sync m16n8k16's A) in natural K
//     order, dequantized in registers as the GEMV does (int4 exact; NF4 as
//     the plain version rounds it); B, the x tile, is K-major in shared
//     memory (x is (M, IN) row-major: no transpose).  Past 72 rows (up to
//     SKINNY_MAX_ROWS = 96, where the prefill GEMM takes over) the wrapper
//     passes G row groups of <= 72 (grid tiles x G, S; a tile's G CTAs
//     adjacent, so its codes come from L2 after the first read).
//   gemv_kernel (M <= 8, float32 x, not on any path): a CTA owns 32 output
//     columns; its 8 column threads each read one 32-bit word (4 columns) of
//     a packed row, 32 groups of them split the packed rows; 8 x 4 float32
//     sums a thread, added in a fixed order through shared memory.
//   gemm_prefill_bf16 (M > SKINNY_MAX_ROWS, bfloat16 x; csrc/int4_prefill.cu,
//     one translation unit a format): prefill and the 128- and 512-row
//     suffix forwards.  The skinny GEMM's operands on a
//     large tile: out^T (128 columns x N x rows) = W^T x^T, N = 128, 192 or
//     256, each consumer warpgroup 64 columns by wgmma m64nNk16 with the
//     weights dequantized into its register A operand (the skinny GEMM's
//     ldmatrix.trans fragments, one ldmatrix.x4 a warp and 64-row block) and
//     the x tile its shared-memory B operand, so each weight is dequantized
//     once per N x rows and never stored as bf16 (a bf16 tile in shared
//     memory, rebuilt for every 128 rows between two __syncthreads a step,
//     ran 2.4-2.6x cuBLAS).
//     Warp specialised: warpgroup 2 produces a ring of up to 8 stages (x
//     tile, codes, NF4's scale row) on full/empty mbarriers and keeps 40
//     registers (setmaxnreg); warpgroups 0 and 1 take 232, hold one block's
//     products in flight (wgmma_wait<1>) while they dequantize the next, and
//     free a stage to the producer when its products are done; no
//     __syncthreads in the mainloop.  Where x's and the codes' rows are
//     whole 16-byte chunks from 16-byte-aligned pointers (a tensor map's
//     strides) the copies are TMA, one producer thread, tensor maps built on
//     the host through cudaGetDriverEntryPoint (no libcuda is linked), and
//     CTAs run in clusters of two on adjacent column tiles that
//     each load half of the x tile and multicast it to both: x, most of a
//     stage's bytes, comes from L2 once per 256 columns.  Without the
//     multicast the ring's copies alone took as long as the whole kernel
//     (tools/prefill_probe.py: the L2 -> SM traffic bound it).  Elsewhere
//     (ragged IN or OUT, offset views) the producer's 128 threads copy by
//     cp.async with zero fill or by element loads, the next stage's element
//     loads issued before this stage's stores (120 registers: two stages'
//     loads in flight; one at a time, their round trips took over half of
//     the ragged shapes' time), mark a stage full once its copies land
//     (PF_LAG stages later), and tiles stop at 192 rows.
//     Persistent: one CTA an SM walks the tiles round-robin, column tile
//     outer, row tile inner; N from prefill_rows, a wave reckoning with a
//     per-format cost a tile (NF4's codebook dequantization favours wide
//     tiles; a 512-row call at OUT = 4096 takes 128 tiles of 128 rows, not
//     64 of 256).  int4's scale multiplies after the float32 sum
//     (__fmul_rn), one rounding to bf16; no split-K, so N changes no bit and
//     reruns are bitwise equal.
//   gemm_kernel (M > 8, float32 x): a 64 x 128 output tile per CTA, K in
//     steps of 32; the x tile and the unpacked weight tile are staged in
//     shared memory as float32 and each of 256 threads accumulates a 4 x 8
//     block with FMAs (no float32 4-bit matmul is on any path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int4_dequant.cuh"
#include "sm90.cuh"

// csrc/int4_prefill.cu, once a format
int prefill_plan_int4(const void* x, const void* packed, const void* scale, int M, int IN,
                      int OUT);
int prefill_plan_nf4(const void* x, const void* packed, const void* scale, int M, int IN,
                     int OUT);
cudaError_t launch_prefill_int4(const void* x, const void* packed, const void* scale,
                                const void* code, void* out, int M, int IN, int OUT,
                                cudaStream_t st);
cudaError_t launch_prefill_nf4(const void* x, const void* packed, const void* scale,
                               const void* code, void* out, int M, int IN, int OUT,
                               cudaStream_t st);

namespace {


__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ------------------------------------------------------- bf16 GEMV (mma.sync)
constexpr int GB_THREADS = 256;                     // 8 warps x 16 columns
constexpr int GB_STAGES = 8;
constexpr int GB_MAX_SPLIT = 16;
constexpr int GB_X_BYTES = GV_MAX_M * 64 * 2;       // x rows 0..7 of the block's 64 inputs
constexpr int GB_STAGE_BYTES = GB_CODE_BYTES + GB_X_BYTES + GB_COLS * 4;  // + NF4 scale row

// d += a b, m16n8k16, bf16 in, float32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int4: the nibbles at bits 0-3 and 16-19 of v, as the bf16x2 of their weights.
// Each nibble goes under the exponent of 128 (bf16 0x4300 | n = 128 + n), a
// high (odd-row) nibble with its sign bit flipped, and 136 comes off both
// halves: low - 8 and (high ^ 8) - 8 = the signed high nibble, exact.
template <bool HIGH>
__device__ __forceinline__ uint32_t int4_pair(uint32_t v) {
  const uint32_t w = (v & 0x000F000Fu) ^ (HIGH ? 0x43084308u : 0x43004300u);
  const uint32_t bias = 0x43084308u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The A fragment of one k16 step from the lane's ldmatrix word a: bytes
// [2t][2g], [2t][2g+1], [2t+1][2g], [2t+1][2g+1] of the step's 8 packed rows.
// Register e pairs packed rows 2t and 2t+1 of one column, low nibbles (k
// pair t: inputs 4t and 4t + 2) or high ones (pair t + 4: inputs 4t + 1 and
// 4t + 3), so a shift and a mask put both nibbles in place.  s0, s1: NF4's
// scales of columns 2g and 2g + 1.
template <int FMT>
__device__ __forceinline__ void dequant_step(uint32_t a, float s0, float s1, const float* code,
                                             uint32_t (&frag)[4]) {
  if (FMT == FMT_INT4) {
    frag[0] = int4_pair<false>(a);
    frag[1] = int4_pair<false>(a >> 8);
    frag[2] = int4_pair<true>(a >> 4);
    frag[3] = int4_pair<true>(a >> 12);
  } else {
    frag[0] = nf4_pair(a, s0, code);
    frag[1] = nf4_pair(a >> 8, s1, code);
    frag[2] = nf4_pair(a >> 4, s0, code);
    frag[3] = nf4_pair(a >> 12, s1, code);
  }
}

template <int FMT>
__global__ void __launch_bounds__(GB_THREADS, 3)
gemv_bf16(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
          const float* __restrict__ scale, const float* __restrict__ code_g,
          __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
          int M, int IN, int OUT, int S, int xvec, int wvec) {
  __shared__ __align__(128) uint8_t ring[GB_STAGES][GB_STAGE_BYTES];
  __shared__ float code[16];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, slice = blockIdx.y, col0 = tile * GB_COLS;
  const int rows = IN / 2, blocks = (IN + 63) / 64;
  // this slice's blocks: [blocks s / S, blocks (s + 1) / S), sizes differ by one at most
  const int kb0 = slice * blocks / S, nb = (slice + 1) * blocks / S - kb0;
  if (tid < 16) code[tid] = FMT == FMT_NF4 ? code_g[tid] : 0.f;

  // block kb -> stage buffer: codes (32 rows x 128 bytes), x rows m < M of its
  // 64 inputs, NF4's scale row; zeros past IN, OUT (int4's zero byte is -8 in
  // the low nibble, so a ragged tail is harmless only because x is zero there)
  auto load = [&](int kb, int buf) {
    const uint32_t base = sm90::smem_addr(ring[buf]);
    {
      const int r = tid >> 3, c = tid & 7, pr = kb * GB_ROWS + r, col = col0 + 16 * c;
      const uint32_t dst = base + r * GB_COLS + ((c ^ (r & 7)) << 4);
      if (wvec) {
        const bool live = pr < rows && col < OUT;
        sm90::cp_async16(dst, live ? packed + (size_t)pr * OUT + col : packed, live ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (pr < rows) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (col + e < OUT) w[e / 4] |= (uint32_t)packed[(size_t)pr * OUT + col + e] << (8 * (e % 4));
        }
        sm90::st_shared16(dst, w[0], w[1], w[2], w[3]);
      }
    }
    if (tid < 8 * M) {
      const int m = tid >> 3, c = tid & 7, k = kb * 64 + 8 * c;
      const uint32_t dst = base + GB_CODE_BYTES + m * 128 + ((c ^ ((m & 3) << 1)) << 4);
      const __nv_bfloat16* src = x + (size_t)m * IN + k;
      if (xvec) {
        sm90::cp_async16(dst, k < IN ? src : x, k < IN ? 16 : 0);
      } else {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = (k + 2 * e < IN ? h[2 * e] : 0u) | (k + 2 * e + 1 < IN ? (uint32_t)h[2 * e + 1] << 16 : 0u);
        sm90::st_shared16(dst, w[0], w[1], w[2], w[3]);
      }
    }
    if (FMT == FMT_NF4 && tid < 32) {
      const int col = col0 + 4 * tid;
      const uint32_t dst = base + GB_CODE_BYTES + GB_X_BYTES + 16 * tid;
      const float* src = scale + (size_t)kb * OUT + col;
      if (wvec) {
        sm90::cp_async16(dst, col < OUT ? src : scale, col < OUT ? 16 : 0);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = col + e < OUT ? src[e] : 0.f;
        sm90::st_shared16(dst, __float_as_uint(v[0]), __float_as_uint(v[1]),
                          __float_as_uint(v[2]), __float_as_uint(v[3]));
      }
    }
  };

  // ldmatrix: lane L gives the address of packed row L of the stage at the
  // warp's chunk, so matrix j (lanes 8j..8j+7) is k16 step j
  const uint32_t a_off = lane * GB_COLS + ((warp ^ (lane & 7)) << 4);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < GB_STAGES - 1; ++i) {
    if (i < nb) load(kb0 + i, i);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < nb; ++i) {
    sm90::cp_async_wait<GB_STAGES - 2>();
    __syncthreads();  // block i landed everywhere; every warp is done with block i - 1's buffer
    if (i + GB_STAGES - 1 < nb) load(kb0 + i + GB_STAGES - 1, (i + GB_STAGES - 1) % GB_STAGES);
    sm90::cp_async_commit();
    const uint8_t* st = ring[i % GB_STAGES];
    uint32_t a[4];
    ldmatrix_x4_trans(a, sm90::smem_addr(st) + a_off);
    float2 s = make_float2(0.f, 0.f);
    if (FMT == FMT_NF4)
      s = *reinterpret_cast<const float2*>(st + GB_CODE_BYTES + GB_X_BYTES + 4 * (16 * warp + 2 * g));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // x row g, inputs 4t..4t+3 of step j; the B pairs are (4t, 4t+2), (4t+1, 4t+3)
      uint2 b = make_uint2(0u, 0u);
      if (g < M)
        b = *reinterpret_cast<const uint2*>(st + GB_CODE_BYTES + g * 128 +
                                            (((2 * j + (t >> 1)) ^ ((g & 3) << 1)) << 4) + 8 * (t & 1));
      uint32_t frag[4];
      dequant_step<FMT>(a[j], s.x, s.y, code, frag);
      mma_16816(acc, frag, __byte_perm(b.x, b.y, 0x5410), __byte_perm(b.x, b.y, 0x7632));
    }
  }

  // acc[h], acc[2 + h]: row m = 2t + h, columns 2g and 2g + 1 of the warp's 16
  const int col = col0 + 16 * warp + 2 * g;
  if (S == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 2 * t + h;
      if (m >= M) continue;
      float v0 = acc[h], v1 = acc[2 + h];
      if (FMT == FMT_INT4) {
        v0 = col < OUT ? __fmul_rn(v0, scale[col]) : 0.f;
        v1 = col + 1 < OUT ? __fmul_rn(v1, scale[col + 1]) : 0.f;
      }
      __nv_bfloat16* o = out + (size_t)m * OUT + col;
      if (OUT % 2 == 0) {
        if (col < OUT) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < OUT) o[0] = __float2bfloat16(v0);
        if (col + 1 < OUT) o[1] = __float2bfloat16(v1);
      }
    }
    return;
  }
  const size_t ld = (size_t)gridDim.x * GB_COLS;  // workspace (S, 8, tiles x 128)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 2 * t + h;
    if (m < M)
      *reinterpret_cast<float2*>(ws + ((size_t)slice * GV_MAX_M + m) * ld + col) =
          make_float2(acc[h], acc[2 + h]);
  }
  __threadfence();  // the partials, before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // the count, before the other slices' partials
  for (int idx = tid; idx < M * GB_COLS; idx += GB_THREADS) {
    const int m = idx / GB_COLS, c = col0 + idx % GB_COLS;
    if (c >= OUT) continue;
    const float* p = ws + (size_t)m * ld + c;
    float part[GB_MAX_SPLIT];  // every slice's load in flight at once
#pragma unroll
    for (int sl = 0; sl < GB_MAX_SPLIT; ++sl)
      part[sl] = sl < S ? __ldcg(p + (size_t)sl * GV_MAX_M * ld) : 0.f;
    float v = part[0];
#pragma unroll
    for (int sl = 1; sl < GB_MAX_SPLIT; ++sl)
      if (sl < S) v += part[sl];
    if (FMT == FMT_INT4) v = __fmul_rn(v, scale[c]);
    out[(size_t)m * OUT + c] = __float2bfloat16(v);
  }
  if (tid == 0) counters[tile] = 0;
}

// ------------------------------------------- bf16 skinny GEMM (wgmma, A in registers)
constexpr int SK_COLS = 128;                        // output columns a CTA: 2 warpgroups x 64
constexpr int SK_THREADS = 256;                     // 8 warps x 16 columns
constexpr int SK_MAX_NT = 9;                        // n8 tiles of a row group: up to 72 x rows
constexpr int SK_MAX_SPLIT = 8;                     // slices the last CTA's batch holds in registers
constexpr int SK_FIXUP_BATCH = 3;                   // its float4 outputs in flight at once
constexpr int SK_SMEM_BUDGET = 110 * 1024;          // a CTA's ring: two CTAs an SM

// One ring stage at NT n8 tiles: the x tile (8 NT rows x 64 bf16, SW128; first,
// so that it starts on a 1024-byte boundary), the block's codes (32 packed
// rows x 128 bytes, chunk c of row r at c ^ (r % 8)), NF4's scale row.
template <int NT> struct Skinny {
  static constexpr int X_BYTES = NT * 1024;
  static constexpr int STAGE = (X_BYTES + GB_CODE_BYTES + SK_COLS * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGES = (SK_SMEM_BUDGET - 1024) / STAGE < 8
                                    ? (SK_SMEM_BUDGET - 1024) / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

// out^T (128 columns x R rows) = W^T x^T for one column tile, one K slice and
// one row group: grid (tiles x G, S), blockIdx.x = tile G + group, so the G
// CTAs that share a tile's codes run side by side and read them from L2.
template <int FMT, int NT>
__global__ void __launch_bounds__(SK_THREADS, 2)
gemm_skinny_bf16(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, const float* __restrict__ code_g,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                 int M, int IN, int OUT, int S, int G, int xvec, int wvec) {
  using K = Skinny<NT>;
  constexpr int N = 8 * NT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float code[16];
  __shared__ int last;
  const uint32_t base = sm90::aligned_base(smem_raw);
  uint8_t* const ring = smem_raw + (base - sm90::smem_addr(smem_raw));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / G, group = blockIdx.x % G, slice = blockIdx.y;
  const int col0 = tile * SK_COLS;
  // this group's x rows [row0, row0 + R), R <= N; R = ceil(M / G) as the wrapper sizes N
  const int R0 = (M + G - 1) / G, row0 = group * R0, R = min(R0, M - row0);
  const int rows = IN / 2, blocks = (IN + 63) / 64;
  const int kb0 = slice * blocks / S, nb = (slice + 1) * blocks / S - kb0;
  if (tid < 16) code[tid] = FMT == FMT_NF4 ? code_g[tid] : 0.f;
  // x rows R..N-1 of every stage stay zero (the loads below write rows < R)
  for (int idx = tid; idx < K::STAGES * (N - R) * 8; idx += SK_THREADS) {
    const int s = idx / ((N - R) * 8), r = R + (idx / 8) % (N - R), c = idx % 8;
    sm90::st_shared16(base + s * K::STAGE + sm90::sw128(r, c), 0u, 0u, 0u, 0u);
  }

  // block kb -> stage buffer: x rows [row0, row0 + R) of its 64 inputs, the
  // codes, NF4's scale row; zeros past IN, OUT (int4's zero byte is -8 in the
  // low nibble: harmless only because x is zero there)
  auto load = [&](int kb, int buf) {
    const uint32_t st = base + buf * K::STAGE;
    for (int idx = tid; idx < 8 * R; idx += SK_THREADS) {
      const int m = idx >> 3, c = idx & 7, k = kb * 64 + 8 * c;
      const uint32_t dst = st + sm90::sw128(m, c);
      const __nv_bfloat16* src = x + (size_t)(row0 + m) * IN + k;
      if (xvec) {
        sm90::cp_async16(dst, k < IN ? src : x, k < IN ? 16 : 0);
      } else {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = (k + 2 * e < IN ? h[2 * e] : 0u) | (k + 2 * e + 1 < IN ? (uint32_t)h[2 * e + 1] << 16 : 0u);
        sm90::st_shared16(dst, w[0], w[1], w[2], w[3]);
      }
    }
    {
      const int r = tid >> 3, c = tid & 7, pr = kb * GB_ROWS + r, col = col0 + 16 * c;
      const uint32_t dst = st + K::X_BYTES + r * SK_COLS + ((c ^ (r & 7)) << 4);
      if (wvec) {
        const bool live = pr < rows && col < OUT;
        sm90::cp_async16(dst, live ? packed + (size_t)pr * OUT + col : packed, live ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (pr < rows) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (col + e < OUT) w[e / 4] |= (uint32_t)packed[(size_t)pr * OUT + col + e] << (8 * (e % 4));
        }
        sm90::st_shared16(dst, w[0], w[1], w[2], w[3]);
      }
    }
    if (FMT == FMT_NF4 && tid < 32) {
      const int col = col0 + 4 * tid;
      const uint32_t dst = st + K::X_BYTES + GB_CODE_BYTES + 16 * tid;
      const float* src = scale + (size_t)kb * OUT + col;
      if (wvec) {
        sm90::cp_async16(dst, col < OUT ? src : scale, col < OUT ? 16 : 0);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = col + e < OUT ? src[e] : 0.f;
        sm90::st_shared16(dst, __float_as_uint(v[0]), __float_as_uint(v[1]),
                          __float_as_uint(v[2]), __float_as_uint(v[3]));
      }
    }
  };

  // ldmatrix: lane 8j + r gives packed row 8j + r / 2 + 4 (r % 2) of the stage
  // at the warp's chunk, so matrix j is k16 step j with its rows in the order
  // 0, 4, 1, 5, 2, 6, 3, 7: a lane's word holds rows t and t + 4
  const int prow = (lane & ~7) + ((lane & 7) >> 1) + 4 * (lane & 1);
  const uint32_t a_off = K::X_BYTES + prow * SK_COLS + ((warp ^ (prow & 7)) << 4);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // blocks 0..STAGES-3 in flight; block i + STAGES - 2 refills block i - 2's buffer
#pragma unroll
  for (int i = 0; i < K::STAGES - 2; ++i) {
    if (i < nb) load(kb0 + i, i);
    sm90::cp_async_commit();
  }
  // Block i: dequantize it into one of two fragment sets while block i - 1's
  // wgmma (the other set) runs; wait for that one only after issuing block i.
  auto step = [&](int i, uint32_t (&frag)[4][4]) {
    sm90::cp_async_wait<K::STAGES - 3>();
    sm90::fence_async_smem();  // this thread's copies and zeros, visible to wgmma
    __syncthreads();  // block i landed everywhere; block i - 2's wgmma done in both warpgroups
    if (i + K::STAGES - 2 < nb)
      load(kb0 + i + K::STAGES - 2, (i + K::STAGES - 2) % K::STAGES);
    sm90::cp_async_commit();
    const int buf = i % K::STAGES;
    const uint32_t st = base + buf * K::STAGE;
    uint32_t a[4];
    ldmatrix_x4_trans(a, st + a_off);
    float2 s = make_float2(0.f, 0.f);
    if (FMT == FMT_NF4)
      s = *reinterpret_cast<const float2*>(ring + buf * K::STAGE + K::X_BYTES + GB_CODE_BYTES +
                                           4 * (16 * warp + 2 * g));
#pragma unroll
    for (int j = 0; j < 4; ++j) dequant_step_k<FMT>(a[j], s.x, s.y, code, frag[j]);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm90::wgmma_bf16_rs<N>(acc, frag[j], sm90::desc_sw128(st + 32 * j), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // block i - 1's group: its fragment set and buffer are free
  };
  uint32_t frag_a[4][4], frag_b[4][4];
  int i = 0;
  for (; i + 1 < nb; i += 2) {
    step(i, frag_a);
    step(i + 1, frag_b);
  }
  if (i < nb) step(i, frag_a);
  sm90::wgmma_wait_all();
  sm90::fence_regs(acc);

  // acc[4q + h], acc[4q + 2 + h]: group row 8q + 2t + h, columns 2g and 2g + 1
  // of the warp's 16
  const int col = col0 + 16 * warp + 2 * g;
  if (S == 1) {
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * q + 2 * t + h;
        if (m >= R) continue;
        float v0 = acc[4 * q + h], v1 = acc[4 * q + 2 + h];
        if (FMT == FMT_INT4) {
          v0 = col < OUT ? __fmul_rn(v0, scale[col]) : 0.f;
          v1 = col + 1 < OUT ? __fmul_rn(v1, scale[col + 1]) : 0.f;
        }
        __nv_bfloat16* o = out + (size_t)(row0 + m) * OUT + col;
        if (OUT % 2 == 0) {
          if (col < OUT) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < OUT) o[0] = __float2bfloat16(v0);
          if (col + 1 < OUT) o[1] = __float2bfloat16(v1);
        }
      }
    return;
  }
  const size_t ld = (size_t)(gridDim.x / G) * SK_COLS;  // workspace (S, M, tiles x 128)
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * q + 2 * t + h;
      if (m < R)
        *reinterpret_cast<float2*>(ws + ((size_t)slice * M + row0 + m) * ld + col) =
            make_float2(acc[4 * q + h], acc[4 * q + 2 + h]);
    }
  __threadfence();  // the partials, before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1) == S * G - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // the count, before the other CTAs' partials
  // Four columns a thread, SK_FIXUP_BATCH of them at once with every slice's
  // float4 of each in flight together: the sum is latency-bound, one round
  // trip to L2 a batch (9 batches of one at M = 72 took ~9 us).
  const size_t sl_step = (size_t)M * ld / 4;  // float4s from one slice's partials to the next
  const int items = M * (SK_COLS / 4);
  for (int first = tid; first < items; first += SK_FIXUP_BATCH * SK_THREADS) {
    float4 pv[SK_FIXUP_BATCH][SK_MAX_SPLIT];
#pragma unroll
    for (int b = 0; b < SK_FIXUP_BATCH; ++b) {
      const int idx = first + b * SK_THREADS, m = idx / (SK_COLS / 4);
      const int c = col0 + 4 * (idx % (SK_COLS / 4));
      const float4* p = reinterpret_cast<const float4*>(ws + (size_t)m * ld + c);
#pragma unroll
      for (int sl = 0; sl < SK_MAX_SPLIT; ++sl)
        pv[b][sl] = idx < items && c < OUT && sl < S ? __ldcg(p + sl * sl_step)
                                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < SK_FIXUP_BATCH; ++b) {
      const int idx = first + b * SK_THREADS, m = idx / (SK_COLS / 4);
      const int c = col0 + 4 * (idx % (SK_COLS / 4));
      if (idx >= items || c >= OUT) continue;
      float v[4] = {pv[b][0].x, pv[b][0].y, pv[b][0].z, pv[b][0].w};
#pragma unroll
      for (int sl = 1; sl < SK_MAX_SPLIT; ++sl)
        if (sl < S)
          v[0] += pv[b][sl].x, v[1] += pv[b][sl].y, v[2] += pv[b][sl].z, v[3] += pv[b][sl].w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e >= OUT) break;
        if (FMT == FMT_INT4) v[e] = __fmul_rn(v[e], scale[c + e]);
        out[(size_t)m * OUT + c + e] = __float2bfloat16(v[e]);
      }
    }
  }
  if (tid == 0) counters[tile] = 0;
}

template <int FMT, int NT>
cudaError_t launch_skinny(const void* x, const void* packed, const void* scale, const void* code,
                          void* out, int M, int IN, int OUT, int S, int G, void* ws,
                          void* counters, int xvec, int wvec, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_skinny_bf16<FMT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Skinny<NT>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((OUT + SK_COLS - 1) / SK_COLS * G, S);
  gemm_skinny_bf16<FMT, NT><<<grid, SK_THREADS, Skinny<NT>::SMEM, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)packed, (const float*)scale, (const float*)code,
      (__nv_bfloat16*)out, (float*)ws, (int*)counters, M, IN, OUT, S, G, xvec, wvec);
  return cudaSuccess;
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

template <int FMT, typename T>
int launch(const void* x, const void* packed, const void* scale, const void* code, void* out,
           int M, int IN, int OUT, int S, int G, void* ws, void* counters, void* stream) {
  if (M < 1 || IN < 2 || IN % 2 || OUT < 1 || (FMT == FMT_NF4 && (IN % 64 || !code)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if (M <= GV_MAX_M) {
    if constexpr (bf16) {
      if (S < 1 || S > (IN + 63) / 64 || S > GB_MAX_SPLIT || (S > 1 && (!ws || !counters)))
        return (int)cudaErrorInvalidValue;
      const int xvec = IN % 8 == 0 && ((uintptr_t)x & 15) == 0;
      const int wvec = OUT % 16 == 0 && ((uintptr_t)packed & 15) == 0 &&
                       (FMT == FMT_INT4 || ((uintptr_t)scale & 15) == 0);
      gemv_bf16<FMT><<<dim3((OUT + GB_COLS - 1) / GB_COLS, S), GB_THREADS, 0, st>>>(
          (const __nv_bfloat16*)x, (const uint8_t*)packed, (const float*)scale,
          (const float*)code, (__nv_bfloat16*)out, (float*)ws, (int*)counters, M, IN, OUT, S,
          xvec, wvec);
    } else {
      gemv_kernel<FMT, float><<<(OUT + GV_BN - 1) / GV_BN, GV_THREADS, 0, st>>>(
          (const float*)x, (const uint8_t*)packed, (const float*)scale, (const float*)code,
          (float*)out, M, IN, OUT);
    }
  } else if (bf16 && G > 0) {
    // the skinny GEMM: G row groups of R = ceil(M / G) <= 72 rows, N = R rounded up to 8
    const int R = (M + G - 1) / G, nt = (R + 7) / 8;
    const long long ctas = (long long)(OUT + SK_COLS - 1) / SK_COLS * G;
    if (G > M || nt > SK_MAX_NT || S < 1 || S > (IN + 63) / 64 || S > SK_MAX_SPLIT ||
        ctas > 0x7FFFFFFF || (S > 1 && (!ws || !counters)))
      return (int)cudaErrorInvalidValue;
    const int xvec = IN % 8 == 0 && ((uintptr_t)x & 15) == 0;
    const int wvec = OUT % 16 == 0 && ((uintptr_t)packed & 15) == 0 &&
                     (FMT == FMT_INT4 || ((uintptr_t)scale & 15) == 0);
    cudaError_t err = cudaErrorInvalidValue;
    switch (nt < 2 ? 2 : nt) {
#define SKINNY_CASE(NT)                                                                     \
  case NT:                                                                                  \
    err = launch_skinny<FMT, NT>(x, packed, scale, code, out, M, IN, OUT, S, G, ws, counters, \
                                 xvec, wvec, st);                                            \
    break;
      SKINNY_CASE(2) SKINNY_CASE(3) SKINNY_CASE(4) SKINNY_CASE(5) SKINNY_CASE(6)
      SKINNY_CASE(7) SKINNY_CASE(8) SKINNY_CASE(9)
#undef SKINNY_CASE
    }
    if (err != cudaSuccess) return (int)err;
  } else if constexpr (bf16) {
    const cudaError_t err =
        FMT == FMT_INT4 ? launch_prefill_int4(x, packed, scale, code, out, M, IN, OUT, st)
                        : launch_prefill_nf4(x, packed, scale, code, out, M, IN, OUT, st);
    if (err != cudaSuccess) return (int)err;
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
// bf16: 0 = float32 x and out, 1 = bfloat16.  Routes: M <= 8 the GEMV (bf16: S K
// slices); bf16 with G > 0 row groups the skinny GEMM (S <= 8 K slices, G
// groups of ceil(M / G) <= 72 rows); else the GEMM (bf16 or float32).  With
// S > 1, ws holds at least S x 8 (GEMV) or S x M (skinny) rows of 128
// ceil(OUT / 128) floats and counters ceil(OUT / 128) int32 zeros (the last
// CTA of a tile resets its own).  Returns a cudaError_t.
extern "C" int mars_matmul_4bit(int fmt, int bf16, const void* x, const void* packed,
                                const void* scale, const void* code, void* out, int M, int IN,
                                int OUT, int S, int G, void* ws, void* counters, void* stream) {
  if (fmt == FMT_INT4)
    return bf16 ? launch<FMT_INT4, __nv_bfloat16>(x, packed, scale, code, out, M, IN, OUT, S, G,
                                                  ws, counters, stream)
                : launch<FMT_INT4, float>(x, packed, scale, code, out, M, IN, OUT, S, G, ws,
                                          counters, stream);
  if (fmt == FMT_NF4)
    return bf16 ? launch<FMT_NF4, __nv_bfloat16>(x, packed, scale, code, out, M, IN, OUT, S, G,
                                                 ws, counters, stream)
                : launch<FMT_NF4, float>(x, packed, scale, code, out, M, IN, OUT, S, G, ws,
                                         counters, stream);
  return (int)cudaErrorInvalidValue;
}

// The prefill GEMM's plan for bfloat16 operands (fmt as above): 2 x its
// tile's x rows, plus 1 for the TMA variant; -1 without a device.
extern "C" int mars_prefill_plan(int fmt, const void* x, const void* packed, const void* scale,
                                 int M, int IN, int OUT) {
  return fmt == FMT_NF4 ? prefill_plan_nf4(x, packed, scale, M, IN, OUT)
                        : prefill_plan_int4(x, packed, scale, M, IN, OUT);
}
