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
// What bounds it: the two products are 4 * BH * L^2 * d operations against
// 16 * BH * L * d bytes of float32 inputs and output, so arithmetic bounds it
// at every path shape, never the memory.  On an H100 (495 TFLOP/s TF32,
// 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s):
//   shape (B x H x L x d)          GFLOP   3 x TF32   CUDA cores   bytes
//   AlphaCLIP-L chunk 16x16x577x64  21.8   0.132 ms   0.326 ms     0.011 ms
//   DINOv2-L @518 1x16x1374x64       7.7   0.047      0.115        0.002
//   CLIP-B/16 @528 1x12x1090x64      3.7   0.022      0.054        0.001
//   five supports 5x16x1374x64      38.7   0.234      0.577        0.009
// In bfloat16 the tensor cores' rate bounds it (DINOv2-L, CLIP-B) or the
// bytes (an AlphaCLIP chunk, 0.023 ms).
//
// Design.  One launch over the (B.H) batch, grid (query tiles, BH); each CTA
// sweeps the keys once in tiles with a float32 online softmax (running max
// and sum per row, output rescaled) on the tensor cores (wgmma,
// csrc/sm90.cuh); the row's 4 threads share the running max (two shuffles)
// and P is P.V's A fragment straight from the accumulator registers.  Keys
// past L are masked, query rows past L are computed on zeros and not stored.
//   float32 (notap_f32): tf32::unbiased_sweep (attention_tf32.cuh, shared
//   with csrc/attention_tap.cu's tap_out_f32), the unbiased sibling of
//   grid_f32's sweep, on the split-TF32 tiles there: each product is three
//   TF32 passes (a_lo b_hi, a_hi b_lo, a_hi b_hi: products
//   to ~2^-20, where one TF32 pass, ~2^-11, would break the 2e-5 float32
//   limit).  What bounds it is the CUDA cores' share beside the tensor
//   cores: splitting K, V^T and P and the softmax take about as many
//   instructions a tile as the passes take cycles.  So a CTA is two
//   warpgroups over 128 query rows sharing each split tile, and the splits
//   run while the tensor cores work (V's while Q K^T runs, the next K
//   tile's while P.V does).  Q hi and lo, one raw K and V tile and one split
//   tile of each take ~161 KB at d = 64: one CTA an SM, 1280 CTAs for an
//   AlphaCLIP chunk and 880 for five supports (several waves on 132 SMs),
//   176 for DINOv2-L at B = 1 (1.33 waves: the second a third full) and 108
//   for CLIP-B (one wave, 24 SMs idle).  The tensor cores' float32 adds
//   truncate, so a tile's P.V is summed from zero in its own accumulator and
//   added to the output sum with an IEEE fma (one accumulator over a
//   4096-key sweep reads 3.7e-5 off the plain version, past the limit:
//   tools/grid_f32_probe.py, one_acc).  Head dims pad to 32, 64, 80 or 128;
//   K tiles are 64 keys, 32 at 128.  The mask costs only the last tile.
//   bfloat16 (notap_bf16): one warpgroup, 64 query rows a CTA (352 CTAs for
//   DINOv2-L at B = 1, 216 for CLIP-B, 2560 for an AlphaCLIP chunk), key
//   tiles of 64 (csrc/attention_sm90.cuh).  Q stays in shared memory; K and
//   V tiles arrive through cp.async, double buffered.  Q K^T is wgmma from
//   shared memory; P = exp(s - running max) is rounded to bf16 in the
//   accumulator registers, which are the A fragment of P.V, so P never
//   touches shared memory; V is read as an MN-major operand (no transpose).
//   The output accumulator is rescaled by exp(m_old - m_new) after the
//   previous P.V has completed.  Head dims past 64 take a second panel
//   (the tile note of attention_sm90.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "attention_tf32.cuh"

namespace {

constexpr int BQ = 64;     // bfloat16: query rows per CTA
constexpr int BK = 64;     // bfloat16: keys per tile
constexpr int DMAX = 128;  // head-dim capacity
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_GRID_Y = 65535;

// ------------------------------------------------------------ float32
template <int DP>
__global__ void __launch_bounds__(tf32::THREADS)
notap_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ out, int L, int d, float scale, int vec) {
  static_assert(tf32::tile_smem<DP>() <= MAX_SMEM, "the tiles fit in shared memory");
  extern __shared__ uint8_t smem_raw[];
  tf32::unbiased_sweep<DP>(q, k, v, out, nullptr, L, d, scale, vec, blockIdx.x * tf32::ROWS,
                           blockIdx.y, smem_raw);
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

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int L, int d,
               float scale, cudaStream_t st) {
  constexpr size_t smem = tf32::tile_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(notap_f32<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  notap_f32<DP><<<dim3((L + tf32::ROWS - 1) / tf32::ROWS, BH), tf32::THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, L, d, scale, vec);
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
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tf32::f32_dp(d)) {
    case 32: return launch_f32<32>(q, k, v, out, BH, L, d, scale, st);
    case 64: return launch_f32<64>(q, k, v, out, BH, L, d, scale, st);
    case 80: return launch_f32<80>(q, k, v, out, BH, L, d, scale, st);
    default: return launch_f32<128>(q, k, v, out, BH, L, d, scale, st);
  }
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
