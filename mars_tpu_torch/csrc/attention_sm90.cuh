// bfloat16 attention tiles on wgmma for head dims up to 128, shared by the
// tensor-core kernels of csrc/attention_tap.cu, csrc/attention_notap.cu and
// csrc/sam_windowed_attention.cu (one warpgroup a CTA, 64 query rows).
//
// A tile holds 64 rows of one head's (L, d) matrix in two panels, in the
// layouts of sm90.cuh: panel 0 holds dims 0..63 as an SW128 tile (8192
// bytes); panel 1 holds the dims past 64, R wide:
//   R = 0    d <= 64          no panel 1
//   R = 16   64 < d <= 80     an interleaved tile of 2 chunks a row (2048 bytes)
//   R = 64   80 < d <= 128    a second SW128 tile
// Columns past d are zero: they add exact zeros to Q K^T and give output
// columns that are not stored.  Q K^T takes 4 + R / 16 K steps of 16 (4, 5 or
// 8); P.V keeps an m64n64 accumulator over panel 0 and an m64nR one over
// panel 1.  At SAM's head dim 80 that is 5 K steps and n64 + n16 where two
// SW128 panels would take 8 and n64 + n64.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace attn {

constexpr int THREADS = 128;  // one warpgroup
constexpr int ROWS = 64;      // rows of a tile: query rows or keys

// The width of panel 1 for head dim d.
__host__ __device__ constexpr int panel1(int d) { return d <= 64 ? 0 : d <= 80 ? 16 : 64; }

template <int R> struct Tile {
  static_assert(R == 0 || R == 16 || R == 64, "panel 1 is 0, 16 or 64 dims wide");
  static constexpr int CHUNKS = 8 + R / 8;             // 16-byte chunks a row
  static constexpr uint32_t BYTES = 8192u + 128u * R;  // both panels, a multiple of 1024
  static constexpr int O1 = R == 0 ? 1 : R / 2;        // registers of panel 1's accumulator
};

// Byte offset of chunk c (8 bf16) of row r in a tile.
template <int R> __device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  if (R == 0 || c < 8) return sm90::sw128(r, c);
  if (R == 64) return 8192u + sm90::sw128(r, c - 8);
  return 8192u + sm90::interleaved(r, c - 8, 2);
}

// Rows [row0, row0 + 64) of an (L, d) bf16 matrix into a tile at shared
// address ``tile``; rows >= L and columns >= d are zero.  ``vec``: cp.async in
// 16-byte chunks (d % 8 == 0, 16-byte aligned rows), else element by element.
template <int R>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, int row0,
                                          int L, int d, bool vec) {
  constexpr int C = Tile<R>::CHUNKS;
  for (int idx = threadIdx.x; idx < ROWS * C; idx += THREADS) {
    const int r = idx / C, c = idx % C, row = row0 + r;
    const uint32_t dst = tile + chunk_offset<R>(r, c);
    if (vec) {
      const bool live = row < L && 8 * c < d;
      sm90::cp_async16(dst, live ? src + (size_t)row * d + 8 * c : src, live ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = 8 * c + 2 * e;
        const float a = row < L && c0 < d ? __bfloat162float(src[(size_t)row * d + c0]) : 0.f;
        const float b =
            row < L && c0 + 1 < d ? __bfloat162float(src[(size_t)row * d + c0 + 1]) : 0.f;
        w[e] = sm90::pack_bf16(a, b);  // exact: a and b are bf16 values
      }
      sm90::st_shared16(dst, w[0], w[1], w[2], w[3]);
    }
  }
}

// Issues s = Q K^T for one 64 x 64 tile pair, unscaled, in the accumulator
// layout of sm90.cuh; the caller fences, commits and waits.
template <int R>
__device__ __forceinline__ void qk_issue(uint32_t qs, uint32_t ks, float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_m64n64_ss(s, sm90::desc_sw128(qs + 32 * kk), sm90::desc_sw128(ks + 32 * kk),
                          kk > 0);
  if constexpr (R == 64) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64_ss(s, sm90::desc_sw128(qs + 8192 + 32 * kk),
                            sm90::desc_sw128(ks + 8192 + 32 * kk), 1);
  } else if constexpr (R == 16) {
    // K-major: chunk stride 128 leading, 8-row group stride 256
    sm90::wgmma_m64n64_ss(s, sm90::desc_interleaved(qs + 8192, 128, 256),
                          sm90::desc_interleaved(ks + 8192, 128, 256), 1);
  }
}

// s = Q K^T for one 64 x 64 tile pair, unscaled.  Waits for the product.
template <int R>
__device__ __forceinline__ void qk(uint32_t qs, uint32_t ks, float (&s)[32]) {
  sm90::wgmma_fence();
  qk_issue<R>(qs, ks, s);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(s);
}

// Issues o0 += P V over panel 0 and o1 += P V over panel 1, P the bf16 A
// fragment (4 registers a K step of 16 keys: the pairs of the Q K^T
// accumulator, packed), V's tile read MN-major; the caller fences, commits
// and waits.
template <int R>
__device__ __forceinline__ void pv_issue(float (&o0)[32], float (&o1)[Tile<R>::O1],
                                         const uint32_t (&p)[16], uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    sm90::wgmma_m64n64_rs_mn(o0, a, sm90::desc_sw128(vs + 2048 * kk), 1);
    if constexpr (R == 64) {
      sm90::wgmma_m64n64_rs_mn(o1, a, sm90::desc_sw128(vs + 8192 + 2048 * kk), 1);
    } else if constexpr (R == 16) {
      // MN-major: 8-row (key) group stride 256 leading, chunk stride 128
      sm90::wgmma_m64n16_rs_mn(o1, a, sm90::desc_interleaved(vs + 8192 + 512 * kk, 256, 128),
                               1);
    }
  }
}

// o0 += P V and o1 += P V for one key tile.  Waits for the products.
template <int R>
__device__ __forceinline__ void pv(float (&o0)[32], float (&o1)[Tile<R>::O1],
                                   const uint32_t (&p)[16], uint32_t vs) {
  sm90::wgmma_fence();
  pv_issue<R>(o0, o1, p, vs);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(o0);
  sm90::fence_regs(o1);
}

// The 2 x 2 bf16 values a thread holds of P (register pair n), as floats.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Rows row0 and row0 + 8 of an m64nN accumulator (N = 2 NR) into ``out``
// (an (L, d) bf16 matrix), its column 0 at dim ``dim0``, each row times
// inv[half]; rows >= L and dims >= d are not stored.  ``pairs``: d is even,
// so neighbouring dims go as one 4-byte store.
template <int NR>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&o)[NR], int dim0,
                                           int row0, int c2, int L, int d, const float (&inv)[2],
                                           bool pairs) {
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const int half = (i / 2) & 1, row = row0 + 8 * half, dim = dim0 + 8 * (i / 4) + c2;
    if (row >= L || dim >= d) continue;
    __nv_bfloat16* dst = out + (size_t)row * d + dim;
    const float a = o[i] * inv[half], b = o[i + 1] * inv[half];
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
    } else {
      dst[0] = __float2bfloat16(a);
      if (dim + 1 < d) dst[1] = __float2bfloat16(b);
    }
  }
}

}  // namespace attn
