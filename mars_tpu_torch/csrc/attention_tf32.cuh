// float32 attention tiles on the tensor cores by split TF32 (sm90.cuh), shared
// by the float32 kernels of csrc/sam_grid_attention.cu (grid_f32) and
// csrc/attention_notap.cu (notap_f32).
//
// A CTA is two warpgroups over 128 query rows, 64 each, sweeping one head's
// keys in tiles that both share: each operand is hi + lo (two TF32 values)
// and each product three TF32 wgmma passes, a_lo b_hi, a_hi b_lo, a_hi b_hi
// (the small terms first).  TF32 wgmma reads both operands K-major, so P.V
// takes V^T: a raw V tile is split into hi and lo V^T tiles with its keys
// permuted inside each group of 8 (0, 2, 4, 6, 1, 3, 5, 7), so that the
// registers of s are P's A fragment as they stand; K tiles are split likewise
// into hi and lo row-panel tiles.  Head dims pad to 32, 64, 80 or 128; K tiles
// are 64 keys, 32 at 128 (shared memory).  The kernels own the loop: these
// are its tiles, loads, splits, passes and the output's store.
#pragma once
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace tf32 {

constexpr int THREADS = 256;  // two warpgroups
constexpr int ROWS = 128;     // query rows a CTA
constexpr int BQ = 64;        // query rows a warpgroup

// Tiles of a float32 kernel whose head dim is padded to DP.  A row-panel tile
// (Q: 64 rows, K: KEYS rows, x DP) holds dims in SW128 panels of 32 floats
// (rows x 128 bytes each) and, at DP = 80, a last panel of 16 interleaved (4
// chunks a row); a V^T tile (DP rows, one per dim, x the tile's keys) holds
// keys in SW128 panels of 32.  Raw tiles are row-major, DP floats a row.
template <int DP> struct F32 {
  static_assert(DP == 32 || DP == 64 || DP == 80 || DP == 128, "DP is 32, 64, 80 or 128");
  static constexpr int KEYS = DP > 80 ? 32 : 64;  // keys a tile
  static constexpr int FULL = DP / 32;            // SW128 panels of a row-panel tile
  static constexpr bool NARROW = DP % 32 != 0;    // and a 16-float interleaved one
  static constexpr int CHUNKS = DP / 4;           // 16-byte chunks a row
  static constexpr uint32_t Q_BYTES = 4u * BQ * DP;    // one warpgroup's Q, hi or lo
  static constexpr uint32_t T_BYTES = 4u * KEYS * DP;  // K, V^T or raw
};

__host__ __device__ constexpr int f32_dp(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 80 ? 80 : 128;
}

// Dynamic shared memory of the tiles: alignment slack, both warpgroups' Q hi
// and lo, K hi and lo, V^T hi and lo, raw K and raw V.
template <int DP> __host__ __device__ constexpr size_t tile_smem() {
  return 1024 + 4 * (size_t)F32<DP>::Q_BYTES + 6 * (size_t)F32<DP>::T_BYTES;
}

// Byte offset of chunk c (4 floats) of row r in a row-panel tile of ``rows``
// rows.
template <int DP>
__device__ __forceinline__ uint32_t panel_offset(int r, int c, int rows) {
  constexpr int FULL = F32<DP>::FULL;
  if (!F32<DP>::NARROW || c < 8 * FULL) return (c / 8) * rows * 128 + sm90::sw128(r, c % 8);
  return FULL * rows * 128 + sm90::interleaved(r, c - 8 * FULL, 4);
}

// Rows [row0, row0 + rows) of an (L, d) float32 matrix into the raw tile
// ``raw``; rows >= L and columns >= d are zero.  ``vec``: cp.async in
// 16-byte chunks (d % 4 == 0, 16-byte aligned rows), else element by element.
template <int DP>
__device__ __forceinline__ void load_raw(float* raw, const float* src, int row0, int rows, int L,
                                         int d, bool vec) {
  if (vec) {
    constexpr int C = F32<DP>::CHUNKS;
    const uint32_t dst = sm90::smem_addr(raw);
    for (int idx = threadIdx.x; idx < rows * C; idx += THREADS) {
      const int r = idx / C, c = idx % C, row = row0 + r;
      const bool live = row < L && 4 * c < d;
      sm90::cp_async16(dst + 16 * idx, live ? src + (size_t)row * d + 4 * c : src,
                       live ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP, row = row0 + r;
      raw[idx] = row < L && c < d ? src[(size_t)row * d + c] : 0.f;
    }
  }
}

// A raw tile of ``rows`` rows split into the hi and lo row-panel tiles at
// shared addresses ``hi`` and ``lo``.
template <int DP>
__device__ __forceinline__ void split_rows(uint32_t hi, uint32_t lo, const float* raw, int rows) {
  constexpr int C = F32<DP>::CHUNKS;
  for (int idx = threadIdx.x; idx < rows * C; idx += THREADS) {
    const float4 x = reinterpret_cast<const float4*>(raw)[idx];
    uint32_t h[4], l[4];
    sm90::split_tf32(x.x, h[0], l[0]);
    sm90::split_tf32(x.y, h[1], l[1]);
    sm90::split_tf32(x.z, h[2], l[2]);
    sm90::split_tf32(x.w, h[3], l[3]);
    const uint32_t off = panel_offset<DP>(idx / C, idx % C, rows);
    sm90::st_shared16(hi + off, h[0], h[1], h[2], h[3]);
    sm90::st_shared16(lo + off, l[0], l[1], l[2], l[3]);
  }
}

// A raw V tile split into the hi and lo V^T tiles.  Row n of V^T is dim n;
// its k-positions 4 (c % 2) + e of key group c / 2 (16-byte chunk c) hold
// key 8 (c / 2) + c % 2 + 2e: each group of 8 keys in the order 0, 2, 4, 6,
// 1, 3, 5, 7, which puts the key pair (2u, 2u + 1) of a thread's s registers
// at the k-positions (u, u + 4) of its A fragment.  A warp's lanes take
// neighbouring dims: its raw reads and its swizzled stores are free of bank
// conflicts.
template <int DP>
__device__ __forceinline__ void split_vt(uint32_t hi, uint32_t lo, const float* raw) {
  constexpr int KEYS = F32<DP>::KEYS;
  for (int idx = threadIdx.x; idx < DP * (KEYS / 4); idx += THREADS) {
    const int n = idx % DP, c = idx / DP, key = 8 * (c / 2) + c % 2;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sm90::split_tf32(raw[(key + 2 * e) * DP + n], h[e], l[e]);
    const uint32_t off = (c / 8) * DP * 128 + sm90::sw128(n, c % 8);
    sm90::st_shared16(hi + off, h[0], h[1], h[2], h[3]);
    sm90::st_shared16(lo + off, l[0], l[1], l[2], l[3]);
  }
}

// Issues s (+)= A B^T for one TF32 pass over the head dim: A a 64-row tile
// (Q hi or lo), B a key tile (K hi or lo); ``first``: s starts at zero.
template <int DP>
__device__ __forceinline__ void qk_pass(float (&s)[F32<DP>::KEYS / 2], uint32_t a, uint32_t b,
                                        bool first) {
  constexpr int KEYS = F32<DP>::KEYS, FULL = F32<DP>::FULL;
#pragma unroll
  for (int p = 0; p < FULL; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tf32_ss<KEYS>(s, sm90::desc_sw128(a + p * BQ * 128 + 32 * kk),
                                sm90::desc_sw128(b + p * KEYS * 128 + 32 * kk),
                                !first || p > 0 || kk > 0);
  if constexpr (F32<DP>::NARROW) {
    // K-major: chunk stride 128 leading, 8-row group stride 512; a K step is 2 chunks
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      sm90::wgmma_tf32_ss<KEYS>(s, sm90::desc_interleaved(a + FULL * BQ * 128 + 256 * kk, 128, 512),
                                sm90::desc_interleaved(b + FULL * KEYS * 128 + 256 * kk, 128, 512),
                                1);
  }
}

// Issues o (+)= P V for one TF32 pass over the key tile: P (hi or lo, in
// the accumulator layout of s) as the A fragment, V^T (hi or lo) as B;
// ``first``: o starts at zero.
template <int DP>
__device__ __forceinline__ void pv_pass(float (&o)[DP / 2], const uint32_t (&p)[F32<DP>::KEYS / 2],
                                        uint32_t vt, bool first) {
#pragma unroll
  for (int j = 0; j < F32<DP>::KEYS / 8; ++j) {
    const uint32_t a[4] = {p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]};
    sm90::wgmma_tf32_rs<DP>(o, a, sm90::desc_sw128(vt + (j / 4) * DP * 128 + 32 * (j % 4)),
                            !first || j > 0);
  }
}

// The output rows r0 and r0 + 8 of a warpgroup (``dst``: row r0 of an (L, d)
// matrix): o over the row sum, whose shares l the row's 4 threads hold; rows
// past L (``live``) and dims past d are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(float* dst, const float (&o)[DP / 2],
                                           const float (&l)[2], const bool (&live)[2], int c2,
                                           int d) {
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float li = l[half];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    inv[half] = 1.f / li;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int half = (i / 2) & 1, dim = 8 * (i / 4) + c2;
    if (!live[half] || dim >= d) continue;
    float* at = dst + (size_t)8 * half * d + dim;
    const float a = o[i] * inv[half], b = o[i + 1] * inv[half];
    if (d % 2 == 0) {
      *reinterpret_cast<float2*>(at) = make_float2(a, b);
    } else {
      at[0] = a;
      if (dim + 1 < d) at[1] = b;
    }
  }
}

}  // namespace tf32
