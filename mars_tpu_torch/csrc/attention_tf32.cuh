// float32 attention tiles on the tensor cores by split TF32 (sm90.cuh), shared
// by the float32 kernels of csrc/sam_grid_attention.cu (grid_f32),
// csrc/sam_windowed_attention.cu (windowed_f32), csrc/attention_notap.cu
// (notap_f32) and csrc/attention_tap.cu (tap_out_f32, tap_mean_f32); the
// first two share the whole biased sweep (biased_sweep below), notap_f32 and
// tap_out_f32 the whole unbiased one (unbiased_sweep).
//
// A CTA is two warpgroups over 128 query rows, 64 each, sweeping one head's
// keys in tiles that both share: each operand is hi + lo (two TF32 values)
// and each product three TF32 wgmma passes, a_lo b_hi, a_hi b_lo, a_hi b_hi
// (the small terms first).  TF32 wgmma reads both operands K-major, so P.V
// takes V^T: a raw V tile is split into hi and lo V^T tiles with its keys
// permuted inside each group of 8 (0, 2, 4, 6, 1, 3, 5, 7), so that the
// registers of s are P's A fragment as they stand; K tiles are split likewise
// into hi and lo row-panel tiles.  Head dims pad to 32, 64, 80 or 128; K tiles
// are 64 keys, 32 at 128 (shared memory); a sweep's last tile may be narrower
// (NK keys, a multiple of 8: the tile functions take NK).
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

// A raw V tile of NK keys split into the hi and lo V^T tiles.  Row n of V^T
// is dim n;
// its k-positions 4 (c % 2) + e of key group c / 2 (16-byte chunk c) hold
// key 8 (c / 2) + c % 2 + 2e: each group of 8 keys in the order 0, 2, 4, 6,
// 1, 3, 5, 7, which puts the key pair (2u, 2u + 1) of a thread's s registers
// at the k-positions (u, u + 4) of its A fragment.  A warp's lanes take
// neighbouring dims: its raw reads and its swizzled stores are free of bank
// conflicts.
template <int DP, int NK = F32<DP>::KEYS>
__device__ __forceinline__ void split_vt(uint32_t hi, uint32_t lo, const float* raw) {
  for (int idx = threadIdx.x; idx < DP * (NK / 4); idx += THREADS) {
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
// (Q hi or lo), B a tile of NK keys (K hi or lo, split as NK rows);
// ``first``: s starts at zero.
template <int DP, int NK = F32<DP>::KEYS>
__device__ __forceinline__ void qk_pass(float (&s)[NK / 2], uint32_t a, uint32_t b, bool first) {
  constexpr int FULL = F32<DP>::FULL;
#pragma unroll
  for (int p = 0; p < FULL; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tf32_ss<NK>(s, sm90::desc_sw128(a + p * BQ * 128 + 32 * kk),
                              sm90::desc_sw128(b + p * NK * 128 + 32 * kk),
                              !first || p > 0 || kk > 0);
  if constexpr (F32<DP>::NARROW) {
    // K-major: chunk stride 128 leading, 8-row group stride 512; a K step is 2 chunks
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      sm90::wgmma_tf32_ss<NK>(s, sm90::desc_interleaved(a + FULL * BQ * 128 + 256 * kk, 128, 512),
                              sm90::desc_interleaved(b + FULL * NK * 128 + 256 * kk, 128, 512),
                              1);
  }
}

// Issues o (+)= P V for one TF32 pass over a tile of NK keys: P (hi or lo,
// in the accumulator layout of s) as the A fragment, V^T (hi or lo) as B;
// ``first``: o starts at zero.
template <int DP, int NK = F32<DP>::KEYS>
__device__ __forceinline__ void pv_pass(float (&o)[DP / 2], const uint32_t (&p)[NK / 2],
                                        uint32_t vt, bool first) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
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

// One CTA's sweep of softmax attention without a bias: query rows [q0, q0 +
// 128) of batch-head ``bh`` of (BH, L, d) q, k, v; out = softmax(q k^T *
// scale) v (BH, L, d), logits __fmul_rn(q . k, scale); with ``lse`` (a
// float32 (BH, L) scratch, or null) also each live row's log-sum-exp, m +
// log(l) of its running max and row sum.  A float32 online softmax: a
// running max per row (shared by the row's 4 threads, two shuffles), the
// output rescaled by exp(m_old - m_new); P is P.V's A fragment straight
// from the accumulator registers.  Q lands raw where the K, V^T and raw
// tiles go and is split first; then the splits run while the tensor cores
// work: V's while Q K^T runs, the next K tile's while P.V does.  Keys past
// L are masked (only the last tile holds any); query rows past L are
// computed on zeros and not stored.  A tile's P.V is summed from zero in
// its own accumulator and added to the output sum with an IEEE fma, as in
// biased_sweep.
template <int DP>
__device__ __forceinline__ void unbiased_sweep(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               float* __restrict__ out, float* __restrict__ lse,
                                               int L, int d, float scale, int vec, int q0, int bh,
                                               uint8_t* smem_raw) {
  using F = F32<DP>;
  constexpr int KEYS = F::KEYS, NS = KEYS / 2;  // NS: registers of s
  const uint32_t base = sm90::aligned_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - sm90::smem_addr(smem_raw));  // base, generic
  // Q hi and lo of warpgroup 0, then of warpgroup 1; K hi, K lo, V^T hi,
  // V^T lo, raw K, raw V
  const int group = threadIdx.x / 128;
  const uint32_t qh = base + 2 * F::Q_BYTES * group, ql = qh + F::Q_BYTES;
  const uint32_t kh = base + 4 * F::Q_BYTES, kl = kh + F::T_BYTES;
  const uint32_t vh = kl + F::T_BYTES, vl = vh + F::T_BYTES;
  float* raw_k = reinterpret_cast<float*>(gbase + 4 * F::Q_BYTES + 4 * F::T_BYTES);
  float* raw_v = raw_k + KEYS * DP;
  const size_t head = (size_t)bh * L * d;
  const float *qg = q + head, *kg = k + head, *vg = v + head;
  const int ntiles = (L + KEYS - 1) / KEYS;
  const int lane = threadIdx.x % 32;
  // rows r0 and r0 + 8 of the warpgroup's 64 (the CTA's rows g0 + r0, + 8)
  const int g0 = 64 * group, r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);  // keys 8j + c2 and + 1 of a tile
  bool live[2];                   // rows below L
#pragma unroll
  for (int half = 0; half < 2; ++half) live[half] = q0 + g0 + r0 + 8 * half < L;

  // Q lands raw where the K, V^T and raw tiles go (6 T_BYTES >= 128 rows),
  // then is split
  float* raw_q = reinterpret_cast<float*>(gbase + 4 * F::Q_BYTES);
  load_raw<DP>(raw_q, qg, q0, ROWS, L, d, vec);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int g = 0; g < 2; ++g)
    split_rows<DP>(base + 2 * F::Q_BYTES * g, base + 2 * F::Q_BYTES * g + F::Q_BYTES,
                   raw_q + BQ * DP * g, BQ);
  sm90::fence_async_smem();
  __syncthreads();  // the raw tiles are free
  load_raw<DP>(raw_k, kg, 0, KEYS, L, d, vec);
  sm90::cp_async_commit();
  load_raw<DP>(raw_v, vg, 0, KEYS, L, d, vec);
  sm90::cp_async_commit();
  sm90::cp_async_wait<1>();
  __syncthreads();
  split_rows<DP>(kh, kl, raw_k, KEYS);
  sm90::fence_async_smem();

  // running max (shared by the row's 4 threads) and this thread's share of
  // the row sum, per row half
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // o: the output sum; pv: a tile's P.V, which the tensor cores sum from
  // zero, then added to o (their truncating adds over a whole sweep's chain
  // of wgmma steps in one accumulator would break the limit)
  float s[NS], o[DP / 2], pv[DP / 2];
  uint32_t ph[NS], pl[NS];  // P hi and lo
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const bool next = t + 1 < ntiles;
    sm90::cp_async_wait<0>();  // raw V tile t
    // V tile t and the split K tile t in view; raw K and V^T free
    __syncthreads();
    if (next) load_raw<DP>(raw_k, kg, (t + 1) * KEYS, KEYS, L, d, vec);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    qk_pass<DP>(s, ql, kh, true);  // the small terms first
    qk_pass<DP>(s, qh, kl, false);
    qk_pass<DP>(s, qh, kh, false);
    sm90::wgmma_commit();
    split_vt<DP>(vh, vl, raw_v);  // while Q K^T runs
    sm90::fence_async_smem();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);

    // logits: register i of s is (row r0 + 8 ((i / 2) % 2), key 8 (i / 4) + c2 + i % 2);
    // only the last tile holds keys past L
    if (next || L % KEYS == 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = __fmul_rn(s[i], scale);
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = t * KEYS + 8 * (i / 4) + c2 + (i & 1) < L ? __fmul_rn(s[i], scale) : -INFINITY;
    }

    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, s[4 * j + 2 * half + e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);  // finite: every tile has a live key
      corr[half] = __expf(m[half] - m_new);       // 0 on the first tile
      m[half] = m_new;
    }
    // P = exp(s - m) (masked keys give 0), split into hi and lo; the row sum
    // adds P
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int half = (i / 2) & 1;
      const float p = __expf(s[i] - m[half]);
      psum[half] += p;
      sm90::split_tf32(p, ph[i], pl[i]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + psum[half];

    sm90::cp_async_wait<0>();  // raw K tile t + 1
    // V^T in view; raw V free; every warp is done with the K tiles
    __syncthreads();
    if (next) load_raw<DP>(raw_v, vg, (t + 1) * KEYS, KEYS, L, d, vec);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    pv_pass<DP>(pv, pl, vh, true);
    pv_pass<DP>(pv, ph, vl, false);
    pv_pass<DP>(pv, ph, vh, false);
    sm90::wgmma_commit();
    if (next) {  // while P.V runs
      split_rows<DP>(kh, kl, raw_k, KEYS);
      sm90::fence_async_smem();
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(pv);
    sm90::fence_regs(ph);
    sm90::fence_regs(pl);
    // o's register i is row r0 + 8 ((i / 2) % 2) as in s
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = fmaf(o[i], corr[(i / 2) & 1], pv[i]);
  }

  if (lse != nullptr) {  // the row sum of the row's 4 threads, as store_rows takes it
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float li = l[half];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      if (lane % 4 == 0 && live[half])
        lse[(size_t)bh * L + q0 + g0 + r0 + 8 * half] = m[half] + logf(li);
    }
  }
  store_rows<DP>(out + head + (size_t)(q0 + g0 + r0) * d, o, l, live, c2, d);
}

// How a biased sweep takes the bias, by the grid's width W
constexpr int BY_TABLES = 0;   // any W: each key's row and column from per-tile tables
constexpr int BY_ROW = 1;      // W a multiple of the key tile: a tile is part of one key row
constexpr int BY_WINDOW = 2;   // W = WINDOW_W (SAM's window): a tile is WINDOW_ROWS key rows
constexpr int WINDOW_W = 14;
constexpr int WINDOW_ROWS = 4;  // 56 keys a tile (64-key tiles: head dims up to 80)
constexpr int WINDOW_STEP = WINDOW_ROWS * WINDOW_W;
constexpr int WINDOW_TAIL = 32;  // the last tile, where L % 56 = 28 (196 = 3 x 56 + 28)

// Dynamic shared memory of a biased sweep: the tiles and, BY_TABLES, the
// tile's key tables.
template <int DP, int MODE> __host__ __device__ constexpr size_t sweep_smem() {
  return tile_smem<DP>() + (MODE == BY_TABLES ? 2 * sizeof(int) * F32<DP>::KEYS : 0);
}

template <int N> struct Keys {
  static constexpr int value = N;
};

// One CTA's sweep of attention with the decomposed relative-position bias
// (the contract of csrc/sam_grid_attention.cu): query rows [q0, q0 + 128) of
// head ``h`` of (H, L, d) q, k, v and (H, L, hg) bias_h, (H, L, wg) bias_w,
// logits (q . k) * scale + bias_h[q, k / wg] + bias_w[q, k % wg] as
// __fadd_rn(__fadd_rn(__fmul_rn(s, scale), bh), bw), the plain version's
// expression in its order; out (H, L, d).  Register i of s is (row r0 + 8
// ((i / 2) % 2), key 8 (i / 4) + c2 + i % 2) of the tile; MODE takes the
// bias:
//   BY_ROW (wg a multiple of the key tile): nothing is masked and key tile
//   t is part of one key row y, columns x0 to x0 + KEYS - 1: a thread loads
//   bias_h at (its rows, y) and bias_w at (its rows, x0 + its keys) before
//   Q K^T; y and x0 step with the tile.
//   BY_WINDOW (wg = 14, SAM's window; head dims up to 80): tiles of 4 key
//   rows, 56 keys, the last WINDOW_TAIL keys wide (the caller's L % 56 =
//   28: 196 keys are 3 tiles and 28 keys).  A thread's keys sit at the
//   same columns in every tile, so its bias_w values are loaded once, into
//   registers, and each tile's bias_h is 4 values a row, loaded before
//   Q K^T.  Keys past L are masked.
//   BY_TABLES (any wg): each key's row and column from per-tile tables, one
//   lookup each per logit after Q K^T; keys past L are masked.
// Query rows past L are computed on zeros and not stored.  The splits run while the tensor
// cores work: V's while Q K^T runs, the next K tile's while P.V does; Q and
// the first K and V tiles are loaded together.  A tile's P.V is summed from
// zero in its own accumulator and added to the output sum with an IEEE fma:
// the tensor cores' float32 adds truncate, and one accumulator over a
// 4096-key sweep reads 3.7e-5 off the plain version
// (tools/grid_f32_probe.py, one_acc).
template <int DP, int MODE>
__device__ __forceinline__ void biased_sweep(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias_h, const float* __restrict__ bias_w, float* __restrict__ out,
    int L, int d, int hg, int wg, float scale, int vec, int q0, int h, uint8_t* smem_raw) {
  using F = F32<DP>;
  constexpr int KEYS = F::KEYS;
  constexpr int STEP = MODE == BY_WINDOW ? WINDOW_STEP : KEYS;  // keys a tile
  constexpr int TAIL = MODE == BY_WINDOW ? WINDOW_TAIL : 0;      // the last tile's, or 0
  static_assert(MODE != BY_WINDOW || STEP <= KEYS, "a window tile fits the tiles");
  static_assert(2 * F::Q_BYTES <= 4 * F::T_BYTES, "raw Q lands below raw K and V");
  const uint32_t base = sm90::aligned_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - sm90::smem_addr(smem_raw));  // base, generic
  // Q hi and lo of warpgroup 0, then of warpgroup 1; K hi, K lo, V^T hi,
  // V^T lo, raw K, raw V; the key tables
  const int group = threadIdx.x / 128;
  const uint32_t qh = base + 2 * F::Q_BYTES * group, ql = qh + F::Q_BYTES;
  const uint32_t kh = base + 4 * F::Q_BYTES, kl = kh + F::T_BYTES;
  const uint32_t vh = kl + F::T_BYTES, vl = vh + F::T_BYTES;
  float* raw_k = reinterpret_cast<float*>(gbase + 4 * F::Q_BYTES + 4 * F::T_BYTES);
  float* raw_v = raw_k + KEYS * DP;
  int* ky = reinterpret_cast<int*>(raw_v + KEYS * DP);  // BY_TABLES: the tile's key rows
  int* kx = ky + KEYS;                                  // and columns
  const size_t head = (size_t)h * L * d;
  const size_t brow = (size_t)h * L;  // the head's first bias row
  const float *qg = q + head, *kg = k + head, *vg = v + head;
  // tiles STEP wide, then (TAIL) one TAIL wide
  const int nfull = TAIL ? L / STEP : (L + STEP - 1) / STEP;
  const int ntiles = nfull + (TAIL ? 1 : 0);
  const int lane = threadIdx.x % 32;
  // rows r0 and r0 + 8 of the warpgroup's 64 (the CTA's rows g0 + r0, + 8)
  const int g0 = 64 * group, r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);  // keys 8j + c2 and + 1 of a tile
  bool live[2];                   // rows below L
#pragma unroll
  for (int half = 0; half < 2; ++half) live[half] = q0 + g0 + r0 + 8 * half < L;

  // Q lands raw where the K and V^T tiles go, the first raw K and V tiles
  // beside it; Q is split, then K
  const int rows0 = nfull > 0 ? STEP : TAIL;
  float* raw_q = reinterpret_cast<float*>(gbase + 4 * F::Q_BYTES);
  load_raw<DP>(raw_q, qg, q0, ROWS, L, d, vec);
  sm90::cp_async_commit();
  load_raw<DP>(raw_k, kg, 0, rows0, L, d, vec);
  sm90::cp_async_commit();
  load_raw<DP>(raw_v, vg, 0, rows0, L, d, vec);
  sm90::cp_async_commit();
  sm90::cp_async_wait<2>();
  __syncthreads();
  for (int g = 0; g < 2; ++g)
    split_rows<DP>(base + 2 * F::Q_BYTES * g, base + 2 * F::Q_BYTES * g + F::Q_BYTES,
                   raw_q + BQ * DP * g, BQ);
  sm90::cp_async_wait<1>();
  __syncthreads();  // raw K tile 0 in view; raw Q is free
  split_rows<DP>(kh, kl, raw_k, rows0);
  sm90::fence_async_smem();

  // running max (shared by the row's 4 threads) and this thread's share of
  // the row sum, per row half; o: the output sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  int y = 0, x0 = 0;  // BY_ROW: tile t's key row and first column
  const float* bhr[2];  // the thread's bias rows (r0 and r0 + 8)
  const float* bwr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t row = brow + q0 + g0 + r0 + 8 * half;
    bhr[half] = bias_h + row * hg;
    bwr[half] = bias_w + row * wg;
  }
  // BY_WINDOW: bias_w at register i of s, the same in every tile (rows past L take none)
  float bw_win[MODE == BY_WINDOW ? STEP / 2 : 1];
  if constexpr (MODE == BY_WINDOW) {
#pragma unroll
    for (int i = 0; i < STEP / 2; ++i) {
      const int half = (i / 2) & 1;
      bw_win[i] = live[half] ? __ldg(bwr[half] + (8 * (i / 4) + c2 + (i & 1)) % WINDOW_W) : 0.f;
    }
  }

  // key tile t, NK keys wide
  auto tile = [&](auto width, int t) {
    constexpr int NK = decltype(width)::value, NS = NK / 2;  // NS: registers of s
    const bool next = t + 1 < ntiles;
    const int next_rows = TAIL && t + 1 == nfull ? TAIL : STEP;
    if constexpr (MODE == BY_TABLES) {
      // the previous tile's middle barrier has retired its tables
      const int key = t * STEP + threadIdx.x;
      if (threadIdx.x < NK) {
        ky[threadIdx.x] = key < L ? key / wg : 0;
        kx[threadIdx.x] = key < L ? key % wg : 0;
      }
    }
    // BY_ROW, BY_WINDOW: the tile's bias, in flight while Q K^T runs (rows
    // past L take none)
    float bh[2] = {0.f, 0.f}, bw[MODE == BY_ROW ? NS : 1];
    if constexpr (MODE == BY_ROW) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2 w[NK / 8] = {};
        if (live[half]) {
          bh[half] = __ldg(bhr[half] + y);
#pragma unroll
          for (int j = 0; j < NK / 8; ++j)
            w[j] = __ldg(reinterpret_cast<const float2*>(bwr[half] + x0 + 8 * j + c2));
        }
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) {
          bw[4 * j + 2 * half] = w[j].x;
          bw[4 * j + 2 * half + 1] = w[j].y;
        }
      }
    }
    float bh_win[2][WINDOW_ROWS] = {};  // BY_WINDOW: bias_h at the tile's key rows
    if constexpr (MODE == BY_WINDOW) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < WINDOW_ROWS; ++r)
          if (live[half] && WINDOW_ROWS * t + r < hg)
            bh_win[half][r] = __ldg(bhr[half] + WINDOW_ROWS * t + r);
    }
    sm90::cp_async_wait<0>();  // raw V tile t
    // V tile t and the split K tile t in view; raw K and V^T free
    __syncthreads();
    if (next) load_raw<DP>(raw_k, kg, (t + 1) * STEP, next_rows, L, d, vec);
    sm90::cp_async_commit();
    float s[NS];
    sm90::wgmma_fence();
    qk_pass<DP, NK>(s, ql, kh, true);  // the small terms first
    qk_pass<DP, NK>(s, qh, kl, false);
    qk_pass<DP, NK>(s, qh, kh, false);
    sm90::wgmma_commit();
    split_vt<DP, NK>(vh, vl, raw_v);  // while Q K^T runs
    sm90::fence_async_smem();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);

    // logits: register i of s is (row r0 + 8 ((i / 2) % 2), key 8 (i / 4) + c2 + i % 2)
    if constexpr (MODE == BY_TABLES) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i / 4) + c2 + (i & 1), half = (i / 2) & 1;
        s[i] = t * STEP + c < L
                   ? __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale),
                                         live[half] ? __ldg(bhr[half] + ky[c]) : 0.f),
                               live[half] ? __ldg(bwr[half] + kx[c]) : 0.f)
                   : -INFINITY;
      }
    } else if constexpr (MODE == BY_WINDOW) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i / 4) + c2 + (i & 1), half = (i / 2) & 1;
        const int r = c / WINDOW_W;  // the key's row in the tile
        float b = bh_win[half][0];
#pragma unroll
        for (int u = 1; u < WINDOW_ROWS; ++u) b = r == u ? bh_win[half][u] : b;
        s[i] = NK == STEP || t * STEP + c < L
                   ? __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), b), bw_win[i])
                   : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), bh[(i / 2) & 1]), bw[i]);
      x0 += KEYS;
      if (x0 == wg) {
        x0 = 0;
        ++y;
      }
    }

    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, s[4 * j + 2 * half + e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);  // finite: every tile has a live key
      corr[half] = __expf(m[half] - m_new);       // 0 on the first tile
      m[half] = m_new;
    }
    // P = exp(s - m) (masked keys give 0), split into hi and lo; the row sum
    // adds P
    uint32_t ph[NS], pl[NS];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int half = (i / 2) & 1;
      const float p = __expf(s[i] - m[half]);
      psum[half] += p;
      sm90::split_tf32(p, ph[i], pl[i]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + psum[half];

    sm90::cp_async_wait<0>();  // raw K tile t + 1
    // V^T in view; raw V free; every warp is done with the K tiles
    __syncthreads();
    if (next) load_raw<DP>(raw_v, vg, (t + 1) * STEP, next_rows, L, d, vec);
    sm90::cp_async_commit();
    // pv: the tile's P.V, which the tensor cores sum from zero
    float pv[DP / 2];
    sm90::wgmma_fence();
    pv_pass<DP, NK>(pv, pl, vh, true);
    pv_pass<DP, NK>(pv, ph, vl, false);
    pv_pass<DP, NK>(pv, ph, vh, false);
    sm90::wgmma_commit();
    if (next) {  // while P.V runs
      split_rows<DP>(kh, kl, raw_k, next_rows);
      sm90::fence_async_smem();
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(pv);
    sm90::fence_regs(ph);
    sm90::fence_regs(pl);
    // o's register i is row r0 + 8 ((i / 2) % 2) as in s
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = fmaf(o[i], corr[(i / 2) & 1], pv[i]);
  };

  for (int t = 0; t < nfull; ++t) tile(Keys<STEP>{}, t);
  if constexpr (TAIL > 0) tile(Keys<TAIL>{}, nfull);

  store_rows<DP>(out + head + (size_t)(q0 + g0 + r0) * d, o, l, live, c2, d);
}

}  // namespace tf32
