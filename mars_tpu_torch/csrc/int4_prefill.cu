// The bf16 prefill GEMM (gemm_prefill_bf16; the design note is
// csrc/int4_matmul.cu's), one format a translation unit: ops/build.py
// compiles this file with -DPF_FMT=0 (int4) and -DPF_FMT=1 (NF4) in parallel
// and links both into the int4_matmul library, whose mars_matmul_4bit calls
// launch_prefill_int4 / launch_prefill_nf4 below.
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int4_dequant.cuh"
#include "sm90.cuh"

#ifndef PF_FMT
#error "compile once per format: -DPF_FMT=0 (int4) or -DPF_FMT=1 (NF4)"
#endif

namespace {

// ------------------------------------- bf16 prefill GEMM (wgmma, A in registers)
constexpr int PF_COLS = 128;          // output columns a tile: two consumer warpgroups x 64
constexpr int PF_BK = 64;             // input rows a ring stage: 32 packed rows, one NF4 block
constexpr int PF_CONSUMERS = 256;     // warpgroups 0 and 1 dequantize and multiply
constexpr int PF_THREADS = 384;       // + warpgroup 2, the producer
constexpr int PF_MAX_STAGES = 8;
constexpr int PF_LAG = 2;             // cp.async variant: stages in flight before one is marked full
// setmaxnreg: 40 x 128 + 232 x 256 = 168 x 384 registers (TMA: one thread
// issues the copies); the cp.async variant's 128 loading threads keep 120,
// for two stages' element loads in flight, and its tiles stop at 192 rows
// (96 accumulators a thread)
constexpr int PF_PRODUCER_REGS = 40;
constexpr int PF_CONSUMER_REGS = 232;
constexpr int PF_PRODUCER_REGS_CP = 120;
constexpr int PF_CONSUMER_REGS_CP = 184;
constexpr int PF_SMEM_BUDGET = 227 * 1024 - 512;  // a CTA's dynamic shared memory, one CTA an SM
// x rows of work a tile costs beyond its own, by format (prefill_rows' wave
// reckoning; fitted to tools/prefill_probe.py's tiles of 128, 192 and 256
// rows: NF4's codebook dequantization costs as much a block as 224 rows)
constexpr int PF_TILE_OVERHEAD_INT4 = 96;
constexpr int PF_TILE_OVERHEAD_NF4 = 224;

// st.shared without a memory clobber, for the cp.async producer's stores:
// no later load of the storing thread reads them, so the compiler may issue
// the next chunks' global loads before them.
__device__ __forceinline__ void st_stage16(uint32_t dst, uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(a), "r"(b), "r"(c),
               "r"(d));
}

// One ring stage at N x rows: the x tile (N rows x 64 bf16, SW128; first, so
// that it starts on a 1024-byte boundary), the block's codes (32 packed rows x
// 128 bytes, chunk c of row r at c ^ (r % 8): TMA's 128-byte swizzle), NF4's
// scale row (128 floats).
template <int N> struct Prefill {
  static constexpr int X_BYTES = N * 128;
  static constexpr int CODE_OFF = X_BYTES;
  static constexpr int SCALE_OFF = X_BYTES + GB_CODE_BYTES;
  static constexpr int STAGE = SCALE_OFF + 1024;
  static constexpr int STAGES = (PF_SMEM_BUDGET - 1024) / STAGE < PF_MAX_STAGES
                                    ? (PF_SMEM_BUDGET - 1024) / STAGE : PF_MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

// out^T (128 columns x N rows) = W^T x^T, tile by tile.  The TMA variant runs
// in clusters of two CTAs on adjacent column tiles of one row tile: each
// loads half of the x tile and multicasts it to both, so x, most of a
// stage's bytes, is read from L2 once per 256 columns; its stages are freed
// by both CTAs' consumers.  A cluster's unit u is column tiles 2 (u / R) and
// 2 (u / R) + 1 of row tile u % R (R = ceil(M / N): the row tiles of one
// column pair run side by side, so its codes come from L2 after the first
// read), units dealt to the persistent clusters round-robin; the cp.async
// variant walks single tiles the same way.  Warpgroup 2 produces the ring
// (TMA: one thread; else cp.async by all 128), warpgroups 0 and 1 consume it.
template <int FMT, int N, bool TMA>
__global__ void __launch_bounds__(PF_THREADS, 1)
gemm_prefill_bf16(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap code_map,
                  const __grid_constant__ CUtensorMap scale_map,
                  const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale, const float* __restrict__ code_g,
                  __nv_bfloat16* __restrict__ out, int M, int IN, int OUT, int xvec, int wvec) {
  using P = Prefill<N>;
  constexpr int CLUSTER = TMA ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[PF_MAX_STAGES], empty[PF_MAX_STAGES];
  __shared__ float code[16];
  const uint32_t base = sm90::aligned_base(smem_raw);
  uint8_t* const ring = smem_raw + (base - sm90::smem_addr(smem_raw));
  const int tid = threadIdx.x;
  const int rtiles = (M + N - 1) / N;
  const int units = ((OUT + PF_COLS - 1) / PF_COLS + CLUSTER - 1) / CLUSTER * rtiles;
  const uint32_t rank = CLUSTER > 1 ? sm90::cluster_rank() : 0;
  const int first = CLUSTER > 1 ? (int)sm90::cluster_id_x() : (int)blockIdx.x;
  const int stride = CLUSTER > 1 ? (int)sm90::cluster_count_x() : (int)gridDim.x;
  const int blocks = (IN + PF_BK - 1) / PF_BK;
  if (tid < 16) code[tid] = FMT == FMT_NF4 ? code_g[tid] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(sm90::smem_addr(&full[s]), TMA ? 1 : PF_THREADS - PF_CONSUMERS);
      // a lane of each consumer warp of the cluster
      sm90::mbar_init(sm90::smem_addr(&empty[s]), CLUSTER * PF_CONSUMERS / 32);
    }
    sm90::fence_mbar_init();
  }
  if (CLUSTER > 1) sm90::cluster_sync();  // the peer's barriers, before any copy or arrival
  else __syncthreads();

  if (tid >= PF_CONSUMERS) {
    // ------------------------------------------------------------ producer
    sm90::setmaxnreg_dec<TMA ? PF_PRODUCER_REGS : PF_PRODUCER_REGS_CP>();
    const int p = tid - PF_CONSUMERS;
    if (TMA) {
      if (p != 0) return;
      int s = 0, phase = 0;
      constexpr int bytes = P::X_BYTES + GB_CODE_BYTES + (FMT == FMT_NF4 ? PF_COLS * 4 : 0);
      constexpr int half = N / CLUSTER;  // x rows this CTA loads for the cluster
      for (int u = first; u < units; u += stride) {
        const int col0 = (u / rtiles * CLUSTER + (int)rank) * PF_COLS, row0 = u % rtiles * N;
        for (int kb = 0; kb < blocks; ++kb) {
          const uint32_t st = base + s * P::STAGE, bar = sm90::smem_addr(&full[s]);
          sm90::mbar_wait(sm90::smem_addr(&empty[s]), phase ^ 1);
          sm90::mbar_expect_tx(bar, bytes);
          sm90::tma_load_2d_multicast(st + rank * half * 128, &x_map, kb * PF_BK,
                                      row0 + (int)rank * half, bar, (1 << CLUSTER) - 1);
          sm90::tma_load_2d(st + P::CODE_OFF, &code_map, col0, kb * (PF_BK / 2), bar);
          if (FMT == FMT_NF4) sm90::tma_load_2d(st + P::SCALE_OFF, &scale_map, col0, kb, bar);
          if (++s == P::STAGES) s = 0, phase ^= 1;
        }
      }
      // every stage's last release, the peer's consumers' included, before
      // this CTA (its barriers, its shared memory) may exit
      for (int i = 0; i < P::STAGES; ++i) {
        sm90::mbar_wait(sm90::smem_addr(&empty[s]), phase ^ 1);
        if (++s == P::STAGES) s = 0, phase ^= 1;
      }
      return;
    }
    // cp.async (zero fill past M, IN, OUT) or element loads where a row is
    // no whole number of 16-byte chunks.  The codes' and NF4 scales' element
    // loads of stage i + 1 are issued before stage i's stores (two register
    // sets), so their round trip overlaps a stage; stage i is marked full
    // once stage i + PF_LAG is issued (its copies waited for, fenced for wgmma).
    const int rows = IN / 2;
    const int items = (first < units ? (units - 1 - first) / stride + 1 : 0) * blocks;
    constexpr int LOADERS = PF_THREADS - PF_CONSUMERS;
    constexpr int CHUNKS = 32 * 8 / LOADERS;  // 16-byte code chunks a thread a stage
    struct Ahead {
      uint32_t b[CHUNKS][16];  // code bytes, as loaded
      float v[4];              // NF4 scales
    };
    // the element loads of stage ``item`` (nothing where cp.async copies them)
    auto fetch = [&](int item, Ahead& a) {
      if (wvec) return;
      const int kb = item % blocks, col0 = (first + item / blocks * stride) / rtiles * PF_COLS;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int idx = p + LOADERS * i, r = idx >> 3, c = idx & 7;
        const int pr = kb * (PF_BK / 2) + r, col = col0 + 16 * c;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          a.b[i][e] = pr < rows && col + e < OUT ? packed[(size_t)pr * OUT + col + e] : 0u;
      }
      if (FMT == FMT_NF4 && p < PF_COLS / 4) {
        const int col = col0 + 4 * p;
        const float* src = scale + (size_t)kb * OUT + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) a.v[e] = col + e < OUT ? src[e] : 0.f;
      }
    };
    auto fill = [&](int item, const Ahead& a) {
      const int u = first + item / blocks * stride, kb = item % blocks;
      const int col0 = u / rtiles * PF_COLS, row0 = u % rtiles * N;
      const int s = item % P::STAGES;
      const uint32_t st = base + s * P::STAGE;
      sm90::mbar_wait(sm90::smem_addr(&empty[s]), (item / P::STAGES & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 8 * N / LOADERS; ++i) {
        const int idx = p + LOADERS * i;
        const int m = idx >> 3, c = idx & 7, row = row0 + m, k = kb * PF_BK + 8 * c;
        const uint32_t dst = st + sm90::sw128(m, c);
        const __nv_bfloat16* src = x + (size_t)row * IN + k;
        if (xvec) {
          const bool live = row < M && k < IN;
          sm90::cp_async16(dst, live ? src : x, live ? 16 : 0);
        } else {
          const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          if (row < M) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = (k + 2 * e < IN ? h[2 * e] : 0u) |
                     (k + 2 * e + 1 < IN ? (uint32_t)h[2 * e + 1] << 16 : 0u);
          }
          st_stage16(dst, w[0], w[1], w[2], w[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int idx = p + LOADERS * i, r = idx >> 3, c = idx & 7;
        const int pr = kb * (PF_BK / 2) + r, col = col0 + 16 * c;
        const uint32_t dst = st + P::CODE_OFF + r * PF_COLS + ((c ^ (r & 7)) << 4);
        if (wvec) {
          const bool live = pr < rows && col < OUT;
          sm90::cp_async16(dst, live ? packed + (size_t)pr * OUT + col : packed, live ? 16 : 0);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = a.b[i][4 * q] | a.b[i][4 * q + 1] << 8 | a.b[i][4 * q + 2] << 16 |
                   a.b[i][4 * q + 3] << 24;
          st_stage16(dst, w[0], w[1], w[2], w[3]);
        }
      }
      if (FMT == FMT_NF4 && p < PF_COLS / 4) {
        const int col = col0 + 4 * p;
        const uint32_t dst = st + P::SCALE_OFF + 16 * p;
        if (wvec) {
          const float* src = scale + (size_t)kb * OUT + col;
          sm90::cp_async16(dst, col < OUT ? src : scale, col < OUT ? 16 : 0);
        } else {
          st_stage16(dst, __float_as_uint(a.v[0]), __float_as_uint(a.v[1]),
                     __float_as_uint(a.v[2]), __float_as_uint(a.v[3]));
        }
      }
      sm90::cp_async_commit();
      if (item >= PF_LAG) {
        sm90::cp_async_wait<PF_LAG>();
        sm90::fence_async_smem();
        sm90::mbar_arrive(sm90::smem_addr(&full[(item - PF_LAG) % P::STAGES]));
      }
    };
    Ahead ahead0, ahead1;
    if (items > 0) fetch(0, ahead0);
    for (int item = 0; item < items; item += 2) {
      if (item + 1 < items) fetch(item + 1, ahead1);
      fill(item, ahead0);
      if (item + 1 < items) {
        if (item + 2 < items) fetch(item + 2, ahead0);
        fill(item + 1, ahead1);
      }
    }
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    for (int item = items < PF_LAG ? 0 : items - PF_LAG; item < items; ++item)
      sm90::mbar_arrive(sm90::smem_addr(&full[item % P::STAGES]));
    return;
  }

  // -------------------------------------------------------------- consumers
  sm90::setmaxnreg_inc<TMA ? PF_CONSUMER_REGS : PF_CONSUMER_REGS_CP>();
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // ldmatrix: lane 8j + r gives packed row 8j + r / 2 + 4 (r % 2) of the stage
  // at the warp's chunk (its 16 columns), so matrix j is k16 step j with its
  // rows in the order 0, 4, 1, 5, 2, 6, 3, 7 (the skinny GEMM's fragments)
  const int prow = (lane & ~7) + ((lane & 7) >> 1) + 4 * (lane & 1);
  const uint32_t a_off = P::CODE_OFF + prow * PF_COLS + ((warp ^ (prow & 7)) << 4);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int s = 0, phase = 0, prev = 0;
  // a stage's products are done: free it in every CTA of the cluster (the
  // peer's producer multicasts into this CTA's copy of it)
  auto release = [&](int stage) {
    if (lane != 0) return;
    if (CLUSTER == 1) {
      sm90::mbar_arrive(sm90::smem_addr(&empty[stage]));
    } else {
#pragma unroll
      for (uint32_t r = 0; r < CLUSTER; ++r) sm90::mbar_arrive_cluster(sm90::smem_addr(&empty[stage]), r);
    }
  };
  // Block kb: dequantize it into one of two fragment sets while block kb - 1's
  // wgmma (the other set) runs; once that one is done, free its stage.
  auto step = [&](int kb, uint32_t (&frag)[4][4]) {
    sm90::mbar_wait(sm90::smem_addr(&full[s]), phase);
    const uint32_t st = base + s * P::STAGE;
    uint32_t a[4];
    ldmatrix_x4_trans(a, st + a_off);
    float2 sc = make_float2(0.f, 0.f);
    if (FMT == FMT_NF4)
      sc = *reinterpret_cast<const float2*>(ring + s * P::STAGE + P::SCALE_OFF +
                                            4 * (16 * warp + 2 * g));
#pragma unroll
    for (int j = 0; j < 4; ++j) dequant_step_k<FMT>(a[j], sc.x, sc.y, code, frag[j]);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm90::wgmma_bf16_rs<N>(acc, frag[j], sm90::desc_sw128(st + 32 * j), kb > 0 || j > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // block kb - 1's group: its fragment set and stage are free
    if (kb > 0) release(prev);
    prev = s;
    if (++s == P::STAGES) s = 0, phase ^= 1;
  };
  uint32_t frag_a[4][4], frag_b[4][4];
  for (int u = first; u < units; u += stride) {
    const int col0 = (u / rtiles * CLUSTER + (int)rank) * PF_COLS, row0 = u % rtiles * N;
    int kb = 0;
    for (; kb + 1 < blocks; kb += 2) {
      step(kb, frag_a);
      step(kb + 1, frag_b);
    }
    if (kb < blocks) step(kb, frag_a);
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    release(prev);

    // acc[4q + h], acc[4q + 2 + h]: tile row 8q + 2t + h, columns 2g and
    // 2g + 1 of the warp's 16; int4's scale after the float32 sum, one rounding
    const int col = col0 + 16 * warp + 2 * g;
    float s0 = 1.f, s1 = 1.f;
    if (FMT == FMT_INT4) {
      s0 = col < OUT ? scale[col] : 0.f;
      s1 = col + 1 < OUT ? scale[col + 1] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * q + 2 * t + h;
        if (m >= M || col >= OUT) continue;
        float v0 = acc[4 * q + h], v1 = acc[4 * q + 2 + h];
        if (FMT == FMT_INT4) v0 = __fmul_rn(v0, s0), v1 = __fmul_rn(v1, s1);
        __nv_bfloat16* o = out + (size_t)m * OUT + col;
        if (OUT % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (col + 1 < OUT) o[1] = __float2bfloat16(v1);
        }
      }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime: the library links no
// libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of a row-major (rows, cols) array of ``elem``-byte values in
// boxes of (box_rows, box_cols); zeros past its edges.
bool tile_map(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type, int elem,
              const void* ptr, long long rows, long long cols, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1u, 1u};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SMs (the persistent grid's size), read once a device.
int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev] &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    cached[dev] = 0;
  return cached[dev];
}

// x rows of a prefill tile at (M, OUT) on ``sms`` SMs: of 256, 192 and 128,
// the one whose tiles, dealt to one CTA an SM, finish first, a tile costing
// its rows plus ``overhead`` (ties to the wider tile).  No K split, so the
// choice changes no output bit.
int prefill_rows(int M, int OUT, int sms, int overhead) {
  const long long cols = (OUT + PF_COLS - 1) / PF_COLS;
  int best = 0;
  long long best_cost = 0;
  const int widths[3] = {256, 192, 128};
  for (const int n : widths) {
    const long long tiles = cols * ((M + n - 1) / n);
    const long long cost = (tiles + sms - 1) / sms * (n + overhead);
    if (!best || cost < best_cost) best = n, best_cost = cost;
  }
  return best;
}

template <int FMT, int N, bool TMA>
cudaError_t launch_prefill(const void* x, const void* packed, const void* scale, const void* code,
                           void* out, int M, int IN, int OUT, int xvec, int wvec, int sms,
                           cudaStream_t st) {
  constexpr int CLUSTER = TMA ? 2 : 1;
  const auto kernel = gemm_prefill_bf16<FMT, N, TMA>;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof maps);
  if (TMA) {
    const EncodeTiled enc = encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    if (!tile_map(enc, &maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, IN, N / CLUSTER, PF_BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tile_map(enc, &maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, IN / 2, OUT,
                  PF_BK / 2, PF_COLS, CU_TENSOR_MAP_SWIZZLE_128B) ||
        (FMT == FMT_NF4 && !tile_map(enc, &maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale,
                                     IN / 64, OUT, 1, PF_COLS, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return cudaErrorInvalidValue;
  }
  const long long units =
      (long long)((OUT + PF_COLS - 1) / PF_COLS + CLUSTER - 1) / CLUSTER * ((M + N - 1) / N);
  if (units > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Prefill<N>::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(PF_THREADS);
  cfg.dynamicSmemBytes = Prefill<N>::SMEM;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as fit at once (one CTA an SM), read once
  static int resident = 0;
  if (!resident) {
    cfg.gridDim = dim3(sms / CLUSTER * CLUSTER);
    if (cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg) != cudaSuccess || resident < 1)
      resident = sms / CLUSTER;
  }
  cfg.gridDim = dim3((unsigned)(units < resident ? units : resident) * CLUSTER);
  return cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], (const __nv_bfloat16*)x,
                            (const uint8_t*)packed, (const float*)scale, (const float*)code,
                            (__nv_bfloat16*)out, M, IN, OUT, xvec, wvec);
}

// The operands' plan: the tile's x rows and the variant (TMA where x's and
// the codes' rows are whole 16-byte chunks from 16-byte-aligned pointers, a
// tensor map's strides; else cp.async, its tiles at most 192 rows).
struct Plan {
  int rows, xvec, wvec;
};

Plan plan(const void* x, const void* packed, const void* scale, int M, int IN, int OUT, int sms) {
  Plan p;
  p.xvec = IN % 8 == 0 && ((uintptr_t)x & 15) == 0;
  p.wvec = OUT % 16 == 0 && ((uintptr_t)packed & 15) == 0 &&
           (PF_FMT == FMT_INT4 || ((uintptr_t)scale & 15) == 0);
  p.rows = prefill_rows(M, OUT, sms,
                        PF_FMT == FMT_NF4 ? PF_TILE_OVERHEAD_NF4 : PF_TILE_OVERHEAD_INT4);
  if (!(p.xvec && p.wvec) && p.rows > 192) p.rows = 192;
  return p;
}

}  // namespace

#if PF_FMT == 0
#define PF_ENTRY(name) name##_int4
#else
#define PF_ENTRY(name) name##_nf4
#endif

// 2 x the tile's x rows, plus 1 for the TMA variant: what launch_prefill_*
// launches for these operands on the current device; -1 without a device.
int PF_ENTRY(prefill_plan)(const void* x, const void* packed, const void* scale, int M, int IN,
                           int OUT) {
  const int sms = sm_count();
  if (sms < 1) return -1;
  const Plan p = plan(x, packed, scale, M, IN, OUT, sms);
  return 2 * p.rows + (p.xvec && p.wvec ? 1 : 0);
}

cudaError_t PF_ENTRY(launch_prefill)(const void* x, const void* packed, const void* scale,
                                     const void* code, void* out, int M, int IN, int OUT,
                                     cudaStream_t st) {
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidValue;
  const Plan p = plan(x, packed, scale, M, IN, OUT, sms);
  const bool tma = p.xvec && p.wvec;
  switch (p.rows) {
    case 128:
      return tma ? launch_prefill<PF_FMT, 128, true>(x, packed, scale, code, out, M, IN, OUT,
                                                     p.xvec, p.wvec, sms, st)
                 : launch_prefill<PF_FMT, 128, false>(x, packed, scale, code, out, M, IN, OUT,
                                                      p.xvec, p.wvec, sms, st);
    case 192:
      return tma ? launch_prefill<PF_FMT, 192, true>(x, packed, scale, code, out, M, IN, OUT,
                                                     p.xvec, p.wvec, sms, st)
                 : launch_prefill<PF_FMT, 192, false>(x, packed, scale, code, out, M, IN, OUT,
                                                      p.xvec, p.wvec, sms, st);
    case 256:  // TMA only
      return launch_prefill<PF_FMT, 256, true>(x, packed, scale, code, out, M, IN, OUT, p.xvec,
                                               p.wvec, sms, st);
  }
  return cudaErrorInvalidValue;
}
