// The 4-bit formats and the weights' register-operand dequantization that
// the skinny GEMM (csrc/int4_matmul.cu) and the prefill GEMM
// (csrc/int4_prefill.cu) share: a stage's codes (GB_ROWS packed rows of
// GB_COLS columns), one ldmatrix.x4.trans of them a warp, and the k16
// steps' A fragments from its words.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int FMT_INT4 = 0;
constexpr int FMT_NF4 = 1;
constexpr int GB_COLS = 128;                        // output columns a CTA
constexpr int GB_ROWS = 32;                         // packed rows a stage: one 64-row block
constexpr int GB_CODE_BYTES = GB_ROWS * GB_COLS;    // 4096

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// NF4: the nibbles at bits 0-3 and 16-19 of v, as bf16(code[c] x s) each.
__device__ __forceinline__ uint32_t nf4_pair(uint32_t v, float s, const float* code) {
  return sm90::pack_bf16(__fmul_rn(code[v & 0xF], s), __fmul_rn(code[(v >> 16) & 0xF], s));
}

// The A fragment of one k16 step in natural K order from the lane's
// ldmatrix word a: bytes (packed row t, column 2g), (t, 2g + 1), (t + 4, 2g),
// (t + 4, 2g + 1) of the step's 8 packed rows.  Register e is one byte's two
// nibbles, low (the even input) in the low half: inputs 2t and 2t + 1 (row
// t; e = 0, 1) or 2t + 8 and 2t + 9 (row t + 4; e = 2, 3) of column 2g (e =
// 0, 2) or 2g + 1 (e = 1, 3).  The low nibbles of bytes 0 and 2 (1 and 3)
// sit at bits 0-3 and 16-19 after one mask, the high ones after a shift
// more; a byte permute pairs each byte's two.  int4: the low nibble under the
// exponent of 128 (bf16 0x4300 | n = 128 + n), the high one with its sign bit
// flipped, 136 off both halves (low - 8 and (high ^ 8) - 8, the signed high
// nibble, exact); NF4 as nf4_pair.
template <int FMT>
__device__ __forceinline__ void dequant_step_k(uint32_t a, float s0, float s1, const float* code,
                                               uint32_t (&frag)[4]) {
  uint32_t lo02 = a & 0x000F000Fu, hi02 = (a >> 4) & 0x000F000Fu;
  uint32_t lo13 = (a >> 8) & 0x000F000Fu, hi13 = (a >> 12) & 0x000F000Fu;
  if (FMT == FMT_INT4) {
    lo02 ^= 0x43004300u, lo13 ^= 0x43004300u, hi02 ^= 0x43084308u, hi13 ^= 0x43084308u;
    const uint32_t bias = 0x43084308u;
    const uint32_t w[4] = {__byte_perm(lo02, hi02, 0x5410), __byte_perm(lo13, hi13, 0x5410),
                           __byte_perm(lo02, hi02, 0x7632), __byte_perm(lo13, hi13, 0x7632)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]),
                                       *reinterpret_cast<const __nv_bfloat162*>(&bias));
      frag[e] = *reinterpret_cast<const uint32_t*>(&r);
    }
  } else {
    frag[0] = nf4_pair(__byte_perm(lo02, hi02, 0x5410), s0, code);
    frag[1] = nf4_pair(__byte_perm(lo13, hi13, 0x5410), s1, code);
    frag[2] = nf4_pair(__byte_perm(lo02, hi02, 0x7632), s0, code);
    frag[3] = nf4_pair(__byte_perm(lo13, hi13, 0x7632), s1, code);
  }
}

}  // namespace
