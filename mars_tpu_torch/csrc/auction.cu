// One epsilon-phase of the Jacobi auction (linear assignment), the whole
// bidding loop in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel mars_tpu/ops/assignment.py:_auction_phase_pallas
// (Pallas body _auction_kernel).  Contract, as there and as the plain version
// mars_tpu_torch/ops/assignment.py:_auction_phase_plain:
//   scores (T, N) float32 row-major, maximise; row_valid (T,) uint8;
//   prices_in (N,) float32; eps; max_rounds.
//   Per round, every valid unassigned row bids: values = scores[r] - prices,
//   j = the FIRST column at the max m1, m2 = the max over the other columns
//   (floored at NEG), bid = (prices[j] + (m1 - m2)) + eps.  Each column goes
//   to its highest bid, ties to the LARGEST row index, if that bid is above
//   NEG / 2; its previous holder loses it and its price becomes that bid.
//   The loop ends when no valid row is unassigned or after max_rounds rounds.
//   Outputs: col_of_row (T,) int32 (-1 unassigned), prices (N,) float32, and
//   stats (4,) int32 = {dense rounds, small rounds, bidder rows in dense
//   rounds, bidder rows in small rounds}; a round is "small" when at most
//   small_k rows bid (small_k < 0: never), as the TPU kernel counts its
//   gather rounds.
// It is bit-exact with the plain version: the same float32 expressions
// (subtractions and additions only, with explicit round-to-nearest
// intrinsics), the argmax-first tie rule kept through an ordered top-2
// reduction, and the order-free column maxima taken with atomicMax on an
// order-preserving int32 encoding of float32.
//
// What bounds it: each round must read the bidding rows of the score matrix
// (bidders x N x 4 bytes; the 7.5 MB matrix at 1369 x 1369 stays resident in
// the 50 MB L2), but rounds are sequential and most of them have a handful of
// bidders, so the floor is the per-round latency: five block barriers, the
// bidder scan and one L2 round trip per bid row.
//
// Design.  One CTA of 1024 threads runs every round; prices, the column
// holders, the per-round column maxima and col_of_row live in shared memory
// (16 (T + N) bytes, 44 KB at 1369 x 1369), so a round costs block barriers,
// not grid syncs or launches.  Per round: scan col_of_row for bidders (a
// shared atomic counter; the order of the bidder list does not matter, since
// both column reductions are maxima); one warp per bidder row computes its
// top-2 with coalesced loads; the column-best bids, the candidates, and the
// winners resolve in three passes over the bidder list; a last pass resets
// the touched columns.  A single CTA reads a dense round's rows at one SM's
// L2 rate; spreading dense rounds over the card (a cooperative launch) is
// work for a later change.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e9f;
constexpr int MAX_SMEM = 227 * 1024;

// float32 -> int32 with the same order (no NaNs here)
__device__ __forceinline__ int enc(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int b) { return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff); }

size_t smem_bytes(int T, int N) { return (size_t)16 * ((size_t)T + (size_t)N); }

__global__ void __launch_bounds__(THREADS, 1)
auction_kernel(const float* __restrict__ scores, const unsigned char* __restrict__ valid,
               const float* __restrict__ prices_in, float eps, int T, int N, int max_rounds,
               int small_k, int* __restrict__ col_out, float* __restrict__ prices_out,
               int* __restrict__ stats) {
  extern __shared__ int sm[];
  float* prices = reinterpret_cast<float*>(sm);
  int* cbest = sm + N;       // encoded best bid per column this round
  int* winner = cbest + N;   // winning row per column this round
  int* owner = winner + N;   // row holding each column
  int* col_of_row = owner + N;
  int* bidders = col_of_row + T;
  int* bid_col = bidders + T;
  float* bid_val = reinterpret_cast<float*>(bid_col + T);
  __shared__ int s_nb;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int neg_key = enc(NEG);
  for (int c = tid; c < N; c += THREADS) {
    prices[c] = prices_in[c];
    cbest[c] = neg_key;
    winner[c] = -1;
    owner[c] = -1;
  }
  for (int r = tid; r < T; r += THREADS) col_of_row[r] = -1;

  int rounds = 0, dense = 0, small = 0, dense_rows = 0, small_rows = 0;
  for (;;) {
    if (tid == 0) s_nb = 0;
    __syncthreads();
    for (int r = tid; r < T; r += THREADS)
      if (col_of_row[r] < 0 && valid[r]) bidders[atomicAdd(&s_nb, 1)] = r;
    __syncthreads();
    const int nb = s_nb;
    if (nb == 0 || rounds >= max_rounds) break;  // uniform across the block
    if (small_k >= 0 && nb <= small_k) {
      ++small;
      small_rows += nb;
    } else {
      ++dense;
      dense_rows += nb;
    }

    // bids: one warp per bidder row
    for (int kk = warp; kk < nb; kk += WARPS) {
      const float* row = scores + (size_t)bidders[kk] * N;
      float m1 = -INFINITY, m2 = NEG;
      int j = INT_MAX;
      for (int c = lane; c < N; c += 32) {  // columns in increasing order
        const float val = __fsub_rn(__ldg(row + c), prices[c]);
        if (val > m1) {
          m2 = fmaxf(m2, m1);
          m1 = val;
          j = c;
        } else {
          m2 = fmaxf(m2, val);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m1o = __shfl_xor_sync(0xffffffffu, m1, off);
        const float m2o = __shfl_xor_sync(0xffffffffu, m2, off);
        const int jo = __shfl_xor_sync(0xffffffffu, j, off);
        if (m1o > m1 || (m1o == m1 && jo < j)) {  // the other lane holds the first max
          m2 = fmaxf(m2o, m1);
          m1 = m1o;
          j = jo;
        } else {
          m2 = fmaxf(m2, m1o);
        }
      }
      if (lane == 0) {
        const float bid = __fadd_rn(__fadd_rn(prices[j], __fsub_rn(m1, m2)), eps);
        bid_col[kk] = j;
        bid_val[kk] = bid;
        atomicMax(&cbest[j], enc(bid));
      }
    }
    __syncthreads();
    // candidates: bid at its column's best; the largest candidate row wins
    for (int kk = tid; kk < nb; kk += THREADS) {
      const int j = bid_col[kk];
      const float cb = dec(cbest[j]);
      if (bid_val[kk] >= cb && cb > NEG / 2) atomicMax(&winner[j], bidders[kk]);
    }
    __syncthreads();
    // winners take their columns; the previous holders lose them
    for (int kk = tid; kk < nb; kk += THREADS) {
      const int r = bidders[kk], j = bid_col[kk];
      if (winner[j] == r) {
        const int old = owner[j];
        if (old >= 0) col_of_row[old] = -1;
        owner[j] = r;
        col_of_row[r] = j;
        prices[j] = dec(cbest[j]);
      }
    }
    __syncthreads();
    for (int kk = tid; kk < nb; kk += THREADS) {
      const int j = bid_col[kk];
      cbest[j] = neg_key;
      winner[j] = -1;
    }
    ++rounds;
  }
  for (int r = tid; r < T; r += THREADS) col_out[r] = col_of_row[r];
  for (int c = tid; c < N; c += THREADS) prices_out[c] = prices[c];
  if (tid == 0) {
    stats[0] = dense;
    stats[1] = small;
    stats[2] = dense_rows;
    stats[3] = small_rows;
  }
}

}  // namespace

extern "C" int mars_auction_phase(const void* scores, const void* valid, const void* prices_in,
                                  float eps, int T, int N, int max_rounds, int small_k,
                                  void* col_out, void* prices_out, void* stats, void* stream) {
  if (T < 1 || N < 1 || max_rounds < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(T, N);
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(auction_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  auction_kernel<<<1, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)scores, (const unsigned char*)valid, (const float*)prices_in, eps, T, N,
      max_rounds, small_k, (int*)col_out, (float*)prices_out, (int*)stats);
  return (int)cudaGetLastError();
}
