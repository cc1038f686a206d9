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
// intrinsics) and the argmax-first tie rule kept through a top-2 merge that
// is associative and order-free (on equal maxima the smaller column wins;
// the second is a max), so any split of a row's columns over lanes, warps
// or CTAs gives the same (j, m1, m2).  Both column reductions are maxima, so
// the order of the bidders does not matter either.
//
// What bounds it: a round reads the bidding rows of the score matrix
// (bidders x N x 4 bytes; the 7.5 MB matrix at 1369 x 1369 stays resident in
// the 50 MB L2), but rounds are sequential and most have a handful of
// bidders: the matching auctions spend ~2 970 of their ~3 160 rounds with at
// most 16 (11.6 on average in the reverse one), each row 5.5 KB.  The card
// reads a round's bytes in nanoseconds, so the bytes bound is not this
// kernel's floor.  One SM is: it issues ~8 instructions a column and bidder
// (load, shared load, subtract, three min/max, compare, select), ~85 cycles
// a 1369-column bidder over its four schedulers, and reads the rows at one
// SM's share of L2; under that, a round's latency chain (an L2 round trip,
// the merges, the winners, the barriers).  Spreading a round's few bidders
// over all the warps of one CTA issues the same columns plus more merges
// (measured slower); spreading them over the SMs of a cluster divides them.
//
// Design.  A cluster of CLUSTER CTAs of 512 threads runs every round; each
// CTA keeps the whole state in its shared memory (prices, the column
// holders, col_of_row, the bidder lists: 16 (T + N) bytes, 44 KB at 1369 x
// 1369, plus the exchange buffers) and every CTA computes the same rounds,
// so the state never moves; only a round's partial results do, and every
// list is built in the same order in every CTA.  A bidder list is kept from
// round to round: the rows that bid and lost and the holders that lost
// their column (each added once: a row holds one column); no round rescans
// T, and the first round's list is the valid rows, scanned once.
//   - A small round (nb <= 16 bidders): warp w of every CTA takes bidder w
//     over that CTA's slice of the columns (whole warps of columns, 192 of
//     1369 a CTA), every lane's loads issued before a branch-free compare
//     chain, the lanes merged by integer warp reductions; lanes 0..7 send
//     the slice's (m1, m2, j) to the 8 CTAs by st.async, each counted on the
//     receiver's mbarrier (no cluster barrier).  Warp 0 of every CTA then
//     finishes the round, a lane a bidder: it merges the 8 slices as a tree,
//     bids, finds each column's best (bid, row) among the lanes by 16
//     shuffles of one 64-bit key (bid, row, column), and the winners take
//     their columns and write the next list in lane order.  One block
//     barrier a round.  The partials alternate between two buffers and
//     mbarriers by round parity: a CTA can run at most one round ahead of
//     another, since it waits for the other's partials of the round.
//   - A dense round (nb > 16): bidder kk goes to CTA kk % 8, a warp a whole
//     row; after a relaxed cluster barrier (every CTA done reading the last
//     round's list and bid columns), (j, bid) go to every CTA by st.async
//     into its bid columns and next list (free until the winners' pass),
//     counted on the round's mbarrier; each CTA then takes the column keys
//     with 64-bit shared atomicMax on (bid, row) (the highest bid wins, ties
//     to the largest row), and all threads resolve the bidders and append
//     the next list in thread order.
//
// Past shared memory.  16 (T + N) bytes and the exchange buffers fit up to
// T + N = 14 266; larger instances (T = N = 7 225 at grid 85, or a five-shot
// support side of 5 x 7 225 columns) run the same rounds with the state
// moved out, as template parameter MODE says:
//   - MODE 0: everything in shared memory, as above;
//   - MODE 1: the row side (col_of_row, the two lists, bid_col: 16 T bytes)
//     in a global scratch buffer the caller allocates, one replica per CTA;
//     the column side stays in shared memory while 16 N + EXTRA_BYTES fits;
//   - MODE 2: the column side (key, prices, owner: 16 N bytes) in the same
//     buffer too, before each CTA's rows.
// A small round touches only its own CTA's replica between block barriers,
// which order global memory within the CTA as they do shared memory.  A
// dense round writes the bids into every CTA's replica: st.async cannot
// reach global memory, so the sender stores them (L2, past L1) and both
// cluster barriers of the round release and acquire (a CTA reads the other
// CTAs' bids only after the second); the replica argument is unchanged.  In
// MODE 2 a column index may pass 16 bits, so a small round's winner pass
// shuffles the column beside the (bid, row) key instead of packing it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // CTAs of the cluster, each a slice of a small round's columns
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 43;  // loads in flight a lane: ceil(1369 / 32), a matching row at once
constexpr int SLICE_UNROLL = (UNROLL + CLUSTER - 1) / CLUSTER;  // the same for one slice
constexpr float NEG = -1e9f;
constexpr int MAX_SMEM = 227 * 1024;
// below every bid's key; its row part (-1) is no row
constexpr unsigned long long KEY_EMPTY = 0xffffffffull;

struct Part {  // a slice's top-2 of one bidder row
  float m1, m2;
  int j, pad;
};

// float32 -> int32 with the same order (no NaNs here)
__device__ __forceinline__ int enc(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int b) { return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff); }

// (bid, low) ordered as unsigned 64-bit: bid first (-0 taken as +0, as a
// float compare takes them), then the low word, which starts with the row
__device__ __forceinline__ unsigned long long bid_key(float bid, unsigned low) {
  const unsigned hi = (unsigned)enc(__fadd_rn(bid, 0.0f)) ^ 0x80000000u;
  return ((unsigned long long)hi << 32) | low;
}
__device__ __forceinline__ int key_bid(unsigned long long k) {
  return (int)((unsigned)(k >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}
// the one local arrival of a phase, which also expects `bytes` of st.async
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// 16 bytes into CTA `rank`'s copy of dst, completing that many bytes of its
// copy of bar
__device__ __forceinline__ void st_async(void* dst, unsigned long long* bar, int rank, float a,
                                         float b, int c) {
  unsigned rdst, rbar;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rdst) : "r"(smem_addr(dst)), "r"(rank));
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(rdst), "r"(__float_as_int(a)), "r"(__float_as_int(b)), "r"(c), "r"(0), "r"(rbar)
      : "memory");
}

// 4 bytes into CTA `rank`'s copy of dst, completing them on its copy of bar
__device__ __forceinline__ void st_async(int* dst, unsigned long long* bar, int rank, int v) {
  unsigned rdst, rbar;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rdst) : "r"(smem_addr(dst)), "r"(rank));
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(rdst), "r"(v), "r"(rbar)
               : "memory");
}

// dynamic shared memory, in every CTA: the slices' partials of the last two
// rounds and their two mbarriers, keys (8 N), prices, owner (4 N each),
// col_of_row, two bidder lists, bid_col (4 T each), the warps' append counts
// and the two list lengths; MODE 1 moves the T arrays to the global scratch,
// MODE 2 the N arrays too
constexpr int PART_BYTES = 2 * WARPS * CLUSTER * (int)sizeof(Part) + 16;
constexpr int EXTRA_BYTES = PART_BYTES + 4 * (WARPS + 2);
size_t smem_bytes(int mode, int T, int N) {
  const size_t rows = mode == 0 ? (size_t)T : 0, cols = mode == 2 ? 0 : (size_t)N;
  return 16 * (rows + cols) + (size_t)EXTRA_BYTES;
}
// one CTA's replica in the global scratch (the buffer holds CLUSTER of them)
__host__ __device__ inline size_t replica_bytes(int mode, int T, int N) {
  return mode == 0 ? 0 : 16 * ((size_t)T + (mode == 2 ? (size_t)N : 0));
}

// the top-2 merge: the other side holds the first max when its m1 is larger,
// or equal at a smaller column
__device__ __forceinline__ void merge(float& m1, float& m2, int& j, float m1o, float m2o, int jo) {
  if (m1o > m1 || (m1o == m1 && jo < j)) {
    m2 = fmaxf(m2o, m1);
    m1 = m1o;
    j = jo;
  } else {
    m2 = fmaxf(m2, m1o);
  }
}

// merge a warp's lanes' (m1, m2, j) by integer reductions of the
// order-preserving encoding: the max, the first column at it (the smallest
// of the lanes holding it), and the max of the rest (the holder's m2 and
// the others' m1, or the max itself when two lanes hold it)
__device__ __forceinline__ void warp_merge(float& m1, float& m2, int& j) {
  const int e1 = enc(m1);
  const int top1 = __reduce_max_sync(0xffffffffu, e1);
  const bool top = e1 == top1;
  const int ties = __popc(__ballot_sync(0xffffffffu, top));
  const int top2 = __reduce_max_sync(0xffffffffu, top ? enc(m2) : e1);
  j = __reduce_min_sync(0xffffffffu, top ? j : INT_MAX);
  m1 = dec(top1);
  m2 = ties > 1 ? m1 : dec(top2);
}

// one batch of a lane's chain: U columns base, base + 32, ... (< hi) loaded
// first, then compared.  FULL: every column but the last is below hi for
// every lane (a matching row: 42 of 43), so only the last load is guarded.
template <int U, bool FULL>
__device__ __forceinline__ void batch_top2(const float* __restrict__ row, const float* prices,
                                           int base, int hi, float& m1, float& m2, int& j) {
  float s[U], q[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = base + 32 * u;
    const bool in = (FULL && u < U - 1) || c < hi;
    s[u] = in ? __ldg(row + c) : -INFINITY;
    q[u] = in ? prices[c] : 0.0f;
  }
  int ju = -1;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float val = __fsub_rn(s[u], q[u]);
    ju = val > m1 ? u : ju;
    m2 = fmaxf(m2, fminf(val, m1));
    m1 = fmaxf(m1, val);
  }
  if (ju >= 0) j = base + 32 * ju;
}

// top-2 of row - prices over columns [lo, hi), one warp: each lane's columns
// lo + lane, lo + lane + 32, ... in increasing order, U loads issued before
// the chain.  The chain keeps the first column at the max (strict >) and
// m2 = max(m2, min(val, m1)), which is max(m2, m1) when val takes the max
// and max(m2, val) otherwise; past hi a value is -inf and changes nothing.
template <int U>
__device__ __forceinline__ void row_top2(const float* __restrict__ row, const float* prices,
                                         int lane, int lo, int hi, float& m1, float& m2, int& j) {
  m1 = -INFINITY;
  m2 = NEG;
  j = INT_MAX;
  for (int b0 = lo; b0 < hi; b0 += 32 * U) {  // uniform across the warp
    if (hi - b0 >= 32 * (U - 1))
      batch_top2<U, true>(row, prices, b0 + lane, hi, m1, m2, j);
    else
      batch_top2<U, false>(row, prices, b0 + lane, hi, m1, m2, j);
  }
  warp_merge(m1, m2, j);
}

// every thread calls it: the rows r where take, appended to list[len...] in
// thread order (so every CTA of the cluster builds the same list); returns
// the new length
__device__ __forceinline__ int ordered_append(int* list, int len, bool take, int r,
                                              int* wcount, int lane, int warp) {
  const unsigned m = __ballot_sync(0xffffffffu, take);
  if (lane == 0) wcount[warp] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = wcount[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (take) list[len + before + __popc(m & ((1u << lane) - 1u))] = r;
  __syncthreads();
  return len + total;
}

struct State {
  unsigned long long* key;  // best (bid, row) per column this round
  float* prices;
  int* owner;  // row holding each column
  int* col_of_row;
  int half_key;  // enc(NEG / 2)
};

// bidder r bid for column j: the row the next round's list gains, or -1
__device__ __forceinline__ int resolve(const State& st, int r, int j) {
  const unsigned long long k = st.key[j];
  const int b = key_bid(k);
  if (b > st.half_key && (int)(unsigned)k == r) {  // r takes column j
    const int old = st.owner[j];
    if (old >= 0) st.col_of_row[old] = -1;
    st.owner[j] = r;
    st.col_of_row[r] = j;
    st.prices[j] = dec(b);
    st.key[j] = KEY_EMPTY;  // j's losers read either key: both say they lost
    return old;
  }
  if (b <= st.half_key) st.key[j] = KEY_EMPTY;  // no row takes j this round
  return r;
}

// the cluster barrier of a dense round: relaxed while every list it guards
// is in shared memory and reached by st.async (MODE 0), release and acquire
// once a replica in global memory is written by plain stores
template <int MODE>
__device__ __forceinline__ void dense_barrier() {
  if (MODE == 0)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;" :::
                 "memory");
  else
    asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
                 ::: "memory");
}

template <int MODE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
auction_kernel(const float* __restrict__ scores, const unsigned char* __restrict__ valid,
               const float* __restrict__ prices_in, float eps, int T, int N, int max_rounds,
               int small_k, int* __restrict__ col_out, float* __restrict__ prices_out,
               int* __restrict__ stats, char* __restrict__ scratch) {
  extern __shared__ float4 sm4[];
  Part* part = reinterpret_cast<Part*>(sm4);  // [round parity][slice][bidder]
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(part + 2 * WARPS * CLUSTER);
  const cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  char* shared_state = reinterpret_cast<char*>(sm4) + PART_BYTES;
  const size_t replica = replica_bytes(MODE, T, N);
  // the column side, then the row side, in shared memory or this CTA's replica
  char* cols = MODE == 2 ? scratch + rank * replica : shared_state;
  char* rows = MODE == 0 ? shared_state + (size_t)16 * N
                         : (MODE == 1 ? scratch + rank * replica : cols + (size_t)16 * N);
  State st;
  st.key = reinterpret_cast<unsigned long long*>(cols);
  st.prices = reinterpret_cast<float*>(st.key + N);
  st.owner = reinterpret_cast<int*>(st.prices + N);
  st.col_of_row = reinterpret_cast<int*>(rows);
  int* lists = st.col_of_row + T;  // this round's bidders and the next round's, by parity
  int* bid_col = lists + 2 * T;
  int* wcount = reinterpret_cast<int*>(MODE == 0 ? reinterpret_cast<char*>(bid_col + T)
                                                 : (MODE == 1 ? shared_state + (size_t)16 * N
                                                              : shared_state));
  int* count = wcount + WARPS;  // the lists' lengths, by parity
  st.half_key = enc(NEG / 2);
  // this CTA's slice of a small round's columns: whole warps of columns
  const int slice = 32 * ((N + 32 * CLUSTER - 1) / (32 * CLUSTER));
  const int lo = min(N, rank * slice), hi = min(N, lo + slice);

  for (int c = tid; c < N; c += THREADS) {
    st.key[c] = KEY_EMPTY;
    st.prices[c] = prices_in[c];
    st.owner[c] = -1;
  }
  for (int r = tid; r < T; r += THREADS) st.col_of_row[r] = -1;
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int len = 0;  // the first round's bidders: the valid rows, in order
  for (int base = 0; base < T; base += THREADS) {
    const int r = base + tid;
    len = ordered_append(lists, len, r < T && valid[r], r, wcount, lane, warp);
  }
  if (tid == 0) count[0] = len;
  cluster.sync();  // every CTA's barriers are ready before anyone sends

  int rounds = 0, dense = 0, small = 0, dense_rows = 0, small_rows = 0;
  int phases = 0;  // the two partial barriers' phase parities, bits 0 and 1
  for (;;) {
    const int par = rounds & 1;
    const int nb = count[par];
    if (nb == 0 || rounds >= max_rounds) break;  // uniform across the cluster
    if (small_k >= 0 && nb <= small_k) {
      ++small;
      small_rows += nb;
    } else {
      ++dense;
      dense_rows += nb;
    }
    const int* cur = lists + par * T;
    int* nxt = lists + (par ^ 1) * T;
    Part* round_part = part + par * WARPS * CLUSTER;

    if (nb <= WARPS) {
      // a warp a bidder over this CTA's slice; the partial to every CTA
      if (tid == 0) mbar_expect(bar + par, CLUSTER * nb * (int)sizeof(Part));
      if (warp < nb) {
        float m1, m2;
        int j;
        row_top2<SLICE_UNROLL>(scores + (size_t)cur[warp] * N, st.prices, lane, lo, hi, m1, m2,
                               j);
        if (lane < CLUSTER)  // lane = the receiving CTA's rank
          st_async(round_part + rank * WARPS + warp, bar + par, lane, m1, m2, j);
      }
      // warp 0 finishes the round, a lane a bidder: merge the slices, bid,
      // each column to its best (bid, row) among the lanes, the winners
      if (warp == 0) {
        mbar_wait(bar + par, (phases >> par) & 1);
        const bool act = lane < nb;
        const int r = act ? cur[lane] : -1;
        float m1 = -INFINITY, m2 = NEG;
        int j = -1;
        // (bid, row, column); 0 when idle, below every real key
        unsigned long long key = 0;
        if (act) {  // the slices' partials merged as a tree
          Part q[CLUSTER];
#pragma unroll
          for (int k = 0; k < CLUSTER; ++k) q[k] = round_part[k * WARPS + lane];
#pragma unroll
          for (int step = 1; step < CLUSTER; step *= 2)
#pragma unroll
            for (int k = 0; k < CLUSTER; k += 2 * step)
              merge(q[k].m1, q[k].m2, q[k].j, q[k + step].m1, q[k + step].m2, q[k + step].j);
          m1 = q[0].m1;
          m2 = q[0].m2;
          j = q[0].j;
          const float bid = __fadd_rn(__fadd_rn(st.prices[j], __fsub_rn(m1, m2)), eps);
          key = MODE == 2 ? bid_key(bid, (unsigned)r) : bid_key(bid, (unsigned)r << 16 | (unsigned)j);
        }
        unsigned long long best = key;  // the best key among the lanes bidding for j
#pragma unroll
        for (int k = 0; k < WARPS; ++k) {
          const unsigned long long other = __shfl_sync(0xffffffffu, key, k);
          if (MODE == 2) {  // columns past 16 bits: the column beside the key
            if (__shfl_sync(0xffffffffu, j, k) == j && other > best) best = other;
          } else if ((int)(other & 0xffff) == j && other > best) {
            best = other;
          }
        }
        int add = r;
        if (act && key_bid(best) > st.half_key && best == key) {  // r takes column j
          add = st.owner[j];
          if (add >= 0) st.col_of_row[add] = -1;
          st.owner[j] = r;
          st.col_of_row[r] = j;
          st.prices[j] = dec(key_bid(best));
        }
        const unsigned m = __ballot_sync(0xffffffffu, add >= 0);
        if (add >= 0) nxt[__popc(m & ((1u << lane) - 1u))] = add;
        if (lane == 0) count[par ^ 1] = __popc(m);
      }
      phases ^= 1 << par;
    } else {  // several bidders a warp, bidder kk in CTA kk % CLUSTER
      // every CTA is done reading the last round's lists and bid_col; in
      // shared memory no memory to order, so a relaxed arrival
      dense_barrier<MODE>();
      if (MODE == 0 && tid == 0) mbar_expect(bar + par, 8 * nb);
      for (int kk = rank + CLUSTER * warp; kk < nb; kk += CLUSTER * WARPS) {
        float m1, m2;
        int j;
        row_top2<UNROLL>(scores + (size_t)cur[kk] * N, st.prices, lane, 0, N, m1, m2, j);
        const float bid = __fadd_rn(__fadd_rn(st.prices[j], __fsub_rn(m1, m2)), eps);
        if (lane < CLUSTER) {  // the bid to every CTA (lane = its rank), parked in its next list
          if (MODE == 0) {
            st_async(bid_col + kk, bar + par, lane, j);
            st_async(nxt + kk, bar + par, lane, __float_as_int(bid));
          } else {  // the same offsets in CTA lane's replica
            const ptrdiff_t to = (ptrdiff_t)(lane - rank) * (ptrdiff_t)replica;
            __stcg(reinterpret_cast<int*>(reinterpret_cast<char*>(bid_col + kk) + to), j);
            __stcg(reinterpret_cast<int*>(reinterpret_cast<char*>(nxt + kk) + to),
                   __float_as_int(bid));
          }
        }
      }
      if (MODE == 0) {
        mbar_wait(bar + par, (phases >> par) & 1);
        phases ^= 1 << par;
      } else {
        dense_barrier<MODE>();  // every CTA's bids are in every replica
      }
      for (int kk = tid; kk < nb; kk += THREADS)
        atomicMax(&st.key[MODE == 0 ? bid_col[kk] : __ldcg(bid_col + kk)],
                  bid_key(__int_as_float(MODE == 0 ? nxt[kk] : __ldcg(nxt + kk)), cur[kk]));
      __syncthreads();
      int next = 0;
      for (int base = 0; base < nb; base += THREADS) {
        const int kk = base + tid;
        const int add =
            kk < nb ? resolve(st, cur[kk], MODE == 0 ? bid_col[kk] : __ldcg(bid_col + kk)) : -1;
        next = ordered_append(nxt, next, add >= 0, add, wcount, lane, warp);
      }
      if (tid == 0) count[par ^ 1] = next;
    }
    __syncthreads();
    ++rounds;
  }
  if (rank == 0) {
    for (int r = tid; r < T; r += THREADS) col_out[r] = st.col_of_row[r];
    for (int c = tid; c < N; c += THREADS) prices_out[c] = st.prices[c];
    if (tid == 0) {
      stats[0] = dense;
      stats[1] = small;
      stats[2] = dense_rows;
      stats[3] = small_rows;
    }
  }
  cluster.sync();  // no CTA leaves while others may still write to it
}

template <int MODE>
int launch(const void* scores, const void* valid, const void* prices_in, float eps, int T, int N,
           int max_rounds, int small_k, void* col_out, void* prices_out, void* stats,
           void* stream, void* scratch) {
  const size_t bytes = smem_bytes(MODE, T, N);
  if (bytes > (size_t)MAX_SMEM || (MODE > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(auction_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  auction_kernel<MODE><<<CLUSTER, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)scores, (const unsigned char*)valid, (const float*)prices_in, eps, T, N,
      max_rounds, small_k, (int*)col_out, (float*)prices_out, (int*)stats, (char*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: where the state lives (MODE above); scratch: CLUSTER replicas of
// replica_bytes(mode, T, N) each, null in mode 0.  The wrapper picks the
// mode by size (ops/assignment.py auction_variant).
extern "C" int mars_auction_phase(const void* scores, const void* valid, const void* prices_in,
                                  float eps, int T, int N, int max_rounds, int small_k,
                                  void* col_out, void* prices_out, void* stats, void* stream,
                                  void* scratch, int mode) {
  if (T < 1 || N < 1 || max_rounds < 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      return launch<0>(scores, valid, prices_in, eps, T, N, max_rounds, small_k, col_out,
                       prices_out, stats, stream, scratch);
    case 1:
      return launch<1>(scores, valid, prices_in, eps, T, N, max_rounds, small_k, col_out,
                       prices_out, stats, stream, scratch);
    case 2:
      return launch<2>(scores, valid, prices_in, eps, T, N, max_rounds, small_k, col_out,
                       prices_out, stats, stream, scratch);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
