// Earlier-in-batch-wins commit fixpoint: one launch runs the whole
// convergence loop of the resolver's intra-batch check.
//
// Replaces the TPU kernel commit_fixpoint_pallas
// (foundationdb_tpu/ops/fixpoint_pallas.py:343, the pallas_call at :336).
// Same function as the plain torch version (conflict_kernel.commit_fixpoint):
//   base  = t_ok & ~(hist_hits > 0)
//   c    <- base & ~blocked(c)   until c stops changing, at most T+1 rounds
// where blocked(c) marks txn t iff one of its valid read rows is hit by a
// committed, strictly earlier write of the same batch:
//   * point read vs point write: same key group (gid) and a smaller txn —
//     the per-gid minimum of committed writer txns, kept in a global scratch
//     table of G+2 ints by atomicMin (reset per round for the writers' gids);
//   * any read vs a committed RANGE write: ovw[r, w] & maskw[w] != 0;
//   * RANGE read vs a committed POINT write: ovrp[r, w] & maskp[w] != 0.
// maskw / maskp are the committed-writer bitmaps, built each round from c by
// real gathers through w_txn / wp_txn (the TPU kernel swept words because
// the TPU has no vector gather).
//
// What bounds it on an H100: one CTA of 1024 threads, so the rounds are
// latency-bound; each round re-reads the ovw + ovrp words (about 0.5 MB at
// the bench width T=4096, Rp=Wp=8192, Rr=Wr=256; 6 MB at the default
// config's 4096 rows per group) plus the row vectors, from L2 after the
// first round. What the design does about it: the committed bitmap c, the
// blocked bitmap and both writer masks live in shared memory; each read
// row is scanned by a group of lanes with independent, coalesced loads;
// and the loop never returns to the host between rounds (the XLA form
// issued ~20 small kernels per round and synced each round's loop test).
//
// Layout the caller guarantees (conflict_kernel.build_batch_arrays): valid
// read rows form a prefix of their group, grouped by ascending txn, so
// "OR over a txn's row window" equals "OR over rows naming that txn", which
// is what the atomicOr below computes. T % 32 == 0 (warp ballots pack 32
// txns per word). Group ids lie in [1, G].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRowsInFlight = 4;   // rows a lane group scans per iteration
constexpr int kWordsPerLane = 8;   // edge words a lane loads per row (target)

// c[txn], with the JAX gather rule for an out-of-range txn (wrap a negative
// index once, then clamp).
__device__ __forceinline__ uint32_t txn_bit(const uint32_t* c, int txn, int T) {
  if (txn < 0) txn += T;
  txn = min(max(txn, 0), T - 1);
  return (c[txn >> 5] >> (txn & 31)) & 1u;
}

// Lanes that scan one row of `words` edge words: a power of two, 1..32.
__device__ __forceinline__ int group_lanes(int words) {
  int lanes = 1;
  while (lanes < words && lanes < 32) lanes <<= 1;
  return lanes;
}

// OR over words j = sub, sub+L, ... < n of row[j] & mask[j]. The first
// kWordsPerLane words are a fully unrolled, predicated sequence, so their
// loads issue back to back instead of each waiting for the one before.
__device__ __forceinline__ uint32_t or_words(const uint32_t* __restrict__ row,
                                             const uint32_t* mask, int n, int sub, int L) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < kWordsPerLane; ++k) {
    const int j = sub + k * L;
    if (j < n) acc |= row[j] & mask[j];
  }
  for (int j = sub + kWordsPerLane * L; j < n; j += L) acc |= row[j] & mask[j];
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1) commit_fixpoint_kernel(
    const bool* __restrict__ t_ok, const int32_t* __restrict__ hist_hits,
    const int32_t* __restrict__ rp_txn, const bool* __restrict__ rp_valid,
    const int32_t* __restrict__ gid_rp,
    const int32_t* __restrict__ r_txn, const bool* __restrict__ r_valid,
    const int32_t* __restrict__ wp_txn, const bool* __restrict__ wp_valid,
    const int32_t* __restrict__ gid_wp,
    const int32_t* __restrict__ w_txn, const bool* __restrict__ w_valid,
    const uint32_t* __restrict__ ovw, const uint32_t* __restrict__ ovrp,
    int32_t* __restrict__ mn, bool* __restrict__ committed,
    int32_t* __restrict__ rounds_out,
    int T, int Rp, int Rr, int Wp, int Wr, int WRW, int WPW, int G) {
  extern __shared__ uint32_t smem[];
  const int TW = T >> 5;
  uint32_t* c = smem;               // [TW] committed bitmap
  uint32_t* base = c + TW;          // [TW] t_ok & ~history hit
  uint32_t* blocked = base + TW;    // [TW] this round's blocked txns
  uint32_t* maskw = blocked + TW;   // [WRW] committed range writes
  uint32_t* maskp = maskw + WRW;    // [WPW] committed point writes
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int gmax = G + 1;           // last slot of the [G + 2] table

  // Every loop that ballots runs over a multiple of 32 indices, so the 32
  // lanes of a warp enter and leave it together.
  for (int t = tid; t < T; t += nthr) {
    const uint32_t word = __ballot_sync(0xffffffffu, t_ok[t] && hist_hits[t] <= 0);
    if (lane == 0) {
      base[t >> 5] = word;
      c[t >> 5] = word;
    }
  }
  // Every gid a valid point row names starts at T (= +inf). Reads only ever
  // see these slots, and the writers' slots are reset each round.
  for (int i = tid; i < Rp; i += nthr)
    if (rp_valid[i]) mn[min(max(gid_rp[i], 0), gmax)] = T;
  for (int i = tid; i < Wp; i += nthr)
    if (wp_valid[i]) mn[min(max(gid_wp[i], 0), gmax)] = T;
  __syncthreads();

  int rounds = 0;
  for (;;) {
    // (a) writer masks from c; reset the point writers' gid slots
    for (int w = tid; w < WRW * 32; w += nthr) {
      const bool b = w < Wr && w_valid[w] && txn_bit(c, w_txn[w], T);
      const uint32_t word = __ballot_sync(0xffffffffu, b);
      if (lane == 0) maskw[w >> 5] = word;
    }
    for (int w = tid; w < WPW * 32; w += nthr) {
      const bool valid = w < Wp && wp_valid[w];
      const bool b = valid && txn_bit(c, wp_txn[w], T);
      const uint32_t word = __ballot_sync(0xffffffffu, b);
      if (lane == 0) maskp[w >> 5] = word;
      if (valid) {
        const int g = gid_wp[w];
        if (g >= 0 && g <= gmax) mn[g] = T;
      }
    }
    for (int i = tid; i < TW; i += nthr) blocked[i] = 0u;
    __syncthreads();

    // (b) per-gid minimum txn of the committed point writers
    for (int w = tid; w < Wp; w += nthr) {
      if (wp_valid[w] && ((maskp[w >> 5] >> (w & 31)) & 1u)) {
        const int g = gid_wp[w];
        if (g >= 0 && g <= gmax) atomicMin(&mn[g], wp_txn[w]);
      }
    }
    __syncthreads();

    // (c) read rows hit by a committed earlier write block their txn.
    // A group of L lanes scans one row, about 8 words per lane (L is a
    // power of two, 1..32): each lane ORs its words without an early exit,
    // so the loads are independent and, for L > 1, coalesced; one ballot
    // ORs the group. Each group keeps kRowsInFlight rows in flight per
    // iteration (all their loads first, then the ballots), so a warp waits
    // on L2 once per kRowsInFlight rows. The word loads do not wait for
    // the row's valid flag (an invalid row never sets a bit, whatever its
    // words); only the group's first lane reads it, the row's txn and
    // (point rows) the gid table.
    {
      const int L = group_lanes((WRW + kWordsPerLane - 1) / kWordsPerLane);
      const int per = 32 / L, grp = lane / L, sub = lane & (L - 1);
      const uint32_t gmask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (grp * L);
      const int stride = nwarps * per;
      for (int r0 = warp * per; r0 < Rp; r0 += stride * kRowsInFlight) {  // warp-uniform
        uint32_t acc[kRowsInFlight];
        int tx[kRowsInFlight];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const int r = r0 + u * stride + grp;
          acc[u] = 0u;
          tx[u] = -1;
          if (r < Rp) {
            const uint32_t* row = ovw + static_cast<size_t>(r) * WRW;
            acc[u] = or_words(row, maskw, WRW, sub, L);
            if (sub == 0 && rp_valid[r]) {
              tx[u] = rp_txn[r];
              // __ldcg: the slot was written by atomics at L2 this round
              if (__ldcg(&mn[min(max(gid_rp[r], 0), gmax)]) < tx[u]) acc[u] = 1u;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const uint32_t hits = __ballot_sync(0xffffffffu, acc[u] != 0u);
          if ((hits & gmask) && tx[u] >= 0 && tx[u] < T)
            atomicOr(&blocked[tx[u] >> 5], 1u << (tx[u] & 31));
        }
      }
    }
    {
      const int W = WRW + WPW;     // a range read row: its ovw then ovrp words
      const int L = group_lanes((W + kWordsPerLane - 1) / kWordsPerLane);
      const int per = 32 / L, grp = lane / L, sub = lane & (L - 1);
      const uint32_t gmask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (grp * L);
      const int stride = nwarps * per;
      for (int r0 = warp * per; r0 < Rr; r0 += stride * kRowsInFlight) {  // warp-uniform
        uint32_t acc[kRowsInFlight];
        int tx[kRowsInFlight];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const int r = r0 + u * stride + grp;
          acc[u] = 0u;
          tx[u] = -1;
          if (r < Rr) {
            const uint32_t* row = ovw + static_cast<size_t>(Rp + r) * WRW;
            const uint32_t* prow = ovrp + static_cast<size_t>(r) * WPW;
            acc[u] = or_words(row, maskw, WRW, sub, L) |
                     or_words(prow, maskp, WPW, sub, L);
            if (sub == 0 && r_valid[r]) tx[u] = r_txn[r];
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const uint32_t hits = __ballot_sync(0xffffffffu, acc[u] != 0u);
          if ((hits & gmask) && tx[u] >= 0 && tx[u] < T)
            atomicOr(&blocked[tx[u] >> 5], 1u << (tx[u] & 31));
        }
      }
    }
    __syncthreads();

    // (d) c' = base & ~blocked; stop at the fixpoint or after T+1 rounds
    // (the JAX while_loop: one first round, then at most T more)
    ++rounds;
    int changed = 0;
    for (int i = tid; i < TW; i += nthr) {
      const uint32_t nw = base[i] & ~blocked[i];
      changed |= (nw != c[i]);
      c[i] = nw;
    }
    if (!__syncthreads_or(changed) || rounds > T) break;
  }

  for (int t = tid; t < T; t += nthr) committed[t] = (c[t >> 5] >> (t & 31)) & 1u;
  if (tid == 0) rounds_out[0] = rounds;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: bools as 1-byte, int32 words holding uint32 bits. The
// kernel launches on `stream`, does not synchronise and allocates nothing.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fdb_commit_fixpoint(
    const void* t_ok, const void* hist_hits,
    const void* rp_txn, const void* rp_valid, const void* gid_rp,
    const void* r_txn, const void* r_valid,
    const void* wp_txn, const void* wp_valid, const void* gid_wp,
    const void* w_txn, const void* w_valid,
    const void* ovw, const void* ovrp,
    void* mn, void* committed, void* rounds,
    int T, int Rp, int Rr, int Wp, int Wr, int WRW, int WPW, int G,
    void* stream) {
  const size_t smem = static_cast<size_t>(3 * (T / 32) + WRW + WPW) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        commit_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  commit_fixpoint_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(t_ok), static_cast<const int32_t*>(hist_hits),
      static_cast<const int32_t*>(rp_txn), static_cast<const bool*>(rp_valid),
      static_cast<const int32_t*>(gid_rp),
      static_cast<const int32_t*>(r_txn), static_cast<const bool*>(r_valid),
      static_cast<const int32_t*>(wp_txn), static_cast<const bool*>(wp_valid),
      static_cast<const int32_t*>(gid_wp),
      static_cast<const int32_t*>(w_txn), static_cast<const bool*>(w_valid),
      static_cast<const uint32_t*>(ovw), static_cast<const uint32_t*>(ovrp),
      static_cast<int32_t*>(mn), static_cast<bool*>(committed),
      static_cast<int32_t*>(rounds),
      T, Rp, Rr, Wp, Wr, WRW, WPW, G);
  return static_cast<int>(cudaGetLastError());
}
